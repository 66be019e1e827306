"""Frozen copies of the card arithmetic of the program's benchmark tools
(``speech_transcript_embeddings_torch/utils/bench.py``: ``PEAK_BF16``,
``peak_bf16``, ``ceiling``, ``card_line``, ``CardSampler``), so that a later
change to the program cannot move the yardstick. ``HBM_BYTES_PER_S`` is the
same data sheet's memory bandwidth (3.35 TB/s, SXM part).
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

# dense bf16 tensor-core peak by card name, at the card's full power limit
# (NVIDIA's H100 data sheet, SXM part: 989 TFLOP/s)
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def peak_bf16(card_name: str) -> float:
    """The bf16 peak of ``card_name`` (``torch.cuda.get_device_name``)."""
    if card_name not in PEAK_BF16:
        raise ValueError(f"no bf16 peak known for the card {card_name!r}: "
                         "add its data sheet's dense rate to PEAK_BF16")
    return PEAK_BF16[card_name]


def ceiling(flops: float, seconds: float, peak: float) -> float:
    """``flops / seconds / peak``, the reading's share of the peak; raises
    on a share above 1 (or not a number): such a reading is impossible, so
    the count, the clock or the measurement is wrong."""
    share = flops / seconds / peak
    if not 0.0 <= share <= 1.0:
        raise ValueError(
            f"{flops / 1e12:.3f} TFLOP in {seconds * 1e3:.3f} ms is "
            f"{share:.1%} of the {peak / 1e12:.0f} TFLOP/s peak: refused")
    return share



# ---- the card ---------------------------------------------------------------

def card_line(index: int = 0) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    of card ``index``."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


class CardSampler:
    """The SM clock (MHz) and power draw (W) of card ``index``, read by one
    ``nvidia-smi -lms`` process every ``period_ms`` while the sampler is
    open (a ``with`` block); only samples taken inside ``recording()``
    windows are kept. ``summary()`` → their median, min and max."""

    def __init__(self, index: int = 0, period_ms: int = 100):
        self.cmd = ["nvidia-smi", "-i", str(index),
                    "--query-gpu=clocks.sm,power.draw",
                    "--format=csv,noheader,nounits", "-lms", str(period_ms)]
        self.samples: List[Tuple[float, float]] = []
        self._recording = threading.Event()
        self._proc: Optional[subprocess.Popen] = None
        self._reader: Optional[threading.Thread] = None

    def __enter__(self) -> "CardSampler":
        self._proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        return self

    def __exit__(self, *exc) -> None:
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._reader.join(timeout=10)

    def _read(self) -> None:
        for line in self._proc.stdout:
            if not self._recording.is_set():
                continue
            try:
                clock, power = (float(x) for x in line.split(","))
            except ValueError:          # "[N/A]" or a partial line
                continue
            self.samples.append((clock, power))

    @contextlib.contextmanager
    def recording(self):
        self._recording.set()
        try:
            yield
        finally:
            self._recording.clear()

    def summary(self) -> Dict[str, dict]:
        if not self.samples:
            raise RuntimeError(f"{' '.join(self.cmd)} gave no sample inside "
                               "the timed windows")
        out = {}
        for key, values in zip(("sm_clock_mhz", "power_w"),
                               zip(*self.samples)):
            out[key] = {"median": statistics.median(values),
                        "min": min(values), "max": max(values),
                        "samples": len(values)}
        return out
