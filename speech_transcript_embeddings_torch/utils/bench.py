"""The measuring parts of the port's benchmark tools (``bench_torch.py``,
``scripts/torch_infer_bench.py``, ``scripts/torch_mfu.py``).

* The CV clip-length mix of ``bench.py`` (its ``_sample_cv_lengths``, copied
  here: the port imports nothing of the JAX side) and its bucketing: each
  clip padded to the smallest bucket that holds it, each bucket batched
  with the remainder dropped, as the training pipeline batches.
* ``count_flops``: the matrix products of one call, counted by
  ``torch.utils.flop_counter``'s formulas with the kernels off, so that
  the plain versions' products are seen (a hand-written kernel is opaque
  to the counter). ``scripts/mfu.py`` counts the same way through XLA's cost
  analysis of a compile with the Pallas kernels off. A train step's count
  holds the remat replay: its ratio to the peak is HFU; a forward's is MFU.
* ``ceiling``: no reading above the card's bf16 peak is printed
  (``PEAK_BF16``; an unknown card raises).
* ``CardSampler``: the SM clock and power draw ``nvidia-smi`` reads during
  the timed windows; ``card_line``: the card's name and power limit.
* The K1-K4 launch counts, and a call's device time by ``torch.profiler``.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import statistics
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# dense bf16 tensor-core peak by card name, at the card's full power limit
# (NVIDIA's H100 data sheet, SXM part: 989 TFLOP/s)
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}

# the four ported TPU kernels → their launch counters
KERNELS = {"K1": "log_mel_normalize", "K2": "log_mel",
           "K3": "flash_rel_fwd_wgmma", "K4": "flash_rel_bwd_wgmma"}


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


def flagship_config(batch: int, asamps: int, tlen: int, overrides=()):
    """The flagship experiment config of ``scripts/mfu.py``,
    ``step_decompose.py`` and ``ab_remat.py``: the flagship model, 5+5
    unfrozen, AdamW at 5e-5 with 100 warmup steps, one bucket of
    ``asamps``; then the ``key=value`` overrides."""
    from speech_transcript_embeddings_torch import config as c
    cfg = c.ExperimentConfig(
        model=c.flagship_model_config(),
        freeze=c.FreezeConfig(mode="partial", text_layers_to_unfreeze=5,
                              audio_layers_to_unfreeze=5),
        optimizer=c.OptimizerConfig(learning_rate=5e-5, warmup_steps=100),
        data=c.DataConfig(batch_size=batch, max_text_length=tlen,
                          audio_buckets=(asamps,), max_audio_samples=asamps),
        train=c.TrainConfig(num_epochs=1, accumulation_steps=1))
    return cfg.with_overrides(c.parse_overrides(list(overrides)))


# ---- bench.py's clip-length mix ---------------------------------------------

def sample_cv_lengths(n: int, rng: np.random.Generator) -> np.ndarray:
    """Clip lengths (samples at 16 kHz) from bench.py's Common Voice pt
    approximation: lognormal(median 4.2 s, σ_log 0.45), mean ≈ 4.65 s,
    clipped to [1, 30] s."""
    secs = np.clip(rng.lognormal(np.log(4.2), 0.45, size=n), 1.0, 30.0)
    return (secs * 16000).astype(np.int64)


def bucket_mix(lengths: Sequence[int], buckets: Sequence[int],
               max_samples: int, batch: int
               ) -> List[Tuple[int, List[int], int]]:
    """[(bucket, its clips' lengths, full batches)] of each bucket with at
    least one full batch, shortest first: a clip is capped at
    ``max_samples`` and goes to the smallest bucket that holds it (the
    largest when none does); a bucket's remainder is dropped."""
    buckets = sorted(buckets)
    per_bucket: Dict[int, List[int]] = {b: [] for b in buckets}
    for n in lengths:
        n = min(int(n), max_samples)
        per_bucket[buckets[min(bisect.bisect_left(buckets, n),
                               len(buckets) - 1)]].append(n)
    return [(b, ns, len(ns) // batch) for b, ns in per_bucket.items()
            if len(ns) >= batch]


def mix_string(mix) -> str:
    """bench.py's description of a mix: ``2s×18 5s×71 10s×35 15s×3``."""
    return " ".join(f"{b // 16000}s×{k}" for b, _, k in mix)


# ---- counts ----------------------------------------------------------------

def reset_launches() -> None:
    """Every kernel wrapper's launch count (and int8 products) to 0."""
    from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    from speech_transcript_embeddings_torch.ops import layer_norm as ln
    from speech_transcript_embeddings_torch.ops import quant
    fk.log_mel.launches = 0
    fk.log_mel.launches_by_frames.clear()
    fk.normalize_and_stack.launches = 0
    fa.LAUNCHES.clear()
    ln.LAUNCHES.clear()
    dg.LAUNCHES.clear()
    quant.int8_matmul.launches = 0


def launches() -> Dict[str, int]:
    """Launches since ``reset_launches``: each kernel by its counter's name
    (the CUDA-core flash pair, the LayerNorm and depthwise GLU kernels
    too), and ``int8_matmul``."""
    from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    from speech_transcript_embeddings_torch.ops import layer_norm as ln
    from speech_transcript_embeddings_torch.ops import quant
    return {"log_mel": fk.log_mel.launches,
            "log_mel_normalize": fk.normalize_and_stack.launches,
            **{k: fa.LAUNCHES[k] for k in ("flash_rel_fwd_wgmma",
                                           "flash_rel_bwd_wgmma",
                                           "flash_rel_fwd", "flash_rel_bwd")},
            **{k: ln.LAUNCHES[k] for k in ("layer_norm_fwd",
                                           "layer_norm_bwd_dx",
                                           "layer_norm_bwd_dgamma")},
            **{k: dg.LAUNCHES[k] for k in ("depthwise_glu_fwd",
                                           "depthwise_glu_bwd_dx",
                                           "depthwise_glu_bwd_dw")},
            "int8_matmul": quant.int8_matmul.launches}


def log_mel_frames() -> Dict[int, int]:
    """Log-mel launches since ``reset_launches``, by frame count."""
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    return dict(fk.log_mel.launches_by_frames)


def require_launches(counts: Dict[str, int], kernels: Sequence[str]) -> None:
    """Raise unless each of ``kernels`` (K1-K4) launched."""
    missing = [k for k in kernels if counts[KERNELS[k]] == 0]
    if missing:
        raise RuntimeError(f"{', '.join(missing)} never launched in the "
                           f"timed steps: {counts}")


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape, **kwargs) -> int:
    """``aten.convolution_backward``'s FLOPs: torch's formula, but for the
    weight gradient 2 a weight element for each batch row and position it
    meets. Torch's own multiplies that by every input channel of the
    layer, ignoring groups: a depthwise kernel's gradient (the conformer's
    conv module) would count H times its work."""
    from torch.utils.flop_counter import conv_flop_count
    flops = 0
    if output_mask[0]:
        flops += conv_flop_count(grad_out_shape, w_shape, out_shape[0],
                                 not transposed)
    if output_mask[1]:
        positions = (x_shape if transposed else grad_out_shape)[2:]
        flops += 2 * int(np.prod(w_shape)) * x_shape[0] * int(
            np.prod(positions))
    return flops


def counting_config(cfg):
    """``cfg`` (an ``ExperimentConfig``) with the kernels off: the model
    and frontend whose products ``count_flops`` sees."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, audio=dataclasses.replace(m.audio, use_flash_attention=False),
        frontend=dataclasses.replace(m.frontend, use_pallas=False)))


class _ProductCounter(TorchDispatchMode):
    """Sums torch's FLOP formulas (``flop_counter``'s registry, with
    ``_conv_backward_flops`` in place of its own) over the ops run under
    it. ``FlopCounterMode`` itself also attributes FLOPs to modules, and its
    module hooks keep every module's output alive to the backward: that
    undoes remat (a B = 64 flagship step ran out of the card's 80 GB under
    it). This mode holds nothing of what it sees."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: _conv_backward_flops
        }).flop_registry
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula = self.registry.get(func._overloadpacket)
        if formula is None:
            # a composite op is counted by the products it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


def count_flops(fn, *args, **kwargs) -> int:
    """The FLOPs of the matrix products of ``fn(*args, **kwargs)`` (2·M·N·K
    a product; convolutions likewise), by torch's formulas. Call it on a
    model and frontend built with the kernels off: a kernel's products are
    not seen, and a launch during the count raises, but for the kernels
    the card always runs: the LayerNorm kernels compute no products, and
    the depthwise GLU kernels' taps (2·K FLOPs a channel and frame, 1.5% of
    the GLU's input product at K = 31, H = 1024) go uncounted on the card
    (on the CPU they are the chain's convolution, and counted)."""
    def product_launches():
        return {k: n for k, n in launches().items()
                if not k.startswith(("layer_norm", "depthwise_glu"))}

    before = product_launches()
    counter = _ProductCounter()
    with counter:
        fn(*args, **kwargs)
    if product_launches() != before:
        raise RuntimeError("a kernel launched while counting FLOPs: count "
                           "with use_flash_attention and use_pallas off")
    return counter.flops


# torch.profiler keeps only the device records whose times fall inside its
# window on the host clock, and a kernel's recorded start can stand
# milliseconds off its launch on the host (scripts/torch_trace_skew.py
# measures it): a kernel launched at the window's edge can be dropped. The
# window is padded by this much on both sides.
TRACE_PAD_S = 0.05


@contextlib.contextmanager
def device_trace():
    """A ``torch.profiler`` window over the host and the device, padded by
    ``TRACE_PAD_S`` on both sides; the work inside it has ended on the
    device before the closing pad. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


def device_busy_ms(fn) -> float:
    """The device time of one call of ``fn`` in ms: the summed self time of
    the device kernels ``torch.profiler`` records."""
    with device_trace() as prof:
        fn()
    return sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def timeit(fn, sync, n: int, warmup: int) -> float:
    """The JAX scripts' ``timeit``: the mean seconds of ``n`` calls of
    ``fn`` after ``warmup``, the window ending in ``sync()`` (a device sync
    on a card)."""
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) / n


def timed_window(step, warm, timed, cuda: bool, sampler=None) -> dict:
    """``step`` on each of ``warm``, then timed on each of ``timed`` (one
    distinct input a step; the window ends in a device sync; the launches
    counted from zero and the card sampled), then on ``warm[0]`` once more
    under ``torch.profiler`` (a card only): → ``timed_steps``, ``step_ms``,
    ``device_busy_ms`` and ``idle_share`` (None off a card), ``launches``
    and ``log_mel_frames`` of the timed steps."""
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for x in warm:
        step(x)
    sync()
    reset_launches()
    with sampler.recording() if sampler else contextlib.nullcontext():
        t0 = time.perf_counter()
        for x in timed:
            step(x)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / len(timed)
    out = dict(timed_steps=len(timed), step_ms=ms, device_busy_ms=None,
               idle_share=None, launches=launches(),
               log_mel_frames=log_mel_frames())
    if cuda:
        busy = device_busy_ms(lambda: step(warm[0]))
        out.update(device_busy_ms=busy, idle_share=1 - busy / ms)
    return out


# ---- the card --------------------------------------------------------------

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
