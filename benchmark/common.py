"""The parts every entry of the benchmark shares: finding a cell by name,
building the program's configuration and model from a configuration file,
the no-JAX check, the per-layer metrics' readers and the judgement of
``correct``.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``);
the mix's ``entry`` names the module of ``entries/`` that drives the
program, and ``limits/<cell>.json`` holds the limits of the numbers that
decide ``correct``. A per-layer metric is ``metrics/<name>.py``. Each is
found by its name: a cell, a mix, a configuration or a metric is added by
adding files and entries, never by editing one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the whole top-level names a run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "speech_transcript_embeddings_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    here: str = HERE


def find_cell(name: str, bench: Optional[dict] = None,
              here: str = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``) with its
    configuration, mix, limits and the metrics it reports, from the
    benchmark's folder ``here``."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(os.path.dirname(here), conf["file"])
    mix = load_json(here, "traffic", f"{w['traffic']}.json")
    limits = load_json(here, "limits", f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, w["chips"], config, mix, limits, e2e, per_layer, here)


def process_start() -> float:
    """The wall-clock time this process started (``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def host_cpu() -> Tuple[List[int], float]:
    """The host's CPU counters (``/proc/stat``'s ``cpu`` line: user, nice,
    system, idle, iowait, irq, softirq, steal, in ticks) and this process's
    CPU seconds; ([], seconds) where there is no ``/proc/stat``."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        ticks = []
    t = os.times()
    return ticks, t.user + t.system


def host_load(before: Tuple[List[int], float], seconds: float
              ) -> Dict[str, float]:
    """The host's CPU between ``before`` (``host_cpu()``) and now, over a
    window of ``seconds``: the shares of its time stolen by other guests of
    the machine and busy, and this process's CPU seconds per second."""
    ticks, cpu_s = host_cpu()
    out = {"process_cpu_per_s": (cpu_s - before[1]) / seconds}
    d = [a - b for a, b in zip(ticks, before[0])]
    if d and sum(d) > 0:
        out["steal_share"] = d[7] / sum(d)
        out["busy_share"] = (sum(d) - d[3] - d[4] - d[7]) / sum(d)
    return out


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose whole top-level name is one of
    ``FORBIDDEN`` (``speech_transcript_embeddings_torch`` is not
    ``speech_transcript_embeddings_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


# ---- the program ------------------------------------------------------------

def port_config(config: dict, mix: dict):
    """The program's ``ExperimentConfig`` of a configuration file and a
    mix (its batch, transcript length and buckets)."""
    from speech_transcript_embeddings_torch.config import ExperimentConfig
    data = {"batch_size": mix.get("batch", mix.get("max_batch")),
            "max_text_length": mix.get("text_len", 64),
            "audio_buckets": mix["buckets"],
            "max_audio_samples": mix["max_samples"]}
    return ExperimentConfig().with_overrides({
        "model": config["model"], "freeze": config["freeze"],
        "loss": config["loss"], "optimizer": config["optimizer"],
        "data": data, "train": {"accumulation_steps": 1, "num_epochs": 1}})


def build_model(torch, cfg, weights: Dict, train: bool, device):
    """The program's model of ``cfg`` holding ``weights`` (name → tensor):
    the training form (fp32 weights) or the serving one (weights in the
    compute dtype, eval, no gradients). Its own initialiser never runs."""
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        DualEncoderModel,
    )
    with torch.device(device):
        model = DualEncoderModel(cfg.model, torch.float32 if train else None)
    model.load_state_dict(weights, strict=True)
    if train:
        return model
    return model.eval().requires_grad_(False)


class Phases:
    """Seconds of the named phases of a set-up, for the run's notes."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now

    def skip(self) -> None:
        """Leave the time since the last mark out of every phase."""
        self.t = time.perf_counter()

    def note(self) -> str:
        return "set-up, s: " + ", ".join(f"{k} {v:.2f}"
                                         for k, v in self.seconds.items())


# ---- per-layer metrics ------------------------------------------------------

class RunInfo:
    """What a per-layer metric's reader may read of a run: the cell's
    ``config`` and ``mix``, the entry's ``window`` (seconds, steps, clips,
    model FLOPs), its ``stretch`` (the traced stretch: its steps, the
    attention calls it made, ``summary`` of its trace, ``window_s``), and
    the card's ``peak_flops`` and ``peak_bytes`` (per second)."""

    def __init__(self, cell: Cell, out: dict, summary: dict,
                 peak_flops: float, peak_bytes: float):
        self.entry = cell.mix["entry"]
        self.config, self.mix = cell.config, cell.mix
        self.window = out.get("window")
        self.stretch = dict(out["stretch"], summary=summary)
        self.peak_flops, self.peak_bytes = peak_flops, peak_bytes


def read_metrics(cell: Cell, run) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader
    (``metrics/<name>.py`` ``read(run)``) finds something for."""
    out = {}
    for m in cell.per_layer:
        path = os.path.join(cell.here, "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{m['name'].replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        value = module.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# ---- correct ----------------------------------------------------------------

def judge(readings: Dict[str, float], limits: dict
          ) -> Tuple[bool, Dict[str, dict]]:
    """Each reading that the cell compares (``limits`` names it) beside its
    limit; correct when every one is a number at or under its limit. A
    reading the cell does not compare stays in the run's report."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings[name]
        checks[name] = {"value": value, "limit": limit}
        if not (value == value and value <= limit):      # NaN fails
            ok = False
    return ok, checks


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    """Each leaf's gap between two norms: |prog − ref| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    vals = sorted(ref[k] for k in keep)
    median = vals[len(vals) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in keep}


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    """The largest gap and its leaf (a NaN is the largest)."""
    at = max(gaps, key=lambda k: float("inf") if gaps[k] != gaps[k]
             else gaps[k])
    return gaps[at], at
