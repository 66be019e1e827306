#!/usr/bin/env python
"""Run one cell of ``BENCHMARK.json`` once, on the card this process finds:

    python benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The run makes its weights and inputs from ``--seed``, warms up the cell's
shapes (``setup_s``: from the process's start to the window's), measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also end standard error.

It exits non-zero and prints no result without a CUDA card (or fewer than
the cell asks for), outside a checkout of the repository, or when a module
of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(code: int, message: str):
    print(f"benchmark: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


class Context:
    """What an entry needs of the run: torch, the device, the seed, the
    window's length, whether to trace, the set-up clock, and the device's
    synchronisation and memory readings. ``card`` holds the card's clock
    and power over the traced stretch (``stretch``)."""

    def __init__(self, torch, device, seed: int, seconds: float,
                 trace: bool, start: float):
        self.torch, self.device = torch, device
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.start = start
        self.setup_s = None
        self.card: dict = {}

    def sync(self) -> None:
        self.torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak_memory(self) -> int:
        return self.torch.cuda.max_memory_allocated(self.device)

    def free(self) -> None:
        """Give the cached blocks of freed tensors back to the card."""
        import gc
        gc.collect()
        self.torch.cuda.empty_cache()

    def mark_setup(self) -> None:
        """Set-up ends: the next line of the entry opens the window."""
        self.sync()
        self.setup_s = time.time() - self.start
        from benchmark import common
        self._cpu = common.host_cpu()

    def host_load(self, seconds: float) -> dict:
        """The host's CPU over the window (``common.host_load``)."""
        from benchmark import common
        return common.host_load(self._cpu, seconds)

    @contextlib.contextmanager
    def stretch(self):
        """The traced stretch, after the window: the profiler records it
        and ``nvidia-smi`` samples the card's clock and power in it. Nothing
        samples the card in the window, whose host clock it would share."""
        from benchmark import card, trace
        path = os.path.join(tempfile.gettempdir(),
                            f"benchmark_trace_{os.getpid()}.json")
        with card.CardSampler(0) as sampler:
            with sampler.recording(), trace.Stretch(self.torch, path) as s:
                yield s
        with contextlib.suppress(RuntimeError):
            self.card = sampler.summary()


def assemble(cell, ctx, out: dict, device: dict, peak_flops: float,
             peak_bytes: float) -> dict:
    """The result line of an entry's output ``out``; ``device`` holds the
    platform, kind, count and peak memory."""
    from benchmark import common, trace
    correct, checks = common.judge(out["readings"], cell.limits)
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if ctx.trace:
        s = out["stretch"]
        summary = trace.summarize(s["events"])
        run = common.RunInfo(cell, out, summary, peak_flops, peak_bytes)
        device = dict(device, busy_s=summary["busy_us"] / 1e6,
                      window_s=s["window_s"])
        result.update(metrics=common.read_metrics(cell, run), device=device,
                      breakdown={"device_ops": summary["top_ops"],
                                 "idle_gaps": summary["idle_gaps"]})
    else:
        # ``train_clips_per_s.b64`` is the entry's ``train_clips_per_s``,
        # split by cell so that each cell has a bound of its own
        metrics = {m["name"]: {"value": out["end_to_end"][
                                   m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
        result.update(metrics=metrics, device=device)
    # every number the cell could compare, beside what the limits name
    result["report"] = dict(out.get("report", {}), readings=out["readings"])
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "speech_transcript_embeddings_"
                                      "torch")):
        fail(3, f"{ROOT} holds no speech_transcript_embeddings_torch: run "
                "from a checkout of the repository")
    # every build and kernel cache of the run lives in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"          # transformers: no JAX
    # one process with few threads: no CPU thread pool beside the
    # dispatching threads (the timed paths run no CPU tensor work)
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, ROOT)
    from benchmark import common
    start = common.process_start()
    import torch
    torch.set_num_threads(1)
    cell = common.find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        fail(4, f"{args.workload} needs {cell.chips} CUDA card(s); "
                f"found {found}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    import importlib
    entry = importlib.import_module(f"benchmark.entries.{cell.mix['entry']}")
    from benchmark import card
    kind = torch.cuda.get_device_name(device)
    ctx = Context(torch, device, args.seed, args.seconds, bool(args.trace),
                  start)
    out = entry.run(ctx, cell)
    loaded = common.forbidden_modules()
    if loaded:
        fail(5, "modules of JAX or of the JAX package were loaded: "
                + ", ".join(loaded))
    dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = assemble(cell, ctx, out, dev, card.peak_bf16(kind),
                      card.HBM_BYTES_PER_S[kind])
    checks = result.pop("checks")
    result["card"] = {"line": card.card_line(0), **ctx.card}
    result["checks"] = checks
    for line in out.get("notes", []):
        print(line, file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
