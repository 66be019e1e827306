#!/usr/bin/env python
"""Device and host attribution of the headline train step of the
PyTorch/CUDA port on one card: the port of ``scripts/profile_b16.py``.

    python scripts/torch_profile_b16.py [--out runs/torch_profile_b16]
        [--batch 16] [--steps 6] [--parse-only] [--device cuda|cpu]
        [key=value ...]

The step is ``bench_torch.py``'s ``retrieval`` configuration at fixed
10 s clips (``bench_torch.build_config("retrieval", B)``: the retrieval
preset, global InfoNCE, 5+5 unfrozen, bf16 μ, ``save_hot2`` remat), the
port's ``train_step`` with K1-K4 on, one distinct device-resident batch a
step. Two warm steps; then ``--steps`` steps timed without the profiler
(``utils/bench.timed_window``: the untraced step time, and device busy of
one more step), then ``--steps`` more steps under ``torch.profiler``
(``utils/bench.device_trace``), each in a ``ProfilerStep#i`` range, each
phase of the step (frontend, forward, loss, backward, gradient norm,
optimizer, metrics) in the ``phase: <name>`` range that ``train_step``
opens itself (``utils/profile.span``) and each marked module of the model
in a ``module: <name>`` range (``utils/profile.module_ranges``). The trace
is written to ``<out>/trace.json.gz`` (kept out of git) and attributed by
``utils/profile.attribute``:

* the device: kernel time by family (K1-K4, GEMMs, the depthwise
  convolution, …) and the top kernels, summed (``device_ms_per_step``),
  their union (busy), the overlap, the span;
* the host: each op's self time, the top ops;
* the idle gaps of the busy union, each attributed through the launch's
  correlation id to the host op that launched the kernel that ends it,
  by phase, by outermost op (a module range or an autograd node) and by
  innermost op (``aten::…``).

Writes ``<out>/profile_attribution.json`` (JAX's keys, ms a step, plus
the untraced step time and device busy, the overlap, the host's top ops,
the idle time and gaps, the card's name and power limit) and
``<out>/top_ops_full.txt`` (every kernel, whole names). ``--parse-only``
attributes the trace already in ``--out`` again, without a card, and keeps
the earlier file's measured keys. The profiler slows the host, so the
traced wall time a step is not the step time: ``untraced_step_ms`` is.
K1-K4 must launch in the timed steps, or the tool raises. ``--device cpu``
runs the same code at a size the overrides make small and records no
device time (its device keys are null); ``--device cuda`` without a card
raises. Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WARMUP_STEPS = 2
TRACE = "trace.json.gz"


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="runs/torch_profile_b16")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--parse-only", action="store_true",
                    help="attribute the trace already in --out again, "
                         "without a card")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", metavar="key=value")
    return ap.parse_args(argv)


def measure(args) -> dict:
    """The untraced window and the traced steps: → the summary's measured
    keys (the trace written to ``<out>/trace.json.gz``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import bench_torch
    from speech_transcript_embeddings_torch.inference.embed import (
        resolve_device,
    )
    from speech_transcript_embeddings_torch.utils import bench as ub
    from speech_transcript_embeddings_torch.utils import profile as up
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    cfg = bench_torch.build_config("retrieval", args.batch, args.overrides)
    bench = bench_torch.Bench(cfg, device)
    n = args.steps
    batches = [bench.to_device(x) for x in
               bench_torch.fixed_batches(cfg, WARMUP_STEPS + 2 * n)]
    bench.sync()
    rec = ub.timed_window(bench.step, batches[:WARMUP_STEPS],
                          batches[WARMUP_STEPS:WARMUP_STEPS + n], bench.cuda)
    if bench.cuda:
        ub.require_launches(rec["launches"], ("K1", "K2", "K3", "K4"))
    window = (ub.device_trace() if bench.cuda else
              profile(activities=[ProfilerActivity.CPU]))
    marked = up.step_modules(bench.state.model, bench.frontend)
    with up.module_ranges(marked), window as prof:
        t0 = time.perf_counter()
        for i, batch in enumerate(batches[WARMUP_STEPS + n:]):
            with record_function(f"{up.STEP_MARK}{i}"):
                bench.step(batch)
        bench.sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    prof.export_chrome_trace(os.path.join(args.out, TRACE))
    return {"batch": args.batch, "steps": n,
            "config": "retrieval, fixed 10 s clips (bench_torch.py)",
            "device": str(device),
            "card": ub.card_line(device.index or 0) if bench.cuda else "cpu",
            "untraced_step_ms": rec["step_ms"],
            "device_busy_ms": rec["device_busy_ms"],
            "idle_share": rec["idle_share"],
            "clips_per_sec": args.batch / (rec["step_ms"] / 1e3),
            "traced_wall_ms_per_step": wall_ms,
            "kernel_launches": rec["launches"],
            "log_mel_frames": {str(k): v for k, v in
                               rec["log_mel_frames"].items()},
            "marked_modules": len(marked)}


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    from speech_transcript_embeddings_torch.utils import profile as up
    out_json = os.path.join(args.out, "profile_attribution.json")
    if args.parse_only:
        with open(out_json) as f:
            old = json.load(f)
        summary = {k: old[k] for k in (
            "batch", "steps", "config", "device", "card", "untraced_step_ms",
            "device_busy_ms", "idle_share", "clips_per_sec",
            "traced_wall_ms_per_step", "kernel_launches", "log_mel_frames",
            "marked_modules")}
    else:
        summary = measure(args)
    trace = os.path.join(args.out, TRACE)
    agg = up.attribute(up.load_trace(trace), summary["steps"])
    all_ops = agg.pop("all_ops")
    device_ms = agg["device_ms_per_step"]
    summary.update(
        ms_per_step=device_ms,
        clips_per_sec_device=(summary["batch"] / (device_ms / 1e3)
                              if device_ms else None),
        xplane=[trace], **agg)
    with open(out_json, "w") as f:
        json.dump(summary, f, indent=2)
        f.write("\n")
    with open(os.path.join(args.out, "top_ops_full.txt"), "w") as f:
        f.writelines(f"{r['ms_per_step']:8.4f} ms/step  x{r['count']}  "
                     f"{r['op']}\n\n" for r in all_ops)
    line = {k: summary[k] for k in (
        "card", "batch", "steps", "untraced_step_ms", "device_busy_ms",
        "traced_wall_ms_per_step", "device_ms_per_step",
        "device_busy_ms_per_step", "overlap_ms_per_step", "span_ms_per_step",
        "idle_ms_per_step", "idle_attributed_share", "kernels_per_step",
        "by_family", "kernel_launches", "log_mel_frames")}
    line["written"] = out_json
    print(json.dumps(line), flush=True)
    return summary


if __name__ == "__main__":
    main()
