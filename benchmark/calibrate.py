#!/usr/bin/env python
"""The readings that a cell's limits of ``correct`` are set from, on the
card, several seeds in one process:

    python benchmark/calibrate.py --workload <name> --seeds 1,2,3
        --what program,control[,half_batch] [--seconds 5]

* ``program``: the program as a run drives it (a train cell: its first
  three steps, no window; an embed cell: a window of ``--seconds``);
* ``control``: the nearest lower precision in the program's place: for a
  train cell the reference with every product's operands in float8 e4m3,
  for an embed cell the program's own int8 path
  (``Embedder.quantize_int8``);
* ``half_batch`` (train cells): the program with half of each batch left
  out of the loss, its mean taken over the rest.

Each is compared with the fp32 reference as a run compares it; one JSON line
a seed and reading. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def half_batch_loss(losses_module):
    """A patch of the program's ``compute_loss`` that leaves out the second
    half of each batch: → (patched, the original)."""
    original = losses_module.compute_loss

    def patched(cfg, out, axis_name=None, group=None):
        half = out.text_pos.shape[0] // 2
        cut = lambda t: None if t is None else t[:half]
        return original(cfg, out._replace(
            text_pos=cut(out.text_pos), text_neg=cut(out.text_neg),
            audio=cut(out.audio), alignment_scores=cut(out.alignment_scores),
            alignment_matrix=cut(out.alignment_matrix)), axis_name, group)
    return patched, original


def train_readings(torch, cell, seed, whats, device):
    from benchmark.entries import train
    from speech_transcript_embeddings_torch.training import losses
    prog = train.Program(torch, cell, seed, device)
    batches = prog.first_batches()
    first = prog.first_steps() if "program" in whats else None
    del prog
    half = None
    if "half_batch" in whats:
        patched, original = half_batch_loss(losses)
        losses.compute_loss = patched
        try:
            fault = train.Program(torch, cell, seed, device)
            half = fault.first_steps()
            del fault
        finally:
            losses.compute_loss = original
    torch.cuda.empty_cache()
    ref = train.reference_first_steps(torch, cell.config, seed, batches,
                                      device)
    out = {}
    if first is not None:
        out["program"] = train.readings(first, ref)
    if half is not None:
        out["half_batch"] = train.readings(half, ref)
    if "control" in whats:
        control = train.reference_first_steps(torch, cell.config, seed,
                                              batches, device, "fp8")
        out["control"] = train.readings(control, ref)
    return {k: dict(v[0], **v[1]) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                    help="change a key of the configuration file for both "
                         "sides (a diagnosis, never a cell's limits)")
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    import importlib

    import torch

    from benchmark import common, run
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 4
    cell = common.find_cell(args.workload)
    for item in args.set:
        key, _, value = item.partition("=")
        *path, last = key.split(".")
        node = cell.config
        for p in path:
            node = node[p]
        node[last] = json.loads(value)
    device = torch.device("cuda", 0)
    whats = args.what.split(",")
    entry = importlib.import_module(f"benchmark.entries.{cell.mix['entry']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        if cell.mix["entry"] == "train":
            readings = train_readings(torch, cell, seed, whats, device)
        else:
            readings = {}
            for what in whats:
                ctx = run.Context(torch, device, seed, args.seconds, False,
                                  time.time())
                out = entry.run(ctx, cell,
                                "int8" if what == "control" else None)
                readings[what] = dict(out["readings"],
                                      **out["end_to_end"])
                torch.cuda.empty_cache()
        for what, r in readings.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "what": what, "readings": r,
                              "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
