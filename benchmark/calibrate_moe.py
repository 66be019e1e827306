#!/usr/bin/env python
"""The readings that the limits of ``correct`` of the DeepSeek-V2 text
embed cell and of the data-parallel train cell are set from, on the card,
several seeds in one process:

    python benchmark/calibrate_moe.py --workload <name> --seeds 1,2,3
        --what program,control[,<fault>…] [--seconds 3]

* ``program``: the cell's entry as a run drives it, with a window of
  ``--seconds``;
* ``control``: the plain reference computed with every product's operands
  in float8 e4m3 (the precision below the configuration's bf16) against
  the fp32 reference, on the cell's own sample (the embed cell: the first
  batches of the cycle; the train cell: the first three global batches,
  on one card);
* a fault put into the program, then the entry as a run drives it. The
  embed cell's (``FAULTS``): ``renormalised`` (the top-k weights
  renormalised to sum 1), ``no_shared`` (the shared experts left out),
  ``no_deinterleave`` (rope on the published interleaved pairs as they
  lie), ``no_yarn_scale`` (the attention scale without YaRN's mscale²),
  ``expert_off_by_one`` (each token sent to the expert after the one it
  chose); the train cell's: ``train_dp.VARIANTS``.

One JSON line a seed and reading, judged on the cell's limits
(``common.judge``: ``correct`` and each compared number beside its limit).
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _renormalised(ds):
    route = ds.route
    ds.route = lambda logits, c: route(
        logits, dataclasses.replace(c, norm_topk_prob=True))
    return [(ds, "route", route)]


def _no_shared(ds):
    init = ds.MoE.__init__

    def patched(self, *args, **kw):
        init(self, *args, **kw)
        self.shared_experts.forward = lambda x: x * 0
    ds.MoE.__init__ = patched
    return [(ds.MoE, "__init__", init)]


def _no_deinterleave(ds):
    original = ds.deinterleave
    ds.deinterleave = lambda x: x
    return [(ds, "deinterleave", original)]


def _no_yarn_scale(ds):
    original = ds.softmax_scale
    ds.softmax_scale = lambda c: (c.qk_nope_head_dim
                                  + c.qk_rope_head_dim) ** -0.5
    return [(ds, "softmax_scale", original)]


def _expert_off_by_one(ds):
    route = ds.route

    def shifted(logits, c):
        weights, experts = route(logits, c)
        return weights, (experts + 1) % c.n_routed_experts
    ds.route = shifted
    return [(ds, "route", route)]


FAULTS = {"renormalised": _renormalised, "no_shared": _no_shared,
          "no_deinterleave": _no_deinterleave,
          "no_yarn_scale": _no_yarn_scale,
          "expert_off_by_one": _expert_off_by_one}


def with_fault(name: str, fn):
    """``fn()`` with the fault ``name`` put into the program's DeepSeek-V2
    module, taken out again after."""
    from speech_transcript_embeddings_torch.models import deepseek_v2 as ds
    undo = FAULTS[name](ds)
    try:
        return fn()
    finally:
        for owner, attr, original in undo:
            setattr(owner, attr, original)


def text_control(torch, cell, seed: int, device) -> dict:
    """The fp8 reference against the fp32 one on a sample of the cycle's
    first batches, drawn as a run draws it."""
    import numpy as np

    from benchmark import traffic
    from benchmark.entries import embed_text, embedding
    pool = embed_text.text_pool(torch, cell.mix, seed,
                                cell.config["model"]["text"]["vocab_size"],
                                1, device)
    rows = [(i, r) for i in range(2) for r in range(len(pool[i][0]))]
    rng = np.random.default_rng(traffic.sub_seed(seed, "sample"))
    picked = [rows[j] for j in embedding.sample(
        rng, [int(pool[i][1][r].sum()) for i, r in rows], cell.mix["sample"])]
    ids = np.stack([pool[i][0][r] for i, r in picked])
    mask = np.stack([pool[i][1][r] for i, r in picked])
    fp32 = embed_text.reference(torch, cell.config, seed, ids, mask, device)
    fp8 = embed_text.reference(torch, cell.config, seed, ids, mask, device,
                               "fp8")
    return {"embedding_gap": embedding.embedding_gap(fp8[0], fp32[0]),
            "route_flip_share": embed_text.flip_share(fp8[1], fp32[1], mask)}


def train_control(torch, cell, seed: int, device) -> dict:
    from benchmark.entries import train
    prog = train.Program(torch, cell, seed, device)
    batches = prog.first_batches()
    del prog
    torch.cuda.empty_cache()
    ref = train.reference_first_steps(torch, cell.config, seed, batches,
                                      device)
    fp8 = train.reference_first_steps(torch, cell.config, seed, batches,
                                      device, "fp8")
    numbers, worst = train.readings(fp8, ref)
    return dict(numbers, **worst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    import importlib

    import torch

    from benchmark import common, run
    if not torch.cuda.is_available():
        print("calibrate_moe: no CUDA card", file=sys.stderr)
        return 4
    cell = common.find_cell(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    entry = importlib.import_module(f"benchmark.entries.{cell.mix['entry']}")
    dp = cell.mix["entry"] == "train_dp"
    for seed in (int(s) for s in args.seeds.split(",")):
        for what in args.what.split(","):
            t = time.time()
            ctx = run.Context(torch, device, seed, args.seconds, False,
                              time.time())
            if what == "control":
                readings = (train_control if dp else text_control)(
                    torch, cell, seed, device)
            elif dp:
                out = entry.run(ctx, cell,
                                None if what == "program" else what)
                readings = dict(out["readings"], **out["end_to_end"])
            else:
                go = lambda: entry.run(ctx, cell)
                out = go() if what == "program" else with_fault(what, go)
                readings = dict(out["readings"], **out["end_to_end"])
            torch.cuda.empty_cache()
            correct, checks = common.judge(readings, cell.limits)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "what": what, "readings": readings,
                              "correct": correct, "checks": checks,
                              "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
