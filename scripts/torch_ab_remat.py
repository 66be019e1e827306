#!/usr/bin/env python
"""A/B the audio encoder's remat policy of the PyTorch/CUDA port on one
card at flagship shapes: the port of ``scripts/ab_remat.py``.

    python scripts/torch_ab_remat.py [--batch=64] [--device cuda|cpu]
        [variant ...] [--set key=value ...]

A variant is a remat policy of the port (``full``: the replay recomputes
the whole block, K3 included; ``save_flash``: the replay reuses the flash
forward's (out, lse); ``save_hot`` and ``save_hot2``: the block also cut
into regions after named activations, ``models/audio_encoder.py``
``REMAT_CUTS``), optionally with suffixes: ``+f32frozen`` stores the
frozen split in fp32 instead of the compute dtype, ``+bf16mu`` keeps
AdamW's μ in bf16, ``+frozenemb`` freezes the text embeddings and the
audio feature projection so that backprop stops at the lowest unfrozen
block. An unknown suffix raises. Default variants: ``full save_flash``.

Each variant runs the flagship step (``utils/bench.flagship_config``:
fusion and word alignment on, pairwise loss, 5+5 unfrozen, K1-K4 on) at
B × 10 s clips, text 64, random weights from a seed, on one distinct
device-resident batch a step (``bench_torch.fixed_batches``): 2 warm
steps, then 10 timed (``utils/bench.timed_window``: the window ends in a
device sync), then device busy of one more step (``torch.profiler``), and
the peak memory. K1-K4 must launch in each variant's timed steps, or the
tool raises. ``--set`` overrides (``train.py``'s syntax) apply to every
variant, to shrink it for ``--device cpu``, which measures nothing of a
device; ``--device cuda`` without a card raises. Prints one line a
variant, then one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

AUDIO_SECONDS = 10
TEXT_LEN = 64
WARMUP_STEPS = 2
MEASURE_STEPS = 10
SUFFIXES = ("f32frozen", "bf16mu", "frozenemb")


def build_config(variant: str, batch: int, overrides=()):
    """ab_remat.py's ``build`` config of ``variant``: the flagship step
    with its remat policy and suffixes applied, then the overrides."""
    from speech_transcript_embeddings_torch.utils import bench as ub
    parts = variant.split("+")
    policy, tags = parts[0], set(parts[1:])
    unknown = tags - set(SUFFIXES)
    if unknown:
        raise SystemExit(f"Unknown variant suffix(es) {sorted(unknown)} in "
                         f"{variant!r} (known: '+f32frozen', '+bf16mu', "
                         "'+frozenemb')")
    train_bottom = "frozenemb" not in tags
    cfg = ub.flagship_config(batch, AUDIO_SECONDS * 16000, TEXT_LEN)
    m = cfg.model
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(m, audio=dataclasses.replace(
            m.audio, remat_policy=policy)),
        freeze=dataclasses.replace(
            cfg.freeze,
            frozen_dtype="float32" if "f32frozen" in tags else None,
            train_text_embeddings=train_bottom,
            train_audio_feature_projection=train_bottom),
        optimizer=dataclasses.replace(
            cfg.optimizer,
            mu_dtype="bfloat16" if "bf16mu" in tags else None))
    from speech_transcript_embeddings_torch import config as c
    return cfg.with_overrides(c.parse_overrides(list(overrides)))


def measure(cfg, device) -> dict:
    """The variant's warm step: → ``utils/bench.timed_window``'s record
    and the peak memory."""
    import torch

    import bench_torch
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    from speech_transcript_embeddings_torch.ops import make_frontend
    from speech_transcript_embeddings_torch.training import train_step as ts
    from speech_transcript_embeddings_torch.utils import bench as ub
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    model = init_model(cfg.model, torch.Generator(device).manual_seed(0),
                       device, train=True)
    state = ts.create_train_state(model, cfg, total_steps=1000)
    frontend = make_frontend(cfg.model.frontend).to(device)
    gen = torch.Generator(device).manual_seed(1)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in bench_torch.fixed_batches(
                   cfg, WARMUP_STEPS + MEASURE_STEPS)]
    rec = ub.timed_window(
        lambda b: ts.train_step(cfg, state, frontend, b, gen),
        batches[:WARMUP_STEPS], batches[WARMUP_STEPS:], cuda)
    rec.pop("log_mel_frames")
    rec["peak_memory_gib"] = (torch.cuda.max_memory_allocated(device)
                              / 2 ** 30 if cuda else None)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", nargs="*", default=[], metavar="key=value",
                    dest="overrides")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    from speech_transcript_embeddings_torch.inference.embed import (
        resolve_device,
    )
    from speech_transcript_embeddings_torch.utils import bench as ub
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        # fp32 products in full fp32, as the training loop runs them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    variants = args.variants or ["full", "save_flash"]
    cfgs = [build_config(v, args.batch, args.overrides) for v in variants]
    results = []
    for variant, cfg in zip(variants, cfgs):
        rec = measure(cfg, device)
        if cuda:
            ub.require_launches(rec["launches"], ("K1", "K2", "K3", "K4"))
        rec = dict(variant=variant, batch=args.batch,
                   clips_per_s=args.batch / (rec["step_ms"] / 1e3), **rec)
        results.append(rec)
        busy = (f", device busy {rec['device_busy_ms']:.1f} ms, peak "
                f"{rec['peak_memory_gib']:.2f} GiB" if cuda else "")
        print(f"{variant}: B={args.batch} {rec['step_ms']:.1f} ms/step "
              f"({rec['clips_per_s']:.1f} clips/s){busy}", flush=True)
    out = {"batch": args.batch, "device": str(device),
           "card": ub.card_line(device.index or 0) if cuda else "cpu",
           "step_ms": {r["variant"]: r["step_ms"] for r in results},
           "results": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
