#!/usr/bin/env python
"""Forward and forward+backward time of each part of the conformer block
of the PyTorch/CUDA port on one card, at flagship shapes: the port of
``scripts/block_breakdown.py``.

    python scripts/torch_block_breakdown.py [--batch 32] [--frames 499]
        [--chained] [--device cuda|cpu] [key=value ...]

At ``[B, T, H] = [32, 499, 1024]`` bf16 (fp32 on the CPU) with fp32
parameters (as the train step holds its trainable split), random weights
from a seed (``init_module``), a full mask, no dropout: ``ffn1``
(``AudioFeedForward``),
``attention_flash`` (``RelPositionAttention`` through the flash kernels,
K3 forward and K4 backward), ``conv`` (``ConvModule``), ``block``
(``ConformerBlock``, flash on) and ``attention_xla`` (the plain attention
path of ``models/audio_encoder.py``). The backward takes the gradients of
``sum(out · w)`` for the parameters and the input (the train path's
shape: cotangents flow through every block).

Default: the mean of 20 calls after 3 warm ones, the window ending in a
device sync, beside the device busy ms of one more call
(``torch.profiler``). ``--chained``: ``utils/profile.chained_times``, the
slope between two chain lengths of the module applied to its own
RMS-renormalised output (8 and 24 for ``ffn1`` and ``conv``, 2 and 8
otherwise), each the median of 12 blocked calls over 8 distinct inputs;
a chain that runs out of device memory prints an error record and the tool
goes on, as JAX's does; any other failure raises. K3 and K4 must launch,
or the tool raises. ``key=value`` overrides apply to the audio encoder's
config (``model.audio.<field>`` of ``train.py``'s syntax), to shrink it
for ``--device cpu``, which measures nothing of a device (busy is null);
``--device cuda`` without a card raises. Prints one JSON line a module,
then one JSON line of all.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODULES = ("ffn1", "attention_flash", "conv", "block", "attention_xla")
# chain lengths: memory-light modules get long chains (bigger slope deltas)
CHAINS = {"ffn1": (8, 24), "conv": (8, 24)}
CHAIN = (2, 8)
WARM, TIMED = 3, 20


def audio_configs(overrides=()):
    """The audio encoder's default config with flash on and off, after
    the ``model.audio.*`` overrides."""
    from speech_transcript_embeddings_torch import config as c
    cfg = c.ExperimentConfig().with_overrides(
        c.parse_overrides(list(overrides)))
    audio = dataclasses.replace(cfg.model.audio, use_flash_attention=True)
    return audio, dataclasses.replace(audio, use_flash_attention=False)


def build(name: str, flash_cfg, plain_cfg, dtype, device, gen):
    """Module ``name`` of ``MODULES``, on ``device``, its weights drawn
    from ``gen``, parameters in fp32, computing in ``dtype``."""
    import torch
    from speech_transcript_embeddings_torch.models import audio_encoder as ae
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_module,
    )
    cls = {"ffn1": ae.AudioFeedForward, "attention_flash":
           ae.RelPositionAttention, "conv": ae.ConvModule,
           "block": ae.ConformerBlock,
           "attention_xla": ae.RelPositionAttention}[name]
    cfg = plain_cfg if name == "attention_xla" else flash_cfg
    with torch.device(device):
        mod = cls(cfg, dtype, param_dtype=torch.float32)
    return init_module(mod, gen, device)


def apply(name: str, mod, x, mask):
    """The module's forward (``ffn1`` takes no mask)."""
    return mod(x) if name == "ffn1" else mod(x, mask)


def loss_and_grads(name: str, mod, x, mask, w):
    """``sum(out · w)`` in fp32 and its gradients for the parameters and
    the input (JAX's ``value_and_grad(loss, argnums=(0, 1))``)."""
    import torch
    x = x.detach().requires_grad_(True)
    loss = torch.sum((apply(name, mod, x, mask) * w).float())
    params = list(mod.parameters())
    grads = torch.autograd.grad(loss, [*params, x])
    return loss.detach(), grads[:-1], grads[-1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=499)
    ap.add_argument("--chained", action="store_true",
                    help="the slope between two chain lengths")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", metavar="key=value")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    from speech_transcript_embeddings_torch.inference.embed import (
        resolve_device,
    )
    from speech_transcript_embeddings_torch.utils import bench as ub
    from speech_transcript_embeddings_torch.utils import profile as up
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    flash_cfg, plain_cfg = audio_configs(args.overrides)
    dtype = torch.bfloat16 if cuda else torch.float32
    b, t, h = args.batch, args.frames, flash_cfg.hidden_size
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(b, t, h)).astype(np.float32)
                         ).to(device, dtype)
    mask = torch.ones((b, t), dtype=torch.int32, device=device)
    w = torch.from_numpy(rng.normal(size=(b, t, h)).astype(np.float32)
                         ).to(device, dtype)
    ub.reset_launches()
    results = []
    for name in MODULES:
        mod = build(name, flash_cfg, plain_cfg, dtype, device,
                    torch.Generator(device).manual_seed(0))
        if args.chained:
            k1, k2 = CHAINS.get(name, CHAIN)
            try:
                tf, tg = up.chained_times(
                    lambda c: apply(name, mod, c, mask),
                    list(mod.parameters()), x, sync, k1, k2)
            except torch.cuda.OutOfMemoryError as e:
                rec = {"what": name, "error": type(e).__name__}
                print(json.dumps(rec), flush=True)
                results.append(rec)
                del mod
                torch.cuda.empty_cache()
                continue
            rec = {"what": name, "fwd_ms": tf * 1e3, "fwd_bwd_ms": tg * 1e3,
                   "chain": [k1, k2]}
        else:
            def fwd():
                with torch.no_grad():
                    return apply(name, mod, x, mask)

            def fwd_bwd():
                return loss_and_grads(name, mod, x, mask, w)

            rec = {"what": name,
                   "fwd_ms": ub.timeit(fwd, sync, TIMED, WARM) * 1e3,
                   "fwd_bwd_ms": ub.timeit(fwd_bwd, sync, TIMED, WARM) * 1e3,
                   "fwd_busy_ms": ub.device_busy_ms(fwd) if cuda else None,
                   "fwd_bwd_busy_ms": (ub.device_busy_ms(fwd_bwd) if cuda
                                       else None)}
        print(json.dumps(rec), flush=True)
        results.append(rec)
        del mod
    counts = ub.launches()
    if cuda:
        ub.require_launches(counts, ("K3", "K4"))
    out = {"batch": b, "frames": t, "hidden": h, "dtype": str(dtype),
           "chained": args.chained, "device": str(device),
           "card": ub.card_line(device.index or 0) if cuda else "cpu",
           "results": results, "kernel_launches": counts}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
