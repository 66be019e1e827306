#!/usr/bin/env python
"""The text encoder's share of the flagship train step of the PyTorch/CUDA
port on one card: the port of ``scripts/text_share.py``.

    python scripts/torch_text_share.py [--batch 128] [--tlen 128]
        [--device cuda|cpu] [key=value ...]

Times ``TextEncoder`` forward and forward+backward (gradients for its
parameters) at the train path's shape, ``[2B, T] = [128, 128]`` (the
clean and corrupted transcripts of a B = 64 batch folded into one call, as
``forward_pos_neg`` does), and one ``TextSelfAttention`` (the q/k/v and
output projections and the LayerNorm; gradients for its parameters and
its input), at the flagship text geometry (12 × 768), bf16 with fp32
parameters, the encoder's remat as the flagship model sets it, random
weights from a seed (``init_module``), no dropout. Each reading is the
mean of 10 calls after 2 warm ones over 12 distinct inputs, the window
ending in a device sync, beside the device busy ms of one more call
(``torch.profiler``). Compare with the whole step's time
(``scripts/torch_ab_remat.py``). ``key=value`` overrides (``train.py``'s
syntax) apply to the flagship model config, to shrink it for ``--device
cpu`` (fp32 there), which measures nothing of a device (busy is null);
``--device cuda`` without a card raises. Prints one line a module, then
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_INPUTS, WARM, TIMED = 12, 2, 10


def model_config(overrides=()):
    """The flagship model config after the ``model.*`` overrides."""
    from speech_transcript_embeddings_torch import config as c
    return c.ExperimentConfig(model=c.flagship_model_config()).with_overrides(
        c.parse_overrides(list(overrides))).model


def build(name: str, mcfg, dtype, device, gen):
    """``encoder`` (``TextEncoder``, the flagship's remat) or
    ``attention`` (``TextSelfAttention``), fp32 parameters drawn from
    ``gen``, computing in ``dtype``."""
    import torch
    from speech_transcript_embeddings_torch.models import text_encoder as te
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_module,
    )
    with torch.device(device):
        mod = (te.TextEncoder(mcfg.text, dtype, torch.float32,
                              remat=mcfg.remat) if name == "encoder" else
               te.TextSelfAttention(mcfg.text, dtype, torch.float32))
    return init_module(mod, gen, device)


def loss_and_grads(mod, inp, mask, w, wrt_input: bool):
    """``sum(out · w)`` in fp32 and its gradients for the parameters (and
    the input where ``wrt_input``: JAX's ``argnums=(0, 1)``)."""
    import torch
    if wrt_input:
        inp = inp.detach().requires_grad_(True)
    loss = torch.sum((mod(inp, mask) * w).float())
    params = list(mod.parameters())
    grads = torch.autograd.grad(loss, params + ([inp] if wrt_input else []),
                                allow_unused=True)
    return loss.detach(), grads[:len(params)], (grads[-1] if wrt_input
                                                else None)


def timeit(fn, inputs, sync) -> float:
    """text_share.py's ``timeit``: the mean seconds of ``TIMED`` calls
    after ``WARM``, cycling over ``inputs``, the window ending in a sync."""
    for i in range(WARM):
        fn(inputs[i % len(inputs)])
    sync()
    t0 = time.perf_counter()
    for i in range(TIMED):
        fn(inputs[i % len(inputs)])
    sync()
    return (time.perf_counter() - t0) / TIMED


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128,
                    help="folded batch (2x the clip batch: pos+neg)")
    ap.add_argument("--tlen", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", metavar="key=value")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    from speech_transcript_embeddings_torch.inference.embed import (
        resolve_device,
    )
    from speech_transcript_embeddings_torch.utils import bench as ub
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dtype = torch.bfloat16 if cuda else torch.float32
    mcfg = model_config(args.overrides)
    tcfg = mcfg.text
    b, t = args.batch, args.tlen
    rng = np.random.default_rng(0)
    ids = [torch.from_numpy(rng.integers(4, tcfg.vocab_size, size=(b, t))
                            .astype(np.int32)).to(device)
           for _ in range(N_INPUTS)]
    mask = torch.ones((b, t), dtype=torch.int32, device=device)
    xs = [torch.from_numpy(rng.normal(size=(b, t, tcfg.hidden_size))
                           .astype(np.float32)).to(device, dtype)
          for _ in range(N_INPUTS)]
    w = torch.from_numpy(rng.normal(size=(b, t, tcfg.hidden_size))
                         .astype(np.float32)).to(device, dtype)
    results = []
    for name, inputs, wrt_input in (("encoder", ids, False),
                                    ("attention", xs, True)):
        mod = build(name, mcfg, dtype, device,
                    torch.Generator(device).manual_seed(0))

        def fwd(inp):
            with torch.no_grad():
                return mod(inp, mask)

        def fwd_bwd(inp):
            return loss_and_grads(mod, inp, mask, w, wrt_input)

        rec = {"what": name, "fwd_ms": timeit(fwd, inputs, sync) * 1e3,
               "fwd_bwd_ms": timeit(fwd_bwd, inputs, sync) * 1e3,
               "fwd_busy_ms": (ub.device_busy_ms(lambda: fwd(inputs[0]))
                               if cuda else None),
               "fwd_bwd_busy_ms": (ub.device_busy_ms(
                   lambda: fwd_bwd(inputs[0])) if cuda else None)}
        if name == "attention":
            rec["fwd_bwd_ms_x_layers"] = rec["fwd_bwd_ms"] * tcfg.num_layers
        results.append(rec)
        del mod
        what = (f"text encoder ({tcfg.num_layers}x{tcfg.hidden_size}, "
                f"B={b}, T={t})" if name == "encoder" else
                "one attention block (incl. qkv/out proj + LN)")
        print(f"{what}: fwd {rec['fwd_ms']:.2f} ms, fwd+bwd "
              f"{rec['fwd_bwd_ms']:.2f} ms", flush=True)
    out = {"batch": b, "tlen": t, "layers": tcfg.num_layers,
           "hidden": tcfg.hidden_size, "dtype": str(dtype),
           "device": str(device),
           "card": ub.card_line(device.index or 0) if cuda else "cpu",
           "results": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
