#!/usr/bin/env python
"""The conformer conv module's forward on one card at flagship shapes, one
stage removed per variant: the port of ``scripts/conv_ablate.py``.

    python scripts/torch_conv_ablate.py [--iters 20] [--device cuda|cpu]

At ``[B, T, H] = [32, 499, 1024]``, K = 31, bf16 (inputs from
``np.random.default_rng(0)`` in the JAX script's order: x, w1 ``[H, 2H]``,
w2 ``[H, H]``, the depthwise kernel ``[K, 1, H]`` fp32), the module as the
JAX script writes it, in plain PyTorch:

    full          LayerNorm → x·w1 → GLU → depthwise → LayerNorm → swish → ·w2
    no_depthwise  without the depthwise convolution
    no_lns        without the two LayerNorms
    matmuls_only  x·w1 → GLU → ·w2

LayerNorm as JAX's ``ln``: fp32 statistics, eps 1e-5, no affine, the
result in the input's dtype; the depthwise convolution as the port's
``ConvModule`` runs it on the CPU (``F.conv1d`` over the ``[B, H, T]``
view; on the card the module runs the depthwise GLU kernels); the two
products ``torch.matmul`` (JAX computes them outside any Pallas kernel).
Not numerically meaningful, timing only. Prints each variant's host ms
(JAX's ``timeit``: the mean of ``--iters`` calls after 3, the window ending
in a device sync) beside its device ms (torch.profiler over ``--iters``
calls, ``chip_smoke.device_split``) and that device time by kernel family
(``utils/profile.kernel_family``): where the ms go. Prints the card first
and one JSON line last. ``--device cpu`` runs the same code on the host
and measures nothing of a device; ``--device cuda`` without a card raises.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

B, T, H, K = 32, 499, 1024, 31
WARM = 3
VARIANTS = ("full", "no_depthwise", "no_lns", "matmuls_only")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def inputs(device):
    """x, w1, w2 (bf16) and the depthwise kernel dw ``[K, 1, H]`` (fp32),
    drawn as the JAX script draws them."""
    import torch
    rng = np.random.default_rng(0)
    draw = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    x, w1, w2 = draw(B, T, H), draw(H, 2 * H), draw(H, H)
    dw = draw(K, 1, H)
    return (*(a.to(device, torch.bfloat16) for a in (x, w1, w2)),
            dw.to(device))


def ln(v):
    """JAX's ``ln``: normalised over the last axis with fp32 statistics,
    eps 1e-5, no scale or offset, in v's dtype."""
    import torch
    f = v.float()
    c = f - f.mean(-1, keepdim=True)
    var = (c * c).mean(-1, keepdim=True)
    return (c * torch.rsqrt(var + 1e-5)).to(v.dtype)


def depthwise(v, dw):
    """Causal depthwise conv of ``v [B, T, H]``, ``dw [K, 1, H]`` cast to
    v's dtype, as ``ConvModule`` computes it on the CPU."""
    import torch.nn.functional as F
    k, h = dw.shape[0], dw.shape[2]
    out = F.conv1d(F.pad(v.transpose(1, 2), (k - 1, 0)),
                   dw.to(v.dtype).permute(2, 1, 0), groups=h)
    return out.transpose(1, 2)


def glu(y):
    import torch
    a, b = y.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


def swish(y):
    import torch
    return y * torch.sigmoid(y)


def variant(name, w1, w2, dw):
    """The variant ``name`` of ``VARIANTS`` as a function of x."""
    def full(x):
        y = glu(ln(x) @ w1)
        return swish(ln(depthwise(y, dw))) @ w2

    def no_depthwise(x):
        return swish(ln(glu(ln(x) @ w1))) @ w2

    def no_lns(x):
        return swish(depthwise(glu(x @ w1), dw)) @ w2

    def matmuls_only(x):
        return glu(x @ w1) @ w2

    return {"full": full, "no_depthwise": no_depthwise, "no_lns": no_lns,
            "matmuls_only": matmuls_only}[name]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
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
    card = ub.card_line(device.index or 0) if cuda else "cpu"
    print(card, flush=True)
    cs = _load("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    x, w1, w2, dw = inputs(device)
    results = []
    for name in VARIANTS:
        fn = variant(name, w1, w2, dw)

        def call(fn=fn):
            with torch.no_grad():
                return fn(x)

        host = ub.timeit(call, sync, args.iters, WARM) * 1e3
        rec = {"what": name, "ms": host, "device_ms": None,
               "device_ms_by_family": None}
        line = f"{name}: {host:.2f} ms"
        if cuda:
            families = {}
            for kernel, ms in cs.device_split(call, iters=args.iters,
                                              warmup=1).items():
                fam = up.kernel_family(kernel)
                families[fam] = families.get(fam, 0.0) + ms
            families = dict(sorted(families.items(), key=lambda kv: -kv[1]))
            rec.update(device_ms=sum(families.values()),
                       device_ms_by_family=families)
            line += (f" (device {rec['device_ms']:.3f} ms: " + ", ".join(
                f"{f} {ms:.3f}" for f, ms in families.items()) + ")")
        print(line, flush=True)
        results.append(rec)
    out = {"shape": [B, T, H, K], "dtype": "bfloat16", "device": str(device),
           "card": card, "iters": args.iters, "results": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
