#!/usr/bin/env python
"""Two formulations of the conformer conv module's causal depthwise
convolution on one card at flagship shapes: the port of
``scripts/depthwise_sweep.py``.

    python scripts/torch_depthwise_sweep.py [--iters 20] [--device cuda|cpu]

At ``[B, T, H] = [32, 499, 1024]``, K = 31, bf16 (inputs from
``np.random.default_rng(0)`` in the JAX script's order: x, w ``[K, 1, H]``
fp32, the cotangent):

* ``grouped``: ``F.conv1d`` over the ``[B, H, T]`` view, left-padded by
  K − 1, ``groups=H``, as the port's ``ConvModule`` computes it on the
  CPU (``ops/depthwise_glu.py``'s chain; ATen's depthwise kernel on the
  card, where the module runs the depthwise GLU kernels);
* ``shift``: the K-term shift-and-scale sum, each product rounded to bf16,
  the sum in fp32, then rounded to bf16 (JAX's ``conv_shift``).

Prints the parity ``max err`` between the two, then for each the forward
and the forward+backward (the gradients of ``sum((out·cot).float())`` for x
and w) in host ms (JAX's ``timeit``: the mean of ``--iters`` calls after 3,
the window ending in a device sync) beside device ms (torch.profiler over ``--iters`` calls,
``chip_smoke.device_ms``). Prints the card first and one JSON line last.
``--device cpu`` runs the same code in bf16 on the host and measures
nothing of a device (its device times are null); ``--device cuda``
without a card raises.
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


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def inputs(device):
    """x ``[B, T, H]`` bf16, w ``[K, 1, H]`` fp32, cot ``[B, T, H]`` bf16,
    drawn as the JAX script draws them."""
    import torch
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(B, T, H)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(K, 1, H)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(B, T, H)).astype(np.float32))
    return (x.to(device, torch.bfloat16), w.to(device),
            cot.to(device, torch.bfloat16))


def conv_grouped(x, w):
    """Causal depthwise conv of ``x [B, T, H]`` with ``w [K, 1, H]``
    (cast to x's dtype): ``F.conv1d`` on the ``[B, H, T]`` view."""
    import torch.nn.functional as F
    k, h = w.shape[0], w.shape[2]
    out = F.conv1d(F.pad(x.transpose(1, 2), (k - 1, 0)),
                   w.to(x.dtype).permute(2, 1, 0), groups=h)
    return out.transpose(1, 2)


def conv_shift(x, w):
    """The same convolution as K shifted products: each rounded to x's
    dtype, summed in fp32, the sum rounded to x's dtype."""
    import torch
    import torch.nn.functional as F
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        acc = acc + (xp[:, i:i + t] * w[i, 0].to(x.dtype)).float()
    return acc.to(x.dtype)


def loss_and_grads(fn, x, w, cot):
    """``sum((fn(x, w)·cot).float())`` and its gradients for (x, w)
    (JAX's ``value_and_grad(loss, argnums=(0, 1))``)."""
    import torch
    x = x.detach().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    loss = torch.sum((fn(x, w) * cot).float())
    return (loss.detach(), *torch.autograd.grad(loss, (x, w)))


def times(fn, cs, cuda, iters):
    """(host ms, device ms or None) of one call of ``fn``."""
    import torch
    from speech_transcript_embeddings_torch.utils import bench as ub
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    host = ub.timeit(fn, sync, iters, WARM) * 1e3
    return host, (cs.device_ms(fn, iters=iters, warmup=1) if cuda else None)


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
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    card = ub.card_line(device.index or 0) if cuda else "cpu"
    print(card, flush=True)
    cs = _load("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    x, w, cot = inputs(device)
    with torch.no_grad():
        out_a, out_b = conv_grouped(x, w), conv_shift(x, w)
    err = (out_a - out_b).float().abs().max().item()
    print(f"parity max err: {err:.4f}", flush=True)
    out = {"shape": [B, T, H, K], "dtype": "bfloat16", "device": str(device),
           "card": card, "iters": args.iters, "parity_max_err": err,
           "max_abs_out": out_a.float().abs().max().item(), "results": []}
    del out_a, out_b
    for name, fn in (("grouped", conv_grouped), ("shift", conv_shift)):
        def fwd(fn=fn):
            with torch.no_grad():
                return fn(x, w)

        f_host, f_dev = times(fwd, cs, cuda, args.iters)
        g_host, g_dev = times(lambda fn=fn: loss_and_grads(fn, x, w, cot),
                              cs, cuda, args.iters)
        dev = (f" (device {f_dev:.3f} / {g_dev:.3f} ms)" if cuda else "")
        print(f"{name}: fwd {f_host:.2f} ms, fwd+bwd {g_host:.2f} ms{dev}",
              flush=True)
        out["results"].append({"what": name, "fwd_ms": f_host,
                               "fwd_bwd_ms": g_host, "fwd_device_ms": f_dev,
                               "fwd_bwd_device_ms": g_dev})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
