#!/usr/bin/env python
"""The flash kernels (K3 forward, K4 backward) on one card at flagship
shapes with parts of the relative bias switched off: the port of
``scripts/flash_ablate.py``.

    python scripts/torch_flash_ablate.py [--iters 20] [--device cuda]

At B·h = 32·16, T = 499, hd 64, E ``[73, 64]`` (L/R = 64/8), a mask of
ones, bf16 (inputs from ``np.random.default_rng(0)`` in the JAX script's
order: q, k, v, E, then the weights w of the loss), each variant times the
forward and backward through the port's autograd ``flash_attention``,
taking the gradients of ``sum((o·w).float())`` for (q, k, v):

    full             the kernels as committed
    no_bias_fwdside  kRelBias = 0 in both sources: no qE product and no bias
                     on the scores, in the forward and in the backward's
                     recomputed p (JAX's ``_bias_rows`` → 0); dqE still on
    no_bias_no_dqe   also kRelBiasGrad = 0 in the backward: no dqE, no
                     dq += round(dqE)·E, dE = 0 (JAX's ``_dqe_rows`` → 0)

The switches are ``constexpr int`` definitions in
``csrc/flash_rel_fwd_sm90.cu`` and ``csrc/flash_rel_bwd_sm90.cu``,
committed as 1. Each variant is built into its own library under
``_build/variants/`` (``scripts/torch_flash_bwd_times.py``'s
``start_variants``, hd 64 alone, every nvcc at once) and its forward and
backward entry points are loaded in place of the package's, so that the
public wrappers launch them.

With the bias off the kernels compute attention with E = 0, so, unlike
JAX's ablation, each variant is checked before it is timed, against the
plain twins (``rel_attention_reference``, ``rel_attention_bwd_reference``;
max error over max|twin| ≤ 2e-2, phase 6's bf16 tolerance): ``full``
against the twins with E; ``no_bias_fwdside``: out, dk and dv against the
twins with a zero E; ``no_bias_no_dqe``: out, dq, dk and dv against them,
and dE exactly 0. A variant that fails raises. Prints each variant's host
ms (JAX's ``timeit``: the mean of ``--iters`` calls after 3, the window
ending in a device sync) beside its device ms (torch.profiler,
``chip_smoke.device_split``; the part of it in K3 and K4 beside) and the
bound of the forward plus the backward
(``chip_smoke.flash_bound``); the card first and one JSON line last. K3
and K4 must launch in each variant's timed window. Needs the card:
``--device cuda`` without one raises.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import sys
import types

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

B, NH, T, HD, L, R = 32, 16, 499, 64, 64, 8
WARM = 3
FWD_SOURCE, FWD_ENTRY = "flash_rel_fwd_sm90.cu", "ste_flash_rel_fwd_wgmma"
BWD_SOURCE, BWD_ENTRY = "flash_rel_bwd_sm90.cu", "ste_flash_rel_bwd_wgmma"
# name → (forward spec, backward spec)
VARIANTS = {"full": ("", ""),
            "no_bias_fwdside": ("kRelBias=0", "kRelBias=0"),
            "no_bias_no_dqe": ("kRelBias=0", "kRelBias=0,kRelBiasGrad=0")}
TOL = 2e-2
FLASH_FAMILIES = ("K3 flash forward", "K4 flash backward")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def inputs(device):
    """q, k, v ``[B·NH, T, HD]``, E ``[L + R + 1, HD]``, the mask ``[B, T]``
    of ones (fp32) and w ``[B·NH, T, HD]``, as the JAX script draws them."""
    import torch
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    q, k, v = mk(B * NH, T, HD), mk(B * NH, T, HD), mk(B * NH, T, HD)
    e = mk(L + R + 1, HD)
    mask = torch.ones((B, T), dtype=torch.float32, device=device)
    return q, k, v, e, mask, mk(B * NH, T, HD)


def use_library(_build, fwd_lib, bwd_lib):
    """Make ``_build.library()`` the package's library with the forward
    and backward entry points of ``fwd_lib`` and ``bwd_lib``."""
    base = _build.library()
    entries = {n: getattr(base, n) for n in _build._SIGNATURES}
    for lib, entry in ((fwd_lib, FWD_ENTRY), (bwd_lib, BWD_ENTRY)):
        fn = getattr(lib, entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        entries[entry] = fn
    proxy = types.SimpleNamespace(**entries)
    _build.library = lambda: proxy


def check(name, fa, cs, q, k, v, e, mask, w):
    """Hold the variant now loaded against the twins (module docstring);
    → {tensor: max error over max|twin|}. Raises on a failure."""
    import torch
    kw = dict(num_heads=NH, left_max=L)
    ref_e = e if name == "full" else torch.zeros_like(e)
    out, lse = fa.flash_attention_fwd(q, k, v, e, mask, **kw)
    grads = fa.flash_attention_bwd(q, k, v, e, mask, out, lse, w, **kw)
    ref_out, _ = fa.rel_attention_reference(q, k, v, ref_e, mask, **kw)
    refs = fa.rel_attention_bwd_reference(q, k, v, ref_e, mask, out, lse, w,
                                          **kw)
    torch.cuda.synchronize()
    errs = {"out": cs._max_rel_err(out, ref_out)}
    errs.update({n: cs._max_rel_err(g, r) for n, g, r in
                 zip(("dq", "dk", "dv", "dE"), grads, refs)})
    held = {"full": ("out", "dq", "dk", "dv", "dE"),
            "no_bias_fwdside": ("out", "dk", "dv"),
            "no_bias_no_dqe": ("out", "dq", "dk", "dv")}[name]
    bad = {n: errs[n] for n in held if not errs[n] <= TOL}
    if name == "no_bias_no_dqe" and torch.count_nonzero(grads[3]).item():
        bad["dE"] = "not zero"
    if bad:
        raise AssertionError(f"{name}: {bad} against the twins "
                             f"(tolerance {TOL} of max|twin|)")
    return {n: errs[n] for n in held}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    from speech_transcript_embeddings_torch.inference.embed import (
        resolve_device,
    )
    from speech_transcript_embeddings_torch.ops import _build
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.utils import bench as ub
    from speech_transcript_embeddings_torch.utils import profile as up
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("the variants are CUDA builds: the ablation "
                           "needs --device cuda")
    card = ub.card_line(device.index or 0)
    print(card, flush=True)
    cs = _load("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    bwd_times = _load("flash_bwd_times", os.path.join(
        HERE, "scripts", "torch_flash_bwd_times.py"))
    names = list(VARIANTS)
    started = [bwd_times.start_variants([VARIANTS[n][i] for n in names],
                                        _build, source, HD)
               for i, source in enumerate((FWD_SOURCE, BWD_SOURCE))]
    _build.library()     # the package's own, for the other entry points
    fwd_libs, bwd_libs = ([ctypes.CDLL(str(p)) for p in
                           bwd_times.finish_variants(s)] for s in started)
    q, k, v, e, mask, w = inputs(device)
    bound = [cs.flash_bound(mask, NH, HD, e.shape[0], torch.bfloat16, bwd)
             for bwd in (False, True)]
    bound_ms = bound[0][0] + bound[1][0]
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))

    def step():
        o = fa.flash_attention(qg, kg, vg, e, mask, num_heads=NH, left_max=L)
        loss = torch.sum((o * w).float())
        return loss.detach(), torch.autograd.grad(loss, (qg, kg, vg))

    results, launches = [], {}
    for name, fwd_lib, bwd_lib in zip(names, fwd_libs, bwd_libs):
        use_library(_build, fwd_lib, bwd_lib)
        errs = check(name, fa, cs, q, k, v, e, mask, w)
        ub.reset_launches()
        host = ub.timeit(step, torch.cuda.synchronize, args.iters, WARM) * 1e3
        counts = ub.launches()
        ub.require_launches(counts, ("K3", "K4"))
        for kname, n in counts.items():
            launches[kname] = launches.get(kname, 0) + n
        split = cs.device_split(step, iters=args.iters, warmup=1)
        dev = sum(split.values())
        flash = sum(ms for kname, ms in split.items()
                    if up.kernel_family(kname) in FLASH_FAMILIES)
        print(f"{name}: fwd+bwd {host:.2f} ms (device "
              f"{dev:.3f} ms, of it K3 + K4 {flash:.3f} ms; bound "
              f"{bound_ms:.4f} ms); held against the twins: " + ", ".join(
                  f"{n} {x:.1e}" for n, x in errs.items()), flush=True)
        results.append({"what": name, "fwd_bwd_ms": host,
                        "fwd_bwd_device_ms": dev,
                        "flash_kernels_device_ms": flash,
                        "bound_ms": bound_ms,
                        "bound_by": [bound[0][1], bound[1][1]],
                        "max_rel_err": errs})
    out = {"shape": {"bh": B * NH, "t": T, "hd": HD, "num_pos": L + R + 1},
           "dtype": "bfloat16", "card": card, "iters": args.iters,
           "results": results, "kernel_launches": launches}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
