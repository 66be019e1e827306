#!/usr/bin/env python3
"""Device time and call time of the port's flash forward (K3) for bf16 at
the main path's shapes, and the host time of one call split by step, for
comparisons of two checkouts on one card.

    python3 scripts/torch_flash_fwd_times.py [--tree DIR] [--tag NAME]
                                             [--host-split]

The script imports ``speech_transcript_embeddings_torch`` from DIR (this
checkout if not given), builds that tree's kernels there and calls its
public ``flash_attention_fwd`` (whose signature has not changed since the
port began) at each (B·h, t_pad) of ``chip_smoke.FWD_BENCH``, hd 64, 16
heads, clips full and at 60% (``chip_smoke._flash_inputs``, seeded, so
every tree sees the same inputs). For an A/B, run it in turns in one call:
parent, change, change, parent.

At each shape it holds out and lse against the tree's
``rel_attention_reference`` (out within 2e-2, lse within 1e-3: phase 3's
bf16 tolerances) and measures, with ``chip_smoke``'s helpers:

* ``ms``: device time of one wrapper call, every kernel it launches
  (torch.profiler), and ``split``: the same by kernel name (the flash
  kernel, the mask's length passes);
* ``call_ms``: the time of a call back to back (CUDA events over 200
  calls), the wrapper's host overhead included;
* ``bound_ms``: ``chip_smoke.flash_bound`` of these inputs.

With ``--host-split`` it also times the host side of a call at (256, 256)
by ``time.perf_counter`` over 2,000 calls: once as it stands
(``host_ms``: the loop without its closing synchronise; ``wall_ms`` with
it), then with each step of the wrapper that the tree has wrapped in a
timer (``split_ms``: the checks, ``_aligned``, ``_lengths``, ``_scale``,
``_t_pad``, ``_build.launch_args``, ``_build.library``, ``_build.check``
and the C entry point, which holds the ctypes conversion, the tensor maps
and the launch); ``rest_ms`` is what no timer holds (the allocations of
out and lse, E's cast, the Python of the wrapper itself) and
``timers_ms`` what the timers add to a call.

It prints the card (``nvidia-smi``) and one JSON line.

With ``--variant SPEC`` (repeatable) it builds this checkout's
``csrc/flash_rel_fwd_sm90.cu`` once per SPEC instead, as
``scripts/torch_flash_bwd_times.py`` builds its variants (``constexpr int
NAME=VALUE`` pairs, or ``@FILE``), and times each in the order given,
loaded in place of the package's library so that the public wrapper calls
it. Give them in turns (A, B, B, A).
"""

import argparse
import collections
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "flash_rel_fwd_sm90.cu"
ENTRY = "ste_flash_rel_fwd_wgmma"
NH, HD, LEFT = 16, 64, 64


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--host-split", action="store_true")
    ap.add_argument("--variant", action="append")
    args = ap.parse_args()
    tree = os.path.abspath(HERE if args.variant else args.tree)
    sys.path.insert(0, tree)
    cs = _load("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    import torch
    from speech_transcript_embeddings_torch.ops import _build
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    if not fa.__file__.startswith(tree):
        raise RuntimeError(f"imported {fa.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if not args.variant:
        result = time_tree(cs, torch, fa, args.tag or tree, card)
        if args.host_split:
            result["host_split"] = host_split(cs, torch, fa, _build)
        print(json.dumps(result), flush=True)
        return
    bwd = _load("flash_bwd_times",
                os.path.join(HERE, "scripts", "torch_flash_bwd_times.py"))
    libs = [ctypes.CDLL(str(p))
            for p in bwd.build_variants(args.variant, _build, SOURCE)]
    base = _build.library()
    for variant, lib in zip(args.variant, libs):
        fn = getattr(lib, ENTRY)
        fn.argtypes = _build._SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        # the package's library with this variant's forward entry point
        proxy = types.SimpleNamespace(**{
            **{n: getattr(base, n) for n in _build._SIGNATURES}, ENTRY: fn})
        _build.library = lambda proxy=proxy: proxy
        result = time_tree(cs, torch, fa, f"variant {variant!r}", card)
        if args.host_split:
            result["host_split"] = host_split(cs, torch, fa, _build)
        print(json.dumps(result), flush=True)


def time_tree(cs, torch, fa, tag, card):
    """Check and time the wrapper at each FWD_BENCH shape."""
    g = torch.Generator().manual_seed(12)
    kw = dict(num_heads=NH, left_max=LEFT)
    result = {"tree": tag, "card": card, "shapes": {}}
    for bh, t in cs.FWD_BENCH:
        q, k, v, _, e, mask = cs._flash_inputs(g, bh, t, HD, torch.bfloat16,
                                               0.02)
        call = lambda: fa.flash_attention_fwd(q, k, v, e, mask, **kw)  # noqa: E731
        out, lse = call()
        ref, ref_lse = fa.rel_attention_reference(q, k, v, e, mask, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-3)
        del out, lse, ref, ref_lse
        split = cs._by_kernel_name(cs.device_split(call, iters=50))
        b_ms, b_by = cs.flash_bound(mask, NH, HD, e.shape[0], torch.bfloat16,
                                    False)
        kernel_ms = sum(ms for name, ms in split.items()
                        if "flash_rel_fwd" in name)
        result["shapes"][f"{bh}x{t}"] = dict(
            ms=sum(split.values()), kernel_ms=kernel_ms, split=split,
            call_ms=cs.cuda_ms(call, iters=200, warmup=20), bound_ms=b_ms,
            bound_by=b_by, err=err, lse_err=lse_err)
        tm = result["shapes"][f"{bh}x{t}"]
        print(f"({bh}, {t}): kernel {kernel_ms:.4f} ms, wrapper's kernels "
              f"{tm['ms']:.4f} ms device, {tm['call_ms']:.4f} ms a call back "
              f"to back; bound {b_ms:.4f} ms ({b_by}), share "
              f"{b_ms / kernel_ms:.1%}; err {err:.2e}, lse err "
              f"{lse_err:.2e}", flush=True)
        for name, ms in split.items():
            print(f"    {ms:.4f} ms {name}", flush=True)
        del q, k, v, e, mask
        torch.cuda.empty_cache()
    return result


def host_split(cs, torch, fa, _build, bh=256, t=256, calls=2000):
    """Host ms of one public call at (bh, t), whole and by step (see the
    module's docstring)."""
    g = torch.Generator().manual_seed(13)
    q, k, v, _, e, mask = cs._flash_inputs(g, bh, t, HD, torch.bfloat16, 0.02)
    kw = dict(num_heads=NH, left_max=LEFT)

    def per_call():
        for _ in range(50):
            fa.flash_attention_fwd(q, k, v, e, mask, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fa.flash_attention_fwd(q, k, v, e, mask, **kw)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return host / calls * 1e3, (time.perf_counter() - t0) / calls * 1e3

    per_call()                          # warm the allocator and caches
    host_ms, wall_ms = per_call()
    spent = collections.Counter()
    restore = []

    def timed(owner, name, key):
        fn = getattr(owner, name)

        def wrapper(*a, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        restore.append((owner, name, fn))
        setattr(owner, name, wrapper)

    lib = _build.library()
    proxy = types.SimpleNamespace(**{n: getattr(lib, n)
                                     for n in _build._SIGNATURES})
    for n in _build._SIGNATURES:
        timed(proxy, n, f"C entry point ({n})")
    restore.append((_build, "library", _build.library))
    _build.library = lambda: proxy
    timed(_build, "library", "_build.library")
    for name in ("_check", "_require_cuda", "flash_kernel", "_aligned",
                 "_lengths", "_scale", "_t_pad"):
        if hasattr(fa, name):
            timed(fa, name, name)
    for name in ("launch_args", "check"):
        timed(_build, name, f"_build.{name}")
    try:
        split_host, _ = per_call()
    finally:
        for owner, name, fn in reversed(restore):
            setattr(owner, name, fn)
    steps = {key: s / (calls + 50) * 1e3 for key, s in spent.items()}
    out = dict(shape=f"{bh}x{t}", calls=calls, host_ms=host_ms,
               wall_ms=wall_ms, split_ms=steps,
               rest_ms=split_host - sum(steps.values()),
               timers_ms=split_host - host_ms)
    print(f"host split at ({bh}, {t}): {host_ms:.4f} ms a call on the host "
          f"({wall_ms:.4f} with the device), by step with timers "
          f"{split_host:.4f}:", flush=True)
    for key, ms in sorted(steps.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:.4f} ms {key}", flush=True)
    print(f"    {out['rest_ms']:.4f} ms the rest", flush=True)
    return out


if __name__ == "__main__":
    main()
