#!/usr/bin/env python3
"""Device time of the port's flash backward (K4) for bf16 at the training
shapes, kernel by kernel, for comparisons of two checkouts on one card.

    python3 scripts/torch_flash_bwd_times.py [--tree DIR] [--tag NAME]

The script imports ``speech_transcript_embeddings_torch`` from DIR (this
checkout if not given), builds that tree's kernels there and calls its
public ``flash_attention_bwd`` (whose signature has not changed since the
port began) at each (B·h, t_pad) of ``chip_smoke.BWD_BENCH``, hd 64, 16
heads, clips full and at 60% (``chip_smoke._flash_inputs``, seeded, so
every tree sees the same inputs). For an A/B, run it in turns in one call:
parent, change, change, parent.

At each shape it holds the four gradients against the tree's
``rel_attention_bwd_reference`` (max error over max|twin| ≤ 2e-2, phase 6's
bf16 tolerance) and measures, with ``chip_smoke``'s helpers:

* ``ms``: device time of one wrapper call, every kernel it launches
  (torch.profiler), and ``split``: the same by kernel name;
* ``call_ms``: the time of a call back to back (CUDA events), the
  wrapper's host overhead included;
* ``bound_ms``: ``chip_smoke.flash_bound`` of these inputs.

It prints the card (``nvidia-smi``) and one JSON line.

With ``--variant SPEC`` (repeatable) it builds this checkout's
``csrc/flash_rel_bwd_sm90.cu`` once per SPEC instead, each into its own
library with the flags of ``ops/_build.py`` (nvcc processes run at once),
and times each in the order given, loaded in place of the package's
library so that the public wrapper calls it. A SPEC is comma-separated
NAME=VALUE pairs that replace the values of ``constexpr int NAME`` (the
empty SPEC is the source as it stands), or ``@FILE``: another source with
the same entry point (a saved earlier version), compiled with the headers
of its own directory first, then those of ``csrc/``. Give them in turns
(A, B, B, A).
"""

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "flash_rel_bwd_sm90.cu"
ENTRY = "ste_flash_rel_bwd_wgmma"


def variant_source(text, spec, source_name=SOURCE):
    """``text`` with the ``constexpr int NAME = VALUE;`` definitions of
    SPEC (comma-separated NAME=VALUE pairs) replaced; each NAME must have
    exactly one definition."""
    for item in filter(None, spec.split(",")):
        name, value = item.split("=")
        text, hits = re.subn(rf"(constexpr int {name} = )[^;]+;",
                             rf"\g<1>{value};", text)
        if hits != 1:
            raise ValueError(f"{name}: {hits} definitions in {source_name}")
    return text


def only_head_dim(text, hd, source_name=SOURCE):
    """``text`` whose entry point instantiates and launches the kernels
    for head dim ``hd`` alone (any other returns cudaErrorInvalidValue):
    one instantiation compiles in a fraction of the eight's time."""
    text, hits = re.subn(
        r"switch \(hd\) \{.*?\n  \}",
        f"if (hd != {hd}) return static_cast<int>(cudaErrorInvalidValue);\n"
        f"  STE_LAUNCH({hd});", text, flags=re.S)
    if hits != 1:
        raise ValueError(f"{hits} head-dim switches in {source_name}")
    return text


def start_variants(specs, _build, source_name=SOURCE, hd=None):
    """Start one nvcc a SPEC (all at once), each building a shared library
    from ``csrc/<source_name>`` into ``_build/variants/``, named by a hash
    of its source text, flags and headers: a library already built is not built
    again, and two builds of one text (in two processes) write the same
    file. With ``hd``, that head dim's kernels alone (``only_head_dim``).
    → [(spec, library path, process or None)] for ``finish_variants``."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = source_name.split(".")[0]
    source = (_build.CSRC / source_name).read_text()
    started = []
    for spec in specs:
        includes = ["-I", str(_build.CSRC)]
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                text = f.read()
            # its own headers first, where it has them
            includes = ["-I", os.path.dirname(os.path.abspath(spec[1:]))] + \
                includes
        else:
            text = variant_source(source, spec, source_name)
        if hd is not None:
            text = only_head_dim(text, hd, source_name)
        # the key: the text, the flags and the headers it may include
        headers = [h.read_text() for d in includes[1::2]
                   for h in sorted(Path(d).glob("*.cuh"))]
        key = hashlib.sha256("\0".join(
            [text, *_build.NVCC_FLAGS, *includes, *headers]).encode()
        ).hexdigest()[:16]
        path = out_dir / f"{stem}_{key}.so"
        if path.exists():
            started.append((spec, path, None))
            continue
        src = out_dir / f"{stem}_{key}.{os.getpid()}.cu"
        src.write_text(text)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        started.append((spec, path, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, *includes, "-shared",
             "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return started


def finish_variants(started, strict=True):
    """Wait for ``start_variants``' builds, keep each one's log beside its
    library (``.log``) and print its ptxas report. → the library paths; a
    failed build raises, or with ``strict=False`` stands in the list as
    the ``RuntimeError`` it would raise."""
    paths = []
    for spec, path, p in started:
        if p is None:
            print(f"variant {spec!r}: built already ({path.name})",
                  flush=True)
            paths.append(path)
            continue
        text = p.communicate()[0]
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        path.with_suffix(".log").write_text(text)
        if p.returncode:
            tmp.unlink(missing_ok=True)
            err = RuntimeError(f"nvcc failed for {spec!r} (log "
                               f"{path.with_suffix('.log')}):\n{text}")
            if strict:
                raise err
            paths.append(err)
            continue
        os.replace(tmp, path)
        lines = text.splitlines()
        report = [f"{m[1]}<{m[2]}>: {lines[n + 3].split(':', 1)[1].strip()}"
                  f"; {lines[n + 2].strip()}"
                  for n, ln in enumerate(lines)
                  for m in [re.search(r"\d+([a-z_]+wgmma_kernel)ILi(64|128)E",
                                      ln)]
                  if m and "Compiling entry" in ln and n + 3 < len(lines)]
        print(f"variant {spec!r}:", *report, sep="\n    ", flush=True)
        paths.append(path)
    return paths


def build_variants(specs, _build, source_name=SOURCE, hd=None):
    """One shared library per SPEC, from ``csrc/<source_name>``; nvcc
    processes run at once (``start_variants``, ``finish_variants``)."""
    return finish_variants(start_variants(specs, _build, source_name, hd))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--variant", action="append")
    args = ap.parse_args()
    tree = os.path.abspath(HERE if args.variant else args.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
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
        time_tree(cs, torch, fa, args.tag or tree, card)
        return
    libs = [ctypes.CDLL(str(p)) for p in build_variants(args.variant, _build)]
    base = _build.library()
    for variant, lib in zip(args.variant, libs):
        fn = getattr(lib, ENTRY)
        fn.argtypes = _build._SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        # the package's library with this variant's backward entry point
        proxy = types.SimpleNamespace(**{
            **{n: getattr(base, n) for n in _build._SIGNATURES}, ENTRY: fn})
        _build.library = lambda proxy=proxy: proxy
        time_tree(cs, torch, fa, f"variant {variant!r}", card)


def time_tree(cs, torch, fa, tag, card):
    """Check and time the wrapper at each BWD_BENCH shape; one JSON line."""
    g = torch.Generator().manual_seed(10)
    nh, hd, left = 16, 64, 64
    kw = dict(num_heads=nh, left_max=left)
    result = {"tree": tag, "card": card, "shapes": {}}
    for bh, t in cs.BWD_BENCH:
        q, k, v, dout, e, mask = cs._flash_inputs(g, bh, t, hd,
                                                  torch.bfloat16, 0.3)
        out, lse = fa.flash_attention_fwd(q, k, v, e, mask, **kw)
        call = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, e, mask, out, lse, dout, **kw)
        got = call()
        ref = fa.rel_attention_bwd_reference(q, k, v, e, mask, out, lse,
                                             dout, **kw)
        torch.cuda.synchronize()
        errs = {n: cs._max_rel_err(a, r) for n, a, r in
                zip(("dq", "dk", "dv", "dE"), got, ref)}
        if max(errs.values()) > 2e-2:
            raise AssertionError(f"({bh}, {t}): {errs}")
        del got, ref
        split = cs._by_kernel_name(cs.device_split(call, iters=20))
        b_ms, b_by = cs.flash_bound(mask, nh, hd, e.shape[0], torch.bfloat16,
                                    True)
        result["shapes"][f"{bh}x{t}"] = dict(
            ms=sum(split.values()), split=split,
            call_ms=cs.cuda_ms(call, iters=20), bound_ms=b_ms,
            bound_by=b_by, max_rel_err=errs)
        print(f"({bh}, {t}): {sum(split.values()):.4f} ms device, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        for name, ms in split.items():
            print(f"    {ms:.4f} ms {name}", flush=True)
        del q, k, v, dout, e, mask, out, lse
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
