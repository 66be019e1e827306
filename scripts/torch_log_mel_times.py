#!/usr/bin/env python3
"""Device time of the port's two log-mel kernels at the main paths' shapes,
for comparisons on one card: of two checkouts, or of tile sizes.

    python3 scripts/torch_log_mel_times.py [--tree DIR] [--tag NAME]
    python3 scripts/torch_log_mel_times.py --variant "" --variant "kMinBlocks=2"

By default the script imports ``speech_transcript_embeddings_torch`` from
DIR (this checkout if not given) and times that tree's kernels, built
there. ``log_mel``, ``normalize_and_stack`` and ``KernelLogMelFrontend``
have kept their signatures since the port began, so it times an older
tree's kernels too. For an A/B, run it in turns in one call: parent,
change, change, parent.

With ``--variant SPEC`` (repeatable) it builds this checkout's
``csrc/log_mel.cu`` once per SPEC instead. A SPEC is comma-separated
NAME=VALUE pairs that replace the values of ``constexpr int NAME``
(``kWarps``, ``kFramesPerWarp``, ``kMinBlocks``, ``kNormThreads``); the
empty SPEC is the source as it stands. Each variant gets its own nvcc
process, all at once, with the flags of ``ops/_build.py``. Each is then
loaded in turn in place of the package's library, so the public wrappers
call it.

At each (B, samples) of ``chip_smoke.MEL_SHAPES`` it holds the wrappers'
outputs against the twins (raw 2e-4, features 2e-3, mask exact) and
measures:

* ``raw_ms`` and ``norm_ms``: device time, by torch.profiler
  (``chip_smoke.device_ms``);
* ``raw_call_ms`` and ``norm_call_ms``: the time of a call back to back, by
  CUDA events (``chip_smoke.cuda_ms``), the wrapper's host overhead
  included;
* ``norm_copy_ms``: the device time of the normalisation with
  ``per_bin_normalize=False``. This is the same loads and stores without
  the statistics.

It prints the card, ptxas' register and spill lines for each variant, and
one JSON line for each tree or variant.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_variants(specs, _build):
    """One shared library per SPEC, from csrc/log_mel.cu with its
    ``constexpr int`` values replaced; nvcc processes run at once."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "log_mel.cu").read_text()
    paths, procs = [], []
    for i, spec in enumerate(specs):
        text = source
        for item in filter(None, spec.split(",")):
            name, value = item.split("=")
            text, hits = re.subn(rf"(constexpr int {name} = )[^;]+;",
                                 rf"\g<1>{value};", text)
            if hits != 1:
                raise ValueError(f"{name}: {hits} definitions in log_mel.cu")
        src = out_dir / f"log_mel_{i}.cu"
        src.write_text(text)
        paths.append(out_dir / f"log_mel_{i}.so")
        procs.append(subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(paths[-1]), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for spec, p in zip(specs, procs):
        text = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {spec!r}:\n{text}")
        print(f"variant {spec!r}:", *[ln.strip() for ln in text.splitlines()
                                      if "registers" in ln or "spill" in ln],
              sep="\n    ", flush=True)
    return paths


def time_kernels(smoke, torch, cfg_type, fe, fk):
    """{"BxN": times} at chip_smoke.MEL_SHAPES through the public wrappers,
    each shape checked against the twins first."""
    cfg = cfg_type(use_pallas=True)
    copy_cfg = cfg_type(use_pallas=True, per_bin_normalize=False)
    front = fk.KernelLogMelFrontend(cfg).cuda()
    g = torch.Generator().manual_seed(2)
    shapes = {}
    for b, n in smoke.MEL_SHAPES:
        wav, lens = smoke.mel_inputs(g, b, n)
        raw = front.raw_log_mel(wav)
        ref = fe.log_mel_reference(cfg, wav, front.transform, front.mel)
        vmask = (torch.arange(raw.shape[1], device="cuda")[None, :]
                 < fe.num_valid_frames(cfg, lens)[:, None])
        torch.testing.assert_close(raw[vmask], ref[vmask], rtol=2e-4,
                                   atol=2e-4)
        feats, mask = front.normalize_and_stack(raw, lens)
        ref_feats, ref_mask = fe.normalize_and_stack_reference(cfg, raw, lens)
        if not torch.equal(mask, ref_mask):
            raise AssertionError(f"mask differs at B={b} × {n}")
        torch.testing.assert_close(feats, ref_feats, rtol=2e-3, atol=2e-3)
        raw_fn = lambda: front.raw_log_mel(wav)              # noqa: E731
        norm_fn = lambda: front.normalize_and_stack(raw, lens)  # noqa: E731
        shapes[f"{b}x{n}"] = {
            "raw_ms": smoke.device_ms(raw_fn),
            "raw_call_ms": smoke.cuda_ms(raw_fn),
            "norm_ms": smoke.device_ms(norm_fn),
            "norm_call_ms": smoke.cuda_ms(norm_fn),
            "norm_copy_ms": smoke.device_ms(
                lambda: fk.normalize_and_stack(copy_cfg, raw, lens)),
            "raw_err": (raw - ref).abs()[vmask].max().item(),
            "feat_err": (feats - ref_feats).abs().max().item()}
    return shapes


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--tag", default="change")
    ap.add_argument("--variant", action="append")
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tree = os.path.abspath(HERE if args.variant else args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from speech_transcript_embeddings_torch.config import FrontendConfig
    from speech_transcript_embeddings_torch.ops import _build
    from speech_transcript_embeddings_torch.ops import frontend as fe
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    if not fk.__file__.startswith(tree):
        raise SystemExit(f"imported {fk.__file__}, not from {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    if not args.variant:
        print(json.dumps({"tag": args.tag, "tree": tree, "card": card,
                          "shapes": time_kernels(smoke, torch, FrontendConfig,
                                                 fe, fk)}), flush=True)
        return
    for variant, path in zip(args.variant,
                             build_variants(args.variant, _build)):
        lib = ctypes.CDLL(str(path))
        for name in ("ste_log_mel", "ste_log_mel_normalize"):
            getattr(lib, name).argtypes = _build._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        _build.library = lambda lib=lib: lib
        print(json.dumps({"variant": variant, "card": card,
                          "shapes": time_kernels(smoke, torch, FrontendConfig,
                                                 fe, fk)}), flush=True)


if __name__ == "__main__":
    main()
