#!/usr/bin/env python
"""The flash forward and backward (K3, K4) on one card at flagship shapes
while the backward's tiles vary: the port of ``scripts/flash_vmem_sweep.py``.

    python scripts/torch_flash_tile_sweep.py [--spec SPEC ...] [--iters 10]
        [--device cuda]

JAX's sweep varies the backward's q-chunk, which a TPU core holds in its
VMEM. The card has no VMEM; what takes its place in
``csrc/flash_rel_bwd_sm90.cu`` are the tiles and the TMA rings in shared
memory: ``kN`` (the rows of a streamed tile: keys in kernel A, queries in
kernel B), ``kStagesA`` and ``kStagesB`` (the ring depths). A SPEC is
comma-separated ``NAME=VALUE`` pairs of those ``constexpr int``
definitions; the empty SPEC is the source as it stands. The default specs:
the source, ``kStagesA=2``, ``kStagesB=1``, ``kStagesB=3``, ``kN=64``.

Every spec is built at once (``scripts/torch_flash_bwd_times.py``'s
``start_variants``, hd 64 alone, into ``_build/variants/``) and then run in
a process of its own (this script with ``--child``), since a kernel that
faults poisons its CUDA context. The children start together and import,
draw their inputs and start the profiler at once (a process spends ≈7 s
in its first profiler session), wait for each other, then take the card
one at a time under a file lock. At B·h = 32·16, T = 499, hd 64, E
``[73, 64]``, a mask of ones, bf16 (inputs from
``np.random.default_rng(0)`` in the JAX script's order), the child holds
the four gradients of ``sum((o·w).float())`` (q, k, v and E, as JAX's
sweep takes them) from the port's autograd ``flash_attention``, the
spec's backward in place of the package's, against the plain twin (max
error over max|twin| ≤ 2e-2, phase 6's bf16 tolerance), then times the
forward and backward: host ms (the mean of ``--iters`` calls after one,
the window ending in a device sync, as JAX's sweep times) beside device
ms (torch.profiler, ``chip_smoke.device_ms``). A spec that fails to
compile, to launch or to hold the twin prints ``FAIL <reason>``, as JAX's
does, and stands so in the last JSON line; the script exits non-zero
only if the source as it stands fails. Prints the card first. Needs the
card: ``--device cuda`` without one raises.

History (JAX, on its TPU): a rows-per-grid-step sweep ran there in round
2 — folding 1/2/4 batch·head rows per grid step measured *flat* (9.5-9.8
ms fwd+bwd at B=32, T=499) and 8 rows OOMed scoped VMEM, so the TPU kernels
keep one row per grid step; the wins that stuck were the host-built Sel
stack, the transposed-contraction dqe, input-dtype gradient stores, and
bwd chunk 256 (13.75 → ~9.5 ms fwd+bwd per layer). Those are TPU times,
not the port's.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import fcntl
import glob
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SOURCE = "flash_rel_bwd_sm90.cu"
SPECS = ("", "kStagesA=2", "kStagesB=1", "kStagesB=3", "kN=64")
TOL = 2e-2
CHILD_TIMEOUT_S = 300      # for all the children together
BARRIER_S = 120


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ablate():
    """``scripts/torch_flash_ablate.py``: the shapes, the inputs and the
    swap of entry points are its own."""
    return _load("flash_ablate", os.path.join(HERE, "scripts",
                                              "torch_flash_ablate.py"))


@contextlib.contextmanager
def _the_card(sync_dir, parties):
    """Wait until ``parties`` children have written their ready file in
    ``sync_dir`` (or ``BARRIER_S`` has passed), then hold the card alone:
    an exclusive lock on ``sync_dir/card.lock`` for the block."""
    with open(os.path.join(sync_dir, f"ready.{os.getpid()}"), "w"):
        pass
    deadline = time.monotonic() + BARRIER_S
    while time.monotonic() < deadline and len(
            glob.glob(os.path.join(sync_dir, "ready.*"))) < parties:
        time.sleep(0.1)
    with open(os.path.join(sync_dir, "card.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def child(lib_path, iters, sync_dir, parties) -> dict:
    """One spec's library: the imports, the inputs and the profiler's
    start-up while the other children do theirs, then, holding the card
    alone (``_the_card``), check the four gradients and time; → the
    spec's record (its ``error`` says why it failed)."""
    import torch
    from speech_transcript_embeddings_torch.ops import _build
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.utils import bench as ub
    cs = _load("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    ablate = _ablate()
    lib = ctypes.CDLL(lib_path)
    # the package's forward with this spec's backward
    ablate.use_library(_build, _build.library(), lib)
    host = ablate.inputs("cpu")
    with ub.device_trace():       # the profiler's first session is slow
        torch.zeros(1, device="cuda")
    nh, left = ablate.NH, ablate.L
    kw = dict(num_heads=nh, left_max=left)
    with _the_card(sync_dir, parties):
        q, k, v, e, mask, w = (x.cuda() for x in host)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v, e)]

        def step():
            o = fa.flash_attention(*leaves[:3], leaves[3], mask, **kw)
            return torch.autograd.grad(torch.sum((o * w).float()), leaves)

        ub.reset_launches()
        grads = step()
        out, lse = fa.rel_attention_reference(q, k, v, e, mask, **kw)
        refs = fa.rel_attention_bwd_reference(q, k, v, e, mask, out, lse, w,
                                              **kw)
        torch.cuda.synchronize()
        errs = {n: cs._max_rel_err(g, r) for n, g, r in
                zip(("dq", "dk", "dv", "dE"), grads, refs)}
        del grads, refs, out, lse
        rec = {"max_rel_err": errs}
        if not all(x <= TOL for x in errs.values()):
            return {**rec, "error": f"gradients against the twin {errs} "
                                    f"(tolerance {TOL} of max|twin|)"}
        rec["fwd_bwd_ms"] = ub.timeit(step, torch.cuda.synchronize, iters,
                                      1) * 1e3
        rec["fwd_bwd_device_ms"] = cs.device_ms(step, iters=iters, warmup=1)
        rec["kernel_launches"] = ub.launches()
        torch.cuda.synchronize()
    return rec


def run_children(libs, iters, timeout=CHILD_TIMEOUT_S) -> list:
    """``child`` for each library, each in a process of its own, all
    started at once; → their records in order (a crash, a non-zero exit,
    no record within ``timeout`` s becomes the record's ``error``)."""
    with tempfile.TemporaryDirectory() as sync_dir:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(lib),
             "--iters", str(iters), "--sync", sync_dir, "--parties",
             str(len(libs))], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=HERE) for lib in libs]
        deadline = time.monotonic() + timeout
        records = []
        for proc in procs:
            try:
                out, err = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                records.append({"error": f"no result within {timeout} s"})
                continue
            lines = out.strip().splitlines()
            if proc.returncode or not lines:
                tail = (err.strip().splitlines() or ["no output"])[-1]
                records.append({"error": f"exit {proc.returncode}: {tail}"})
            else:
                records.append(json.loads(lines[-1]))
    return records


def _first_error(text):
    """The first line of a failed build's log that names an error, else
    its last line."""
    lines = [ln.strip() for ln in text.splitlines()[1:] if ln.strip()]
    return next((ln for ln in lines if "error" in ln.lower()),
                lines[-1] if lines else text)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spec", action="append",
                    help="NAME=VALUE,... of csrc/flash_rel_bwd_sm90.cu "
                         "(repeatable; '' is the source as it stands)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", metavar="LIBRARY", help=argparse.SUPPRESS)
    ap.add_argument("--sync", help=argparse.SUPPRESS)
    ap.add_argument("--parties", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.child:
        print(json.dumps(child(args.child, args.iters, args.sync,
                               args.parties)), flush=True)
        return {}
    from speech_transcript_embeddings_torch.inference.embed import (
        resolve_device,
    )
    from speech_transcript_embeddings_torch.ops import _build
    from speech_transcript_embeddings_torch.utils import bench as ub
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("the specs are CUDA builds: the sweep needs "
                           "--device cuda")
    specs = list(SPECS if args.spec is None else args.spec)
    card = ub.card_line(device.index or 0)
    print(card, flush=True)
    bwd_times = _load("flash_bwd_times", os.path.join(
        HERE, "scripts", "torch_flash_bwd_times.py"))
    a = _ablate()
    started = bwd_times.start_variants(specs, _build, SOURCE, a.HD)
    _build.library()     # the package's own, for the forward, meanwhile
    libs = bwd_times.finish_variants(started, strict=False)
    built = [lib for lib in libs if not isinstance(lib, Exception)]
    records = iter(run_children(built, args.iters))
    results, launches = [], {}
    for spec, lib in zip(specs, libs):
        rec = ({"error": _first_error(str(lib))}
               if isinstance(lib, Exception) else next(records))
        rec = {"spec": spec, **rec}
        tag = spec or "source"
        if "error" in rec:
            print(f"bwd {tag}: FAIL {rec['error'][:160]}", flush=True)
        else:
            for kname, n in rec.pop("kernel_launches").items():
                launches[kname] = launches.get(kname, 0) + n
            print(f"bwd {tag}: {rec['fwd_bwd_ms']:.2f} ms fwd+bwd (device "
                  f"{rec['fwd_bwd_device_ms']:.3f} ms)", flush=True)
        results.append(rec)
    out = {"shape": {"bh": a.B * a.NH, "t": a.T, "hd": a.HD,
                     "num_pos": a.L + a.R + 1},
           "dtype": "bfloat16", "card": card, "iters": args.iters,
           "results": results, "kernel_launches": launches}
    print(json.dumps(out), flush=True)
    if "" in specs and "error" in results[specs.index("")]:
        raise SystemExit("the source as it stands failed: "
                         + results[specs.index("")]["error"])
    return out


if __name__ == "__main__":
    main()
