#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port, on one GPU: serving and
training.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``speech_transcript_embeddings_torch/
csrc`` (nvcc, sm_90a) and holds each against its plain PyTorch twin at the
shapes the serving and training paths give it: log-mel (phase 2, timed at
every main-path shape beside the twin and a cuFFT composite, and its
error per mel bin taken against float64), the flash
forward (phase 3) and backward (phase 6). Each flash direction has a
tensor-core kernel (bf16, the main paths) and a CUDA-core one (fp32);
phases 3 and 6 time both (device time, and back-to-back calls beside it),
the twin and SDPA without the bias (a yardstick, not the same function) at
the main paths' shapes, each beside its bound. The LayerNorm kernels
(phase 17, run after phase 6) are held against the plain chain within one
bf16 step and timed forward and backward at the conformer's bf16
activations of the cells, beside their bytes bound, the chain and ATen's
bf16 LayerNorm. The depthwise GLU kernels (phase 18) likewise, beside the
plain ATen chain the conv module ran before them. Every path that counts
its launches also counts the plain LayerNorm calls and the conv modules'
``depthwise_glu`` calls on the card (``KernelCalls``) and holds those
kernels' launches equal to them.
Runs a small fp32 model on the GPU (kernels) and on the CPU (twins), for
serving (phase 4) and for one optimizer step (phase 7). Serves the
full-width ``retrieval_model_config()`` model (random weights from a seed)
through the port's HTTP service (phase 5), then trains it through the
port's CLI, ``preset=retrieval`` for one epoch on synthetic clips, and
serves the trained ``final_model`` (phase 8). Trains the reference-parity
``preset=flagship`` (fusion and word-alignment heads) through a preemption
and a mid-epoch resume, with the test and retrieval phases, scores its best
checkpoint with the inference CLI, and holds a small fp32 fused model's
optimizer step on the GPU against the CPU (phase 9). Int8 serving (W8A8,
``torch._int_mm``): the small model's int8 Dense products GPU against CPU
(phase 4), the full-width model served in int8 beside bf16 (phase 5).
Conversion (phase 10): a reference-format checkpoint at the flagship
geometry, written from a seed, goes through ``convert_checkpoint
--from-torch``; the result is scored by ``infer batch`` in bf16 and int8
and trained two micro-steps from ``train.init_checkpoint``. Data parallel
(phase 11), each part in ranks that ``torchrun`` starts (this script with
``--dp-worker``): a small fp32 model as 2 gloo ranks on the card against
one process; ``preset=retrieval`` through the CLI under NCCL at world size
1, preempted by an agreed flag and resumed; the same model as 2 gloo ranks
on the card, their weights bit-identical. Tensor parallel (phase 12),
``mesh.num_model=2`` as 2 gloo ranks on the card: phase 7's small model in
fp32 and bf16 against one process; ``preset=retrieval`` through the CLI,
each rank's peak memory beside the one-rank peak of the same step, its
``final_model`` served in one process; the CLI under NCCL where there are
two cards. The quality tools: ``scripts/torch_int8_quality_eval.py``
scores phase 8's ``final_model`` in bf16 and int8 over 64 test clips at
the end of phase 8, and ``scripts/torch_proxy_quality_run.py`` trains the
midsize retrieval recipe one epoch with every kernel on (phase 13); both
check that log-mel ran only at frame counts phase 2 held against the
twin. The benchmark tools (phase 14): ``bench_torch.py`` (the retrieval
step on the length mix and at 10 s) and ``scripts/torch_infer_bench.py``
in bf16 and int8, each a process of its own, every reading under the
card's bf16 peak. The step-diagnosis tools (phase 15):
``scripts/torch_profile_b16.py --steps 3`` (the retrieval step traced and
attributed: device time by kernel family, the idle gaps by the host op
that launched the kernel ending each) and a short
``scripts/torch_block_breakdown.py``. The ablation tools (phase 16):
``scripts/torch_depthwise_sweep.py``, ``scripts/torch_conv_ablate.py``,
``scripts/torch_flash_ablate.py`` (the flash kernels rebuilt with the
relative bias, then its gradient, switched off, each held against the
twins with E = 0) and ``scripts/torch_flash_tile_sweep.py`` (the
backward's tiles) at full width. Phases 2, 3 and 6 also call each kernel's
raw entry point once with every output and scratch buffer a view inside a
buffer of a sentinel pattern, 4 KiB of guard on each side, and fail on a
changed guard byte or input. Phases 11, 12, 14 and 15 run
``preset=retrieval`` at full width with each encoder cut to six blocks
(``CUT_DEPTH``: one frozen under the five unfrozen). Phases 14-16 only
run processes and read their lines: a thread runs them beside phases
11-13, and the smoke waits for it before it exits. Phases 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15
and 16 check that their path went through its kernels (and, in int8, its
int8 products), counted from zero; the last line before the result lists
each phase's seconds. Each phase prints a line per check; any failure raises and exits non-zero. Detailed
numbers go to ``chiprun_out/chip_smoke.json``. The last line is the JSON
result. Nothing of JAX or of the JAX package is imported.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = "speech_transcript_embeddings_torch"
TPU = "speech_transcript_embeddings_tpu"
BUCKETS = (41200, 82160, 164080, 246000, 491760)
T_PADS = (128, 256, 512, 768, 1536)
RECORD: dict = {}


def log(phase, msg, **data):
    print(f"[phase {phase}] {msg}", flush=True)
    if data:
        RECORD.setdefault(f"phase_{phase}", []).append(data)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms (CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_split(fn, iters=20, warmup=3):
    """{kernel name: mean device ms a call} of the device kernels ``fn``
    launches (torch.profiler, in ``utils/bench.py``'s padded
    ``device_trace``), over ``iters`` calls after ``warmup``: each kernel's
    mean over its recorded launches, times its launches a call. A trace
    can miss a launch (seen on the card before the window was padded: 19
    of 20 recorded in each trace after phase 2, and fewer in a later run),
    so the mean is not taken over ``iters``; a trace that lost more (fewer
    kernels than calls less one) is taken again, twice at most."""
    from speech_transcript_embeddings_torch.utils.bench import device_trace
    for _ in range(warmup):
        fn()
    recorded = []
    for _ in range(3):
        with device_trace() as prof:
            for _ in range(iters):
                fn()
        rows = _device_rows(prof)
        recorded.append(sum(calls for _, _, calls in rows))
        if recorded[-1] >= iters - 1:
            return {name: ms / calls * max(1, round(calls / iters))
                    for ms, name, calls in rows}
    raise RuntimeError(f"torch.profiler recorded {recorded} device kernels "
                       f"in three traces of {iters} calls")


def device_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms: the summed durations of the device
    kernels it launches (``device_split``). Unlike ``cuda_ms`` it does not
    count the gaps in which the device waits for the host to launch the
    next kernel."""
    return sum(device_split(fn, iters, warmup).values())


def phase0():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "test needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    free_gb = shutil.disk_usage(ROOT).free / 1e9
    log(0, f"card {smi}; torch {torch.__version__} (CUDA "
           f"{torch.version.cuda}); {torch.cuda.device_count()} device(s); "
           f"{free_gb:.0f} GB free on the checkout's disk",
        card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        disk_free_gb=free_gb)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase1():
    from speech_transcript_embeddings_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    report = (_build.BUILD_DIR / "nvcc.log").read_text().splitlines()
    ptxas = [ln.strip() for ln in report
             if any(w in ln for w in ("Compiling entry", "registers", "spill"))]
    log(1, f"built {path.name} in {secs:.1f} s", seconds=secs, ptxas=ptxas)
    for ln in ptxas:
        print("   ", ln)


# (B, samples) of every log-mel launch on the main paths: training
# micro-batches of 16 at the three CV buckets (the serving request of 16
# clips of 4.7 s at 82,160 too), the quality proxy's micro-batches of 32 at
# its one 48,000-sample bucket (phase 13), the benchmark tools' 10 s clips
# (phase 14: bench_torch.py's fixed step at B = 16, the embed step's
# B = 64 at the same frame count) and the 30 s serving batch (3 clips → 4);
# the last is the kernels line's "at" shape
MEL_SHAPES = ((16, 41200), (16, 82160), (16, 164080), (32, 48000),
              (16, 160000), (4, 491760))


def mel_frames(n, frame=400, hop=160):
    """Log-mel frames of an ``n``-sample bucket."""
    return 1 + (n - frame) // hop


def check_mel_frames(phase, frames):
    """Fails unless every frame count in ``frames`` (a path's log-mel
    launches by frame count) is one that phase 2 held against the twin."""
    checked = {mel_frames(n) for n in BUCKETS} | \
        {mel_frames(n) for _, n in MEL_SHAPES}
    if not set(frames) <= checked:
        raise AssertionError(f"phase {phase}: log-mel launched at frames "
                             f"{sorted(set(frames) - checked)}, which phase 2 "
                             f"did not check (it checks {sorted(checked)})")


def mel_inputs(g, b, n):
    """A padded waveform batch [b, n] (fp32, 0.1 noise) and its lengths on
    the card: for b = 4 a full clip, 71%, 33% and one under a frame (399
    samples); for more clips lengths spread from n down to 20% of n."""
    import torch
    if b == 4:
        lens = [n, int(n * 0.71), int(n * 0.33), 399]
    else:
        lens = [n - i * (n * 4 // 5) // (b - 1) for i in range(b)]
    lens = torch.tensor(lens, dtype=torch.int32)
    wav = torch.randn(b, n, generator=g) * 0.1
    wav *= torch.arange(n)[None, :] < lens[:, None]
    return wav.cuda(), lens.cuda()


def cufft_log_mel(cfg, wav, window, mel):
    """The raw log-mel as a composite of PyTorch calls around cuFFT: unfold,
    remove DC, preemphasis, window, ``torch.fft.rfft(n=512)``, power, mel
    matmul, log. A yardstick timed beside the kernel; the port never calls
    it."""
    import torch
    from speech_transcript_embeddings_torch.ops import frontend as fe
    b, n = wav.shape
    nf = fe.frames_for_samples(cfg, n)
    need = (nf - 1) * cfg.hop_length + cfg.frame_length
    x = torch.nn.functional.pad(wav * 2.0 ** 15, (0, max(need - n, 0)))
    d = x.unfold(1, cfg.frame_length, cfg.hop_length)[:, :nf]
    d = d - d.mean(-1, keepdim=True)
    p = cfg.preemphasis
    e = torch.cat([(1.0 - p) * d[..., :1], d[..., 1:] - p * d[..., :-1]], -1)
    spec = torch.fft.rfft(e * window, n=cfg.fft_length)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.log(torch.clamp(power @ mel, min=cfg.mel_floor))


def phase2():
    """Both log-mel kernels against their twins: at every bucket (B=4, a
    clip under one frame), then at every shape the main paths launch, where
    they are also timed beside the twin and the cuFFT composite, the raw
    kernel's and the twin's errors are taken per mel bin against a float64
    evaluation, and each kernel gets its bound. Times are device time
    (``device_ms``): a wrapper's host overhead exceeds these kernels'
    device time, so back-to-back CUDA events (``cuda_ms``, kept as
    ``*_call_ms``) time the host. Tolerances: raw log-mel 2e-4 (rtol and
    atol, on the valid frames), features 2e-3, mask exact."""
    import numpy as np
    import torch
    from speech_transcript_embeddings_torch.config import FrontendConfig
    from speech_transcript_embeddings_torch.ops import frontend as fe
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_log_mel_schedule import float64_log_mel
    cfg = FrontendConfig(use_pallas=True)
    front = fk.KernelLogMelFrontend(cfg).cuda()
    window = torch.as_tensor(fe.povey_window(cfg), dtype=torch.float32,
                             device="cuda")
    mel_nnz = int(np.count_nonzero(fe.make_mel_filters(cfg)))
    g = torch.Generator().manual_seed(2)
    worst = {"raw": 0.0, "features": 0.0}

    def check(wav, lens, what):
        raw = front.raw_log_mel(wav)
        ref_raw = fe.log_mel_reference(cfg, wav, front.transform, front.mel)
        valid = fe.num_valid_frames(cfg, lens)
        vmask = (torch.arange(raw.shape[1], device="cuda")[None, :]
                 < valid[:, None])
        raw_err = (raw - ref_raw).abs()[vmask].max().item()
        torch.testing.assert_close(raw[vmask], ref_raw[vmask], rtol=2e-4,
                                   atol=2e-4)
        feats, mask = front.normalize_and_stack(raw, lens)
        ref_feats, ref_mask = fe.normalize_and_stack_reference(cfg, raw,
                                                               lens)
        if not torch.equal(mask, ref_mask):
            raise AssertionError(f"log-mel mask differs at {what}")
        feat_err = (feats - ref_feats).abs().max().item()
        torch.testing.assert_close(feats, ref_feats, rtol=2e-3, atol=2e-3)
        short = (valid == 0).nonzero().flatten().tolist()
        if not torch.isfinite(feats).all() or any(
                feats[i].abs().max() != 0 for i in short):
            raise AssertionError("non-finite features or a sub-frame clip "
                                 "with non-zero features")
        worst["raw"] = max(worst["raw"], raw_err)
        worst["features"] = max(worst["features"], feat_err)
        return raw, ref_raw, vmask, raw_err, feat_err

    for n in BUCKETS:
        wav, lens = mel_inputs(g, 4, n)
        raw, _, _, raw_err, feat_err = check(wav, lens, f"bucket {n}")
        log(2, f"bucket {n} B=4 frames {raw.shape[1]}: raw err "
               f"{raw_err:.2e} (tol 2e-4), features err {feat_err:.2e} "
               f"(tol 2e-3), mask exact", bucket=n, frames=raw.shape[1],
            raw_err=raw_err, feat_err=feat_err)
    times = {}
    for b, n in MEL_SHAPES:
        wav, lens = mel_inputs(g, b, n)
        raw, ref_raw, vmask, raw_err, feat_err = check(wav, lens,
                                                       f"B={b} × {n}")
        # whose error is it: kernel and twin against float64, per mel bin
        ref64 = torch.as_tensor(float64_log_mel(cfg, wav.cpu().numpy()),
                                device="cuda")
        per_bin = {name: ((a.double() - ref64).abs() * vmask[..., None])
                   .amax(dim=(0, 1)).tolist()
                   for name, a in (("kernel", raw), ("twin", ref_raw))}
        composite = cufft_log_mel(cfg, wav, window, front.mel)
        composite_err = (composite - ref_raw).abs()[vmask].max().item()
        del ref64, composite
        (raw_b, raw_by), (norm_b, norm_by), (dft_b, _) = log_mel_bound(
            n, mel_nnz, b=b)
        raw_fn = lambda: front.raw_log_mel(wav)              # noqa: E731
        norm_fn = lambda: front.normalize_and_stack(raw, lens)  # noqa: E731
        t = {
            "raw_ms": device_ms(raw_fn), "raw_call_ms": cuda_ms(raw_fn),
            "raw_plain_ms": device_ms(lambda: fe.log_mel_reference(
                cfg, wav, front.transform, front.mel)),
            "cufft_composite_ms_not_one_call": device_ms(
                lambda: cufft_log_mel(cfg, wav, window, front.mel)),
            "norm_ms": device_ms(norm_fn), "norm_call_ms": cuda_ms(norm_fn),
            "norm_plain_ms": device_ms(
                lambda: fe.normalize_and_stack_reference(cfg, raw, lens)),
            "raw_bound_ms": raw_b, "raw_bound_by": raw_by,
            "norm_bound_ms": norm_b, "norm_bound_by": norm_by,
            "raw_bound_ms_dft_as_dense_matmul": dft_b,
        }
        times[(b, n)] = t
        top = {name: sorted(range(len(v)), key=lambda m: -v[m])[:4]
               for name, v in per_bin.items()}
        log(2, f"B={b} × {n} (frames {raw.shape[1]}): raw err {raw_err:.2e} "
               f"(tol 2e-4), features err {feat_err:.2e} (tol 2e-3), mask "
               f"exact; vs float64 kernel max {max(per_bin['kernel']):.2e} "
               f"(worst bins " + ", ".join(
                   f"{m}: {per_bin['kernel'][m]:.1e}" for m in top['kernel'])
            + f"), twin max {max(per_bin['twin']):.2e} (worst bins "
            + ", ".join(f"{m}: {per_bin['twin'][m]:.1e}" for m in top['twin'])
            + f"); cuFFT composite vs twin {composite_err:.1e}. Device "
              f"time: log-mel kernel {t['raw_ms']:.4f} ms (bound "
              f"{raw_b:.4f} ms by {raw_by}, share {raw_b / t['raw_ms']:.1%}"
              f"; {t['raw_call_ms']:.4f} ms a call back to back), twin "
              f"{t['raw_plain_ms']:.4f} ms, cuFFT composite (not one call) "
              f"{t['cufft_composite_ms_not_one_call']:.4f} ms; normalise "
              f"kernel {t['norm_ms']:.4f} ms (bound {norm_b:.4f} ms by "
              f"{norm_by}, share {norm_b / t['norm_ms']:.1%}; "
              f"{t['norm_call_ms']:.4f} ms a call), twin "
              f"{t['norm_plain_ms']:.4f} ms",
            batch=b, samples=n, frames=raw.shape[1], raw_err=raw_err,
            feat_err=feat_err, per_bin_err_vs_f64=per_bin,
            cufft_composite_err=composite_err, **t)
        del wav, lens, raw, ref_raw
        torch.cuda.empty_cache()
    _guard_log_mel(cfg, front, g)
    return worst, times


BF16_PEAK, FP32_PEAK, HBM_RATE = 989e12, 67e12, 3.35e12   # H100 SXM, dense
# (B·h, t_pad) of the main path: K3 serving 16 × 4.7 s, serving the 30 s
# bucket, training at 164,080 samples; K4 training at 164,080 and 246,000
FWD_BENCH = ((256, 256), (64, 1536), (256, 512))
BWD_BENCH = ((256, 512), (256, 768))


def bound_ms(flop, nbytes, peak):
    """(least time in ms, "operations" or "bytes"): the larger of the
    operations over the peak for their type and the bytes over 3.35 TB/s."""
    t_ops, t_bytes = flop / peak, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_bound(mask, nh, hd, num_pos, dtype, bwd):
    """Bound of the flash forward (bwd=False) or backward at these inputs:
    per row 4·t·n·hd FLOP for q·kᵀ and p·v (10·t·n·hd for the five products
    of the backward) over the n valid keys of its clip (all t_pad keys in a
    clip with none, where p = 1 on every key), plus the qE products; each
    input read once and each output written once."""
    import torch
    t = mask.shape[1]
    lens = torch.sum(mask > 0, dim=1).tolist()
    keys = sum(n if n else t for n in lens) * nh
    bh = len(lens) * nh
    per = 10 if bwd else 4
    flop = per * t * keys * hd + (6 if bwd else 2) * bh * t * num_pos * hd
    size = 2 if dtype == torch.bfloat16 else 4
    tensors = 8 if bwd else 4          # q k v out (+ dout dq dk dv)
    nbytes = bh * t * (tensors * hd * size + 4) + (2 if bwd else 1) * \
        num_pos * hd * size
    return bound_ms(flop, nbytes, BF16_PEAK if dtype == torch.bfloat16
                    else FP32_PEAK)


def _flash_inputs(g, bh, t, hd, dtype, e_scale, nh=16, zero=False):
    """q, k, v, dout, E, mask for B = bh / nh clips: the first full, the
    others at 60% of t (or 0 with ``zero``)."""
    import torch
    b = bh // nh
    q, k, v, dout = (torch.randn(bh, t, hd, generator=g).to("cuda", dtype)
                     for _ in range(4))
    e = (torch.randn(73, hd, generator=g) * e_scale).to("cuda", dtype)
    lens = [t] + [0 if zero else int(t * 0.6)] * (b - 1)
    mask = (torch.arange(t)[None, :] < torch.tensor(lens)[:, None]).to("cuda")
    return q, k, v, dout, e, mask


def _turns(fn_a, fn_b, **kw):
    """Mean times of two versions timed in turns a, b, b, a."""
    a1, b1, b2, a2 = (cuda_ms(f, **kw) for f in (fn_a, fn_b, fn_b, fn_a))
    return (a1 + a2) / 2, (b1 + b2) / 2


def phase3():
    """Flash forward (K3) against its plain twin at every T_PADS, bf16
    through the tensor-core kernel and fp32 through the CUDA-core one
    (tolerance 2e-2 and 1e-4 on out, 1e-3 on lse), and the CUDA-core
    kernel's bf16 instantiation (reached only here) once; then, at the main
    path's shapes, both kernels held against the twin (bf16 tolerances) and
    timed beside the twin and SDPA (no bias, no mask: not the same
    function, a yardstick): device time by torch.profiler (``device_ms``),
    and the time a call takes back to back (CUDA events) beside it. Every
    tensor-core case is launched twice, the two results bit-identical.
    Prints the wgmma kernel's ptxas report and its HGMMA and UTMALDG
    instruction counts (cuobjdump), and fails where an instantiation has
    none."""
    import torch
    import torch.nn.functional as F
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(3)
    nh, hd, left = 16, 64, 64
    kw = dict(num_heads=nh, left_max=left)
    worst, times = {}, {}
    bf, f32 = (torch.bfloat16, 2e-2), (torch.float32, 1e-4)
    cases = [(*dt, "auto", t, hd, "ragged") for dt in (bf, f32)
             for t in T_PADS]
    cases += [(*bf, "auto", 512, 128, "ragged"),
              (*bf, "auto", 256, hd, "zero_length"),
              (*f32, "auto", 256, hd, "zero_length"),
              (*bf, "simt", 768, hd, "ragged")]

    def same_bits(kernel, got, args, what):
        again = fa._fwd_launch(kernel, *args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash fwd {kernel} {what}: two launches "
                                 f"on the same inputs differ")

    for ln in _ptxas_report("fwd_wgmma_kernel"):
        log(3, f"ptxas {ln}", ptxas=ln)
    sass = _sass_counts("fwd_wgmma_kernel")
    for kname, n in sass.items():
        log(3, f"SASS {kname}: " + ", ".join(f"{op} {c}" for op, c in
                                             n.items()), sass={kname: n})
    if len(sass) != 8 or any(0 in n.values() for n in sass.values()):
        raise AssertionError(f"wgmma forward instantiations without HGMMA "
                             f"or UTMALDG: {sass}")
    for dtype, tol, route, t, d, kind in cases:
        name = str(dtype).split(".")[-1]
        q, k, v, _, e, mask = _flash_inputs(g, 2 * nh, t, d, dtype, 0.02,
                                            zero=kind == "zero_length")
        kernel = fa.flash_kernel(dtype, d) if route == "auto" else route
        out, lse = fa._fwd_launch(kernel, q, k, v, e, mask, nh, left)
        if kernel == "mma":
            same_bits(kernel, (out, lse), (q, k, v, e, mask, nh, left),
                      f"t_pad {t} hd {d} {kind}")
        ref, ref_lse = fa.rel_attention_reference(q, k, v, e, mask, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-3)
        worst[kernel] = max(worst.get(kernel, 0.0), err)
        log(3, f"flash fwd {kernel} {name} t_pad {t} B=2 h=16 hd={d} {kind}: "
               f"err {err:.2e} (tol {tol:g}), lse err {lse_err:.2e}",
            kernel=kernel, dtype=name, t_pad=t, hd=d, kind=kind, err=err,
            lse_err=lse_err)
    for bh, t in FWD_BENCH:
        q, k, v, _, e, mask = _flash_inputs(g, bh, t, hd, torch.bfloat16,
                                            0.02)
        ref, ref_lse = fa.rel_attention_reference(q, k, v, e, mask, **kw)
        for kernel in ("mma", "simt"):
            out, lse = fa._fwd_launch(kernel, q, k, v, e, mask, nh, left)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                       atol=2e-2)
            torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-3)
            if kernel == "mma":
                same_bits(kernel, (out, lse), (q, k, v, e, mask, nh, left),
                          f"B·h {bh} t_pad {t}")
            worst[kernel] = max(worst[kernel], err)
            log(3, f"flash fwd {kernel} bfloat16 t_pad {t} B·h {bh} hd={hd} "
                   f"ragged: err {err:.2e} (tol 0.02), lse err "
                   f"{lse_err:.2e}", kernel=kernel, dtype="bfloat16",
                t_pad=t, bh=bh, hd=hd, kind="ragged", err=err,
                lse_err=lse_err)
        del ref, ref_lse, out, lse
        mma = lambda: fa._fwd_launch("mma", q, k, v, e, mask, nh, left)  # noqa: E731
        simt = lambda: fa._fwd_launch("simt", q, k, v, e, mask, nh, left)  # noqa: E731
        call_ms, simt_call_ms = _turns(mma, simt)
        plain = lambda: fa.rel_attention_reference(q, k, v, e, mask, **kw)  # noqa: E731
        q4, k4, v4 = (x.view(bh // nh, nh, t, hd) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4)  # noqa: E731
        b_ms, b_by = flash_bound(mask, nh, hd, 73, torch.bfloat16, False)
        times[(bh, t)] = dict(
            ms=device_ms(mma), simt_ms=device_ms(simt),
            plain_ms=device_ms(plain, iters=5, warmup=1),
            sdpa_ms=device_ms(sdpa), call_ms=call_ms,
            simt_call_ms=simt_call_ms, bound_ms=b_ms, bound_by=b_by)
        tm = times[(bh, t)]
        log(3, f"flash fwd bf16 (B·h {bh}, t_pad {t}, hd 64), device time: "
               f"tensor-core kernel {tm['ms']:.4f} ms ({call_ms:.4f} ms a "
               f"call back to back), CUDA-core kernel {tm['simt_ms']:.4f} ms "
               f"({simt_call_ms:.4f}), twin {tm['plain_ms']:.4f} ms, SDPA "
               f"without bias or mask (not the same function) "
               f"{tm['sdpa_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}), share "
               f"of bound {b_ms / tm['ms']:.1%}", bh=bh, t_pad=t, **tm)
        del q, k, v, e, mask, q4, k4, v4
        torch.cuda.empty_cache()
    _guard_flash_fwd(g)
    return worst, times


def _by_kernel_name(split):
    """``device_split``'s {name: ms} under short names, without return
    type, namespace and arguments (``flash_rel_bwd_dq_wgmma_kernel<64>``),
    the times of names that shorten alike added."""
    short = {}
    for name, ms in split.items():
        name = name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")[:60]
        short[name] = short.get(name, 0.0) + ms
    return short


def _ptxas_report(pattern):
    """'kernel: registers, spills' for each ptxas entry of the last build
    (``_build/nvcc.log``) whose name matches the regular expression
    ``pattern`` (lower case and underscores)."""
    from speech_transcript_embeddings_torch.ops import _build
    lines, report, entry = (_build.BUILD_DIR / "nvcc.log").read_text(
        ).splitlines(), [], None
    for ln in lines:
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if re.search(pattern, ln) else None
        elif entry and "spill" in ln:
            spill = ln.strip()
        elif entry and "registers" in ln:
            # the kernel's name and its template arguments: an int
            # (ILi64E), or as mangled
            m = re.search(r"\d+([a-z_]*" + pattern
                          + r"[a-z_]*)(?:ILi(\d+)E|I(.*?)E)?E", entry)
            report.append(f"{m[1]}<{m[2] or m[3] or ''}>: "
                          f"{ln.split(':', 1)[1].strip()}; {spill}")
            entry = None
    return report


def _sass_counts(pattern, ops=("HGMMA", "UTMALDG")):
    """{kernel<HD>: {op: instructions}} in the built library's SASS
    (``cuobjdump -sass``) for each function whose name matches ``pattern``
    (as in ``_ptxas_report``)."""
    from speech_transcript_embeddings_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            m = re.search(r"\d+([a-z_]+" + pattern + r")ILi(\d+)", ln)
            name = f"{m[1]}<{m[2]}>" if m else None
            if name:
                counts[name] = dict.fromkeys(ops, 0)
        elif name:
            for op in ops:
                counts[name][op] += f" {op}" in ln
    return counts


def _max_rel_err(a, b):
    """max|a − b| / max|b| (fp32)."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


# ---- guard bands around every buffer a kernel writes (phases 2, 3, 6) -------

GUARD_BYTES = 4096


def _pattern(n, device):
    """``n`` bytes of a pattern no kernel writes by chance: (151·i + 89)
    mod 256."""
    import torch
    return ((torch.arange(n, device=device) * 151 + 89) % 256).to(torch.uint8)


class Guarded:
    """Output and scratch tensors of one raw kernel call, each a view
    inside a buffer of the sentinel pattern with ``GUARD_BYTES`` of guard
    before and after it; the inputs' bytes snapped before the call."""

    def __init__(self, kernel, device):
        self.kernel, self.device = kernel, device
        self.bufs, self.inputs = [], []

    def empty(self, name, shape, dtype):
        import torch
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        raw = _pattern(2 * GUARD_BYTES + n, self.device)
        self.bufs.append((name, raw, n))
        return raw[GUARD_BYTES:GUARD_BYTES + n].view(dtype).view(shape)

    def watch(self, **inputs):
        """Snap the inputs, to be found unchanged after the call."""
        self.inputs += [(name, t, t.clone()) for name, t in inputs.items()]

    def check(self, what):
        """Fail on a changed guard byte (naming the kernel, the buffer and
        the byte's offset from the view) or a changed input."""
        import torch
        torch.cuda.synchronize()
        for name, raw, n in self.bufs:
            bad = raw != _pattern(raw.numel(), self.device)
            bad[GUARD_BYTES:GUARD_BYTES + n] = False
            if bad.any():
                off = int(bad.nonzero()[0]) - GUARD_BYTES
                raise AssertionError(
                    f"{self.kernel} at {what} wrote outside {name}: the "
                    f"first changed guard byte is at offset {off} from its "
                    f"start (it holds {n} bytes; {int(bad.sum())} guard "
                    "bytes changed)")
        for name, t, before in self.inputs:
            if not torch.equal(t, before):
                raise AssertionError(f"{self.kernel} at {what} changed its "
                                     f"input {name}")


def _guard_log_mel(cfg, front, g):
    """Both raw log-mel entry points once at every ``MEL_SHAPES`` shape
    and every bucket (ragged clips, the 30 s bucket included): every output
    in guard bands, every input unchanged, the outputs equal to the
    wrappers' (the kernels are deterministic)."""
    import torch
    from speech_transcript_embeddings_torch.ops import _build
    from speech_transcript_embeddings_torch.ops import frontend as fe
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    lib = _build.library()
    tab = fk._device_tables(cfg, torch.device("cuda"))
    shapes = list(MEL_SHAPES) + [(4, n) for n in BUCKETS]
    for b, n in shapes:
        wav, lens = mel_inputs(g, b, n)
        what = f"B={b} × {n}"
        frames = fe.frames_for_samples(cfg, n)
        want = front.raw_log_mel(wav)
        gd = Guarded("log_mel_fft_kernel (ste_log_mel)", "cuda")
        out = gd.empty("out", (b, frames, cfg.num_mel_bins), torch.float32)
        gd.watch(waveform=wav, **tab)
        device, stream = _build.launch_args(wav)
        _build.check(lib.ste_log_mel(
            wav.data_ptr(), b, n, *(tab[k].data_ptr() for k in (
                "window", "window_step", "twiddles", "response",
                "mel_ranges", "mel_weights")), cfg.num_mel_bins,
            cfg.preemphasis / fk.V_SCALE, float(cfg.mel_floor),
            out.data_ptr(), frames, device, stream), "ste_log_mel")
        gd.check(what)
        if not torch.equal(out, want):
            raise AssertionError(f"ste_log_mel at {what}: guarded output "
                                 "differs from the wrapper's")
        feats_want, mask_want = front.normalize_and_stack(want, lens)
        t2 = frames // cfg.stride
        gd2 = Guarded("log_mel_normalize_kernel (ste_log_mel_normalize)",
                      "cuda")
        feats = gd2.empty("features", (b, t2, cfg.num_mel_bins * cfg.stride),
                          torch.float32)
        mask = gd2.empty("mask", (b, t2), torch.int32)
        gd2.watch(logmel=want, num_samples=lens)
        _build.check(lib.ste_log_mel_normalize(
            want.data_ptr(), lens.data_ptr(), b, frames, cfg.num_mel_bins,
            cfg.stride, cfg.frame_length, cfg.hop_length,
            int(cfg.per_bin_normalize), feats.data_ptr(), mask.data_ptr(),
            device, stream), "ste_log_mel_normalize")
        gd2.check(what)
        if not (torch.equal(feats, feats_want) and torch.equal(mask,
                                                               mask_want)):
            raise AssertionError(f"ste_log_mel_normalize at {what}: guarded "
                                 "output differs from the wrapper's")
        del wav, lens, want, out, feats_want, mask_want, feats, mask
    log(2, f"guard bands ({GUARD_BYTES} bytes a side, pattern 151·i + 89): "
           f"ste_log_mel and ste_log_mel_normalize at {len(shapes)} shapes "
           f"(every MEL_SHAPES shape, every bucket at B=4, ragged) wrote "
           f"inside their outputs only, left their inputs unchanged and gave "
           f"the wrappers' bits", guard_shapes=[f"{b}x{n}" for b, n in shapes])


# (B·h, t) of the flash guard checks: the main paths' shapes, a 10 s clip
# (t = 499, not a multiple of 64) and the 30 s bucket
GUARD_FLASH = ((256, 256), (256, 499), (256, 512), (256, 768), (64, 1536))


def _guard_flash_fwd(g, nh=16, hd=64, left=64):
    """The wgmma forward's raw entry point once a ``GUARD_FLASH`` shape,
    ragged clips (the first full, the others at 60%) and one with a clip of
    no valid frame: out and lse in guard bands, the inputs unchanged, the
    outputs equal to ``_fwd_launch``'s."""
    import torch
    from speech_transcript_embeddings_torch.ops import _build
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    lib = _build.library()
    cases = [(bh, t, False) for bh, t in GUARD_FLASH] + [(32, 499, True)]
    for bh, t, zero in cases:
        q, k, v, _, e, mask = _flash_inputs(g, bh, t, hd, torch.bfloat16,
                                            0.02, nh=nh, zero=zero)
        want = fa._fwd_launch("mma", q, k, v, e, mask, nh, left)
        what = f"B·h {bh} t {t}" + (" (clips of no frame)" if zero else "")
        gd = Guarded("flash_rel_fwd_wgmma_kernel (ste_flash_rel_fwd_wgmma)",
                     "cuda")
        out = gd.empty("out", (bh, t, hd), torch.bfloat16)
        lse = gd.empty("lse", (bh, t, 1), torch.float32)
        gd.watch(q=q, k=k, v=v, e=e, mask=mask)
        device, stream = _build.launch_args(q)
        _build.check(lib.ste_flash_rel_fwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(),
            mask.data_ptr(), fa._MASK_KINDS[mask.dtype], out.data_ptr(),
            lse.data_ptr(), bh, t, fa._t_pad(t), hd, e.shape[0], left, nh,
            fa._scale(q.dtype, hd), device, stream),
            "ste_flash_rel_fwd_wgmma")
        gd.check(what)
        if not (torch.equal(out, want[0]) and torch.equal(lse, want[1])):
            raise AssertionError(f"ste_flash_rel_fwd_wgmma at {what}: "
                                 "guarded output differs from _fwd_launch's")
        del q, k, v, e, mask, want, out, lse
    log(3, f"guard bands ({GUARD_BYTES} bytes a side): "
           f"ste_flash_rel_fwd_wgmma at {len(cases)} shapes (B·h, t) "
           f"{[c[:2] for c in cases]}, ragged, t = 499 and the 30 s bucket, "
           "a clip of no frame: out and lse written inside only, inputs "
           "unchanged, _fwd_launch's bits",
        guard_shapes=[list(c) for c in cases])


def _guard_flash_bwd(g, nh=16, hd=64, left=64):
    """The wgmma backward's raw entry point once a ``GUARD_FLASH`` shape
    and a case of clips with no valid frame: dq, dk, dv and the scratch
    kernel A writes for kernel B (q_s, qE, dd) and the dE partials in guard
    bands, the inputs unchanged, the gradients equal to ``_bwd_launch``'s."""
    import torch
    from speech_transcript_embeddings_torch.ops import _build
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    lib = _build.library()
    cases = [(bh, t, False) for bh, t in GUARD_FLASH] + [(32, 499, True)]
    for bh, t, zero in cases:
        q, k, v, dout, e, mask = _flash_inputs(g, bh, t, hd, torch.bfloat16,
                                               0.3, nh=nh, zero=zero)
        out, lse = fa._fwd_launch("mma", q, k, v, e, mask, nh, left)
        want = fa._bwd_launch("mma", q, k, v, e, mask, out, lse, dout, nh,
                              left)
        what = f"B·h {bh} t {t}" + (" (clips of no frame)" if zero else "")
        num_pos = e.shape[0]
        lengths = fa._lengths(mask)
        gd = Guarded("flash_rel_bwd_dq/dkv_wgmma_kernel "
                     "(ste_flash_rel_bwd_wgmma)", "cuda")
        dq, dk, dv, q_s = (gd.empty(name, (bh, t, hd), torch.bfloat16)
                           for name in ("dq", "dk", "dv", "q_s"))
        qe = gd.empty("qE", (bh, t, fa._np_pad(num_pos)), torch.bfloat16)
        dd = gd.empty("dd", (bh, t), torch.float32)
        de_part = gd.empty("dE partials", (bh * -(-t // 64), num_pos, hd),
                           torch.float32)
        gd.watch(q=q, k=k, v=v, e=e, lengths=lengths, out=out, dout=dout,
                 lse=lse)
        device, stream = _build.launch_args(q)
        _build.check(lib.ste_flash_rel_bwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            q_s.data_ptr(), qe.data_ptr(), dd.data_ptr(), de_part.data_ptr(),
            bh, t, fa._t_pad(t), hd, num_pos, left, nh,
            fa._scale(q.dtype, hd), 1.0 / math.sqrt(hd), device, stream),
            "ste_flash_rel_bwd_wgmma")
        gd.check(what)
        got = (dq, dk, dv, torch.sum(de_part, dim=0).to(e.dtype))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"ste_flash_rel_bwd_wgmma at {what}: "
                                 "guarded gradients differ from "
                                 "_bwd_launch's")
        del q, k, v, dout, e, mask, out, lse, want, got, dq, dk, dv, q_s, qe
        del dd, de_part
    torch.cuda.empty_cache()
    log(6, f"guard bands ({GUARD_BYTES} bytes a side): "
           f"ste_flash_rel_bwd_wgmma at {len(cases)} shapes (B·h, t) "
           f"{[c[:2] for c in cases]}, ragged, t = 499 and the 30 s bucket, "
           "clips of no frame: dq, dk, dv, q_s, qE, dd and the dE partials "
           "written inside only, inputs unchanged, _bwd_launch's bits",
        guard_shapes=[list(c) for c in cases])


def phase6():
    """Flash backward (K4) against its plain twin: at every T_PADS in bf16
    (tensor cores) and fp32 (CUDA cores), plus hd 128 and a clip with no
    valid frame. Tolerance: max error over max|twin| per gradient, 2e-2 in
    bf16 and 1e-4 in fp32 (phase 3's forward tolerances); each bf16 case
    launched twice, the two results bit-identical. Then, at the training
    shapes, both kernels (the CUDA-core kernel's bf16 instantiation is
    reached only here) held against the twin (bf16 tolerance) and timed
    beside the twin and SDPA's backward (no bias, no mask: a yardstick), by
    device time (the tensor-core call also kernel by kernel) and
    back-to-back calls as in phase 3. Prints the wgmma pair's ptxas report
    and its HGMMA and UTMALDG instruction counts (cuobjdump), and fails
    where a kernel has none."""
    import torch
    import torch.nn.functional as F
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(6)
    left = 64
    cases = [(dt, t, 2, 16, 64, "ragged", "auto")
             for dt in ("bfloat16", "float32") for t in T_PADS]
    cases += [("bfloat16", 512, 2, 8, 128, "ragged", "auto"),
              ("float32", 512, 2, 8, 128, "ragged", "auto"),
              ("bfloat16", 256, 2, 16, 64, "zero_length", "auto"),
              ("float32", 256, 2, 16, 64, "zero_length", "auto")]
    tols = {"bfloat16": 2e-2, "float32": 1e-4}
    worst, worst_abs, times = {}, {}, {}

    def check(kernel, got, ref, name, t, b, nh, hd, kind):
        torch.cuda.synchronize()
        errs = {}
        for gname, a, r in zip(("dq", "dk", "dv", "dE"), got, ref):
            if a.dtype != r.dtype or a.shape != r.shape or \
                    not torch.isfinite(a).all():
                raise AssertionError(f"flash bwd {gname}: {a.dtype} "
                                     f"{tuple(a.shape)} vs {r.dtype} "
                                     f"{tuple(r.shape)}, or not finite")
            errs[gname] = _max_rel_err(a, r)
            worst_abs[kernel] = max(worst_abs.get(kernel, 0.0), (
                a.float() - r.float()).abs().max().item())
            if errs[gname] > tols[name]:
                raise AssertionError(
                    f"flash bwd {kernel} {gname} {name} t {t} hd {hd} "
                    f"{kind}: max error {errs[gname]:.2e} of max|ref| > "
                    f"{tols[name]}")
        worst[kernel] = max(worst.get(kernel, 0.0), *errs.values())
        log(6, f"flash bwd {kernel} {name} t_pad {t} B={b} h={nh} hd={hd} "
               f"{kind}: max err/max|ref| dq {errs['dq']:.1e} dk "
               f"{errs['dk']:.1e} dv {errs['dv']:.1e} dE {errs['dE']:.1e} "
               f"(tol {tols[name]:g})",
            kernel=kernel, dtype=name, t_pad=t, B=b, heads=nh, hd=hd,
            kind=kind, errs=errs)

    def same_bits(kernel, got, args, what):
        again = fa._bwd_launch(kernel, *args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash bwd {kernel} {what}: two launches "
                                 f"on the same inputs differ")

    for ln in _ptxas_report("bwd_d[a-z]+_wgmma_kernel"):
        log(6, f"ptxas {ln}", ptxas=ln)
    sass = _sass_counts("bwd_d[a-z]+_wgmma_kernel")
    for kname, n in sass.items():
        log(6, f"SASS {kname}: " + ", ".join(f"{op} {c}" for op, c in
                                             n.items()), sass={kname: n})
    if not sass or any(0 in n.values() for n in sass.values()):
        raise AssertionError(f"wgmma kernels without HGMMA or UTMALDG: "
                             f"{sass}")
    for name, t, b, nh, hd, kind, route in cases:
        dtype = getattr(torch, name)
        q, k, v, dout, e, mask = _flash_inputs(
            g, b * nh, t, hd, dtype, 0.3, nh=nh, zero=kind == "zero_length")
        kw = dict(num_heads=nh, left_max=left)
        kernel = fa.flash_kernel(dtype, hd) if route == "auto" else route
        out, lse = fa.flash_attention_fwd(q, k, v, e, mask, **kw)
        args = (q, k, v, e, mask, out, lse, dout, nh, left)
        got = fa._bwd_launch(kernel, *args)
        ref = fa.rel_attention_bwd_reference(q, k, v, e, mask, out, lse,
                                             dout, **kw)
        check(kernel, got, ref, name, t, b, nh, hd, kind)
        if kernel == "mma":
            same_bits(kernel, got, args, f"t_pad {t} hd {hd} {kind}")
        del q, k, v, dout, out, lse, got, ref
        torch.cuda.empty_cache()
    nh, hd = 16, 64
    kw = dict(num_heads=nh, left_max=left)
    for bh, t in BWD_BENCH:
        q, k, v, dout, e, mask = _flash_inputs(g, bh, t, hd, torch.bfloat16,
                                               0.3)
        out, lse = fa.flash_attention_fwd(q, k, v, e, mask, **kw)
        ref = fa.rel_attention_bwd_reference(q, k, v, e, mask, out, lse,
                                             dout, **kw)
        args = (q, k, v, e, mask, out, lse, dout, nh, left)
        for kernel in ("mma", "simt"):
            got = fa._bwd_launch(kernel, *args)
            check(kernel, got, ref, "bfloat16", t, bh // nh, nh, hd,
                  "ragged")
            if kernel == "mma":
                same_bits(kernel, got, args, f"B·h {bh} t_pad {t}")
        del ref, got
        torch.cuda.empty_cache()
        mma = lambda: fa._bwd_launch("mma", q, k, v, e, mask, out, lse,  # noqa: E731
                                     dout, nh, left)
        simt = lambda: fa._bwd_launch("simt", q, k, v, e, mask, out, lse,  # noqa: E731
                                      dout, nh, left)
        call_ms, simt_call_ms = _turns(mma, simt, iters=10)
        plain = lambda: fa.rel_attention_bwd_reference(  # noqa: E731
            q, k, v, e, mask, out, lse, dout, **kw)
        q4, k4, v4 = (x.view(bh // nh, nh, t, hd).detach().requires_grad_()
                      for x in (q, k, v))
        o4 = F.scaled_dot_product_attention(q4, k4, v4)
        d4 = dout.view_as(o4)
        sdpa = lambda: torch.autograd.grad(o4, (q4, k4, v4), d4,  # noqa: E731
                                           retain_graph=True)
        b_ms, b_by = flash_bound(mask, nh, hd, 73, torch.bfloat16, True)
        split = _by_kernel_name(device_split(mma, iters=10))
        for kname, kms in split.items():
            log(6, f"  (B·h {bh}, t_pad {t}) tensor-core wrapper call, "
                   f"device time: {kms:.4f} ms {kname}")
        times[(bh, t)] = dict(
            ms=sum(split.values()), split=split,
            simt_ms=device_ms(simt, iters=10),
            plain_ms=device_ms(plain, iters=5, warmup=1),
            sdpa_ms=device_ms(sdpa, iters=10), call_ms=call_ms,
            simt_call_ms=simt_call_ms, bound_ms=b_ms, bound_by=b_by)
        tm = times[(bh, t)]
        log(6, f"flash bwd bf16 (B·h {bh}, t_pad {t}, hd 64), device time "
               f"of the wrapper's kernels: tensor-core {tm['ms']:.4f} ms "
               f"({call_ms:.4f} ms a call back to back), CUDA-core "
               f"{tm['simt_ms']:.4f} ms ({simt_call_ms:.4f}), twin "
               f"{tm['plain_ms']:.4f} ms, SDPA backward without bias or mask "
               f"(not the same function) {tm['sdpa_ms']:.4f} ms; bound "
               f"{b_ms:.4f} ms ({b_by}), share of bound {b_ms / tm['ms']:.1%}",
            bh=bh, t_pad=t, **tm)
        del q, k, v, dout, e, mask, out, lse, q4, k4, v4, o4, d4
        torch.cuda.empty_cache()
    _guard_flash_bwd(g)
    return worst, worst_abs, times


# phase 17: the LayerNorm kernels at the conformer's bf16 activations of
# the cells: the embed cell's 10 s bucket ([64, 512, 1024]) and the b64
# train cell's ([64, 499, 1024])
LN_SHAPES = ((64, 512, 1024), (64, 499, 1024))
LN_KERNELS = ("layer_norm_fwd", "layer_norm_bwd_dx", "layer_norm_bwd_dgamma")
DW_KERNELS = ("depthwise_glu_fwd", "depthwise_glu_bwd_dx",
              "depthwise_glu_bwd_dw")


class KernelCalls:
    """Counts the plain ``LayerNorm`` calls and the conv modules'
    ``depthwise_glu`` calls on the card from its creation to ``stop``,
    apart from the kernels' own counters (``LAUNCHES``, cleared here):
    ``LayerNorm.forward`` and the encoder's ``depthwise_glu`` are wrapped,
    so every model built meanwhile is seen. A call counts as one forward
    launch before it runs (a remat replay that stops inside it has
    launched); an output that a gradient reaches counts one ``_bwd_dx``
    launch, and one launch of the parameters' sum (``layer_norm_bwd_dgamma``,
    ``depthwise_glu_bwd_dw``) where they train. ``ShardedLayerNorm`` keeps
    its own forward and is not counted."""

    def __init__(self):
        from speech_transcript_embeddings_torch.models import audio_encoder
        from speech_transcript_embeddings_torch.models import layers
        from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
        from speech_transcript_embeddings_torch.ops import layer_norm as ln
        self.calls = dict.fromkeys(LN_KERNELS + DW_KERNELS, 0)
        self._forward = layers.LayerNorm.forward
        self._depthwise_glu = audio_encoder.depthwise_glu
        count = self._count

        def counted_ln(module, x):
            return count(LN_KERNELS, lambda: self._forward(module, x), x,
                         module.weight.requires_grad
                         or module.bias.requires_grad)

        def counted_dw(x, weight):
            return count(DW_KERNELS, lambda: self._depthwise_glu(x, weight),
                         x, weight.requires_grad)

        ln.LAUNCHES.clear()
        dg.LAUNCHES.clear()
        layers.LayerNorm.forward = counted_ln
        audio_encoder.depthwise_glu = counted_dw

    def _count(self, kernels, run, x, params):
        if not x.is_cuda:
            return run()
        fwd, dx, dparams = kernels
        self.calls[fwd] += 1
        y = run()
        if y.requires_grad:
            def reached(_):
                self.calls[dx] += 1
                self.calls[dparams] += params
            y.register_hook(reached)
        return y

    def stop(self, what):
        """Unwraps the calls; raises unless the kernels launched as often
        as the calls say, and LayerNorm's at least once. → the launches by
        kernel."""
        from speech_transcript_embeddings_torch.models import audio_encoder
        from speech_transcript_embeddings_torch.models import layers
        from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
        from speech_transcript_embeddings_torch.ops import layer_norm as ln
        layers.LayerNorm.forward = self._forward
        audio_encoder.depthwise_glu = self._depthwise_glu
        launched = {**{k: ln.LAUNCHES[k] for k in LN_KERNELS},
                    **{k: dg.LAUNCHES[k] for k in DW_KERNELS}}
        if launched != self.calls or not launched["layer_norm_fwd"]:
            raise AssertionError(f"{what}: LayerNorm and depthwise GLU "
                                 f"kernels launched {launched}, the calls "
                                 f"want {self.calls}")
        return launched


def queued_ms(fn, iters=20, warmup=3, hold_ms=40):
    """Mean device time of ``fn`` in ms, without the host's pace: CUDA
    events around ``iters`` calls that the host queues while the device
    spins in ``torch.cuda._sleep`` ahead of them (``hold_ms`` at the
    card's 1,980 MHz, longer if the queue ran dry), so they run back to
    back (the gaps between dependent kernels included)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(hold_ms * 1e-3 * 1.98e9))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()        # the device still holds
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        hold_ms *= 4
    raise RuntimeError(f"queued_ms: the host did not queue {iters} calls "
                       f"within {hold_ms / 4} ms")


def _ln_err(got, want):
    """The largest |got − want| in units of one bf16 rounding of want
    (2⁻⁸ of its magnitude), on a floor of 1e-6 of want's largest."""
    import torch
    want = want.float()
    unit = torch.clamp(want.abs() * 2 ** -8, min=1e-6 * want.abs().max())
    return ((got.float() - want).abs() / unit).max().item()


def phase17():
    """The LayerNorm kernels (``ops/layer_norm.py``) at ``LN_SHAPES`` in
    bf16, γ and β fp32 with their gradients: the forward, the backward
    (dx, then dγ and dβ from persistent partials) and the backward of a
    frozen bf16 γ, β (dx alone), each held against the plain chain within
    one bf16 step (2⁻⁷ of the value: the two sides round fp32 values that
    differ in their last bits) and timed (``queued_ms``: device time, the
    host's pace left out) beside its bytes bound, the plain chain (input
    cast, γ/β widened, ATen fp32 LayerNorm, cast back) and ATen's LayerNorm
    on bf16 (``library_ms``, which the port never calls). Prints the
    kernels' ptxas report."""
    import torch
    import torch.nn.functional as F
    from speech_transcript_embeddings_torch.ops import layer_norm as ln
    log(17, "ptxas: " + "; ".join(_ptxas_report("layer_norm")))
    out = {}
    for shape in LN_SHAPES:
        g = torch.Generator().manual_seed(sum(shape))
        rows, n = shape[0] * shape[1], shape[2]
        x = (torch.randn(*shape, generator=g) * 3 + 1).to("cuda",
                                                          torch.bfloat16)
        dy = torch.randn(*shape, generator=g).to("cuda", torch.bfloat16)
        w = (1 + 0.1 * torch.randn(n, generator=g)).to("cuda")
        b = (0.1 * torch.randn(n, generator=g)).to("cuda")
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        eps, bf = 1e-5, torch.bfloat16
        y, xc, mean, rstd = ln._fwd(x, w, b, eps, bf)
        dx, dgamma, dbeta = ln._bwd(dy, xc, w, mean, rstd, True, True)
        dx_frozen = ln._bwd(dy, xc, wb, mean, rstd, True, False)[0]
        # the plain chain and its autograd backward
        xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, w, b))
        want = ln.layer_norm_reference(xr, wr, br, eps, bf)
        want_dx, want_dg, want_db = torch.autograd.grad(
            want, (xr, wr, br), dy, retain_graph=True)
        xf = x.detach().clone().requires_grad_()
        want_f = ln.layer_norm_reference(xf, wb, bb, eps, bf)
        want_dx_frozen = torch.autograd.grad(want_f, (xf,), dy,
                                             retain_graph=True)[0]
        torch.cuda.synchronize()
        err = {"y": _ln_err(y, want), "dx": _ln_err(dx, want_dx),
               "dx_frozen": _ln_err(dx_frozen, want_dx_frozen)}
        for name, got, ref in (("dgamma", dgamma, want_dg),
                               ("dbeta", dbeta, want_db)):
            err[name] = ((got - ref).abs().max() / ref.abs().max()).item()
        if max(err["y"], err["dx"], err["dx_frozen"]) > 2.0 or \
                max(err["dgamma"], err["dbeta"]) > 1e-4:
            raise AssertionError(f"layer_norm at {shape}: {err} (bf16 "
                                 "roundings; dγ, dβ relative to the largest)")
        # ATen's LayerNorm on bf16 (the yardstick) and its backward
        xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, wb, bb))
        lib = F.layer_norm(xl, (n,), wl, bl, eps)
        fwd = lambda: ln._fwd(x, w, b, eps, bf)
        bwd = lambda: ln._bwd(dy, xc, w, mean, rstd, True, True)
        times = {
            "fwd_ms": queued_ms(fwd),
            "bwd_ms": queued_ms(bwd),
            "bwd_frozen_ms": queued_ms(
                lambda: ln._bwd(dy, xc, wb, mean, rstd, True, False)),
            "fwd_call_ms": cuda_ms(fwd), "bwd_call_ms": cuda_ms(bwd),
            "plain_fwd_ms": queued_ms(
                lambda: ln.layer_norm_reference(x, w, b, eps, bf)),
            "plain_fwd_frozen_ms": queued_ms(
                lambda: ln.layer_norm_reference(x, wb, bb, eps, bf)),
            "plain_bwd_ms": queued_ms(lambda: torch.autograd.grad(
                want, (xr, wr, br), dy, retain_graph=True)),
            "plain_bwd_frozen_ms": queued_ms(lambda: torch.autograd.grad(
                want_f, (xf,), dy, retain_graph=True)),
            "library_fwd_ms": queued_ms(
                lambda: F.layer_norm(x, (n,), wb, bb, eps)),
            "library_bwd_ms": queued_ms(lambda: torch.autograd.grad(
                lib, (xl, wl, bl), dy, retain_graph=True)),
            "max_err": err}
        # each input read once, each output written once: x, y (bf16),
        # γ, β, μ, rstd forward; dy, x, dx, μ, rstd, γ, dγ, dβ backward
        times["fwd_bound_ms"], times["fwd_bound_by"] = bound_ms(
            7 * rows * n, rows * n * 4 + 8 * n + 8 * rows, FP32_PEAK)
        times["bwd_bound_ms"], times["bwd_bound_by"] = bound_ms(
            12 * rows * n, rows * n * 6 + 12 * n + 8 * rows, FP32_PEAK)
        times["bwd_frozen_bound_ms"], _ = bound_ms(
            8 * rows * n, rows * n * 6 + 2 * n + 8 * rows, FP32_PEAK)
        for d in ("fwd", "bwd", "bwd_frozen"):
            times[f"{d}_share"] = times[f"{d}_bound_ms"] / times[f"{d}_ms"]
        key = "x".join(map(str, shape))
        out[key] = times
        log(17, f"layer_norm {key} bf16: fwd {times['fwd_ms']:.4f} ms "
                f"(bound {times['fwd_bound_ms']:.4f}, "
                f"{100 * times['fwd_share']:.1f}%; plain "
                f"{times['plain_fwd_ms']:.4f}, frozen "
                f"{times['plain_fwd_frozen_ms']:.4f}; ATen bf16 "
                f"{times['library_fwd_ms']:.4f}), bwd {times['bwd_ms']:.4f} "
                f"(bound {times['bwd_bound_ms']:.4f}, "
                f"{100 * times['bwd_share']:.1f}%; plain "
                f"{times['plain_bwd_ms']:.4f}; ATen bf16 "
                f"{times['library_bwd_ms']:.4f}), frozen bwd "
                f"{times['bwd_frozen_ms']:.4f} "
                f"({100 * times['bwd_frozen_share']:.1f}%; plain "
                f"{times['plain_bwd_frozen_ms']:.4f}); err {err}",
            **{"shape": key, **times})
    return out


# phase 18: the depthwise GLU kernels at the conv module's bf16 activations
# of the cells (C = 1024, K = 31): the embed cell's 10 s bucket (T = 512)
# and the b64 train cell's (T = 499), and a rank's half width under tensor
# parallel
DW_SHAPES = ((64, 512, 1024), (64, 499, 1024), (64, 499, 512))


def phase18():
    """The depthwise GLU kernels (``ops/depthwise_glu.py``) at
    ``DW_SHAPES`` in bf16, K = 31: the forward, the backward with an fp32
    weight's gradient (dx, then dw from persistent partials) and the
    backward of a frozen bf16 weight (dx alone), each held against the
    plain version of the kernels' arithmetic within one bf16 step (dw
    within 1e-4 of its largest) and timed (``queued_ms``) beside its bytes
    bound and the plain ATen chain that the conv module ran before
    (``depthwise_glu_chain`` and the depthwise norm's copy of its
    transposed output; its backward by autograd), the yardstick. Prints
    the kernels' ptxas report."""
    import torch
    from speech_transcript_embeddings_torch.ops import depthwise_glu as dg
    log(18, "ptxas: " + "; ".join(_ptxas_report("depthwise_glu")))
    out = {}
    for shape in DW_SHAPES:
        b, t, c = shape
        k, bf = 31, torch.bfloat16
        g = torch.Generator().manual_seed(sum(shape))
        x = torch.randn(b, t, 2 * c, generator=g).to("cuda", bf)
        w = (0.2 * torch.randn(c, 1, k, generator=g)).to("cuda")
        wb = w.to(bf)
        dy = torch.randn(b, t, c, generator=g).to("cuda", bf)
        y, xc = dg._fwd(x, w)
        dx, dw = dg._bwd(dy, xc, w, True, True)
        dx_frozen = dg._bwd(dy, xc, wb, True, False)[0]
        want = dg.depthwise_glu_reference(x, w)
        want_dx, want_dw = dg.depthwise_glu_bwd_reference(dy, x, w)
        want_dx_frozen = dg.depthwise_glu_bwd_reference(dy, x, wb)[0]
        torch.cuda.synchronize()
        err = {"y": _ln_err(y, want), "dx": _ln_err(dx, want_dx),
               "dx_frozen": _ln_err(dx_frozen, want_dx_frozen),
               "dw": ((dw - want_dw).abs().max()
                      / want_dw.abs().max()).item()}
        if max(err["y"], err["dx"], err["dx_frozen"]) > 2.0 or \
                err["dw"] > 1e-4:
            raise AssertionError(f"depthwise_glu at {shape}: {err} (bf16 "
                                 "roundings; dw relative to the largest)")
        # the chain and its autograd backward (the depthwise norm's copy of
        # the transposed output included)
        xr, wr = (v.detach().clone().requires_grad_() for v in (x, w))
        chain = dg.depthwise_glu_chain(xr, wr).contiguous()
        xf = x.detach().clone().requires_grad_()
        chain_f = dg.depthwise_glu_chain(xf, wb).contiguous()
        fwd = lambda: dg._fwd(x, w)
        bwd = lambda: dg._bwd(dy, xc, w, True, True)
        times = {
            "fwd_ms": queued_ms(fwd),
            "bwd_ms": queued_ms(bwd),
            "bwd_frozen_ms": queued_ms(
                lambda: dg._bwd(dy, xc, wb, True, False)),
            "fwd_call_ms": cuda_ms(fwd), "bwd_call_ms": cuda_ms(bwd),
            "plain_fwd_ms": queued_ms(
                lambda: dg.depthwise_glu_chain(x, w).contiguous()),
            "plain_bwd_ms": queued_ms(lambda: torch.autograd.grad(
                chain, (xr, wr), dy, retain_graph=True)),
            "plain_bwd_frozen_ms": queued_ms(lambda: torch.autograd.grad(
                chain_f, (xf,), dy, retain_graph=True)),
            "max_err": err}
        # each input read once, each output written once: x, w, y forward;
        # dy, x, w, dx, dw backward. Operations: the GLU (≈ 5 a channel and
        # time) and 2 a tap in each sum
        n = b * t * c
        times["fwd_bound_ms"], times["fwd_bound_by"] = bound_ms(
            (5 + 2 * k) * n, 6 * n + 4 * c * k, FP32_PEAK)
        times["bwd_bound_ms"], times["bwd_bound_by"] = bound_ms(
            (10 + 4 * k) * n, 10 * n + 8 * c * k, FP32_PEAK)
        times["bwd_frozen_bound_ms"], _ = bound_ms(
            (10 + 2 * k) * n, 10 * n + 2 * c * k, FP32_PEAK)
        for d in ("fwd", "bwd", "bwd_frozen"):
            times[f"{d}_share"] = times[f"{d}_bound_ms"] / times[f"{d}_ms"]
        key = "x".join(map(str, shape))
        out[key] = times
        log(18, f"depthwise_glu {key} bf16, K {k}: fwd {times['fwd_ms']:.4f}"
                f" ms (bound {times['fwd_bound_ms']:.4f}, "
                f"{100 * times['fwd_share']:.1f}%; chain "
                f"{times['plain_fwd_ms']:.4f}), bwd {times['bwd_ms']:.4f} "
                f"(bound {times['bwd_bound_ms']:.4f}, "
                f"{100 * times['bwd_share']:.1f}%; chain "
                f"{times['plain_bwd_ms']:.4f}), frozen bwd "
                f"{times['bwd_frozen_ms']:.4f} "
                f"({100 * times['bwd_frozen_share']:.1f}%; chain "
                f"{times['plain_bwd_frozen_ms']:.4f}); err {err}",
            **{"shape": key, **times})
    return out


def _clip(seconds, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    env = 0.5 + 0.5 * np.sin(np.linspace(0, 40 * seconds, n)) ** 2
    return (rng.normal(scale=0.1, size=n) * env).astype(np.float32)


def phase4():
    import dataclasses

    import numpy as np
    import torch
    from speech_transcript_embeddings_torch.config import (
        AudioEncoderConfig, DataConfig, ExperimentConfig, FrontendConfig,
        HeadsConfig, ModelConfig, TextEncoderConfig,
    )
    from speech_transcript_embeddings_torch.inference.embed import Embedder
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    mc = ModelConfig(
        text=TextEncoderConfig(vocab_size=1000, hidden_size=128, num_layers=2,
                               num_heads=4, intermediate_size=512),
        audio=AudioEncoderConfig(hidden_size=256, num_layers=2, num_heads=4,
                                 intermediate_size=1024,
                                 use_flash_attention=True),
        frontend=FrontendConfig(use_pallas=True),
        heads=HeadsConfig(projection_dim=128, use_cross_modal=False,
                          use_word_alignment=False),
        dtype="float32")
    cfg = ExperimentConfig(model=mc, data=DataConfig(dataset="synthetic"))
    cpu_model = init_model(mc, torch.Generator().manual_seed(4))
    gpu_model = copy.deepcopy(cpu_model).cuda()
    texts = ["casa tempo dia", "mar sol", "uma frase de teste bem mais longa"]
    batches = [[_clip(2.5, 1), _clip(4.0, 2)], [_clip(9.0, 3)],
               [_clip(28.0, 4), _clip(1.0, 5)]]
    cpu, gpu = Embedder(cfg, cpu_model), Embedder(cfg, gpu_model)
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    fa.LAUNCHES.clear()           # counts of this fp32 path start at zero
    kernel_calls = KernelCalls()
    errs = [float(np.abs(gpu.embed_texts(texts) - cpu.embed_texts(texts)).max())]
    for clips in batches:
        a, b = gpu.embed_audios(clips), cpu.embed_audios(clips)
        if not np.isfinite(a).all():
            raise AssertionError("non-finite small-config embeddings")
        errs.append(float(np.abs(a - b).max()))
    launches = dict(fa.LAUNCHES)
    kernel_launched = kernel_calls.stop("fp32 serving")
    worst = max(errs)
    if worst > 1e-4:
        raise AssertionError(f"GPU (kernels) vs CPU (twins) embeddings differ "
                             f"by {worst:.2e} > 1e-4: {errs}")
    if set(launches) != {"flash_rel_fwd"} or launches["flash_rel_fwd"] < 6:
        raise AssertionError(f"fp32 serving launched {launches}: want only "
                             f"the CUDA-core kernel, twice per audio batch")
    launches.update(kernel_launched)
    log(4, f"small f32 model (2 layers, audio 256/4 heads, text 128): GPU "
           f"kernels vs CPU twins max err {worst:.2e} (tol 1e-4) over texts "
           f"and buckets 41200/164080/491760; flash launches {launches}",
        errs=errs, launches=launches)
    int8 = _phase4_int8(cfg, cpu_model, texts, batches, gpu)
    return launches, int8


def _int8_dense_counts(model):
    """Quantized Dense modules on the text path and on the audio path."""
    from speech_transcript_embeddings_torch.ops.quant import Int8Dense
    names = [n for n, m in model.named_modules() if isinstance(m, Int8Dense)]
    return {path: sum(n.startswith(tuple(f"{path}_{p}" for p in (
        "encoder.", "projection.", "pooling."))) for n in names)
        for path in ("text", "audio")}, len(names)


def _phase4_int8(cfg, cpu_model, texts, batches, gpu_fp):
    """Int8 serving (W8A8) of the small model on the GPU (cuBLASLt int8
    products) and on the CPU (the plain int32 product). Each quantized
    Dense of the GPU run is fed its own captured input on both devices: the
    int8 activations and the int32 products must be bit-equal, the outputs
    within 1e-5 of their largest element. End to end, unit-norm
    embeddings: the text within 1e-3 of the CPU's; the audio, whose
    log-mel features already differ between the kernels and the twins (up
    to 2e-4), at cosine ≥ 0.999 to the CPU's, because int8 rounding turns
    a small change of an activation into a whole step where x/s_x crosses
    a half (on the CPU, a 1e-6 relative change of this model's input moves
    its int8 audio embeddings by 3.5-4.1e-3); and both at cosine ≥ 0.995
    to the GPU's full precision (tests/test_quant.py's bound). The product
    count must be the quantized Dense modules of each path × its forwards.
    Then torch._int_mm's shape rules on the card, and whether a transposed
    int8 weight (a view) gives the same product, at what time."""
    import numpy as np
    import torch
    from speech_transcript_embeddings_torch.inference.embed import Embedder
    from speech_transcript_embeddings_torch.ops import quant
    cpu = Embedder(cfg, copy.deepcopy(cpu_model)).quantize_int8()
    gpu = Embedder(cfg, copy.deepcopy(cpu_model).cuda()).quantize_int8()
    per_path, n_q = _int8_dense_counts(gpu.model)
    captured = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: captured.append(
            (name, args[0].detach(), out.detach())))
        for name, m in gpu.model.named_modules()
        if isinstance(m, quant.Int8Dense)]
    quant.int8_matmul.launches = 0      # the int8 path's count starts here
    try:
        out = {"text": [gpu.embed_texts(texts)], "audio": [
            gpu.embed_audios(clips) for clips in batches]}
    finally:
        for h in hooks:
            h.remove()
    products = quant.int8_matmul.launches
    want = per_path["text"] + per_path["audio"] * len(batches)
    if products != want:
        raise AssertionError(f"{products} int8 products for {per_path} "
                             f"quantized Dense × 1 text and {len(batches)} "
                             f"audio forwards (want {want})")
    ref = {"text": [cpu.embed_texts(texts)],
           "audio": [cpu.embed_audios(clips) for clips in batches]}
    fp = {"text": [gpu_fp.embed_texts(texts)],
          "audio": [gpu_fp.embed_audios(clips) for clips in batches]}
    cpu_mods = dict(cpu.model.named_modules())
    dense_err, shapes = 0.0, set()
    for name, x, y in captured:
        xq, _ = quant.quantize_activations(x)
        xq_cpu, _ = quant.quantize_activations(x.cpu())
        mod = cpu_mods[name]
        n, k = mod.weight_q.shape
        acc = quant.int8_matmul(xq.reshape(-1, k),
                                gpu.model.get_submodule(name).weight_q.t())
        if not torch.equal(xq.cpu(), xq_cpu) or not torch.equal(
                acc.cpu(), quant.int8_matmul(xq_cpu.reshape(-1, k),
                                             mod.weight_q.t())):
            raise AssertionError(f"{name}: int8 activations or int32 "
                                 f"products differ between GPU and CPU")
        y_cpu = mod(x.cpu())
        err = ((y.float().cpu() - y_cpu.float()).abs().max()
               / y_cpu.float().abs().max().clamp_min(1e-30)).item()
        dense_err = max(dense_err, err)
        shapes.add((xq.reshape(-1, k).shape[0], k, n))
    if dense_err > 1e-5:
        raise AssertionError(f"an int8 Dense's output differs GPU vs CPU by "
                             f"{dense_err:.2e} of its largest element")
    e2e = {"text": 0.0, "audio": 0.0}
    cos_cpu, cos_fp = 1.0, 1.0
    for path in ("text", "audio"):
        for g, c, f in zip(out[path], ref[path], fp[path]):
            norms = np.linalg.norm(g, axis=1)
            if not np.isfinite(g).all() or np.abs(norms - 1).max() > 1e-3:
                raise AssertionError(f"int8 {path} embeddings: norms {norms}")
            e2e[path] = max(e2e[path], float(np.abs(g - c).max()))
            cos_fp = min(cos_fp, float(np.sum(g * f, axis=1).min()))
            if path == "audio":
                cos_cpu = min(cos_cpu, float(np.sum(g * c, axis=1).min()))
    if e2e["text"] > 1e-3 or cos_cpu < 0.999 or cos_fp < 0.995:
        raise AssertionError(f"int8 GPU vs CPU: text max err "
                             f"{e2e['text']:.2e} (tol 1e-3), audio cosine "
                             f"{cos_cpu:.5f} (≥ 0.999); vs full precision "
                             f"cosine {cos_fp:.5f} (≥ 0.995)")
    rules = _int_mm_rules()
    log(4, f"int8 (W8A8): {n_q} quantized Dense ({per_path}); GPU vs CPU "
           f"unit-norm embeddings: text max err {e2e['text']:.2e} (tol "
           f"1e-3), audio max err {e2e['audio']:.2e}, cosine min "
           f"{cos_cpu:.6f} (≥ 0.999); each int8 "
           f"Dense on its captured input: int8 activations and int32 "
           f"products bit-equal, output max err {dense_err:.1e} of its "
           f"largest (tol 1e-5), {len(captured)} calls at (M, K, N) "
           f"{sorted(shapes)[:6]}...; int8 vs full precision cosine min "
           f"{cos_fp:.5f} (bound 0.995); {products} torch._int_mm calls = "
           f"quantized Dense × forwards; torch._int_mm on the card: {rules}",
        e2e_err=e2e, audio_cos_vs_cpu=cos_cpu, dense_err=dense_err,
        cos_vs_fp=cos_fp,
        products=products, quantized=per_path, shapes=sorted(shapes),
        int_mm_rules=rules)
    return products


def _int_mm_rules():
    """What torch._int_mm takes on the card: rows ≤ 16, inner and output
    dims that are not multiples of 8 (each refused or not), and whether a
    transposed weight view gives the same product as the contiguous
    weight, with both times (device time, torch.profiler) and the kernels
    the view launches."""
    import torch
    g = torch.Generator().manual_seed(9)
    x = torch.randint(-127, 128, (4096, 1024), generator=g,
                      dtype=torch.int8).cuda()
    w_nk = torch.randint(-127, 128, (4096, 1024), generator=g,
                         dtype=torch.int8).cuda()
    w_kn = w_nk.t().contiguous()
    out = {}
    for what, (m, k, n) in (("rows 16", (16, 1024, 1024)),
                            ("rows 17", (17, 1024, 1024)),
                            ("rows 148", (148, 1024, 1024)),
                            ("inner 36", (64, 36, 64)),
                            ("output 36", (64, 64, 36))):
        try:
            torch._int_mm(x[:m, :k].contiguous(), w_kn[:k, :n].contiguous())
            torch.cuda.synchronize()
            out[what] = "taken"
        except RuntimeError as e:
            out[what] = f"refused ({str(e).splitlines()[0][:90]})"
    plain = (x[:256].cpu().to(torch.int32) @ w_kn.cpu().to(torch.int32)
             ).cuda()
    view = torch._int_mm(x[:256], w_nk.t())
    contiguous = torch._int_mm(x[:256], w_kn)
    out["contiguous weight exact"] = bool(torch.equal(contiguous, plain))
    out["transposed view equals it"] = bool(torch.equal(view, contiguous))
    from speech_transcript_embeddings_torch.utils.bench import device_trace
    for what, w in (("contiguous", w_kn), ("transposed view", w_nk.t())):
        torch._int_mm(x, w)
        with device_trace() as prof:
            torch._int_mm(x, w)
        out[f"{what}: device kernels (ms, name, calls)"] = [
            (round(ms, 4), k[:60], c) for ms, k, c in _device_rows(prof)]
        # CUDA events over back-to-back calls (4096 × 1024 × 4096)
        out[f"{what}: ms a call"] = cuda_ms(lambda: torch._int_mm(x, w))
    return out


def _request(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        status, body = r.status, json.loads(r.read())
    return status, body, (time.perf_counter() - t0) * 1e3


def _check_embs(body, n, what):
    import numpy as np
    e = np.asarray(body["embeddings"], np.float64)
    if e.shape != (n, 768) or not np.isfinite(e).all():
        raise AssertionError(f"{what}: bad embeddings {e.shape}")
    norms = np.linalg.norm(e, axis=1)
    if np.abs(norms - 1).max() >= 1e-3:
        raise AssertionError(f"{what}: norms {norms}")
    return e


def phase5():
    """Full-width serving of the seed-0 retrieval model over HTTP, in bf16
    and then in int8 (W8A8) from the same checkpoint."""
    build_dir = os.path.join(ROOT, REPO, "_build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build_dir)
    try:
        return _phase5(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase5(tmp):
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch
    from speech_transcript_embeddings_torch import checkpoints
    from speech_transcript_embeddings_torch.config import (
        DataConfig, ExperimentConfig, retrieval_model_config,
    )
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    from speech_transcript_embeddings_torch.models.layers import Dense, Embed
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    from speech_transcript_embeddings_torch.serve import (
        EmbeddingService, make_handler,
    )
    cfg = ExperimentConfig(model=retrieval_model_config(),
                           data=DataConfig(dataset="synthetic"))
    t0 = time.perf_counter()
    model = init_model(cfg.model, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    path = os.path.join(tmp, "retrieval_seed0")
    checkpoints.save_params_checkpoint(path, model, cfg, info={"seed": 0})
    del model
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    service = EmbeddingService(path, device="cuda")
    setup_s = time.perf_counter() - t0
    # serving stores every Dense and Embed weight in its compute dtype (bf16
    # in the encoders), so the cast at each call is a no-op
    dense = [m for m in service.embedder.model.modules()
             if isinstance(m, (Dense, Embed))]
    if any(m.weight.dtype != m.dtype for m in dense):
        raise AssertionError("a served Dense/Embed weight is not stored in "
                             "its compute dtype")
    n_bf16 = sum(m.weight.dtype == torch.bfloat16 for m in dense)
    log(5, f"retrieval_model_config: {n_params / 1e6:.1f}M params in "
           f"{cfg.model.dtype}, init + save + load {setup_s:.1f} s; "
           f"{n_bf16}/{len(dense)} Dense/Embed weights stored in bf16 (the "
           f"rest are the fp32 heads)",
        params=n_params, setup_s=setup_s, dense_bf16=n_bf16,
        dense=len(dense))
    if not 850e6 < n_params < 900e6:
        raise AssertionError(f"unexpected parameter count {n_params}")

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    texts = ["casa tempo dia noite", "mar sol", "uma palavra longa de teste",
             "a cidade dorme sob a chuva fina da noite de inverno"]
    short, mid, long_ = _clip(2.5, 11), _clip(9.0, 12), _clip(28.0, 13)
    batch16 = [_clip(4.7, 20 + i) for i in range(16)]
    lat = {}
    audio_forwards = 0
    # every count starts at zero just before the main path runs
    fk.log_mel.launches = 0
    fk.log_mel.launches_by_frames.clear()
    fk.normalize_and_stack.launches = 0
    fa.LAUNCHES.clear()
    kernel_calls = KernelCalls()
    try:
        status, body, lat["healthz"] = _request(url + "/healthz")
        if status != 200 or body["projection_dim"] != 768:
            raise AssertionError(f"/healthz: {status} {body}")
        for tag in ("cold", "warm"):
            status, body, lat[f"embed_text_4_{tag}"] = _request(
                url + "/embed_text", {"texts": texts})
            text_embs = _check_embs(body, 4, "/embed_text")
        for tag in ("cold", "warm"):
            status, body, lat[f"embed_audio_3_{tag}"] = _request(
                url + "/embed_audio",
                {"audios": [short.tolist(), mid.tolist(), long_.tolist()]})
            batch = _check_embs(body, 3, "/embed_audio")
            audio_forwards += 1
        for tag in ("cold", "warm"):
            status, body, lat[f"embed_audio_9s_alone_{tag}"] = _request(
                url + "/embed_audio", {"audios": [mid.tolist()]})
            alone = _check_embs(body, 1, "/embed_audio alone")[0]
            audio_forwards += 1
        cos = float(alone @ batch[1])
        if cos < 0.999:
            raise AssertionError(f"9 s clip alone vs in the batch: cos {cos}")
        for tag in ("cold", "warm"):
            status, body, lat[f"embed_audio_16x4.7s_{tag}"] = _request(
                url + "/embed_audio", {"audios": [c.tolist() for c in batch16]})
            audio_embs = _check_embs(body, 16, "/embed_audio x16")
            audio_forwards += 1
        status, body, lat["similarity"] = _request(
            url + "/similarity", {"text": texts[0], "audio": short.tolist()})
        audio_forwards += 2          # the batcher's embedding + embed_pair
        if not (-1 <= body["similarity"] <= 1 and
                abs(body["similarity"] - body["similarity_fused"]) < 1e-3):
            raise AssertionError(f"/similarity: {body}")
        torch.cuda.synchronize()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    launches = {"log_mel": fk.log_mel.launches,
                "log_mel_normalize": fk.normalize_and_stack.launches,
                "flash_rel_fwd_wgmma": fa.LAUNCHES["flash_rel_fwd_wgmma"],
                "flash_rel_fwd": fa.LAUNCHES["flash_rel_fwd"],
                **kernel_calls.stop("serving")}
    by_frames = dict(fk.log_mel.launches_by_frames)
    layers = cfg.model.audio.num_layers
    if launches["flash_rel_fwd_wgmma"] != layers * audio_forwards or \
            launches["flash_rel_fwd"] != 0:
        raise AssertionError(f"flash launched {launches} for "
                             f"{audio_forwards} audio forwards of {layers} "
                             f"blocks: every one must be the tensor-core "
                             f"kernel")
    if launches["log_mel"] != audio_forwards or \
            launches["log_mel_normalize"] != audio_forwards:
        raise AssertionError(f"log-mel launches {launches} for "
                             f"{audio_forwards} audio forwards")
    if 3072 not in by_frames or not any(f < 3072 for f in by_frames):
        raise AssertionError(f"log-mel ran at frame counts {by_frames}: need "
                             "the 30 s bucket (TPU K2) and a shorter one (K1)")
    clips_per_s = {k: n / (lat[k] / 1e3) for k, n in (
        ("embed_audio_3_warm", 3), ("embed_audio_16x4.7s_warm", 16))}
    for k, v in lat.items():
        log(5, f"{k}: {v:.1f} ms", request=k, ms=v)
    log(5, f"audio clips/s (warm, one request each): 3 clips in the 30 s "
           f"bucket {clips_per_s['embed_audio_3_warm']:.1f}, 16 clips of "
           f"4.7 s {clips_per_s['embed_audio_16x4.7s_warm']:.1f}; alone vs "
           f"batched cos {cos:.6f}; launches {launches}, log-mel by frames "
           f"{by_frames}", clips_per_s=clips_per_s, cos=cos,
        launches=launches, by_frames={str(k): v for k, v in by_frames.items()})
    bf16 = _breakdown(service.embedder, {
        "16 clips of 4.7 s": (batch16, lat["embed_audio_16x4.7s_warm"]),
        "3 clips, 30 s bucket": ([short, mid, long_],
                                 lat["embed_audio_3_warm"])}, "bf16")
    log(5, f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
           f" GiB", peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    bf16.update(_serving_memory(service.embedder, texts, batch16, mem0))
    _release(service)
    del service, httpd, dense
    int8 = _phase5_int8(path, texts, batch16, text_embs, audio_embs, bf16,
                        layers)
    return launches, int8


def _serving_memory(embedder, texts, clips, before):
    """Device memory of a serving Embedder: what it holds at rest (weights
    and tables: allocated now less ``before``, taken just before it was
    built), and the most that one text and one audio request allocate on
    top; their sum is a serving process's peak."""
    import torch
    torch.cuda.synchronize()
    now = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    embedder.embed_texts(texts)
    embedder.embed_audios(clips)
    torch.cuda.synchronize()
    out = {"resident_gib": (now - before) / 2**30,
           "request_gib": (torch.cuda.max_memory_allocated() - now) / 2**30}
    out["peak_gib"] = out["resident_gib"] + out["request_gib"]
    return out


def _phase5_int8(path, texts, batch16, text_bf16, audio_bf16, bf16, layers):
    """The same checkpoint served with ``EmbeddingService(int8=True)`` over
    HTTP: ``/embed_text`` 4 × 128 tokens and ``/embed_audio`` 16 × 4.7 s,
    cold and warm. Checks unit-norm 768-d rows and the launches (the
    log-mel kernels and K3 once a forward and block, as in bf16: int8
    replaces only the Dense products; the int8 products = quantized Dense
    of each path × its forwards); reports, beside bf16, the device busy
    time, the Embedder alone, the HTTP request, the device memory and each
    clip's int8-vs-bf16 cosine (random weights: a report, not a gate)."""
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    from speech_transcript_embeddings_torch.ops import quant
    from speech_transcript_embeddings_torch.serve import (
        EmbeddingService, make_handler,
    )
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    service = EmbeddingService(path, device="cuda", int8=True)
    setup_s = time.perf_counter() - t0
    per_path, n_q = _int8_dense_counts(service.embedder.model)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    lat = {}
    # every count starts at zero just before the int8 path runs
    fk.log_mel.launches = 0
    fk.normalize_and_stack.launches = 0
    fa.LAUNCHES.clear()
    quant.int8_matmul.launches = 0
    kernel_calls = KernelCalls()
    try:
        for tag in ("cold", "warm"):
            _, body, lat[f"embed_text_4_{tag}"] = _request(
                url + "/embed_text", {"texts": texts})
            text_embs = _check_embs(body, 4, "int8 /embed_text")
            _, body, lat[f"embed_audio_16x4.7s_{tag}"] = _request(
                url + "/embed_audio", {"audios": [c.tolist() for c in batch16]})
            audio_embs = _check_embs(body, 16, "int8 /embed_audio x16")
        torch.cuda.synchronize()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    launches = {"log_mel": fk.log_mel.launches,
                "log_mel_normalize": fk.normalize_and_stack.launches,
                "flash_rel_fwd_wgmma": fa.LAUNCHES["flash_rel_fwd_wgmma"],
                "flash_rel_fwd": fa.LAUNCHES["flash_rel_fwd"],
                "int8_products": quant.int8_matmul.launches}
    want = {"log_mel": 2, "log_mel_normalize": 2, "flash_rel_fwd_wgmma":
            2 * layers, "flash_rel_fwd": 0,
            "int8_products": 2 * (per_path["text"] + per_path["audio"])}
    if launches != want:
        raise AssertionError(f"int8 serving launched {launches}, want {want}")
    launches.update(kernel_calls.stop("int8 serving"))
    cos_audio = np.sum(audio_embs * audio_bf16, axis=1)
    cos_text = np.sum(text_embs * text_bf16, axis=1)
    res = _breakdown(service.embedder, {"16 clips of 4.7 s": (
        batch16, lat["embed_audio_16x4.7s_warm"])}, "int8")
    res.update(_serving_memory(service.embedder, texts, batch16, before))
    for k, v in lat.items():
        log(5, f"int8 {k}: {v:.1f} ms", request=f"int8 {k}", ms=v)
    log(5, f"int8 serving (W8A8, {n_q} quantized Dense: {per_path}; set-up "
           f"{setup_s:.1f} s): 16 × 4.7 s warm HTTP "
           f"{lat['embed_audio_16x4.7s_warm']:.1f} ms (bf16 "
           f"{bf16['16 clips of 4.7 s']['http_ms']:.1f}), Embedder alone "
           f"{res['16 clips of 4.7 s']['direct_ms']:.1f} ms (bf16 "
           f"{bf16['16 clips of 4.7 s']['direct_ms']:.1f}), device busy "
           f"{res['16 clips of 4.7 s']['device_busy_ms']:.1f} ms (bf16 "
           f"{bf16['16 clips of 4.7 s']['device_busy_ms']:.1f}); weights "
           f"held {res['resident_gib']:.3f} GiB (bf16 "
           f"{bf16['resident_gib']:.3f}), a request's own "
           f"{res['request_gib']:.3f} GiB (bf16 {bf16['request_gib']:.3f}), "
           f"serving peak {res['peak_gib']:.3f} GiB (bf16 "
           f"{bf16['peak_gib']:.3f}); int8 vs bf16 cosine per clip "
           f"min {cos_audio.min():.4f} mean {cos_audio.mean():.4f}, per text "
           f"min {cos_text.min():.4f} (random weights: reported, not gated); "
           f"launches {launches}",
        launches=launches, lat=lat, int8=res, bf16=bf16,
        cos_audio=cos_audio.tolist(), cos_text=cos_text.tolist(),
        quantized=per_path, setup_s=setup_s)
    _release(service)
    return launches


def _release(service):
    """Take a served model off the card: the service's batcher threads
    live on (they keep the service), so the phases after this one would
    otherwise count its weights in their peak memory."""
    import gc

    import torch
    service.embedder.model = None
    gc.collect()
    torch.cuda.empty_cache()


def _device_rows(prof):
    """(device ms, kernel name, calls) of a torch.profiler run, largest
    first (device-side events only: host ops are not counted)."""
    import torch
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if dev > 0:
            rows.append((dev / 1e3, e.key, e.count))
    return sorted(rows, reverse=True)


def _breakdown(embedder, batches, tag):
    """Where a warm audio request's time goes: the Embedder alone (no HTTP,
    no JSON; host clock over a call that ends in a device sync) and one
    forward's device kernels by name (torch.profiler), beside the HTTP
    request's time (``batches``: name → (clips, HTTP ms)). Runs after the
    launch counts were read. → name → the numbers."""
    import torch
    from speech_transcript_embeddings_torch.utils.bench import device_trace
    out = {}
    for name, (clips, http_ms) in batches.items():
        embedder.embed_audios(clips)
        t0 = time.perf_counter()
        for _ in range(3):
            embedder.embed_audios(clips)
        direct = (time.perf_counter() - t0) / 3 * 1e3
        with device_trace() as prof:
            t0 = time.perf_counter()
            embedder.embed_audios(clips)
            wall = (time.perf_counter() - t0) * 1e3
        rows = _device_rows(prof)
        busy = sum(r[0] for r in rows)
        top = "; ".join(f"{k[:48]} x{c} {ms:.1f} ms" for ms, k, c in rows[:6])
        out[name] = dict(http_ms=http_ms, direct_ms=direct,
                         profiled_wall_ms=wall, device_busy_ms=busy,
                         idle_share=1 - busy / wall, kernels=sum(
                             c for _, _, c in rows))
        log(5, f"{tag} {name}: HTTP request {http_ms:.1f} ms, Embedder "
               f"alone {direct:.1f} ms, profiled forward {wall:.1f} ms with "
               f"{out[name]['kernels']} device kernels busy {busy:.1f} ms "
               f"(idle {1 - busy / wall:.0%}); top device time: {top}",
            batch=f"{tag} {name}", **out[name],
            top=[{"kernel": k, "calls": c, "ms": ms} for ms, k, c in rows[:25]])
    return out


ZERO_GRAD_LEAVES = (".key.bias", "pooling.score_out.bias", ".attn_k.bias")


def _train_cfg_small(fused=False):
    from speech_transcript_embeddings_torch.config import (
        AudioEncoderConfig, DataConfig, ExperimentConfig, FreezeConfig,
        FrontendConfig, HeadsConfig, LossConfig, ModelConfig,
        OptimizerConfig, TextEncoderConfig, TrainConfig,
    )
    mc = ModelConfig(
        text=TextEncoderConfig(vocab_size=1000, hidden_size=128, num_layers=2,
                               num_heads=4, intermediate_size=512),
        audio=AudioEncoderConfig(hidden_size=256, num_layers=2, num_heads=4,
                                 intermediate_size=1024,
                                 use_flash_attention=True,
                                 remat_policy="save_hot2"),
        frontend=FrontendConfig(use_pallas=True),
        heads=HeadsConfig(projection_dim=128, use_cross_modal=fused,
                          use_word_alignment=fused),
        dtype="float32", remat=True)
    return ExperimentConfig(
        model=mc,
        freeze=FreezeConfig(mode="partial", text_layers_to_unfreeze=1,
                            audio_layers_to_unfreeze=1),
        loss=LossConfig(kind="global"),
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=0),
        data=DataConfig(dataset="synthetic", batch_size=4, max_text_length=16,
                        audio_buckets=(41200, 82160), max_audio_samples=82160,
                        num_synthetic_samples=32),
        train=TrainConfig(num_epochs=1, accumulation_steps=2, seed=0))


def phase7():
    return _one_step_gpu_vs_cpu(_train_cfg_small(), 7, "small f32 model")


def _small_batches(cfg):
    """The first two train batches of the small models' synthetic data."""
    from speech_transcript_embeddings_torch.data import (
        DataPipeline, SimpleWordTokenizer, SyntheticSource,
    )
    pipe = DataPipeline(cfg.data, SimpleWordTokenizer(vocab_size=1000),
                        seed=0)
    return list(pipe.epoch_batches(SyntheticSource(cfg.data, seed=3),
                                   "train", 1))[:2]


def _small_model(cfg):
    import torch
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    return init_model(cfg.model, torch.Generator().manual_seed(7), train=True)


def _step_run(cfg, model, batches, device, dropout=False):
    """One optimizer step (accumulation 2) of ``model``'s weights on
    ``device`` from two host batches: each micro-batch's gradient before
    any update, ``train_step``'s metrics, the trainable weights after, the
    flash, LayerNorm and depthwise GLU launches (the latter two held to
    ``KernelCalls`` on the card). With ``dropout``, dropout and SpecAugment draw from the run's
    stream, restarted for each pass. Under a process group (phases
    11, 12) the model sits on ``cfg``'s mesh: each rank takes its data
    index's rows of every batch, and the gradients and the loss are
    averaged over the data axis, as the train step averages them; under
    tensor parallel the weights, gradients and results are this rank's
    shards. Checks one update and the frozen split unchanged."""
    import torch
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        DualEncoderModel,
    )
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.ops import make_frontend
    from speech_transcript_embeddings_torch.parallel import collectives
    from speech_transcript_embeddings_torch.parallel import mesh as mesh_lib
    from speech_transcript_embeddings_torch.training import loop, losses
    from speech_transcript_embeddings_torch.training import train_step as ts
    fa.LAUNCHES.clear()       # counts of this path start at zero
    kernel_calls = KernelCalls() if str(device).startswith("cuda") else None
    mesh = mesh_lib.make_mesh(cfg) if collectives.initialized() \
        else mesh_lib.Mesh()
    with torch.device(device):
        replica = DualEncoderModel(cfg.model, torch.float32,
                                   mesh.model_axis())
    replica.load_state_dict(mesh_lib.shard_state(model.state_dict(), mesh))
    state = ts.create_train_state(replica, cfg, total_steps=4, mesh=mesh)
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    frontend = make_frontend(cfg.model.frontend).to(device)
    batches = [mesh_lib.shard_batch(mesh, b) for b in batches]
    group = mesh.data_group
    stream = lambda: loop.dropout_generator(  # noqa: E731
        cfg.train.seed, torch.device(device), mesh.data_index) \
        if dropout else None
    grads, gen = [], stream()      # per micro-batch, before any update
    for b in batches:
        out = state.model.forward_pos_neg(ts.model_batch_from_host(
            frontend, b, device), gen)
        gs = torch.autograd.grad(
            losses.compute_loss(cfg.loss, out, ts.data_axis(), group)[0],
            list(state.trainable.values()), allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(state.trainable.values(), gs)]
        collectives.all_reduce_mean_(gs, group)
        grads.append({k: g.cpu() for k, g in zip(state.trainable, gs)})
    metrics, gen = [], stream()
    for b in batches:
        m = ts.train_step(cfg, state, frontend, b, gen)
        m["loss"] = collectives.mean_over_ranks(m["loss"], group)
        metrics.append({k: float(v) for k, v in m.items()})
    if state.optimizer.count != 1:
        raise AssertionError(f"{state.optimizer.count} updates after two "
                             "micro-steps at accumulation 2")
    for k, p in state.frozen.items():
        if not torch.equal(p, frozen0[k]):
            raise AssertionError(f"frozen {k} changed on {device}")
    launches = {k: n for k, n in fa.LAUNCHES.items() if n}
    if kernel_calls:
        launches.update(kernel_calls.stop(f"one step on {device}"))
    return (metrics, {k: p.detach().cpu() for k, p in
                      state.trainable.items()}, grads, launches)


def _one_step_gpu_vs_cpu(cfg, phase, what):
    """One optimizer step of a small fp32 model with flash attention under
    save_hot2 remat, on the GPU (kernels, TF32 off) and on the CPU (twins),
    from the same weights and batches (``_step_run``), held to
    ``_hold_step``'s tolerances. → the GPU's flash launches."""
    batches = _small_batches(cfg)
    model = _small_model(cfg)
    runs = {device: _step_run(cfg, model, batches, device)
            for device in ("cuda", "cpu")}
    launches = runs["cuda"][3]
    if _flash(launches) != {"flash_rel_fwd", "flash_rel_bwd"}:
        raise AssertionError(f"fp32 training launched {launches}: want only "
                             "the CUDA-core kernels")
    out = _hold_step(cfg, runs["cuda"], runs["cpu"], model, "GPU", "CPU")
    log(phase, f"{what}, accumulation 2, {cfg.loss.kind} loss, save_hot2 "
               f"remat: GPU (kernels) vs CPU (twins) {out['text']}; GPU "
               f"flash launches {launches}",
        launches=launches, **out["data"], gpu=runs["cuda"][0],
        cpu=runs["cpu"][0])
    return launches


def _hold_step(cfg, got, want, model, got_name, want_name):
    """Hold ``_step_run``'s result ``got`` to ``want``, both from
    ``model``'s weights. Tolerances: loss and grad norm rtol 1e-4; each
    micro-batch's gradient, per trainable leaf, within 1e-3 of the leaf's
    largest element (the leaves whose exact gradient is 0, below 1e-4 of
    the largest gradient of the model); each updated leaf all within 2·lr
    and 99.9% of its resolved elements within 1e-5. Adam's first step moves
    a weight by ≈lr·g/|g|, so an element whose gradient is rounding noise
    may flip: the zero-gradient leaves, and the elements whose mean
    gradient over the two micro-batches differs between the runs by more
    than 1% of itself (fp32 does not resolve its direction), are not
    resolved. → {"text": a summary, "data": the numbers}."""
    import torch
    runs = {"got": got, "want": want}
    errs = {}
    for key in ("loss", "grad_norm"):
        for i, (g, c) in enumerate(zip(got[0], want[0])):
            errs[f"{key}_{i}"] = abs(g[key] - c[key]) / abs(c[key])
            if not math.isfinite(g[key]) or errs[f"{key}_{i}"] > 1e-4:
                raise AssertionError(f"micro-step {i} {key}: {got_name} "
                                     f"{g[key]} vs {want_name} {c[key]}")
    grad_err = 0.0
    for g_want, g_got in zip(want[2], got[2]):
        g_max = max(g.abs().max().item() for g in g_want.values())
        for k, c in g_want.items():
            d = (g_got[k] - c).abs().max().item()
            if k.endswith(ZERO_GRAD_LEAVES):
                if max(c.abs().max().item(), g_got[k].abs().max().item()) \
                        > 1e-4 * g_max:
                    raise AssertionError(f"gradient of {k} is not ≈0")
                continue
            c_max = c.abs().max().item()   # 0 for a leaf the loss never reads
            grad_err = max(grad_err, d / c_max if c_max else d)
            if d > 1e-3 * c_max:
                raise AssertionError(f"gradient of {k}: {got_name} vs "
                                     f"{want_name} max diff {d:.2e} of max "
                                     f"{c_max:.2e}")
    mean = {r: {k: sum(g[k] for g in runs[r][2]) / len(runs[r][2])
                for k in runs[r][2][0]} for r in runs}
    lr = cfg.optimizer.learning_rate
    init = dict(model.named_parameters())
    worst, moved, far, noise = 0.0, 0, 0.0, 0
    for k, c in want[1].items():
        g = got[1][k]
        diff = (g - c).abs()
        worst = max(worst, diff.max().item())
        resolved = (mean["got"][k] - mean["want"][k]).abs() <= \
            1e-2 * mean["want"][k].abs()
        if k.endswith(ZERO_GRAD_LEAVES):
            resolved[...] = False   # Adam scales their gradient noise to ±lr
        noise += int((~resolved).sum())
        share = ((diff > 1e-5) & resolved).float().mean().item()
        far = max(far, share)
        if diff.max() > 2 * lr or share > 1e-3:
            raise AssertionError(f"updated {k}: {got_name} vs {want_name} "
                                 f"max diff {diff.max().item():.2e}, share "
                                 f"beyond 1e-5 {share:.1e}")
        moved += not torch.equal(g, init[k].detach())
    if moved < 0.9 * len(want[1]):
        raise AssertionError(f"only {moved} of {len(want[1])} trainable "
                             "leaves moved")
    text = (f"loss/grad-norm rel err {max(errs.values()):.1e} (tol 1e-4), "
            f"gradient max err/max per leaf {grad_err:.1e} (tol 1e-3), "
            f"updated params max diff {worst:.1e} (bound 2·lr = {2 * lr:g}), "
            f"share of resolved elements beyond 1e-5 {far:.1e} (tol 1e-3; "
            f"{noise} elements not resolved), {moved}/{len(want[1])} "
            "trainable leaves moved, frozen unchanged")
    return {"text": text, "data": dict(
        errs=errs, grad_err=grad_err, param_max_diff=worst,
        share_beyond_1e5=far, unresolved=noise, moved=moved)}


FLASH_KERNELS = ("flash_rel_fwd_wgmma", "flash_rel_bwd_wgmma", "flash_rel_fwd",
                 "flash_rel_bwd")


def _flash(launches):
    """The flash kernels that ``launches`` (kernel → count) launched."""
    return {k for k, n in launches.items() if n and k in FLASH_KERNELS}
N_PARAMS = 863_886_658
N_TRAINABLE = 354_846_082
# preset=flagship (fusion and word alignment on), from the JAX abstract
# tree: tests/test_torch_heads.py holds these equal to it
FLAGSHIP_PARAMS = 876_981_059
FLAGSHIP_TRAINABLE = 367_940_483



def phase8():
    """Full-width ``preset=retrieval`` training through the port's CLI, in
    process, on synthetic CV-length clips: one epoch of micro-batches of 16
    at accumulation 4, validation, the checkpoints (no periodic one:
    ``train.save_every=0``), the test and retrieval phases, and the
    final_model checkpoint, which the serving path loads. Checks the
    parameter split, finite losses, the frozen split untouched, the
    trainable split moved, and that every micro-step and every forward ran
    the kernels (K4 24 times a micro-step, K3 24 times a forward with no
    remat replay, the log-mel kernels once per batch, the LayerNorm kernels
    as ``KernelCalls`` counts the calls). Then scores the final_model with ``scripts/torch_int8_quality_eval.py`` (``_int8_eval``,
    a path of its own) while the run's directory still holds it. → (the
    training path's launches, warm clips/s, the int8 eval's launches)."""
    import numpy as np
    import torch
    from speech_transcript_embeddings_torch import train as cli
    from speech_transcript_embeddings_torch.inference.embed import Embedder
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    from speech_transcript_embeddings_torch.training import train_step as ts
    build_dir = os.path.join(ROOT, REPO, "_build")
    os.makedirs(build_dir, exist_ok=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        argv = ["preset=retrieval", "device=cuda",
                "data.synthetic_length_profile=cv", "train.num_epochs=1",
                "optimizer.warmup_steps=1", "train.save_every=0",
                f"train.output_dir={tmp}/run"]
        # every count starts at zero just before the main path runs
        fk.log_mel.launches = 0
        fk.log_mel.launches_by_frames.clear()
        fk.normalize_and_stack.launches = 0
        fa.LAUNCHES.clear()
        kernel_calls = KernelCalls()
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"log_mel": fk.log_mel.launches,
                    "log_mel_normalize": fk.normalize_and_stack.launches,
                    **{name: fa.LAUNCHES[name] for name in FLASH_KERNELS}}
        kernel_launched = kernel_calls.stop("preset=retrieval training")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        cfg, state = res["cfg"], res["state"]
        ep = res["epochs"][0]
        micro, n_eval = ep["train_batches"], ep["eval_batches"]
        layers = cfg.model.audio.num_layers
        if cfg.model.audio.remat_policy != "save_hot2" or not cfg.model.remat:
            raise AssertionError(f"preset=retrieval remat: {cfg.model.remat} "
                                 f"{cfg.model.audio.remat_policy}")
        forwards = micro + n_eval + res["test_batches"] + \
            res["retrieval_batches"]
        want = {"flash_rel_bwd_wgmma": layers * micro,
                "flash_rel_fwd_wgmma": layers * forwards,
                "flash_rel_fwd": 0, "flash_rel_bwd": 0,
                "log_mel": forwards, "log_mel_normalize": forwards}
        if launches != want:
            raise AssertionError(
                f"launches {launches} != {want} for {micro} micro-steps, "
                f"{n_eval} eval, {res['test_batches']} test and "
                f"{res['retrieval_batches']} retrieval batches")
        launches.update(kernel_launched)
        if (res["n_params"], res["n_trainable"]) != (N_PARAMS, N_TRAINABLE):
            raise AssertionError(f"{res['n_params']} params, "
                                 f"{res['n_trainable']} trainable")
        losses = [s["loss"] for s in res["step_log"]]
        if len(losses) != micro or not np.isfinite(losses).all():
            raise AssertionError(f"micro-step losses {losses}")
        if not np.isfinite(ep["val_metrics"]["loss"]):
            raise AssertionError(f"validation {ep['val_metrics']}")
        updates = state.optimizer.count
        warm = ep["warm_clips_per_sec"]
        samples = sorted({s["samples"] for s in res["step_log"]})

        # the same seeded init again: the frozen split must be bit-identical,
        # the trainable split must have moved (update 1 has lr 0 under
        # warmup, update 2 does not)
        fresh = init_model(cfg.model, torch.Generator("cuda").manual_seed(
            cfg.train.seed), "cuda", train=True)
        fresh = ts.create_train_state(fresh, cfg, total_steps=1)
        for k, p in state.frozen.items():
            if not torch.equal(p, fresh.frozen[k]):
                raise AssertionError(f"frozen {k} changed")
        moved = [k for k, p in state.trainable.items()
                 if not torch.equal(p, fresh.trainable[k])]
        still = sorted(set(state.trainable) - set(moved))
        del fresh
        torch.cuda.empty_cache()
        if updates < 2 or len(moved) < 0.9 * len(state.trainable):
            raise AssertionError(f"{len(moved)} of {len(state.trainable)} "
                                 f"trainable leaves moved in {updates} "
                                 f"updates; unchanged: {still[:10]}")
        log(8, f"preset=retrieval through the CLI: {res['n_params']:,} params, "
               f"{res['n_trainable']:,} trainable; {micro} micro-steps of "
               f"{cfg.data.batch_size} at buckets {samples} ({updates} "
               f"updates), {n_eval} eval batches; losses {losses[0]:.4f} → "
               f"{losses[-1]:.4f}, val loss {ep['val_metrics']['loss']:.4f}; "
               f"frozen bit-identical, {len(moved)}/{len(state.trainable)} "
               f"trainable leaves moved (unchanged: {still}); launches "
               f"{launches}",
            n_params=res["n_params"], n_trainable=res["n_trainable"],
            micro_steps=micro, eval_batches=n_eval, updates=updates,
            losses=losses, val=ep["val_metrics"], moved=len(moved),
            unchanged=still, launches=launches, samples=samples)
        log(8, f"train {ep['clips_per_sec']:.2f} clips/s over the epoch "
               f"(host clock), {warm:.2f} clips/s warm (from the end of the "
               f"first micro-step to the last, CUDA events); epoch "
               f"{ep['train_seconds']:.1f} s, whole CLI run {wall:.1f} s; "
               f"peak device memory {peak_gib:.2f} GiB",
            clips_per_s=ep["clips_per_sec"], warm_clips_per_s=warm,
            train_seconds=ep["train_seconds"], cli_seconds=wall,
            peak_gib=peak_gib)

        _profile_micro_step(8, res)
        del state, res
        torch.cuda.empty_cache()

        emb = Embedder.from_checkpoint(os.path.join(tmp, "run", "final_model"),
                                       device="cuda")
        e = emb.embed_audios([_clip(6.0, 31)])
        norm = float(np.linalg.norm(e[0]))
        if e.shape != (1, 768) or not np.isfinite(e).all() or \
                abs(norm - 1) > 1e-3:
            raise AssertionError(f"final_model embedding {e.shape} norm {norm}")
        log(8, f"final_model served by Embedder: one 6 s clip → unit vector "
               f"(norm {norm:.6f})", norm=norm)
        del emb
        torch.cuda.empty_cache()
        int8_eval = _int8_eval(os.path.join(tmp, "run", "final_model"))
    return launches, warm, int8_eval


# synthetic clips of the flagship phase: the fewest whose train split still
# fills a batch of 16 at three buckets (41,200 / 82,160 / 164,080: 8
# micro-steps, 2 updates at accumulation 4)
FLAGSHIP_CLIPS = 160
PREEMPT_AT = 3       # inside the first accumulation window


def phase9():
    """The reference-parity ``preset=flagship`` (cross-modal fusion and
    word alignment, pairwise loss, accumulation 4) at full width through
    the port's CLI, on synthetic CV-length clips: a run preempted after
    ``PREEMPT_AT`` micro-steps by ``train.fault_inject_preempt_at``, then
    the rerun that resumes inside the epoch and finishes it, with
    validation, the checkpoints, the test phase over both best checkpoints
    and the retrieval phase. Checks the parameter split, the resume, finite
    losses, the frozen split untouched, the trainable split moved, the
    artifacts in the JAX loop's schema and the kernels' launches over both
    runs (K4 24 times a micro-step, K3 24 times a forward, the log-mel
    kernels once a batch); then ``infer batch`` on the best checkpoint,
    whose fused and projection-path scores must differ; then one optimizer
    step of a small fp32 fused model, GPU against CPU (phase 7's
    tolerances)."""
    import csv

    import numpy as np
    import torch
    from speech_transcript_embeddings_torch import checkpoints as ckpt
    from speech_transcript_embeddings_torch import infer
    from speech_transcript_embeddings_torch import train as cli
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    from speech_transcript_embeddings_torch.training import train_step as ts
    build_dir = os.path.join(ROOT, REPO, "_build")
    os.makedirs(build_dir, exist_ok=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = os.path.join(tmp, "run")
        argv = ["preset=flagship", "device=cuda",
                "data.synthetic_length_profile=cv", "train.num_epochs=1",
                "train.save_every=0", "optimizer.warmup_steps=0",
                f"data.num_synthetic_samples={FLAGSHIP_CLIPS}",
                f"train.output_dir={out}"]
        # every count starts at zero just before the main path runs
        fk.log_mel.launches = 0
        fk.log_mel.launches_by_frames.clear()
        fk.normalize_and_stack.launches = 0
        fa.LAUNCHES.clear()
        kernel_calls = KernelCalls()
        t0 = time.perf_counter()
        first = cli.main(argv + [f"train.fault_inject_preempt_at={PREEMPT_AT}"])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        if first.get("preempted") != {"epoch": 1, "batches_done": PREEMPT_AT}:
            raise AssertionError(f"preemption: {first.get('preempted')}")
        meta = ckpt.load_metadata(os.path.join(out, "latest"))
        saved = torch.load(os.path.join(out, "latest", "optimizer.pt"),
                           map_location="cpu", weights_only=True)
        if meta["epoch"] != 0 or meta["metrics"]["mid_epoch"] != {
                "epoch": 1, "batches_done": PREEMPT_AT} or \
                saved["optimizer"]["mini_step"] != PREEMPT_AT or \
                saved["step"] != PREEMPT_AT:
            raise AssertionError(f"mid-epoch latest: {meta['metrics']}, "
                                 f"mini_step {saved['optimizer']['mini_step']}")
        del saved
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        launches = {"log_mel": fk.log_mel.launches,
                    "log_mel_normalize": fk.normalize_and_stack.launches,
                    **{name: fa.LAUNCHES[name] for name in FLASH_KERNELS}}
        kernel_launched = kernel_calls.stop("preset=flagship training")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        cfg, state = res["cfg"], res["state"]
        ep = res["epochs"][0]
        log_text = open(os.path.join(out, "training.log")).read()
        if "preempted" in res or ep["skipped_batches"] != PREEMPT_AT or \
                "Resumed mid-epoch" not in log_text or \
                f"skipping the first {PREEMPT_AT}" not in log_text:
            raise AssertionError(f"no mid-epoch resume: {ep}")
        micro = PREEMPT_AT + ep["train_batches"]
        forwards = micro + ep["eval_batches"] + res["test_batches"] + \
            res["retrieval_batches"]
        layers = cfg.model.audio.num_layers
        want = {"flash_rel_bwd_wgmma": layers * micro,
                "flash_rel_fwd_wgmma": layers * forwards,
                "flash_rel_fwd": 0, "flash_rel_bwd": 0,
                "log_mel": forwards, "log_mel_normalize": forwards}
        if launches != want:
            raise AssertionError(
                f"launches {launches} != {want} for {micro} micro-steps, "
                f"{ep['eval_batches']} eval, {res['test_batches']} test and "
                f"{res['retrieval_batches']} retrieval batches")
        launches.update(kernel_launched)
        if (res["n_params"], res["n_trainable"]) != (FLAGSHIP_PARAMS,
                                                     FLAGSHIP_TRAINABLE):
            raise AssertionError(f"{res['n_params']} params, "
                                 f"{res['n_trainable']} trainable")
        heads = cfg.model.heads
        if not (heads.use_cross_modal and heads.use_word_alignment) or \
                cfg.loss.kind != "pairwise":
            raise AssertionError(f"preset=flagship: {heads} {cfg.loss}")
        losses = [s["loss"] for s in first["step_log"] + res["step_log"]]
        if len(losses) != micro or not np.isfinite(losses).all():
            raise AssertionError(f"micro-step losses {losses}")
        # the artifacts of the JAX loop, in its schema
        with open(os.path.join(out, "test_metrics.json")) as f:
            tm = json.load(f)
        keys = {"loss", "avg_similarity", "median_similarity",
                "std_similarity", "clean_similarity", "corrupt_similarity",
                "similarity_gap"}
        if not tm or not set(tm) <= {"best_loss_model", "best_gap_model"} \
                or any(set(b) != keys or not np.isfinite(list(b.values())).all()
                       for b in tm.values()):
            raise AssertionError(f"test_metrics.json {tm}")
        with open(os.path.join(out, "retrieval_metrics.json")) as f:
            ret = json.load(f)
        best = next(iter(ret))
        if not {"recall@1", "recall@5", "recall@10", "mean_rank", "mrr"} <= \
                set(ret[best]):
            raise AssertionError(f"retrieval_metrics.json {ret}")
        for name in ("latest", "final_model", "best_model_loss", best):
            if not ckpt.checkpoint_exists(os.path.join(out, name)):
                raise AssertionError(f"no {name} checkpoint")
        # the plots need matplotlib, which both packages treat as optional
        plots = ("similarity_dist_epoch_1.png", "clean_corrupt_progress.png")
        for name in ("config.json",) + (
                plots if importlib.util.find_spec("matplotlib") else ()):
            if not os.path.exists(os.path.join(out, name)):
                raise AssertionError(f"no {name}")
        saves = first["saves"] + res["saves"]
        updates = state.optimizer.count
        fresh = init_model(cfg.model, torch.Generator("cuda").manual_seed(
            cfg.train.seed), "cuda", train=True)
        fresh = ts.create_train_state(fresh, cfg, total_steps=1)
        for k, p in state.frozen.items():
            if not torch.equal(p, fresh.frozen[k]):
                raise AssertionError(f"frozen {k} changed")
        moved = [k for k, p in state.trainable.items()
                 if not torch.equal(p, fresh.trainable[k])]
        still = sorted(set(state.trainable) - set(moved))
        del fresh
        torch.cuda.empty_cache()
        if updates < 1 or len(moved) < 0.9 * len(state.trainable):
            raise AssertionError(f"{len(moved)} of {len(state.trainable)} "
                                 f"trainable leaves moved in {updates} "
                                 f"updates; unchanged: {still[:10]}")
        samples = sorted({s["samples"] for s in res["step_log"]})
        log(9, f"preset=flagship through the CLI: {res['n_params']:,} params, "
               f"{res['n_trainable']:,} trainable; preempted after "
               f"{PREEMPT_AT} micro-steps ({first_s:.1f} s), resumed "
               f"mid-epoch and finished ({second_s:.1f} s): {micro} "
               f"micro-steps of {cfg.data.batch_size} at buckets {samples} "
               f"({updates} updates), {ep['eval_batches']} eval, "
               f"{res['test_batches']} test and {res['retrieval_batches']} "
               f"retrieval batches; losses {losses[0]:.4f} → "
               f"{losses[-1]:.4f}; test {sorted(tm)}, retrieval ({best}) "
               f"{ret[best]}; frozen bit-identical, {len(moved)}/"
               f"{len(state.trainable)} trainable leaves moved (unchanged: "
               f"{still}); launches {launches}",
            n_params=res["n_params"], n_trainable=res["n_trainable"],
            micro_steps=micro, updates=updates, losses=losses,
            val=ep["val_metrics"], test=tm, retrieval=ret, moved=len(moved),
            unchanged=still, launches=launches, samples=samples)
        for sv in saves:
            log(9, f"checkpoint {sv['name']}: {sv['bytes'] / 1e9:.3f} GB "
                   f"in {sv['seconds']:.2f} s "
                   f"({sv['bytes'] / 1e9 / max(sv['seconds'], 1e-9):.2f} "
                   f"GB/s)", **sv)
        log(9, f"train {ep['clips_per_sec']:.2f} clips/s over the resumed "
               f"part of the epoch (host clock, {ep['train_batches']} "
               f"micro-steps), {ep['warm_clips_per_sec']:.2f} clips/s warm "
               f"(CUDA events); peak device memory {peak_gib:.2f} GiB",
            clips_per_s=ep["clips_per_sec"],
            warm_clips_per_s=ep["warm_clips_per_sec"],
            first_run_s=first_s, second_run_s=second_s, peak_gib=peak_gib)
        step = _profile_micro_step(9, res)
        del state, res, first
        torch.cuda.empty_cache()

        # the inference CLI scores the best checkpoint
        t0 = time.perf_counter()
        scored = infer.main(["batch", "--checkpoint", os.path.join(out, best),
                             "--num-samples", "32", "--device", "cuda",
                             "--results-dir", os.path.join(tmp, "cv")])
        infer_s = time.perf_counter() - t0
        with open(scored["csv"], newline="") as f:
            rows = list(csv.reader(f))
        sims, proj = scored["similarities"], scored["projection_similarities"]
        gap = float(np.abs(sims - proj).max())
        if rows[0] != ["sample_id", "text", "similarity",
                       "projection_similarity"] or len(rows) != 33 or \
                not np.isfinite(sims).all() or gap < 1e-3:
            raise AssertionError(f"infer batch: {rows[:2]}, {len(rows)} rows, "
                                 f"fused vs projection max diff {gap}")
        log(9, f"infer batch on {best}: 32 rows in {infer_s:.1f} s, fused "
               f"vs projection-path similarity max diff {gap:.3f} (the "
               f"fusion ran), Recall@1 {scored['retrieval']['recall@1']:.3f}",
            infer_s=infer_s, fused_vs_projection=gap,
            retrieval=scored["retrieval"])
        torch.cuda.empty_cache()
    fp32 = _one_step_gpu_vs_cpu(_train_cfg_small(fused=True), 9,
                                "small f32 fused model")
    return launches, step, fp32


def reference_table():
    """The reference trainer's checkpoint at the flagship geometry, key by
    key: (reference key, shape, the port's parameter or None, how the port
    holds it: None as is, "squeeze" the Conv1d's last axis, or (a, b) the
    rows a:b of ``nn.MultiheadAttention``'s in_proj), and whether it is a
    LayerNorm weight. XLM-R 12 × 768 (vocab 250,002, 514 positions, its
    pooler, which the port does not use), w2v-bert 24 × 1024 (160
    features, 4096 FFN, kernel 31, 73 distances, the SpecAugment vector),
    projection 768 with attentive pooling, fusion and word alignment."""
    rows = []

    def lin(ref, port, out, inp):
        rows.append((f"{ref}.weight", (out, inp), port and f"{port}.weight",
                     None, False))
        rows.append((f"{ref}.bias", (out,), port and f"{port}.bias", None,
                     False))

    def ln(ref, port, d):
        rows.append((f"{ref}.weight", (d,), f"{port}.weight", None, True))
        rows.append((f"{ref}.bias", (d,), f"{port}.bias", None, False))

    t, te = 768, "text_encoder"
    for name, n in (("word_embeddings", 250002), ("position_embeddings", 514),
                    ("token_type_embeddings", 1)):
        rows.append((f"{te}.embeddings.{name}.weight", (n, t),
                     f"{te}.embeddings.{name}.weight", None, False))
    ln(f"{te}.embeddings.LayerNorm", f"{te}.embeddings.norm", t)
    for i in range(12):
        r, p = f"{te}.encoder.layer.{i}", f"{te}.layer_{i}"
        for src, dst in (("query", "query"), ("key", "key"),
                         ("value", "value")):
            lin(f"{r}.attention.self.{src}", f"{p}.attention.{dst}", t, t)
        lin(f"{r}.attention.output.dense", f"{p}.attention.out", t, t)
        ln(f"{r}.attention.output.LayerNorm", f"{p}.attention.norm", t)
        lin(f"{r}.intermediate.dense", f"{p}.intermediate", 3072, t)
        lin(f"{r}.output.dense", f"{p}.output", t, 3072)
        ln(f"{r}.output.LayerNorm", f"{p}.norm", t)
    lin(f"{te}.pooler.dense", None, t, t)
    a, ae = 1024, "audio_encoder"
    ln(f"{ae}.feature_projection.layer_norm", f"{ae}.feature_norm", 160)
    lin(f"{ae}.feature_projection.projection", f"{ae}.feature_projection",
        a, 160)
    rows.append((f"{ae}.masked_spec_embed", (a,), f"{ae}.masked_spec_embed",
                 None, False))
    for i in range(24):
        r, p = f"{ae}.encoder.layers.{i}", f"{ae}.layer_{i}"
        for k in ("ffn1", "ffn2"):
            ln(f"{r}.{k}_layer_norm", f"{p}.{k}_norm", a)
            lin(f"{r}.{k}.intermediate_dense", f"{p}.{k}.intermediate",
                4096, a)
            lin(f"{r}.{k}.output_dense", f"{p}.{k}.output", a, 4096)
        ln(f"{r}.self_attn_layer_norm", f"{p}.attention_norm", a)
        for src, dst in (("q", "query"), ("k", "key"), ("v", "value"),
                         ("out", "out")):
            lin(f"{r}.self_attn.linear_{src}", f"{p}.attention.{dst}", a, a)
        rows.append((f"{r}.self_attn.distance_embedding.weight", (73, 64),
                     f"{p}.attention.distance_embedding", None, False))
        c = f"{r}.conv_module"
        ln(f"{c}.layer_norm", f"{p}.conv.norm", a)
        rows.append((f"{c}.pointwise_conv1.weight", (2 * a, a, 1),
                     f"{p}.conv.pointwise1.weight", "squeeze", False))
        rows.append((f"{c}.depthwise_conv.weight", (a, 1, 31),
                     f"{p}.conv.depthwise_kernel", None, False))
        ln(f"{c}.depthwise_layer_norm", f"{p}.conv.depthwise_norm", a)
        rows.append((f"{c}.pointwise_conv2.weight", (a, a, 1),
                     f"{p}.conv.pointwise2.weight", "squeeze", False))
        ln(f"{r}.final_layer_norm", f"{p}.final_norm", a)
    d = 768
    for m, h in (("text", t), ("audio", a)):
        lin(f"{m}_projection.projection.0", f"{m}_projection.dense_in",
            2 * d, h)
        lin(f"{m}_projection.projection.3", f"{m}_projection.dense_out",
            d, 2 * d)
        ln(f"{m}_projection.projection.4", f"{m}_projection.norm", d)
        lin(f"{m}_pooling.attention.0", f"{m}_pooling.score_in", h // 2, h)
        lin(f"{m}_pooling.attention.2", f"{m}_pooling.score_out", 1, h // 2)
        lin(f"{m}_seq_to_projection", f"{m}_seq_to_projection", d, h)
        lin(f"{m}_fusion.0", f"{m}_fusion", d, 2 * d)
        ln(f"{m}_fusion.1", f"{m}_fusion_norm", d)
    for x in ("text_to_audio_attention", "audio_to_text_attention"):
        for src, dst in (("query", "query"), ("key", "key"),
                         ("value", "value"), ("out_proj", "out")):
            lin(f"{x}.{src}", f"{x}.{dst}", d, d)
    w = "word_level_alignment"
    lin(f"{w}.text_projection", f"{w}.text_proj", d, t)
    lin(f"{w}.audio_projection", f"{w}.audio_proj", d, a)
    for i, name in enumerate(("attn_q", "attn_k", "attn_v")):
        rows.append((f"{w}.alignment_attention.in_proj_weight", (3 * d, d),
                     f"{w}.{name}.weight", (i * d, (i + 1) * d), False))
        rows.append((f"{w}.alignment_attention.in_proj_bias", (3 * d,),
                     f"{w}.{name}.bias", (i * d, (i + 1) * d), False))
    lin(f"{w}.alignment_attention.out_proj", f"{w}.attn_out", d, d)
    lin(f"{w}.output_projection", f"{w}.output_proj", d, d)
    ln(f"{w}.layer_norm", f"{w}.norm", d)
    lin(f"{w}.alignment_confidence.0", f"{w}.confidence_in", d // 2, d)
    lin(f"{w}.alignment_confidence.2", f"{w}.confidence_out", 1, d // 2)
    return rows


def _as_port(tensor, how):
    if how == "squeeze":
        return tensor[:, :, 0]
    if how is not None:
        return tensor[how[0]:how[1]]
    return tensor


def phase10():
    """Conversion at the flagship geometry, from the reference's format:
    a ``torch.save`` of ``{"model_state_dict", "temperature",
    "use_cross_modal", "use_attentive_pooling", "use_word_alignment",
    "projection_dim"}`` with the reference's key names (``reference_table``),
    values from a numpy seed (0.02 · N(0, 1); LayerNorm weights 1 + that),
    877M fp32 values. ``convert_checkpoint --from-torch`` ingests it in a
    subprocess; the sniffed geometry must be the flagship's and every
    source tensor equal to its port parameter after the table's
    permutation. Then ``infer batch`` scores 32 synthetic clips from the
    converted checkpoint in bf16 and with ``--int8`` (unit-norm, finite),
    and ``preset=flagship train.init_checkpoint=`` it trains two
    micro-steps (accumulation 2: one update): finite losses, the frozen
    split equal to the checkpoint's, the trainable split moved, K4
    launched. The ingested config, as JAX's, leaves flash attention and
    the log-mel kernels off (their config defaults), so ``infer`` runs the
    plain attention and frontend; the flagship preset runs the kernels."""
    import re

    import numpy as np
    import torch
    from speech_transcript_embeddings_torch import checkpoints as ckpt
    from speech_transcript_embeddings_torch import infer
    from speech_transcript_embeddings_torch import train as cli
    from speech_transcript_embeddings_torch.config import (
        ExperimentConfig, flagship_model_config,
    )
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    from speech_transcript_embeddings_torch.ops import quant
    build_dir = os.path.join(ROOT, REPO, "_build")
    os.makedirs(build_dir, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        src, dst = os.path.join(tmp, "best_model_gap.pt"), \
            os.path.join(tmp, "converted")
        rows = reference_table()
        t0 = time.perf_counter()
        rng = np.random.default_rng(10)
        sd = {}
        for key, shape, _, _, is_norm in rows:
            if key not in sd:
                v = rng.standard_normal(shape, dtype=np.float32) * 0.02
                sd[key] = torch.from_numpy(v + 1.0 if is_norm else v)
        n_src = sum(v.numel() for v in sd.values())
        n_port = sum(int(np.prod(shape)) // (3 if isinstance(how, tuple)
                                             else 1)
                     for _, shape, port, how, _ in rows if port)
        if n_port != FLAGSHIP_PARAMS:
            raise AssertionError(f"the table maps {n_port} values, the "
                                 f"flagship has {FLAGSHIP_PARAMS}")
        out["draw_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.save({"model_state_dict": sd, "epoch": 7, "temperature": 0.07,
                    "use_cross_modal": True, "use_attentive_pooling": True,
                    "use_word_alignment": True, "projection_dim": 768}, src)
        out["write_s"] = max(time.perf_counter() - t0, 1e-3)
        out["src_gb"] = os.path.getsize(src) / 1e9

        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", f"{REPO}.convert_checkpoint",
             "--from-torch", src, "--output", dst], cwd=ROOT,
            capture_output=True, text=True, timeout=900)
        out["convert_process_s"] = time.perf_counter() - t0
        if run.returncode:
            raise AssertionError(f"convert_checkpoint failed: {run.stderr}")
        said = re.search(r"Saved ([\d,]+)-param checkpoint .*\(([\d.]+) GB; "
                         r"read \+ convert ([\d.]+) s, write ([\d.]+) s\)",
                         run.stdout)
        n_conv = int(said.group(1).replace(",", ""))
        out.update(dst_gb=float(said.group(2)),
                   ingest_s=max(float(said.group(3)), 1e-3),
                   save_s=max(float(said.group(4)), 1e-3))
        # the sniffed geometry is the flagship's
        got = ExperimentConfig.from_json(json.dumps(
            ckpt.load_metadata(dst)["config"])).model
        want = flagship_model_config()
        geometry = lambda m: (  # noqa: E731
            [getattr(m.text, f) for f in (
                "vocab_size", "hidden_size", "num_layers", "num_heads",
                "intermediate_size", "max_position_embeddings",
                "type_vocab_size")],
            [getattr(m.audio, f) for f in (
                "feature_dim", "hidden_size", "num_layers", "num_heads",
                "intermediate_size", "conv_kernel_size", "left_max_rel_pos",
                "right_max_rel_pos", "apply_spec_augment")],
            [m.heads.projection_dim, m.heads.projection_hidden_dim
             or 2 * m.heads.projection_dim, m.heads.use_cross_modal,
             m.heads.use_attentive_pooling, m.heads.use_word_alignment],
            m.frontend.num_mel_bins * m.frontend.stride)
        if geometry(got) != geometry(want) or n_conv != FLAGSHIP_PARAMS:
            raise AssertionError(f"sniffed {geometry(got)} ({n_conv} params) "
                                 f"!= flagship {geometry(want)}")
        # every source tensor, exactly, where the table says
        t0 = time.perf_counter()
        stored = ckpt.load_stored_state(dst)
        out["load_s"] = time.perf_counter() - t0
        mapped = {port for _, _, port, _, _ in rows if port}
        if set(stored) != mapped:
            raise AssertionError(f"converted keys differ from the table: "
                                 f"{sorted(set(stored) ^ mapped)[:8]}")
        t0 = time.perf_counter()
        for key, _, port, how, _ in rows:
            if port and not torch.equal(stored[port], _as_port(sd[key], how)):
                raise AssertionError(f"{port} is not {key}")
        out["compare_s"] = time.perf_counter() - t0
        del sd, stored
        log(10, f"reference checkpoint at the flagship geometry: "
                f"{len({r[0] for r in rows})} tensors, {n_src:,} values "
                f"({FLAGSHIP_PARAMS:,} for the port, the rest the unused "
                f"pooler), {out['src_gb']:.3f} GB drawn in "
                f"{out['draw_s']:.1f} s and written in {out['write_s']:.1f} s "
                f"({out['src_gb'] / out['write_s']:.2f} GB/s); "
                f"convert_checkpoint --from-torch in "
                f"{out['convert_process_s']:.1f} s (its own: read + convert "
                f"{out['ingest_s']:.1f} s = "
                f"{out['src_gb'] / out['ingest_s']:.2f} GB/s, write "
                f"{out['dst_gb']:.3f} GB in {out['save_s']:.1f} s = "
                f"{out['dst_gb'] / out['save_s']:.2f} GB/s); sniffed geometry "
                f"= flagship; all {len(mapped)} port tensors equal their "
                f"source exactly (checked in {out['compare_s']:.1f} s)",
            **out, tensors=len(mapped))

        scored = {}
        for tag, extra in (("bf16", []), ("int8", ["--int8"])):
            fk.log_mel.launches = 0
            fa.LAUNCHES.clear()
            quant.int8_matmul.launches = 0
            kernel_calls = KernelCalls()
            t0 = time.perf_counter()
            res = infer.main(["batch", "--checkpoint", dst, "--num-samples",
                              "32", "--device", "cuda", "--dataset",
                              "synthetic", "--results-dir",
                              os.path.join(tmp, f"cv_{tag}")] + extra)
            secs = time.perf_counter() - t0
            counts = {"log_mel": fk.log_mel.launches,
                      "int8_products": quant.int8_matmul.launches,
                      **{k: v for k, v in fa.LAUNCHES.items() if v},
                      **kernel_calls.stop(f"infer {tag}")}
            embs = np.concatenate([res["text_embeddings"],
                                   res["audio_embeddings"]])
            norms = np.linalg.norm(embs, axis=1)
            if len(res["similarities"]) != 32 or not np.isfinite(embs).all() \
                    or np.abs(norms - 1).max() > 1e-3 or \
                    (tag == "int8") != (counts["int8_products"] > 0):
                raise AssertionError(f"infer {tag} on the converted "
                                     f"checkpoint: norms {norms}, {counts}")
            scored[tag] = res
            out[f"infer_{tag}_s"] = secs
            log(10, f"infer batch --checkpoint converted {' '.join(extra)}: "
                    f"32 clips in {secs:.1f} s (load included), unit-norm "
                    f"finite embeddings, launches {counts}",
                tag=tag, seconds=secs, launches=counts,
                retrieval=res["retrieval"])
        cos = np.sum(scored["int8"]["audio_embeddings"]
                     * scored["bf16"]["audio_embeddings"], axis=1)
        out["int8_vs_bf16_audio_cos_mean"] = float(cos.mean())

        # two micro-steps of preset=flagship from the converted checkpoint
        argv = ["preset=flagship", "device=cuda", "train.num_epochs=1",
                "optimizer.warmup_steps=0", "train.accumulation_steps=2",
                "data.num_synthetic_samples=64",
                "train.fault_inject_preempt_at=2",
                f"train.init_checkpoint={dst}",
                f"train.output_dir={tmp}/run"]
        # every count starts at zero just before this path runs
        fk.log_mel.launches = 0
        fk.log_mel.launches_by_frames.clear()
        fk.normalize_and_stack.launches = 0
        fa.LAUNCHES.clear()
        kernel_calls = KernelCalls()
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        launches = {"log_mel": fk.log_mel.launches,
                    "log_mel_normalize": fk.normalize_and_stack.launches,
                    **{name: fa.LAUNCHES[name] for name in FLASH_KERNELS}}
        kernel_launched = kernel_calls.stop("training from the converted checkpoint")
        losses = [st["loss"] for st in res["step_log"]]
        layers = flagship_model_config().audio.num_layers
        want = {"log_mel": 2, "log_mel_normalize": 2,
                "flash_rel_fwd_wgmma": 2 * layers,
                "flash_rel_bwd_wgmma": 2 * layers,
                "flash_rel_fwd": 0, "flash_rel_bwd": 0}
        if res.get("preempted", {}).get("batches_done") != 2 or \
                len(losses) != 2 or not np.isfinite(losses).all() or \
                launches != want:
            raise AssertionError(f"two micro-steps from the converted "
                                 f"checkpoint: {res.get('preempted')}, "
                                 f"losses {losses}, launches {launches}")
        launches.update(kernel_launched)
        start = ckpt.load_stored_state(dst)
        after = ckpt.load_stored_state(os.path.join(tmp, "run", "latest"))
        frozen = [k for k, v in after.items() if v.dtype == torch.bfloat16]
        trainable = [k for k, v in after.items() if v.dtype == torch.float32]
        moved = [k for k in trainable if not torch.equal(after[k], start[k])]
        changed = [k for k in frozen
                   if not torch.equal(after[k], start[k].to(torch.bfloat16))]
        n_train = sum(after[k].numel() for k in trainable)
        if changed or n_train != FLAGSHIP_TRAINABLE or \
                len(moved) < 0.9 * len(trainable):
            raise AssertionError(f"frozen changed {changed[:5]}; "
                                 f"{n_train} trainable values, "
                                 f"{len(moved)}/{len(trainable)} moved")
        del start, after
        log(10, f"preset=flagship train.init_checkpoint=converted: 2 "
                f"micro-steps (one update) in {out['train_s']:.1f} s (init, "
                f"load, steps, the 'latest' save), losses "
                f"{[round(x, 4) for x in losses]}; frozen split equal to the "
                f"checkpoint's, {len(moved)}/{len(trainable)} trainable "
                f"leaves moved ({n_train:,} values); launches {launches}; "
                f"int8 vs bf16 audio cosine on the converted weights, mean "
                f"{out['int8_vs_bf16_audio_cos_mean']:.4f}",
            **out, losses=losses, launches=launches, moved=len(moved),
            trainable=len(trainable))
    torch.cuda.empty_cache()
    return launches


# phase 11: the data-parallel path. The full-width runs take phase 9's
# synthetic clips (8 micro-steps of 16 at three buckets); the preemption
# flag is raised after micro-step 2 and agreed through any_rank after that
# same batch
DP_CLIPS = 160
DP_FLAG_AT = 2
DP_SMALL_BATCH = 8       # (a): the global batch, 4 rows a rank
DP_STEPS = 4             # (c): micro-steps, at accumulation 2
# the depth of preset=retrieval in phases 11, 12, 14 and 15: the full
# width, each encoder's frozen bottom cut to one block under its five
# unfrozen ones (phases 8-10 run the full 24 + 12 blocks); these paths'
# gloo collectives and separate processes are what holds the smoke's time
# on a slow host
CUT_DEPTH = ("model.audio.num_layers=6", "model.audio.scan_bottom=1",
             "model.text.num_layers=6", "model.text.scan_bottom=1")
DP_DROPOUT_OFF = ("model.text.hidden_dropout=0.0",
                  "model.text.attention_dropout=0.0",
                  "model.audio.conv_dropout=0.0",
                  "model.audio.apply_spec_augment=false",
                  "model.heads.dropout=0.0")


def _dp_argv(out):
    """``preset=retrieval`` at B = 16 (global) on CV lengths, dropout and
    SpecAugment off, no warmup."""
    return ["preset=retrieval", "data.batch_size=16",
            "data.synthetic_length_profile=cv",
            "train.num_epochs=1", "train.save_every=0",
            "optimizer.warmup_steps=0",
            f"data.num_synthetic_samples={DP_CLIPS}",
            f"train.output_dir={out}", *DP_DROPOUT_OFF, *CUT_DEPTH]


def _torchrun(nproc, part, out, timeout, phase=11):
    """Run ``chip_smoke.py --dp-worker PART OUT`` as ``nproc`` ranks under
    torchrun (a free local port), in a session of its own that is killed
    whole if it outlives ``timeout``; raise unless every rank exited 0.
    → the command's seconds."""
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", os.path.join(ROOT, "chip_smoke.py"),
           "--dp-worker", part, out]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text = proc.communicate()[0]
        raise RuntimeError(f"phase {phase} ({part}) outlived {timeout} s:\n"
                           f"{text[-6000:]}")
    secs = time.perf_counter() - t0
    with open(os.path.join(out, f"{part}.log"), "w") as f:
        f.write(text)
    if proc.returncode != 0:
        raise RuntimeError(f"phase {phase} ({part}): torchrun exited "
                           f"{proc.returncode}:\n{text[-6000:]}")
    for line in text.splitlines():
        if line.startswith(f"[phase {phase}]"):
            print(line, flush=True)
    return secs


def _dp_read(out, part, rank):
    import torch
    return torch.load(os.path.join(out, f"{part}_rank{rank}.pt"),
                      weights_only=False)


def phase11():
    """Data-parallel training on the one card. (a) a small fp32 model
    (phase 7's, at a global batch of 8) as 2 ranks over gloo: one
    accumulation-2 optimizer step held against the same model in one
    process by phase 7's rule, and the two ranks' weights bit-identical.
    (b) ``preset=retrieval`` at full width (``CUT_DEPTH``) through the
    port's CLI under ``torchrun --nproc_per_node=1``, NCCL at world size 1: preempted by an
    agreed flag and resumed, with phase 9's checks and launch counts, then
    one micro-step profiled without a group and under it (device time,
    NCCL's), the same model, batch and configuration. (c) the
    same model as 2 ranks on the card over gloo (NCCL refuses two ranks on
    one device): a few micro-steps, the ranks' weights bit-identical after
    every update, the first loss against (b)'s, each rank's peak memory,
    the gradient all-reduce's time."""
    build_dir = os.path.join(ROOT, REPO, "_build")
    os.makedirs(build_dir, exist_ok=True)
    import torch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        a = _phase11a(tmp)
        b = _phase11b(tmp)
        c = _phase11c(tmp, b)
    return a, b, c


def _phase11a(tmp):
    cfg = _dp_small_cfg()
    secs = _torchrun(2, "a", tmp, 300)
    ranks = [_dp_read(tmp, "a", r) for r in range(2)]
    for k, p in ranks[0]["run"][1].items():
        if not ranks[1]["run"][1][k].equal(p):
            raise AssertionError(f"ranks disagree on {k} after the update")
    launches = ranks[0]["run"][3]
    if _flash(launches) != {"flash_rel_fwd", "flash_rel_bwd"}:
        raise AssertionError(f"fp32 training launched {launches}")
    model = _small_model(cfg)
    one = _step_run(cfg, model, _small_batches(cfg), "cuda")
    out = _hold_step(cfg, ranks[0]["run"], one, model, "2 ranks", "1 process")
    log(11, f"(a) small f32 model, global batch {DP_SMALL_BATCH} as 2 gloo "
            f"ranks on the card, accumulation 2, {cfg.loss.kind} loss: 2 "
            f"ranks vs 1 process {out['text']}; both ranks' weights "
            f"bit-identical; rank 0 flash launches {launches}; torchrun "
            f"{secs:.1f} s",
        launches=launches, **out["data"], dp=ranks[0]["run"][0],
        one=one[0], seconds=secs)
    return launches


def _dp_small_cfg():
    cfg = _train_cfg_small()
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=DP_SMALL_BATCH))


def _phase11b(tmp):
    secs = _torchrun(1, "b", tmp, 600)
    res = _dp_read(tmp, "b", 0)
    log(11, f"(b) preset=retrieval through the CLI under torchrun "
            f"--nproc_per_node=1, NCCL: preempted at micro-step "
            f"{DP_FLAG_AT} (the flag raised there and agreed through "
            f"any_rank after that batch), resumed mid-epoch and finished: "
            f"{res['micro']} micro-steps ({res['updates']} updates), "
            f"losses {res['losses'][0]:.4f} → {res['losses'][-1]:.4f} "
            f"(finite); frozen bit-identical, {res['moved']}/"
            f"{res['trainable']} trainable leaves moved; launches "
            f"{res['launches']}; peak {res['peak_gib']:.2f} GiB; torchrun "
            f"{secs:.1f} s", **{k: v for k, v in res.items()
                                if k not in ("step", "alone")}, seconds=secs)
    st, alone, red = res["step"], res["alone"], res["all_reduce"]
    log(11, f"(b) one warm micro-step at {st['samples']} samples, the same "
            f"model, batch and configuration: without a group device busy "
            f"{alone['device_busy_ms']:.1f} ms, host clock "
            f"{alone['step_ms']:.1f} ms; under the NCCL group of 1 device "
            f"busy {st['device_busy_ms']:.1f} ms "
            f"({st['device_busy_ms'] - alone['device_busy_ms']:+.2f} ms), "
            f"NCCL kernels {st['collective_ms']:.2f} ms in "
            f"{st['collective_kernels']} launches, host clock "
            f"{st['step_ms']:.1f} ms; the gradient all-reduce of "
            f"{red['gb']:.3f} GB alone: {red['device_ms']:.2f} ms device "
            f"time, {red['call_ms']:.2f} ms a call (CUDA events)",
        **st, alone=alone, all_reduce=red)
    return res


def _phase11c(tmp, b):
    secs = _torchrun(2, "c", tmp, 600)
    ranks = [_dp_read(tmp, "c", r) for r in range(2)]
    if ranks[0]["digests"] != ranks[1]["digests"]:
        raise AssertionError("the ranks' trainable weights differ after an "
                             "update")
    losses, rank_losses = ranks[0]["losses"], ranks[0]["rank_losses"]
    first = abs(losses[0] - b["losses"][0])
    if rank_losses[0] == rank_losses[1]:
        raise AssertionError(f"both ranks' first losses are {rank_losses}: "
                             "the ranks did not hold their own rows")
    if not all(math.isfinite(x) for x in losses) or first > 2e-2:
        raise AssertionError(f"2-rank losses {losses} vs (b)'s first "
                             f"{b['losses'][0]}")
    peaks = [r["peak_gib"] for r in ranks]
    reduce_s = ranks[0]["all_reduce_s"]
    log(11, f"(c) preset=retrieval as 2 gloo ranks on the card, global B = "
            f"16, {DP_STEPS} micro-steps at accumulation 2: losses "
            f"{[round(x, 4) for x in losses]} (finite); first loss "
            f"{losses[0]:.5f} (the mean of the ranks' "
            f"{', '.join(f'{x:.5f}' for x in rank_losses)}) vs (b)'s "
            f"{b['losses'][0]:.5f}, diff "
            f"{first:.1e} (tol 2e-2); trainable weights bit-identical "
            f"across ranks after each of {len(ranks[0]['digests'])} updates "
            f"(sha256), and moved; peak memory per rank "
            f"{', '.join(f'{p:.2f}' for p in peaks)} GiB; gradient "
            f"all-reduce of {ranks[0]['reduce_gb']:.3f} GB over gloo "
            f"{', '.join(f'{x * 1e3:.0f}' for x in reduce_s)} ms (host "
            f"clock); micro-step host clock "
            f"{', '.join(f'{x * 1e3:.0f}' for x in ranks[0]['step_s'])} ms; "
            f"torchrun {secs:.1f} s",
        losses=losses, rank_losses=rank_losses, first_loss_diff=first,
        peak_gib=peaks,
        all_reduce_s=reduce_s, reduce_gb=ranks[0]["reduce_gb"],
        step_s=ranks[0]["step_s"], seconds=secs)
    return {"peak_gib": peaks, "all_reduce_s": reduce_s}


def dp_worker(part, out):
    """One rank of phase 11 or 12, started by torchrun; saves what the
    parent checks into ``out``."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if part in ("b", "tp-c"):       # NCCL, joined by the CLI
        result = (_dp_worker_b if part == "b" else _tp_worker_c)(out)
    else:
        # phase 12 (b): rank 0 takes the one-rank step before the group
        # exists (rank 1 waits to join it)
        ref = _tp_reference(out) if part == "tp-b" and \
            os.environ["RANK"] == "0" else None
        # two ranks on one card: gloo (NCCL refuses them), from the
        # launcher's environment
        dist.init_process_group("gloo", init_method="env://")
        try:
            result = {"a": _dp_worker_a, "c": _dp_worker_c,
                      "tp-a": _tp_worker_a,
                      "tp-b": lambda: _tp_worker_b(out, ref)}[part]()
        finally:
            dist.destroy_process_group()
    rank = int(os.environ["RANK"])
    torch.save(result, os.path.join(out, f"{part}_rank{rank}.pt"))


def _dp_worker_a():
    cfg = _dp_small_cfg()
    return {"run": _step_run(cfg, _small_model(cfg), _small_batches(cfg),
                             "cuda:0")}


def _dp_worker_b(out):
    """(b): the CLI twice (preempted, resumed) under the launcher's NCCL
    group of one, K1-K4 counted from zero over both; then one micro-step
    profiled without a group, and under a group this worker joins."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from speech_transcript_embeddings_torch import train as cli
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    from speech_transcript_embeddings_torch.parallel import collectives
    from speech_transcript_embeddings_torch.parallel import mesh as mesh_lib
    from speech_transcript_embeddings_torch.training import train_step as ts
    run = os.path.join(out, "run")
    argv = ["device=cuda", "mesh.multihost=true"] + _dp_argv(run)
    fk.log_mel.launches = 0
    fk.log_mel.launches_by_frames.clear()
    fk.normalize_and_stack.launches = 0
    fa.LAUNCHES.clear()
    kernel_calls = KernelCalls()
    first = cli.main(argv + [f"train.fault_inject_preempt_at={DP_FLAG_AT}"])
    if first.get("preempted") != {"epoch": 1, "batches_done": DP_FLAG_AT}:
        raise AssertionError(f"preemption: {first.get('preempted')}")
    log_text = open(os.path.join(run, "training.log")).read()
    if "Data parallel: 1 rank(s) over nccl" not in log_text:
        raise AssertionError("the run did not take the NCCL data axis")
    res = cli.main(argv)
    torch.cuda.synchronize()
    launches = {"log_mel": fk.log_mel.launches,
                "log_mel_normalize": fk.normalize_and_stack.launches,
                **{name: fa.LAUNCHES[name] for name in FLASH_KERNELS}}
    kernel_launched = kernel_calls.stop("data-parallel training")
    cfg, state, ep = res["cfg"], res["state"], res["epochs"][0]
    if ep["skipped_batches"] != DP_FLAG_AT:
        raise AssertionError(f"no mid-epoch resume: {ep}")
    micro = DP_FLAG_AT + ep["train_batches"]
    forwards = micro + ep["eval_batches"] + res["test_batches"] + \
        res["retrieval_batches"]
    layers = cfg.model.audio.num_layers
    want = {"flash_rel_bwd_wgmma": layers * micro,
            "flash_rel_fwd_wgmma": layers * forwards,
            "flash_rel_fwd": 0, "flash_rel_bwd": 0,
            "log_mel": forwards, "log_mel_normalize": forwards}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    launches.update(kernel_launched)
    losses = [s["loss"] for s in first["step_log"] + res["step_log"]]
    if len(losses) != micro or not np.isfinite(losses).all():
        raise AssertionError(f"micro-step losses {losses}")
    fresh = ts.create_train_state(init_model(
        cfg.model, torch.Generator("cuda").manual_seed(cfg.train.seed),
        "cuda", train=True), cfg, total_steps=1)
    for k, p in state.frozen.items():
        if not torch.equal(p, fresh.frozen[k]):
            raise AssertionError(f"frozen {k} changed")
    moved = sum(not torch.equal(p, fresh.trainable[k])
                for k, p in state.trainable.items())
    if moved < 0.9 * len(state.trainable):
        raise AssertionError(f"{moved} of {len(state.trainable)} trainable "
                             "leaves moved")
    del fresh
    torch.cuda.empty_cache()
    # the CLI left the group: the one-process step, then the same under it
    alone = _profile_micro_step(11, res)
    mesh_lib.maybe_initialize_distributed(True, "cuda")
    try:
        step = _profile_micro_step(11, res)
        # the gradient all-reduce alone, on buffers of the trainable
        # split's size: NCCL's in-place all-reduce of one rank and the
        # bucket packing around it
        bufs = [torch.zeros_like(p) for p in state.trainable.values()]
        reduce = {"gb": sum(4 * b.numel() for b in bufs) / 1e9,
                  "call_ms": cuda_ms(lambda: collectives.all_reduce_mean_(
                      bufs), iters=3, warmup=1),
                  "device_ms": device_ms(lambda: collectives.all_reduce_mean_(
                      bufs), iters=3, warmup=1)}
        del bufs
    finally:
        dist.destroy_process_group()
    return {"launches": launches, "losses": losses, "micro": micro,
            "updates": state.optimizer.count, "moved": moved,
            "trainable": len(state.trainable), "peak_gib": ep["peak_mem_gib"],
            "step": step, "alone": alone, "all_reduce": reduce}


def _dp_worker_c():
    """(c): ``preset=retrieval`` built as the CLI builds it, trained on this
    rank's rows; the weights' sha256 after every update, the gradient
    all-reduce timed on buffers of the trainable split's size."""
    import hashlib
    import torch
    import torch.distributed as dist
    from speech_transcript_embeddings_torch import train as cli
    from speech_transcript_embeddings_torch.data import (
        DataPipeline, make_source, resolve_tokenizer,
    )
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    from speech_transcript_embeddings_torch.ops import make_frontend
    from speech_transcript_embeddings_torch.parallel import collectives
    from speech_transcript_embeddings_torch.parallel import mesh as mesh_lib
    from speech_transcript_embeddings_torch.training import loop
    from speech_transcript_embeddings_torch.training import train_step as ts
    device = torch.device("cuda:0")
    cfg = cli.build_config(_dp_argv("unused") +
                           ["train.accumulation_steps=2"])
    mesh = mesh_lib.make_mesh(cfg)
    state = ts.create_train_state(init_model(
        cfg.model, torch.Generator(device).manual_seed(cfg.train.seed),
        device, train=True), cfg, total_steps=100)
    frontend = make_frontend(cfg.model.frontend).to(device)
    pipeline = DataPipeline(cfg.data, resolve_tokenizer(cfg),
                            seed=cfg.train.seed)
    source = make_source(cfg.data, seed=cfg.train.seed)
    batches = itertools.islice(pipeline.epoch_batches(source, "train", 1),
                               DP_STEPS)
    gen = loop.dropout_generator(cfg.train.seed, device, mesh.rank)

    def digest():
        h = hashlib.sha256()
        for p in state.trainable.values():
            h.update(p.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    start, digests, losses, step_s = digest(), [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        m = ts.train_step(cfg, state, frontend,
                          mesh_lib.shard_batch(mesh, batch), gen)
        if not losses:      # each rank's own rows: their losses differ
            rank_losses = collectives.gather_host(m["loss"][None]).tolist()
        losses.append(float(collectives.mean_over_ranks(m["loss"])))
        torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        if state.optimizer.mini_step == 0:
            digests.append(digest())
    if start in digests:
        raise AssertionError("the trainable weights did not move")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    bufs = [torch.zeros_like(p) for p in state.trainable.values()]
    all_reduce_s = []
    for _ in range(2):
        dist.barrier()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        collectives.all_reduce_mean_(bufs)
        torch.cuda.synchronize(device)
        all_reduce_s.append(time.perf_counter() - t0)
    return {"digests": digests, "losses": losses, "peak_gib": peak,
            "rank_losses": rank_losses,
            "all_reduce_s": all_reduce_s, "step_s": step_s,
            "reduce_gb": sum(4 * b.numel() for b in bufs) / 1e9}


# phase 12: tensor parallel, the mesh's model axis of 2, as 2 gloo ranks on
# the one card (NCCL refuses two ranks on one device): (a) the small model
# of phase 7 in fp32 and in bf16, dropout on, the clip firing; (b)
# preset=retrieval through the CLI on phase 9's CV lengths at its shortest
# bucket;
# (c) the CLI under NCCL with a card per rank, where there are two cards
TP_CLIP = 0.1            # (a): max_grad_norm, below the small model's norms
TP_CLIPS = 32            # (b): 2 micro-steps of 16, one update
TP_UPDATES = 1           # (b): the CLI's schedule length for TP_CLIPS
TP_NORM_TOL = 4e-3       # (b): grad norm, relative, against model=1
TP_UPDATE_COS = 0.9      # (b): the update's cosine against model=1
TP_BUCKET = 41200        # (b): the shortest CV bucket (its gloo copies scale
                         # with the clip)


def _tp_argv(out):
    """(b): ``preset=retrieval`` at B = 16 on CV lengths, every clip at
    the ``TP_BUCKET`` bucket, accumulation 2, dropout and SpecAugment off, no
    warmup."""
    return ["preset=retrieval", "data.batch_size=16",
            "data.synthetic_length_profile=cv",
            f"data.audio_buckets=[{TP_BUCKET}]",
            f"data.max_audio_samples={TP_BUCKET}", "train.num_epochs=1",
            "train.accumulation_steps=2",
            "train.save_every=0", "optimizer.warmup_steps=0",
            f"data.num_synthetic_samples={TP_CLIPS}",
            f"train.output_dir={out}", *DP_DROPOUT_OFF, *CUT_DEPTH]


def _tp_small_cfg(dtype):
    cfg = _train_cfg_small()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype=dtype),
        optimizer=dataclasses.replace(cfg.optimizer, max_grad_norm=TP_CLIP),
        mesh=dataclasses.replace(cfg.mesh, num_model=2))


def _tp_worker_a():
    """(a): the small model's step at model=2, fp32 then bf16."""
    cfgs = {d: _tp_small_cfg(d) for d in ("float32", "bfloat16")}
    return {d: _step_run(cfg, _small_model(cfg), _small_batches(cfg),
                         "cuda:0", dropout=True) for d, cfg in cfgs.items()}


def _merge_run(ranks, model):
    """Two model ranks' ``_step_run`` results → one whole run: the
    trainable weights and each micro-batch's gradient merged from their
    shards, checking that every replicated leaf agrees bit for bit."""
    from speech_transcript_embeddings_torch.parallel import mesh as mesh_lib
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}

    def merge(parts, what):
        out = {}
        for k in parts[0]:
            if mesh_lib.shard_dim(k) is None and \
                    not parts[1][k].equal(parts[0][k]):
                raise AssertionError(f"the model ranks' replicated {what} "
                                     f"{k} differ")
            out[k] = mesh_lib.merge_shards(k, [p[k] for p in parts],
                                           shapes[k])
        return out
    metrics = ranks[0][0]
    if metrics != ranks[1][0]:
        raise AssertionError(f"the model ranks' metrics differ: {metrics} "
                             f"vs {ranks[1][0]}")
    return (metrics, merge([r[1] for r in ranks], "weights"),
            [merge([r[2][i] for r in ranks], "gradients")
             for i in range(len(ranks[0][2]))], ranks[0][3])


def phase12():
    """Tensor parallel (the model axis of 2) on the one card. (a) phase
    7's small model as 2 gloo ranks against one process, one
    accumulation-2 step with dropout on and the clip firing: fp32 by phase
    7's rule and loss and grad norm within 1e-6, bf16 (the tensor-core
    flash kernels at the local heads) by phase 11's 2e-2 rule; the
    replicated leaves bit-identical across the ranks. (b)
    ``preset=retrieval`` (``CUT_DEPTH``) through the CLI at
    ``mesh.num_model=2`` as 2 gloo ranks: finite losses, the first against the same batch at model=1
    (2e-2), the window's mean grad norm (``TP_NORM_TOL``) and the update's
    cosine (``TP_UPDATE_COS``) against model=1's, the shard shapes, K1-K4 on
    each rank, the gathered shards equal to ``final_model``, which
    ``Embedder`` serves in one process; each rank's peak memory in each
    micro-step of the window below the same micro-step's at model=1, and
    its whole run's below the one-rank window's; device busy, the
    collectives' share. (c) the CLI under NCCL, a card per rank, when
    there are two cards."""
    build_dir = os.path.join(ROOT, REPO, "_build")
    os.makedirs(build_dir, exist_ok=True)
    import torch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        a = _phase12a(tmp)
        b = _phase12b(tmp)
        b["nccl"] = _phase12c(tmp, b)
    return a, b


def _phase12a(tmp):
    secs = _torchrun(2, "tp-a", tmp, 300, phase=12)
    ranks = [_dp_read(tmp, "tp-a", r) for r in range(2)]
    launches = {}
    for dtype, want_kernels, tol in (
            ("float32", {"flash_rel_fwd", "flash_rel_bwd"}, 1e-6),
            ("bfloat16", {"flash_rel_fwd_wgmma", "flash_rel_bwd_wgmma"},
             2e-2)):
        cfg = _tp_small_cfg(dtype)
        model = _small_model(cfg)
        got = _merge_run([r[dtype] for r in ranks], model)
        one = _step_run(cfg, model, _small_batches(cfg), "cuda",
                        dropout=True)
        launches[dtype] = got[3]
        if _flash(got[3]) != want_kernels or _flash(one[3]) != want_kernels:
            raise AssertionError(f"{dtype} launched {got[3]} at model=2, "
                                 f"{one[3]} in one process")
        errs = {f"{key}_{i}": abs(g[key] - o[key]) / abs(o[key])
                for key in ("loss", "grad_norm")
                for i, (g, o) in enumerate(zip(got[0], one[0]))}
        norms = [m["grad_norm"] for m in one[0]]
        if max(errs.values()) > tol or min(norms) <= TP_CLIP:
            raise AssertionError(f"{dtype}: rel errs {errs} (tol {tol}), "
                                 f"grad norms {norms} (clip {TP_CLIP})")
        if dtype == "float32":
            out = _hold_step(cfg, got, one, model, "2 TP ranks", "1 process")
            text, data = out["text"], out["data"]
        else:
            # Adam's first step moves a weight by ≤ lr: a sign flipped by
            # bf16 rounding is 2·lr, and rounding may add to that
            worst = max((got[1][k] - v).abs().max().item()
                        for k, v in one[1].items())
            if worst > 2.5 * cfg.optimizer.learning_rate:
                raise AssertionError(f"bf16 weights differ by {worst}")
            text = (f"updated params max diff {worst:.1e} (bound 2.5·lr)")
            data = {"param_max_diff": worst}
        log(12, f"(a) small {dtype} model at model=2 as 2 gloo ranks on the "
                f"card vs 1 process, accumulation 2, dropout on, clip "
                f"{TP_CLIP} below grad norms {[round(n, 3) for n in norms]}: "
                f"loss/grad-norm rel err {max(errs.values()):.1e} (tol "
                f"{tol:g}); {text}; replicated leaves bit-identical across "
                f"the ranks; rank 0 flash launches {got[3]}; torchrun "
                f"{secs:.1f} s",
            dtype=dtype, rel_errs=errs, launches=got[3], **data,
            tp=got[0], one=one[0], seconds=secs)
    return launches


def _phase12b(tmp):
    secs = _torchrun(2, "tp-b", tmp, 900, phase=12)
    ranks = [_dp_read(tmp, "tp-b", r) for r in range(2)]
    r0, ref = ranks[0], ranks[0]["reference"]
    losses = r0["losses"]
    first = abs(losses[0] - ref["loss"])
    ref_norm = sum(ref["grad_norms"]) / len(ref["grad_norms"])
    norm_err = abs(r0["grad_norm"] - ref_norm) / ref_norm
    update = r0["update"]
    # log the readings first: a failed check still leaves them
    log(12, f"(b) against model=1 on the same window: first loss "
            f"{losses[0]:.6f} vs {ref['loss']:.6f}, diff {first:.1e} (tol "
            f"2e-2); mean grad norm {r0['grad_norm']:.6f} vs "
            f"{ref_norm:.6f}, rel {norm_err:.2e} (tol {TP_NORM_TOL:g}); "
            f"the update's cosine over {update['leaves']} trainable leaves "
            f"{update['cos']:.6f} (min {TP_UPDATE_COS:g}), lowest leaf "
            f"{update['worst_leaf']} {update['worst_leaf_cos']:.4f}",
        first_loss_diff=first, grad_norm=r0["grad_norm"],
        ref_grad_norms=ref["grad_norms"], grad_norm_rel_err=norm_err,
        update=update)
    if not all(math.isfinite(x) for x in losses) or first > 2e-2 or \
            ranks[1]["losses"] != losses:
        raise AssertionError(f"model=2 losses {losses} / "
                             f"{ranks[1]['losses']} vs model=1 first "
                             f"{ref['loss']}")
    if norm_err > TP_NORM_TOL or not update["cos"] >= TP_UPDATE_COS:
        raise AssertionError(f"model=2 grad norm rel err {norm_err} (tol "
                             f"{TP_NORM_TOL}), update cosine "
                             f"{update['cos']} (min {TP_UPDATE_COS})")
    if r0["launches"] != ranks[1]["launches"]:
        raise AssertionError(f"launches differ: {r0['launches']} vs "
                             f"{ranks[1]['launches']}")
    # each micro-step of the window against the same one at model=1, and
    # each rank's whole run (the test and retrieval phases included)
    # against the one-rank window's peak
    peaks = [r["step"]["peaks_gib"] for r in ranks]
    run_peaks = [r["run_peak_gib"] for r in ranks]
    if any(p >= q for rank in peaks for p, q in zip(rank,
                                                    ref["peaks_gib"])) or \
            max(run_peaks) >= ref["peak_gib"]:
        raise AssertionError(f"peaks a rank {peaks} GiB (whole run "
                             f"{run_peaks}) are not below the one-rank "
                             f"{ref['peaks_gib']} GiB")
    import numpy as np
    import torch
    from speech_transcript_embeddings_torch.inference.embed import Embedder
    emb = Embedder.from_checkpoint(os.path.join(tmp, "run", "final_model"),
                                   device="cuda")
    e = emb.embed_audios([_clip(6.0, 31)])
    t = emb.embed_texts(["uma frase curta"])
    norms = [float(np.linalg.norm(x[0])) for x in (e, t)]
    if e.shape != (1, 768) or not np.isfinite(e).all() or \
            max(abs(n - 1) for n in norms) > 1e-3:
        raise AssertionError(f"final_model embeddings {e.shape} {norms}")
    del emb
    torch.cuda.empty_cache()
    log(12, f"(b) preset=retrieval through the CLI at mesh.num_model=2 as 2 "
            f"gloo ranks on the card: {r0['micro']} micro-steps of 16 at "
            f"{TP_BUCKET} samples ({r0['updates']} update(s)), losses "
            f"{[round(x, 4) for x in losses]} (finite, equal on both "
            f"ranks), the grad norm and the update as model=1's (above); "
            f"{r0['split']} split leaves at 1/2 of their rows or columns "
            f"on each rank (the vocabulary padded to {r0['vocab_rows']} "
            f"rows a rank); launches per rank {r0['launches']}; final_model "
            f"equal to the ranks' gathered shards ({r0['compared']} "
            f"leaves), served by Embedder in one process (norms "
            f"{norms[0]:.6f}, {norms[1]:.6f}); torchrun {secs:.1f} s",
        losses=losses, reference=ref, first_loss_diff=first,
        launches=r0["launches"], micro=r0["micro"], seconds=secs)
    for r, rank in enumerate(ranks):
        st = rank["step"]
        log(12, f"(b) rank {r} at {TP_BUCKET} samples (B=16), a fresh "
                f"optimizer's window, accumulating then updating: peak "
                f"device memory {st['peaks_gib'][0]:.3f} / "
                f"{st['peaks_gib'][1]:.3f} GiB vs {ref['peaks_gib'][0]:.3f} "
                f"/ {ref['peaks_gib'][1]:.3f} GiB at model=1 (the same "
                f"window, rank 0 before the run); the whole run's peak "
                f"{rank['run_peak_gib']:.3f} GiB; device busy of an "
                f"accumulating micro-step "
                f"{st['device_busy_ms']:.1f} ms under the profiler: kernels "
                f"{st['kernel_ms']:.1f} ms, the gloo collectives' "
                f"host↔device copies {st['copy_ms']:.1f} ms (the two ranks "
                f"share the card); {st['collectives']} collectives "
                f"{st['collective_s'] * 1e3:.0f} ms host clock (each after "
                f"a device sync, in an updating micro-step of "
                f"{st['synced_step_s'] * 1e3:.0f} ms); an accumulating "
                f"micro-step's host clock {st['step_ms']:.0f} ms",
            rank=r, **st, run_peak_gib=rank["run_peak_gib"],
            one_rank_peaks_gib=ref["peaks_gib"])
    return {"launches": r0["launches"], "losses": losses, "peak_gib": peaks,
            "run_peak_gib": run_peaks, "one_rank_peaks_gib": ref["peaks_gib"],
            "steps": [r["step"] for r in ranks]}


def _phase12c(tmp, b=None):
    """(c): the CLI at model=2 under NCCL, a card per rank, where there are
    two cards (data 2 × model 2 where there are four): K1-K4 on each rank,
    its losses against (b)'s (the same configuration and batches over gloo
    on one card, 2e-2)."""
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        log(12, f"(c) did not run: NCCL needs a card per rank and this "
                f"machine has one card (torch.cuda.device_count() = {n}); "
                "(a) and (b) ran over gloo", ran=False, device_count=n)
        return None
    world = 4 if n >= 4 else 2
    secs = _torchrun(world, "tp-c", tmp, 900, phase=12)
    ranks = [_dp_read(tmp, "tp-c", r) for r in range(world)]
    losses = ranks[0]["losses"]
    diff = None if b is None else abs(losses[0] - b["losses"][0])
    if not all(math.isfinite(x) for x in losses) or \
            any(r["losses"] != losses for r in ranks) or \
            (diff is not None and diff > 2e-2):
        raise AssertionError(f"(c) losses {[r['losses'] for r in ranks]}, "
                             f"(b) {None if b is None else b['losses']}")
    log(12, f"(c) the CLI at data={world // 2} × model=2 under NCCL, a card "
            f"per rank ({n} cards): losses {[round(x, 4) for x in losses]}, "
            f"equal on every rank; first vs (b)'s over gloo: "
            f"{'not run' if diff is None else f'{diff:.1e} (tol 2e-2)'}; "
            f"launches per rank {ranks[0]['launches']}; torchrun "
            f"{secs:.1f} s", ran=True, device_count=n, losses=losses,
        launches=ranks[0]["launches"], seconds=secs)
    return ranks[0]


def _tp_worker_c(out):
    """(c): the CLI at ``mesh.num_model=2`` on the card of this rank's
    ``LOCAL_RANK``, under the NCCL group the CLI joins, K1-K4 counted."""
    import numpy as np
    import torch
    from speech_transcript_embeddings_torch import train as cli
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    run = os.path.join(out, "nccl")
    fk.log_mel.launches = 0
    fk.normalize_and_stack.launches = 0
    fa.LAUNCHES.clear()
    kernel_calls = KernelCalls()
    res = cli.main(["device=cuda", "mesh.num_model=2"] + _tp_argv(run))
    torch.cuda.synchronize()
    kernel_launched = kernel_calls.stop("(c) tensor-parallel training")
    mesh = res["state"].mesh
    text = open(os.path.join(run, "training.log")).read() \
        if mesh.rank == 0 else ""
    if mesh.rank == 0 and not (
            "Tensor parallel: 2 rank(s) a data row over nccl" in text and
            f"Data parallel: {mesh.data} rank(s) over nccl" in text):
        raise AssertionError("(c) the run did not take the NCCL mesh")
    losses = [s["loss"] for s in res["step_log"]]
    if not np.isfinite(losses).all():
        raise AssertionError(f"(c) losses {losses}")
    return {"losses": losses,
            "launches": {"log_mel": fk.log_mel.launches,
                         "log_mel_normalize": fk.normalize_and_stack.launches,
                         **{k: fa.LAUNCHES[k] for k in FLASH_KERNELS},
                         **kernel_launched}}


def _tp_worker_b(out, ref):
    """(b): both ranks run the CLI at ``mesh.num_model=2``, K1-K4 counted
    from zero over the run, and check their shards; the gathered final
    weights against ``final_model``; one warm micro-step profiled. ``ref``:
    rank 0's step at model=1 (``_tp_reference``)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from speech_transcript_embeddings_torch import checkpoints
    from speech_transcript_embeddings_torch import train as cli
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        DualEncoderModel,
    )
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    from speech_transcript_embeddings_torch.parallel import mesh as mesh_lib
    from speech_transcript_embeddings_torch.training import (
        optimizer as opt_lib,
    )
    # two ranks share card 0: the loop takes the card of LOCAL_RANK
    os.environ["LOCAL_RANK"] = "0"
    torch.cuda.set_device(0)
    run = os.path.join(out, "run")
    rank = dist.get_rank()
    fk.log_mel.launches = 0
    fk.log_mel.launches_by_frames.clear()
    fk.normalize_and_stack.launches = 0
    fa.LAUNCHES.clear()
    kernel_calls = KernelCalls()
    torch.cuda.reset_peak_memory_stats()
    res = cli.main(["device=cuda", "mesh.num_model=2"] + _tp_argv(run))
    torch.cuda.synchronize()
    run_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {"log_mel": fk.log_mel.launches,
                "log_mel_normalize": fk.normalize_and_stack.launches,
                **{name: fa.LAUNCHES[name] for name in FLASH_KERNELS}}
    kernel_launched = kernel_calls.stop(f"(b) tensor-parallel training, rank {rank}")
    cfg, state, ep = res["cfg"], res["state"], res["epochs"][0]
    mesh = state.mesh
    # the whole model's counts, from the one-process model on meta
    with torch.device("meta"):
        whole = DualEncoderModel(cfg.model, torch.float32)
    labels = opt_lib.param_labels(whole, cfg.freeze, cfg.model)
    want_n = (sum(p.numel() for p in whole.parameters()),
              sum(p.numel() for k, p in whole.named_parameters()
                  if labels[k] != opt_lib.FROZEN))
    del whole
    if (mesh.data, mesh.model) != (1, 2) or \
            (res["n_params"], res["n_trainable"]) != want_n:
        raise AssertionError(f"mesh {mesh}, {res['n_params']} params, "
                             f"{res['n_trainable']} trainable, want {want_n}")
    micro = ep["train_batches"]
    forwards = micro + ep["eval_batches"] + res["test_batches"] + \
        res["retrieval_batches"]
    layers = cfg.model.audio.num_layers
    want = {"flash_rel_bwd_wgmma": layers * micro,
            "flash_rel_fwd_wgmma": layers * forwards,
            "flash_rel_fwd": 0, "flash_rel_bwd": 0,
            "log_mel": forwards, "log_mel_normalize": forwards}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    launches.update(kernel_launched)
    shapes = state.model.full_shapes()
    split, vocab_rows = 0, None
    for k, p in state.model.named_parameters():
        dim = mesh_lib.shard_dim(k)
        whole = list(shapes[k])
        if dim is not None:
            whole[dim] = -(-whole[dim] // 2)
            split += 1
            if k.endswith("word_embeddings.weight"):
                vocab_rows = whole[dim]
        if tuple(p.shape) != tuple(whole):
            raise AssertionError(f"{k}: {tuple(p.shape)} on rank {rank}")
    gathered = mesh_lib.gather_state(state.model.state_dict(), mesh, shapes)
    compared, update = 0, None
    if rank == 0:
        saved = checkpoints.load_stored_state(os.path.join(run,
                                                           "final_model"))
        if set(saved) != set(gathered):
            raise AssertionError("final_model holds other leaves")
        for k, v in saved.items():
            if not torch.equal(v, gathered[k]):
                raise AssertionError(f"final_model {k} is not the gathered "
                                     "shards")
            compared += 1
        update = _update_cosines(gathered, ref.pop("before"),
                                 ref.pop("update"))
    del gathered
    losses = [s["loss"] for s in res["step_log"]]
    if len(losses) != micro or not np.isfinite(losses).all():
        raise AssertionError(f"micro-step losses {losses}")
    step = _tp_profile_micro_step(res)
    return {"reference": ref, "losses": losses, "micro": micro,
            "updates": state.optimizer.count, "launches": launches,
            "split": split, "vocab_rows": vocab_rows, "compared": compared,
            "grad_norm": ep["train_metrics"]["grad_norm"], "update": update,
            "run_peak_gib": run_peak, "step": step}


def _update_cosines(after, before, want):
    """The cosine between the update a run made (``after - before``, each
    trainable leaf) and ``want``'s, over all of them (float64 sums), and
    the leaf where it is lowest."""
    import torch
    dot = got_sq = want_sq = 0.0
    worst = (2.0, None)
    for k, w in want.items():
        d = (after[k].float() - before[k]).flatten().double()
        w = w.flatten().double()
        terms = (torch.dot(d, w).item(), torch.dot(d, d).item(),
                 torch.dot(w, w).item())
        dot, got_sq, want_sq = (a + b for a, b in
                                zip((dot, got_sq, want_sq), terms))
        if terms[1] and terms[2]:
            worst = min(worst, (terms[0] / math.sqrt(terms[1] * terms[2]),
                                k))
    return {"cos": dot / math.sqrt(got_sq * want_sq), "worst_leaf": worst[1],
            "worst_leaf_cos": worst[0], "leaves": len(want)}


def _tp_batches(cfg):
    """The run's first accumulation window: its first two train batches."""
    from speech_transcript_embeddings_torch.data import (
        DataPipeline, make_source, resolve_tokenizer,
    )
    pipeline = DataPipeline(cfg.data, resolve_tokenizer(cfg),
                            seed=cfg.train.seed)
    batches = pipeline.epoch_batches(
        make_source(cfg.data, seed=cfg.train.seed), "train", 1)
    return [next(batches) for _ in range(cfg.train.accumulation_steps)]


def _tp_window_peaks(cfg, state, frontend, batches):
    """Peak device memory (GiB) of each micro-step of one accumulation
    window from a fresh optimizer: the accumulating one, then the update."""
    import torch
    from speech_transcript_embeddings_torch.training import train_step as ts
    peaks = []
    for batch in batches:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts.train_step(cfg, state, frontend, batch, None)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    return peaks


def _tp_reference(out):
    """(b)'s first accumulation window at model=1 on the card, in one
    process, as the CLI takes it (seed-0 weights, its first two train
    batches, its one-update schedule): each micro-step's loss and grad
    norm, and the trainable weights before and the update on the host;
    then the window's per-micro-step peaks from a fresh optimizer (its
    kernels warm), as ``_tp_profile_micro_step`` takes them at model=2."""
    import torch
    from speech_transcript_embeddings_torch import train as cli
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    from speech_transcript_embeddings_torch.ops import make_frontend
    from speech_transcript_embeddings_torch.training import train_step as ts
    cfg = cli.build_config(_tp_argv(os.path.join(out, "run")))
    model = init_model(cfg.model, torch.Generator("cuda").manual_seed(
        cfg.train.seed), "cuda", train=True)
    state = ts.create_train_state(model, cfg, total_steps=TP_UPDATES)
    before = {k: p.detach().to("cpu", copy=True)
              for k, p in state.trainable.items()}
    frontend = make_frontend(cfg.model.frontend).to("cuda")
    batches = _tp_batches(cfg)
    metrics = [ts.train_step(cfg, state, frontend, b, None) for b in batches]
    update = {k: p.detach().cpu() - before[k]
              for k, p in state.trainable.items()}
    del state
    peaks = _tp_window_peaks(cfg, ts.create_train_state(
        model, cfg, total_steps=TP_UPDATES), frontend, batches)
    del model
    torch.cuda.empty_cache()
    return {"loss": float(metrics[0]["loss"]),
            "grad_norms": [float(m["grad_norm"]) for m in metrics],
            "peaks_gib": peaks, "peak_gib": max(peaks),
            "samples": int(batches[0]["waveform"].shape[1]),
            "before": before, "update": update}


def _tp_profile_micro_step(res):
    """A finished model=2 run's model with a fresh optimizer (the run
    dropped its moments; its kernels are warm) on the run's first window:
    each micro-step's peak memory (accumulate, update: as
    ``_tp_reference`` takes them at model=1); then an accumulating
    micro-step's host clock; an updating one with a device sync before
    each collective, timed on the host clock (the gloo collectives' time);
    and an accumulating one under torch.profiler (device busy; the
    host↔device copies, which are the gloo collectives' on the card)."""
    import torch
    import torch.distributed as dist
    from speech_transcript_embeddings_torch.training import train_step as ts
    from speech_transcript_embeddings_torch.utils.bench import device_trace
    cfg = res["cfg"]
    state = ts.create_train_state(res["state"].model, cfg,
                                  total_steps=TP_UPDATES,
                                  mesh=res["state"].mesh)
    batches = _tp_batches(cfg)
    peaks = _tp_window_peaks(cfg, state, res["frontend"], batches)
    step = lambda: ts.train_step(cfg, state, res["frontend"],  # noqa
                                 batches[0], None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    spent = []
    plain = dist.all_reduce

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain(*args, **kw)
        spent.append(time.perf_counter() - t)
        return out
    dist.all_reduce = timed
    try:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        synced = time.perf_counter() - t0
    finally:
        dist.all_reduce = plain
    with device_trace() as prof:
        step()
    # gloo's device rows: its host↔device copies, and "gloo:" spans that
    # repeat the copies' time (left out, or they would count twice)
    rows = [r for r in _device_rows(prof) if not r[1].startswith("gloo:")]
    copy_ms = sum(ms for ms, k, _ in rows if "memcpy" in k.lower())
    busy = sum(r[0] for r in rows)
    del state
    return dict(samples=int(batches[0]["waveform"].shape[1]),
                peaks_gib=peaks, peak_gib=max(peaks),
                step_ms=step_ms, device_busy_ms=busy, copy_ms=copy_ms,
                kernel_ms=busy - copy_ms,
                collectives=len(spent), collective_s=sum(spent),
                synced_step_s=synced,
                top=[{"kernel": k, "calls": c, "ms": ms}
                     for ms, k, c in rows[:12]])


# the quality tools: the int8 eval (in phase 8) over the first INT8_POOL
# test clips of phase 8's corpus; phase 13's one epoch of the midsize
# retrieval recipe with every kernel on (run C of PERF.md's "Quality on
# trained weights", cut to PROXY_CLIPS training clips)
INT8_POOL = 64
PROXY_CLIPS = 1024
PROXY_KERNELS = ("model.audio.use_flash_attention=true",
                 "model.frontend.use_pallas=true")
PORT_KERNELS = ("log_mel_fft_kernel", "log_mel_normalize_kernel",
                "flash_rel_fwd_wgmma_kernel", "flash_rel_bwd_dq_wgmma_kernel",
                "flash_rel_bwd_dkv_wgmma_kernel")


def _script(name):
    """``scripts/<name>.py`` as a module (the directory is no package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase13():
    """The quality proxy on the card: ``scripts/torch_proxy_quality_run.py``,
    one epoch of the midsize retrieval recipe at ``PROXY_CLIPS`` clips with
    flash attention and the log-mel kernels on: the loss falls across the
    epoch, the validation gap is positive, K1-K4 launched as often as the
    run's batches say, log-mel only at frame counts phase 2 checked, and one
    warm micro-step profiled. (The other quality tool, the int8 eval, runs
    in phase 8 on its full-width final_model: ``_int8_eval``.)"""
    return _phase13_proxy()


def _int8_eval(checkpoint):
    """``scripts/torch_int8_quality_eval.py`` on ``checkpoint`` (phase 8's
    full-width final_model) over its first ``INT8_POOL`` test clips, the
    counts from zero: the fp and int8 embeddings finite and unit-norm, int8
    products launched, log-mel only at frame counts phase 2 checked. The
    JSON lands beside the checkpoint. → the path's launches."""
    import numpy as np
    import torch
    from speech_transcript_embeddings_torch.utils import bench as ub
    tint8 = _script("torch_int8_quality_eval")
    seen = []
    embed_split = tint8.embed_split

    def recording(emb, texts, audios, chunk=32):
        te, ae = embed_split(emb, texts, audios, chunk)
        seen.append((te, ae))
        return te, ae

    tint8.embed_split = recording
    torch.cuda.empty_cache()
    with open(os.path.join(checkpoint, "metadata.json")) as f:
        dim = json.load(f)["config"]["model"]["heads"]["projection_dim"]
    ub.reset_launches()
    kernel_calls = KernelCalls()
    t0 = time.perf_counter()
    res = tint8.main(["--checkpoint", checkpoint, "--limit", str(INT8_POOL),
                      "--device", "cuda"])
    secs = time.perf_counter() - t0
    launches = ub.launches()
    kernel_calls.stop("the int8 eval")
    frames = ub.log_mel_frames()
    with open(os.path.join(os.path.dirname(checkpoint),
                           "int8_quality_eval.json")) as f:
        written = json.load(f)
    if written != json.loads(json.dumps(res)) or set(written) != {
            "checkpoint", "pool", "fp", "int8", "delta_int8_minus_fp"}:
        raise AssertionError(f"int8_quality_eval.json {sorted(written)}")
    if res["pool"] != INT8_POOL or len(seen) != 2:
        raise AssertionError(f"pool {res['pool']}, {len(seen)} passes")
    norm_err = 0.0
    for what, (te, ae) in zip(("fp", "int8"), seen):
        for name, e in (("text", te), ("audio", ae)):
            if e.shape != (INT8_POOL, dim) or not np.isfinite(e).all():
                raise AssertionError(f"{what} {name} embeddings {e.shape}")
            err = float(np.abs(np.linalg.norm(e.astype(np.float64), axis=1)
                               - 1).max())
            if err > 1e-3:
                raise AssertionError(f"{what} {name} embedding norms off 1 "
                                     f"by {err}")
            norm_err = max(norm_err, err)
    if not all(np.isfinite(v) for p in ("fp", "int8")
               for v in res[p].values()):
        raise AssertionError(f"metrics {res}")
    if launches["int8_matmul"] == 0:
        raise AssertionError(f"no int8 product launched: {launches}")
    check_mel_frames(8, frames)
    d = res["delta_int8_minus_fp"]
    log(8, f"int8 eval (scripts/torch_int8_quality_eval.py) of final_model "
           f"over {INT8_POOL} test clips in {secs:.1f} s: fp R@1 "
           f"{res['fp']['recall@1']:.4f}, gap "
           f"{res['fp']['similarity_gap']:.4f}; ΔR@1 {d['recall@1']}, Δgap "
           f"{d['similarity_gap']}, ΔMRR {d['mrr']}; embeddings finite, norms "
           f"within {norm_err:.1e} of 1; log-mel frames {frames}; launches "
           f"{launches}",
        seconds=secs, fp=res["fp"], int8=res["int8"], delta=d,
        norm_err=norm_err, frames=frames, launches=launches)
    return launches


def _phase13_proxy():
    import numpy as np
    import torch
    from speech_transcript_embeddings_torch.utils import bench as ub
    tproxy = _script("torch_proxy_quality_run")
    torch.cuda.empty_cache()
    build_dir = os.path.join(ROOT, REPO, "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        ub.reset_launches()
        kernel_calls = KernelCalls()
        t0 = time.perf_counter()
        res = tproxy.main([os.path.join(tmp, "proxy"), "--preset-retrieval",
                           "--samples", str(PROXY_CLIPS), "--acc", "1",
                           "--epochs", "1", "--device", "cuda",
                           "--extra", *PROXY_KERNELS])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ub.launches()
        kernel_launched = kernel_calls.stop("the quality proxy")
        frames = ub.log_mel_frames()
        with open(os.path.join(tmp, "proxy", "proxy_summary.json")) as f:
            summary = json.load(f)
    cfg, ep = res["cfg"], res["epochs"][0]
    layers = cfg.model.audio.num_layers
    micro, n_eval = ep["train_batches"], ep["eval_batches"]
    forwards = micro + n_eval + res["test_batches"] + res["retrieval_batches"]
    # remat_policy=full replays each block's forward, K3 included, in the
    # backward
    want = {"flash_rel_bwd_wgmma": layers * micro,
            "flash_rel_fwd_wgmma": layers * (forwards + micro),
            "flash_rel_fwd": 0, "flash_rel_bwd": 0, "log_mel": forwards,
            "log_mel_normalize": forwards, "int8_matmul": 0, **kernel_launched}
    if launches != want:
        raise AssertionError(
            f"launches {launches} != {want} for {micro} micro-steps, "
            f"{n_eval} eval, {res['test_batches']} test and "
            f"{res['retrieval_batches']} retrieval batches")
    if summary != json.loads(json.dumps(res["summary"])):
        raise AssertionError("proxy_summary.json is not the run's summary")
    losses = [s["loss"] for s in res["step_log"]]
    k = max(len(losses) // 4, 1)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    gap = summary["val_gap_trajectory"][0]
    if len(losses) != micro or not np.isfinite(losses).all() or \
            not last < first:
        raise AssertionError(f"losses {losses}")
    if not gap > 0:
        raise AssertionError(f"validation gap {gap}")
    check_mel_frames(13, frames)
    log(13, f"midsize proxy, {PROXY_CLIPS} clips, one epoch with K1-K4 on, "
            f"through the script in {secs:.1f} s: {micro} micro-steps of "
            f"{cfg.data.batch_size}, loss {first:.4f} → {last:.4f} (means of "
            f"the first and last {k}), validation gap {gap:.4f}, test "
            f"R@1 {summary['retrieval']['recall@1']:.4f}; "
            f"{ep['clips_per_sec']:.1f} clips/s over the epoch (host), "
            f"{ep['warm_clips_per_sec']:.1f} warm; log-mel frames {frames}; "
            f"launches {launches}",
        seconds=secs, micro_steps=micro, loss_first=first, loss_last=last,
        val_gap=gap, retrieval=summary["retrieval"],
        clips_per_s=ep["clips_per_sec"],
        warm_clips_per_s=ep["warm_clips_per_sec"], frames=frames,
        launches=launches)
    step = _profile_micro_step(13, res)
    del res
    torch.cuda.empty_cache()
    return launches, step


# the benchmark tools of phase 14, each run from the checkout in a process
# of its own: → the kernels its JSON line must show launched
BENCH_RUNS = {"bench": (["bench_torch.py", *CUT_DEPTH],
                        ("K1", "K2", "K3", "K4")),
              "embed_bench": (["scripts/torch_infer_bench.py", *CUT_DEPTH],
                              ("K1", "K2", "K3")),
              "embed_bench_int8": (["scripts/torch_infer_bench.py", "--int8",
                                    *CUT_DEPTH], ("K1", "K2", "K3"))}


def phase14():
    """The benchmark tools on the card: ``bench_torch.py`` with its default
    config (the length mix and the fixed 10 s step of ``preset=retrieval``
    at B = 16, at ``CUT_DEPTH``) and ``scripts/torch_infer_bench.py`` in bf16 and int8 (B =
    64 × 10 s), each a process started from the checkout. Each prints its
    JSON line (printed here too) only when every reading held the ceiling
    (the tool raises above the card's bf16 peak) and its kernels launched
    over its timed steps, counted from zero; this phase checks that line:
    HFU or MFU in (0, 1], K1-K4 launched (K1-K3 in the embed step, which
    has no backward; int8 products under ``--int8``), clips/s finite and
    above 0, and log-mel only at frame counts phase 2 checked. → each
    tool's launches."""
    import torch
    from speech_transcript_embeddings_torch.utils import bench as ub
    torch.cuda.empty_cache()
    out = {}
    for name, (cmd, kernels) in BENCH_RUNS.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *cmd], cwd=ROOT,
                              capture_output=True, text=True, timeout=900)
        secs = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"{' '.join(cmd)} exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        clips = rec["value"] if name == "bench" else rec["clips_per_s"]
        ratios = [rec["hfu"] if name == "bench" else rec["mfu"]]
        if name == "bench":
            ratios += [rec["fixed_10s"]["hfu"]] + [b["hfu"] for b in
                                                   rec["buckets"]]
        if not (math.isfinite(clips) and clips > 0) or not all(
                0 < r <= 1 for r in ratios):
            raise AssertionError(f"{name}: clips/s {clips}, HFU/MFU {ratios}")
        ub.require_launches(rec["kernel_launches"], kernels)
        if name.endswith("int8") and rec["int8_products"] == 0:
            raise AssertionError(f"{name}: no int8 product launched")
        check_mel_frames(14, {int(k): v for k, v in
                              rec["log_mel_frames"].items()})
        log(14, f"{' '.join(cmd)} in {secs:.1f} s: {clips:.2f} clips/s, "
                + (f"fixed 10 s {rec['fixed_10s_value']:.2f}, HFU "
                   f"{rec['hfu']:.1%} (fixed 10 s "
                   f"{rec['fixed_10s']['hfu']:.1%}), " if name == "bench"
                   else f"MFU {rec['mfu']:.1%}, ")
                + f"device busy {rec['device_busy_ms']:.1f} ms a step (idle "
                  f"{rec['idle_share']:.0%}), peak "
                  f"{rec['peak_memory_gib']:.2f} GiB, SM "
                  f"{rec['sm_clock_mhz']['median']:.0f} MHz, "
                  f"{rec['power_w']['median']:.0f} W; launches "
                  f"{rec['kernel_launches']}",
            seconds=secs, name=name, result=rec)
        out[name] = rec["kernel_launches"]
    return out


# the step-diagnosis tools of phase 15, each run from the checkout in a
# process of its own
PROFILE_STEPS = 3
BREAKDOWN_BATCH = 8
PROFILE_KERNELS = {"K1": "K1 log-mel normalise", "K2": "K2 log-mel",
                   "K3": "K3 flash forward", "K4": "K4 flash backward"}


def _tool_line(cmd, timeout=300):
    """Run ``scripts/<cmd[0]>`` with ``cmd[1:]`` from the checkout: → its
    last JSON line and the seconds it took; a non-zero exit raises."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join("scripts", cmd[0]),
                           *cmd[1:]], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return (json.loads(proc.stdout.strip().splitlines()[-1]),
            time.perf_counter() - t0)


def phase15():
    """The step-diagnosis tools on the card: ``scripts/torch_profile_b16.py
    --steps 3`` (the ``retrieval`` step at fixed 10 s, B = 16, at
    ``CUT_DEPTH``, traced and attributed) and ``scripts/torch_block_breakdown.py`` at B = 8, each a
    process started from the checkout. The attribution's families sum to
    its ``device_ms_per_step`` within 1%; K1-K4 each have device time; busy
    plus idle equals the device span within 2% a step; at least 90% of
    the idle time is attributed to a named host op; K1-K4 launched in the
    untimed window, log-mel only at frame counts phase 2 checked. Every
    block module reads a finite time, none is an error record, and K3 and
    K4 launched. → each tool's launches."""
    import torch
    from speech_transcript_embeddings_torch.utils import bench as ub
    torch.cuda.empty_cache()
    build_dir = os.path.join(ROOT, REPO, "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        line, secs = _tool_line(["torch_profile_b16.py", "--steps",
                                 str(PROFILE_STEPS), "--out", tmp,
                                 *CUT_DEPTH])
        with open(line["written"]) as f:
            prof = json.load(f)
    fams = {r["family"]: r["ms_per_step"] for r in prof["by_family"]}
    dev, busy = prof["device_ms_per_step"], prof["device_busy_ms_per_step"]
    idle, span = prof["idle_ms_per_step"], prof["span_ms_per_step"]
    if abs(sum(fams.values()) - dev) > 0.01 * dev:
        raise AssertionError(f"families sum to {sum(fams.values())} ms, "
                             f"device time {dev} ms a step")
    if not all(fams.get(f, 0) > 0 for f in PROFILE_KERNELS.values()):
        raise AssertionError(f"a kernel of K1-K4 has no device time: {fams}")
    if abs(busy + idle - span) > 0.02 * span:
        raise AssertionError(f"busy {busy} + idle {idle} ms != span {span}")
    if prof["idle_attributed_share"] < 0.9:
        raise AssertionError(f"only {prof['idle_attributed_share']:.1%} of "
                             "the idle time attributed to a host op")
    ub.require_launches(prof["kernel_launches"], tuple(PROFILE_KERNELS))
    check_mel_frames(15, {int(k): v for k, v in
                          prof["log_mel_frames"].items()})
    top = prof["idle_gaps"]["by_outermost_op"][:3]
    log(15, f"scripts/torch_profile_b16.py --steps {PROFILE_STEPS} in "
            f"{secs:.1f} s: untraced step {prof['untraced_step_ms']:.1f} ms, "
            f"device busy {prof['device_busy_ms']:.1f}; traced "
            f"{dev:.1f} ms of kernels a step ({prof['kernels_per_step']:.0f} "
            f"launches), busy {busy:.1f}, idle {idle:.1f} of a "
            f"{span:.1f} ms span, {prof['idle_attributed_share']:.1%} "
            f"attributed; families " + ", ".join(
                f"{k} {v:.2f}" for k, v in fams.items())
            + "; top idle by outermost op: " + "; ".join(
                f"{r['op']} {r['ms_per_step']:.1f} ms" for r in top),
        seconds=secs, families=fams, device_ms_per_step=dev,
        busy_ms_per_step=busy, idle_ms_per_step=idle, span_ms_per_step=span,
        idle_attributed_share=prof["idle_attributed_share"],
        untraced_step_ms=prof["untraced_step_ms"],
        launches=prof["kernel_launches"])
    out = {"profile": prof["kernel_launches"]}
    line, secs = _tool_line(["torch_block_breakdown.py", "--batch",
                             str(BREAKDOWN_BATCH)])
    bad = [r for r in line["results"] if "error" in r or not all(
        math.isfinite(r[k]) and r[k] > 0 for k in ("fwd_ms", "fwd_bwd_ms"))]
    if bad or len(line["results"]) != 5:
        raise AssertionError(f"block breakdown: {line['results']}")
    ub.require_launches(line["kernel_launches"], ("K3", "K4"))
    log(15, f"scripts/torch_block_breakdown.py --batch {BREAKDOWN_BATCH} in "
            f"{secs:.1f} s: " + "; ".join(
                f"{r['what']} {r['fwd_ms']:.2f} / {r['fwd_bwd_ms']:.2f} ms"
                for r in line["results"])
            + f"; launches {line['kernel_launches']}",
        seconds=secs, results=line["results"],
        launches=line["kernel_launches"])
    out["block_breakdown"] = line["kernel_launches"]
    return out


# the ablation tools of phase 16, each run from the checkout at full width
ABLATION_ITERS = 5
SWEEP_SPECS = ("", "kStagesB=3", "kStagesA=2")   # the source and two specs


def _finite_positive(*values):
    return all(isinstance(x, (int, float)) and math.isfinite(x) and x > 0
               for x in values)


def phase16():
    """The ablation tools on the card, each a process started from the
    checkout at full width with ``--iters`` ``ABLATION_ITERS``:
    ``scripts/torch_depthwise_sweep.py`` (the two depthwise formulations:
    their parity error over max|out| within 2e-2, phase 6's bf16
    tolerance), ``scripts/torch_conv_ablate.py`` (the four conv-module
    variants, device time by kernel family), ``scripts/torch_flash_ablate.py``
    (its three kernel variants built with the bias switches, each held
    against the twins as the tool does: full with E; out, dk and dv with
    E = 0 with the bias off; out and every gradient with E = 0 and dE = 0
    with its gradient off too) and ``scripts/torch_flash_tile_sweep.py`` at
    ``SWEEP_SPECS`` (the source as it stands must hold the twin). Every
    time is finite and positive; K3 and K4 launched in both flash tools,
    counted from zero in their processes. The flash tools' kernel variants
    are built first, every nvcc at once, while the two conv tools run (a
    variant library is named by its source's hash, so the tools find them
    built). → each flash tool's launches."""
    from speech_transcript_embeddings_torch.ops import _build
    iters = ["--iters", str(ABLATION_ITERS)]
    variants, ablate = _script("torch_flash_bwd_times"), _script(
        "torch_flash_ablate")
    started = variants.start_variants(
        sorted({f for f, _ in ablate.VARIANTS.values()}), _build,
        ablate.FWD_SOURCE, ablate.HD) + variants.start_variants(
        sorted({b for _, b in ablate.VARIANTS.values()} | set(SWEEP_SPECS)),
        _build, ablate.BWD_SOURCE, ablate.HD)
    line, secs = _tool_line(["torch_depthwise_sweep.py", *iters])
    share = line["parity_max_err"] / line["max_abs_out"]
    times = [r[k] for r in line["results"]
             for k in ("fwd_ms", "fwd_bwd_ms", "fwd_device_ms",
                       "fwd_bwd_device_ms")]
    if not share <= 2e-2 or not _finite_positive(*times) or \
            len(line["results"]) != 2:
        raise AssertionError(f"depthwise sweep: parity {share:.2e} of "
                             f"max|out|, results {line['results']}")
    log(16, f"scripts/torch_depthwise_sweep.py in {secs:.1f} s: parity max "
            f"err {line['parity_max_err']:.4f} ({share:.1e} of max|out|, tol "
            "2e-2); " + "; ".join(
                f"{r['what']} fwd {r['fwd_ms']:.3f} ms (device "
                f"{r['fwd_device_ms']:.3f}), fwd+bwd {r['fwd_bwd_ms']:.3f} "
                f"({r['fwd_bwd_device_ms']:.3f})" for r in line["results"]),
        seconds=secs, result=line)
    line, secs = _tool_line(["torch_conv_ablate.py", *iters])
    rs = line["results"]
    if [r["what"] for r in rs] != ["full", "no_depthwise", "no_lns",
                                   "matmuls_only"] or not _finite_positive(
            *(r[k] for r in rs for k in ("ms", "device_ms"))) or not all(
            r["device_ms_by_family"] for r in rs):
        raise AssertionError(f"conv ablation: {rs}")
    log(16, f"scripts/torch_conv_ablate.py in {secs:.1f} s: " + "; ".join(
        f"{r['what']} {r['ms']:.3f} ms (device {r['device_ms']:.3f}: "
        + ", ".join(f"{f} {ms:.3f}" for f, ms in
                    r["device_ms_by_family"].items()) + ")" for r in rs),
        seconds=secs, result=line)
    from speech_transcript_embeddings_torch.utils import bench as ub
    t0 = time.perf_counter()
    variants.finish_variants(started)
    log(16, f"{len(started)} kernel variants built (waited "
            f"{time.perf_counter() - t0:.1f} s after the conv tools)")
    out = {}
    line, secs = _tool_line(["torch_flash_ablate.py", *iters])
    rs = line["results"]
    if [r["what"] for r in rs] != ["full", "no_bias_fwdside",
                                   "no_bias_no_dqe"] or not _finite_positive(
            *(r[k] for r in rs for k in ("fwd_bwd_ms", "fwd_bwd_device_ms",
                                         "flash_kernels_device_ms"))) or \
            not all(x <= 2e-2 for r in rs for x in r["max_rel_err"].values()):
        raise AssertionError(f"flash ablation: {rs}")
    ub.require_launches(line["kernel_launches"], ("K3", "K4"))
    log(16, f"scripts/torch_flash_ablate.py in {secs:.1f} s (B·h 512, t "
            f"499): " + "; ".join(
                f"{r['what']} fwd+bwd {r['fwd_bwd_ms']:.3f} ms (device "
                f"{r['fwd_bwd_device_ms']:.3f}, K3 + K4 "
                f"{r['flash_kernels_device_ms']:.3f}), against the twins "
                + ", ".join(f"{n} {x:.1e}" for n, x in
                            r["max_rel_err"].items()) for r in rs)
            + f"; bound {rs[0]['bound_ms']:.4f} ms; launches "
              f"{line['kernel_launches']}",
        seconds=secs, result=line)
    out["flash_ablate"] = line["kernel_launches"]
    specs = [a for spec in SWEEP_SPECS for a in ("--spec", spec)]
    line, secs = _tool_line(["torch_flash_tile_sweep.py", *iters, *specs])
    rs = {r["spec"]: r for r in line["results"]}
    src = rs[""]
    if "error" in src or not _finite_positive(
            src["fwd_bwd_ms"], src["fwd_bwd_device_ms"]) or not all(
            "error" in r or _finite_positive(r["fwd_bwd_ms"],
                                             r["fwd_bwd_device_ms"])
            for r in rs.values()):
        raise AssertionError(f"tile sweep: {line['results']}")
    ub.require_launches(line["kernel_launches"], ("K3", "K4"))
    log(16, f"scripts/torch_flash_tile_sweep.py in {secs:.1f} s: " + "; ".join(
        f"{spec or 'source'} " + (f"FAIL {r['error'][:80]}" if "error" in r
                                  else f"{r['fwd_bwd_ms']:.3f} ms (device "
                                       f"{r['fwd_bwd_device_ms']:.3f})")
        for spec, r in rs.items()) + f"; launches {line['kernel_launches']}",
        seconds=secs, result=line)
    out["tile_sweep"] = line["kernel_launches"]
    return out


def _profile_micro_step(phase, res):
    """One warm micro-step of a finished run's model at its longest train
    bucket, timed on the host clock and under torch.profiler (after the
    launch counts were read). The run dropped its optimizer moments for
    the test phase, so the step gets a fresh optimizer."""
    import torch
    from speech_transcript_embeddings_torch.training import train_step as ts
    from speech_transcript_embeddings_torch.utils.bench import device_trace
    cfg = res["cfg"]
    state = ts.create_train_state(res["state"].model, cfg, total_steps=1000)
    batch = max(res["pipeline"].epoch_batches(res["source"], "train", 1),
                key=lambda b: b["waveform"].shape[1])
    gen = torch.Generator("cuda").manual_seed(1)
    ts.train_step(cfg, state, res["frontend"], batch, gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ts.train_step(cfg, state, res["frontend"], batch, gen)
    torch.cuda.synchronize()
    plain_step_ms = (time.perf_counter() - t1) * 1e3
    with device_trace() as prof:
        t1 = time.perf_counter()
        ts.train_step(cfg, state, res["frontend"], batch, gen)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    # the collectives' kernels (NCCL's; none in one process)
    nccl = [(ms, c) for ms, k, c in rows if "nccl" in k.lower()]
    top = "; ".join(f"{k[:48]} x{c} {ms:.1f} ms" for ms, k, c in rows[:8])
    out = dict(samples=int(batch["waveform"].shape[1]),
               step_ms=plain_step_ms, profiled_step_ms=step_ms,
               device_busy_ms=busy, idle_share=1 - busy / plain_step_ms,
               collective_ms=sum(ms for ms, _ in nccl),
               collective_kernels=sum(c for _, c in nccl),
               # the port's own kernels a micro-step, by the trace
               kernel_calls={name: sum(c for _, k, c in rows if name in k)
                             for name in PORT_KERNELS})
    log(phase, f"one warm micro-step at {out['samples']} samples "
               f"(B={batch['waveform'].shape[0]}): {plain_step_ms:.1f} ms "
               f"(host clock, ends in a device sync), {step_ms:.1f} ms under "
               f"the profiler with device kernels busy {busy:.1f} ms (idle "
               f"{out['idle_share']:.0%} of the unprofiled step), NCCL "
               f"kernels {out['collective_ms']:.2f} ms in "
               f"{out['collective_kernels']} launches; the port's "
               f"kernels {out['kernel_calls']}; top device time: {top}",
        **out, top=[{"kernel": k, "calls": c, "ms": ms}
                    for ms, k, c in rows[:25]])
    del state
    return out


def log_mel_bound(n, mel_nnz, b=4, frame=400, hop=160, fft=512, mels=80):
    """Bounds of the two log-mel kernels at B clips of n samples, over the
    fp32 peak and 3.35 TB/s. The raw kernel by the least work of its
    function: per frame 5 FLOP a sample (DC removal, preemphasis, window),
    a real FFT of ``fft`` points (2.5·N·log2 N), 3 a bin for the power, 2
    per nonzero of the mel filter bank (``mel_nnz``) and 1 a mel bin for
    the log; its bytes are the waveform in and the log-mel out. The
    normalise kernel by its bytes (raw log-mel in, stacked features and
    mask out). Also the raw kernel's bound with the DFT counted as the
    dense fp32 matrix product the TPU computes (frames × 400 × 2·257, then
    the dense mel product): a note, not the least work."""
    frames = 1 + (n - frame) // hop
    bins = fft // 2 + 1
    fft_flop = 2.5 * fft * (fft.bit_length() - 1)
    raw_bytes = 4 * b * (n + frames * mels)
    raw = bound_ms(b * frames * (5 * frame + fft_flop + 3 * bins
                                 + 2 * mel_nnz + mels), raw_bytes, FP32_PEAK)
    dft_matmul = bound_ms(b * frames * (2 * frame * 2 * bins + 3 * bins
                                        + 2 * bins * mels),
                          raw_bytes, FP32_PEAK)
    norm = bound_ms(4 * b * frames * mels,
                    4 * b * (2 * frames * mels + frames // 2), FP32_PEAK)
    return raw, norm, dft_matmul


PHASE_SECONDS: dict = {}


def timed(n, phase):
    """``phase()``, its seconds recorded under ``n``."""
    t0 = time.perf_counter()
    try:
        return phase()
    finally:
        PHASE_SECONDS[n] = time.perf_counter() - t0


def _beside(fn):
    """Start ``fn()`` in a thread: → ``join``, which waits for it and
    returns its result or raises its exception."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as exc:
            box["err"] = exc

    thread = threading.Thread(target=run, name="phases-14-16")
    thread.start()

    def join():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["out"]
    return join


def main():
    import torch
    start = time.perf_counter()
    card = timed(0, phase0)
    timed(1, phase1)
    mel_err, mel_times = timed(2, phase2)
    flash_err, fwd_times = timed(3, phase3)
    serve_fp32, int8_small = timed(4, phase4)
    serve, serve_int8 = timed(5, phase5)
    bwd_err, bwd_abs_err, bwd_times = timed(6, phase6)
    ln_times = timed(17, phase17)
    dw_times = timed(18, phase18)
    train_fp32 = timed(7, phase7)
    train, warm_clips_per_s, int8_eval = timed(8, phase8)
    flagship, flagship_step, _ = timed(9, phase9)
    converted = timed(10, phase10)
    # phases 14-16 only run the tools' processes and read their JSON
    # lines: they run beside phases 11-13, whose time goes mostly to the
    # host (gloo copies, process starts, checkpoint writes)
    join = _beside(lambda: (timed(14, phase14), timed(15, phase15),
                            timed(16, phase16)))
    try:
        dp_fp32, dp, dp2 = timed(11, phase11)
        tp_small, tp = timed(12, phase12)
        proxy, proxy_step = timed(13, phase13)
    except BaseException:
        try:        # its processes end before this one does
            join()
        except BaseException as exc:
            print(f"phases 14-16 beside the failure: {exc!r}",
                  file=sys.stderr, flush=True)
        raise
    bench, tools, ablation = join()
    paths = {"int8_eval": int8_eval, "quality_proxy": proxy, "serve": serve, "serve_int8": serve_int8, "train": train,
             "flagship_train": flagship, "converted_train": converted,
             "dp_train": dp["launches"], "tp_train": tp["launches"],
             "tp_bf16": tp_small["bfloat16"], "bench": bench["bench"],
             "embed_bench": {k: bench["embed_bench"][k]
                             + bench["embed_bench_int8"][k]
                             for k in bench["embed_bench"]},
             "profile": tools["profile"],
             "block_breakdown": tools["block_breakdown"],
             "flash_ablate": ablation["flash_ablate"],
             "tile_sweep": ablation["tile_sweep"],
             "serve_fp32": serve_fp32,
             "train_fp32": train_fp32, "dp_fp32": dp_fp32,
             "tp_fp32": tp_small["float32"]}
    by_path = {name: {p: c.get(name, 0) for p, c in paths.items()}
               for name in train}
    at = MEL_SHAPES[-1]
    mel_at = f"B={at[0]}, {at[1]} samples"

    def by_shape(key):
        return {f"{b}x{n}": t[key] for (b, n), t in mel_times.items()}

    kernels = []
    for name, pre, line, err in (("log_mel", "raw", 70, mel_err["raw"]),
                                 ("log_mel_normalize", "norm", 141,
                                  mel_err["features"])):
        tm = mel_times[at]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{REPO}/csrc/log_mel.cu",
            "replaces": f"{TPU}/ops/frontend_pallas.py:{line}",
            "max_abs_err": err, "ms": tm[f"{pre}_ms"],
            "plain_ms": tm[f"{pre}_plain_ms"], "bound_ms": tm[f"{pre}_bound_ms"],
            "bound_by": tm[f"{pre}_bound_by"], "library_ms": None,
            "at": mel_at, "ms_by_shape": by_shape(f"{pre}_ms"),
            "bound_ms_by_shape": by_shape(f"{pre}_bound_ms"),
            "plain_ms_by_shape": by_shape(f"{pre}_plain_ms")})
    kernels[0]["cufft_composite_ms_not_one_call"] = by_shape(
        "cufft_composite_ms_not_one_call")
    kernels[0]["bound_ms_dft_as_dense_matmul"] = \
        mel_times[at]["raw_bound_ms_dft_as_dense_matmul"]
    # the flash kernels: the tensor-core pair carries the bf16 main paths;
    # the CUDA-core pair the fp32 ones, whose launches are
    # counted on phases 4 and 7; every time at the bf16 main-path shape
    fwd_at, bwd_at = (64, 1536), (256, 768)
    for name, route_key, errs, times, at, line in (
            ("flash_rel_fwd_wgmma", "ms", flash_err["mma"], fwd_times, fwd_at,
             237),
            ("flash_rel_fwd", "simt_ms", flash_err["simt"], fwd_times, fwd_at,
             237),
            ("flash_rel_bwd_wgmma", "ms", bwd_abs_err["mma"], bwd_times, bwd_at,
             278),
            ("flash_rel_bwd", "simt_ms", bwd_abs_err["simt"], bwd_times,
             bwd_at, 278)):
        src = {"flash_rel_fwd_wgmma": "flash_rel_fwd_sm90.cu",
               "flash_rel_fwd": "flash_rel_fwd.cu",
               "flash_rel_bwd_wgmma": "flash_rel_bwd_sm90.cu",
               "flash_rel_bwd": "flash_rel_bwd.cu"}[name]
        tm = times[at]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{REPO}/csrc/{src}",
            "replaces": f"{TPU}/ops/flash_attention.py:{line}",
            "max_abs_err": errs, "ms": tm[route_key],
            "call_ms_back_to_back": tm[route_key.replace("ms", "call_ms")],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": None,
            "sdpa_ms_not_the_same_function": tm["sdpa_ms"],
            "at": f"bf16, B·h {at[0]}, t_pad {at[1]}, hd 64",
            "ms_by_shape": {f"{bh}x{t}": v[route_key]
                            for (bh, t), v in times.items()}})
    # the LayerNorm kernels replace no TPU kernel: every time at the embed
    # cell's [64, 512, 1024] bf16
    ln_at = "x".join(map(str, LN_SHAPES[0]))
    for name, d in (("layer_norm_fwd", "fwd"), ("layer_norm_bwd_dx", "bwd")):
        tm = ln_times[ln_at]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{REPO}/csrc/layer_norm.cu",
            "replaces": None, "max_err_bf16_steps": tm["max_err"],
            "ms": tm[f"{d}_ms"], "call_ms_back_to_back": tm[f"{d}_call_ms"],
            "plain_ms": tm[f"plain_{d}_ms"], "bound_ms": tm[f"{d}_bound_ms"],
            "bound_by": tm[f"{d}_bound_by"],
            "library_ms": tm[f"library_{d}_ms"],
            "at": f"bf16 [{ln_at.replace('x', ', ')}], fp32 γ, β",
            "ms_by_shape": {k: v[f"{d}_ms"] for k, v in ln_times.items()}})
    # dγ and dβ: the partial rows' sum, launched right after dx where γ or
    # β trains; its time is inside layer_norm_bwd_dx's ms (the affine
    # backward), and the frozen backward's time is dx alone
    tm = ln_times[ln_at]
    kernels.append({
        "name": "layer_norm_bwd_dgamma", "route": "cuda",
        "source": f"{REPO}/csrc/layer_norm.cu", "replaces": None,
        "max_rel_err": {k: tm["max_err"][k] for k in ("dgamma", "dbeta")},
        "ms": None, "ms_inside": "layer_norm_bwd_dx",
        "bwd_ms_minus_frozen_bwd_ms": tm["bwd_ms"] - tm["bwd_frozen_ms"],
        "at": f"bf16 [{ln_at.replace('x', ', ')}], fp32 γ, β"})
    # the depthwise GLU kernels replace no TPU kernel: every time at the
    # embed cell's [64, 512, 1024] bf16; the weight gradient's sum is
    # inside the backward's ms, the frozen backward is dx alone
    dw_at = "x".join(map(str, DW_SHAPES[0]))
    tm = dw_times[dw_at]
    for name, d in (("depthwise_glu_fwd", "fwd"),
                    ("depthwise_glu_bwd_dx", "bwd"),
                    ("depthwise_glu_bwd_dw", None)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{REPO}/csrc/depthwise_glu.cu", "replaces": None,
            "max_err_bf16_steps": tm["max_err"],
            **({"ms": tm[f"{d}_ms"],
                "call_ms_back_to_back": tm[f"{d}_call_ms"],
                "plain_ms": tm[f"plain_{d}_ms"],
                "bound_ms": tm[f"{d}_bound_ms"],
                "bound_by": tm[f"{d}_bound_by"], "library_ms": None,
                "ms_by_shape": {s_: v[f"{d}_ms"]
                                for s_, v in dw_times.items()}}
               if d else {"ms": None, "ms_inside": "depthwise_glu_bwd_dx",
                          "bwd_ms_minus_frozen_bwd_ms":
                              tm["bwd_ms"] - tm["bwd_frozen_ms"]}),
            "at": f"bf16 [{dw_at.replace('x', ', ')}], K 31, fp32 weight"})
    for k in kernels:
        k["launches_by_path"] = by_path[k["name"]]
        main_path = ("serve", "serve_int8", "train", "flagship_train",
                     "converted_train", "dp_train", "tp_train", "tp_bf16",
                     "int8_eval", "quality_proxy", "bench", "embed_bench",
                     "profile", "block_breakdown", "flash_ablate",
                     "tile_sweep") \
            if k["name"] not in ("flash_rel_fwd", "flash_rel_bwd") else (
                "serve_fp32", "train_fp32", "dp_fp32", "tp_fp32")
        k["launches"] = sum(by_path[k["name"]][p] for p in main_path)
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on its path")
    if any(m.split(".")[0] in ("jax", "flax", TPU) for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels,
                   "flash_bwd_max_rel_err": bwd_err,
                   "log_mel_times": {f"{b}x{n}": v for (b, n), v in
                                     mel_times.items()},
                   "flash_fwd_times": {f"{bh}x{t}": v for (bh, t), v in
                                       fwd_times.items()},
                   "flash_bwd_times": {f"{bh}x{t}": v for (bh, t), v in
                                       bwd_times.items()},
                   "train_warm_clips_per_s": warm_clips_per_s,
                   "int8_products": {"small_model": int8_small,
                                     "serve_int8": serve_int8[
                                         "int8_products"],
                                     "int8_eval": int8_eval["int8_matmul"]},
                   "quality_proxy_micro_step": proxy_step,
                   "flagship_micro_step": flagship_step,
                   "dp_micro_step_world_1": dp["step"],
                   "dp_all_reduce_world_1": dp["all_reduce"],
                   "dp_two_rank_gloo": dp2, "tp_two_rank_gloo": tp,
                   "phase_seconds": {**PHASE_SECONDS,
                                     "total": time.perf_counter() - start},
                   **RECORD},
                  f, indent=1)
    print("phase seconds: " + ", ".join(
        f"{n}: {t:.1f}" for n, t in sorted(PHASE_SECONDS.items()))
        + f" (14-16 beside 11-13); total {time.perf_counter() - start:.1f}",
        flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(sys.argv[2], sys.argv[3])
    else:
        main()
