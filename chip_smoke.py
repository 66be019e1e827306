#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port, on one GPU: serving and
training.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``speech_transcript_embeddings_torch/
csrc`` (nvcc, sm_90a) and holds each against its plain PyTorch twin at the
shapes the serving and training paths give it: log-mel (phase 2), the flash
forward (phase 3) and backward (phase 6). Runs a small model on the GPU
(kernels) and on the CPU (twins) with the same seeded weights, for serving
(phase 4) and for one optimizer step (phase 7). Serves the full-width
``retrieval_model_config()`` model (random weights from a seed) through the
port's HTTP service (phase 5), then trains it through the port's CLI,
``preset=retrieval`` for one epoch on synthetic clips, and serves the
trained ``final_model`` (phase 8). Phases 5 and 8 check that their path went
through every kernel. Each phase prints a line per check; any failure
raises and exits non-zero. Detailed numbers go to
``chiprun_out/chip_smoke.json``. The last line is the JSON result.
"""

from __future__ import annotations

import copy
import json
import os
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
    log(0, f"card {smi}; torch {torch.__version__} (CUDA "
           f"{torch.version.cuda}); {torch.cuda.device_count()} device(s)",
        card=smi, torch=torch.__version__, cuda=torch.version.cuda)
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


def phase2():
    import torch
    from speech_transcript_embeddings_torch.config import FrontendConfig
    from speech_transcript_embeddings_torch.ops import frontend as fe
    from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
    cfg = FrontendConfig(use_pallas=True)
    front = fk.KernelLogMelFrontend(cfg).cuda()
    g = torch.Generator().manual_seed(2)
    worst = {"raw": 0.0, "features": 0.0}
    times = {}
    for n in BUCKETS:
        lens = torch.tensor([n, int(n * 0.71), int(n * 0.33), 399],
                            dtype=torch.int32)
        wav = torch.randn(4, n, generator=g) * 0.1
        wav *= torch.arange(n)[None, :] < lens[:, None]
        wav, lens = wav.cuda(), lens.cuda()
        raw = front.raw_log_mel(wav)
        ref_raw = fe.log_mel_reference(cfg, wav, front.transform, front.mel)
        valid = fe.num_valid_frames(cfg, lens)
        vmask = torch.arange(raw.shape[1], device="cuda")[None, :] < valid[:, None]
        raw_err = (raw - ref_raw).abs()[vmask].max().item()
        torch.testing.assert_close(raw[vmask], ref_raw[vmask], rtol=2e-4,
                                   atol=2e-4)
        feats, mask = front.normalize_and_stack(raw, lens)
        ref_feats, ref_mask = fe.normalize_and_stack_reference(cfg, raw, lens)
        if not torch.equal(mask, ref_mask):
            raise AssertionError(f"log-mel mask differs at bucket {n}")
        feat_err = (feats - ref_feats).abs().max().item()
        torch.testing.assert_close(feats, ref_feats, rtol=2e-3, atol=2e-3)
        if not (torch.isfinite(feats).all() and feats[3].abs().max() == 0):
            raise AssertionError("non-finite features or a sub-frame clip "
                                 "with non-zero features")
        t = {
            "raw_ms": cuda_ms(lambda: front.raw_log_mel(wav)),
            "raw_plain_ms": cuda_ms(lambda: fe.log_mel_reference(
                cfg, wav, front.transform, front.mel)),
            "norm_ms": cuda_ms(lambda: front.normalize_and_stack(raw, lens)),
            "norm_plain_ms": cuda_ms(lambda: fe.normalize_and_stack_reference(
                cfg, raw, lens)),
        }
        times[n] = t
        worst["raw"] = max(worst["raw"], raw_err)
        worst["features"] = max(worst["features"], feat_err)
        log(2, f"bucket {n} B=4 frames {raw.shape[1]}: raw err {raw_err:.2e} "
               f"(tol 2e-4), features err {feat_err:.2e} (tol 2e-3), mask "
               f"exact; log-mel kernel {t['raw_ms']:.3f} ms vs plain "
               f"{t['raw_plain_ms']:.3f} ms, normalise kernel "
               f"{t['norm_ms']:.3f} ms vs plain {t['norm_plain_ms']:.3f} ms",
            bucket=n, frames=raw.shape[1], raw_err=raw_err,
            feat_err=feat_err, **t)
    return worst, times


def phase3():
    import torch
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(3)
    nh, hd, left, right, b = 16, 64, 64, 8, 2
    worst, times = {}, {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        name = str(dtype).split(".")[-1]
        for t in T_PADS:
            q, k, v = (torch.randn(b * nh, t, hd, generator=g).to("cuda", dtype)
                       for _ in range(3))
            e = (torch.randn(left + right + 1, hd, generator=g) * 0.02
                 ).to("cuda", dtype)
            mask = (torch.arange(t)[None, :]
                    < torch.tensor([[t], [int(t * 0.6)]])).to("cuda")
            kw = dict(num_heads=nh, left_max=left)
            out, lse = fa.flash_attention_fwd(q, k, v, e, mask, **kw)
            ref, ref_lse = fa.rel_attention_reference(q, k, v, e, mask, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-3)
            ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, e, mask, **kw))
            plain_ms = cuda_ms(lambda: fa.rel_attention_reference(
                q, k, v, e, mask, **kw))
            worst[name] = max(worst.get(name, 0.0), err)
            times[(name, t)] = (ms, plain_ms)
            log(3, f"flash {name} t_pad {t} B=2 h=16 hd=64: err {err:.2e} "
                   f"(tol {tol:g}), lse err {lse_err:.2e}; kernel {ms:.3f} ms "
                   f"vs plain {plain_ms:.3f} ms",
                dtype=name, t_pad=t, err=err, lse_err=lse_err, ms=ms,
                plain_ms=plain_ms)
    return worst, times


def _max_rel_err(a, b):
    """max|a − b| / max|b| (fp32)."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def phase6():
    """Flash backward (K4) against its plain twin: fwd+bwd at every T_PADS in
    bf16 and fp32, plus hd 128, a clip with no valid frame and the training
    shape (B 16, t_pad 768); times K4 alone and fwd+bwd against the twin's
    fwd+bwd. Tolerance: max error over max|twin| per gradient, 2e-2 in bf16
    and 1e-4 in fp32 (phase 3's forward tolerances)."""
    import torch
    from speech_transcript_embeddings_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(6)
    left, right = 64, 8
    cases = [(dt, t, 2, 16, 64, "ragged") for dt in ("bfloat16", "float32")
             for t in T_PADS]
    cases += [("bfloat16", 512, 2, 8, 128, "ragged"),
              ("float32", 512, 2, 8, 128, "ragged"),
              ("bfloat16", 256, 2, 16, 64, "zero_length"),
              ("float32", 256, 2, 16, 64, "zero_length"),
              ("bfloat16", 768, 16, 16, 64, "ragged")]   # the training shape
    tols = {"bfloat16": 2e-2, "float32": 1e-4}
    worst, worst_abs, times = {}, {}, {}
    for name, t, b, nh, hd, kind in cases:
        dtype = getattr(torch, name)
        q, k, v, dout = (torch.randn(b * nh, t, hd, generator=g).to(
            "cuda", dtype) for _ in range(4))
        e = (torch.randn(left + right + 1, hd, generator=g) * 0.3).to(
            "cuda", dtype)
        lens = [t] + [0 if kind == "zero_length" else int(t * 0.6)] * (b - 1)
        mask = (torch.arange(t)[None, :] < torch.tensor(lens)[:, None]
                ).to("cuda")
        kw = dict(num_heads=nh, left_max=left)
        out, lse = fa.flash_attention_fwd(q, k, v, e, mask, **kw)
        got = fa.flash_attention_bwd(q, k, v, e, mask, out, lse, dout, **kw)
        ref = fa.rel_attention_bwd_reference(q, k, v, e, mask, out, lse,
                                             dout, **kw)
        torch.cuda.synchronize()
        errs = {}
        for gname, a, r in zip(("dq", "dk", "dv", "dE"), got, ref):
            if a.dtype != r.dtype or a.shape != r.shape or \
                    not torch.isfinite(a).all():
                raise AssertionError(f"flash bwd {gname}: {a.dtype} "
                                     f"{tuple(a.shape)} vs {r.dtype} "
                                     f"{tuple(r.shape)}, or not finite")
            errs[gname] = _max_rel_err(a, r)
            worst_abs[name] = max(worst_abs.get(name, 0.0), (
                a.float() - r.float()).abs().max().item())
            if errs[gname] > tols[name]:
                raise AssertionError(
                    f"flash bwd {gname} {name} t {t} hd {hd} {kind}: max "
                    f"error {errs[gname]:.2e} of max|ref| > {tols[name]}")
        bwd_ms = cuda_ms(lambda: fa.flash_attention_bwd(
            q, k, v, e, mask, out, lse, dout, **kw), iters=10)
        bwd_plain_ms = cuda_ms(lambda: fa.rel_attention_bwd_reference(
            q, k, v, e, mask, out, lse, dout, **kw), iters=5, warmup=1)

        def both(fwd, bwd):
            o, l = fwd(q, k, v, e, mask, **kw)
            bwd(q, k, v, e, mask, o, l, dout, **kw)
        fb_ms = cuda_ms(lambda: both(fa.flash_attention_fwd,
                                     fa.flash_attention_bwd), iters=10)
        fb_plain_ms = cuda_ms(lambda: both(fa.rel_attention_reference,
                                           fa.rel_attention_bwd_reference),
                              iters=5, warmup=1)
        worst[name] = max(worst.get(name, 0.0), *errs.values())
        times[(name, t, b, hd, kind)] = (bwd_ms, bwd_plain_ms)
        log(6, f"flash bwd {name} t_pad {t} B={b} h={nh} hd={hd} {kind}: "
               f"max err/max|ref| dq {errs['dq']:.1e} dk {errs['dk']:.1e} "
               f"dv {errs['dv']:.1e} dE {errs['dE']:.1e} (tol "
               f"{tols[name]:g}); K4 {bwd_ms:.3f} ms vs plain "
               f"{bwd_plain_ms:.3f} ms; fwd+bwd kernels {fb_ms:.3f} ms vs "
               f"plain {fb_plain_ms:.3f} ms",
            dtype=name, t_pad=t, B=b, heads=nh, hd=hd, kind=kind, errs=errs,
            bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, fwd_bwd_ms=fb_ms,
            fwd_bwd_plain_ms=fb_plain_ms)
        del q, k, v, dout, out, lse, got, ref
        torch.cuda.empty_cache()
    return worst, worst_abs, times


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
    errs = [float(np.abs(gpu.embed_texts(texts) - cpu.embed_texts(texts)).max())]
    for clips in batches:
        a, b = gpu.embed_audios(clips), cpu.embed_audios(clips)
        if not np.isfinite(a).all():
            raise AssertionError("non-finite small-config embeddings")
        errs.append(float(np.abs(a - b).max()))
    worst = max(errs)
    if worst > 1e-4:
        raise AssertionError(f"GPU (kernels) vs CPU (twins) embeddings differ "
                             f"by {worst:.2e} > 1e-4: {errs}")
    log(4, f"small f32 model (2 layers, audio 256/4 heads, text 128): GPU "
           f"kernels vs CPU twins max err {worst:.2e} (tol 1e-4) over texts "
           f"and buckets 41200/164080/491760", errs=errs)


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
    build_dir = os.path.join(ROOT, REPO, "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = os.path.join(tmp, "retrieval_seed0")
        checkpoints.save_checkpoint(path, model, cfg, info={"seed": 0})
        del model
        torch.cuda.empty_cache()
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
    fa.flash_attention_fwd.launches = 0
    try:
        status, body, lat["healthz"] = _request(url + "/healthz")
        if status != 200 or body["projection_dim"] != 768:
            raise AssertionError(f"/healthz: {status} {body}")
        for tag in ("cold", "warm"):
            status, body, lat[f"embed_text_4_{tag}"] = _request(
                url + "/embed_text", {"texts": texts})
            _check_embs(body, 4, "/embed_text")
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
            _check_embs(body, 16, "/embed_audio x16")
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
                "flash_rel_fwd": fa.flash_attention_fwd.launches}
    by_frames = dict(fk.log_mel.launches_by_frames)
    layers = cfg.model.audio.num_layers
    if launches["flash_rel_fwd"] != layers * audio_forwards:
        raise AssertionError(f"flash launched {launches['flash_rel_fwd']} "
                             f"times for {audio_forwards} audio forwards of "
                             f"{layers} blocks")
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
    _breakdown(service.embedder, {"16 clips of 4.7 s": batch16,
                                  "3 clips, 30 s bucket": [short, mid, long_]},
               lat)
    log(5, f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
           f" GiB", peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return launches


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


def _breakdown(embedder, batches, lat):
    """Where a warm audio request's time goes: the Embedder alone (no HTTP,
    no JSON; host clock over a call that ends in a device sync) and one
    forward's device kernels by name (torch.profiler). Runs after the
    launch counts were read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    http = {"16 clips of 4.7 s": lat["embed_audio_16x4.7s_warm"],
            "3 clips, 30 s bucket": lat["embed_audio_3_warm"]}
    for name, clips in batches.items():
        embedder.embed_audios(clips)
        t0 = time.perf_counter()
        for _ in range(3):
            embedder.embed_audios(clips)
        direct = (time.perf_counter() - t0) / 3 * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            embedder.embed_audios(clips)
            wall = (time.perf_counter() - t0) * 1e3
        rows = _device_rows(prof)
        busy = sum(r[0] for r in rows)
        top = "; ".join(f"{k[:48]} x{c} {ms:.1f} ms" for ms, k, c in rows[:6])
        log(5, f"{name}: HTTP request {http[name]:.1f} ms, Embedder alone "
               f"{direct:.1f} ms, profiled forward {wall:.1f} ms with device "
               f"kernels busy {busy:.1f} ms (idle {1 - busy / wall:.0%}); top "
               f"device time: {top}",
            batch=name, http_ms=http[name], direct_ms=direct,
            profiled_wall_ms=wall, device_busy_ms=busy,
            idle_share=1 - busy / wall,
            top=[{"kernel": k, "calls": c, "ms": ms} for ms, k, c in rows[:25]])


ZERO_GRAD_LEAVES = (".key.bias", "pooling.score_out.bias")


def _train_cfg_small():
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
        heads=HeadsConfig(projection_dim=128, use_cross_modal=False,
                          use_word_alignment=False),
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
    """One optimizer step (accumulation 2, global loss) of a small fp32
    model with flash attention under save_hot2 remat, on the GPU (kernels,
    TF32 off) and on the CPU (twins), from the same weights and batches,
    dropout off. Tolerances: loss and grad norm rtol 1e-4; the first
    micro-batch's gradient, per trainable leaf, within 1e-3 of the leaf's
    largest element (the leaves whose exact gradient is 0, below 1e-4 of the
    largest gradient of the model); each updated leaf 99.9% of elements
    within 1e-5 (not those zero-gradient leaves, whose noise Adam scales to
    ±lr) and all within 2·lr — Adam's first step moves a weight by
    ≈lr·sign(g), so an element whose gradient is rounding noise may flip;
    frozen leaves bit-identical."""
    import numpy as np
    import torch
    from speech_transcript_embeddings_torch.data import (
        DataPipeline, SimpleWordTokenizer, SyntheticSource,
    )
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    from speech_transcript_embeddings_torch.ops import make_frontend
    from speech_transcript_embeddings_torch.training import losses
    from speech_transcript_embeddings_torch.training import train_step as ts
    cfg = _train_cfg_small()
    pipe = DataPipeline(cfg.data, SimpleWordTokenizer(vocab_size=1000),
                        seed=0)
    batches = list(pipe.epoch_batches(SyntheticSource(cfg.data, seed=3),
                                      "train", 1))[:2]
    model = init_model(cfg.model, torch.Generator().manual_seed(7),
                       train=True)
    runs = {}
    for device in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(device)
        state = ts.create_train_state(m, cfg, total_steps=4)
        frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
        frontend = make_frontend(cfg.model.frontend).to(device)
        out = state.model.forward_pos_neg(ts.model_batch_from_host(
            frontend, batches[0], device), None)
        grads = torch.autograd.grad(
            losses.compute_loss(cfg.loss, out)[0],
            list(state.trainable.values()), allow_unused=True)
        grads = {k: (torch.zeros_like(p) if g is None else g).cpu()
                 for (k, p), g in zip(state.trainable.items(), grads)}
        metrics = [{k: float(v) for k, v in ts.train_step(
            cfg, state, frontend, b, None).items()} for b in batches]
        if state.optimizer.count != 1:
            raise AssertionError(f"{state.optimizer.count} updates after two "
                                 "micro-steps at accumulation 2")
        for k, p in state.frozen.items():
            if not torch.equal(p, frozen0[k]):
                raise AssertionError(f"frozen {k} changed on {device}")
        runs[device] = (metrics, {k: p.detach().cpu() for k, p in
                                  state.trainable.items()}, grads)
    init = dict(model.named_parameters())
    errs = {}
    for key in ("loss", "grad_norm"):
        for i, (g, c) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
            errs[f"{key}_{i}"] = abs(g[key] - c[key]) / abs(c[key])
            if not np.isfinite(g[key]) or errs[f"{key}_{i}"] > 1e-4:
                raise AssertionError(f"micro-step {i} {key}: GPU {g[key]} vs "
                                     f"CPU {c[key]}")
    g_cpu, g_gpu = runs["cpu"][2], runs["cuda"][2]
    g_max = max(g.abs().max().item() for g in g_cpu.values())
    grad_err = 0.0
    for k, c in g_cpu.items():
        d = (g_gpu[k] - c).abs().max().item()
        if k.endswith(ZERO_GRAD_LEAVES):
            if max(c.abs().max().item(), g_gpu[k].abs().max().item()) \
                    > 1e-4 * g_max:
                raise AssertionError(f"gradient of {k} is not ≈0")
            continue
        c_max = c.abs().max().item()      # 0 for a leaf the loss never reads
        grad_err = max(grad_err, d / c_max if c_max else d)
        if d > 1e-3 * c_max:
            raise AssertionError(f"gradient of {k}: GPU vs CPU max diff "
                                 f"{d:.2e} of max {c.abs().max().item():.2e}")
    lr = cfg.optimizer.learning_rate
    worst, moved, far = 0.0, 0, 0.0
    for k, c in runs["cpu"][1].items():
        g = runs["cuda"][1][k]
        diff = (g - c).abs()
        worst = max(worst, diff.max().item())
        share = (diff > 1e-5).float().mean().item()
        if k.endswith(ZERO_GRAD_LEAVES):
            share = 0.0     # Adam scales their gradient noise to ±lr
        far = max(far, share)
        if diff.max() > 2 * lr or share > 1e-3:
            raise AssertionError(f"updated {k}: GPU vs CPU max diff "
                                 f"{diff.max().item():.2e}, share beyond 1e-5 "
                                 f"{share:.1e}")
        moved += not torch.equal(g, init[k].detach())
    if moved < 0.9 * len(runs["cpu"][1]):
        raise AssertionError(f"only {moved} of {len(runs['cpu'][1])} "
                             "trainable leaves moved")
    log(7, f"small f32 model, accumulation 2, global loss, save_hot2 remat: "
           f"GPU (kernels) vs CPU (twins) loss/grad-norm rel err "
           f"{max(errs.values()):.1e} (tol 1e-4), gradient max err/max per "
           f"leaf {grad_err:.1e} (tol 1e-3), updated params max diff "
           f"{worst:.1e} (bound 2·lr = {2 * lr:g}), share beyond 1e-5 "
           f"{far:.1e} (tol 1e-3), {moved}/{len(runs['cpu'][1])} trainable "
           f"leaves moved, frozen unchanged",
        errs=errs, grad_err=grad_err, param_max_diff=worst,
        share_beyond_1e5=far, moved=moved,
        gpu=runs["cuda"][0], cpu=runs["cpu"][0])


N_PARAMS = 863_886_658
N_TRAINABLE = 354_846_082


def phase8():
    """Full-width ``preset=retrieval`` training through the port's CLI, in
    process, on synthetic CV-length clips: one epoch of micro-batches of 16
    at accumulation 4, validation, the final_model checkpoint, which the
    serving path loads. Checks the parameter split, finite losses, the
    frozen split untouched, the trainable split moved, and that every
    micro-step ran the kernels (K4 24 times, K3 24 times with no remat
    replay, the log-mel kernels once per batch)."""
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
    from torch.profiler import ProfilerActivity, profile
    build_dir = os.path.join(ROOT, REPO, "_build")
    os.makedirs(build_dir, exist_ok=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        argv = ["preset=retrieval", "device=cuda",
                "data.synthetic_length_profile=cv", "train.num_epochs=1",
                "optimizer.warmup_steps=1", f"train.output_dir={tmp}/run"]
        # every count starts at zero just before the main path runs
        fk.log_mel.launches = 0
        fk.log_mel.launches_by_frames.clear()
        fk.normalize_and_stack.launches = 0
        fa.flash_attention_fwd.launches = 0
        fa.flash_attention_bwd.launches = 0
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"log_mel": fk.log_mel.launches,
                    "log_mel_normalize": fk.normalize_and_stack.launches,
                    "flash_rel_fwd": fa.flash_attention_fwd.launches,
                    "flash_rel_bwd": fa.flash_attention_bwd.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        cfg, state = res["cfg"], res["state"]
        ep = res["epochs"][0]
        micro, n_eval = ep["train_batches"], ep["eval_batches"]
        layers = cfg.model.audio.num_layers
        if cfg.model.audio.remat_policy != "save_hot2" or not cfg.model.remat:
            raise AssertionError(f"preset=retrieval remat: {cfg.model.remat} "
                                 f"{cfg.model.audio.remat_policy}")
        want = {"flash_rel_bwd": layers * micro,
                "flash_rel_fwd": layers * (micro + n_eval),
                "log_mel": micro + n_eval, "log_mel_normalize": micro + n_eval}
        if launches != want:
            raise AssertionError(f"launches {launches} != {want} for {micro} "
                                 f"micro-steps and {n_eval} eval batches")
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

        # one warm micro-step under the profiler (after the counts were read)
        batch = max(res["pipeline"].epoch_batches(res["source"], "train", 1),
                    key=lambda b: b["waveform"].shape[1])
        gen = torch.Generator("cuda").manual_seed(1)
        ts.train_step(cfg, state, res["frontend"], batch, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ts.train_step(cfg, state, res["frontend"], batch, gen)
        torch.cuda.synchronize()
        plain_step_ms = (time.perf_counter() - t1) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            ts.train_step(cfg, state, res["frontend"], batch, gen)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t1) * 1e3
        rows = _device_rows(prof)
        busy = sum(r[0] for r in rows)
        top = "; ".join(f"{k[:48]} x{c} {ms:.1f} ms" for ms, k, c in rows[:8])
        log(8, f"one warm micro-step at {batch['waveform'].shape[1]} samples "
               f"(B={batch['waveform'].shape[0]}): {plain_step_ms:.1f} ms "
               f"(host clock, ends in a device sync), {step_ms:.1f} ms under "
               f"the profiler with device kernels busy {busy:.1f} ms (idle "
               f"{1 - busy / plain_step_ms:.0%} of the unprofiled step); top "
               f"device time: {top}",
            samples=int(batch["waveform"].shape[1]),
            step_ms=plain_step_ms, profiled_step_ms=step_ms,
            device_busy_ms=busy, idle_share=1 - busy / plain_step_ms,
            top=[{"kernel": k, "calls": c, "ms": ms} for ms, k, c in rows[:25]])
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
    return launches, warm


def main():
    import torch
    card = phase0()
    phase1()
    mel_err, mel_times = phase2()
    flash_err, flash_times = phase3()
    phase4()
    serve = phase5()
    bwd_err, bwd_abs_err, bwd_times = phase6()
    phase7()
    train, warm_clips_per_s = phase8()
    by_path = {name: {"serve": serve.get(name, 0), "train": train[name]}
               for name in train}
    launches = {name: sum(v.values()) for name, v in by_path.items()}
    big = BUCKETS[-1]
    train_shape = ("bfloat16", 768, 16, 64, "ragged")
    kernels = [
        {"name": "log_mel", "route": "cuda", "source": f"{REPO}/csrc/log_mel.cu",
         "replaces": f"{TPU}/ops/frontend_pallas.py:70",
         "launches": launches["log_mel"], "max_abs_err": mel_err["raw"],
         "ms": mel_times[big]["raw_ms"],
         "plain_ms": mel_times[big]["raw_plain_ms"],
         "at": f"B=4, {big} samples"},
        {"name": "log_mel_normalize", "route": "cuda",
         "source": f"{REPO}/csrc/log_mel.cu",
         "replaces": f"{TPU}/ops/frontend_pallas.py:141",
         "launches": launches["log_mel_normalize"],
         "max_abs_err": mel_err["features"], "ms": mel_times[big]["norm_ms"],
         "plain_ms": mel_times[big]["norm_plain_ms"],
         "at": f"B=4, {big} samples"},
        {"name": "flash_rel_fwd", "route": "cuda",
         "source": f"{REPO}/csrc/flash_rel_fwd.cu",
         "replaces": f"{TPU}/ops/flash_attention.py:237",
         "launches": launches["flash_rel_fwd"],
         "max_abs_err": flash_err["bfloat16"],
         "ms": flash_times[("bfloat16", 1536)][0],
         "plain_ms": flash_times[("bfloat16", 1536)][1],
         "at": "bf16, B=2, 16 heads, t_pad 1536, hd 64"},
        {"name": "flash_rel_bwd", "route": "cuda",
         "source": f"{REPO}/csrc/flash_rel_bwd.cu",
         "replaces": f"{TPU}/ops/flash_attention.py:278",
         "launches": launches["flash_rel_bwd"],
         "max_abs_err": bwd_abs_err["bfloat16"],
         "ms": bwd_times[train_shape][0], "plain_ms": bwd_times[train_shape][1],
         "at": "bf16, B=16, 16 heads, t_pad 768, hd 64 (the training shape)"},
    ]
    for k in kernels:
        k["launches_by_path"] = by_path[k["name"]]
    if any(m.split(".")[0] in ("jax", "flax") for m in sys.modules):
        raise AssertionError("jax was imported")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels,
                   "flash_bwd_max_rel_err": bwd_err,
                   "train_warm_clips_per_s": warm_clips_per_s, **RECORD},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
