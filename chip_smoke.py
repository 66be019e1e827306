#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port's serving path, on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``speech_transcript_embeddings_torch/
csrc`` (nvcc, sm_90a), holds each against its plain PyTorch twin at the
shapes the serving path gives it, runs a small model on the GPU (kernels)
and on the CPU (twins) with the same seeded weights, then serves the
full-width ``retrieval_model_config()`` model (random weights from a seed)
through the port's HTTP service and checks its answers and that the main
path went through every kernel. Each phase prints one line; any failure
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
    log(5, f"retrieval_model_config: {n_params / 1e6:.1f}M params in "
           f"{cfg.model.dtype}, init + save + load {setup_s:.1f} s",
        params=n_params, setup_s=setup_s)
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
        rows = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue        # host ops; their kernels are counted below
            dev = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
            if dev > 0:
                rows.append((dev / 1e3, e.key, e.count))
        rows.sort(reverse=True)
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


def main():
    import torch
    card = phase0()
    phase1()
    mel_err, mel_times = phase2()
    flash_err, flash_times = phase3()
    phase4()
    launches = phase5()
    big = BUCKETS[-1]
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
    ]
    if any(m.split(".")[0] in ("jax", "flax") for m in sys.modules):
        raise AssertionError("jax was imported")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, **RECORD}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
