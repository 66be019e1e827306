#!/usr/bin/env python
"""Embedding throughput of the PyTorch/CUDA port on one card: the port of
``scripts/infer_bench.py``.

    python scripts/torch_infer_bench.py [--int8] [--device cuda|cpu]
        [key=value ...]

Times the embed step through ``Embedder``'s own path, the one serving
runs: the log-mel frontend, ``encode_audio`` and ``encode_text``, each
L2-normalised (``Embedder._embed_audio`` / ``_embed_text``), at B = 64
clips of 10 s (lengths drawn from 5 to 10 s) and 64 text tokens, on the
flagship model with no remat (no backward to save for), random weights
from a seed, bf16. (JAX's embed step runs the model's pair forward, whose
cross-modal fusion heads add a few small products; ``Embedder`` embeds
each side on its own.) Device-resident batches, a distinct one a step, 2
warm and 12 timed steps; the window ends in ``torch.cuda.synchronize()``.
``--int8`` first quantizes the Dense products of the pair forward
(``Embedder.quantize_int8``, W8A8 through ``torch._int_mm``).

Beside the time: the device busy ms of one more step (``torch.profiler``)
and the idle share, the step's FLOPs (its matrix products counted on a
bf16 model with the kernels off, nothing quantized) and their share of the
card's bf16 peak (MFU; a share above 1 raises), the peak memory, the SM
clock and power during the timed steps, the card's name and power limit,
and the launches over the timed steps: K1-K3 must launch, and under
``--int8`` the int8 products. ``key=value`` overrides (``train.py``'s
syntax) shrink the model for ``--device cpu``, which measures nothing of a
device. ``--device cuda`` without a card raises.

Prints a line like infer_bench.py's, then ONE JSON line, the last.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, AUDIO_SECONDS, TLEN = 64, 10, 64
WARM, TIMED = 2, 12


def build_config(overrides=()):
    from speech_transcript_embeddings_torch import config as c
    cfg = c.ExperimentConfig(
        model=dataclasses.replace(c.flagship_model_config(), remat=False),
        data=c.DataConfig(max_text_length=TLEN))
    return cfg.with_overrides(c.parse_overrides(list(overrides)))


def make_embedder(cfg, device):
    """An ``Embedder`` over the serving form of ``cfg``'s model, weights
    from seed 0."""
    import torch
    from speech_transcript_embeddings_torch.inference.embed import Embedder
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    model = init_model(cfg.model, torch.Generator(device).manual_seed(0),
                       device)
    return Embedder(cfg, model)


def embed_step(emb, batch):
    return (emb._embed_text(batch["input_ids"], batch["attention_mask"]),
            emb._embed_audio(batch["waveform"], batch["num_samples"]))


def batches(cfg, n, device):
    """``n`` device-resident batches from ``default_rng(0)``, as
    infer_bench.py draws them."""
    import torch
    rng = np.random.default_rng(0)
    asamps = AUDIO_SECONDS * 16000
    out = []
    for _ in range(n):
        host = {"waveform": rng.normal(scale=0.05, size=(B, asamps)
                                       ).astype(np.float32),
                "num_samples": rng.integers(asamps // 2, asamps,
                                            size=B).astype(np.int32),
                "input_ids": rng.integers(4, cfg.model.text.vocab_size,
                                          size=(B, TLEN)).astype(np.int32),
                "attention_mask": np.ones((B, TLEN), np.int32)}
        out.append({k: torch.from_numpy(v).to(device)
                    for k, v in host.items()})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--int8", action="store_true",
                    help="quantize the Dense products to int8 (W8A8) first")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", metavar="key=value")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    mode = "int8" if args.int8 else "bf16"
    import torch
    from speech_transcript_embeddings_torch.inference.embed import (
        resolve_device,
    )
    from speech_transcript_embeddings_torch.utils import bench as ub
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    cfg = build_config(args.overrides)
    emb = make_embedder(cfg, device)
    if args.int8:
        emb.quantize_int8()
    data = batches(cfg, WARM + TIMED, device)
    step = lambda b: embed_step(emb, b)                     # noqa: E731
    if cuda:
        peak = ub.peak_bf16(torch.cuda.get_device_name(device))
        torch.cuda.reset_peak_memory_stats(device)
        sampler = ub.CardSampler(device.index or 0)
    else:
        sampler = None
    with sampler or contextlib.nullcontext():
        rec = ub.timed_window(step, data[:WARM], data[WARM:], cuda, sampler)
    peak_gib = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if cuda else None)
    del emb
    counting = make_embedder(ub.counting_config(cfg), device)
    flops = ub.count_flops(embed_step, counting, data[0])
    del counting
    secs = rec["step_ms"] / 1e3
    counts = rec.pop("launches")
    if cuda:
        ub.require_launches(counts, ("K1", "K2", "K3"))
        if args.int8 and counts["int8_matmul"] == 0:
            raise RuntimeError(f"--int8 but no int8 product launched: "
                               f"{counts}")
        mfu = ub.ceiling(flops, secs, peak)
        card, clock_power = ub.card_line(device.index or 0), sampler.summary()
    else:
        mfu, card = None, "cpu"
        clock_power = {"sm_clock_mhz": None, "power_w": None}
    out = dict(
        what="embed_step", mode=mode, batch=B, seconds=AUDIO_SECONDS,
        text_len=TLEN, device=str(device), ms=rec["step_ms"],
        clips_per_s=B / secs, timed_steps=rec["timed_steps"],
        device_busy_ms=rec["device_busy_ms"], idle_share=rec["idle_share"],
        step_tflop=flops / 1e12, mfu=mfu,
        peak_tflops=peak / 1e12 if cuda else None, peak_memory_gib=peak_gib,
        **clock_power, card=card, kernel_launches=counts,
        int8_products=counts["int8_matmul"],
        log_mel_frames={str(k): v for k, v in
                        sorted(rec["log_mel_frames"].items())})
    print(f"embed step [{mode}] (text+audio, B={B}, 10 s): "
          f"{rec['step_ms']:.1f} ms = {B / secs:.1f} clips/s/chip "
          f"(reference eval ~12.5 clips/s) on {card}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
