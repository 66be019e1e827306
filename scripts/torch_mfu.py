#!/usr/bin/env python
"""MFU of the conformer forward and HFU of the flagship train step of the
PyTorch/CUDA port on one card: the port of ``scripts/mfu.py``.

    python scripts/torch_mfu.py [--batch 32] [--seconds 10] [--text-len 64]
        [--device cuda|cpu] [key=value ...]

FLOPs come from ``utils.bench.count_flops``: the matrix products of one
call on a model built with the kernels off (flash attention and the
log-mel kernels: a hand-written kernel is opaque to the counter), as
mfu.py counts an XLA compile with the Pallas kernels off. The counting
call is never timed; the timed calls run the flagship configuration,
kernels on.

* ``conformer_forward``: the audio encoder alone (24 blocks, bf16, no
  gradient) on the log-mel features of ``--batch`` clips of ``--seconds``,
  2 warm and 10 timed calls: model FLOPs, so **MFU**.
* ``flagship_train_step``: the flagship preset's train step (fusion and
  word alignment on, pairwise loss, 5+5 unfrozen, ``save_hot2`` remat) on
  distinct device-resident batches, 2 warm and 8 timed steps. Its count
  holds the remat replay: **HFU**.

Each timed window ends in ``torch.cuda.synchronize()``. The ratio is to
the card's bf16 peak (``utils.bench.PEAK_BF16``; an unknown card, or a
ratio above 1, raises). Beside it: device busy ms of one more call
(``torch.profiler``), the SM clock and power during the timed calls, the
card's name and power limit. ``key=value`` overrides (``train.py``'s
syntax) apply to both configurations, to shrink them for ``--device
cpu``, which measures nothing of a device. ``--device cuda`` without a
card raises.

Writes one JSON line per measurement.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _peak_gib(device):
    """The peak memory since the last reset, in GiB (None off a card)."""
    import torch
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def conformer_forward(cfg, device, wav, nsamp, sampler):
    """The audio encoder's forward alone: → its record and its FLOPs."""
    import torch
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    from speech_transcript_embeddings_torch.ops import make_frontend
    from speech_transcript_embeddings_torch.utils import bench as ub
    cuda = device.type == "cuda"
    with torch.no_grad():
        feats, mask = make_frontend(cfg.model.frontend).to(device)(wav, nsamp)

    def encoder(c):
        m = dataclasses.replace(c.model, remat=False)
        return init_model(m, torch.Generator(device).manual_seed(0),
                          device).audio_encoder

    enc = encoder(cfg)
    with torch.inference_mode():
        rec = ub.timed_window(lambda x: enc(*x), [(feats, mask)] * 2,
                              [(feats, mask)] * 10, cuda, sampler)
    rec["peak_memory_gib"] = _peak_gib(device)
    del enc
    counting = encoder(ub.counting_config(cfg))
    with torch.inference_mode():
        flops = ub.count_flops(counting, feats, mask)
    rec.update(frames=int(feats.shape[1]))
    return rec, flops


def train_step(cfg, device, sampler):
    """The flagship train step: → its record and its FLOPs."""
    import torch
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    from speech_transcript_embeddings_torch.ops import make_frontend
    from speech_transcript_embeddings_torch.training import train_step as ts
    from speech_transcript_embeddings_torch.utils import bench as ub
    cuda = device.type == "cuda"
    b = cfg.data.batch_size
    asamps, tlen = cfg.data.max_audio_samples, cfg.data.max_text_length
    vocab = cfg.model.text.vocab_size
    rng = np.random.default_rng(0)

    def host():
        return {"waveform": rng.normal(scale=0.05, size=(b, asamps)
                                       ).astype(np.float32),
                "num_samples": np.full(b, asamps, np.int32),
                "input_ids_pos": rng.integers(4, vocab, size=(b, tlen)
                                              ).astype(np.int32),
                "attention_mask_pos": np.ones((b, tlen), np.int32),
                "input_ids_neg": rng.integers(4, vocab, size=(b, tlen)
                                              ).astype(np.int32),
                "attention_mask_neg": np.ones((b, tlen), np.int32)}

    batches = [{k: torch.from_numpy(v).to(device) for k, v in host().items()}
               for _ in range(2 + 8)]

    def state_of(c):
        model = init_model(c.model, torch.Generator(device).manual_seed(0),
                           device, train=True)
        return (ts.create_train_state(model, c, total_steps=1000),
                make_frontend(c.model.frontend).to(device),
                torch.Generator(device).manual_seed(1))

    state, frontend, gen = state_of(cfg)
    rec = ub.timed_window(
        lambda x: ts.train_step(cfg, state, frontend, x, gen), batches[:2],
        batches[2:], cuda, sampler)
    rec["peak_memory_gib"] = _peak_gib(device)
    del state, frontend
    if cuda:
        torch.cuda.empty_cache()
    ccfg = ub.counting_config(cfg)
    state, frontend, gen = state_of(ccfg)
    flops = ub.count_flops(ts.train_step, ccfg, state, frontend, batches[0],
                           gen)
    return rec, flops


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seconds", type=int, default=10)
    ap.add_argument("--text-len", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", metavar="key=value")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    from speech_transcript_embeddings_torch.inference.embed import (
        resolve_device,
    )
    from speech_transcript_embeddings_torch.utils import bench as ub
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    b, asamps = args.batch, args.seconds * 16000
    cfg = ub.flagship_config(b, asamps, args.text_len, args.overrides)
    if cuda:
        # fp32 products in full fp32, as the training loop runs them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        peak = ub.peak_bf16(torch.cuda.get_device_name(device))
    wav = torch.from_numpy(np.random.default_rng(0).normal(
        scale=0.05, size=(b, asamps)).astype(np.float32)).to(device)
    nsamp = torch.full((b,), asamps, dtype=torch.int32, device=device)
    results = []
    for what, run in (
            ("conformer_forward",
             lambda s: conformer_forward(cfg, device, wav, nsamp, s)),
            ("flagship_train_step", lambda s: train_step(cfg, device, s))):
        sampler = ub.CardSampler(device.index or 0) if cuda else None
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        with sampler or contextlib.nullcontext():
            rec, flops = run(sampler)
        secs = rec["step_ms"] / 1e3
        counts = rec.pop("launches")
        rec.pop("log_mel_frames")
        out = dict(what=what, batch=b, seconds=args.seconds, **rec)
        ratio = "mfu" if what == "conformer_forward" else "hfu"
        out["model_tflops" if ratio == "mfu" else "executed_tflops"] = \
            flops / 1e12
        if cuda:
            ub.require_launches(counts, ("K3",) if ratio == "mfu" else
                                ("K1", "K2", "K3", "K4"))
            out[ratio] = ub.ceiling(flops, secs, peak)
            out.update(**sampler.summary(),
                       card=ub.card_line(device.index or 0),
                       peak_tflops=peak / 1e12)
        else:
            out.update({ratio: None, "card": "cpu"})
        if ratio == "hfu":
            out["clips_per_sec"] = b / secs
        out["kernel_launches"] = counts
        results.append(out)
    for r in results:
        print(json.dumps(r), flush=True)
    return results


if __name__ == "__main__":
    main()
