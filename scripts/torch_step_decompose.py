#!/usr/bin/env python
"""Decompose the flagship train step of the PyTorch/CUDA port on one card:
the port of ``scripts/step_decompose.py``.

    python scripts/torch_step_decompose.py [--batch 32] [--seconds 10]
        [--text-len 64] [--device cuda|cpu] [key=value ...]

The flagship config (``utils/bench.flagship_config``: fusion and word
alignment on, pairwise loss, 5+5 unfrozen, ``save_hot2`` remat, K1-K4 on)
at B = 32 × 10 s clips, text 64, random weights from a seed, one batch of
full-length clips. Four readings, each the mean of 8 calls after 2 warm
ones (the window ends in a device sync), beside the device busy ms of one
more call (``torch.profiler``):

* ``fwd-only (host batch)``: the frontend, the forward and the loss, from
  numpy arrays (the host-to-device copy included), no gradient;
* ``fwd-only (device batch)``: the same from tensors on the card;
* ``value_and_grad (device)``: the loss and its gradients over the
  trainable split (``autograd.grad``, the remat replay included);
* ``full train_step``: ``training/train_step.py``'s step (the gradient
  norm and the AdamW update added).

The forward draws dropout and SpecAugment from the step's generator, as
JAX's ``deterministic=False``. K1-K4 must launch over the readings, or
the tool raises. ``--device cpu`` runs the same code at a size the
overrides make small and measures nothing of a device (device busy is
null); ``--device cuda`` without a card raises. Prints one line a reading,
then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WARM, TIMED = 2, 8


def host_batch(cfg, rng) -> dict:
    """step_decompose.py's batch: full-length clips of noise, random ids,
    no padding."""
    b = cfg.data.batch_size
    asamps, tlen = cfg.data.max_audio_samples, cfg.data.max_text_length
    vocab = cfg.model.text.vocab_size
    return {"waveform": rng.normal(scale=0.05, size=(b, asamps)
                                   ).astype(np.float32),
            "num_samples": np.full(b, asamps, np.int32),
            "input_ids_pos": rng.integers(4, vocab, size=(b, tlen)
                                          ).astype(np.int32),
            "attention_mask_pos": np.ones((b, tlen), np.int32),
            "input_ids_neg": rng.integers(4, vocab, size=(b, tlen)
                                          ).astype(np.int32),
            "attention_mask_neg": np.ones((b, tlen), np.int32)}


def loss_fn(cfg, state, frontend, batch, gen):
    """JAX's ``loss_fn``: the frontend, ``forward_pos_neg`` and the loss."""
    from speech_transcript_embeddings_torch.training import losses
    from speech_transcript_embeddings_torch.training import train_step as ts
    device = next(iter(state.trainable.values())).device
    mb = ts.model_batch_from_host(frontend, batch, device)
    loss, _ = losses.compute_loss(cfg.loss,
                                  state.model.forward_pos_neg(mb, gen))
    return loss


def value_and_grad(cfg, state, frontend, batch, gen):
    """The loss and its gradient for each trainable parameter (zeros for
    one the loss does not reach, as ``train_step`` fills them)."""
    import torch
    loss = loss_fn(cfg, state, frontend, batch, gen)
    params = list(state.trainable.values())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(state.trainable.items(),
                                                grads)}


def reading(fn, cuda: bool) -> dict:
    """step_decompose.py's ``timeit`` (2 warm calls, the mean of 8, the
    window ending in a device sync) and the device busy ms of one more
    call."""
    import torch
    from speech_transcript_embeddings_torch.utils import bench as ub
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(WARM):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        fn()
    sync()
    host_ms = (time.perf_counter() - t0) * 1e3 / TIMED
    return {"host_ms": host_ms,
            "device_busy_ms": ub.device_busy_ms(fn) if cuda else None}


def main(argv=None) -> dict:
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
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        init_model,
    )
    from speech_transcript_embeddings_torch.ops import make_frontend
    from speech_transcript_embeddings_torch.training import train_step as ts
    from speech_transcript_embeddings_torch.utils import bench as ub
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        # fp32 products in full fp32, as the training loop runs them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = ub.flagship_config(args.batch, args.seconds * 16000, args.text_len,
                             args.overrides)
    model = init_model(cfg.model, torch.Generator(device).manual_seed(0),
                       device, train=True)
    state = ts.create_train_state(model, cfg, total_steps=1000)
    frontend = make_frontend(cfg.model.frontend).to(device)
    gen = torch.Generator(device).manual_seed(1)
    host = host_batch(cfg, np.random.default_rng(0))
    dev = {k: torch.from_numpy(v).to(device) for k, v in host.items()}

    def fwd(batch):
        with torch.no_grad():
            return loss_fn(cfg, state, frontend, batch, gen)

    ub.reset_launches()
    results = []
    for what, fn in (
            ("fwd-only (host batch)", lambda: fwd(host)),
            ("fwd-only (device batch)", lambda: fwd(dev)),
            ("value_and_grad (device)",
             lambda: value_and_grad(cfg, state, frontend, dev, gen)),
            ("full train_step",
             lambda: ts.train_step(cfg, state, frontend, dev, gen))):
        rec = dict(what=what, **reading(fn, cuda))
        results.append(rec)
        busy = (f", device busy {rec['device_busy_ms']:.1f} ms"
                if cuda else "")
        print(f"{what}: {rec['host_ms']:.1f} ms{busy}", flush=True)
    counts = ub.launches()
    if cuda:
        ub.require_launches(counts, ("K1", "K2", "K3", "K4"))
    out = {"batch": args.batch, "seconds": args.seconds,
           "text_len": args.text_len, "device": str(device),
           "card": ub.card_line(device.index or 0) if cuda else "cpu",
           "readings": results, "kernel_launches": counts}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
