"""Training diagnostics: the gradient-accumulation self-check.

Port of ``speech_transcript_embeddings_tpu/training/diagnostics.py``: the
mean of per-micro-batch gradients must equal the gradient of the batches
concatenated, which is what accumulation applies. The check uses the
pairwise loss (linear in per-sample terms, so the identity is exact; the
global loss couples the samples of a batch by design) and no dropout.
It makes no collective of the data axis: under data parallel training
every rank runs it identically, on the same whole probe batches, and none
waits on another; under tensor parallel the model axis's collectives run
inside the forward and backward, on every rank alike, and each rank
compares its own shards.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Sequence

import numpy as np
import torch

from speech_transcript_embeddings_torch.config import ExperimentConfig
from speech_transcript_embeddings_torch.training import losses
from speech_transcript_embeddings_torch.training.train_step import (
    model_batch_from_host,
)

logger = logging.getLogger("ste_torch")


def _grads(cfg: ExperimentConfig, state, frontend, batch) -> Dict[str, np.ndarray]:
    loss_cfg = dataclasses.replace(cfg.loss, kind="pairwise")
    device = next(iter(state.trainable.values())).device
    out = state.model.forward_pos_neg(
        model_batch_from_host(frontend, batch, device), None)
    loss, _ = losses.compute_loss(loss_cfg, out)
    params = list(state.trainable.values())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {k: (np.zeros(tuple(p.shape)) if g is None
                else g.detach().double().cpu().numpy())
            for (k, p), g in zip(state.trainable.items(), grads)}


def validate_gradient_accumulation(cfg: ExperimentConfig, state, frontend,
                                   batches: Sequence[Dict],
                                   rtol: float = 2e-2) -> dict:
    """Mean-of-micro-batch gradients against the concatenated batch's.

    ``batches`` (host batches) must share one shape. → ``{"max_rel_err",
    "mean_grad_norm", "max_grad_norm", "ok"}``, with the JAX package's
    norm warnings (> 100: lower the LR; < 1e-8: raise it)."""
    k = len(batches)
    if k < 2:
        logger.warning("Not enough test batches (%d) for accumulation "
                       "validation", k)
        return {"ok": False, "reason": "not_enough_batches"}
    accum = None
    for b in batches:
        g = _grads(cfg, state, frontend, b)
        accum = g if accum is None else {n: accum[n] + g[n] for n in accum}
    accum = {n: a / k for n, a in accum.items()}
    big = {key: np.concatenate([b[key] for b in batches], axis=0)
           for key in batches[0]}
    g_big = _grads(cfg, state, frontend, big)
    # one flattened comparison: per-leaf relative errors are meaningless for
    # leaves whose gradient is structurally zero (softmax-shift-invariant
    # biases), where both sides are rounding noise
    diff = np.concatenate([(accum[n] - g_big[n]).ravel() for n in accum])
    ref = np.concatenate([g_big[n].ravel() for n in accum])
    norms = [np.linalg.norm(g_big[n]) for n in accum]
    max_rel = float(np.linalg.norm(diff) / max(np.linalg.norm(ref), 1e-12))
    report = {"max_rel_err": max_rel, "mean_grad_norm": float(np.mean(norms)),
              "max_grad_norm": float(np.max(norms)), "ok": bool(max_rel < rtol)}
    logger.info("Gradient accumulation check: max relative error %.2e over "
                "%d microbatches", max_rel, k)
    if report["max_grad_norm"] > 100:
        logger.warning("Very large gradients detected - consider lowering "
                       "the learning rate")
    elif report["max_grad_norm"] < 1e-8:
        logger.warning("Very small gradients detected - consider increasing "
                       "the learning rate")
    else:
        logger.info("Gradient magnitudes look reasonable")
    return report
