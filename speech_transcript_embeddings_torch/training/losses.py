"""Contrastive losses.

Port of ``speech_transcript_embeddings_tpu/training/losses.py``:

* ``pairwise`` — 2-way InfoNCE as cross-entropy over ``[s_pos, s_neg] / τ``
  with an optional corrupt penalty (reference parity);
* ``global`` — in-batch-negative InfoNCE: each clip scored against every
  clean and every corrupted transcript of the GLOBAL batch. Under data
  parallel training (``axis_name="data"``) each rank holds its own rows and
  gathers every rank's transcripts with ``parallel.collectives.gather_rows``,
  whose backward sums each row's gradient over every rank's loss. The
  ``group`` is the data axis's (``Mesh.data_group``; None: every rank):
  under tensor parallel the ranks of a data row hold the same embeddings
  and each gathers over its own data axis.

With the word-alignment head on, each sample's term is weighted by
``1 − sigmoid(mean token score)·alignment_weight``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from speech_transcript_embeddings_torch.config import LossConfig
from speech_transcript_embeddings_torch.parallel import collectives


class LossAux(NamedTuple):
    s_pos: torch.Tensor    # [B] cosine(audio, clean text)
    s_neg: torch.Tensor    # [B] cosine(audio, corrupted text)


def to_human_readable(cosine: torch.Tensor, temperature: float = 0.1,
                      scale: str = "prob") -> torch.Tensor:
    """Raw cosine (−1..1) → a 0..1 score: sigmoid(cos/τ), or (cos + 1)/2."""
    if scale == "0to1":
        return (cosine + 1.0) * 0.5
    if scale == "prob":
        return torch.sigmoid(cosine / temperature)
    raise ValueError(f"Unknown scale {scale!r}")


def alignment_factor(alignment_scores, alignment_weight: float):
    if alignment_scores is None:
        return None
    return 1.0 - torch.sigmoid(alignment_scores.mean(dim=1)) * alignment_weight


def pairwise_info_nce(cfg: LossConfig, text_pos, text_neg, audio,
                      alignment_scores=None):
    """CE over the 2-way choice {clean, corrupt} per sample."""
    s_pos = torch.sum(audio * text_pos, dim=-1)
    s_neg = torch.sum(audio * text_neg, dim=-1)
    logits = torch.stack([s_pos, s_neg], dim=1) / cfg.temperature
    per_sample = -F.log_softmax(logits, dim=1)[:, 0]
    factor = alignment_factor(alignment_scores, cfg.alignment_weight)
    if factor is not None:
        per_sample = per_sample * factor
    loss = per_sample.mean()
    if cfg.corrupt_gamma > 0:
        loss = loss + cfg.corrupt_gamma * F.relu(s_neg).mean()
    return loss, LossAux(s_pos=s_pos, s_neg=s_neg)


def _gathered(text_pos, text_neg, axis_name, group):
    """(every rank's clean transcripts, every rank's corrupted ones, this
    rank's offset in them): one ``gather_rows`` of both over ``group``, so
    the forward and the backward each make one collective."""
    if axis_name is None:
        return text_pos, text_neg, 0
    collectives.require(axis_name)
    b = text_pos.shape[0]
    both = collectives.gather_rows(torch.cat([text_pos, text_neg], dim=0),
                                   group)
    both = both.reshape(-1, 2, b, text_pos.shape[-1])         # [N, 2, B, D]
    return (both[:, 0].reshape(-1, text_pos.shape[-1]),
            both[:, 1].reshape(-1, text_pos.shape[-1]),
            collectives.rank(group) * b)


def global_info_nce(cfg: LossConfig, text_pos, text_neg, audio,
                    alignment_scores=None, axis_name: Optional[str] = None,
                    group=None):
    """In-batch-negative InfoNCE: row i's candidates are every clean and
    every corrupted transcript of the global batch; its target is its own
    clean transcript. With ``axis_name`` (data parallel) the rows are this
    rank's: logits ``[B_local, 2·B_global]``, labels ``rank·B_local + i``,
    and the loss (the corrupt penalty too) the local mean, so that the
    mean of the ranks' gradients is the gradient of the global batch's
    loss, as JAX's ``shard_map`` form computes it."""
    all_pos, all_neg, shard = _gathered(text_pos, text_neg, axis_name, group)
    b = audio.shape[0]
    cand = torch.cat([all_pos, all_neg], dim=0)               # [2·Bg, D]
    logits = (audio @ cand.T) / cfg.temperature               # [Bl, 2·Bg]
    idx = torch.arange(b, device=audio.device)
    per_sample = -F.log_softmax(logits, dim=-1)[idx, shard + idx]
    factor = alignment_factor(alignment_scores, cfg.alignment_weight)
    if factor is not None:
        per_sample = per_sample * factor
    loss = per_sample.mean()
    s_pos = torch.sum(audio * text_pos, dim=-1)
    s_neg = torch.sum(audio * text_neg, dim=-1)
    if cfg.corrupt_gamma > 0:
        loss = loss + cfg.corrupt_gamma * F.relu(s_neg).mean()
    return loss, LossAux(s_pos=s_pos, s_neg=s_neg)


def global_per_sample_masked(cfg: LossConfig, text_pos, text_neg, audio,
                             example_mask, alignment_scores=None,
                             axis_name: Optional[str] = None, group=None):
    """Per-sample in-batch InfoNCE for evaluation under masked tails: the
    candidate columns of padded rows (``example_mask`` 0) are removed
    before the log-softmax. Entries of padded rows are meaningless; the
    caller's mask zeroes them. With ``axis_name`` the rows are this rank's,
    scored against the whole batch's candidates, whose masks are gathered
    with them (a padded row on another rank is still no candidate)."""
    all_pos, all_neg, shard = _gathered(text_pos, text_neg, axis_name, group)
    all_mask = example_mask if axis_name is None else \
        collectives.gather_rows(example_mask, group)
    b = audio.shape[0]
    cand = torch.cat([all_pos, all_neg], dim=0)
    logits = (audio @ cand.T) / cfg.temperature
    cmask = torch.cat([all_mask, all_mask], dim=0) > 0
    logits = torch.where(cmask[None, :], logits,
                         torch.finfo(logits.dtype).min)
    idx = torch.arange(b, device=audio.device)
    per = -F.log_softmax(logits, dim=-1)[idx, shard + idx]
    factor = alignment_factor(alignment_scores, cfg.alignment_weight)
    if factor is not None:
        per = per * factor
    if cfg.corrupt_gamma > 0:
        per = per + cfg.corrupt_gamma * F.relu(torch.sum(audio * text_neg, -1))
    return per


def compute_loss(cfg: LossConfig, output, axis_name: Optional[str] = None,
                 group=None):
    """Dispatch on ``cfg.kind`` given a ``PosNegOutput``."""
    if cfg.kind == "pairwise":
        return pairwise_info_nce(cfg, output.text_pos, output.text_neg,
                                 output.audio, output.alignment_scores)
    if cfg.kind == "global":
        return global_info_nce(cfg, output.text_pos, output.text_neg,
                               output.audio, output.alignment_scores,
                               axis_name, group)
    raise ValueError(f"Unknown loss kind {cfg.kind!r}")
