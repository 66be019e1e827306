"""Projection, pooling and fusion heads of the dual encoder.

Port of ``speech_transcript_embeddings_tpu/models/heads.py``:
``EnhancedProjection``, ``AttentivePooling``, ``CrossModalAttention`` and
``WordLevelAlignment``. They have no compute dtype in the JAX model, so they
run in fp32 on whatever the encoders return (a bf16 hidden state is widened
first, as Flax's dtype promotion does). The two attention heads are plain
products and a softmax: ``WordLevelAlignment`` returns its probabilities,
which a fused attention call cannot. Masked scores are filled with −1e9, not
−inf, so a clip with no valid frame gives uniform probabilities, not NaN.
Tensor parallel (``axis``) splits what JAX's rules split: the projection's
hidden features (``dense_in`` / ``dense_out``), the heads of the
cross-modal attention and of the word alignment's attention
(``attn_q/k/v`` split by output features with their biases replicated, as
JAX leaves them); ``score_in``, ``text_proj``, ``output_proj``,
``confidence_*`` and the norms stay replicated.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from speech_transcript_embeddings_torch.models.layers import (
    Dense, LayerNorm, column_dense, dropout, row_dense,
)
from speech_transcript_embeddings_torch.parallel.collectives import (
    ModelAxis, copy_to_model, reduce_from_model,
)

NEG_INF = -1e9


class EnhancedProjection(nn.Module):
    """Dense → act → dropout → Dense → LayerNorm into the shared space."""

    def __init__(self, in_dim: int, projection_dim: int,
                 hidden_dim: Optional[int] = None, activation: str = "gelu",
                 dropout: float = 0.0, axis: Optional[ModelAxis] = None):
        super().__init__()
        hidden = hidden_dim or 2 * projection_dim
        if activation not in ("gelu", "relu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.dropout_rate = dropout
        self.axis = axis
        self.dense_in = column_dense(axis, in_dim, hidden)
        self.dense_out = row_dense(axis, hidden, projection_dim)
        self.norm = LayerNorm(projection_dim, 1e-5)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dense_in(copy_to_model(x, self.axis))
        x = (F.gelu(x, approximate="none") if self.activation == "gelu"
             else F.relu(x))
        x = dropout(x, self.dropout_rate, generator, self.axis)
        return self.norm(self.dense_out(x))


class AttentivePooling(nn.Module):
    """Learned softmax pooling over time: Dense(h/2) → tanh → Dense(1) →
    masked softmax (−1e9) → weighted sum in the hidden states' dtype."""

    def __init__(self, hidden: int):
        super().__init__()
        self.score_in = Dense(hidden, hidden // 2)
        self.score_out = Dense(hidden // 2, 1)

    def forward(self, hidden: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = self.score_out(torch.tanh(self.score_in(hidden)))[..., 0]
        if mask is not None:
            s = torch.where(mask == 0, torch.full_like(s, NEG_INF), s)
        w = torch.softmax(s.float(), dim=-1).to(hidden.dtype)
        return torch.einsum("bt,bth->bh", w, hidden)


def _probs(scores: torch.Tensor, mask: Optional[torch.Tensor], rate: float,
           generator: Optional[torch.Generator],
           axis: Optional[ModelAxis] = None) -> torch.Tensor:
    """Masked (−1e9 where ``mask`` is 0) softmax over the keys in fp32,
    then dropout: ``scores [B, h, Tq, Tk]`` (this rank's heads under
    ``axis``), ``mask [B, Tk]``."""
    if mask is not None:
        scores = torch.where(mask[:, None, None, :] == 0,
                             torch.full_like(scores, NEG_INF), scores)
    probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
    return dropout(probs, rate, generator, axis, 1)


class CrossModalAttention(nn.Module):
    """Multi-head attention of ``x [B, Tq, D]`` over ``context [B, Tk, D]``
    with a key mask ``[B, Tk]`` (1 = keep); scale head_dim^−½, dropout on
    the probabilities."""

    def __init__(self, dim: int, num_heads: int = 8, dropout: float = 0.0,
                 axis: Optional[ModelAxis] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dropout_rate = dropout
        self.axis = axis
        self.local_heads = axis.part(num_heads) if axis else num_heads
        self.query = column_dense(axis, dim, dim)
        self.key = column_dense(axis, dim, dim)
        self.value = column_dense(axis, dim, dim)
        self.out = row_dense(axis, dim, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        hd = x.shape[-1] // self.num_heads
        split = lambda h: h.reshape(*h.shape[:-1], self.local_heads, hd)  # noqa: E731
        x = copy_to_model(x, self.axis)
        context = copy_to_model(context, self.axis)
        q = split(self.query(x))
        k = split(self.key(context))
        v = split(self.value(context))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
        probs = _probs(scores, mask, self.dropout_rate, generator, self.axis)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(out.reshape(*x.shape[:-1], self.local_heads * hd))


class WordLevelAlignment(nn.Module):
    """Soft alignment of text tokens onto audio frames: tokens (queries)
    attend to frames in a shared ``alignment_dim`` space, the attended
    representation joins a residual (the raw text hidden state when its
    width is ``alignment_dim``, else the projected one) under a LayerNorm,
    and a small MLP scores each token. → (aligned ``[B, Tt, D]``, token
    scores ``[B, Tt]`` zeroed on padded tokens, the alignment matrix
    ``[B, Tt, Ta]``: the probabilities averaged over heads)."""

    def __init__(self, text_dim: int, audio_dim: int, alignment_dim: int,
                 num_heads: int = 4, dropout: float = 0.0,
                 axis: Optional[ModelAxis] = None):
        super().__init__()
        d = alignment_dim
        self.num_heads = num_heads
        self.dropout_rate = dropout
        self.axis = axis
        self.local_heads = axis.part(num_heads) if axis else num_heads
        self.text_proj = Dense(text_dim, d)
        self.audio_proj = Dense(audio_dim, d)
        self.attn_q = column_dense(axis, d, d, replicated_bias=True)
        self.attn_k = column_dense(axis, d, d, replicated_bias=True)
        self.attn_v = column_dense(axis, d, d, replicated_bias=True)
        self.attn_out = row_dense(axis, d, d)
        self.output_proj = Dense(d, d)
        self.norm = LayerNorm(d, 1e-5)
        self.confidence_in = Dense(d, d // 2)
        self.confidence_out = Dense(d // 2, 1)

    def forward(self, text_hidden: torch.Tensor, audio_hidden: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None,
                audio_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        d = self.text_proj.weight.shape[0]
        hd = d // self.num_heads
        text_proj = self.text_proj(text_hidden)
        audio_proj = self.audio_proj(audio_hidden)
        split = lambda h: h.reshape(*h.shape[:-1], self.local_heads, hd)  # noqa: E731
        q = split(self.attn_q(copy_to_model(text_proj, self.axis)))
        audio_in = copy_to_model(audio_proj, self.axis)
        k = split(self.attn_k(audio_in))
        v = split(self.attn_v(audio_in))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
        probs = _probs(scores, audio_mask, self.dropout_rate, generator,
                       self.axis)
        attended = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        attended = self.attn_out(attended.reshape(
            *text_proj.shape[:-1], self.local_heads * hd))
        if self.axis is None:
            alignment_matrix = probs.mean(dim=1)
        else:   # the mean over every rank's heads
            alignment_matrix = reduce_from_model(
                probs.sum(dim=1), self.axis) / self.num_heads
        residual = (text_hidden.float() if text_hidden.shape[-1] == d
                    else text_proj)
        aligned = self.norm(residual + self.output_proj(attended))
        conf = F.relu(self.confidence_in(aligned))
        scores = self.confidence_out(conf)[..., 0]
        if text_mask is not None:
            scores = scores * text_mask.to(scores.dtype)
        return aligned, scores, alignment_matrix
