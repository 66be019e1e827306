"""Projection and pooling heads (``EnhancedProjection``, ``AttentivePooling``).

Port of the retrieval-path heads of
``speech_transcript_embeddings_tpu/models/heads.py``. They have no compute
dtype in the JAX model, so they run in fp32 on whatever the encoders return.
``CrossModalAttention`` and ``WordLevelAlignment`` are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from speech_transcript_embeddings_torch.models.layers import (
    Dense, LayerNorm, dropout,
)

NEG_INF = -1e9


class EnhancedProjection(nn.Module):
    """Dense → act → dropout → Dense → LayerNorm into the shared space."""

    def __init__(self, in_dim: int, projection_dim: int,
                 hidden_dim: Optional[int] = None, activation: str = "gelu",
                 dropout: float = 0.0):
        super().__init__()
        hidden = hidden_dim or 2 * projection_dim
        if activation not in ("gelu", "relu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.dropout_rate = dropout
        self.dense_in = Dense(in_dim, hidden)
        self.dense_out = Dense(hidden, projection_dim)
        self.norm = LayerNorm(projection_dim, 1e-5)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dense_in(x)
        x = (F.gelu(x, approximate="none") if self.activation == "gelu"
             else F.relu(x))
        x = dropout(x, self.dropout_rate, generator)
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
