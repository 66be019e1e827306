"""Flax-semantics building blocks: Dense, LayerNorm and Embed.

They reproduce how the JAX package's ``flax.linen`` layers compute under a
``dtype``: a Dense or Embed with compute dtype ``d`` casts its weights to
``d`` and returns ``d`` (so the port stores those weights in ``d`` — the
same rounding, done once); a LayerNorm takes its statistics and applies its
fp32 scale and bias in fp32 and returns ``d``. Weights are allocated empty;
``models.dual_encoder.init_model`` or a loaded ``state_dict`` fills them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """``y = x·Wᵀ + b`` in the weight's dtype; ``weight`` is ``[out, in]``
    (the transpose of Flax's ``kernel``)."""

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=dtype))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and parameters, output in ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class Embed(nn.Module):
    """Embedding table ``[num, dim]`` stored in the compute dtype."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim, dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


def masked_probs(scores: torch.Tensor, mask) -> torch.Tensor:
    """Attention probabilities as the JAX encoders compute them: the
    additive mask ``(1 − mask)·finfo(f32).min`` promotes the scores to fp32
    (in bf16 the constant would round to −inf, and 0·−inf is NaN), the
    softmax runs in fp32, and the probabilities keep the scores' dtype."""
    if mask is not None:
        scores = scores.float() + (1.0 - mask[:, None, None, :].float()) * (
            torch.finfo(torch.float32).min)
    return torch.softmax(scores.float(), dim=-1).to(scores.dtype)
