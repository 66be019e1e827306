"""Flax-semantics building blocks: Dense, LayerNorm, Embed and dropout.

They reproduce how the JAX package's ``flax.linen`` layers compute under a
``dtype``: a Dense or Embed with compute dtype ``d`` casts its weights, its
bias and its input to ``d`` at every call and returns ``d``; a LayerNorm
takes its statistics and applies its scale and bias in fp32 and returns
``d``. Where a weight is stored is a separate choice (``param_dtype``):
serving stores Dense and Embed weights in the compute dtype, so the cast is
a no-op (the same rounding, done once); training stores them in fp32, as
JAX keeps its parameters, and the cast happens at each call. Weights are
allocated empty; ``models.dual_encoder.init_model`` or a loaded
``state_dict`` fills them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """``y = x·Wᵀ + b`` in the compute dtype; ``weight`` is ``[out, in]``
    (the transpose of Flax's ``kernel``), stored in ``param_dtype``
    (default: the compute dtype)."""

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        store = param_dtype or dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               dtype=store))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=store))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and parameters (a parameter stored in
    another dtype is widened at the call), output in ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.dtype)


class Embed(nn.Module):
    """Embedding table ``[num, dim]`` stored in ``param_dtype`` (default:
    the compute dtype); the table is cast to the compute dtype, then
    indexed, as Flax's ``nn.Embed`` does."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, dim,
                                               dtype=param_dtype or dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight.to(self.dtype))


def dropout_keep(shape, rate: float, generator: Optional[torch.Generator]
                 ) -> Optional[torch.Tensor]:
    """The keep mask of Flax's ``nn.Dropout`` (each element kept with
    probability 1 − rate), drawn from ``generator`` on its device; None when
    nothing is dropped (``generator`` None means deterministic)."""
    if generator is None or rate == 0.0:
        return None
    return torch.rand(shape, generator=generator,
                      device=generator.device) >= rate


def apply_dropout(x: torch.Tensor, keep: Optional[torch.Tensor],
                  rate: float) -> torch.Tensor:
    """Kept elements scaled by 1/(1 − rate), the others 0."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout`` drawing from ``generator`` (None: identity)."""
    return apply_dropout(x, dropout_keep(x.shape, rate, generator), rate)


def replayable(generator: Optional[torch.Generator]):
    """→ ``get()`` for a checkpointed block: the first call returns
    ``generator`` itself (the forward advances it), every later call a copy
    of its state at this moment, so the backward replay draws the same
    dropout masks again. Reading the state does not wait for the device."""
    if generator is None:
        return lambda: None
    state = generator.get_state()
    calls = []

    def get():
        calls.append(None)
        if len(calls) == 1:
            return generator
        g = torch.Generator(device=generator.device)
        g.set_state(state)
        return g
    return get


def masked_probs(scores: torch.Tensor, mask) -> torch.Tensor:
    """Attention probabilities as the JAX encoders compute them: the
    additive mask ``(1 − mask)·finfo(f32).min`` promotes the scores to fp32
    (in bf16 the constant would round to −inf, and 0·−inf is NaN), the
    softmax runs in fp32, and the probabilities keep the scores' dtype."""
    if mask is not None:
        scores = scores.float() + (1.0 - mask[:, None, None, :].float()) * (
            torch.finfo(torch.float32).min)
    return torch.softmax(scores.float(), dim=-1).to(scores.dtype)
