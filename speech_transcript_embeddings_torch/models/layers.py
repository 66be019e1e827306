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

Tensor parallel (a ``ModelAxis``): ``ColumnDense`` holds a slice of a
Dense's output features, ``RowDense`` a slice of its input features (its
partial products summed over the axis, then its whole bias added once),
``VocabEmbed`` a slice of a table's rows, and ``ShardedLayerNorm``
normalises channels split over the axis with statistics summed over it.
``column_dense`` / ``row_dense`` / ``embed`` / ``layer_norm`` build the
plain layer without an axis. Dropout on a split activation draws its mask
at full width and keeps this rank's slice, so the ranks draw what one
process draws.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from speech_transcript_embeddings_torch.ops.layer_norm import (
    layer_norm as layer_norm_op,
)
from speech_transcript_embeddings_torch.parallel.collectives import (
    ModelAxis, all_reduce_model, copy_to_model, reduce_from_model,
)


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
    another dtype is widened at the call), output in ``dtype``: the CUDA
    kernels of ``ops/layer_norm.py`` on the card, the plain chain on the
    CPU."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_op(x, self.weight, self.bias, self.eps, self.dtype)


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


class ColumnDense(Dense):
    """A Dense whose output features are split over the model axis: this
    rank holds its rows of ``weight`` ``[out/M, in]`` and of the bias, or,
    with ``replicated_bias``, the whole bias (JAX leaves it unsplit), of
    which it adds its slice. Its input is the same on every rank, passed
    through ``copy_to_model`` by the caller."""

    def __init__(self, in_features: int, out_features: int, axis: ModelAxis,
                 *, use_bias: bool = True, replicated_bias: bool = False,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, axis.part(out_features),
                         use_bias=use_bias, dtype=dtype,
                         param_dtype=param_dtype)
        self.axis = axis
        self.replicated_bias = use_bias and replicated_bias
        if self.replicated_bias:
            self.bias = nn.Parameter(torch.empty(
                out_features, dtype=param_dtype or dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias
        if self.replicated_bias:
            # the gradient of the slice each rank reads, summed: every rank
            # holds the whole bias's gradient
            bias = self.axis.local(copy_to_model(bias, self.axis), 0)
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if bias is None else bias.to(dt))


class RowDense(Dense):
    """A Dense whose input features are split over the model axis: this
    rank holds columns ``[out, in/M]`` of ``weight`` and multiplies its
    slice of the input; the partial products are summed over the axis
    (``reduce_from_model``) and the whole bias, replicated, added once."""

    def __init__(self, in_features: int, out_features: int, axis: ModelAxis,
                 *, use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(axis.part(in_features), out_features,
                         use_bias=use_bias, dtype=dtype,
                         param_dtype=param_dtype)
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = reduce_from_model(F.linear(x.to(dt), self.weight.to(dt)),
                              self.axis)
        return y if self.bias is None else y + self.bias.to(dt)


def column_dense(axis: Optional[ModelAxis], in_features: int,
                 out_features: int, *, replicated_bias: bool = False,
                 **kw) -> Dense:
    if axis is None:
        return Dense(in_features, out_features, **kw)
    return ColumnDense(in_features, out_features, axis,
                       replicated_bias=replicated_bias, **kw)


def row_dense(axis: Optional[ModelAxis], in_features: int,
              out_features: int, **kw) -> Dense:
    if axis is None:
        return Dense(in_features, out_features, **kw)
    return RowDense(in_features, out_features, axis, **kw)


class VocabEmbed(Embed):
    """An Embed whose rows are split over the model axis: the table is
    padded to ``⌈num/M⌉·M`` rows (zeros, never looked up) and this rank
    holds rows ``[i·⌈num/M⌉, (i+1)·⌈num/M⌉)``. Each rank looks up the ids
    it holds, zeroes the others, and the ranks' rows are summed (one rank
    holds each id)."""

    def __init__(self, num: int, dim: int, axis: ModelAxis,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        per = -(-num // axis.size)
        super().__init__(per, dim, dtype, param_dtype)
        self.axis = axis
        self.first = axis.index * per

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.first
        held = (local >= 0) & (local < self.weight.shape[0])
        rows = F.embedding(torch.where(held, local, 0),
                           self.weight.to(self.dtype))
        rows = torch.where(held[..., None], rows, torch.zeros_like(rows))
        return reduce_from_model(rows, self.axis)


def embed(axis: Optional[ModelAxis], num: int, dim: int,
          dtype: torch.dtype = torch.float32,
          param_dtype: Optional[torch.dtype] = None) -> Embed:
    if axis is None:
        return Embed(num, dim, dtype, param_dtype)
    return VocabEmbed(num, dim, axis, dtype, param_dtype)


class ShardedLayerNorm(LayerNorm):
    """LayerNorm over channels split over the model axis: the whole scale
    and bias (replicated, as JAX keeps them) and this rank's channels of
    the input; the mean and the variance are sums over the axis (two
    passes, in fp32), and each rank applies its slice of the scale and
    bias."""

    def __init__(self, dim: int, eps: float, axis: ModelAxis,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps, dtype)
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, n = self.axis, self.weight.shape[0]
        x = x.float()
        mean = all_reduce_model(x.sum(-1, keepdim=True), a) / n
        xc = x - mean
        var = all_reduce_model((xc * xc).sum(-1, keepdim=True), a) / n
        scale = a.local(copy_to_model(self.weight.float(), a), 0)
        bias = a.local(copy_to_model(self.bias.float(), a), 0)
        return (xc * torch.rsqrt(var + self.eps) * scale + bias).to(
            self.dtype)


def layer_norm(axis: Optional[ModelAxis], dim: int, eps: float,
               dtype: torch.dtype = torch.float32) -> LayerNorm:
    """A LayerNorm of channels that ``axis`` splits (None: whole)."""
    if axis is None:
        return LayerNorm(dim, eps, dtype)
    return ShardedLayerNorm(dim, eps, axis, dtype)


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
            generator: Optional[torch.Generator],
            axis: Optional[ModelAxis] = None, dim: int = -1) -> torch.Tensor:
    """Flax ``nn.Dropout`` drawing from ``generator`` (None: identity).
    With ``axis``, ``x`` is this rank's slice along ``dim`` of an
    activation split over the model axis: the mask is drawn at full width
    and this rank keeps its slice."""
    if axis is None:
        return apply_dropout(x, dropout_keep(x.shape, rate, generator), rate)
    shape = list(x.shape)
    shape[dim] *= axis.size
    keep = dropout_keep(shape, rate, generator)
    return apply_dropout(x, None if keep is None else axis.local(keep, dim),
                         rate)


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
