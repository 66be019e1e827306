"""LayerNorm with fp32 statistics that reads and writes the compute dtype:
a CUDA kernel pair and its plain version.

The port's ``models.layers.LayerNorm`` computes as flax's does under a
``dtype``: statistics, scale and bias in fp32, the output in ``dtype``. In
eager PyTorch that is a chain (the input cast to fp32, γ and β widened,
ATen's fp32 LayerNorm, the output cast back) of 3 to 6 launches a call and
≈ 20 bytes an element, whose backward saves the fp32 copy of the input.
``csrc/layer_norm.cu`` computes the same function in one forward kernel
(x, γ and β read in their stored dtypes, μ and rstd saved in fp32) and a
backward of one kernel for dx, and one more for dγ and dβ where they are
wanted; it replaces no TPU kernel (JAX leaves LayerNorm to XLA).

CPU tensors take ``layer_norm_reference``, the chain itself, bit for bit.
CUDA tensors launch the kernels or raise: rows of a width that is a
multiple of 8 up to ``MAX_WIDTH``, in bf16 or fp32, γ and β of one dtype.
An input that is not contiguous is copied once, in its own dtype.
``LAUNCHES`` counts each kernel's launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from speech_transcript_embeddings_torch.ops import _build

MAX_WIDTH = 4096
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# launches of each CUDA kernel, counted where it is launched
LAUNCHES = collections.Counter()


def layer_norm_reference(x, weight, bias, eps: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """The plain version: the input, γ and β in fp32, ATen's LayerNorm,
    the output rounded to ``dtype``. Differentiable by autograd."""
    return F.layer_norm(x.float(), weight.shape, weight.float(), bias.float(),
                        eps).to(dtype)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or in fp64 where it is fp64 (the formula's tests)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def layer_norm_stats_reference(x, eps: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """μ and rstd = 1/√(σ² + eps) of each row, fp32 (two passes, as the
    forward kernel keeps them), flattened over the leading dimensions."""
    xf = _wide(x).reshape(-1, x.shape[-1])
    mean = xf.mean(-1)
    var = (xf - mean[:, None]).square().mean(-1)
    return mean, 1.0 / torch.sqrt(var + eps)


def layer_norm_bwd_reference(dy, x, weight, mean, rstd
                             ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernels → (dx in x's dtype, dγ, dβ in
    fp32): with x̂ = (x − μ)·rstd and g = dy·γ,
    dx = rstd·(g − mean(g) − x̂·mean(g·x̂)), dγ = Σ dy·x̂, dβ = Σ dy over
    the rows. ``mean`` and ``rstd`` are one value a row."""
    n = x.shape[-1]
    xf, dyf = _wide(x).reshape(-1, n), _wide(dy).reshape(-1, n)
    mean, rstd = _wide(mean)[:, None], _wide(rstd)[:, None]
    xhat = (xf - mean) * rstd
    g = dyf * _wide(weight)
    dx = rstd * (g - g.mean(-1, keepdim=True)
                 - xhat * (g * xhat).mean(-1, keepdim=True))
    return (dx.reshape(x.shape).to(x.dtype), (dyf * xhat).sum(0),
            dyf.sum(0))


def _check(x, weight, bias, dtype):
    n = x.shape[-1]
    if weight.shape != (n,) or bias.shape != (n,):
        raise ValueError(f"weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} must be [{n}]")
    if n % 8 or not 8 <= n <= MAX_WIDTH:
        raise ValueError(f"layer_norm kernel: width {n} is not a multiple "
                         f"of 8 in [8, {MAX_WIDTH}]")
    if x.dtype not in _DTYPES or dtype not in _DTYPES or \
            weight.dtype not in _DTYPES or weight.dtype != bias.dtype:
        raise ValueError(f"layer_norm kernel: input {x.dtype}, output "
                         f"{dtype}, weight {weight.dtype}, bias {bias.dtype}"
                         f": need {list(_DTYPES)}, weight and bias alike")
    device = x.get_device()                   # -1 off the card
    if device < 0 or weight.get_device() != device or \
            bias.get_device() != device:
        raise ValueError(f"layer_norm kernel: expected CUDA tensors on one "
                         f"device, got {x.device}, {weight.device}, "
                         f"{bias.device}")


def _fwd(x, weight, bias, eps: float, dtype: torch.dtype):
    """→ (y in ``dtype``, the input as the kernel read it, μ, rstd)."""
    _check(x, weight, bias, dtype)
    x, weight, bias = (_build.aligned(t) for t in (x, weight, bias))
    n = x.shape[-1]
    rows = x.numel() // n
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if rows:
        device, stream = _build.launch_args(x)
        code = _build.library().ste_layer_norm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, n, eps, _DTYPES[x.dtype],
            _DTYPES[dtype], _DTYPES[weight.dtype], device, stream)
        _build.check(code, "ste_layer_norm_fwd")
        LAUNCHES["layer_norm_fwd"] += 1
    return y, x, mean, rstd


@functools.lru_cache(maxsize=None)
def _bwd_blocks(rows: int, width: int, device: int) -> int:
    """The persistent backward's grid (fixed for a shape and a card, so
    the partial sums, and the bits, repeat)."""
    blocks = ctypes.c_int(0)
    code = _build.library().ste_layer_norm_bwd_blocks(
        rows, width, device, ctypes.addressof(blocks))
    _build.check(code, "ste_layer_norm_bwd_blocks")
    return blocks.value


def _bwd(dy, x, weight, mean, rstd, need_dx: bool, need_affine: bool
         ) -> Tuple[Optional[torch.Tensor], ...]:
    """→ (dx in x's dtype, dγ, dβ in fp32), each None where not wanted;
    ``x`` as ``_fwd`` returned it."""
    n = x.shape[-1]
    rows = x.numel() // n
    dy = _build.aligned(dy)
    dx = torch.empty_like(x) if need_dx else None
    dgamma = dbeta = part = None
    if need_affine:       # every column is written (a sum over no row: 0)
        new = torch.empty if rows else torch.zeros
        dgamma, dbeta = (new(n, dtype=torch.float32, device=x.device)
                         for _ in range(2))
    if not rows:
        return dx, dgamma, dbeta
    device, stream = _build.launch_args(x)
    blocks = 0
    if need_affine:
        blocks = _bwd_blocks(rows, n, device)
        part = torch.empty((2, blocks, n), dtype=torch.float32,
                           device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    code = _build.library().ste_layer_norm_bwd(
        dy.data_ptr(), x.data_ptr(), weight.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), ptr(dx), ptr(part), ptr(dgamma), ptr(dbeta), rows,
        n, blocks, _DTYPES[x.dtype], _DTYPES[dy.dtype], _DTYPES[weight.dtype],
        device, stream)
    _build.check(code, "ste_layer_norm_bwd")
    LAUNCHES["layer_norm_bwd_dx"] += 1
    if need_affine:
        LAUNCHES["layer_norm_bwd_dgamma"] += 1
    return dx, dgamma, dbeta


class _LayerNorm(torch.autograd.Function):
    """The forward kernel, and the backward kernels in reverse: saves the
    input in its own dtype (contiguous) and μ, rstd in fp32. It keeps no
    state between calls, so a remat replay calls it again as it is."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype):
        y, xc, mean, rstd = _fwd(x, weight, bias, eps, dtype)
        ctx.save_for_backward(xc, weight, mean, rstd)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dgamma, dbeta = _bwd(dy, x, _build.aligned(weight), mean, rstd,
                                 need_x, need_w or need_b)
        cast = lambda g, need: g.to(weight.dtype) if need else None
        return dx, cast(dgamma, need_w), cast(dbeta, need_b), None, None


def layer_norm(x, weight, bias, eps: float, dtype: torch.dtype
               ) -> torch.Tensor:
    """LayerNorm of the last dimension with fp32 statistics, γ and β
    (widened from their stored dtype), output in ``dtype``: the kernels
    for CUDA tensors (differentiable), ``layer_norm_reference`` for CPU
    tensors."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps, dtype)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps, dtype)
    return _fwd(x, weight, bias, eps, dtype)[0]
