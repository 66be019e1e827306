"""The conformer conv module's GLU and causal depthwise convolution on
``[B, T, ·]``: a CUDA kernel pair and its plain versions.

``ConvModule`` maps the pointwise1 output ``x`` ``[B, T, 2C]`` to the
depthwise norm's input ``y`` ``[B, T, C]``: ``a, g = x.chunk(2, -1)``,
``u = a·σ(g)``, ``y[t] = Σ_{k<K} w[c, k]·u[t − (K−1) + k]`` (u = 0 before
t = 0), with the weight ``[C, 1, K]`` (Conv1d layout). Eager PyTorch ran it
as a chain (sigmoid, mul, a transpose padded to ``[B, C, T + K − 1]``,
ATen's depthwise convolution with the weight cast to the compute dtype, the
transpose back) that moved each element about seven times.
``csrc/depthwise_glu.cu`` computes it in one forward kernel (x read once,
y written once, the GLU and the taps in fp32, y rounded once) and a
backward of one kernel for dx, with one more that sums the weight
gradient's fp32 partials where the weight needs its gradient; dw comes
back in the weight's own dtype. It replaces no TPU kernel (the JAX
package leaves the module to XLA).

CPU tensors take ``depthwise_glu_chain``, the chain itself, bit for bit.
CUDA tensors launch the kernels or raise: activations in bf16 or fp32, the
weight in bf16 or fp32 (read as it is stored: fp32 where it trains, bf16
where ``create_train_state`` froze it), C a multiple of 8 and K up to
``MAX_TAPS``. ``depthwise_glu_reference`` and ``depthwise_glu_bwd_reference``
repeat the kernels' arithmetic in plain PyTorch. ``LAUNCHES`` counts each
kernel's launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from speech_transcript_embeddings_torch.ops import _build

MAX_TAPS = 31
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# launches of each CUDA kernel, counted where it is launched
LAUNCHES = collections.Counter()


def depthwise_glu_chain(x: torch.Tensor, weight: torch.Tensor
                        ) -> torch.Tensor:
    """The chain ``ConvModule`` ran before the kernels, in x's dtype (the
    weight cast to it), as a transposed view ``[B, T, C]``."""
    a, g = x.chunk(2, dim=-1)
    u = (a * torch.sigmoid(g)).transpose(1, 2)                 # [B, C, T]
    return F.conv1d(F.pad(u, (weight.shape[-1] - 1, 0)), weight.to(x.dtype),
                    groups=weight.shape[0]).transpose(1, 2)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or in fp64 where it is fp64 (the formula's tests)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _glu(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """→ (a, σ(g), u = a·σ(g)), widened."""
    a, g = _wide(x).chunk(2, dim=-1)
    s = torch.sigmoid(g)
    return a, s, a * s


def depthwise_glu_reference(x: torch.Tensor, weight: torch.Tensor
                            ) -> torch.Tensor:
    """The plain version of the forward kernel: the GLU and the taps in
    fp32 (tap 0 first), y rounded once to x's dtype. Differentiable by
    autograd."""
    u = _glu(x)[2]
    w = _wide(weight)[:, 0, :]
    k, t = w.shape[-1], u.shape[1]
    up = F.pad(u, (0, 0, k - 1, 0))                 # zeros before t = 0
    y = sum(w[:, j] * up[:, j:j + t] for j in range(k))
    return y.to(x.dtype)


def depthwise_glu_bwd_reference(dy: torch.Tensor, x: torch.Tensor,
                                weight: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels → (dx in x's dtype, dw in the
    weight's): ``du[t] = Σ_k w[c, k]·dy[t + (K−1) − k]``, ``da = du·σ``,
    ``dg = du·a·σ·(1 − σ)``, ``dw[c, k] = Σ_{b,t} u[t]·dy[t + (K−1) − k]``
    (dy = 0 past T), in fp32."""
    a, s, u = _glu(x)
    w = _wide(weight)[:, 0, :]
    k, t = w.shape[-1], u.shape[1]
    dyp = F.pad(_wide(dy), (0, 0, 0, k - 1))        # zeros past T
    shifted = [dyp[:, k - 1 - j:k - 1 - j + t] for j in range(k)]
    du = sum(w[:, j] * shifted[j] for j in range(k))
    dx = torch.cat([du * s, du * a * s * (1 - s)], dim=-1).to(x.dtype)
    dw = torch.stack([(u * shifted[j]).sum((0, 1)) for j in range(k)], -1)
    return dx, dw[:, None, :].to(weight.dtype)


def _check(x: torch.Tensor, weight: torch.Tensor) -> None:
    if x.dim() != 3 or x.shape[-1] % 2:
        raise ValueError(f"depthwise_glu kernel: x {tuple(x.shape)} must be "
                         "[B, T, 2C]")
    c = x.shape[-1] // 2
    if weight.dim() != 3 or tuple(weight.shape[:2]) != (c, 1):
        raise ValueError(f"depthwise_glu kernel: weight "
                         f"{tuple(weight.shape)} must be [{c}, 1, K]")
    if c % 8 or c < 8 or not 1 <= weight.shape[-1] <= MAX_TAPS:
        raise ValueError(f"depthwise_glu kernel: C {c} is not a multiple of "
                         f"8, or K {weight.shape[-1]} is not in [1, "
                         f"{MAX_TAPS}]")
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise ValueError(f"depthwise_glu kernel: x {x.dtype}, weight "
                         f"{weight.dtype}: need {list(_DTYPES)}")
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"depthwise_glu kernel: expected CUDA tensors on "
                         f"one device, got {x.device}, {weight.device}")


@functools.lru_cache(maxsize=None)
def _blocks(batch: int, time: int, channels: int, device: int
            ) -> Tuple[int, int]:
    """The persistent grids' blocks a channel slice, forward and backward
    (fixed for a shape and a card, so the weight gradient's partial sums,
    and the bits, repeat)."""
    fwd, bwd = ctypes.c_int(0), ctypes.c_int(0)
    code = _build.library().ste_depthwise_glu_blocks(
        batch, time, channels, device, ctypes.addressof(fwd),
        ctypes.addressof(bwd))
    _build.check(code, "ste_depthwise_glu_blocks")
    return fwd.value, bwd.value


def _fwd(x: torch.Tensor, weight: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (y in x's dtype, x as the kernel read it)."""
    _check(x, weight)
    x, weight = _build.aligned(x), _build.aligned(weight)
    b, t, c2 = x.shape
    y = torch.empty((b, t, c2 // 2), dtype=x.dtype, device=x.device)
    if y.numel():
        device, stream = _build.launch_args(x)
        code = _build.library().ste_depthwise_glu_fwd(
            x.data_ptr(), weight.data_ptr(), y.data_ptr(), b, t, c2 // 2,
            weight.shape[-1], _blocks(b, t, c2 // 2, device)[0],
            _DTYPES[x.dtype], _DTYPES[weight.dtype], device, stream)
        _build.check(code, "ste_depthwise_glu_fwd")
        LAUNCHES["depthwise_glu_fwd"] += 1
    return y, x


def _bwd(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
         need_dx: bool, need_dw: bool
         ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """→ (dx in x's dtype, dw in the weight's), each None where not
    wanted; ``x`` and ``weight`` as ``_fwd`` read them."""
    b, t, c2 = x.shape
    c, k = c2 // 2, weight.shape[-1]
    dx = torch.empty_like(x) if need_dx else None
    dw = part = None
    if need_dw:           # every tap is written (a sum over no time: 0)
        dw = (torch.empty if x.numel() else torch.zeros)(
            weight.shape, dtype=weight.dtype, device=x.device)
    if not x.numel() or not (need_dx or need_dw):
        return dx, dw
    dy = _build.aligned(dy.to(x.dtype))
    device, stream = _build.launch_args(x)
    blocks = _blocks(b, t, c, device)[1]
    if need_dw:
        part = torch.empty((blocks, MAX_TAPS, c), dtype=torch.float32,
                           device=x.device)
    ptr = lambda v: None if v is None else v.data_ptr()
    code = _build.library().ste_depthwise_glu_bwd(
        dy.data_ptr(), x.data_ptr(), weight.data_ptr(), ptr(dx), ptr(part),
        ptr(dw), b, t, c, k, blocks, _DTYPES[x.dtype], _DTYPES[weight.dtype],
        device, stream)
    _build.check(code, "ste_depthwise_glu_bwd")
    LAUNCHES["depthwise_glu_bwd_dx"] += 1
    if need_dw:
        LAUNCHES["depthwise_glu_bwd_dw"] += 1
    return dx, dw


class _DepthwiseGlu(torch.autograd.Function):
    """The forward kernel, and the backward kernels in reverse: saves x as
    the forward read it (one ``[B, T, 2C]`` tensor) and the weight.
    It keeps no state between calls, so a remat replay calls it again as
    it is."""

    @staticmethod
    def forward(ctx, x, weight):
        y, xc = _fwd(x, weight)
        ctx.save_for_backward(xc, weight)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        return _bwd(dy, x, _build.aligned(weight), *ctx.needs_input_grad)


def depthwise_glu(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """y ``[B, T, C]`` in x's dtype from the pointwise1 output x
    ``[B, T, 2C]`` and the depthwise weight ``[C, 1, K]``: the kernels for
    CUDA tensors (differentiable), ``depthwise_glu_chain`` where both lie
    on the CPU."""
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return depthwise_glu_chain(x, weight)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _DepthwiseGlu.apply(x, weight)
    return _fwd(x, weight)[0]
