"""Int8 dynamic quantization of the serving path's Dense products (W8A8).

Port of ``speech_transcript_embeddings_tpu/ops/quant.py``, computed as it
computes:

  * weights: ``s_w = max(max|w| over the input axis, 1e-12) / 127`` in
    fp32 (a product with the fp32 reciprocal of 127, as XLA rewrites the
    division by a constant), one scale per output channel, and ``q =
    clip(round(w / s_w), -127, 127)`` as int8. A weight with a dim below
    ``MIN_QUANT_DIM`` stays as it is (the attentive-pooling score head
    ``[H/2, 1]`` gains nothing and loses the most);
  * activations: per row ``s_x = max(max|x|, 1e-12) / 127`` (the same
    way) and ``x_q = clip(round(x / s_x), -127, 127)`` (a division, as
    ``jnp.round(xf / sx)``; both round half to even);
  * the product ``int32 = x_q · q``, then ``out = int32 · s_x · s_w (+ bias
    in fp32)``, cast to the module's compute dtype.

The product is ``torch._int_mm`` on the card (cuBLASLt int8): the JAX
package leaves it to XLA (``lax.dot_general`` int8×int8→int32) outside any
Pallas kernel. On the CPU it is the plain int32 product, which gives the
same integers. On the card (torch 2.11, cuBLASLt; chip_smoke.py phase 4)
``_int_mm`` refuses 16 rows or fewer and inner or output dims that are not
multiples of 8: ``int8_matmul`` pads fewer rows with zero rows (a zero row
quantizes to 0) and slices them off; ``quantize_module`` refuses a weight
on the card whose dims are not multiples of 8, so nothing falls back to
bf16. ``Int8Dense`` keeps ``weight_q`` as ``[out, in]`` (the transpose of
JAX's ``kernel_q``) and passes its transposed view: ``_int_mm`` takes the
view as it is, with no copy, in the layout cuBLASLt's int8 tensor-core
kernels want (x row-major, the weight column-major); a contiguous ``[in,
out]`` weight gives the same integers 4.6× slower (0.284 against 0.062 ms
at 4096 × 1024 × 4096 on an NVIDIA H100 80GB HBM3 at 700 W). The quantize
and rescale passes are plain tensor code. Inference only: there is no
gradient path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# a weight smaller than this on either axis stays in its own dtype
MIN_QUANT_DIM = 32
_PAD_ROWS = 32        # torch._int_mm on CUDA takes more than 16 rows
_INV_127 = float(np.float32(1.0 / 127.0))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127`` as XLA computes it under ``jit``: times
    the fp32 reciprocal of 127 (1 ulp from the quotient in ≈5% of
    elements)."""
    return torch.clamp(amax, min=1e-12) * _INV_127


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Dense weight ``[out, in]`` (any float dtype) → (``q`` int8
    ``[out, in]``, ``scale`` fp32 ``[out]``)."""
    w = w.float()
    scale = _scale(w.abs().amax(dim=1, keepdim=True))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 ``[M, K]`` × int8 ``[K, N]`` (the transposed view of an
    ``[N, K]`` weight) → the exact int32 ``[M, N]``: ``torch._int_mm`` on
    the card (counted in ``launches``), the plain int32 product on the
    CPU."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ wq.to(torch.int32)
    m = xq.shape[0]
    if m <= 16:
        xq = F.pad(xq, (0, 0, 0, _PAD_ROWS - m))
    out = torch._int_mm(xq, wq)
    int8_matmul.launches += 1
    return out[:m]


int8_matmul.launches = 0


def quantize_activations(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [..., K]`` → (int8 ``x_q``, fp32 per-row scale ``[..., 1]``)."""
    xf = x.float()
    sx = _scale(xf.abs().amax(dim=-1, keepdim=True))
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


class Int8Dense(nn.Module):
    """A quantized ``Dense``: ``weight_q`` int8 ``[out, in]``,
    ``weight_scale`` fp32 ``[out]`` and the bias in fp32, all buffers (the
    float weight is gone); computes in the W8A8 scheme above and returns
    ``dtype``."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        q, scale = quantize_weight(weight)
        self.register_buffer("weight_q", q)
        self.register_buffer("weight_scale", scale)
        self.register_buffer("bias", None if bias is None else bias.float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, sx = quantize_activations(x)
        n, k = self.weight_q.shape
        acc = int8_matmul(xq.reshape(-1, k), self.weight_q.t())
        out = acc.reshape(*x.shape[:-1], n).float() * sx * self.weight_scale
        if self.bias is not None:
            out = out + self.bias
        return out.to(self.dtype)


def quantize_module(weight: torch.Tensor, bias: Optional[torch.Tensor],
                    dtype: torch.dtype, device: torch.device
                    ) -> Optional[Int8Dense]:
    """The ``Int8Dense`` of a Dense with this (stored) weight and bias on
    ``device``, or None where ``MIN_QUANT_DIM`` leaves it as it is. On the
    card a dim that is not a multiple of 8 raises: cuBLASLt's int8 product
    does not take it."""
    out_dim, in_dim = weight.shape
    if min(out_dim, in_dim) < MIN_QUANT_DIM:
        return None
    if device.type == "cuda" and (out_dim % 8 or in_dim % 8):
        raise ValueError(
            f"a Dense weight [{out_dim}, {in_dim}] cannot be served in int8 "
            "on the card: torch._int_mm takes dims that are multiples of 8")
    return Int8Dense(weight.to(device), None if bias is None else
                     bias.to(device), dtype)
