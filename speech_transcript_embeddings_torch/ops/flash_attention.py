"""Relative_key flash attention: CUDA forward kernel and its plain twin.

Port of ``speech_transcript_embeddings_tpu/ops/flash_attention.py``, forward
only (``_fwd_kernel``). The w2v-bert-2.0 conformer's self-attention with the
Shaw relative_key bias:

    s[i, j] = q_s[i]·k[j] + qE[i, clip(j − i, −L, R) + L],   q_s = q/√hd

with ``qE = q_s·Eᵀ``, keys past the clip's valid length at NEG = −1e30, and
``lse = m + log l`` written for the backward. Same signature and layout as
the JAX function: q, k, v ``[B·num_heads, T, hd]``, E ``[num_pos, hd]``,
``kv_mask [B, T]`` a contiguous-prefix mask reduced to one valid length per
batch row.

This PR is inference only: the backward kernel (the TPU's ``_bwd_kernel``)
comes with training as a ``torch.autograd.Function``, so the wrapper raises
when grad mode is on and an input requires grad rather than return a result
without a gradient.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from speech_transcript_embeddings_torch.ops import _build

BLOCK = 128          # the TPU kernel's key padding unit (t_pad = ⌈T/128⌉·128)
NEG = -1e30
MAX_NUM_POS = 128
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _t_pad(t: int) -> int:
    return -(-t // BLOCK) * BLOCK


def _scale(q: torch.Tensor) -> torch.Tensor:
    """1/√hd rounded to q's dtype, as the JAX wrapper scales q."""
    return torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)


def _lengths(kv_mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(kv_mask > 0, dim=-1).to(torch.int32)


def _check(q, k, v, dist_embedding, kv_mask, num_heads, left_max):
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B·h, T, hd] shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must be one of {list(_DTYPES)}: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    bh, t, hd = q.shape
    num_pos = dist_embedding.shape[0]
    if dist_embedding.shape != (num_pos, hd) or not 0 < num_pos <= MAX_NUM_POS:
        raise ValueError(f"dist_embedding {tuple(dist_embedding.shape)}: need "
                         f"[num_pos ≤ {MAX_NUM_POS}, {hd}]")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}")
    if not 0 <= left_max < num_pos:
        raise ValueError(f"left_max {left_max} outside [0, {num_pos})")
    if kv_mask.ndim != 2 or kv_mask.shape[1] != t or \
            kv_mask.shape[0] * num_heads != bh:
        raise ValueError(f"kv_mask {tuple(kv_mask.shape)} does not match "
                         f"{bh} rows of {num_heads} heads and T={t}")


def rel_attention_reference(q, k, v, dist_embedding, kv_mask, *,
                            num_heads: int, left_max: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the kernel → (out ``[B·h, T, hd]`` in q's dtype, lse
    ``[B·h, T, 1]`` fp32). Follows the TPU kernel's numerics: q_s and qE
    rounded to q's dtype, fp32 scores and softmax over the keys padded to a
    multiple of 128 (so a row with no valid key averages over t_pad keys),
    probabilities rounded to v's dtype for the value product."""
    _check(q, k, v, dist_embedding, kv_mask, num_heads, left_max)
    bh, t, hd = q.shape
    t_pad = _t_pad(t)
    num_pos = dist_embedding.shape[0]
    right = num_pos - 1 - left_max
    pad = (0, 0, 0, t_pad - t)
    q_s = q * _scale(q).to(q.device)
    qp, kp, vp = (torch.nn.functional.pad(x, pad).float()
                  for x in (q_s, k, v))
    e = dist_embedding.to(q.dtype).float()
    qe = (qp @ e.T).to(q.dtype).float()                      # [bh, t_pad, P]
    pos = torch.arange(t_pad, device=q.device)
    idx = torch.clamp(pos[None, :] - pos[:, None], -left_max, right) + left_max
    bias = torch.gather(qe, 2, idx[None].expand(bh, t_pad, t_pad))
    s = qp @ kp.transpose(1, 2) + bias
    lengths = torch.repeat_interleave(_lengths(kv_mask), num_heads)
    valid = pos[None, None, :] < lengths[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ vp
    out = (acc / l).to(q.dtype)[:, :t]
    return out, (m + torch.log(l))[:, :t]


def flash_attention_fwd(q, k, v, dist_embedding, kv_mask, *,
                        num_heads: int, left_max: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) through the CUDA kernel for CUDA tensors, through the twin
    for CPU tensors."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v, dist_embedding)):
        raise NotImplementedError(
            "flash_attention has no backward kernel yet (training is not "
            "ported; see ROADMAP.md): call it under torch.no_grad()")
    if q.device.type == "cpu":
        return rel_attention_reference(q, k, v, dist_embedding, kv_mask,
                                       num_heads=num_heads, left_max=left_max)
    _check(q, k, v, dist_embedding, kv_mask, num_heads, left_max)
    for x in (q, k, v, dist_embedding, kv_mask):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"flash_attention: expected CUDA tensors on one "
                             f"device, got {x.device}")
    bh, t, hd = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    e = dist_embedding.to(q.dtype).contiguous()
    lengths = _lengths(kv_mask).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((bh, t, 1), dtype=torch.float32, device=q.device)
    device, stream = _build.launch_args(q)
    code = _build.library().ste_flash_rel_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, t, _t_pad(t),
        hd, e.shape[0], left_max, num_heads, float(_scale(q)),
        _DTYPES[q.dtype], device, stream)
    _build.check(code, "ste_flash_rel_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, dist_embedding, kv_mask, *, num_heads: int,
                    left_max: int) -> torch.Tensor:
    """Relative_key attention outputs ``[B·num_heads, T, hd]`` (pre
    out-projection), q unscaled — the JAX ``flash_attention`` signature."""
    return flash_attention_fwd(q, k, v, dist_embedding, kv_mask,
                               num_heads=num_heads, left_max=left_max)[0]
