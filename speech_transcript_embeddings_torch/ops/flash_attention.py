"""Relative_key flash attention: CUDA forward and backward kernels and their
plain twins.

Port of ``speech_transcript_embeddings_tpu/ops/flash_attention.py``
(``_fwd_kernel`` and ``_bwd_kernel``). The w2v-bert-2.0 conformer's
self-attention with the Shaw relative_key bias:

    s[i, j] = q_s[i]·k[j] + qE[i, clip(j − i, −L, R) + L],   q_s = q/√hd

with ``qE = q_s·Eᵀ``, keys past the clip's valid length at NEG = −1e30 (an
additive mask, as the TPU kernels apply it), and ``lse = m + log l`` kept
for the backward. Same signature and layout as the JAX function: q, k, v
``[B·num_heads, T, hd]``, E ``[num_pos, hd]``, ``kv_mask [B, T]`` a
contiguous-prefix mask reduced to one valid length per batch row.

Each direction has two CUDA routes: a tensor-core one for bf16 with a head
dim that is a multiple of 16 (the conformer's case), on Hopper's wgmma fed
by TMA (``csrc/flash_rel_fwd_sm90.cu``, ``csrc/flash_rel_bwd_sm90.cu``),
and a CUDA-core one for fp32 and other head dims (``csrc/flash_rel_fwd.cu``,
``csrc/flash_rel_bwd.cu``); ``flash_kernel`` is the rule that picks one, and
``LAUNCHES`` counts each kernel's launches. CPU tensors take the plain
twins. The public wrappers check their inputs once; the launch functions
behind them trust them.

``flash_attention`` is differentiable: its backward is the K4 kernel pair
for CUDA tensors and ``rel_attention_bwd_reference`` (the same math in
plain PyTorch) for CPU tensors. Its
``residuals`` list keeps the forward's (out, lse) across a remat replay, so
the replay does not launch the forward kernel again (the JAX
``save_residuals`` variant).
"""

from __future__ import annotations

import collections
import functools
import math
from typing import Optional, Tuple

import torch

from speech_transcript_embeddings_torch.ops import _build

BLOCK = 128          # the TPU kernel's key padding unit (t_pad = ⌈T/128⌉·128)
NEG = -1e30
MAX_NUM_POS = 128
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the mask dtypes the wgmma forward reads itself (others arrive as `> 0`)
_MASK_KINDS = {torch.bool: 0, torch.int32: 1, torch.float32: 2}
# launches of each CUDA kernel (pair), counted where it is launched
LAUNCHES = collections.Counter()


def _t_pad(t: int) -> int:
    return -(-t // BLOCK) * BLOCK


@functools.lru_cache(maxsize=None)
def _scale(dtype: torch.dtype, head_dim: int) -> float:
    """1/√hd rounded to ``dtype``, as the JAX wrapper scales q: a Python
    float (exact in ``dtype``), so that a launch builds no tensor for it and
    ``q * _scale(...)`` rounds once, as the product with a 0-dim tensor of
    ``dtype`` does."""
    return float(torch.tensor(1.0 / math.sqrt(head_dim), dtype=dtype))


def _lengths(kv_mask: torch.Tensor) -> torch.Tensor:
    """int32 count of the positive entries of each row of ``kv_mask``, for
    the twins and the kernels that take lengths (one ATen op fewer than
    ``sum(mask > 0).to(int32)``; no comparison for a bool mask). The wgmma
    forward counts them itself."""
    valid = kv_mask if kv_mask.dtype == torch.bool else kv_mask > 0
    return valid.sum(-1, dtype=torch.int32)


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


def _require_cuda(name, *tensors):
    device = tensors[0].get_device()           # -1 off the card
    if device < 0 or any(x.get_device() != device for x in tensors):
        raise ValueError(f"{name}: expected CUDA tensors on one device, got "
                         f"{', '.join(str(x.device) for x in tensors)}")


def _key_mask(kv_mask, num_heads, t_pad, device) -> torch.Tensor:
    """``[B·h, 1, t_pad]`` additive key mask: 0 below the clip's length,
    NEG from it on (the padded keys t..t_pad-1 included)."""
    lengths = torch.repeat_interleave(_lengths(kv_mask), num_heads)
    pos = torch.arange(t_pad, device=device)
    return torch.where(pos[None, None, :] < lengths[:, None, None], 0.0, NEG)


def _dist_index(t_rows, t_pad, left_max, right, device) -> torch.Tensor:
    """``[t_rows, t_pad]`` column of qE for each (query, key) pair."""
    rows = torch.arange(t_rows, device=device)
    cols = torch.arange(t_pad, device=device)
    return torch.clamp(cols[None, :] - rows[:, None], -left_max, right) + left_max


def rel_attention_reference(q, k, v, dist_embedding, kv_mask, *,
                            num_heads: int, left_max: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the forward kernel → (out ``[B·h, T, hd]`` in q's
    dtype, lse ``[B·h, T, 1]`` fp32). Follows the TPU kernel's numerics:
    q_s and qE rounded to q's dtype, fp32 scores with the additive key mask
    and softmax over the keys padded to a multiple of 128 (so a row with no
    valid key averages over t_pad keys), probabilities rounded to v's dtype
    for the value product. Differentiable by autograd."""
    _check(q, k, v, dist_embedding, kv_mask, num_heads, left_max)
    bh, t, hd = q.shape
    t_pad = _t_pad(t)
    num_pos = dist_embedding.shape[0]
    pad = (0, 0, 0, t_pad - t)
    q_s = q * _scale(q.dtype, hd)
    qp, kp, vp = (torch.nn.functional.pad(x, pad).float()
                  for x in (q_s, k, v))
    e = dist_embedding.to(q.dtype).float()
    qe = (qp @ e.T).to(q.dtype).float()                      # [bh, t_pad, P]
    idx = _dist_index(t_pad, t_pad, left_max, num_pos - 1 - left_max, q.device)
    bias = torch.gather(qe, 2, idx[None].expand(bh, t_pad, t_pad))
    s = qp @ kp.transpose(1, 2) + bias + _key_mask(kv_mask, num_heads, t_pad,
                                                   q.device)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ vp
    out = (acc / l).to(q.dtype)[:, :t]
    return out, (m + torch.log(l))[:, :t]


def rel_attention_bwd_reference(q, k, v, dist_embedding, kv_mask, out, lse,
                                dout, *, num_heads: int, left_max: int
                                ) -> Tuple[torch.Tensor, ...]:
    """Plain twin of the backward kernel → (dq, dk, dv in q's dtype, dE in
    E's dtype), the math of the TPU ``_bwd_kernel``: p = exp(s − lse) from
    the forward's lse, dd = rowsum(dO∘O), ds = p·(dp − dd); dq and dk take
    ds rounded to the input dtype, the bias gradient
    ``dqE[i, clip(j − i) + L] += ds[i, j]`` stays fp32 (padded keys
    included), dq += round(dqE)·E, dE = Σ dqEᵀ·q_s, and dq is scaled by
    1/√hd in fp32 and rounded again.

    For a clip with no valid key the TPU kernel's lse is NEG (log t_pad
    vanishes beside 1e30 in fp32), so p = 1 on every key, not 1/t_pad; this
    twin and the CUDA kernel reproduce that, where autograd through
    ``rel_attention_reference`` gives the exact softmax gradient."""
    _check(q, k, v, dist_embedding, kv_mask, num_heads, left_max)
    bh, t, hd = q.shape
    dt = q.dtype
    t_pad = _t_pad(t)
    num_pos = dist_embedding.shape[0]
    pad = (0, 0, 0, t_pad - t)
    q_s = (q * _scale(dt, hd)).float()                        # [bh, t, hd]
    kp, vp = (torch.nn.functional.pad(x, pad).float() for x in (k, v))
    e = dist_embedding.to(dt).float()
    do = dout.to(dt).float()
    dd = torch.sum(do * out.float(), dim=-1, keepdim=True)    # [bh, t, 1]
    qe = (q_s @ e.T).to(dt).float()                           # [bh, t, P]
    idx = _dist_index(t, t_pad, left_max, num_pos - 1 - left_max,
                      q.device)[None].expand(bh, t, t_pad)
    s = q_s @ kp.transpose(1, 2) + torch.gather(qe, 2, idx) + _key_mask(
        kv_mask, num_heads, t_pad, q.device)
    p = torch.exp(s - lse)                                    # [bh, t, t_pad]
    dv = p.to(dt).float().transpose(1, 2) @ do
    ds = p * (do @ vp.transpose(1, 2) - dd)
    ds_c = ds.to(dt).float()
    dq = ds_c @ kp
    dk = ds_c.transpose(1, 2) @ q_s
    dqe = torch.zeros((bh, t, num_pos), dtype=torch.float32,
                      device=q.device).scatter_add_(2, idx, ds)
    dq = dq + dqe.to(dt).float() @ e
    de = torch.einsum("bip,bid->pd", dqe, q_s)
    dq = (dq.to(dt).float() * (1.0 / math.sqrt(hd))).to(dt)
    return (dq, dk[:, :t].to(dt), dv[:, :t].to(dt),
            de.to(dist_embedding.dtype))


def flash_kernel(dtype: torch.dtype, head_dim: int) -> str:
    """The dispatch rule for CUDA tensors: ``"mma"`` (the tensor-core
    kernels, bf16 operands with fp32 accumulate, as the TPU's MXU computes)
    for bf16 with a head dim that is a multiple of 16 up to 128; ``"simt"``
    (the CUDA-core kernels, fp32 throughout) for everything else — fp32
    inputs, whose 1e-4 tolerance tensor cores cannot meet, and odd head
    dims."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 and \
            head_dim <= MAX_HEAD_DIM:
        return "mma"
    return "simt"


def _np_pad(num_pos: int) -> int:
    """E's rows padded to the mma k-step (16) in the tensor-core kernels."""
    return -(-num_pos // 16) * 16


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte aligned start (the kernels read 16
    bytes at a time; TMA needs it)."""
    if not x.is_contiguous():
        x = x.detach().contiguous()
    return x if x.data_ptr() % 16 == 0 else x.detach().clone()


def _fwd_launch(kernel, q, k, v, dist_embedding, kv_mask, num_heads,
                left_max):
    """Launch forward kernel ``kernel`` ("mma": the wgmma kernel, or
    "simt") → (out, lse), for CUDA inputs that ``_check`` passed and that
    the route takes (``flash_kernel``)."""
    bh, t, hd = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    e = _aligned(dist_embedding.to(q.dtype))
    out = torch.empty_like(q)
    lse = torch.empty((bh, t, 1), dtype=torch.float32, device=q.device)
    device, stream = _build.launch_args(q)
    shape = (bh, t, _t_pad(t), hd, e.shape[0], left_max, num_heads,
             _scale(q.dtype, hd))
    if kernel == "mma":
        # each block counts its clip's valid keys in the mask itself
        mask = kv_mask if kv_mask.dtype in _MASK_KINDS else kv_mask > 0
        if not mask.is_contiguous():
            mask = mask.contiguous()
        code = _build.library().ste_flash_rel_fwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(),
            mask.data_ptr(), _MASK_KINDS[mask.dtype], out.data_ptr(),
            lse.data_ptr(), *shape, device, stream)
        _build.check(code, "ste_flash_rel_fwd_wgmma")
        LAUNCHES["flash_rel_fwd_wgmma"] += 1
    else:
        lengths = _lengths(kv_mask)
        code = _build.library().ste_flash_rel_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), lse.data_ptr(), *shape,
            _DTYPES[q.dtype], device, stream)
        _build.check(code, "ste_flash_rel_fwd")
        LAUNCHES["flash_rel_fwd"] += 1
    return out, lse


def flash_attention_fwd(q, k, v, dist_embedding, kv_mask, *,
                        num_heads: int, left_max: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) through the forward kernel that ``flash_kernel`` picks for
    CUDA tensors, through the twin for CPU tensors; no gradient
    (``flash_attention`` differentiates)."""
    if q.device.type == "cpu":
        with torch.no_grad():
            return rel_attention_reference(
                q, k, v, dist_embedding, kv_mask, num_heads=num_heads,
                left_max=left_max)
    _check(q, k, v, dist_embedding, kv_mask, num_heads, left_max)
    _require_cuda("flash_attention", q, k, v, dist_embedding, kv_mask)
    return _fwd_launch(flash_kernel(q.dtype, q.shape[-1]), q, k, v,
                       dist_embedding, kv_mask, num_heads, left_max)


def _bwd_launch(kernel, q, k, v, dist_embedding, kv_mask, out, lse, dout,
                num_heads, left_max):
    """Launch backward kernel pair ``kernel`` ("mma": the wgmma pair, or
    "simt") → (dq, dk, dv, dE), for CUDA inputs that ``_check`` passed and
    that the route takes, E in q's dtype."""
    bh, t, hd = q.shape
    num_pos = dist_embedding.shape[0]
    q, k, v, e = (_aligned(x) for x in (q, k, v, dist_embedding))
    do = _aligned(dout.to(q.dtype))
    lse = lse.detach().float().contiguous()
    lengths = _lengths(kv_mask)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    q_tiles = -(-t // 64)                   # the kernels' query tile
    de_part = torch.empty((bh * q_tiles, num_pos, hd), dtype=torch.float32,
                          device=q.device)
    device, stream = _build.launch_args(q)
    lib = _build.library()
    if kernel == "mma":
        # scratch that kernel A writes and kernel B reads: q_s, qE (bf16,
        # exact) and dd = rowsum(dO∘O)
        o = _aligned(out.to(q.dtype))
        q_s = torch.empty_like(q)
        qe = torch.empty((bh, t, _np_pad(num_pos)), dtype=q.dtype,
                         device=q.device)
        dd = torch.empty((bh, t), dtype=torch.float32, device=q.device)
        code = lib.ste_flash_rel_bwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), q_s.data_ptr(),
            qe.data_ptr(), dd.data_ptr(), de_part.data_ptr(), bh, t,
            _t_pad(t), hd, num_pos, left_max, num_heads, _scale(q.dtype, hd),
            1.0 / math.sqrt(hd), device, stream)
        _build.check(code, "ste_flash_rel_bwd_wgmma")
        LAUNCHES["flash_rel_bwd_wgmma"] += 1
    else:
        # dd = rowsum(dO∘O) in fp32 (outside the kernel, as in the JAX
        # wrapper); the mixed-dtype product casts O on the fly instead of
        # materialising an fp32 copy of it
        dd = torch.sum(do.float() * out.detach(), dim=-1).contiguous()
        qe = torch.empty((bh, t, num_pos), dtype=torch.float32,
                         device=q.device)
        code = lib.ste_flash_rel_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(),
            lengths.data_ptr(), do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), qe.data_ptr(),
            de_part.data_ptr(), bh, t, _t_pad(t), hd, num_pos, left_max,
            num_heads, _scale(q.dtype, hd), 1.0 / math.sqrt(hd),
            _DTYPES[q.dtype], device, stream)
        _build.check(code, "ste_flash_rel_bwd")
        LAUNCHES["flash_rel_bwd"] += 1
    de = torch.sum(de_part, dim=0).to(e.dtype)
    return dq, dk, dv, de


def flash_attention_bwd(q, k, v, dist_embedding, kv_mask, out, lse, dout, *,
                        num_heads: int, left_max: int
                        ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dE) through the backward kernel pair that
    ``flash_kernel`` picks for CUDA tensors, through
    ``rel_attention_bwd_reference`` for CPU tensors. ``dist_embedding`` is
    E in the dtype the forward used; dE comes back in it."""
    if q.device.type == "cpu":
        return rel_attention_bwd_reference(
            q, k, v, dist_embedding, kv_mask, out, lse, dout,
            num_heads=num_heads, left_max=left_max)
    _check(q, k, v, dist_embedding, kv_mask, num_heads, left_max)
    _require_cuda("flash_attention_bwd", q, k, v, dist_embedding, kv_mask,
                  out, lse, dout)
    if dist_embedding.dtype != q.dtype:
        raise ValueError(f"dist_embedding dtype {dist_embedding.dtype} != "
                         f"{q.dtype}: cast E before the op")
    return _bwd_launch(flash_kernel(q.dtype, q.shape[-1]), q, k, v,
                       dist_embedding, kv_mask, out, lse, dout, num_heads,
                       left_max)


class _FlashApply(torch.autograd.Function):
    """Identity on the forward kernel's ``out``, the backward kernel in
    reverse (the JAX ``_flash_apply``): the forward kernel runs outside the
    Function, so a remat replay can reuse its (out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, e, kv_mask, out, lse, num_heads, left_max):
        ctx.save_for_backward(q, k, v, e, kv_mask, out, lse)
        ctx.kw = dict(num_heads=num_heads, left_max=left_max)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, e, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv, de = flash_attention_bwd(q, k, v, e, kv_mask, out, lse,
                                             dout, **ctx.kw)
        return dq, dk, dv, de, None, None, None, None, None


def flash_attention(q, k, v, dist_embedding, kv_mask, *, num_heads: int,
                    left_max: int, residuals: Optional[list] = None
                    ) -> torch.Tensor:
    """Relative_key attention outputs ``[B·num_heads, T, hd]`` (pre
    out-projection), q unscaled — the JAX ``flash_attention`` signature.
    Pass E in the compute dtype (``dist_embedding.to(q.dtype)``), as the
    JAX module does, so autograd carries dE to an fp32 parameter.

    ``residuals`` is the port's form of the JAX ``save_residuals``: a list
    that outlives a remat replay. Empty, the call stores the forward
    kernel's (out, lse) in it; filled, the call (the replay) reuses them and
    launches no forward kernel."""
    if not (torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v, dist_embedding))):
        return flash_attention_fwd(q, k, v, dist_embedding, kv_mask,
                                   num_heads=num_heads, left_max=left_max)[0]
    e = dist_embedding.to(q.dtype)
    if residuals:
        out, lse = residuals
    else:
        out, lse = flash_attention_fwd(q, k, v, e, kv_mask,
                                       num_heads=num_heads, left_max=left_max)
        if residuals is not None:
            residuals.extend((out, lse))
    return _FlashApply.apply(q, k, v, e, kv_mask, out, lse, num_heads,
                             left_max)
