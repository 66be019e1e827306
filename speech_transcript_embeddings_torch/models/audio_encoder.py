"""w2v-bert-2.0-style conformer speech encoder.

Port of ``speech_transcript_embeddings_tpu/models/audio_encoder.py``:
feature LayerNorm → projection → SpecAugment (training) → masked fill →
conformer blocks, each a half-step FFN → relative_key self-attention →
convolution module (LayerNorm, masked fill, pointwise conv + GLU, causal
depthwise conv, LayerNorm, swish, pointwise conv) → half-step FFN →
LayerNorm.

With ``use_flash_attention`` the attention runs through the relative_key
flash kernels (``ops/flash_attention.py``: the CUDA kernels for CUDA
tensors, their twins on the CPU); otherwise, or when attention dropout is
active in training, through the plain gathered-table path, as the JAX
module does. Dropout sits at the JAX places and draws from the ``generator``
passed in (None: deterministic).

With ``remat`` each block is recomputed in the backward. The block runs as
five stages, each named by the activation it ends with (``STAGES``); a
policy cuts the block after some of them (``REMAT_CUTS``) and each region
between cuts is one non-reentrant ``torch.utils.checkpoint``. A region's
input is what the replay starts from, so a cut saves one activation where
JAX's ``save_only_these_names`` saves the named one beside it: x + ½·ffn1
for ``ffn1_out``, q/k/v for ``attn_q/k/v``, x + conv for ``conv_out`` (the
same sizes). Every ``save_*`` policy also keeps the flash forward's
(out, lse) across the replay (``flash_attention(residuals=...)``).
``scan_bottom`` is not ported: the bridge unstacks scanned parameters into
``layer_i``.

Tensor parallel (``axis``, a ``ModelAxis``): each FFN splits its
intermediate features, the attention its heads (the flash kernels run at
the local head count; the replicated distance table enters through
``copy_to_model``, so its gradient, each rank's heads' share, is summed),
the conv module its GLU channels (a rank holds ``[a_r | g_r]`` of
``pointwise1``), its depthwise channels and the ``depthwise_norm`` over
them; the feature projection and the norms stay replicated, as JAX's
rules leave them. The collectives replay with their regions under remat,
identically on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from speech_transcript_embeddings_torch.config import AudioEncoderConfig
from speech_transcript_embeddings_torch.models.layers import (
    Dense, LayerNorm, column_dense, dropout, layer_norm, masked_probs,
    replayable, row_dense,
)
from speech_transcript_embeddings_torch.ops.depthwise_glu import (
    depthwise_glu,
)
from speech_transcript_embeddings_torch.ops.flash_attention import (
    flash_attention,
)
from speech_transcript_embeddings_torch.parallel.collectives import (
    ModelAxis, copy_to_model,
)

# the stages of a conformer block, each named by the activation it ends with
STAGES = ("ffn1_out", "attn_qkv", "attn_out", "conv_out", "block_out")
# remat policy → the stages after which it cuts a block into replay regions
# ('full' recomputes everything, the save_* policies keep named activations)
REMAT_CUTS = {"full": (), "save_flash": (), "save_hot": ("conv_out",),
              "save_hot2": ("ffn1_out", "conv_out"),
              "save_hot3": ("ffn1_out", "attn_qkv")}


def _run_region(stages, carry, mask, generator, residuals):
    gen = generator()
    for stage in stages:
        carry = stage(carry, mask, gen, residuals)
    return carry


def swish(x):
    return x * torch.sigmoid(x)


def spec_augment_draw(batch: int, t: int, cfg: AudioEncoderConfig,
                      generator: torch.Generator) -> Optional[torch.Tensor]:
    """The uniform draws ``u [B, S_max]`` of SpecAugment's span starts
    (None when the clip is no longer than one span)."""
    length = cfg.mask_time_length
    if t <= length:
        return None
    s_max = max(int(round(cfg.mask_time_prob * t / length)),
                cfg.mask_time_min_masks)
    return torch.rand((batch, s_max), generator=generator,
                      device=generator.device)


def spec_augment_apply(x, masked_embed, attention_mask, cfg, u):
    """SpecAugment time masking (JAX ``_spec_augment_time``) with given
    draws ``u``: per clip ``k = max(round(prob·valid/len), min_masks)``
    spans of ``mask_time_length`` frames, starts ``⌊u·max(valid − len,
    1)⌋`` inside the valid region, only valid frames masked, masked frames
    replaced by ``masked_embed``."""
    if u is None:
        return x
    b, t, _ = x.shape
    length = cfg.mask_time_length
    if attention_mask is not None:
        valid = torch.sum(attention_mask > 0, dim=-1)
    else:
        valid = torch.full((b,), t, dtype=torch.int64, device=x.device)
    k = torch.clamp(torch.round(cfg.mask_time_prob * valid.float() / length)
                    .to(torch.int64), min=cfg.mask_time_min_masks)
    max_start = torch.clamp(valid - length, min=1).float()
    starts = torch.floor(u * max_start[:, None]).to(torch.int64)
    span_on = torch.arange(u.shape[1], device=x.device)[None, :] < k[:, None]
    pos = torch.arange(t, device=x.device)[None, None, :]
    in_span = ((pos >= starts[..., None]) & (pos < starts[..., None] + length)
               & span_on[..., None])
    mask = torch.any(in_span, dim=1)
    if attention_mask is not None:
        mask = mask & (attention_mask > 0)
    return torch.where(mask[..., None], masked_embed[None, None, :], x)


class AudioFeedForward(nn.Module):
    def __init__(self, cfg: AudioEncoderConfig, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None,
                 axis: Optional[ModelAxis] = None):
        super().__init__()
        self.cfg = cfg
        self.axis = axis
        self.intermediate = column_dense(axis, cfg.hidden_size,
                                         cfg.intermediate_size, dtype=dtype,
                                         param_dtype=param_dtype)
        self.output = row_dense(axis, cfg.intermediate_size, cfg.hidden_size,
                                dtype=dtype, param_dtype=param_dtype)

    def forward(self, x, generator=None):
        c = self.cfg
        h = swish(self.intermediate(copy_to_model(x, self.axis)))
        h = dropout(h, c.activation_dropout, generator, self.axis)
        return dropout(self.output(h), c.hidden_dropout, generator)


class RelPositionAttention(nn.Module):
    """Self-attention with the Shaw relative_key bias:
    ``scores = (q·kᵀ + q·E[clip(j − i, −L, R) + L]ᵀ) / √hd``."""

    def __init__(self, cfg: AudioEncoderConfig, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None,
                 axis: Optional[ModelAxis] = None):
        super().__init__()
        c = self.cfg = cfg
        h = c.hidden_size
        self.axis = axis
        self.num_heads = axis.part(c.num_heads) if axis else c.num_heads
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.query, self.key, self.value = (column_dense(axis, h, h, **kw)
                                            for _ in range(3))
        self.out = row_dense(axis, h, h, **kw)
        num_pos = c.left_max_rel_pos + c.right_max_rel_pos + 1
        self.distance_embedding = nn.Parameter(
            torch.empty(num_pos, c.head_dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.attend(*self.project(x), mask, generator)

    def project(self, x: torch.Tensor):
        """→ q, k, v ``[B, T, num_heads, head_dim]`` (this rank's heads)."""
        shape = (*x.shape[:2], self.num_heads, self.cfg.head_dim)
        x = copy_to_model(x, self.axis)
        return (self.query(x).reshape(shape), self.key(x).reshape(shape),
                self.value(x).reshape(shape))

    def attend(self, q, k, v, mask: Optional[torch.Tensor],
               generator: Optional[torch.Generator] = None,
               residuals: Optional[list] = None) -> torch.Tensor:
        """Attention of projected q, k, v, then the output projection;
        ``residuals`` keeps the flash forward across a remat replay."""
        c = self.cfg
        b, t, nh, hd = q.shape
        h = nh * hd
        dist_emb = copy_to_model(self.distance_embedding, self.axis)

        if c.use_flash_attention and (generator is None
                                      or c.attention_dropout == 0):
            # [B·h, T, hd] fold at the kernel's public function, as in JAX
            fold = lambda a: a.transpose(1, 2).reshape(b * nh, t, hd)
            kv_mask = mask if mask is not None else torch.ones(
                (b, t), dtype=torch.float32, device=q.device)
            out = flash_attention(
                fold(q), fold(k), fold(v), dist_emb.to(q.dtype), kv_mask,
                num_heads=nh, left_max=c.left_max_rel_pos,
                residuals=residuals)
            out = out.reshape(b, nh, t, hd).transpose(1, 2).reshape(b, t, h)
            return self.out(out)

        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        pos = torch.arange(t, device=q.device)
        distance = torch.clamp(pos[None, :] - pos[:, None],
                               -c.left_max_rel_pos, c.right_max_rel_pos)
        rel = dist_emb[distance + c.left_max_rel_pos].to(q.dtype)
        scores = (scores + torch.einsum("bqhd,qkd->bhqk", q, rel)) / (hd ** 0.5)
        probs = dropout(masked_probs(scores, mask), c.attention_dropout,
                        generator, self.axis, 1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(probs.dtype))
        return self.out(out.reshape(b, t, h))


class ConvModule(nn.Module):
    """Conformer convolution block with a causal depthwise conv
    (``depthwise_kernel`` is ``[H, 1, K]``, Conv1d layout; this rank's
    channels under tensor parallel). The GLU and the depthwise conv are
    ``ops/depthwise_glu.py``: its kernels on the card, the plain chain on
    the CPU."""

    def __init__(self, cfg: AudioEncoderConfig, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None,
                 axis: Optional[ModelAxis] = None):
        super().__init__()
        c = self.cfg = cfg
        h = c.hidden_size
        self.axis = axis
        kw = dict(use_bias=False, dtype=dtype, param_dtype=param_dtype)
        self.norm = LayerNorm(h, c.layer_norm_eps, dtype)
        self.pointwise1 = column_dense(axis, h, 2 * h, **kw)
        self.depthwise_kernel = nn.Parameter(torch.empty(
            axis.part(h) if axis else h, 1, c.conv_kernel_size,
            dtype=torch.float32))
        self.depthwise_norm = layer_norm(axis, h, c.layer_norm_eps, dtype)
        self.pointwise2 = row_dense(axis, h, h, **kw)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.cfg
        x = self.norm(x)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        x = depthwise_glu(self.pointwise1(copy_to_model(x, self.axis)),
                          self.depthwise_kernel)              # [B, T, H]
        h = swish(self.depthwise_norm(x))
        return dropout(self.pointwise2(h), c.conv_dropout, generator)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: AudioEncoderConfig, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None,
                 axis: Optional[ModelAxis] = None):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ffn1_norm = LayerNorm(h, eps, dtype)
        self.ffn1 = AudioFeedForward(cfg, dtype, param_dtype, axis)
        self.attention_norm = LayerNorm(h, eps, dtype)
        self.attention = RelPositionAttention(cfg, dtype, param_dtype, axis)
        self.conv = ConvModule(cfg, dtype, param_dtype, axis)
        self.ffn2_norm = LayerNorm(h, eps, dtype)
        self.ffn2 = AudioFeedForward(cfg, dtype, param_dtype, axis)
        self.final_norm = LayerNorm(h, eps, dtype)

    def forward(self, x, mask, generator=None):
        carry = (x,)
        for stage in self.stages():
            carry = stage(carry, mask, generator, None)
        return carry[0]

    def stages(self):
        """The block's stages in ``STAGES`` order, each
        ``stage(carry, mask, generator, residuals) → carry`` on a tuple of
        tensors: (x,) between stages, (x, q, k, v) after ``attn_qkv``."""
        return (self._ffn1, self._qkv, self._attend, self._conv, self._ffn2)

    def _ffn1(self, carry, mask, generator, residuals):
        (x,) = carry
        return (x + 0.5 * self.ffn1(self.ffn1_norm(x), generator),)

    def _qkv(self, carry, mask, generator, residuals):
        (x,) = carry
        return (x, *self.attention.project(self.attention_norm(x)))

    def _attend(self, carry, mask, generator, residuals):
        x, q, k, v = carry
        attn = self.attention.attend(q, k, v, mask, generator, residuals)
        return (x + dropout(attn, self.cfg.attention_dropout, generator),)

    def _conv(self, carry, mask, generator, residuals):
        (x,) = carry
        return (x + self.conv(x, mask, generator),)

    def _ffn2(self, carry, mask, generator, residuals):
        (x,) = carry
        return (self.final_norm(
            x + 0.5 * self.ffn2(self.ffn2_norm(x), generator)),)


class AudioEncoder(nn.Module):
    """Stacked log-mel features ``[B, T, feature_dim]`` → hidden states
    ``[B, T, H]``."""

    def __init__(self, cfg: AudioEncoderConfig, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None,
                 remat: bool = False, axis: Optional[ModelAxis] = None):
        super().__init__()
        if cfg.remat_policy not in REMAT_CUTS:
            raise ValueError(
                f"Unknown remat_policy {cfg.remat_policy!r}; use 'full', "
                "'save_flash', 'save_hot', 'save_hot2' or 'save_hot3'")
        self.cfg = cfg
        self.remat = remat
        self.feature_norm = LayerNorm(cfg.feature_dim, cfg.layer_norm_eps, dtype)
        self.feature_projection = Dense(cfg.feature_dim, cfg.hidden_size,
                                        dtype=dtype, param_dtype=param_dtype)
        if cfg.apply_spec_augment and cfg.mask_time_prob > 0:
            # SpecAugment's learned mask vector (training only)
            self.masked_spec_embed = nn.Parameter(
                torch.empty(cfg.hidden_size, dtype=torch.float32))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}",
                            ConformerBlock(cfg, dtype, param_dtype, axis))

    def forward(self, features: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.cfg
        x = self.feature_projection(self.feature_norm(features))
        x = dropout(x, c.feat_proj_dropout, generator)
        if hasattr(self, "masked_spec_embed") and generator is not None:
            u = spec_augment_draw(x.shape[0], x.shape[1], c, generator)
            x = spec_augment_apply(x, self.masked_spec_embed.to(x.dtype),
                                   attention_mask, c, u)
        if attention_mask is not None:
            x = x * attention_mask[..., None].to(x.dtype)
        x = dropout(x, c.hidden_dropout, generator)
        for i in range(c.num_layers):
            block = getattr(self, f"layer_{i}")
            if self.remat and torch.is_grad_enabled():
                x = self._remat_block(block, x, attention_mask, generator)
            else:
                x = block(x, attention_mask, generator)
        return x

    def _remat_block(self, block, x, mask, generator):
        """One block as non-reentrant checkpoints of the regions between
        the policy's cuts. Each region's replay draws its dropout masks
        again from a copy of the generator's state at the region's start; a
        ``save_*`` policy's replay reuses the flash forward's (out, lse)."""
        cuts = REMAT_CUTS[self.cfg.remat_policy]
        residuals = None if self.cfg.remat_policy == "full" else []
        carry, region = (x,), []
        for name, stage in zip(STAGES, block.stages()):
            region.append(stage)
            if name in cuts or name == STAGES[-1]:
                carry = checkpoint(_run_region, tuple(region), carry, mask,
                                   replayable(generator), residuals,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
                region = []
        return carry[0]
