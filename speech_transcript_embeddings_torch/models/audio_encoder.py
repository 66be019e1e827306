"""w2v-bert-2.0-style conformer speech encoder (eval path).

Port of ``speech_transcript_embeddings_tpu/models/audio_encoder.py``:
feature LayerNorm → projection → masked fill → conformer blocks, each a
half-step FFN → relative_key self-attention → convolution module (LayerNorm,
masked fill, pointwise conv + GLU, causal depthwise conv, LayerNorm, swish,
pointwise conv) → half-step FFN → LayerNorm.

With ``use_flash_attention`` the attention runs through the relative_key
flash kernel (``ops/flash_attention.py``: the CUDA kernel for CUDA tensors,
its twin on the CPU); otherwise through the plain gathered-table path, as
the JAX module does. SpecAugment (training only), the remat policies and
``scan_bottom`` are not ported: this package serves, and the bridge unstacks
scanned parameters into ``layer_i``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from speech_transcript_embeddings_torch.config import AudioEncoderConfig
from speech_transcript_embeddings_torch.models.layers import (
    Dense, LayerNorm, masked_probs,
)
from speech_transcript_embeddings_torch.ops.flash_attention import (
    flash_attention,
)


def swish(x):
    return x * torch.sigmoid(x)


class AudioFeedForward(nn.Module):
    def __init__(self, cfg: AudioEncoderConfig, dtype: torch.dtype):
        super().__init__()
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size,
                                  dtype=dtype)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size, dtype=dtype)

    def forward(self, x):
        return self.output(swish(self.intermediate(x)))


class RelPositionAttention(nn.Module):
    """Self-attention with the Shaw relative_key bias:
    ``scores = (q·kᵀ + q·E[clip(j − i, −L, R) + L]ᵀ) / √hd``."""

    def __init__(self, cfg: AudioEncoderConfig, dtype: torch.dtype):
        super().__init__()
        c = self.cfg = cfg
        h = c.hidden_size
        self.query = Dense(h, h, dtype=dtype)
        self.key = Dense(h, h, dtype=dtype)
        self.value = Dense(h, h, dtype=dtype)
        self.out = Dense(h, h, dtype=dtype)
        num_pos = c.left_max_rel_pos + c.right_max_rel_pos + 1
        self.distance_embedding = nn.Parameter(
            torch.empty(num_pos, c.head_dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        c = self.cfg
        b, t, h = x.shape
        nh, hd = c.num_heads, c.head_dim
        q = self.query(x).reshape(b, t, nh, hd)
        k = self.key(x).reshape(b, t, nh, hd)
        v = self.value(x).reshape(b, t, nh, hd)
        dist_emb = self.distance_embedding

        if c.use_flash_attention:
            # [B·h, T, hd] fold at the kernel's public function, as in JAX
            fold = lambda a: a.transpose(1, 2).reshape(b * nh, t, hd)
            kv_mask = mask if mask is not None else torch.ones(
                (b, t), dtype=torch.float32, device=x.device)
            out = flash_attention(fold(q), fold(k), fold(v), dist_emb, kv_mask,
                                  num_heads=nh, left_max=c.left_max_rel_pos)
            out = out.reshape(b, nh, t, hd).transpose(1, 2).reshape(b, t, h)
            return self.out(out)

        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        pos = torch.arange(t, device=x.device)
        distance = torch.clamp(pos[None, :] - pos[:, None],
                               -c.left_max_rel_pos, c.right_max_rel_pos)
        rel = dist_emb[distance + c.left_max_rel_pos].to(q.dtype)
        scores = (scores + torch.einsum("bqhd,qkd->bhqk", q, rel)) / (hd ** 0.5)
        probs = masked_probs(scores, mask)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(probs.dtype))
        return self.out(out.reshape(b, t, h))


class ConvModule(nn.Module):
    """Conformer convolution block with a causal depthwise conv
    (``depthwise_kernel`` is ``[H, 1, K]``, Conv1d layout)."""

    def __init__(self, cfg: AudioEncoderConfig, dtype: torch.dtype):
        super().__init__()
        c = self.cfg = cfg
        h = c.hidden_size
        self.dtype = dtype
        self.norm = LayerNorm(h, c.layer_norm_eps, dtype)
        self.pointwise1 = Dense(h, 2 * h, use_bias=False, dtype=dtype)
        self.depthwise_kernel = nn.Parameter(
            torch.empty(h, 1, c.conv_kernel_size, dtype=torch.float32))
        self.depthwise_norm = LayerNorm(h, c.layer_norm_eps, dtype)
        self.pointwise2 = Dense(h, h, use_bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        x = self.norm(x)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        a, g = self.pointwise1(x).chunk(2, dim=-1)
        x = (a * torch.sigmoid(g)).transpose(1, 2)            # [B, H, T]
        x = F.conv1d(F.pad(x, (self.cfg.conv_kernel_size - 1, 0)),
                     self.depthwise_kernel.to(self.dtype),
                     groups=self.cfg.hidden_size).transpose(1, 2)
        return self.pointwise2(swish(self.depthwise_norm(x)))


class ConformerBlock(nn.Module):
    def __init__(self, cfg: AudioEncoderConfig, dtype: torch.dtype):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ffn1_norm = LayerNorm(h, eps, dtype)
        self.ffn1 = AudioFeedForward(cfg, dtype)
        self.attention_norm = LayerNorm(h, eps, dtype)
        self.attention = RelPositionAttention(cfg, dtype)
        self.conv = ConvModule(cfg, dtype)
        self.ffn2_norm = LayerNorm(h, eps, dtype)
        self.ffn2 = AudioFeedForward(cfg, dtype)
        self.final_norm = LayerNorm(h, eps, dtype)

    def forward(self, x, mask):
        x = x + 0.5 * self.ffn1(self.ffn1_norm(x))
        x = x + self.attention(self.attention_norm(x), mask)
        x = x + self.conv(x, mask)
        x = x + 0.5 * self.ffn2(self.ffn2_norm(x))
        return self.final_norm(x)


class AudioEncoder(nn.Module):
    """Stacked log-mel features ``[B, T, feature_dim]`` → hidden states
    ``[B, T, H]``."""

    def __init__(self, cfg: AudioEncoderConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.feature_norm = LayerNorm(cfg.feature_dim, cfg.layer_norm_eps, dtype)
        self.feature_projection = Dense(cfg.feature_dim, cfg.hidden_size,
                                        dtype=dtype)
        if cfg.apply_spec_augment and cfg.mask_time_prob > 0:
            # SpecAugment's learned mask vector: part of the checkpoint, used
            # only in training (not ported)
            self.masked_spec_embed = nn.Parameter(
                torch.empty(cfg.hidden_size, dtype=torch.float32))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", ConformerBlock(cfg, dtype))

    def forward(self, features: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.feature_projection(self.feature_norm(features))
        if attention_mask is not None:
            x = x * attention_mask[..., None].to(x.dtype)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, attention_mask)
        return x
