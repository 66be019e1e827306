"""The dual-encoder speech↔transcript embedding model (retrieval path).

Port of ``speech_transcript_embeddings_tpu/models/dual_encoder.py`` with the
pair-fusion heads off, which is ``retrieval_model_config()``: encoder →
attentive pooling (or CLS / masked mean) → projection → L2 norm. The
encoders run in ``cfg.dtype``; the heads run in fp32, as in the JAX model.
Cross-modal fusion and word alignment are not ported yet: a config that
asks for them raises rather than run a partial model.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from speech_transcript_embeddings_torch.config import ModelConfig
from speech_transcript_embeddings_torch.models.audio_encoder import (
    AudioEncoder, ConvModule, RelPositionAttention,
)
from speech_transcript_embeddings_torch.models.heads import (
    AttentivePooling, EnhancedProjection,
)
from speech_transcript_embeddings_torch.models.layers import (
    Dense, Embed, LayerNorm,
)
from speech_transcript_embeddings_torch.models.text_encoder import TextEncoder

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unsupported model dtype {cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x·rsqrt(Σx² + eps)`` in fp32 (the rsqrt form: a zero vector maps
    to zero, with a zero gradient)."""
    x = x.float()
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


class DualEncoderModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        heads = cfg.heads
        if heads.use_cross_modal or heads.use_word_alignment:
            raise NotImplementedError(
                "the cross-modal fusion and word-alignment heads are not "
                "ported yet (ROADMAP.md, Queue 1); use a config with "
                "heads.use_cross_modal=False and heads.use_word_alignment="
                "False, e.g. retrieval_model_config()")
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.text_encoder = TextEncoder(cfg.text, dtype)
        self.audio_encoder = AudioEncoder(cfg.audio, dtype)
        proj = lambda in_dim: EnhancedProjection(
            in_dim, heads.projection_dim, heads.projection_hidden_dim,
            heads.activation)
        self.text_projection = proj(cfg.text.hidden_size)
        self.audio_projection = proj(cfg.audio.hidden_size)
        if heads.use_attentive_pooling:
            self.text_pooling = AttentivePooling(cfg.text.hidden_size)
            self.audio_pooling = AttentivePooling(cfg.audio.hidden_size)

    def encode_text(self, input_ids, attention_mask=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (projected ``[B, D]`` fp32, hidden ``[B, T, H]``)."""
        hidden = self.text_encoder(input_ids, attention_mask)
        if self.cfg.heads.use_attentive_pooling:
            pooled = self.text_pooling(hidden, attention_mask)
        else:
            pooled = hidden[:, 0, :]
        return self.text_projection(pooled), hidden

    def encode_audio(self, features, attention_mask=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        hidden = self.audio_encoder(features, attention_mask)
        if self.cfg.heads.use_attentive_pooling:
            pooled = self.audio_pooling(hidden, attention_mask)
        elif attention_mask is not None:
            m = attention_mask[..., None].to(hidden.dtype)
            pooled = (hidden * m).sum(1) / torch.clamp(m.sum(1), min=1e-9)
        else:
            pooled = hidden.mean(dim=1)
        return self.audio_projection(pooled), hidden

    def forward_pair(self, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One transcript per clip → (text_emb, audio_emb), L2-normalised."""
        text, _ = self.encode_text(batch["input_ids"], batch["attention_mask"])
        audio, _ = self.encode_audio(batch["input_features"],
                                     batch["attention_mask_audio"])
        return l2_normalize(text), l2_normalize(audio)

    def forward(self, batch):
        return self.forward_pair(batch)


@torch.no_grad()
def init_model(cfg: ModelConfig, generator: torch.Generator,
               device="cpu") -> DualEncoderModel:
    """A seeded model on ``device`` (``generator`` must live there too):
    Dense and Embed weights normal(0.02) with zero biases, LayerNorm 1/0,
    distance embeddings normal(0.02), depthwise kernels normal(1/√K) (Flax's
    lecun-normal scale), the SpecAugment vector uniform(0, 1)."""
    with torch.device(device):
        model = DualEncoderModel(cfg)
    for mod in model.modules():
        if isinstance(mod, (Dense, Embed)):
            mod.weight.normal_(0.0, 0.02, generator=generator)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, RelPositionAttention):
            mod.distance_embedding.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, ConvModule):
            k = mod.depthwise_kernel.shape[-1]
            mod.depthwise_kernel.normal_(0.0, k ** -0.5, generator=generator)
    enc = model.audio_encoder
    if hasattr(enc, "masked_spec_embed"):
        enc.masked_spec_embed.uniform_(0.0, 1.0, generator=generator)
    return model.eval().requires_grad_(False)
