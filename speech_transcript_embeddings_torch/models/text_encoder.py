"""RoBERTa/XLM-R-style bidirectional text encoder (eval path).

Port of ``speech_transcript_embeddings_tpu/models/text_encoder.py``:
RoBERTa position ids (``cumsum(mask)·mask + pad_token_id``), post-LayerNorm
blocks, erf-GELU FFN and an additive attention mask with an fp32 softmax.
The attention is plain tensor code: the JAX package has no kernel here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from speech_transcript_embeddings_torch.config import TextEncoderConfig
from speech_transcript_embeddings_torch.models.layers import (
    Dense, Embed, LayerNorm, masked_probs,
)


def roberta_position_ids(input_ids: torch.Tensor, pad_token_id: int
                         ) -> torch.Tensor:
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype):
        super().__init__()
        c = self.cfg = cfg
        self.word_embeddings = Embed(c.vocab_size, c.hidden_size, dtype)
        self.position_embeddings = Embed(c.max_position_embeddings,
                                         c.hidden_size, dtype)
        self.token_type_embeddings = Embed(c.type_vocab_size, c.hidden_size,
                                           dtype)
        self.norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos_ids = roberta_position_ids(input_ids, self.cfg.pad_token_id)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.norm(x)


class TextSelfAttention(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype):
        super().__init__()
        c = self.cfg = cfg
        h = c.hidden_size
        self.query = Dense(h, h, dtype=dtype)
        self.key = Dense(h, h, dtype=dtype)
        self.value = Dense(h, h, dtype=dtype)
        self.out = Dense(h, h, dtype=dtype)
        self.norm = LayerNorm(h, c.layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        c = self.cfg
        split = lambda t: t.reshape(*t.shape[:-1], c.num_heads, c.head_dim)
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / (c.head_dim ** 0.5)
        probs = masked_probs(scores, mask)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(probs.dtype))
        return self.norm(x + self.out(ctx.reshape(*x.shape[:-1], -1)))


class TextLayer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype):
        super().__init__()
        c = cfg
        self.attention = TextSelfAttention(c, dtype)
        self.intermediate = Dense(c.hidden_size, c.intermediate_size,
                                  dtype=dtype)
        self.output = Dense(c.intermediate_size, c.hidden_size, dtype=dtype)
        self.norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)

    def forward(self, x, mask):
        x = self.attention(x, mask)
        y = self.output(F.gelu(self.intermediate(x), approximate="none"))
        return self.norm(x + y)


class TextEncoder(nn.Module):
    """``input_ids [B, T]`` (+ mask) → final hidden states ``[B, T, H]``.
    Blocks are ``layer_0 … layer_{n-1}`` (the JAX scanned bottom stack is
    unstacked by ``bridge.py``)."""

    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.embeddings = TextEmbeddings(cfg, dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", TextLayer(cfg, dtype))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embeddings(input_ids)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, attention_mask)
        return x
