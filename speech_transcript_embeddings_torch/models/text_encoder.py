"""RoBERTa/XLM-R-style bidirectional text encoder.

Port of ``speech_transcript_embeddings_tpu/models/text_encoder.py``:
RoBERTa position ids (``cumsum(mask)·mask + pad_token_id``), post-LayerNorm
blocks, erf-GELU FFN and an additive attention mask with an fp32 softmax.
The attention is plain tensor code: the JAX package has no kernel here.
Dropout sits at the JAX places (embeddings, attention probabilities,
attention output, FFN output) and draws from the ``generator`` passed in
(None: deterministic). With ``remat`` each block is recomputed in the
backward (non-reentrant ``torch.utils.checkpoint``), as ``nn.remat`` does.
Tensor parallel (``axis``): the word table splits its vocabulary
(``VocabEmbed``), the attention its heads and the FFN its intermediate
features; the other tables and the norms stay replicated.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from speech_transcript_embeddings_torch.config import TextEncoderConfig
from speech_transcript_embeddings_torch.models.layers import (
    Embed, LayerNorm, column_dense, dropout, embed, masked_probs, replayable,
    row_dense,
)
from speech_transcript_embeddings_torch.parallel.collectives import (
    ModelAxis, copy_to_model,
)


def roberta_position_ids(input_ids: torch.Tensor, pad_token_id: int
                         ) -> torch.Tensor:
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None,
                 axis: Optional[ModelAxis] = None):
        super().__init__()
        c = self.cfg = cfg
        self.word_embeddings = embed(axis, c.vocab_size, c.hidden_size, dtype,
                                     param_dtype)
        self.position_embeddings = Embed(c.max_position_embeddings,
                                         c.hidden_size, dtype, param_dtype)
        self.token_type_embeddings = Embed(c.type_vocab_size, c.hidden_size,
                                           dtype, param_dtype)
        self.norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)

    def forward(self, input_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pos_ids = roberta_position_ids(input_ids, self.cfg.pad_token_id)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return dropout(self.norm(x), self.cfg.hidden_dropout, generator)


class TextSelfAttention(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype,
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
        self.norm = LayerNorm(h, c.layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.cfg
        split = lambda t: t.reshape(*t.shape[:-1], self.num_heads, c.head_dim)
        xin = copy_to_model(x, self.axis)
        q, k, v = (split(self.query(xin)), split(self.key(xin)),
                   split(self.value(xin)))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / (c.head_dim ** 0.5)
        probs = dropout(masked_probs(scores, mask), c.attention_dropout,
                        generator, self.axis, 1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(probs.dtype))
        out = dropout(self.out(ctx.reshape(*x.shape[:-1], -1)),
                      c.hidden_dropout, generator)
        return self.norm(x + out)


class TextLayer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None,
                 axis: Optional[ModelAxis] = None):
        super().__init__()
        c = self.cfg = cfg
        self.axis = axis
        self.attention = TextSelfAttention(c, dtype, param_dtype, axis)
        self.intermediate = column_dense(axis, c.hidden_size,
                                         c.intermediate_size, dtype=dtype,
                                         param_dtype=param_dtype)
        self.output = row_dense(axis, c.intermediate_size, c.hidden_size,
                                dtype=dtype, param_dtype=param_dtype)
        self.norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)

    def forward(self, x, mask, generator=None):
        x = self.attention(x, mask, generator)
        y = self.output(F.gelu(self.intermediate(copy_to_model(x, self.axis)),
                               approximate="none"))
        return self.norm(x + dropout(y, self.cfg.hidden_dropout, generator))


class TextEncoder(nn.Module):
    """``input_ids [B, T]`` (+ mask) → final hidden states ``[B, T, H]``.
    Blocks are ``layer_0 … layer_{n-1}`` (the JAX scanned bottom stack is
    unstacked by ``bridge.py``)."""

    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None,
                 remat: bool = False, axis: Optional[ModelAxis] = None):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.embeddings = TextEmbeddings(cfg, dtype, param_dtype, axis)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}",
                            TextLayer(cfg, dtype, param_dtype, axis))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embeddings(input_ids, generator)
        for i in range(self.cfg.num_layers):
            layer = getattr(self, f"layer_{i}")
            if self.remat and torch.is_grad_enabled():
                gen = replayable(generator)
                x = checkpoint(lambda h, m, layer=layer, gen=gen:
                               layer(h, m, gen()),
                               x, attention_mask, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, attention_mask, generator)
        return x
