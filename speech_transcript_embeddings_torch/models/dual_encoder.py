"""The dual-encoder speech↔transcript embedding model.

Port of ``speech_transcript_embeddings_tpu/models/dual_encoder.py``:
encoder → attentive pooling (or CLS / masked mean) → projection, then, when
``heads.use_cross_modal`` is on, each pooled projection attends to the
other modality's sequence (mapped into projection space) and is fused with
what it attended to (``apply_cross_modal``) → L2 norm. ``forward_pair``
takes one transcript per clip (serving); ``forward_pos_neg`` the clean and
the corrupted transcript of each clip in one 2B-row text call (training),
with the audio tiled against both for the fusion, and the word-alignment
head (``heads.use_word_alignment``) over the clean transcript. The encoders
run in ``cfg.dtype``; the heads run in fp32, as in the JAX model. A
``generator`` turns dropout and SpecAugment on (JAX's
``deterministic=False``). Built with a ``ModelAxis`` (tensor parallel), the
model holds this rank's shard of each parameter that
``parallel.mesh.shard_dim`` names (``init_model(axis=...)`` draws each
whole tensor as one process does and keeps the shard); its outputs are the
whole model's on every rank of the axis.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from speech_transcript_embeddings_torch.config import ModelConfig
from speech_transcript_embeddings_torch.models.audio_encoder import (
    AudioEncoder, ConvModule, RelPositionAttention,
)
from speech_transcript_embeddings_torch.models.heads import (
    AttentivePooling, CrossModalAttention, EnhancedProjection,
    WordLevelAlignment,
)
from speech_transcript_embeddings_torch.models.layers import (
    Dense, Embed, LayerNorm,
)
from speech_transcript_embeddings_torch.models.text_encoder import TextEncoder
from speech_transcript_embeddings_torch.parallel import mesh as mesh_lib
from speech_transcript_embeddings_torch.parallel.collectives import ModelAxis

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


class PosNegOutput(NamedTuple):
    text_pos: torch.Tensor       # [B, D] normalised
    text_neg: torch.Tensor       # [B, D] normalised
    audio: torch.Tensor          # [B, D] normalised
    alignment_scores: Optional[torch.Tensor] = None   # [B, T_text]
    alignment_matrix: Optional[torch.Tensor] = None   # [B, T_text, T_audio]


class DualEncoderModel(nn.Module):
    """``param_dtype`` is where Dense and Embed weights are stored: None
    (serving) stores them in the compute dtype, ``torch.float32`` (training)
    keeps them in fp32 and casts at each call, as JAX does. ``axis``: the
    model axis of tensor parallel (None: the whole model)."""

    def __init__(self, cfg: ModelConfig,
                 param_dtype: Optional[torch.dtype] = None,
                 axis: Optional[ModelAxis] = None):
        super().__init__()
        heads = cfg.heads
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.axis = axis
        dtype = compute_dtype(cfg)
        self.text_encoder = TextEncoder(cfg.text, dtype, param_dtype,
                                        remat=cfg.remat, axis=axis)
        self.audio_encoder = AudioEncoder(cfg.audio, dtype, param_dtype,
                                          remat=cfg.remat, axis=axis)
        proj = lambda in_dim: EnhancedProjection(
            in_dim, heads.projection_dim, heads.projection_hidden_dim,
            heads.activation, heads.dropout, axis)
        self.text_projection = proj(cfg.text.hidden_size)
        self.audio_projection = proj(cfg.audio.hidden_size)
        if heads.use_attentive_pooling:
            self.text_pooling = AttentivePooling(cfg.text.hidden_size)
            self.audio_pooling = AttentivePooling(cfg.audio.hidden_size)
        d = heads.projection_dim
        if heads.use_cross_modal:
            self.text_seq_to_projection = Dense(cfg.text.hidden_size, d)
            self.audio_seq_to_projection = Dense(cfg.audio.hidden_size, d)
            self.text_to_audio_attention = CrossModalAttention(
                d, heads.cross_modal_heads, heads.dropout, axis)
            self.audio_to_text_attention = CrossModalAttention(
                d, heads.cross_modal_heads, heads.dropout, axis)
            self.text_fusion = Dense(2 * d, d)
            self.text_fusion_norm = LayerNorm(d, 1e-5)
            self.audio_fusion = Dense(2 * d, d)
            self.audio_fusion_norm = LayerNorm(d, 1e-5)
        if heads.use_word_alignment:
            self.word_level_alignment = WordLevelAlignment(
                cfg.text.hidden_size, cfg.audio.hidden_size, d,
                heads.alignment_heads, heads.dropout, axis)

    def full_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Each parameter's whole shape (its own without tensor
        parallel)."""
        if self.axis is None:
            return {k: tuple(p.shape) for k, p in self.named_parameters()}
        with torch.device("meta"):
            whole = DualEncoderModel(self.cfg, self.param_dtype)
        return {k: tuple(p.shape) for k, p in whole.named_parameters()}

    def encode_text(self, input_ids, attention_mask=None, generator=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (projected ``[B, D]`` fp32, hidden ``[B, T, H]``)."""
        hidden = self.text_encoder(input_ids, attention_mask, generator)
        if self.cfg.heads.use_attentive_pooling:
            pooled = self.text_pooling(hidden, attention_mask)
        else:
            pooled = hidden[:, 0, :]
        return self.text_projection(pooled, generator), hidden

    def encode_audio(self, features, attention_mask=None, generator=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        hidden = self.audio_encoder(features, attention_mask, generator)
        if self.cfg.heads.use_attentive_pooling:
            pooled = self.audio_pooling(hidden, attention_mask)
        elif attention_mask is not None:
            m = attention_mask[..., None].to(hidden.dtype)
            pooled = (hidden * m).sum(1) / torch.clamp(m.sum(1), min=1e-9)
        else:
            pooled = hidden.mean(dim=1)
        return self.audio_projection(pooled, generator), hidden

    def apply_cross_modal(self, text_projected, text_hidden, text_mask,
                          audio_projected, audio_hidden, audio_mask,
                          generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fuse each pooled projection with its attention over the other
        modality's sequence in projection space (identity when
        ``heads.use_cross_modal`` is off)."""
        if not self.cfg.heads.use_cross_modal:
            return text_projected, audio_projected
        audio_seq = self.audio_seq_to_projection(audio_hidden)
        text_seq = self.text_seq_to_projection(text_hidden)
        text_attended = self.text_to_audio_attention(
            text_projected[:, None, :], audio_seq, audio_mask,
            generator)[:, 0, :]
        audio_attended = self.audio_to_text_attention(
            audio_projected[:, None, :], text_seq, text_mask,
            generator)[:, 0, :]
        text_fused = self.text_fusion_norm(self.text_fusion(
            torch.cat([text_projected, text_attended], dim=-1)))
        audio_fused = self.audio_fusion_norm(self.audio_fusion(
            torch.cat([audio_projected, audio_attended], dim=-1)))
        return text_fused, audio_fused

    def forward_pair(self, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One transcript per clip → (text_emb, audio_emb), fused when the
        config fuses, L2-normalised."""
        text, text_hidden = self.encode_text(batch["input_ids"],
                                             batch["attention_mask"])
        audio, audio_hidden = self.encode_audio(batch["input_features"],
                                                batch["attention_mask_audio"])
        text, audio = self.apply_cross_modal(
            text, text_hidden, batch["attention_mask"], audio, audio_hidden,
            batch["attention_mask_audio"])
        return l2_normalize(text), l2_normalize(audio)

    def forward_pos_neg(self, batch: Dict[str, torch.Tensor],
                        generator: Optional[torch.Generator] = None
                        ) -> PosNegOutput:
        """Clean and corrupted transcript against one clip: both transcripts
        in one 2B-row text-encoder call, as the JAX model encodes them. Both
        fusions run in one call over the audio tiled twice; the audio
        embedding returned is the one fused against the clean transcript
        (the reference's semantics)."""
        b = batch["input_ids_pos"].shape[0]
        amask = batch["attention_mask_audio"]
        ids = torch.cat([batch["input_ids_pos"], batch["input_ids_neg"]], 0)
        tmask = torch.cat([batch["attention_mask_pos"],
                           batch["attention_mask_neg"]], 0)
        text, text_hidden = self.encode_text(ids, tmask, generator)
        audio, audio_hidden = self.encode_audio(batch["input_features"],
                                                amask, generator)
        if self.cfg.heads.use_cross_modal:
            text, audio2 = self.apply_cross_modal(
                text, text_hidden, tmask, torch.cat([audio] * 2, 0),
                torch.cat([audio_hidden] * 2, 0), torch.cat([amask] * 2, 0),
                generator)
            audio = audio2[:b]
        scores = matrix = None
        if self.cfg.heads.use_word_alignment:
            _, scores, matrix = self.word_level_alignment(
                text_hidden[:b], audio_hidden, batch["attention_mask_pos"],
                amask, generator)
        return PosNegOutput(text_pos=l2_normalize(text[:b]),
                            text_neg=l2_normalize(text[b:]),
                            audio=l2_normalize(audio),
                            alignment_scores=scores, alignment_matrix=matrix)

    def forward(self, batch, generator=None):
        if "input_ids_pos" in batch:
            return self.forward_pos_neg(batch, generator)
        return self.forward_pair(batch)


_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated to ±2


def _truncated_normal(shape, std, generator, device):
    """Flax's variance-scaling ``truncated_normal``: a unit normal truncated
    to [−2, 2], scaled by ``std / 0.8796`` so the result has std ``std``
    (inverse-CDF sampling, as ``jax.random.truncated_normal``)."""
    lo, hi = (0.5 * (1 + math.erf(z / math.sqrt(2))) for z in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)
    z = torch.clamp(torch.special.ndtri(u), -2.0, 2.0)
    return z * (std / _TRUNC_STD)


@torch.no_grad()
def init_module(module: nn.Module, generator: torch.Generator, device="cpu",
                shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                axis: Optional[ModelAxis] = None) -> nn.Module:
    """Fill ``module``'s parameters in place from ``generator``, with
    ``init_model``'s distributions, in its order (any module of the
    model: a conformer block, a text encoder…). ``shapes``: each
    parameter's whole shape under tensor parallel (``axis``), where this
    rank keeps its shard of each drawn tensor."""
    if shapes is None:
        shapes = {k: tuple(p.shape) for k, p in module.named_parameters()}

    def put(name, p, draw):
        """Fill ``p`` with its shard of ``draw(whole shape)``."""
        whole = draw(shapes[name])
        p.copy_(whole if axis is None else mesh_lib.shard_tensor(
            name, whole, axis.size, axis.index))

    normal = lambda std: lambda shape: std(shape) * torch.randn(
        shape, generator=generator, device=device)
    lecun = lambda fan_in: lambda shape: _truncated_normal(
        shape, shape[fan_in] ** -0.5, generator, device)
    for name, mod in module.named_modules():
        at = f"{name}." if name else ""
        if isinstance(mod, Dense):
            put(at + "weight", mod.weight, lecun(1))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, Embed):
            put(at + "weight", mod.weight, normal(lambda s: s[1] ** -0.5))
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, RelPositionAttention):
            put(at + "distance_embedding", mod.distance_embedding,
                normal(lambda s: 0.02))
        elif isinstance(mod, ConvModule):
            put(at + "depthwise_kernel", mod.depthwise_kernel, lecun(-1))
    for mod in module.modules():
        if hasattr(mod, "masked_spec_embed"):
            mod.masked_spec_embed.uniform_(0.0, 1.0, generator=generator)
    return module


@torch.no_grad()
def init_model(cfg: ModelConfig, generator: torch.Generator, device="cpu",
               *, train: bool = False, axis: Optional[ModelAxis] = None
               ) -> DualEncoderModel:
    """A seeded model on ``device`` (``generator`` must live there too),
    drawn from the distributions of the JAX package's initializers: Dense
    kernels lecun-normal (truncated normal, std 1/√fan_in), Embed tables
    normal with std 1/√features, depthwise kernels lecun-normal over the
    kernel width, distance embeddings normal(0.02), the SpecAugment vector
    uniform[0, 1), biases 0, LayerNorm 1/0. ``train`` keeps Dense and Embed
    weights in fp32 and gradients on (the trainer then freezes its split);
    otherwise the model is the serving form: weights in the compute dtype,
    eval mode, no gradients. With ``axis`` (tensor parallel) each tensor
    is drawn whole, in the one-process order, and this rank keeps its
    shard: the shard equals, bit for bit, that slice of the one-process
    model from the same generator, and the device holds one whole tensor
    at a time."""
    with torch.device(device):
        model = DualEncoderModel(cfg, torch.float32 if train else None, axis)
    init_module(model, generator, device, model.full_shapes(), axis)
    if train:
        return model
    return model.eval().requires_grad_(False)
