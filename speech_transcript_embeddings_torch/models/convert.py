"""HuggingFace encoder weights → the port's parameter names.

Port of ``speech_transcript_embeddings_tpu/models/convert.py``. The
reference consumes its pretrained encoders through
``transformers.AutoModel.from_pretrained``; the port's encoders are its own
modules, so a published state dict is renamed once onto them. HF weights
are torch tensors already and both sides keep torch's ``[out, in]`` Linear
layout, so the mapping is a renaming with two exceptions: the conformer's
pointwise ``Conv1d`` weights ``[out, in, 1]`` lose their last axis (the
port holds them as a ``Dense``), and nothing else is permuted (the depthwise
``Conv1d`` weight ``[C, 1, K]`` is the port's layout as it is). The input
is a flat ``{name: tensor or np.ndarray}`` state dict of an
``{XLMRoberta,Roberta,Bert}Model`` or a ``Wav2Vec2BertModel``; the output
is ``{port name under the encoder: fp32 tensor}``, values unchanged. Keys
the port has no parameter for (``position_ids`` buffers, a pooler) are not
read. The JAX package's ``restack_encoder_params`` has no counterpart: the
port does not stack layers (``models/audio_encoder.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from speech_transcript_embeddings_torch.config import (
    AudioEncoderConfig, TextEncoderConfig,
)

StateDict = Dict[str, torch.Tensor]

# prefixes some exported checkpoints carry (JAX convert.py:46-50, :86-89)
TEXT_PREFIXES = ("roberta.", "bert.", "model.")
AUDIO_PREFIXES = ("wav2vec2_bert.", "model.")

# HF name under a layer → the port's, for the renamed modules
_TEXT_LAYER = {
    "attention.self.query": "attention.query",
    "attention.self.key": "attention.key",
    "attention.self.value": "attention.value",
    "attention.output.dense": "attention.out",
    "attention.output.LayerNorm": "attention.norm",
    "intermediate.dense": "intermediate",
    "output.dense": "output",
    "output.LayerNorm": "norm",
}
_AUDIO_LAYER = {
    "ffn1_layer_norm": "ffn1_norm",
    "ffn1.intermediate_dense": "ffn1.intermediate",
    "ffn1.output_dense": "ffn1.output",
    "self_attn_layer_norm": "attention_norm",
    "self_attn.linear_q": "attention.query",
    "self_attn.linear_k": "attention.key",
    "self_attn.linear_v": "attention.value",
    "self_attn.linear_out": "attention.out",
    "conv_module.layer_norm": "conv.norm",
    "conv_module.depthwise_layer_norm": "conv.depthwise_norm",
    "ffn2_layer_norm": "ffn2_norm",
    "ffn2.intermediate_dense": "ffn2.intermediate",
    "ffn2.output_dense": "ffn2.output",
    "final_layer_norm": "final_norm",
}


def as_fp32(v) -> torch.Tensor:
    """A tensor or array as an fp32 CPU tensor (no copy when it is one)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


def strip_prefix(sd: Mapping, prefixes) -> Mapping:
    """``sd`` without the first of ``prefixes`` that some key carries."""
    for p in prefixes:
        if any(k.startswith(p) for k in sd):
            return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    return sd


def copy_affine(sd: Mapping, src: str, dst: str, out: StateDict,
                bias: bool = True) -> None:
    """``src.weight`` (+ ``src.bias``) → ``dst.weight`` (+ ``dst.bias``)."""
    out[f"{dst}.weight"] = as_fp32(sd[f"{src}.weight"])
    if bias and f"{src}.bias" in sd:
        out[f"{dst}.bias"] = as_fp32(sd[f"{src}.bias"])


def convert_text_encoder(sd: Mapping, cfg: TextEncoderConfig) -> StateDict:
    """HF {Roberta,XLMRoberta,Bert}Model state dict → ``TextEncoder``
    parameters."""
    sd = strip_prefix(sd, TEXT_PREFIXES)
    out: StateDict = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        copy_affine(sd, f"embeddings.{name}", f"embeddings.{name}", out,
                    bias=False)
    copy_affine(sd, "embeddings.LayerNorm", "embeddings.norm", out)
    for i in range(cfg.num_layers):
        for src, dst in _TEXT_LAYER.items():
            copy_affine(sd, f"encoder.layer.{i}.{src}", f"layer_{i}.{dst}",
                        out)
    return out


def convert_audio_encoder(sd: Mapping, cfg: AudioEncoderConfig) -> StateDict:
    """HF Wav2Vec2BertModel state dict → ``AudioEncoder`` parameters
    (``masked_spec_embed`` only when the source has it)."""
    sd = strip_prefix(sd, AUDIO_PREFIXES)
    out: StateDict = {}
    copy_affine(sd, "feature_projection.layer_norm", "feature_norm", out)
    copy_affine(sd, "feature_projection.projection", "feature_projection",
                out)
    if "masked_spec_embed" in sd:
        out["masked_spec_embed"] = as_fp32(sd["masked_spec_embed"])
    for i in range(cfg.num_layers):
        src, dst = f"encoder.layers.{i}", f"layer_{i}"
        for s, d in _AUDIO_LAYER.items():
            copy_affine(sd, f"{src}.{s}", f"{dst}.{d}", out)
        out[f"{dst}.attention.distance_embedding"] = as_fp32(
            sd[f"{src}.self_attn.distance_embedding.weight"])
        # Conv1d [out, in, 1] → Dense [out, in]; depthwise [C, 1, K] as is
        for k in (1, 2):
            out[f"{dst}.conv.pointwise{k}.weight"] = as_fp32(
                sd[f"{src}.conv_module.pointwise_conv{k}.weight"])[:, :, 0]
        out[f"{dst}.conv.depthwise_kernel"] = as_fp32(
            sd[f"{src}.conv_module.depthwise_conv.weight"])
    return out


def text_config_from_hf(hf_config) -> TextEncoderConfig:
    return TextEncoderConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        pad_token_id=hf_config.pad_token_id,
        layer_norm_eps=hf_config.layer_norm_eps,
        hidden_dropout=hf_config.hidden_dropout_prob,
        attention_dropout=hf_config.attention_probs_dropout_prob,
    )


def audio_config_from_hf(hf_config) -> AudioEncoderConfig:
    return AudioEncoderConfig(
        feature_dim=hf_config.feature_projection_input_dim,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        conv_kernel_size=hf_config.conv_depthwise_kernel_size,
        left_max_rel_pos=hf_config.left_max_position_embeddings,
        right_max_rel_pos=hf_config.right_max_position_embeddings,
        layer_norm_eps=hf_config.layer_norm_eps,
        hidden_dropout=hf_config.hidden_dropout,
        attention_dropout=hf_config.attention_dropout,
        conv_dropout=hf_config.conformer_conv_dropout,
        activation_dropout=hf_config.activation_dropout,
        feat_proj_dropout=hf_config.feat_proj_dropout,
        apply_spec_augment=hf_config.apply_spec_augment,
        mask_time_prob=hf_config.mask_time_prob,
        mask_time_length=hf_config.mask_time_length,
        mask_time_min_masks=hf_config.mask_time_min_masks,
    )
