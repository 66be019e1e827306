"""Reference torch checkpoints → a config and the port's state dict.

Port of ``speech_transcript_embeddings_tpu/models/ingest_torch.py``. The
reference saves ``torch.save({'model_state_dict': ..., 'temperature': ...,
'use_cross_modal': ...})``; its inference scripts rebuild the model config
by sniffing state-dict keys. This module does the same so that a user of
the reference can bring a trained ``best_model_gap.pt`` to the port:

  * ``sniff_reference_config`` — the stored hyperparameters where present,
    key patterns and tensor shapes otherwise → an ``ExperimentConfig``;
  * ``state_dict_from_reference_checkpoint`` — every tensor renamed onto
    the port's modules: the encoders through ``models/convert.py``, the
    heads here. A torch ``Linear`` and the port's ``Dense`` are both
    ``[out, in]``, so nothing is transposed; ``nn.MultiheadAttention``'s
    ``in_proj`` is split into ``attn_q``, ``attn_k`` and ``attn_v``.

Checkpoints of the reference's inference-variant model (no
``*_seq_to_projection``) get identity sequence-to-projection maps when
``hidden == projection_dim``, the one geometry in which that older model
runs.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Mapping, Tuple

import torch

from speech_transcript_embeddings_torch import config as config_lib
from speech_transcript_embeddings_torch.models import convert
from speech_transcript_embeddings_torch.models.convert import StateDict

logger = logging.getLogger("ste_torch")


def _strip(sd: Mapping, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _default_heads(hidden: int) -> int:
    """A state dict does not hold the head count: ``hidden // 64`` is that
    of every encoder the reference ships (mpnet 12, roberta-large 16,
    w2v-bert 16); tiny test models fall back to 4 (or 1)."""
    nh = hidden // 64
    if nh == 0 or hidden % (nh * 64):
        nh = 4 if hidden % 4 == 0 else 1
    return nh


def _count_layers(sd: Mapping, pattern: str) -> int:
    n = -1
    for k in sd:
        parts = k.split(".")
        if len(parts) > 2 and parts[0] == pattern and \
                parts[1] in ("layer", "layers"):
            n = max(n, int(parts[2]))
    return n + 1


def sniff_reference_config(ckpt: dict) -> config_lib.ExperimentConfig:
    """Reference checkpoint dict → ExperimentConfig: the hyperparameters the
    reference's trainer stores first, the inference scripts' key sniffing
    for the head flags and the tensor shapes for the geometry otherwise."""
    sd = ckpt["model_state_dict"]
    tsd = _strip(sd, "text_encoder.")
    asd = _strip(sd, "audio_encoder.")

    vocab, t_hidden = tsd["embeddings.word_embeddings.weight"].shape
    text_cfg = config_lib.TextEncoderConfig(
        vocab_size=vocab, hidden_size=t_hidden,
        num_layers=_count_layers(tsd, "encoder"),
        num_heads=_default_heads(t_hidden),
        intermediate_size=tsd[
            "encoder.layer.0.intermediate.dense.weight"].shape[0],
        max_position_embeddings=tsd[
            "embeddings.position_embeddings.weight"].shape[0],
    )
    a_hidden, feat = asd["feature_projection.projection.weight"].shape
    num_pos = asd["encoder.layers.0.self_attn.distance_embedding.weight"
                  ].shape[0]
    if num_pos != 64 + 8 + 1:
        raise ValueError(
            f"distance embedding has {num_pos} positions; only the w2v-bert "
            "64/8 clamp window can be inferred — pass an explicit config")
    audio_cfg = config_lib.AudioEncoderConfig(
        feature_dim=feat, hidden_size=a_hidden,
        num_layers=_count_layers(asd, "encoder"),
        num_heads=_default_heads(a_hidden),
        intermediate_size=asd[
            "encoder.layers.0.ffn1.intermediate_dense.weight"].shape[0],
        conv_kernel_size=asd[
            "encoder.layers.0.conv_module.depthwise_conv.weight"].shape[2],
        left_max_rel_pos=64, right_max_rel_pos=8,
        apply_spec_augment="masked_spec_embed" in asd,
    )

    def flag(key: str, prefix: str) -> bool:
        return bool(ckpt.get(key, any(k.startswith(prefix) for k in sd)))

    proj_w = sd["text_projection.projection.3.weight"]
    heads_cfg = config_lib.HeadsConfig(
        projection_dim=int(ckpt.get("projection_dim", proj_w.shape[0])),
        projection_hidden_dim=sd["text_projection.projection.0.weight"
                                 ].shape[0],
        use_cross_modal=flag("use_cross_modal", "text_to_audio_attention"),
        use_attentive_pooling=flag("use_attentive_pooling", "text_pooling"),
        use_word_alignment=flag("use_word_alignment", "word_level_alignment"),
    )
    frontend_cfg = config_lib.FrontendConfig()
    if frontend_cfg.num_mel_bins * frontend_cfg.stride != feat:
        frontend_cfg = dataclasses.replace(
            frontend_cfg, num_mel_bins=feat // frontend_cfg.stride)
    model_cfg = config_lib.ModelConfig(
        text=text_cfg, audio=audio_cfg, heads=heads_cfg, frontend=frontend_cfg)
    loss_cfg = config_lib.LossConfig(
        temperature=float(ckpt.get("temperature", 0.1)))
    return config_lib.ExperimentConfig(model=model_cfg, loss=loss_cfg)


def _head_state(sd: Mapping, heads: config_lib.HeadsConfig, t_hidden: int,
                a_hidden: int) -> StateDict:
    out: StateDict = {}

    def lin(src: str, dst: str) -> None:     # a Linear or a LayerNorm
        convert.copy_affine(sd, src, dst, out)

    for m in ("text", "audio"):
        lin(f"{m}_projection.projection.0", f"{m}_projection.dense_in")
        lin(f"{m}_projection.projection.3", f"{m}_projection.dense_out")
        lin(f"{m}_projection.projection.4", f"{m}_projection.norm")
        if heads.use_attentive_pooling:
            lin(f"{m}_pooling.attention.0", f"{m}_pooling.score_in")
            lin(f"{m}_pooling.attention.2", f"{m}_pooling.score_out")
    if heads.use_cross_modal:
        for attn in ("text_to_audio_attention", "audio_to_text_attention"):
            for src, dst in (("query", "query"), ("key", "key"),
                             ("value", "value"), ("out_proj", "out")):
                lin(f"{attn}.{src}", f"{attn}.{dst}")
        for m, hidden in (("text", t_hidden), ("audio", a_hidden)):
            lin(f"{m}_fusion.0", f"{m}_fusion")
            lin(f"{m}_fusion.1", f"{m}_fusion_norm")
            key = f"{m}_seq_to_projection"
            if f"{key}.weight" in sd:
                lin(key, key)
            elif hidden == heads.projection_dim:
                # the inference-variant model attends over the raw hidden
                # states: an identity projection reproduces it exactly
                logger.warning("%s missing; using identity (model.py-era "
                               "checkpoint)", key)
                out[f"{key}.weight"] = torch.eye(hidden)
                out[f"{key}.bias"] = torch.zeros(hidden)
            else:
                raise ValueError(
                    f"{key} missing and hidden {hidden} != projection "
                    f"{heads.projection_dim}: checkpoint is not loadable "
                    "(the reference's model would fail on it too)")
    if heads.use_word_alignment:
        wa = "word_level_alignment"
        d = heads.projection_dim
        att = f"{wa}.alignment_attention"
        in_w = convert.as_fp32(sd[f"{att}.in_proj_weight"])      # [3D, D]
        in_b = convert.as_fp32(sd[f"{att}.in_proj_bias"])
        lin(f"{wa}.text_projection", f"{wa}.text_proj")
        lin(f"{wa}.audio_projection", f"{wa}.audio_proj")
        for i, name in enumerate(("attn_q", "attn_k", "attn_v")):
            out[f"{wa}.{name}.weight"] = in_w[i * d:(i + 1) * d]
            out[f"{wa}.{name}.bias"] = in_b[i * d:(i + 1) * d]
        lin(f"{wa}.alignment_attention.out_proj", f"{wa}.attn_out")
        lin(f"{wa}.output_projection", f"{wa}.output_proj")
        lin(f"{wa}.layer_norm", f"{wa}.norm")
        lin(f"{wa}.alignment_confidence.0", f"{wa}.confidence_in")
        lin(f"{wa}.alignment_confidence.2", f"{wa}.confidence_out")
    return out


def state_dict_from_reference_checkpoint(
        ckpt: dict, cfg: config_lib.ExperimentConfig) -> StateDict:
    """Reference checkpoint dict → the port's ``DualEncoderModel(cfg.model)``
    state dict (fp32, every parameter)."""
    sd = ckpt["model_state_dict"]
    out = {f"text_encoder.{k}": v for k, v in convert.convert_text_encoder(
        _strip(sd, "text_encoder."), cfg.model.text).items()}
    out.update({f"audio_encoder.{k}": v for k, v in
                convert.convert_audio_encoder(
                    _strip(sd, "audio_encoder."), cfg.model.audio).items()})
    out.update(_head_state(sd, cfg.model.heads, cfg.model.text.hidden_size,
                           cfg.model.audio.hidden_size))
    return out


def load_reference_checkpoint(path: str
                              ) -> Tuple[config_lib.ExperimentConfig,
                                         StateDict]:
    """``torch.load`` a reference ``*.pt`` (or a bare state dict) →
    (ExperimentConfig, the port's state dict)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "model_state_dict" not in ckpt:
        ckpt = {"model_state_dict": ckpt}
    cfg = sniff_reference_config(ckpt)
    return cfg, state_dict_from_reference_checkpoint(ckpt, cfg)
