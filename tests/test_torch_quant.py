"""The port's int8 serving (``ops/quant.py``, ``Embedder.quantize_int8``)
against the JAX package's (``ops/quant.py``, its ``Embedder.quantize_int8``)
on the same bridged tiny weights, fusion heads on: the same set of Dense
modules quantized (JAX's ``dense_param_paths`` over the pair forward, then
the ``MIN_QUANT_DIM`` gate), bit-equal int8 weights and equal scales (also
from a checkpoint whose fp32 weights serving stores in bf16), and
embeddings within 1e-3 of JAX's int8 ``Embedder``. The port's ``weight_q``
is ``[out, in]``, the transpose of JAX's ``kernel_q``.
"""

import dataclasses

import numpy as np
import pytest
import jax
import torch

from speech_transcript_embeddings_tpu.config import (
    DataConfig, ExperimentConfig, tiny_model_config,
)
from speech_transcript_embeddings_tpu.inference import embed as jembed
from speech_transcript_embeddings_tpu.models.dual_encoder import (
    DualEncoderModel as JaxModel, init_params,
)
from speech_transcript_embeddings_tpu.ops import quant as jquant
from speech_transcript_embeddings_torch import bridge, checkpoints
from speech_transcript_embeddings_torch.inference import embed as tembed
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel,
)
from speech_transcript_embeddings_torch.models.layers import Dense
from speech_transcript_embeddings_torch.ops import quant
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401

TEXTS = ["uma frase de teste", "outra frase diferente aqui", "casa"]


def _cfg(dtype="float32"):
    mc = tiny_model_config(text_hidden=64, audio_hidden=64, projection_dim=48)
    return ExperimentConfig(
        model=dataclasses.replace(mc, dtype=dtype),
        data=DataConfig(dataset="synthetic", max_text_length=12,
                        audio_buckets=(16000, 32000),
                        max_audio_samples=32000))


def _clips():
    rng = np.random.default_rng(1)
    return [rng.normal(scale=0.1, size=n).astype(np.float32)
            for n in (9000, 15000, 4000)]


def _int8_leaves(params) -> dict:
    """JAX's quantized tree → port module name → (kernel_q, kernel_scale)."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict) and "kernel_q" in v:
                out[".".join(prefix + (k,))] = (np.asarray(v["kernel_q"]),
                                                np.asarray(v["kernel_scale"]))
            elif isinstance(v, dict):
                walk(v, prefix + (k,))
    walk(params, ())
    return out


def _port_int8(embedder) -> dict:
    return {name: (m.weight_q.t().numpy(), m.weight_scale.numpy())
            for name, m in embedder.model.named_modules()
            if isinstance(m, quant.Int8Dense)}


@pytest.fixture(scope="module")
def pair():
    cfg = _cfg()
    params = jax.tree.map(np.asarray, init_params(JaxModel(cfg.model),
                                                  jax.random.PRNGKey(0)))
    model = bridge.load_flax_params(DualEncoderModel(port_cfg(cfg.model)),
                                    params)
    full = tembed.Embedder(port_cfg(cfg), model)
    fp = (full.embed_texts(TEXTS), full.embed_audios(_clips()))
    ref = jembed.Embedder(cfg, params).quantize_int8()
    port = tembed.Embedder(port_cfg(cfg), model).quantize_int8()
    return ref, port, fp, params


def test_quantized_denses_are_jax_dense_param_paths(pair):
    """JAX's traced Dense paths, gated by ``MIN_QUANT_DIM``, name the same
    modules as the port's ``Int8Dense``s; the word-alignment head (not on
    the pair forward) and the pooling score heads ([H/2, 1]) stay Dense."""
    ref, port, _, params = pair
    cfg = ref.cfg
    length, bucket = cfg.data.max_text_length, min(cfg.data.audio_buckets)
    paths = jquant.dense_param_paths(
        ref._pair_full, params,
        jax.ShapeDtypeStruct((1, length), np.int32),
        jax.ShapeDtypeStruct((1, length), np.int32),
        jax.ShapeDtypeStruct((1, bucket), np.float32),
        jax.ShapeDtypeStruct((1,), np.int32))
    def kernel(path):
        node = params
        for k in path:
            node = node[k]
        return node["kernel"]

    traced = {".".join(p) for p in paths}
    gated = {".".join(p) for p in paths
             if min(kernel(p).shape) >= quant.MIN_QUANT_DIM}
    assert set(_port_int8(port)) == set(_int8_leaves(ref.params)) == gated
    assert {"text_pooling.score_out", "audio_pooling.score_out"} <= \
        traced - gated
    assert not any(n.startswith("word_level_alignment") for n in traced)
    assert isinstance(port.model.word_level_alignment.attn_q, Dense)
    assert any(n.startswith("text_fusion") for n in gated)


def test_int8_weights_are_bit_equal_to_jax(pair):
    ref, port, _, _ = pair
    want, got = _int8_leaves(ref.params), _port_int8(port)
    for name, (q, scale) in want.items():
        assert got[name][0].dtype == np.int8, name
        np.testing.assert_array_equal(got[name][0], q, err_msg=name)
        np.testing.assert_array_equal(got[name][1], scale, err_msg=name)


def test_int8_from_a_checkpoint_reads_the_stored_fp32_weights(pair,
                                                              tmp_path):
    """The same fp32 weights saved as a bf16-compute model's (as training
    stores its trainable split): serving casts them to bf16, but the int8
    weights come from the fp32 values, bit-equal to JAX's (which quantizes
    fp32 params whatever the compute dtype); the biases stay fp32."""
    ref, _, _, params = pair
    cfg = port_cfg(_cfg("bfloat16"))
    model = bridge.load_flax_params(
        DualEncoderModel(cfg.model, torch.float32), params)
    path = str(tmp_path / "ckpt")
    checkpoints.save_params_checkpoint(path, model, cfg)
    port = tembed.Embedder.from_checkpoint(path, device="cpu")
    query = lambda: port.model.get_submodule(  # noqa: E731
        "text_encoder.layer_0.attention.query")
    assert query().weight.dtype == torch.bfloat16
    port.quantize_int8()
    want, got = _int8_leaves(ref.params), _port_int8(port)
    assert set(got) == set(want)
    for name, (q, scale) in want.items():
        np.testing.assert_array_equal(got[name][0], q, err_msg=name)
        np.testing.assert_array_equal(got[name][1], scale, err_msg=name)
    sd = bridge.flax_to_state_dict(params)
    assert query().bias.dtype == torch.float32 and torch.equal(
        query().bias, sd["text_encoder.layer_0.attention.query.bias"])


def test_int8_embeddings_match_jax_int8_embedder(pair):
    """Within 1e-3 of JAX's int8 Embedder: ``embed_texts`` through both
    APIs (measured max 3.0e-8); the audio and the pair forward on the same
    log-mel features (measured 6.0e-8), because the two frontends' features
    differ by up to 5.4e-5, and W8A8 turns such a change into one of
    5.7e-3 in the audio embeddings: a rounding x/s_x that crosses a half
    moves a whole int8 step (the port against itself moves 6.5e-3 under a
    1e-6 relative change of its input), so through the two APIs the audio
    is compared with the port's own features. And within cosine 0.995 of
    the port's full-precision embeddings, tests/test_quant.py's bound."""
    ref, port, (te_fp, ae_fp), _ = pair
    clips = _clips()
    te = port.embed_texts(TEXTS)
    np.testing.assert_allclose(te, ref.embed_texts(TEXTS), atol=1e-3)
    wav, lens = port._pad_audio(clips)
    feats, amask = port.frontend(torch.from_numpy(wav), torch.from_numpy(lens))
    ids, masks = port._tokenize(TEXTS)
    batch = {"input_ids": ids, "attention_mask": masks,
             "input_features": feats.numpy(),
             "attention_mask_audio": amask.numpy()}
    with torch.inference_mode():
        got = port.model.forward_pair({k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        audio = port.model.encode_audio(feats, amask)[0]
    # JAX's jitted int8 pair forward, and its unfused audio path
    want = ref._pair_jit(ref.params, batch)

    @jax.jit
    def jaudio(params, f, m):
        with jquant.intercept_int8():
            return JaxModel(ref.cfg.model).apply(
                {"params": params}, f, m, method=JaxModel.encode_audio)[0]

    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)
    np.testing.assert_allclose(
        tembed.l2_normalize(audio).numpy(),
        np.asarray(jembed.l2_normalize(jaudio(ref.params, batch[
            "input_features"], batch["attention_mask_audio"]))), atol=1e-3)
    # the API computes the same: the port's features through the int8 model
    ae = port.embed_audios(clips)
    np.testing.assert_allclose(ae, tembed.l2_normalize(audio).numpy(),
                               atol=1e-6)
    assert np.sum(te * te_fp, -1).min() > 0.995
    assert np.sum(ae * ae_fp, -1).min() > 0.995
    assert not np.allclose(te, te_fp, atol=1e-6)      # the int8 path ran


def test_min_quant_dim_gate_and_the_dims_the_card_takes():
    w = torch.randn(32, 64)
    assert quant.quantize_module(torch.randn(31, 64), None, torch.float32,
                                 torch.device("cpu")) is None
    assert isinstance(quant.quantize_module(w, None, torch.float32,
                                            torch.device("cpu")),
                      quant.Int8Dense)
    # torch._int_mm on the card takes dims that are multiples of 8: refused
    # before anything moves to the card
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.quantize_module(torch.randn(36, 64), None, torch.bfloat16,
                              torch.device("cuda"))


def test_quantizing_twice_changes_nothing(pair):
    _, port, _, _ = pair
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    mods = dict(port.model.named_modules())
    assert port.quantize_int8() is port
    after = port.model.state_dict()
    assert set(after) == set(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert all(mods[n] is m for n, m in port.model.named_modules())
