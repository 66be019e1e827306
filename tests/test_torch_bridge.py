"""Flax param tree → the port's state_dict: exact round trips on the tiny
tree (unrolled and with scanned bottom blocks), bf16 leaves, loud failures,
and full coverage of the flagship-shaped retrieval model."""

import dataclasses

import numpy as np
import pytest
import jax
import torch

from speech_transcript_embeddings_tpu.config import (
    retrieval_model_config, tiny_model_config,
)
from speech_transcript_embeddings_tpu.models.dual_encoder import (
    DualEncoderModel as JaxModel, abstract_params, init_params,
)
from speech_transcript_embeddings_torch import bridge
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel,
)


def tiny_retrieval(**audio):
    mc = tiny_model_config(use_word_alignment=False)
    return dataclasses.replace(
        mc, heads=dataclasses.replace(mc.heads, use_cross_modal=False),
        audio=dataclasses.replace(mc.audio, **audio))


def _scanned(mc, n):
    return dataclasses.replace(
        mc, text=dataclasses.replace(mc.text, scan_bottom=n),
        audio=dataclasses.replace(mc.audio, scan_bottom=n))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny_params():
    return _np_tree(init_params(JaxModel(tiny_retrieval()),
                                jax.random.PRNGKey(0)))


@pytest.mark.parametrize("scan_bottom", [0, 1])
def test_exact_round_trip_tiny(scan_bottom, tiny_params):
    mc = _scanned(tiny_retrieval(), scan_bottom)
    params = (_np_tree(init_params(JaxModel(mc), jax.random.PRNGKey(0)))
              if scan_bottom else tiny_params)
    model = bridge.load_flax_params(DualEncoderModel(mc), params)
    back = bridge.state_dict_to_flax(model, mc)
    flat_a = dict(bridge._flatten(params))
    flat_b = dict(bridge._flatten(back))
    assert set(flat_a) == set(flat_b)
    for path, a in flat_a.items():
        np.testing.assert_array_equal(flat_b[path], a, err_msg=str(path))
    # a scanned bottom lands in layer_0 with the per-layer slice
    layer0 = model.audio_encoder.layer_0.attention.query.weight.detach().numpy()
    src = (params["audio_encoder"]["bottom_stack"]["scan"]["block"]
           if scan_bottom else params["audio_encoder"]["layer_0"])
    kernel = src["attention"]["query"]["kernel"]
    np.testing.assert_array_equal(
        layer0, (kernel[0] if scan_bottom else kernel).T)


def test_bf16_leaves_become_fp32_and_conv_is_transposed(tiny_params):
    params = tiny_params
    bf16 = jax.tree.map(lambda a: np.asarray(a).astype(jax.numpy.bfloat16),
                        params)
    sd = bridge.flax_to_state_dict(bf16)
    assert all(v.dtype == torch.float32 for v in sd.values())
    dw = params["audio_encoder"]["layer_1"]["conv"]["depthwise_kernel"]
    got = sd["audio_encoder.layer_1.conv.depthwise_kernel"].numpy()
    assert dw.shape == (7, 1, 48) and got.shape == (48, 1, 7)
    np.testing.assert_array_equal(
        got, dw.astype(jax.numpy.bfloat16).astype(np.float32).transpose(2, 1, 0))


def test_unused_or_missing_leaves_raise(tiny_params):
    mc, params = tiny_retrieval(), tiny_params
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unused leaves .*stray"):
        bridge.load_flax_params(DualEncoderModel(mc), extra)
    missing = dict(params)
    missing.pop("audio_pooling")
    with pytest.raises(ValueError, match="unset parameters .*audio_pooling"):
        bridge.load_flax_params(DualEncoderModel(mc), missing)


def test_flagship_abstract_tree_covers_meta_model():
    """retrieval_model_config(): 877M parameters, scanned bottoms (7 text,
    19 audio blocks). The abstract tree is shapes only; the port's model is
    built on the meta device. Every leaf maps to exactly one parameter with
    the transposed shape, and every parameter is set."""
    mc = retrieval_model_config()
    shapes = bridge.flax_shapes(abstract_params(JaxModel(mc)))
    with torch.device("meta"):
        model = DualEncoderModel(mc)
    bridge.check_covers(model, shapes)
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert n == sum(p.numel() for p in model.parameters())
    assert 850e6 < n < 900e6
    assert shapes["audio_encoder.layer_18.attention.query.weight"] == (1024, 1024)
    assert shapes["audio_encoder.layer_0.conv.depthwise_kernel"] == (1024, 1, 31)
    assert shapes["text_encoder.embeddings.word_embeddings.weight"] == (250002, 768)
    assert shapes["audio_encoder.layer_23.attention.distance_embedding"] == (73, 64)
