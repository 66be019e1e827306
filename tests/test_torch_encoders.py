"""The port's encoders and heads against the JAX modules on the same params
(tiny config, fp32, ragged masks, 1e-4): the audio encoder through the
flash path (JAX's Pallas kernel in interpret mode, the port's twin) and the
plain path, the text encoder, and the two heads."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_transcript_embeddings_tpu.config import tiny_model_config
from speech_transcript_embeddings_tpu.models import audio_encoder as jae
from speech_transcript_embeddings_tpu.models import heads as jheads
from speech_transcript_embeddings_tpu.models import text_encoder as jte
from speech_transcript_embeddings_torch import bridge
from speech_transcript_embeddings_torch.models import audio_encoder as tae
from speech_transcript_embeddings_torch.models import heads as theads
from speech_transcript_embeddings_torch.models import text_encoder as tte
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel, init_model,
)

MC = tiny_model_config(use_word_alignment=False)
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(params):
    return jax.tree.map(np.asarray, params)


def _port(module, params):
    bridge.load_flax_params(module, _np(params))
    return module.eval().requires_grad_(False)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "plain"])
def test_audio_encoder_matches_jax(flash):
    cfg = dataclasses.replace(MC.audio, use_flash_attention=flash)
    rng = np.random.default_rng(0)
    t = 150
    feats = rng.normal(size=(2, t, cfg.feature_dim)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array([[t], [97]])).astype(np.int32)
    enc = jae.AudioEncoder(cfg)
    # the same tree either way: init through the cheap plain path
    params = jae.AudioEncoder(MC.audio).init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(mask))["params"]
    ref = np.asarray(enc.apply({"params": params}, jnp.asarray(feats),
                               jnp.asarray(mask)))
    port = _port(tae.AudioEncoder(cfg, torch.float32), params)
    got = port(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_text_encoder_matches_jax():
    cfg = MC.text
    rng = np.random.default_rng(1)
    ids = rng.integers(4, cfg.vocab_size, size=(3, 20)).astype(np.int32)
    mask = np.ones_like(ids)
    for row, n in ((1, 11), (2, 5)):
        ids[row, n:], mask[row, n:] = cfg.pad_token_id, 0
    enc = jte.TextEncoder(cfg)
    params = enc.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                      jnp.asarray(mask))["params"]
    ref = np.asarray(enc.apply({"params": params}, jnp.asarray(ids),
                               jnp.asarray(mask)))
    port = _port(tte.TextEncoder(cfg, torch.float32), params)
    got = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(
        tte.roberta_position_ids(torch.from_numpy(ids), 1).numpy(),
        np.asarray(jte.roberta_position_ids(jnp.asarray(ids), 1)))


def test_heads_match_jax():
    rng = np.random.default_rng(2)
    hidden = rng.normal(size=(3, 9, 48)).astype(np.float32)
    mask = (np.arange(9)[None, :] < np.array([[9], [4], [1]])).astype(np.int32)

    pool = jheads.AttentivePooling()
    pp = pool.init(jax.random.PRNGKey(2), jnp.asarray(hidden),
                   jnp.asarray(mask))["params"]
    ref = np.asarray(pool.apply({"params": pp}, jnp.asarray(hidden),
                                jnp.asarray(mask)))
    got = _port(theads.AttentivePooling(48), pp)(
        torch.from_numpy(hidden), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)

    proj = jheads.EnhancedProjection(projection_dim=24, dropout=0.0)
    jp = proj.init(jax.random.PRNGKey(3), jnp.asarray(hidden[:, 0]))["params"]
    ref = np.asarray(proj.apply({"params": jp}, jnp.asarray(hidden[:, 0])))
    got = _port(theads.EnhancedProjection(48, 24), jp)(
        torch.from_numpy(hidden[:, 0])).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_fusion_heads_are_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DualEncoderModel(tiny_model_config())


def test_seeded_init_is_deterministic_and_finite():
    mc = dataclasses.replace(
        MC, heads=dataclasses.replace(MC.heads, use_cross_modal=False),
        audio=dataclasses.replace(MC.audio, use_flash_attention=True))
    a = init_model(mc, torch.Generator().manual_seed(7))
    b = init_model(mc, torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    feats = torch.randn(2, 40, mc.audio.feature_dim,
                        generator=torch.Generator().manual_seed(0))
    mask = torch.ones(2, 40, dtype=torch.int32)
    with torch.no_grad():
        proj, hidden = a.encode_audio(feats, mask)
    assert torch.isfinite(proj).all() and hidden.shape == (2, 40, 48)
