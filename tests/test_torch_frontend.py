"""Port of the log-mel frontend: numpy builders, plain twins and the kernel
frontend's CPU path against the JAX ``LogMelFrontend`` and the Pallas
frontend (fused and tiled, interpret mode), at the shapes of
tests/test_frontend_pallas.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from speech_transcript_embeddings_tpu.config import FrontendConfig
from speech_transcript_embeddings_tpu.ops import frontend as jfe
from speech_transcript_embeddings_tpu.ops import frontend_pallas as jfp
from speech_transcript_embeddings_torch.ops import frontend as fe
from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
from speech_transcript_embeddings_torch.ops import make_frontend

CFGS = {"w2v_bert": FrontendConfig(), "tiny_8_bins": FrontendConfig(num_mel_bins=8)}
LENGTHS = [21000, 48000, 7000]
BUCKET = 48000


def _batch(lengths=LENGTHS, bucket=BUCKET, seed=0):
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(lengths), bucket), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.normal(scale=0.1, size=n)
    return wav, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("name", list(CFGS))
def test_numpy_builders_equal_jax_module(name):
    cfg = CFGS[name]
    np.testing.assert_array_equal(fe.make_frame_transform(cfg),
                                  jfe.make_frame_transform(cfg))
    np.testing.assert_array_equal(fe.make_mel_filters(cfg),
                                  jfe.make_mel_filters(cfg))


@pytest.mark.parametrize("jax_front", ["jnp", "pallas_fused", "pallas_tiled"])
def test_features_match_jax(jax_front):
    """Features at 2e-3 and the mask exactly, against each JAX frontend."""
    cfg = CFGS["w2v_bert"]
    wav, lens = _batch()
    ref_front = {
        "jnp": lambda: jfe.LogMelFrontend(cfg),
        "pallas_fused": lambda: jfp.PallasLogMelFrontend(cfg, interpret=True,
                                                          fused=True),
        "pallas_tiled": lambda: jfp.PallasLogMelFrontend(cfg, interpret=True,
                                                          fused=False),
    }[jax_front]()
    ref_feats, ref_mask = ref_front(jnp.asarray(wav), jnp.asarray(lens))
    feats, mask = fe.LogMelFrontend(cfg)(torch.from_numpy(wav),
                                         torch.from_numpy(lens))
    assert feats.dtype == torch.float32 and mask.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref_feats),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", list(CFGS))
def test_raw_log_mel_matches_jax(name):
    """Raw log-mel on the valid frames at 2e-4, against the jnp spectrogram
    and the tiled Pallas kernel (the port reads zeros past the waveform, as
    the Pallas kernel does)."""
    cfg = CFGS[name]
    wav, _ = _batch([16000], 16000, seed=1)
    front = fe.LogMelFrontend(cfg)
    got = front.raw_log_mel(torch.from_numpy(wav)).numpy()
    nf = fe.frames_for_samples(cfg, 16000)
    assert got.shape == (1, nf, cfg.num_mel_bins)
    ref = np.asarray(jfe._log_mel_spectrogram(
        cfg, jnp.asarray(jfe.make_frame_transform(cfg), jnp.float32),
        jnp.asarray(jfe.make_mel_filters(cfg), jnp.float32),
        jnp.asarray(wav), nf, 257))
    valid = 1 + (16000 - 400) // 160
    np.testing.assert_allclose(got[:, :valid], ref[:, :valid], rtol=2e-4,
                               atol=2e-4)
    pal = np.asarray(jfp.pallas_log_mel(
        cfg, jnp.asarray(jfp.packed_transform(cfg)),
        jnp.asarray(jfp.packed_mel(cfg)), jnp.asarray(wav), True))
    np.testing.assert_allclose(got, pal, rtol=2e-4, atol=2e-4)


def test_kernel_frontend_cpu_path_is_the_twin_and_launches_nothing():
    cfg = FrontendConfig(use_pallas=True)
    wav, lens = _batch([399, 30000], 41200, seed=2)   # one clip < 1 frame
    front = make_frontend(cfg)
    assert isinstance(front, fk.KernelLogMelFrontend)
    before = (fk.log_mel.launches, fk.normalize_and_stack.launches)
    feats, mask = front(torch.from_numpy(wav), torch.from_numpy(lens))
    ref_feats, ref_mask = fe.LogMelFrontend(cfg)(torch.from_numpy(wav),
                                                 torch.from_numpy(lens))
    np.testing.assert_array_equal(feats.numpy(), ref_feats.numpy())
    np.testing.assert_array_equal(mask.numpy(), ref_mask.numpy())
    assert (fk.log_mel.launches, fk.normalize_and_stack.launches) == before
    # the clip shorter than one frame: no valid frame, all-zero features
    assert feats.shape == (2, 128, 160) and mask[0].sum() == 0
    assert np.all(feats[0].numpy() == 0) and np.isfinite(feats.numpy()).all()


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    cfg = FrontendConfig()
    front = fk.KernelLogMelFrontend(cfg).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        front.raw_log_mel(torch.zeros(1, 41200, device="meta"))
    with pytest.raises(ValueError, match="framing"):
        fk.KernelLogMelFrontend(FrontendConfig(hop_length=128))


def test_frame_counts_match_jax():
    cfg = FrontendConfig()
    for n in (41200, 82160, 164080, 246000, 491760, 16000, 48000):
        assert fe.frames_for_samples(cfg, n) == jfe.frames_for_samples(cfg, n)
    ns = np.asarray([0, 399, 400, 559, 560, 491760], np.int32)
    np.testing.assert_array_equal(
        fe.num_valid_frames(cfg, torch.from_numpy(ns)).numpy(),
        np.asarray(jfe.num_valid_frames(cfg, jnp.asarray(ns))))
