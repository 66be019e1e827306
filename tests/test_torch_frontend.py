"""Port of the log-mel frontend: numpy builders, plain twins and the kernel
frontend's CPU path against the JAX ``LogMelFrontend`` and the Pallas
frontend (fused and tiled, interpret mode), at the shapes of
tests/test_frontend_pallas.py. Also the float32 numpy emulation of the CUDA
kernels' schedule (tests/torch_log_mel_schedule.py: the pre-steps, the
512-point Stockham FFT of two real signals, the split with the
preemphasis response, the sparse mel product, the per-slice partials
merged by Chan's formula), held against JAX."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from speech_transcript_embeddings_tpu.config import FrontendConfig
from speech_transcript_embeddings_torch import config as tconfig
from speech_transcript_embeddings_tpu.ops import frontend as jfe
from speech_transcript_embeddings_tpu.ops import frontend_pallas as jfp
from speech_transcript_embeddings_torch.ops import frontend as fe
from speech_transcript_embeddings_torch.ops import frontend_kernels as fk
from speech_transcript_embeddings_torch.ops import make_frontend
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401
from torch_log_mel_schedule import (
    cx, emulate_log_mel, emulate_normalize, float64_log_mel, stockham,
)

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
    np.testing.assert_array_equal(fe.make_frame_transform(port_cfg(cfg)),
                                  jfe.make_frame_transform(cfg))
    np.testing.assert_array_equal(fe.make_mel_filters(port_cfg(cfg)),
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
    feats, mask = fe.LogMelFrontend(port_cfg(cfg))(torch.from_numpy(wav),
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
    front = fe.LogMelFrontend(port_cfg(cfg))
    got = front.raw_log_mel(torch.from_numpy(wav)).numpy()
    nf = fe.frames_for_samples(port_cfg(cfg), 16000)
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
    cfg = tconfig.FrontendConfig(use_pallas=True)
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
    cfg = tconfig.FrontendConfig()
    front = fk.KernelLogMelFrontend(cfg).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        front.raw_log_mel(torch.zeros(1, 41200, device="meta"))
    with pytest.raises(ValueError, match="framing"):
        fk.KernelLogMelFrontend(tconfig.FrontendConfig(hop_length=128))


EMU_CASES = {
    "w2v_bert": FrontendConfig(),
    "tiny_8_bins": FrontendConfig(num_mel_bins=8),
    "no_per_bin_normalize": FrontendConfig(per_bin_normalize=False),
}


@pytest.mark.parametrize("name", list(EMU_CASES))
def test_kernel_schedule_emulation_matches_jax(name):
    """The kernels' schedule, emulated in float32, against the JAX
    spectrogram (raw, valid frames, 2e-4), ``LogMelFrontend`` (features
    2e-3, mask exact) and ``pallas_log_mel_fused`` in interpret mode
    (normalised log-mel 2e-3), on a batch with a clip under one frame and
    clips that end inside a cluster rank's slice."""
    cfg = EMU_CASES[name]
    lens = LENGTHS + [399]
    wav, lens = _batch(lens)
    nf = fe.frames_for_samples(port_cfg(cfg), BUCKET)
    slice_ = -(-nf // 16) * 2
    valid = fe.num_valid_frames(port_cfg(cfg), torch.from_numpy(lens)).numpy()
    assert valid[-1] == 0 and valid[2] % slice_ and valid[2] < 2 * slice_
    raw = emulate_log_mel(port_cfg(cfg), wav)
    ref_raw = np.asarray(jfe._log_mel_spectrogram(
        cfg, jnp.asarray(jfe.make_frame_transform(cfg), jnp.float32),
        jnp.asarray(jfe.make_mel_filters(cfg), jnp.float32),
        jnp.asarray(wav), nf, 257))
    vmask = np.arange(nf)[None] < valid[:, None]
    np.testing.assert_allclose(raw[vmask], ref_raw[vmask], rtol=2e-4,
                               atol=2e-4)
    normed, feats, mask = emulate_normalize(port_cfg(cfg), raw, lens)
    ref_feats, ref_mask = jfe.LogMelFrontend(cfg)(jnp.asarray(wav),
                                                  jnp.asarray(lens))
    np.testing.assert_array_equal(mask, np.asarray(ref_mask))
    np.testing.assert_allclose(feats, np.asarray(ref_feats), rtol=2e-3,
                               atol=2e-3)
    fused = np.asarray(jfp.pallas_log_mel_fused(
        cfg, jnp.asarray(jfp.packed_transform(cfg)),
        jnp.asarray(jfp.packed_mel(cfg)), jnp.asarray(wav),
        jnp.asarray(lens), True))[..., :cfg.num_mel_bins]
    np.testing.assert_allclose(normed, fused, rtol=2e-3, atol=2e-3)


def test_kernel_schedule_keeps_the_low_mel_bins_accurate():
    """Preemphasis is a high-pass, so the lowest mel bins hold ~1e-3 of a
    frame's power. The kernel applies it in the frequency domain, which
    keeps the error of every mel bin, the lowest included, within 1e-4 of
    a float64 evaluation on noise clips of the 164,080 bucket. The twin's
    error is ≈4e-5 there. An fp32 FFT of the preemphasised frame has
    errors ~10× larger (scripts/torch_log_mel_fft_accuracy.py)."""
    cfg = tconfig.FrontendConfig()
    wav, _ = _batch([164080, 120000, 50000, 20000], 164080, seed=4)
    err = np.abs(emulate_log_mel(cfg, wav) - float64_log_mel(cfg, wav))
    assert err.max() < 1e-4, err.max(axis=(0, 1))[:8]


def test_fft_schedule_matches_numpy_fft():
    """The kernel's Stockham radix-8 schedule and twiddle table against
    numpy's float64 FFT: within float32 rounding of the largest output."""
    rng = np.random.default_rng(3)
    z = (rng.normal(size=(6, 512)) + 1j * rng.normal(size=(6, 512)))
    tab = fk.kernel_tables(tconfig.FrontendConfig())["twiddles"]
    got = stockham(z.astype(np.complex64), cx(tab[:, 0], tab[:, 1]))
    ref = np.fft.fft(z.astype(np.complex64).astype(np.complex128))
    assert np.abs(got - ref).max() < 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("name", list(CFGS))
def test_mel_filter_ranges_rebuild_the_filter_bank(name):
    cfg = tconfig.FrontendConfig(num_mel_bins=CFGS[name].num_mel_bins)
    dense = fe.make_mel_filters(cfg)
    ranges, weights = fe.mel_filter_ranges(cfg)
    assert ranges.shape == (cfg.num_mel_bins, 2)
    rebuilt = np.zeros_like(dense)
    off = 0
    for m, (start, length) in enumerate(ranges):
        rebuilt[start:start + length, m] = weights[off:off + length]
        off += length
    assert off == len(weights) == np.count_nonzero(dense)
    np.testing.assert_array_equal(rebuilt, dense)
    if cfg.num_mel_bins == 80:
        assert len(weights) == 501
    tab = fk.kernel_tables(cfg)
    np.testing.assert_array_equal(tab["mel_ranges"][:, :2], ranges)
    np.testing.assert_array_equal(
        tab["mel_ranges"][:, 2], np.cumsum(ranges[:, 1]) - ranges[:, 1])
    np.testing.assert_array_equal(tab["mel_weights"],
                                  weights.astype(np.float32))


def test_kernel_tables_are_float64_definitions_rounded_once():
    """Window, its steps, twiddles and the preemphasis response equal their
    float64 definitions to within half an fp32 ulp (plus 1e-15 where the
    exact value is 0)."""
    cfg = tconfig.FrontendConfig()
    tab = fk.kernel_tables(cfg)
    n = np.arange(400)
    window = (0.5 - 0.5 * np.cos(2 * np.pi * n / 399)) ** 0.85
    padded = np.concatenate([[0.0], window, [0.0]])
    t = np.arange(512)
    twiddles = np.stack([np.cos(2 * np.pi * t / 512),
                         -np.sin(2 * np.pi * t / 512)], axis=-1)
    k = np.arange(257)
    response = np.stack([1 - 0.97 * np.cos(2 * np.pi * k / 512),
                         0.97 * np.sin(2 * np.pi * k / 512)], axis=-1)
    for got, ref in ((tab["window"], window),
                     (tab["window_step"], 128 * (padded[1:] - padded[:-1])),
                     (tab["twiddles"], twiddles),
                     (tab["response"], response)):
        assert got.dtype == np.float32 and got.shape == ref.shape
        half_ulp = np.spacing(np.abs(ref).astype(np.float32)) / 2
        assert np.all(np.abs(got.astype(np.float64) - ref)
                      <= half_ulp + 1e-15)


def test_frame_counts_match_jax():
    cfg = FrontendConfig()
    for n in (41200, 82160, 164080, 246000, 491760, 16000, 48000):
        assert fe.frames_for_samples(port_cfg(cfg), n) == \
            jfe.frames_for_samples(cfg, n)
    ns = np.asarray([0, 399, 400, 559, 560, 491760], np.int32)
    np.testing.assert_array_equal(
        fe.num_valid_frames(port_cfg(cfg), torch.from_numpy(ns)).numpy(),
        np.asarray(jfe.num_valid_frames(cfg, jnp.asarray(ns))))
