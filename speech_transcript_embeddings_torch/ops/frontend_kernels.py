"""CUDA log-mel kernels (``csrc/log_mel.cu``) behind PyTorch wrappers.

Port of the two Pallas kernels of ``speech_transcript_embeddings_tpu/ops/
frontend_pallas.py`` (``_kernel`` and ``_fused_kernel``): ``log_mel`` is the
raw log-mel at every bucket (a real FFT per frame and the sparse mel
product), ``normalize_and_stack`` the masked per-bin normalisation,
stacking and mask (a cluster of blocks per clip). Together they compute the
fused kernel's function; the 30 s bucket, which the TPU sent to the tiled
kernel, runs the same pair. The FFT kernel reads small fp32 tables built
once per config and device from ``frontend.py``'s float64 builders
(``kernel_tables``).

Each wrapper takes the plain twin of ``frontend.py`` for a CPU tensor and
launches its kernel for a CUDA tensor; any other device raises. ``launches``
counts kernel launches (``launches_by_frames`` by frame count, so a run can
show which buckets went through the kernel).
"""

from __future__ import annotations

import collections
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from speech_transcript_embeddings_torch.config import FrontendConfig
from speech_transcript_embeddings_torch.ops import _build
from speech_transcript_embeddings_torch.ops import frontend as fe

def _check_framing(cfg: FrontendConfig):
    if cfg.frame_length != 400 or cfg.hop_length != 160 or cfg.fft_length != 512:
        raise ValueError("the log-mel kernel assumes the w2v-bert 25 ms / 10 ms "
                         "framing with a 512-point FFT")


def _require_cuda(name, *tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")


# the FFT's imaginary input is V_SCALE · Δwindow · s: a power of two that
# brings it to the real input's magnitude (see csrc/log_mel.cu)
V_SCALE = 128.0


@functools.lru_cache(maxsize=None)
def kernel_tables(cfg: FrontendConfig) -> Dict[str, np.ndarray]:
    """The FFT kernel's tables, each built in float64 and rounded once to
    fp32 (int32 for the ranges): ``window`` ``[frame_length]`` (Povey),
    ``window_step`` ``[frame_length + 1]`` (V_SCALE·(w[j] − w[j−1]), w zero
    outside the frame), ``twiddles`` ``[fft_length, 2]`` (re, im of
    ``exp(-2πi·t / fft_length)``), ``response`` ``[fft_length//2 + 1, 2]``
    (the preemphasis response), ``mel_ranges`` ``[num_mel_bins, 3]`` (first
    FFT bin, number of bins, offset into the weights) and ``mel_weights``,
    the nonzeros of ``make_mel_filters`` packed filter after filter."""
    ranges, weights = fe.mel_filter_ranges(cfg)
    offsets = np.cumsum(ranges[:, 1]) - ranges[:, 1]
    window = fe.povey_window(cfg)
    tw, resp = fe.fft_twiddles(cfg), fe.preemphasis_response(cfg)
    tables = {
        "window": window.astype(np.float32),
        "window_step": (V_SCALE * np.diff(window, prepend=0.0, append=0.0)
                        ).astype(np.float32),
        "twiddles": np.stack([tw.real, tw.imag], axis=-1).astype(np.float32),
        "response": np.stack([resp.real, resp.imag],
                             axis=-1).astype(np.float32),
        "mel_ranges": np.concatenate([ranges, offsets[:, None]],
                                     axis=1).astype(np.int32),
        "mel_weights": weights.astype(np.float32),
    }
    for a in tables.values():
        a.flags.writeable = False
    return tables


@functools.lru_cache(maxsize=None)
def _device_tables(cfg: FrontendConfig, device: torch.device):
    return {k: torch.from_numpy(v.copy()).to(device)
            for k, v in kernel_tables(cfg).items()}


def log_mel(cfg: FrontendConfig, waveform: torch.Tensor,
            transform: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
    """Raw log-mel ``[B, F, num_mel_bins]`` fp32 of a padded waveform batch.
    ``transform`` and ``mel`` are the twin's dense matrices (the CPU path
    uses them); the kernel checks their shapes and reads the sparse form of
    ``make_mel_filters(cfg)`` from ``kernel_tables`` instead."""
    if waveform.device.type == "cpu":
        return fe.log_mel_reference(cfg, waveform, transform, mel)
    _check_framing(cfg)
    _require_cuda("log_mel", waveform, transform, mel)
    b, n = waveform.shape
    num_freq = cfg.fft_length // 2 + 1
    if tuple(transform.shape) != (cfg.frame_length, 2 * num_freq) or \
            tuple(mel.shape) != (num_freq, cfg.num_mel_bins):
        raise ValueError(f"bad frontend matrices {tuple(transform.shape)}, "
                         f"{tuple(mel.shape)}")
    num_frames = fe.frames_for_samples(cfg, n)
    wave = waveform.float().contiguous()
    tab = _device_tables(cfg, wave.device)
    out = torch.empty((b, num_frames, cfg.num_mel_bins), dtype=torch.float32,
                      device=wave.device)
    device, stream = _build.launch_args(wave)
    code = _build.library().ste_log_mel(
        wave.data_ptr(), b, n, *(tab[k].data_ptr() for k in (
            "window", "window_step", "twiddles", "response", "mel_ranges",
            "mel_weights")), cfg.num_mel_bins, cfg.preemphasis / V_SCALE,
        float(cfg.mel_floor), out.data_ptr(), num_frames, device, stream)
    _build.check(code, "ste_log_mel")
    log_mel.launches += 1
    log_mel.launches_by_frames[num_frames] += 1
    return out


log_mel.launches = 0
log_mel.launches_by_frames = collections.Counter()


def normalize_and_stack(cfg: FrontendConfig, logmel: torch.Tensor,
                        num_samples: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Features ``[B, F/stride, num_mel_bins·stride]`` and mask
    ``[B, F/stride]`` (int32) from the raw log-mel."""
    if logmel.device.type == "cpu":
        return fe.normalize_and_stack_reference(cfg, logmel, num_samples)
    _require_cuda("normalize_and_stack", logmel)
    b, num_frames, n_mels = logmel.shape
    if n_mels != cfg.num_mel_bins or num_frames % cfg.stride:
        raise ValueError(f"bad log-mel shape {tuple(logmel.shape)}")
    lm = logmel.float().contiguous()
    ns = num_samples.to(device=lm.device, dtype=torch.int32).contiguous()
    if tuple(ns.shape) != (b,):
        raise ValueError(f"num_samples shape {tuple(ns.shape)} != ({b},)")
    t2 = num_frames // cfg.stride
    feats = torch.empty((b, t2, n_mels * cfg.stride), dtype=torch.float32,
                        device=lm.device)
    mask = torch.empty((b, t2), dtype=torch.int32, device=lm.device)
    device, stream = _build.launch_args(lm)
    code = _build.library().ste_log_mel_normalize(
        lm.data_ptr(), ns.data_ptr(), b, num_frames, n_mels, cfg.stride,
        cfg.frame_length, cfg.hop_length, int(cfg.per_bin_normalize),
        feats.data_ptr(), mask.data_ptr(), device, stream)
    _build.check(code, "ste_log_mel_normalize")
    normalize_and_stack.launches += 1
    return feats, mask


normalize_and_stack.launches = 0


class KernelLogMelFrontend(fe.LogMelFrontend):
    """``LogMelFrontend`` through the kernel wrappers (the port of
    ``PallasLogMelFrontend``): kernels for CUDA inputs, twins for CPU."""

    def __init__(self, cfg: FrontendConfig = None):
        super().__init__(cfg)
        _check_framing(self.cfg)

    def raw_log_mel(self, waveform):
        return log_mel(self.cfg, waveform, self.transform, self.mel)

    def normalize_and_stack(self, logmel, num_samples):
        return normalize_and_stack(self.cfg, logmel, num_samples)
