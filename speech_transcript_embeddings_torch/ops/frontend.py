"""Log-mel audio frontend (w2v-bert-2.0 / SeamlessM4T numerics), plain PyTorch.

Port of ``speech_transcript_embeddings_tpu/ops/frontend.py``: framing →
remove-DC → preemphasis 0.97 → Povey window → rDFT(512) → power → 80-bin
kaldi mel (floor 2^-23) → ln → masked per-utterance per-bin normalisation
(ddof 1) → stride-2 frame stacking. In the twin, the per-frame chain up to
the DFT is one linear map, folded into a ``[400, 514]`` (cos ‖ sin) matrix;
the CUDA kernel computes the same map by an FFT, with the preemphasis
applied in the frequency domain.

This module holds the numpy builders of the two matrices (the JAX module
imports jax, so they are copied here and tested equal), the float64 tables
of the FFT kernel (Povey window, twiddles, preemphasis response, the mel
bank's nonzero ranges),
the frame counts, and the plain versions of the raw log-mel and of
``normalize_and_stack``: the twins of the CUDA kernels in
``frontend_kernels.py`` and the CPU path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from speech_transcript_embeddings_torch.config import FrontendConfig


def _hertz_to_mel_kaldi(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def make_mel_filters(cfg: FrontendConfig) -> np.ndarray:
    """Kaldi-scale triangular mel filter bank ``[fft_length//2 + 1,
    num_mel_bins]`` float64 (transformers' ``mel_filter_bank`` with
    ``mel_scale='kaldi', triangularize_in_mel_space=True``)."""
    num_freq = cfg.fft_length // 2 + 1
    mel_min = _hertz_to_mel_kaldi(cfg.min_frequency)
    mel_max = _hertz_to_mel_kaldi(cfg.max_frequency)
    filter_freqs = np.linspace(mel_min, mel_max, cfg.num_mel_bins + 2)
    fft_bin_width = cfg.sampling_rate / ((num_freq - 1) * 2)
    fft_freqs = _hertz_to_mel_kaldi(fft_bin_width * np.arange(num_freq))

    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    return np.maximum(0.0, np.minimum(down_slopes, up_slopes))


def make_frame_transform(cfg: FrontendConfig) -> np.ndarray:
    """remove-DC, preemphasis, Povey window and the real DFT of the
    zero-padded frame folded into one ``[frame_length, 2·(fft//2 + 1)]``
    float64 matrix (cos ‖ sin halves)."""
    n, f = cfg.frame_length, cfg.fft_length
    num_freq = f // 2 + 1
    dc = np.eye(n) - np.full((n, n), 1.0 / n)
    p = cfg.preemphasis
    pre = np.eye(n)
    pre[0, 0] = 1.0 - p
    for j in range(1, n):
        pre[j - 1, j] = -p
    window = povey_window(cfg)
    t = np.arange(n)[:, None]
    k = np.arange(num_freq)[None, :]
    ang = 2.0 * np.pi * t * k / f
    lin = dc @ pre @ np.diag(window)
    return np.concatenate([lin @ np.cos(ang), lin @ -np.sin(ang)], axis=1)


def povey_window(cfg: FrontendConfig) -> np.ndarray:
    """Kaldi's Povey window ``hanning(frame_length) ** 0.85``, float64."""
    return np.hanning(cfg.frame_length) ** 0.85


def fft_twiddles(cfg: FrontendConfig) -> np.ndarray:
    """``exp(-2πi·t / fft_length)`` for ``t < fft_length``, complex128: the
    twiddles of the kernel's ``fft_length``-point FFT."""
    ang = 2.0 * np.pi * np.arange(cfg.fft_length) / cfg.fft_length
    return np.cos(ang) - 1j * np.sin(ang)


def preemphasis_response(cfg: FrontendConfig) -> np.ndarray:
    """``1 − p·exp(-2πi·k / fft_length)`` for the ``fft_length//2 + 1``
    bins, complex128: the preemphasis filter in the frequency domain."""
    k = np.arange(cfg.fft_length // 2 + 1)
    ang = 2.0 * np.pi * k / cfg.fft_length
    return 1.0 - cfg.preemphasis * (np.cos(ang) - 1j * np.sin(ang))


def mel_filter_ranges(cfg: FrontendConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse form of ``make_mel_filters``: ``ranges`` int32 ``[num_mel_bins,
    2]`` (first FFT bin, number of bins) of each filter's nonzeros and their
    float64 weights packed filter after filter (501 at the default config).
    A triangular filter's nonzeros are contiguous; raises if one is not."""
    mel = make_mel_filters(cfg)
    ranges, weights = [], []
    for m in range(mel.shape[1]):
        nz = np.flatnonzero(mel[:, m])
        start = int(nz[0]) if nz.size else 0
        if nz.size and nz[-1] - start + 1 != nz.size:
            raise ValueError(f"mel filter {m} has non-contiguous nonzeros")
        ranges.append((start, nz.size))
        weights.append(mel[start:start + nz.size, m])
    return np.asarray(ranges, np.int32), np.concatenate(weights)


def num_valid_frames(cfg: FrontendConfig, num_samples: torch.Tensor
                     ) -> torch.Tensor:
    """Frames fully contained in the first ``num_samples`` samples."""
    return torch.where(
        num_samples >= cfg.frame_length,
        1 + torch.div(num_samples - cfg.frame_length, cfg.hop_length,
                      rounding_mode="floor"),
        torch.zeros_like(num_samples))


def frames_for_samples(cfg: FrontendConfig, num_samples: int) -> int:
    """Static frame count for a padded waveform of ``num_samples`` samples,
    rounded up to a multiple of ``stride``."""
    if num_samples < cfg.frame_length:
        raise ValueError(f"audio bucket {num_samples} shorter than one frame")
    t = 1 + (num_samples - cfg.frame_length) // cfg.hop_length
    return ((t + cfg.stride - 1) // cfg.stride) * cfg.stride


def log_mel_reference(cfg: FrontendConfig, waveform: torch.Tensor,
                      transform: torch.Tensor, mel: torch.Tensor
                      ) -> torch.Tensor:
    """Raw log-mel ``[B, F, num_mel_bins]`` (fp32): framing → folded DFT →
    power → mel → ``log(max(·, mel_floor))``. Frames past the waveform read
    zeros. Plain twin of the ``ste_log_mel`` kernel."""
    b, n = waveform.shape
    num_frames = frames_for_samples(cfg, n)
    num_freq = transform.shape[1] // 2
    need = (num_frames - 1) * cfg.hop_length + cfg.frame_length
    scaled = torch.nn.functional.pad(waveform.float() * 2.0 ** 15,
                                     (0, max(need - n, 0)))
    frames = scaled.unfold(1, cfg.frame_length, cfg.hop_length)[:, :num_frames]
    spec = frames @ transform
    power = spec[..., :num_freq] ** 2 + spec[..., num_freq:] ** 2
    return torch.log(torch.clamp(power @ mel, min=cfg.mel_floor))


def normalize_and_stack_reference(cfg: FrontendConfig, logmel: torch.Tensor,
                                  num_samples: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked per-utterance, per-bin normalisation (ddof 1, padding → 0)
    and stride stacking; the mask is taken at the last frame of each stride
    group. Plain twin of the ``ste_log_mel_normalize`` kernel."""
    b, num_frames, _ = logmel.shape
    valid = num_valid_frames(cfg, num_samples.to(logmel.device))
    frame_mask = (torch.arange(num_frames, device=logmel.device)[None, :]
                  < valid[:, None])
    if cfg.per_bin_normalize:
        fmask = frame_mask[..., None].float()
        count = torch.clamp(valid.float(), min=1.0)[:, None, None]
        mean = torch.sum(logmel * fmask, dim=1, keepdim=True) / count
        centred = (logmel - mean) * fmask
        var = (torch.sum(centred * centred, dim=1, keepdim=True)
               / torch.clamp(count - 1.0, min=1.0))
        logmel = centred * torch.rsqrt(var + 1e-7)
    else:
        logmel = logmel * frame_mask[..., None]
    t2 = num_frames // cfg.stride
    features = logmel.reshape(b, t2, cfg.num_mel_bins * cfg.stride)
    mask = frame_mask.reshape(b, t2, cfg.stride)[:, :, cfg.stride - 1]
    return features, mask.to(torch.int32)


class LogMelFrontend(nn.Module):
    """Waveform batch ``[B, N]`` (fp32, zero-padded) and valid sample counts
    ``[B]`` → stacked features ``[B, T, num_mel_bins·stride]`` and mask
    ``[B, T]`` (int32). The DFT and mel matrices are fp32 buffers; the
    matmuls run in full fp32."""

    def __init__(self, cfg: FrontendConfig = None):
        super().__init__()
        self.cfg = cfg or FrontendConfig()
        self.register_buffer("transform", torch.as_tensor(
            make_frame_transform(self.cfg), dtype=torch.float32),
            persistent=False)
        self.register_buffer("mel", torch.as_tensor(
            make_mel_filters(self.cfg), dtype=torch.float32),
            persistent=False)

    def raw_log_mel(self, waveform: torch.Tensor) -> torch.Tensor:
        return log_mel_reference(self.cfg, waveform, self.transform, self.mel)

    def normalize_and_stack(self, logmel, num_samples):
        return normalize_and_stack_reference(self.cfg, logmel, num_samples)

    def forward(self, waveform: torch.Tensor, num_samples: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if waveform.ndim != 2:
            raise ValueError(f"expected [B, N] waveform, got {waveform.shape}")
        return self.normalize_and_stack(self.raw_log_mel(waveform),
                                        num_samples)
