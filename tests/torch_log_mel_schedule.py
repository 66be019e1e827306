"""Float32 numpy emulation of the log-mel CUDA kernels' schedule
(speech_transcript_embeddings_torch/csrc/log_mel.cu), step for step: the
tests hold it against the JAX package, and
scripts/torch_log_mel_fft_accuracy.py against float64. It imports no JAX."""

import numpy as np
import torch

from speech_transcript_embeddings_torch.ops import frontend as fe
from speech_transcript_embeddings_torch.ops import frontend_kernels as fk

F32 = np.float32
H = F32(0.70710678118654752)       # √½, as the kernel's dft8 rounds it
# Stockham stages (radix R, Ns) of the kernel's 512-point FFT
STAGES_512 = ((8, 1), (8, 8), (8, 64))


def cx(re, im):
    out = np.empty(np.shape(re), np.complex64)
    out.real, out.imag = re, im
    return out


def dft4(a0, a1, a2, a3):
    """log_mel.cu dft4: outputs 0..3 in natural order."""
    t0, t2, t1, u = a0 + a2, a0 - a2, a1 + a3, a1 - a3
    t3 = cx(u.imag, -u.real)                       # (a1 − a3)·(−i)
    return t0 + t1, t2 + t3, t0 - t1, t2 - t3


def dft8(v):
    """log_mel.cu dft8 along the last axis: a radix-2 step, two dft4."""
    a = [v[..., n] + v[..., n + 4] for n in range(4)]
    d = [v[..., n] - v[..., n + 4] for n in range(4)]
    b = [d[0], cx(H * (d[1].real + d[1].imag), H * (d[1].imag - d[1].real)),
         cx(d[2].imag, -d[2].real),
         cx(H * (d[3].imag - d[3].real), -H * (d[3].real + d[3].imag))]
    ea, eb = dft4(*a), dft4(*b)
    return np.stack([x for pair in zip(ea, eb) for x in pair], axis=-1)


def stockham(z, tw, stages=STAGES_512):
    """Stockham FFT along the last axis of ``z`` (complex64, length n):
    butterfly j of a stage (R, Ns) reads z[j + r·n/R], twiddles by
    W_{Ns·R}^{r·(j mod Ns)} (entry r·(j mod Ns)·len(tw)/(Ns·R) of the
    ``tw`` table of W_len(tw)) and writes (j / Ns)·Ns·R + j mod Ns + r·Ns.
    Radix 8 and 4 butterflies are the kernel's dft8 and dft4."""
    n = z.shape[-1]
    for radix, ns in stages:
        j = np.arange(n // radix)[:, None]
        r = np.arange(radix)[None, :]
        v = z[..., j + (n // radix) * r]
        if ns > 1:
            v = v * tw[r * (j % ns) * (len(tw) // (ns * radix))]
        v = dft8(v) if radix == 8 else np.stack(
            dft4(*np.moveaxis(v, -1, 0)), axis=-1)
        z = np.empty_like(z)
        z[..., (j // ns) * ns * radix + j % ns + ns * r] = v
    return z


def frames_of(cfg, wav):
    """[B, F, 400] float32 frames (×2^15, zeros past the waveform) and the
    DC-removed frames, the mean summed in float32."""
    b, n = wav.shape
    nf = fe.frames_for_samples(cfg, n)
    x = np.zeros((b, max(n, (nf - 1) * cfg.hop_length + cfg.frame_length)),
                 F32)
    x[:, :n] = wav * F32(2 ** 15)
    frames = x[:, np.arange(nf)[:, None] * cfg.hop_length
               + np.arange(cfg.frame_length)]
    mean = frames.sum(-1, dtype=F32) / F32(cfg.frame_length)
    return frames - mean[..., None]


def sparse_mel_log(cfg, power):
    """log(max(Σ over each filter's (start, length) range, mel_floor)), the
    sum in ascending bin order."""
    tab = fk.kernel_tables(cfg)
    out = np.zeros(power.shape[:-1] + (cfg.num_mel_bins,), F32)
    for m, (start, length, off) in enumerate(tab["mel_ranges"]):
        for i in range(length):
            out[..., m] += power[..., start + i] * tab["mel_weights"][off + i]
    return np.log(np.maximum(out, F32(cfg.mel_floor)))


def emulate_log_mel(cfg, wav):
    """Raw log-mel ``[B, F, n_mels]`` by log_mel_fft_kernel's stages: u =
    window·d and v = V_SCALE·Δwindow·s (s[j] = d[j−1], s[0] = d[0]) as the
    real and imaginary inputs of one 512-point complex FFT; the two-signal
    split; X_k = H_k·U_k − (p / V_SCALE)·V_k; power; sparse mel; log."""
    tab = fk.kernel_tables(cfg)
    tw = cx(tab["twiddles"][:, 0], tab["twiddles"][:, 1])
    resp = cx(tab["response"][:, 0], tab["response"][:, 1])
    d = frames_of(cfg, wav)
    n = cfg.frame_length
    s = np.concatenate([d[..., :1], d], axis=-1)            # n + 1 long
    u = np.zeros(d.shape[:-1] + (cfg.fft_length,), F32)
    v = np.zeros_like(u)
    u[..., :n] = tab["window"] * d
    v[..., :n + 1] = tab["window_step"] * s
    z = stockham(cx(u, v), tw)
    k = np.arange(cfg.fft_length // 2 + 1)
    a, c = z[..., k], np.conj(z[..., (cfg.fft_length - k) % cfg.fft_length])
    uk, dk = (a + c) * F32(0.5), (a - c) * F32(0.5)
    hu = uk * resp
    coef = F32(cfg.preemphasis / fk.V_SCALE)
    xr, xi = hu.real - coef * dk.imag, hu.imag + coef * dk.real
    return sparse_mel_log(cfg, xr * xr + xi * xi)


def emulate_normalize(cfg, logmel, num_samples, ranks=8, threads=512):
    """Normalised ``[B, F, n_mels]``, stacked features and mask by
    log_mel_normalize_kernel's schedule: ``ranks`` slices of ceil(F /
    (ranks·stride))·stride frames; in a slice, lane l of ``threads //
    n_mels`` sums (x − K) and (x − K)² over frames l, l + lanes, ... (K the
    slice's first frame), the lanes' sums added in order give the slice's
    (count, mean, M2); the slices merge in rank order by the multi-way form
    of Chan's formula."""
    b, nf, n_mels = logmel.shape
    lanes = threads // n_mels
    slice_ = -(-nf // (ranks * cfg.stride)) * cfg.stride
    valid = fe.num_valid_frames(cfg, torch.from_numpy(num_samples)).numpy()
    out = np.zeros_like(logmel)
    for i, nv in enumerate(valid):
        if not cfg.per_bin_normalize:
            out[i, :nv] = logmel[i, :nv]
            continue
        counts, means, m2s = [], [], []
        for q in range(ranks):
            part = logmel[i, q * slice_:min((q + 1) * slice_, nf, nv)]
            shift = part[0] if len(part) else np.zeros(n_mels, F32)
            t1, t2 = np.zeros(n_mels, F32), np.zeros(n_mels, F32)
            for lane in range(lanes):
                c = part[lane::lanes] - shift
                t1 += c.sum(0, dtype=F32)
                t2 += (c * c).sum(0, dtype=F32)
            d = t1 / F32(len(part)) if len(part) else t1
            counts.append(F32(len(part)))
            means.append(shift + d)
            m2s.append(np.maximum(t2 - t1 * d, F32(0)))
        n = F32(sum(counts))
        mu = sum(c * m for c, m in zip(counts, means)) / max(n, F32(1))
        m2 = sum(s + c * (m - mu) ** 2 for c, m, s in zip(counts, means, m2s))
        inv = F32(1) / np.sqrt(m2 / max(n - 1, F32(1)) + F32(1e-7))
        out[i, :nv] = (logmel[i, :nv] - mu) * inv
    t2 = nf // cfg.stride
    mask = (np.arange(t2)[None] * cfg.stride + cfg.stride - 1
            < valid[:, None]).astype(np.int32)
    return out, out.reshape(b, t2, -1), mask


def float64_log_mel(cfg, wav):
    """The twin's raw log-mel in float64: the yardstick of accuracy."""
    b, n = wav.shape
    nf = fe.frames_for_samples(cfg, n)
    x = np.zeros((b, max(n, (nf - 1) * cfg.hop_length + cfg.frame_length)))
    x[:, :n] = wav.astype(np.float64) * 2.0 ** 15
    frames = x[:, np.arange(nf)[:, None] * cfg.hop_length
               + np.arange(cfg.frame_length)]
    spec = frames @ fe.make_frame_transform(cfg)
    k = spec.shape[-1] // 2
    power = spec[..., :k] ** 2 + spec[..., k:] ** 2
    return np.log(np.maximum(power @ fe.make_mel_filters(cfg), cfg.mel_floor))
