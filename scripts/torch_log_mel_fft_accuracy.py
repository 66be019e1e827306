#!/usr/bin/env python3
"""Accuracy of FFT schedules for the port's raw log-mel kernel, on the CPU.

    python3 scripts/torch_log_mel_fft_accuracy.py

Evaluates three float32 computations of the raw log-mel and compares each
with a float64 evaluation of the twin. The inputs are those of
tests/test_torch_kernels_cuda.py::test_log_mel_kernel_matches_twin. The
three computations are:

* the twin (dense folded DFT, fp32 matmuls);
* the kernel's schedule (tests/torch_log_mel_schedule.py): preemphasis in
  the frequency domain, one 512-point FFT of two real signals;
* the even/odd packed real FFT, with the preemphasis applied in the time
  domain: a 256-point complex FFT of w[2m] + i·w[2m+1] and the real split.
  This is the textbook design. The kernel does not use it, because its
  lowest mel bins are not accurate enough.

For each input it prints the largest error against float64 and the largest
error per mel bin. It also prints the largest ratio of the difference from
the twin to the kernel tests' allowance, 2e-4 + 2e-4·|twin|, as
torch.testing.assert_close(rtol=2e-4, atol=2e-4) counts it. A ratio above 1
fails that test. Everything is float32 numpy, so the numbers say nothing
about the card's speed.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from speech_transcript_embeddings_torch.config import FrontendConfig  # noqa: E402
from speech_transcript_embeddings_torch.ops import frontend as fe  # noqa: E402
from speech_transcript_embeddings_torch.ops import frontend_kernels as fk  # noqa: E402
import test_torch_kernels_cuda as cuda_tests  # noqa: E402
import torch_log_mel_schedule as sched  # noqa: E402

F32 = np.float32


def packed_even_odd(cfg, wav):
    """Raw log-mel by the even/odd packed real FFT, with the preemphasis in
    the time domain, all in float32."""
    tab = fk.kernel_tables(cfg)
    tw = sched.cx(tab["twiddles"][:, 0], tab["twiddles"][:, 1])
    d = sched.frames_of(cfg, wav)
    e = np.empty_like(d)
    e[..., 0] = F32(1.0 - cfg.preemphasis) * d[..., 0]
    e[..., 1:] = d[..., 1:] - F32(cfg.preemphasis) * d[..., :-1]
    w = np.zeros(d.shape[:-1] + (cfg.fft_length,), F32)
    w[..., :cfg.frame_length] = e * tab["window"]
    z = sched.stockham(sched.cx(w[..., 0::2], w[..., 1::2]), tw,
                       ((8, 1), (8, 8), (4, 64)))
    half = cfg.fft_length // 2
    k = np.arange(half + 1)
    a, c = z[..., k % half], np.conj(z[..., (half - k) % half])
    ev, dv = (a + c) * F32(0.5), (a - c) * F32(0.5)
    spec = ev + tw[k] * sched.cx(dv.imag, -dv.real)
    return sched.sparse_mel_log(cfg, spec.real ** 2 + spec.imag ** 2)


def main():
    for case, (batch, bucket, kind, _) in cuda_tests.LOG_MEL_CASES.items():
        cfg = FrontendConfig()
        g = torch.Generator().manual_seed(bucket + batch)
        lens = torch.tensor(cuda_tests._log_mel_lengths(batch, bucket, kind),
                            dtype=torch.int32)
        wav = torch.randn(batch, bucket, generator=g) * 0.1
        wav *= torch.arange(bucket)[None, :] < lens[:, None]
        twin = fe.LogMelFrontend(cfg).raw_log_mel(wav).numpy()
        wav = wav.numpy()
        ref = sched.float64_log_mel(cfg, wav)
        for name, got in (("twin", twin),
                          ("kernel schedule", sched.emulate_log_mel(cfg, wav)),
                          ("even/odd packed", packed_even_odd(cfg, wav))):
            err = np.abs(got - ref).max(axis=(0, 1))
            ratio = (np.abs(got - twin) / (2e-4 + 2e-4 * np.abs(twin))).max()
            worst = np.argsort(-err)[:3]
            print(f"{case:26s} {name:16s} vs float64 {err.max():.2e} (mel "
                  + ", ".join(f"{m}: {err[m]:.1e}" for m in worst)
                  + f"); vs twin {ratio:.3f} of the allowance", flush=True)


if __name__ == "__main__":
    main()
