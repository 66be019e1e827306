# The port's copy of speech_transcript_embeddings_tpu/data/native_audio.py: the port imports
# nothing of the JAX package. Keep the two in step.
"""ctypes bindings for the native C++ audio IO library (native/audio_io.cpp).

Builds the shared library on first use with the system toolchain and caches it
in the package's ignored ``_build/``; every entry point has a pure-Python fallback so the
framework works without a compiler.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("ste_torch")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "audio_io.cpp")
_SO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "_build", "libste_audio.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", _SO, _SRC, "-lpthread"]
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:
        logger.warning("native audio build failed (%s); using Python fallback", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
            if not os.path.exists(_SRC) or not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            logger.warning("could not load %s: %s", _SO, e)
            return None
        lib.ste_decode_wav.restype = ctypes.c_long
        lib.ste_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int)]
        lib.ste_resample.restype = ctypes.c_long
        lib.ste_resample.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long]
        lib.ste_pad_batch.restype = None
        lib.ste_pad_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_long),
            ctypes.c_long, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int]
        _lib = lib
        return _lib


def decode_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes → (mono float32 waveform, sample_rate)."""
    lib = get_lib()
    if lib is not None:
        sr = ctypes.c_int(0)
        n = lib.ste_decode_wav(data, len(data), None, 0, ctypes.byref(sr))
        if n >= 0:
            out = np.empty(n, np.float32)
            got = lib.ste_decode_wav(data, len(data),
                                     out.ctypes.data_as(ctypes.c_void_p), n,
                                     ctypes.byref(sr))
            return out[:got], sr.value
        logger.warning("native WAV decode failed (code %d); Python fallback", n)
    # fallback: scipy
    import io
    from scipy.io import wavfile
    sr, wav = wavfile.read(io.BytesIO(data))
    if wav.dtype.kind == "i":
        wav = wav.astype(np.float32) / float(np.iinfo(wav.dtype).max + 1)
    elif wav.dtype.kind == "u":
        wav = (wav.astype(np.float32) - 128.0) / 128.0
    else:
        wav = wav.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    return wav.astype(np.float32), int(sr)


def decode_audio(data: bytes, name: str = "") -> Tuple[np.ndarray, int]:
    """Decode audio bytes of any supported container → (mono f32 wave, rate).

    WAV goes through the native C++ decoder (scipy fallback). Compressed
    formats — mp3 above all: Common Voice ships mp3 and the reference decoded
    it via librosa (processor.py:74-85) — go through the first available
    backend: ``soundfile`` (libsndfile), then the ``ffmpeg`` CLI (present in
    the deploy image, deploy/Dockerfile.tpu). Raises RuntimeError naming the
    missing backends when neither exists.
    """
    if len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return decode_wav(data)
    return _decode_compressed(data, name)


def _decode_compressed(data: bytes, name: str = "") -> Tuple[np.ndarray, int]:
    try:
        import io

        import soundfile as sf
        wav, sr = sf.read(io.BytesIO(data), dtype="float32", always_2d=True)
        return wav.mean(axis=1).astype(np.float32), int(sr)
    except ImportError:
        pass
    except Exception as e:       # corrupt file or unsupported codec: try ffmpeg
        logger.warning("soundfile could not decode %s (%s); trying ffmpeg",
                       name or "<bytes>", e)
    import shutil
    exe = shutil.which("ffmpeg")
    if exe:
        # decode + mono-mix + resample to 16 kHz in one pipe
        proc = subprocess.run(
            [exe, "-v", "error", "-i", "pipe:0", "-f", "f32le", "-ac", "1",
             "-ar", "16000", "pipe:1"],
            input=data, capture_output=True, timeout=120)
        if proc.returncode == 0 and proc.stdout:
            return np.frombuffer(proc.stdout, np.float32).copy(), 16000
        raise RuntimeError(
            f"ffmpeg failed to decode {name or '<bytes>'}: "
            f"{proc.stderr.decode(errors='replace')[:500]}")
    raise RuntimeError(
        f"No decoder available for compressed audio {name or '<bytes>'} "
        "(WAV decodes natively). Install `soundfile` or the `ffmpeg` CLI — "
        "the TPU deploy image (deploy/Dockerfile.tpu) ships ffmpeg.")


def wav_header_info(path: str):
    """Parse a WAV file's RIFF header → (num_frames, sample_rate) without
    reading the sample data; None when the file is not a parseable WAV (e.g.
    mp3 — the caller decodes those fully) or when the data-chunk size is a
    streaming placeholder (0 or 0xFFFFFFFF, as ffmpeg writes to pipes) that
    cannot be trusted for a length."""
    import struct
    try:
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
                return None
            sr = channels = bits = None
            data_size = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                if cid == b"fmt ":
                    fmt = f.read(size + (size & 1))
                    if len(fmt) < 16:
                        return None
                    channels = struct.unpack("<H", fmt[2:4])[0]
                    sr = struct.unpack("<I", fmt[4:8])[0]
                    bits = struct.unpack("<H", fmt[14:16])[0]
                elif cid == b"data":
                    data_size = size
                    f.seek(size + (size & 1), 1)
                else:
                    f.seek(size + (size & 1), 1)
            if not (sr and channels and bits and data_size):
                return None
            if data_size == 0xFFFFFFFF:     # streaming placeholder
                return None
            return data_size // (channels * max(bits // 8, 1)), sr
    except OSError:
        return None



def resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return np.asarray(wav, np.float32)
    lib = get_lib()
    if lib is not None:
        wav = np.ascontiguousarray(wav, np.float32)
        cap = int(len(wav) * sr_out / sr_in) + 1
        out = np.empty(cap, np.float32)
        n = lib.ste_resample(wav.ctypes.data_as(ctypes.c_void_p), len(wav),
                             sr_in, sr_out,
                             out.ctypes.data_as(ctypes.c_void_p), cap)
        return out[:n]
    from speech_transcript_embeddings_torch.data.sources import _resample_linear
    return _resample_linear(np.asarray(wav, np.float32), sr_in, sr_out)


def pad_batch(clips: Sequence[np.ndarray], bucket: int,
              num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Peak-normalise (only when |x|>1) + zero-pad into ([n, bucket] f32, [n] i32)."""
    n = len(clips)
    lib = get_lib()
    if lib is not None and n:
        clips = [np.ascontiguousarray(c, np.float32) for c in clips]
        ptrs = (ctypes.c_void_p * n)(
            *[c.ctypes.data_as(ctypes.c_void_p).value for c in clips])
        lens = (ctypes.c_long * n)(*[len(c) for c in clips])
        out = np.empty((n, bucket), np.float32)
        counts = np.empty(n, np.int32)
        lib.ste_pad_batch(ptrs, lens, n, bucket,
                          out.ctypes.data_as(ctypes.c_void_p),
                          counts.ctypes.data_as(ctypes.c_void_p), num_threads)
        return out, counts
    out = np.zeros((n, bucket), np.float32)
    counts = np.zeros(n, np.int32)
    for i, c in enumerate(clips):
        c = np.asarray(c, np.float32)[:bucket]
        peak = np.abs(c).max() if len(c) else 0.0
        if peak > 1.0:
            c = c / peak
        out[i, : len(c)] = c
        counts[i] = len(c)
    return out, counts
