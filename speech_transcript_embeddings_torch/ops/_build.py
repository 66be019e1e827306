"""Build and load the CUDA kernels of ``csrc/`` on first use.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into ONE shared library with
a plain C interface (no PyTorch headers, so the build takes seconds), placed
in ``speech_transcript_embeddings_torch/_build/`` (listed in ``.gitignore``)
under a name keyed by the sources' and flags' hash, and loaded with
``ctypes``. Each C entry point returns ``cudaGetLastError()`` after its
launch; ``check`` turns a non-zero code into an exception. A missing ``nvcc``
or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (see the .cu files)
_SIGNATURES = {
    "ste_log_mel": [_P, _I, _I, _P, _P, _I, _F, _P, _I, _I, _P],
    "ste_log_mel_normalize": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                              _I, _P],
    "ste_flash_rel_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _F, _I, _I, _P],
}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of speech_transcript_embeddings_torch cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libste_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    The ptxas report (registers, shared memory, spills) goes to
    ``_build/nvcc.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def launch_args(t):
    """(device index, current stream handle) for a CUDA tensor."""
    import torch
    return (t.device.index or 0,
            ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream))
