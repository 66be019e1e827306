"""Build and load the CUDA kernels of ``csrc/`` on first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of them
at once, and the objects are linked into ONE shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), placed
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (see the .cu files)
_SIGNATURES = {
    "ste_log_mel": [_P, _I, _I] + [_P] * 6 + [_I, _F, _F, _P, _I, _I, _P],
    "ste_log_mel_normalize": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                              _I, _P],
    "ste_flash_rel_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _F, _I, _I, _P],
    "ste_flash_rel_bwd": [_P] * 13 + [_I] * 7 + [_F, _F, _I, _I, _P],
    "ste_flash_rel_fwd_wgmma": ([_P] * 5 + [_I] + [_P] * 2 + [_I] * 7
                                + [_F, _I, _P]),
    "ste_flash_rel_bwd_wgmma": [_P] * 15 + [_I] * 7 + [_F, _F, _I, _P],
    "ste_layer_norm_fwd": [_P] * 6 + [_I, _I, _F, _I, _I, _I, _I, _P],
    "ste_layer_norm_bwd": [_P] * 9 + [_I] * 7 + [_P],
    "ste_layer_norm_bwd_blocks": [_I, _I, _I, _P],
    "ste_depthwise_glu_fwd": [_P] * 3 + [_I] * 8 + [_P],
    "ste_depthwise_glu_bwd": [_P] * 6 + [_I] * 8 + [_P],
    "ste_depthwise_glu_blocks": [_I] * 4 + [_P] * 2,
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
    for src in sorted(CSRC.glob("*.cu*")):         # the headers too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libste_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source, run in parallel, then one link. The ptxas
    report (registers, shared memory, spills) goes to ``_build/nvcc.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [(cmd, p.communicate()[0], p.returncode)
            for cmd, p in zip(cmds, procs)]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    if all(rc == 0 for _, _, rc in logs):
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append((link, proc.stdout + proc.stderr, proc.returncode))
    (BUILD_DIR / "nvcc.log").write_text("".join(
        " ".join(cmd) + "\n" + text for cmd, text, _ in logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    failed = [(cmd, text, rc) for cmd, text, rc in logs if rc != 0]
    if failed:
        cmd, text, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
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


def aligned(x):
    """``x`` contiguous with a 16-byte aligned start (the kernels move 16
    bytes at a time)."""
    if not x.is_contiguous():
        x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def launch_args(t):
    """(device index, current stream handle) for a CUDA tensor, as the
    ints that the entry points' argtypes convert (the raw handle, without
    the ``torch.cuda.Stream`` object that ``current_stream`` builds)."""
    import torch
    device = t.get_device()
    return device, torch._C._cuda_getCurrentRawStream(device)
