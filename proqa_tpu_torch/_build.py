"""Builds the hand-written CUDA kernels and loads them.

`csrc/*.cu` compile with nvcc into one shared library with a plain C
interface, `build/proqa_tpu_torch/libproqa_kernels_<hash>.so` at the root of
the checkout, on first use. The name carries a hash of the sources and flags,
so an edited source builds anew. The library is loaded with ctypes: every
pointer and the stream pass as `c_void_p`, and every entry point returns a
cudaError_t code that `check` turns into an exception.

Nothing here runs at import: the package imports on machines without nvcc or
a GPU, where only the kernels' plain PyTorch versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "proqa_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # queries, corpus, bmax3, gmax, num_q, n, dim, block, group, is_bf16, stream
    "proqa_block_maxima": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, key_mask, out, batch, heads, seq, head_dim, scale, is_bf16, stream
    "proqa_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}: the CUDA kernels cannot be built"
        )
    return path


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libproqa_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists. The
    compiler's report (ptxas register and shared-memory use) is kept beside
    the library as `<name>.log`. Raises with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n  {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.proqa_error_string.argtypes = [ctypes.c_int]
        lib.proqa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = library().proqa_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} ({msg})")
