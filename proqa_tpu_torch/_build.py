"""Builds the hand-written CUDA kernels and loads them.

`csrc/*.cu` compile with nvcc into one shared library with a plain C
interface, `build/proqa_tpu_torch/libproqa_kernels_<hash>.so` at the root of
the checkout, on first use: one nvcc process per source, all started
together, then one link. The name carries a hash of the sources and flags,
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U, _L, _U64 = ctypes.c_uint32, ctypes.c_longlong, ctypes.c_uint64
_DROPOUT = [_U, _U, _U, _F]  # k0, k1, threshold, 1/(1-rate) (ops/random.py)
_SIGNATURES = {
    # queries, corpus, scale_a, scale_b, bmax, gmax, num_q, n, dim, block, group,
    # is_bf16, corpus_int8, stream
    "proqa_block_maxima": [_P] * 6 + [_I] * 7 + [_P],
    # queries, corpus, bmax, gmax, num_q, n, dim, block, group, stream
    "proqa_block_maxima_wgmma": [_P] * 4 + [_I] * 5 + [_P],
    # queries, corpus, ids, out, num_q, nb, kb, block, dim, is_bf16, stream
    "proqa_gather_score": [_P] * 4 + [_I] * 6 + [_P],
    # q, k, v, key_mask, out, batch, heads, seq, head_dim, scale, is_bf16,
    # dropout, k0, k1, threshold, inv_keep, stream
    "proqa_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, *_DROPOUT, _P],
    # q, k, v, dout, key_mask, dq, dk, dv, stats, keep_bits, batch, heads, seq,
    # head_dim, scale, is_bf16, dropout, k0, k1, threshold, inv_keep, stream
    "proqa_attention_bwd": [_P] * 10 + [_I, _I, _I, _I, _F, _I, _I, *_DROPOUT, _P],
    # x, y, n, seed, threshold, inv_keep, is_bf16, stream
    "proqa_dropout": [_P, _P, _L, _U64, _U, _F, _I, _P],
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
    for src in sorted(CSRC.glob("*.cu*")):  # sources and the headers they include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libproqa_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[tuple[list[str], subprocess.CompletedProcess]]:
    """Runs the commands side by side and waits for all of them."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    done = []
    for cmd, p in procs:
        output = p.communicate()[0]  # reads the pipe to its end, then waits
        done.append((cmd, subprocess.CompletedProcess(cmd, p.returncode, output, "")))
    return done


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc per source in parallel, then one link. The compiler's report (ptxas
    register and shared-memory use) is kept beside the library as
    `<name>.log`. Raises with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        steps = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                          for src, obj in zip(sources, objects)])
        link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp),
                *map(str, objects)]
        if all(proc.returncode == 0 for _, proc in steps):
            steps += _run_all([link])
        log = "".join(f"$ {' '.join(cmd)}\n{proc.stdout}" for cmd, proc in steps)
        failed = [(cmd, proc) for cmd, proc in steps if proc.returncode != 0]
        if failed:
            cmd, proc = failed[0]
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n  "
                               f"{' '.join(cmd)}\n{proc.stdout}")
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
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


def launch(entry: str, device, *args) -> None:
    """Calls the library's `entry` with args and the raw handle of the
    current stream on `device` (a CUDA torch.device with its index), on that
    device, and raises if the launch failed. The host path is kept short:
    the stream handle is read without building a torch.cuda.Stream, and the
    current device is switched only when it is another one."""
    import torch

    fn = getattr(_lib if _lib is not None else library(), entry)
    index = device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        code = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            code = fn(*args, stream)
    if code != 0:
        check(code, entry)
