"""Host heap growth in large steps, for a process that keeps what its CUDA
searches return.

A search's answers are small host arrays (values and rows, 20 KB for 32
queries of 80), and a client that keeps them grows glibc's heap with every
call. By default malloc extends the heap by its top pad, 128 KB, at a time.
On an H100 host under gVisor (which handles the address space's changes in
user space) the calls after each extension ran about 1.5 ms slower, in the
upload, the kernels' launches and the downloads alike: in a closed loop of
32-query searches over 21,015,324 x 128 bf16 rows that kept four answers a
call, 15-20% of calls, every 6th or 7th (128 KB / 20 KB). With a top pad of
64 MiB, about 1% (PERF.md, section 6).

`grow_in_large_steps` sets the top pad to HEAP_STEP and trims the heap only
past TRIM_THRESHOLD. Setting either stops glibc's moving mmap threshold
where the process's earlier frees have put it; setting it as well (to 32
MiB) made 2,048-query searches slower than leaving it there. It costs
address space, not memory: pages are touched only when used. It acts once a
process, and only where the C library has mallopt (glibc); elsewhere it does
nothing.
"""
from __future__ import annotations

import ctypes

HEAP_STEP = 64 << 20        # bytes the heap grows by at a time (M_TOP_PAD)
TRIM_THRESHOLD = 2 * HEAP_STEP  # free bytes at the heap's top before it shrinks

# mallopt's parameters (malloc.h)
_M_TRIM_THRESHOLD, _M_TOP_PAD = -1, -2

_set: bool | None = None  # the outcome, once tried


def grow_in_large_steps() -> bool:
    """Sets malloc's top pad and trim threshold (once a process). True where
    they are set, False where the C library has no mallopt or refused them."""
    global _set
    if _set is None:
        try:
            mallopt = ctypes.CDLL(None).mallopt
        except (OSError, AttributeError):
            _set = False
        else:
            mallopt.argtypes, mallopt.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
            _set = all(mallopt(param, value) == 1 for param, value in (
                (_M_TOP_PAD, HEAP_STEP), (_M_TRIM_THRESHOLD, TRIM_THRESHOLD)))
    return _set
