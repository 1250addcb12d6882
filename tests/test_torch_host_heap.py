"""utils/host_heap.py: once a CUDA index has searched, glibc's heap grows in
steps of HEAP_STEP, so a client that keeps its answers extends it rarely.
Runs on the CPU: the settings are the C library's, not the card's."""
import ctypes
import platform

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from proqa_tpu_torch.index import dense  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.utils import host_heap  # noqa: E402

GLIBC = platform.libc_ver()[0] == "glibc"


def test_settings_take_where_glibc_is_and_once():
    assert host_heap.grow_in_large_steps() is GLIBC
    assert host_heap.grow_in_large_steps() is GLIBC  # a second call changes nothing


def test_kept_answers_grow_the_heap_in_large_steps():
    """Arrays of a 32-query answer's size, all kept: every move of the
    program break is at least HEAP_STEP (malloc's default is 128 KB)."""
    if not GLIBC:
        assert host_heap.grow_in_large_steps() is False
        return
    host_heap.grow_in_large_steps()
    sbrk = ctypes.CDLL(None).sbrk
    sbrk.argtypes, sbrk.restype = [ctypes.c_ssize_t], ctypes.c_void_p
    kept, moves, at = [], [], sbrk(0)
    for _ in range(20_000):  # 400 MB of answers at most: several steps
        kept.append(np.ones(2560, dtype=np.float32) * 2)  # 10 KB, as vals [32, 80]
        now = sbrk(0)
        if now != at:
            moves.append(now - at)
            at = now
    assert moves and all(m >= host_heap.HEAP_STEP for m in moves), moves[:5]


def test_cpu_index_leaves_malloc_alone(monkeypatch):
    calls = []
    monkeypatch.setattr(dense, "grow_in_large_steps", lambda: calls.append(1))
    rows = torch.randn(2048, 16)
    index = DenseIndex.from_embeddings(rows, device="cpu", dtype=torch.float32)
    vals, ids = index.search(rows[:4].numpy(), 3)
    assert vals.shape == ids.shape == (4, 3)
    assert calls == []
