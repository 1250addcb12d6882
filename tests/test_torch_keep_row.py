"""The dropout mask's per-row shortcut used by the attention kernels.

csrc/random.cuh:ProqaKeepRow draws the mask of a thread's elements of one row
of a 64-key tile with the work they share done once: for a counter n0 and
offsets o < 2^16 whose set bits are clear in n0, lo32(n0 + o) = lo32(n0) ^ o
and the first mix's x >> 16 does not depend on o. This mirrors that
arithmetic in Python and holds it against ops/random.py:bits, which the plain
versions use, on the counters K2 and K3 give it: n0 = ((b H + h) T + i) T
+ key0 + c with T % 64 == 0, key0 % 64 == 0, c in {0, 2, 4, 6}, and offsets
8 n + e, n < 8, e < 2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from proqa_tpu_torch.ops import random  # noqa: E402

MASK32 = random.MASK32


def _mix32_tail(x: int) -> int:
    x = (x * 0x7FEB352D) & MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def _keep_row_bits(k0: int, k1: int, n0: int, o: int) -> int:
    """ProqaKeepRow(k0, k1, n0).keep(o)'s bits, step for step."""
    v = (n0 & MASK32) ^ k0
    x = v ^ (v >> 16)
    y = (n0 >> 32) ^ k1
    return random.mix32(_mix32_tail(x ^ o) ^ y)


def _counters(rng, t: int, count: int):
    """Tile-row counters n0 = (row) T + key0 + c of [B H T, T] masks, some
    near the 2^32 boundaries of the low word."""
    rows = rng.integers(0, 2**40 // t, size=count, dtype=np.int64)
    near = (np.arange(1, 5, dtype=np.int64) << 32) // t  # rows whose counters cross 2^32
    rows[: near.size] = near
    key0 = 64 * rng.integers(0, t // 64, size=count, dtype=np.int64)
    c = 2 * rng.integers(0, 4, size=count, dtype=np.int64)
    return rows * t + key0 + c


@pytest.mark.parametrize("t", [128, 384, 1024])
@pytest.mark.parametrize("seed", [0, 2**61 + 5])
def test_keep_row_matches_the_hash(t, seed):
    rng = np.random.default_rng(seed % 1000 + t)
    k0, k1 = random.keys(seed, 1)
    n0 = _counters(rng, t, 64)
    offsets = np.array([8 * n + e for n in range(8) for e in range(2)], dtype=np.int64)
    want = random.bits(k0, k1, torch.from_numpy(n0[:, None] + offsets[None, :]))
    got = [[_keep_row_bits(k0, k1, int(a), int(o)) for o in offsets] for a in n0]
    assert torch.equal(want, torch.tensor(got, dtype=want.dtype))


@pytest.mark.parametrize("vec", [8, 4])  # elements of a 16-byte vector: bf16, f32
@pytest.mark.parametrize("seed", [3, 2**61 + 5])
def test_keep_row_matches_the_hash_on_dropout_vectors(vec, seed):
    """csrc/dropout.cu draws vector i's mask as ProqaKeepRow(k0, k1, vec i)
    .keep(o) for o < vec: n0 = vec i has the low bits of o clear."""
    rng = np.random.default_rng(seed % 1000 + vec)
    k0, k1 = random.keys(seed, 0)
    vectors = rng.integers(0, 2**40 // vec, size=64, dtype=np.int64)
    vectors[:4] = (np.arange(1, 5, dtype=np.int64) << 32) // vec - 1  # n0 + o near 2^32
    n0 = vec * vectors
    offsets = np.arange(vec, dtype=np.int64)
    want = random.bits(k0, k1, torch.from_numpy(n0[:, None] + offsets[None, :]))
    got = [[_keep_row_bits(k0, k1, int(a), int(o)) for o in offsets] for a in n0]
    assert torch.equal(want, torch.tensor(got, dtype=want.dtype))
