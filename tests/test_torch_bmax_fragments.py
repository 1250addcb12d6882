"""The register-level block maxima of csrc/block_maxima_wgmma.cu (K1 on
Hopper), mirrored in numpy and held against the plain block maxima.

The kernel never stores a score: each thread folds its own accumulator
columns of a block, then the four threads of a quad exchange halves twice
(`exchange_halves`), and each lane stores the maxima it is left with at an
address computed from its lane. That index arithmetic cannot run on a CPU
as CUDA, so this file repeats it step for step, thread by thread, over the
wgmma accumulator layout (thread t holds d[i] of a 64 x N tile at row
16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4)
+ i % 2), and checks that every block's maximum lands where bmax3 wants it,
for every block size the kernel takes. The GPU tests hold the kernel itself
to its plain version (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from proqa_tpu_torch.ops import mips_kernel  # noqa: E402

CHUNK = 128  # corpus rows a chunk (the wgmma N)


def _fragments(tile: np.ndarray) -> np.ndarray:
    """[128 threads, 64] accumulator registers of a [64, 128] score tile."""
    t = np.arange(128)[:, None]
    i = np.arange(64)[None, :]
    rows = 16 * (t // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2)
    cols = 8 * (i // 4) + 2 * (t % 4) + i % 2
    return tile[rows, cols]


def _exchange(v: np.ndarray, bit: int) -> np.ndarray:
    """exchange_halves over the 128 threads: v [128, K] -> [128, K / 2]."""
    k = v.shape[1] // 2
    upper = ((np.arange(128) & bit) != 0)[:, None]
    send = np.where(upper, v[:, :k], v[:, k:])
    keep = np.where(upper, v[:, k:], v[:, :k])
    return np.maximum(keep, send[np.arange(128) ^ bit])


def _chunk_maxima(d: np.ndarray, block: int) -> np.ndarray:
    """take_maxima's v [128, 2 * nb]: v[h * nb + b] of each thread."""
    nb = max(1, CHUNK // block)
    kj = 16 // nb
    v = np.empty((128, 2 * nb), dtype=d.dtype)
    for h in range(2):
        for b in range(nb):
            js = np.arange(b * kj, (b + 1) * kj)
            v[:, h * nb + b] = np.maximum(d[:, 4 * js + 2 * h], d[:, 4 * js + 2 * h + 1]).max(1)
    return v


def _kernel_group(scores: np.ndarray, block: int):
    """One group of one warpgroup's query tile: scores [64, rows] -> the
    bmax3 rows [64, rows / block] and gmax [64] as the lanes store them."""
    rows = scores.shape[1]
    nb, span = max(1, CHUNK // block), max(1, block // CHUNK)
    out = np.full((64, rows // block), np.nan, dtype=scores.dtype)
    gm = np.full(128, -np.inf, dtype=scores.dtype)
    t = np.arange(128)
    lane = t % 4
    my_q = 16 * (t // 32) + (t % 32) // 4 + 8 * (lane & 1)
    part = None
    for c in range(rows // CHUNK):
        v = _chunk_maxima(_fragments(scores[:, c * CHUNK:(c + 1) * CHUNK]), block)
        if span > 1:
            part = v if c % span == 0 else np.maximum(part, v)
            if c % span != span - 1:
                continue
            v = part
        w = _exchange(v, 1)
        k = v.shape[1]
        if k >= 4:
            u = _exchange(w, 2)
            gm = np.maximum(gm, u.max(1))
            for th in range(128):
                g0 = c * nb + (lane[th] >> 1) * (k // 4)
                out[my_q[th], g0:g0 + k // 4] = u[th]
        else:
            u = np.maximum(w[:, 0], w[t ^ 2, 0])
            gm = np.maximum(gm, u)
            for th in np.flatnonzero((lane >> 1) == 0):
                out[my_q[th], c // span] = u[th]
    gm = np.maximum(gm, gm[t ^ 2])
    gmax = np.full(64, np.nan, dtype=scores.dtype)
    sel = (lane >> 1) == 0
    gmax[my_q[sel]] = gm[sel]
    return out, gmax


@pytest.mark.parametrize("block", mips_kernel.WGMMA_BLOCKS)
@pytest.mark.parametrize("group", [8, 128])
def test_register_maxima_land_where_bmax3_wants_them(block, group):
    rows = group * block
    assert mips_kernel.kernel_for(torch.bfloat16, torch.bfloat16, block=block, group=group,
                                  grouped=True, scaled=False) == "wgmma"
    rng = np.random.default_rng(block + group)
    scores = rng.standard_normal((64, rows)).astype(np.float32)
    out, gmax = _kernel_group(scores, block)
    want = scores.reshape(64, rows // block, block).max(2)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(gmax, want.max(1))


@pytest.mark.parametrize("queries,corpus,block,group,grouped,scaled,want", [
    (torch.bfloat16, torch.bfloat16, 16, 128, True, False, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 256, 128, True, False, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 16, 8, True, False, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 16, 4, True, False, "simple"),    # 64-row groups
    (torch.bfloat16, torch.bfloat16, 48, 128, True, False, "simple"),  # not a power of 2
    (torch.bfloat16, torch.bfloat16, 256, 8, False, False, "simple"),  # block-major (K8)
    (torch.bfloat16, torch.int8, 16, 128, True, True, "simple"),       # K5
    (torch.bfloat16, torch.int8, 16, 128, True, False, "simple"),
    (torch.float32, torch.float32, 16, 128, True, False, "simple"),
])
def test_kernel_choice_is_a_function_of_dtypes_and_shapes(queries, corpus, block, group, grouped,
                                                          scaled, want):
    assert mips_kernel.kernel_for(queries, corpus, block=block, group=group, grouped=grouped,
                                  scaled=scaled) == want
