"""The loop forms of K2 and K3 (head dims past 256) pass p, ds, ds^T and
pd^T between kernels as wgmma A fragments.

The scores kernels (csrc/attention_fwd.cu, csrc/attention_bwd.cu) round
each 64 x 64 tile to bf16 fragments (attention_tiles.cuh:pack_rows), write
them in fragment order (store_frags, frag_tile), K3's transposes through a
padded shared-memory tile (transpose_frags), and attention_slice_kernel
reads them back (fetch) as the A operand of one m64nNk16 wgmma a k-step.
This mirrors that index arithmetic with numpy, thread by thread, and holds
the A operand the slice kernel feeds the tensor cores to the tile, or its
transpose, and the sum of its products over a slice to o = p v (as dq = ds
k), dk = ds^T q and dv = pd^T do.
"""
import numpy as np
import pytest

TILE, WARPGROUP, TRANS_LD = 64, 128, 64 + 8
FRAG_WORDS = 16 * WARPGROUP


def frag_row(t):
    return 16 * (t // 32) + (t % 32) // 4


def frag_col(t):
    return 2 * (t % 4)


def accumulator(x):
    """s[t][i] of a 64 x 64 tile in the wgmma accumulator layout."""
    s = np.empty((WARPGROUP, 32), x.dtype)
    for t in range(WARPGROUP):
        for i in range(32):
            s[t, i] = x[frag_row(t) + 8 * ((i // 2) % 2), 8 * (i // 4) + frag_col(t) + i % 2]
    return s


def pack_rows(s):
    """a[t][ks][r] as (low, high) element pairs."""
    a = np.empty((WARPGROUP, 4, 4, 2), s.dtype)
    for ks in range(4):
        for r in range(4):
            a[:, ks, r, 0] = s[:, 8 * ks + 2 * r]
            a[:, ks, r, 1] = s[:, 8 * ks + 2 * r + 1]
    return a


def transpose_frags(a):
    buf = np.full((TILE, TRANS_LD), np.nan, a.dtype)
    for t in range(WARPGROUP):
        row, col = frag_row(t), frag_col(t)
        for ks in range(4):
            for r in range(4):
                at = (row + 8 * (r % 2), 16 * ks + 8 * (r // 2) + col)
                buf[at[0], at[1]:at[1] + 2] = a[t, ks, r]
    out = np.empty_like(a)
    for t in range(WARPGROUP):
        row, col = frag_row(t), frag_col(t)
        for ks in range(4):
            for r in range(4):
                j, i = row + 8 * (r % 2), 16 * ks + 8 * (r // 2) + col
                out[t, ks, r] = buf[i, j], buf[i + 1, j]
    return out


def store_frags(frags, base, a):
    for t in range(WARPGROUP):
        for ks in range(4):
            for r in range(4):
                frags[base + (4 * ks + r) * WARPGROUP + t] = a[t, ks, r]


def fetch(frags, base):
    a = np.empty((WARPGROUP, 4, 4, 2), frags.dtype)
    for t in range(WARPGROUP):
        for ks in range(4):
            for r in range(4):
                a[t, ks, r] = frags[base + (4 * ks + r) * WARPGROUP + t]
    return a


def a_operand(a):
    """The 64 x 64 matrix the wgmma A register layout gives: per k-step ks,
    a warp's 16 rows; register r holds row t / 4 + 8 (r % 2) of the warp's,
    columns 16 ks + 8 (r / 2) + 2 (t % 4) and the next."""
    m = np.full((TILE, TILE), np.nan, a.dtype)
    for t in range(WARPGROUP):
        lane = t % 32
        for ks in range(4):
            for r in range(4):
                row = 16 * (t // 32) + lane // 4 + 8 * (r % 2)
                col = 16 * ks + 8 * (r // 2) + 2 * (lane % 4)
                m[row, col:col + 2] = a[t, ks, r]
    return m


def frag_index(kind, tiles, bh, nt, it, kt):
    """frag_tile's offset in the kind-th of K3's arrays (K2 has one)."""
    return kind * tiles * FRAG_WORDS + (bh * nt + it) * nt * FRAG_WORDS + kt * FRAG_WORDS


@pytest.mark.parametrize("seed", [0, 1])
def test_a_fragments_are_the_tile_and_its_transpose(seed):
    x = np.random.default_rng(seed).standard_normal((TILE, TILE)).astype(np.float32)
    a = pack_rows(accumulator(x))
    np.testing.assert_array_equal(a_operand(a), x)
    np.testing.assert_array_equal(a_operand(transpose_frags(a)), x.T)


@pytest.mark.parametrize("bh_count,seq,dh", [(2, 128, 384), (1, 256, 512)])
def test_slice_products_are_dq_dk_dv(bh_count, seq, dh):
    """The scores kernel's writes and the slice kernels' reads, over every
    tile of `bh_count` (batch, head) slices: each slice kernel's sum of A
    times its streamed tile equals the product of the whole matrices."""
    rng = np.random.default_rng(seq + dh)
    nt = seq // TILE
    tiles = bh_count * nt * nt
    ds, pd = (rng.standard_normal((bh_count, seq, seq)).astype(np.float32) for _ in range(2))
    q, k, do = (rng.standard_normal((bh_count, seq, dh)).astype(np.float32) for _ in range(3))
    frags = np.full((3 * tiles * FRAG_WORDS, 2), np.nan, np.float32)  # u32: two bf16
    for bh in range(bh_count):
        for it in range(nt):  # the scores kernel's block
            for kt in range(nt):  # its sweep 2
                rows, keys = slice(it * TILE, (it + 1) * TILE), slice(kt * TILE, (kt + 1) * TILE)
                a = pack_rows(accumulator(ds[bh, rows, keys]))
                store_frags(frags, frag_index(0, tiles, bh, nt, it, kt), a)
                store_frags(frags, frag_index(1, tiles, bh, nt, it, kt), transpose_frags(a))
                a = pack_rows(accumulator(pd[bh, rows, keys]))
                store_frags(frags, frag_index(2, tiles, bh, nt, it, kt), transpose_frags(a))
    assert not np.isnan(frags).any()
    for kind, src, want in ((0, k, ds @ k), (1, q, ds.transpose(0, 2, 1) @ q),
                            (2, do, pd.transpose(0, 2, 1) @ do)):
        for bh in range(bh_count):
            for tile in range(nt):  # the slice kernel's block rows (all of its Dh slices)
                acc = np.zeros((TILE, dh), np.float64)
                for item in range(nt):
                    base = (frag_index(kind, tiles, bh, nt, tile, item) if kind == 0
                            else frag_index(kind, tiles, bh, nt, item, tile))
                    acc += a_operand(fetch(frags, base)) @ src[bh, item * TILE:(item + 1) * TILE]
                np.testing.assert_allclose(acc, want[bh, tile * TILE:(tile + 1) * TILE],
                                           rtol=1e-4, atol=1e-3)
