"""The register-level block maxima of csrc/block_maxima_wgmma.cu (K1, K5
and K7 on Hopper) and its widening of int8 codes, mirrored in numpy and held
against the plain block maxima and the layout wgmma reads.

The kernel never stores a score: each thread folds its own accumulator
columns of a block, then the four threads of a quad exchange halves twice
(`exchange_halves`), each lane applies the epilogue (K5's block scales, K7's
sign-aware bounds) to the run of blocks it is left with, loading their
scales at an index computed from its lane, and stores the run at an address
computed from its lane. That index arithmetic cannot run on a CPU as CUDA,
so this file repeats it step for step, thread by thread, over the wgmma
accumulator layout (thread t holds d[i] of a 64 x N tile at row
16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4)
+ i % 2), and checks that every block's value lands where bmax3 wants it,
for every block size the kernel takes. For int8 codes, the producer
warpgroup's widening (`widen_share`, `widen_chunk`, `widen_pair`) is
mirrored byte by byte: every code of a chunk must land, as the bf16 of its
value, at the byte that wgmma's B descriptor (`desc_sw128`) reads for it.
The GPU tests hold the kernel itself to its plain version
(tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from proqa_tpu_torch.ops import mips_kernel  # noqa: E402
from proqa_tpu_torch.ops.dot import dot_f32  # noqa: E402

CHUNK = 128  # corpus rows a chunk (the wgmma N)
HALF = 16384  # bytes of one 64-column half of a bf16 chunk (one bf16 TMA box)


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


def _epilogue(u: np.ndarray, first: np.ndarray, scale_a, scale_b) -> np.ndarray:
    """RawMaxima, BlockScales or RowBounds over each thread's run u [128, N]
    of blocks first [128] + 0 .. N - 1 (of the whole corpus), in f32."""
    if scale_a is None:
        return u
    idx = first[:, None] + np.arange(u.shape[1])
    if scale_b is None:
        return u * scale_a[idx]
    return np.where(u >= 0, u * scale_a[idx], u * scale_b[idx])


def _my_q() -> np.ndarray:
    """The query row (of its warpgroup's 64) whose maxima each thread stores."""
    t = np.arange(128)
    return 16 * (t // 32) + (t % 32) // 4 + 8 * (t % 4 & 1)


def _lane_runs(scores: np.ndarray, block: int, g: int = 0, group: int | None = None,
               scale_a=None, scale_b=None):
    """take_maxima over group g (of `group` blocks) of one warpgroup's query
    tile, scores [64, rows]: (runs, gm), runs the (thread, first block of
    its run within the group, values) of every store a lane makes, after the
    epilogue of scale_a and scale_b (f32 [NB] of the whole corpus, or None),
    and gm [128] each thread's group maximum before the final exchange."""
    rows = scores.shape[1]
    group = rows // block if group is None else group
    nb, span = max(1, CHUNK // block), max(1, block // CHUNK)
    runs = []
    gm = np.full(128, -np.inf, dtype=scores.dtype)
    t = np.arange(128)
    lane = t % 4
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
            # Blocks::first: the lane's run starts at block c nb + (lane >> 1) k / 4
            first = g * group + c * nb + (lane >> 1) * (k // 4)
            u = _epilogue(u, first, scale_a, scale_b)
            gm = np.maximum(gm, u.max(1))
            for th in range(128):
                runs.append((th, c * nb + (lane[th] >> 1) * (k // 4), u[th]))
        else:
            u = np.maximum(w[:, 0], w[t ^ 2, 0])
            first = np.full(128, g * group + c // span)
            u = _epilogue(u[:, None], first, scale_a, scale_b)[:, 0]
            gm = np.maximum(gm, u)
            for th in np.flatnonzero((lane >> 1) == 0):
                runs.append((th, c // span, u[th:th + 1]))
    return runs, gm


def _kernel_group(scores: np.ndarray, block: int, g: int = 0, group: int | None = None,
                  scale_a=None, scale_b=None):
    """Group g (of `group` blocks) of one warpgroup's query tile: scores
    [64, rows] -> the bmax3 rows [64, rows / block] and gmax [64] as the
    lanes store them (the Grouped layout), after the epilogue of scale_a and
    scale_b (f32 [NB] of the whole corpus, or None)."""
    runs, gm = _lane_runs(scores, block, g, group, scale_a, scale_b)
    out = np.full((64, scores.shape[1] // block), np.nan, dtype=scores.dtype)
    my_q = _my_q()
    for th, b0, u in runs:
        out[my_q[th], b0:b0 + len(u)] = u
    t = np.arange(128)
    lane = t % 4
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


@pytest.mark.parametrize("block", mips_kernel.WGMMA_BLOCKS)
@pytest.mark.parametrize("kind", ["scales", "scale_bounds"])
def test_register_epilogues_land_where_bmax3_wants_them(block, kind):
    """K5's and K7's epilogues in the mirror: each lane's scale index, the
    multiply after the max and before the group maximum, K7's sign branch
    (a third of the blocks score below zero, one block is all zero codes),
    and block 256's fold across two chunks, held bit for bit against the
    plain version on the same f32 scores, for group 1 of 2."""
    group, groups = 8, 2
    n = group * block * groups
    assert mips_kernel.kernel_for(torch.bfloat16, torch.int8, block=block, group=group,
                                  grouped=True, scaled=True) == "wgmma"
    rng = np.random.default_rng(block + len(kind))
    queries = torch.from_numpy(np.abs(rng.standard_normal((64, 128))).astype(np.float32) / 11.3)
    queries = queries.bfloat16()
    codes = rng.integers(-127, 128, (n // block, block, 128))
    codes[::3] = -np.abs(codes[::3])      # these blocks score <= 0 against |queries|
    codes[1] = 0                          # an all-zero block
    codes = torch.from_numpy(codes.reshape(n, 128).astype(np.int8))
    if kind == "scales":
        sa, sb = rng.uniform(1e-3, 5e-2, n // block).astype(np.float32), None
        sa[1] = 1.0
        kw = {"scales": torch.from_numpy(sa)}
    else:
        rs = rng.uniform(1e-3, 5e-2, (n // block, block)).astype(np.float32)
        sa, sb = rs.max(1), rs.min(1)
        kw = {"scale_bounds": (torch.from_numpy(sa), torch.from_numpy(sb))}
    bmax3, gmax = mips_kernel.block_maxima_grouped_reference(queries, codes, block=block,
                                                             group=group, **kw)
    scores = dot_f32(codes.to(torch.bfloat16), queries.T).T.numpy()  # [64, N], as the plain one
    assert (scores.reshape(64, -1, block).max(2) < 0).any()
    g = 1
    rows = slice(g * group * block, (g + 1) * group * block)
    out, gm = _kernel_group(scores[:, rows], block, g=g, group=group, scale_a=sa, scale_b=sb)
    np.testing.assert_array_equal(out, bmax3[g].numpy())
    np.testing.assert_array_equal(gm, gmax[g, 0].numpy())


def _tile_n_cases():
    return [(block, tile_n) for block in mips_kernel.WGMMA_BLOCKS
            for tile_n in (128, 256, 512, 1024, 2048) if tile_n >= block]


@pytest.mark.parametrize("num_q", [65, 200])
@pytest.mark.parametrize("block,tile_n", _tile_n_cases())
def test_block_major_stores_land_once_on_their_maxima(block, tile_n, num_q):
    """K8 on the Hopper kernel: every lane's run of finished maxima goes to
    bmax[(group * tile + block) * num_q + query], block by block num_q
    floats apart (store_blocks<BlockMajor>). Over a whole launch (two
    warpgroups of 64 queries a CUDA block, ragged query tiles, three tiles
    of tile_n rows) each (block, query) of bmax [NB, num_q] is written
    exactly once, with its maximum, and nothing lands past it."""
    group = tile_n // block
    assert mips_kernel.kernel_for(torch.bfloat16, torch.bfloat16, block=block, group=group,
                                  grouped=False, scaled=False) == "wgmma"
    tiles, nwg = 3, 2 if num_q > 64 else 1
    q_pad = -(-num_q // (64 * nwg)) * 64 * nwg
    rng = np.random.default_rng(block + tile_n + num_q)
    scores = rng.standard_normal((q_pad, tiles * tile_n)).astype(np.float32)
    nb = tiles * tile_n // block
    mem = np.full(nb * num_q + 4096, np.nan, dtype=np.float32)
    writes = np.zeros(mem.shape, dtype=np.int64)
    my_q = _my_q()
    for q_base in range(0, q_pad, 64):              # warpgroups of all query tiles
        for g in range(tiles):
            runs, _ = _lane_runs(scores[q_base:q_base + 64, g * tile_n:(g + 1) * tile_n],
                                 block, g=g, group=group)
            for th, b0, u in runs:
                q = q_base + my_q[th]
                if q >= num_q:                      # the kernel's out == nullptr
                    continue
                at = (g * group + b0 + np.arange(len(u))) * num_q + q
                mem[at] = u
                writes[at] += 1
    assert (writes[:nb * num_q] == 1).all()
    assert not writes[nb * num_q:].any()
    want = scores[:num_q].reshape(num_q, nb, block).max(2).T        # [NB, Q]
    np.testing.assert_array_equal(mem[:nb * num_q].reshape(nb, num_q), want)


# --- K1 over f32: csrc/block_maxima_f32.cu ---

F32_BOX = 16384  # bytes of one corpus stage: a TMA box of 128 rows x 32 f32 columns
F32_TILES = [8, 16]  # queries a thread (QT): tiles of 128 queries (Q <= 128) or 256


def _f32_threads():
    """(qg, rg) of the 256 FMA threads: lane l of warp w is (2 w + l / 16, l % 16)."""
    t = np.arange(256)
    return 2 * (t // 32) + (t % 32) // 16, t % 16


def _f32_lane_query(rg, qt: int):
    """lane_query<QT>: the query (of its thread tile) a lane stores."""
    j = 4 * (rg & 1) + 2 * (rg >> 1 & 1) + (rg >> 2 & 1)
    return 2 * j + (rg >> 3 & 1) if qt == 16 else j


def _f32_exchange(v: np.ndarray, bit: int) -> np.ndarray:
    """exchange_halves over the 256 FMA threads: v [256, K] -> [256, K / 2]."""
    k = v.shape[1] // 2
    t = np.arange(256)
    upper = ((t & bit) != 0)[:, None]
    send = np.where(upper, v[:, :k], v[:, k:])
    keep = np.where(upper, v[:, k:], v[:, :k])
    return np.maximum(keep, send[t ^ bit])


def _f32_kernel_group(scores: np.ndarray, block: int, qt: int, num_q: int):
    """One group of one CUDA block of bmax_f32_kernel<block, qt>: scores
    [16 qt queries, rows] -> (bmax3 rows [16 qt, rows / block], gmax, and the
    count of stores at each (query, block) and each gmax slot), as the lanes
    store them (nan where no lane stores: queries past num_q)."""
    rows, nq = scores.shape[1], 16 * qt
    qg, rg = _f32_threads()
    t = np.arange(256)
    fold = 8 if block >= CHUNK else block // 16
    nb, span = 8 // fold, max(1, block // CHUNK)
    run = nb if qt == 16 else (nb // 2 if nb >= 2 else 1)
    my_q = qg + 16 * _f32_lane_query(rg, qt)
    out = np.full((nq, rows // block), np.nan, dtype=scores.dtype)
    writes = np.zeros(out.shape, dtype=np.int64)
    gm = np.full(256, -np.inf, dtype=scores.dtype)
    part = None
    j, i = np.arange(qt), np.arange(8)
    for c in range(rows // CHUNK):
        chunk = scores[:, c * CHUNK:(c + 1) * CHUNK]
        # products: acc[th, j, i] = score of query qg + 16 j, chunk row rg + 16 i
        acc = chunk[qg[:, None, None] + 16 * j[None, :, None],
                    rg[:, None, None] + 16 * i[None, None, :]]
        # the fold: v[th, j * nb + b] = max over the thread's rows of block b
        v = acc.reshape(256, qt, nb, fold).max(3).reshape(256, qt * nb)
        if span > 1:
            part = v if c % span == 0 else np.maximum(part, v)
            if c % span != span - 1:
                continue
            v = part
        w = _f32_exchange(_f32_exchange(_f32_exchange(v, 1), 2), 4)
        u = _f32_exchange(w, 8) if qt == 16 or nb >= 2 else np.maximum(w, w[t ^ 8])
        gm = np.maximum(gm, u.max(1))
        for th in range(256):
            if my_q[th] >= num_q:
                continue
            if qt == 16:
                b0 = c // span * nb
            elif nb >= 2:
                b0 = c * nb + (nb // 2 if rg[th] & 8 else 0)
            elif rg[th] & 8 == 0:
                b0 = c // span
            else:
                continue
            out[my_q[th], b0:b0 + run] = u[th]
            writes[my_q[th], b0:b0 + run] += 1
    if qt == 8:
        gm = np.maximum(gm, gm[t ^ 8])
    gmax = np.full(nq, np.nan, dtype=scores.dtype)
    gmax_writes = np.zeros(nq, dtype=np.int64)
    sel = (my_q < num_q) & ((rg & 8) == 0 if qt == 8 else True)
    gmax[my_q[sel]] = gm[sel]
    np.add.at(gmax_writes, my_q[sel], 1)
    return out, gmax, writes, gmax_writes


@pytest.mark.parametrize("qt", F32_TILES)
def test_f32_thread_tiles_cover_the_step_once(qt):
    """The 256 FMA threads' qt x 8 tiles (queries qg + 16 j, rows rg + 16 i)
    cover the 16 qt x 128 step exactly once, and the 16 lanes of a half warp
    share their queries and hold every row of the chunk between them."""
    qg, rg = _f32_threads()
    cover = np.zeros((16 * qt, 128), dtype=np.int64)
    for th in range(256):
        np.add.at(cover, (qg[th] + 16 * np.arange(qt)[:, None], rg[th] + 16 * np.arange(8)), 1)
    assert (cover == 1).all()
    halves = np.arange(256) // 16
    for h in range(16):
        assert len(set(qg[halves == h])) == 1
        assert sorted(rg[halves == h]) == list(range(16))


@pytest.mark.parametrize("qt,num_q", [(8, 128), (8, 100), (16, 256), (16, 200)])
@pytest.mark.parametrize("block", mips_kernel.WGMMA_BLOCKS)
def test_f32_register_maxima_land_where_bmax3_wants_them(block, qt, num_q):
    """bmax_f32_kernel's fold, exchanges of halves, runs and group maximum,
    thread by thread, for both query tiles: every (query, block) of a group
    of 8 blocks (block 256: across two chunks) is stored once with its
    maximum, gmax once with the group's, and nothing past num_q."""
    group = 8
    assert mips_kernel.kernel_for(torch.float32, torch.float32, block=block, group=group,
                                  grouped=True, scaled=False) == "f32"
    rng = np.random.default_rng(block + num_q)
    scores = rng.standard_normal((16 * qt, group * block)).astype(np.float32)
    out, gmax, writes, gmax_writes = _f32_kernel_group(scores, block, qt, num_q)
    want = scores.reshape(16 * qt, group, block).max(2)
    np.testing.assert_array_equal(out[:num_q], want[:num_q])
    np.testing.assert_array_equal(gmax[:num_q], want[:num_q].max(1))
    assert (writes[:num_q] == 1).all() and not writes[num_q:].any()
    assert (gmax_writes[:num_q] == 1).all() and not gmax_writes[num_q:].any()


@pytest.mark.parametrize("qt", F32_TILES)
def test_f32_shared_loads_and_stores_are_conflict_free(qt):
    """The f32 kernel's shared-memory addresses: the query tile's stores
    (load_queries) and every float4 load of products(), unit u of a box,
    computed as the kernel computes them ((row * 128 + phase * 16) ^ 16 u +
    2048 k), lie where TMA's 128-byte swizzle puts that row's columns 4 u ..
    4 u + 3 of the box. Each quarter warp's distinct addresses hit distinct
    16-byte bank groups, and a warp's load takes the fewest 128-byte passes
    its distinct bytes allow: 2 for the corpus (16 rows), 1 for the queries
    (2 rows)."""
    qg, rg = _f32_threads()
    query_box = 16 * qt * 128

    # the query tile's stores: thread t's units e = t + 256 k
    written = np.zeros(4 * query_box // 16, dtype=np.int64)
    for k in range(16 * qt * 32 // 256):
        e = np.arange(256) + 256 * k
        r, col = e // 32, e % 32
        at = (col // 8) * query_box + _sw128(r, (col % 8) * 16)
        np.add.at(written, at // 16, 1)
        for quarter in range(32):
            assert len(set(at[8 * quarter:8 * quarter + 8] // 16 % 8)) == 8
    assert (written == 1).all()

    for name, who, rows, n_rows in (("queries", qg, qt, 2), ("corpus", rg, 8, 16)):
        base = who * 128 + (who % 8) * 16                   # swizzled(row, 0)
        for u in range(8):
            for k in range(rows):
                at = ((base ^ (16 * u)) + 2048 * k).astype(np.int64)
                np.testing.assert_array_equal(at, _sw128(who + 16 * k, 16 * u))
                for w in range(8):                          # warps
                    lanes = at[32 * w:32 * w + 32]
                    for quarter in range(4):
                        q_at = np.unique(lanes[8 * quarter:8 * quarter + 8])
                        assert len(set(q_at // 16 % 8)) == len(q_at), (name, u, k)
                    uniq = np.unique(lanes)
                    worst = np.bincount(uniq // 16 % 8, minlength=8).max()
                    assert len(uniq) == n_rows and worst == -(-len(uniq) // 8), (name, u, k)


# --- the producer warpgroup's widening of an int8 chunk into the bf16 ring ---


def _sw128(row, byte):
    """TMA's 128-byte swizzle: byte `byte` of row `row` of a box of 128-byte
    rows, in a stage aligned to 1024 bytes; the 16-byte unit index is XORed
    with row % 8."""
    off = np.asarray(row) * 128 + np.asarray(byte)
    return off ^ (((off >> 7) & 7) << 4)


def _desc_sw128_byte(n, k):
    """The byte of a bf16 stage that wgmma reads for corpus row n, column k
    through desc_sw128(stage, ks = k / 16): the k-step starts at
    (ks / 4) HALF + (ks % 4) 32, 8-row groups lie 1024 bytes apart (its
    stride), rows of an 8-row atom 128 bytes apart, and the 128-byte swizzle
    XORs address bits 4-6 with bits 7-9."""
    ks = k // 16
    off = (ks % 4) * 32 + (k % 16) * 2 + (n % 8) * 128 + (n // 8) * 1024
    return (ks // 4) * HALF + (off ^ (((off >> 7) & 7) << 4))


def _bf16_value(bits):
    return (np.asarray(bits, dtype=np.uint32) << 16).view(np.float32)


def _widen_pair(w, sel: int):
    """widen_pair on uint32 words w: __byte_perm(w, 0x43434343, sel), then
    the bf16x2 difference of its two masks, rounded to nearest (each
    difference must be exact)."""
    w = np.asarray(w, dtype=np.uint64)
    src = [(w >> (8 * j)) & 0xFF for j in range(4)] + [np.full_like(w, 0x43)] * 4
    p = sum(src[(sel >> (4 * j)) & 7] << (8 * j) for j in range(4)).astype(np.uint32)
    a, b = p & np.uint32(0xFF7FFF7F), p & np.uint32(0xFF80FF80)
    halves = []
    for shift in (0, 16):
        d = _bf16_value((a >> shift) & 0xFFFF) - _bf16_value((b >> shift) & 0xFFFF)
        bits = d.view(np.uint32) >> 16
        assert np.array_equal(_bf16_value(bits), d), "a difference is not a bf16 value"
        halves.append(bits)
    return halves[0] | (halves[1] << 16)


def test_widen_pair_is_exact_for_every_byte():
    codes = np.arange(-128, 128, dtype=np.int8)
    words = np.ascontiguousarray(codes.reshape(-1, 4)).view(np.uint32)[:, 0]
    got = np.stack([_widen_pair(words, 0x4140), _widen_pair(words, 0x4342)], 1).reshape(-1)
    values = _bf16_value(np.stack([got & 0xFFFF, got >> 16], 1).reshape(-1))
    np.testing.assert_array_equal(values, codes.astype(np.float32))


def _widen_share(p: int):
    """widen_share(p): (src, dst_lo, dst_hi) bytes of pass 0, as the kernel
    computes them."""
    e = p % 8
    second = int(e >= 4)
    row = 2 * (p // 16) + second
    v = e % 4 + 4 * (second ^ ((p // 8) % 2))
    sw = row % 8
    base = (v // 4) * HALF + (row // 8) * 1024 + sw * 128
    return (row * 128 + (v ^ sw) * 16, base + ((2 * (v % 4)) ^ sw) * 16,
            base + ((2 * (v % 4) + 1) ^ sw) * 16)


def test_widened_chunk_lands_where_wgmma_reads_it():
    """The 128 producer threads' 8 passes over a raw int8 stage (laid out by
    TMA with the 128-byte swizzle) write every byte of the bf16 stage once,
    each code as the bf16 of its value at the byte desc_sw128 reads for its
    (row, column); that byte is also where TMA puts a bf16 chunk, K1's
    layout. Each quarter warp's load and its two stores of a pass hit 8
    distinct 16-byte bank groups."""
    rng = np.random.default_rng(6)
    codes = rng.integers(-128, 128, (CHUNK, 128)).astype(np.int8)
    n, k = np.meshgrid(np.arange(CHUNK), np.arange(128), indexing="ij")
    raw = np.zeros(CHUNK * 128, np.uint8)
    raw[_sw128(n, k)] = codes.view(np.uint8)
    wide = np.zeros(2 * HALF, np.uint8)
    writes = np.zeros(2 * HALF, np.int64)
    shares = [_widen_share(p) for p in range(128)]
    for i in range(8):
        for quarter in range(16):
            units = {"load": [], "lo": [], "hi": []}
            for p in range(8 * quarter, 8 * quarter + 8):
                src, lo, hi = (x + 2048 * i for x in shares[p])
                words = raw[src:src + 16].view(np.uint32)
                out = np.stack([_widen_pair(words, 0x4140), _widen_pair(words, 0x4342)], 1)
                out = out.reshape(-1).astype(np.uint32).view(np.uint8)
                for dst, part in ((lo, out[:16]), (hi, out[16:])):
                    wide[dst:dst + 16] = part
                    writes[dst:dst + 16] += 1
                units["load"].append(src // 16 % 8)
                units["lo"].append(lo // 16 % 8)
                units["hi"].append(hi // 16 % 8)
            for name, banks in units.items():
                assert len(set(banks)) == 8, f"pass {i} quarter {quarter}: {name} conflicts"
    assert (writes == 1).all()
    at = _desc_sw128_byte(n, k)
    # K1's layout: TMA's two boxes of 64 bf16 columns put (n, k) at that byte
    np.testing.assert_array_equal(at, (k // 64) * HALF + _sw128(n, (k % 64) * 2))
    got = _bf16_value(wide[at] | (wide[at + 1].astype(np.uint32) << 8))
    np.testing.assert_array_equal(got, codes.astype(np.float32))


@pytest.mark.parametrize("queries,corpus,block,group,grouped,scaled,want", [
    (torch.bfloat16, torch.bfloat16, 16, 128, True, False, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 256, 128, True, False, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 16, 8, True, False, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 16, 4, True, False, "simple"),    # 64-row groups
    (torch.bfloat16, torch.bfloat16, 48, 128, True, False, "simple"),  # not a power of 2
    (torch.float32, torch.float32, 256, 8, False, False, "simple"),    # f32 K8
    (torch.bfloat16, torch.int8, 16, 128, True, True, "wgmma"),        # K5 and K7
    (torch.bfloat16, torch.int8, 16, 128, True, False, "simple"),
    (torch.float32, torch.int8, 16, 128, True, False, "simple"),      # f32 over int8
    (torch.bfloat16, torch.int8, 128, 128, True, True, "wgmma"),       # the capacity point
    (torch.bfloat16, torch.int8, 256, 8, True, True, "wgmma"),
    (torch.float32, torch.int8, 16, 128, True, True, "simple"),        # f32 queries
    (torch.bfloat16, torch.int8, 48, 128, True, True, "simple"),       # not in WGMMA_BLOCKS
    (torch.bfloat16, torch.int8, 16, 4, True, True, "simple"),         # 64-row groups
    (torch.bfloat16, torch.int8, 256, 8, False, True, "simple"),       # block-major
    (torch.bfloat16, torch.bfloat16, 16, 128, True, True, "simple"),   # scaled bf16 corpus
    (torch.bfloat16, torch.bfloat16, 256, 8, False, False, "wgmma"),   # K8, block-major
    (torch.bfloat16, torch.bfloat16, 16, 8, False, False, "wgmma"),    # K8 at tile_n 128
    (torch.bfloat16, torch.bfloat16, 16, 4, False, False, "simple"),   # K8 at tile_n 64
    (torch.bfloat16, torch.bfloat16, 48, 8, False, False, "simple"),   # K8, odd block
    (torch.float32, torch.float32, 16, 128, True, False, "f32"),       # K1 over f32
    (torch.float32, torch.float32, 256, 8, True, False, "f32"),
    (torch.float32, torch.float32, 16, 4, True, False, "simple"),      # 64-row groups
    (torch.float32, torch.float32, 48, 128, True, False, "simple"),    # not in WGMMA_BLOCKS
    (torch.float32, torch.float32, 16, 128, True, True, "simple"),     # scaled f32 corpus
])
def test_kernel_choice_is_a_function_of_dtypes_and_shapes(queries, corpus, block, group, grouped,
                                                          scaled, want):
    assert mips_kernel.kernel_for(queries, corpus, block=block, group=group, grouped=grouped,
                                  scaled=scaled) == want
