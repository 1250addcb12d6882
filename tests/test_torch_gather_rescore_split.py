"""The work split of csrc/gather_rescore.cu (K6/K9 on Hopper), mirrored in
Python thread by thread and held to the function it computes,

    out[q, j * block + b] = corpus[ids[q, j] * block + b] . queries[q].

The kernel's index arithmetic cannot run on a CPU as CUDA, so this file
repeats it step for step, for its two forms: gather_score_ring_kernel (D =
128: 8 stages of 16 KB of rows) and gather_score_wide_kernel (every other
width: 4 stages of 48 KB, as many whole rows as fit beside the query's, at
most 64):
  - work items: item `it` is query it // per_q's run of at most 32
    candidate blocks (`work_item`), items dealt to the persistent grid's
    CTAs in turn;
  - the producer warp: tile n of a CTA goes to ring stage n % stages after a
    wait on the stage's empty barrier; lane p copies the piece of candidate
    block b0 + p by one bulk copy, lane 0 the query row after the stage's
    rows;
  - the consumer warps: warp w takes the tiles n with n % 4 == w, waits on
    the full barrier at parity (n // stages) & 1, and its lanes store the
    scores of the stage rows `store_rows` names after the exchange of halves.
A simulation runs the producer as far ahead as its waits allow and each
consumer warp as far as its waits allow, with each mbarrier modelled by its
count of completed phases (a wait on parity P passes once the count's
parity is not P). The copies a round of the producer issued land one stage
at a time, the latest first, and the consumer warps try their waits before
any has landed and after each: the hardware does not order the bulk copies
of different stages. It checks that every wait passes at the phase that was
filled for it, that every piece is a legal bulk copy, that every row a lane
stores came from the corpus row the function names, and that every output
element is written exactly once. At the largest shapes the simulation
covers four CTAs' first 256 tiles, and every query's candidate blocks are
shown to be covered once by its items and every item by one CTA. The GPU
tests hold the kernel itself to its plain version (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

RUN_BLOCKS, CONSUMERS, STAGES, TILE_BYTES, DIM = 32, 4, 8, 16384, 128
# gather_score_wide_kernel: kWideStages, kWideStageBytes, kWideMaxRows
WIDE_STAGES, WIDE_STAGE_BYTES, WIDE_MAX_ROWS = 4, 49152, 64
SMS = 132            # the H100 SXM's multiprocessors: one CTA fits on each
FULL_SIM_TILES = 40_000  # above this many tiles a case simulates four CTAs' prefixes
PREFIX_TILES = 256


class Tile:
    """csrc/gather_rescore.cu's Tile<T> for elements of `elt` bytes (D = 128)."""

    stages = STAGES

    def __init__(self, elt: int):
        self.row_bytes = DIM * elt
        self.rows = TILE_BYTES // self.row_bytes
        self.query_at = TILE_BYTES          # the query's row follows the stage's rows
        self.stage_bytes = TILE_BYTES + self.row_bytes
        self.vec = 16 // elt
        self.lanes = DIM // self.vec
        self.rows_per_load = 32 // self.lanes
        self.steps = self.rows // 32

    def store_rows(self) -> np.ndarray:
        return store_rows(self)


class WideTile:
    """gather_score_wide_kernel's stage at width `dim` for elements of `elt`
    bytes: launch_wide's rows_per_stage rows, then the query's row."""

    def __init__(self, dim: int, elt: int, stages: int = WIDE_STAGES):
        self.stages = stages
        self.row_bytes = dim * elt
        assert self.row_bytes <= WIDE_STAGE_BYTES // 3   # kWideMaxRowBytes
        self.rows = min(WIDE_MAX_ROWS, (WIDE_STAGE_BYTES - self.row_bytes) // self.row_bytes)
        self.query_at = self.rows * self.row_bytes
        self.stage_bytes = WIDE_STAGE_BYTES
        self.vecs = self.row_bytes // 16    # 16-byte vectors a row
        self.vec = 16 // elt

    def store_rows(self) -> np.ndarray:
        """[WIDE_MAX_ROWS // 32, 32]: lane l stores row 32 g + l (those below
        the tile's row count)."""
        return np.arange(WIDE_MAX_ROWS).reshape(-1, 32)


TILES = {"bfloat16": Tile(2), "float32": Tile(4)}


def work_item(it, kb: int, per_q: int):
    """(q, first, nblk) of work item `it` (numpy arrays or ints)."""
    q = it // per_q
    i = it - q * per_q
    base = kb // per_q
    extra = kb - base * per_q
    return q, i * base + np.minimum(i, extra), base + np.where(i < extra, 1, 0)


def per_query(kb: int) -> int:
    return (kb + RUN_BLOCKS - 1) // RUN_BLOCKS


def grid_size(num_q: int, kb: int) -> int:
    return min(num_q * per_query(kb), SMS)


def producer_tiles(cta, grid, num_q, kb, block, ids, g):
    """The producer warp's tiles, in order: stage, empty-barrier parity,
    the bytes it announces and each bulk copy (destination byte in the
    stage, source: corpus row or the query, bytes)."""
    per_q = per_query(kb)
    n = 0
    for it in range(cta, num_q * per_q, grid):
        q, first, nblk = (int(x) for x in work_item(it, kb, per_q))
        id_lane = [int(ids[q, first + lane]) if lane < nblk else 0 for lane in range(32)]
        rows = nblk * block
        for r0 in range(0, rows, g.rows):
            nrows = min(g.rows, rows - r0)
            b0 = r0 // block
            pieces = (r0 + nrows - 1) // block - b0 + 1
            cand = [id_lane[min(b0 + lane, RUN_BLOCKS - 1)] for lane in range(32)]  # the shuffle
            copies = [(g.query_at, ("query", q), g.row_bytes)]
            for lane in range(32):
                if lane < pieces:
                    b = b0 + lane
                    lo, hi = max(r0, b * block), min(r0 + nrows, (b + 1) * block)
                    copies.append(((lo - r0) * g.row_bytes, cand[lane] * block + (lo - b * block),
                                   (hi - lo) * g.row_bytes))
            yield {"n": n, "stage": n % g.stages, "parity": ((n // g.stages) & 1) ^ 1,
                   "tx": (nrows + 1) * g.row_bytes, "copies": copies, "pieces": pieces}
            n += 1


def consumer_tiles(cta, grid, warp, num_q, kb, block, g):
    """Consumer warp `warp`'s tiles, in order: stage, full-barrier parity,
    query, the output offset of the tile's first row and its row count."""
    per_q = per_query(kb)
    n = 0
    for it in range(cta, num_q * per_q, grid):
        q, first, nblk = (int(x) for x in work_item(it, kb, per_q))
        rows = nblk * block
        base = (q * kb + first) * block
        for r0 in range(0, rows, g.rows):
            if n % CONSUMERS == warp:
                yield {"n": n, "stage": n % g.stages, "parity": (n // g.stages) & 1, "q": q,
                       "out": base + r0, "nrows": min(g.rows, rows - r0)}
            n += 1


def load_rows(g) -> np.ndarray:
    """[steps, loads, 32]: the stage row each lane reads at each load."""
    lane = np.arange(32)
    return np.array([[s * 32 + k * g.rows_per_load + lane // g.lanes for k in range(g.lanes)]
                     for s in range(g.steps)])


def store_rows(g) -> np.ndarray:
    """[steps, 32]: the stage row whose score each lane stores."""
    lane = np.arange(32)
    return np.array([s * 32 + (lane % g.lanes) * g.rows_per_load + lane // g.lanes
                     for s in range(g.steps)])


def sum_rows(p: np.ndarray, bit: int) -> np.ndarray:
    """The kernel's sum_rows<bit> over the warp: p [32 lanes, 2 * bit]."""
    lane = np.arange(32)
    upper = ((lane & bit) != 0)[:, None]
    send = np.where(upper, p[:, :bit], p[:, bit:2 * bit])
    keep = np.where(upper, p[:, bit:2 * bit], p[:, :bit])
    p = keep + send[lane ^ bit]
    return p[:, 0] if bit == 1 else sum_rows(p, bit // 2)


def simulate(cta, grid, num_q, kb, block, ids, g, max_tiles=None) -> list[np.ndarray]:
    """Runs one CTA's producer and consumer warps against modelled mbarriers
    (up to tile max_tiles); returns the output elements each consumed tile
    stored."""
    flat_ids = ids.reshape(-1)
    lane_rows = g.store_rows().reshape(-1)
    assert g.query_at + g.row_bytes <= g.stage_bytes
    stages = g.stages
    prod = producer_tiles(cta, grid, num_q, kb, block, ids, g)
    cons = [consumer_tiles(cta, grid, w, num_q, kb, block, g) for w in range(CONSUMERS)]

    def bounded(gen):
        t = next(gen, None)
        return None if t is None or (max_tiles is not None and t["n"] >= max_tiles) else t

    full, empty = [0] * stages, [0] * stages      # completed phases of each barrier
    held = [None] * stages                         # (tile n, query, source row of each row)
    p_next, c_next = bounded(prod), [bounded(c) for c in cons]
    stored = []

    def consume() -> bool:
        """Each consumer warp as far as its waits allow."""
        moved = False
        for w in range(CONSUMERS):
            while (t := c_next[w]) is not None:
                s = t["stage"]
                if full[s] % 2 == t["parity"]:
                    break  # not filled yet
                assert full[s] == t["n"] // stages + 1, "a wait passed at another fill's phase"
                n, query, src = held[s]
                assert n == t["n"] and query == t["q"]
                rows = lane_rows[lane_rows < t["nrows"]]
                out = t["out"] + rows
                want = flat_ids[out // block] * block + out % block
                np.testing.assert_array_equal(src[rows], want)
                stored.append(out)
                held[s] = None
                empty[s] += 1
                c_next[w] = bounded(cons[w])
                moved = True
        return moved

    while p_next is not None or any(t is not None for t in c_next):
        issued = []
        while p_next is not None:
            t = p_next
            s = t["stage"]
            if empty[s] % 2 == t["parity"]:
                break  # the stage's previous tile is still being read
            assert empty[s] == t["n"] // stages, "the producer passed a later release"
            assert held[s] is None
            assert 1 <= t["pieces"] <= RUN_BLOCKS
            src = np.full(g.rows, -1, dtype=np.int64)
            query = None
            total = 0
            for dst, source, nbytes in t["copies"]:
                assert nbytes > 0 and nbytes % 16 == 0 and dst % 16 == 0
                total += nbytes
                if isinstance(source, tuple):
                    assert dst == g.query_at and nbytes == g.row_bytes
                    query = source[1]
                    continue
                assert dst + nbytes <= g.query_at and dst % g.row_bytes == 0
                r, cnt = dst // g.row_bytes, nbytes // g.row_bytes
                assert (src[r:r + cnt] == -1).all(), "two copies into one row"
                src[r:r + cnt] = source + np.arange(cnt)
            assert total == t["tx"], "the announced bytes differ from the copies'"
            held[s] = (t["n"], query, src)
            issued.append(s)
            p_next = bounded(prod)
        progress = bool(issued)
        progress |= consume()  # the copies still in flight
        for s in reversed(issued):  # they land, the latest first
            full[s] += 1
            progress |= consume()
        assert progress, "the ring deadlocked"
    return stored


def check_split(q, kb, block, ids, g) -> None:
    """Every score written once (the whole grid simulated), or no element
    written twice (four CTAs' first tiles) where the tiles are many."""
    per_q = per_query(kb)
    grid = grid_size(q, kb)
    _, _, nblk = work_item(np.arange(per_q), kb, per_q)
    tiles = q * sum(-(-int(b) * block // g.rows) for b in nblk)
    if tiles <= FULL_SIM_TILES:
        stored = [o for c in range(grid) for o in simulate(c, grid, q, kb, block, ids, g)]
        assert len(stored) == tiles
        written = np.bincount(np.concatenate(stored), minlength=q * kb * block)
        assert written.size == q * kb * block and (written == 1).all()
    else:
        stored = np.concatenate([o for c in sorted({0, 1, 2, grid - 1}) for o in simulate(
            c, grid, q, kb, block, ids, g, max_tiles=PREFIX_TILES)])
        assert np.unique(stored).size == stored.size, "an element written twice"


def split_ids(block, kb, q, seed):
    rng = np.random.default_rng(seed)
    nb = max(2 * kb, 64)
    ids = rng.integers(0, nb, (q, kb))
    ids[:, 0] = nb - 1
    return ids


@pytest.mark.parametrize("q", [1, 3, 2048])
@pytest.mark.parametrize("kb", [1, 7, 80, 1280])
@pytest.mark.parametrize("block", [16, 32, 64, 128, 256])
def test_work_split_writes_every_score_once(block, kb, q):
    ids = split_ids(block, kb, q, seed=block * 7 + kb + q)
    per_q = per_query(kb)
    grid = grid_size(q, kb)

    # every query's candidate blocks covered once by its items, every item
    # by one CTA
    its = np.arange(q * per_q)
    iq, first, nblk = work_item(its, kb, per_q)
    assert ((nblk >= 1) & (nblk <= RUN_BLOCKS)).all() and nblk.max() - nblk.min() <= 1
    starts = first.reshape(q, per_q)
    ends = starts + nblk.reshape(q, per_q)
    assert (iq.reshape(q, per_q) == np.arange(q)[:, None]).all()
    assert (starts[:, 0] == 0).all() and (ends[:, -1] == kb).all()
    assert (starts[:, 1:] == ends[:, :-1]).all()
    owners = np.concatenate([np.arange(c, q * per_q, grid) for c in range(grid)])
    np.testing.assert_array_equal(np.sort(owners), its)

    for g in TILES.values():
        check_split(q, kb, block, ids, g)


@pytest.mark.parametrize("q", [3, 2048])
@pytest.mark.parametrize("kb", [7, 80])
@pytest.mark.parametrize("block", [16, 64])
@pytest.mark.parametrize("d", [16, 96, 768, 4096])
def test_wide_work_split_writes_every_score_once(d, block, kb, q):
    """gather_score_wide_kernel's slots, phases and rows_per_stage: at D =
    16 a stage holds 64 rows, at 4,096 in f32 (a 16 KB row) two."""
    ids = split_ids(block, kb, q, seed=d + block * 7 + kb + q)
    for elt in (2, 4):
        check_split(q, kb, block, ids, WideTile(d, elt))


@pytest.mark.parametrize("stages", [4, 6, 8])
def test_a_stage_two_warps_read_passes_a_stale_phase(stages):
    """Why the kernel asserts kWideStages % kConsumers == 0: with 6 stages
    tile n and tile n + 6 share a stage but not a warp, and the warp of
    n + 6 passes its wait while tile n's copies are in flight."""
    ids = split_ids(64, 80, 3, seed=1)
    g = WideTile(768, 2, stages=stages)
    if stages % CONSUMERS == 0:
        check_split(3, 80, 64, ids, g)
    else:
        with pytest.raises(AssertionError, match="another fill's phase"):
            check_split(3, 80, 64, ids, g)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lanes_hold_the_sums_of_their_rows(dtype):
    """A consumer warp's loads, partial sums and exchange of halves: each lane
    ends with the whole f32 dot product of the row it stores."""
    g = TILES[dtype]
    rng = np.random.default_rng(5)
    stage = rng.standard_normal((g.rows, DIM)).astype(np.float32)
    query = rng.standard_normal(DIM).astype(np.float32)
    lane = np.arange(32)
    cols = (lane % g.lanes)[:, None] * g.vec + np.arange(g.vec)        # [32, vec]
    loads, stores = load_rows(g), store_rows(g)
    for s in range(g.steps):
        # p[l, k]: lane l's partial sum of the row it reads at load k
        p = np.stack([(np.take_along_axis(stage[loads[s, k]], cols, 1) * query[cols]).sum(1)
                      for k in range(g.lanes)], axis=1)
        got = sum_rows(p, g.lanes // 2)
        np.testing.assert_allclose(got, stage[stores[s]] @ query, rtol=1e-5, atol=1e-5)
        # the 32 lanes store 32 distinct, consecutive rows of the step
        np.testing.assert_array_equal(np.sort(stores[s]), s * 32 + np.arange(32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [16, 96, 768, 4096])
def test_wide_lanes_hold_the_sums_of_their_rows(d, dtype):
    """gather_score_wide_kernel's sums: lane l adds the products of its
    16-byte vectors l, l + 32, ... of each row in order, and the exchange of
    halves over 32 rows (sum_rows<16>) leaves lane l the sum of row 32 g + l."""
    g = WideTile(d, 2 if dtype == "bfloat16" else 4)
    rng = np.random.default_rng(d)
    stage = rng.standard_normal((g.rows, d)).astype(np.float32)
    query = rng.standard_normal(d).astype(np.float32)
    vectors = stage.reshape(g.rows, g.vecs, g.vec) * query.reshape(g.vecs, g.vec)
    for rows in g.store_rows():
        p = np.zeros((32, 32), dtype=np.float32)  # p[l, k]: lane l's sum of row rows[k]
        for k, row in enumerate(rows):
            if row < g.rows:
                for v in range(g.vecs):
                    p[v % 32, k] += vectors[row, v].sum()
        got = sum_rows(p, 16)
        valid = rows < g.rows
        np.testing.assert_allclose(got[valid], stage[rows[valid]] @ query, rtol=1e-4, atol=1e-4)
