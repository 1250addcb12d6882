"""Port parity for the int8 index: the quantizer, the scaled and bounded
block maxima (kernels K5 and K7), the pipelines around them, the v1 pipeline
(K8), mips_topk's int8 dispatch and DenseIndex(dtype="int8"), against the
JAX package on the same numpy inputs (Pallas in interpret mode)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from proqa_tpu.index.dense import DenseIndex as JaxDenseIndex  # noqa: E402
from proqa_tpu.index.idmap import IdMap as JaxIdMap  # noqa: E402
from proqa_tpu.ops import mips as jax_mips  # noqa: E402
from proqa_tpu.ops import pallas_mips  # noqa: E402
from proqa_tpu.ops import quant as jax_quant  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.index.idmap import IdMap  # noqa: E402
from proqa_tpu_torch.ops import mips, mips_kernel, quant  # noqa: E402
from proqa_tpu_torch.testing import topk_disagreements  # noqa: E402

# f32 scores of unit-scale rows times scales of ~0.02: summation order moves
# them by ~1e-6
ATOL = 1e-4
# the per-row test's rows reach norms of 10 against unnormalised queries:
# scores of ~350, where f32 sums in another order differ by ~1e-4
ROW_ATOL = 2e-3


def _emb(n, d=128, seed=0, lo=0.5, hi=2.0):
    """Rows of varied norm, so the blocks get different scales."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * rng.uniform(lo, hi, (n, 1))).astype(np.float32)


def _queries(q, d=128, seed=1):
    return np.random.default_rng(seed).standard_normal((q, d)).astype(np.float32)


def _recall(got, want):
    return np.mean([len(set(g) & set(w)) / len(w) for g, w in zip(got, want)])


@pytest.mark.parametrize("block", [1, 16, 128])
def test_quantize_rows_byte_equal_to_jax(block):
    emb = _emb(5003, seed=block)  # ragged: the last block is partial
    emb[32:48] = 0.0              # an all-zero block gets scale 1
    got_q, got_s = quant.quantize_rows(emb, block=block, chunk=1 << 11)
    want_q, want_s = jax_quant.quantize_rows(emb, block=block, chunk=1 << 11)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    assert got_q.tobytes() == want_q.tobytes() and got_s.tobytes() == want_s.tobytes()
    np.testing.assert_array_equal(quant.dequantize_rows(got_q, got_s, block),
                                  jax_quant.dequantize_rows(want_q, want_s, block))
    want_rows = np.asarray(jax_quant.expand_scales(jnp.asarray(want_s), block, 5003))
    np.testing.assert_array_equal(quant.expand_scales(torch.from_numpy(got_s), block, 5003)
                                  .numpy(), want_rows)
    np.testing.assert_array_equal(quant.expand_scales(got_s, block, 5003), want_rows)


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["scales", "scale_bounds"])
def test_block_maxima_grouped_int8_matches_jax(kind, qdtype):
    """K5 (per-block scales) and K7 (per-row scale bounds) at the shapes of
    tests/test_pallas_mips.py, against the Pallas kernels in interpret mode."""
    n, q, block, group = 1024, 16, 8, 16
    emb, queries = _emb(n, seed=41, lo=0.25, hi=4.0), _queries(q, seed=2)
    jq = jnp.asarray(queries, getattr(jnp, qdtype))
    tq = torch.from_numpy(queries).to(getattr(torch, qdtype))
    if kind == "scales":
        q8, sc = quant.quantize_rows(emb, block=block)
        jkw = {"scales": jnp.asarray(sc)}
        tkw = {"scales": torch.from_numpy(sc)}
    else:
        q8, rs = quant.quantize_rows(emb, block=1)
        smax, smin = rs.reshape(-1, block).max(1), rs.reshape(-1, block).min(1)
        jkw = {"scale_bounds": (jnp.asarray(smax), jnp.asarray(smin))}
        tkw = {"scale_bounds": (torch.from_numpy(smax), torch.from_numpy(smin))}
    want = pallas_mips.block_maxima_grouped(jq, jnp.asarray(q8), block=block, group=group,
                                            tile_q=16, sub_chunks=2, interpret=True, **jkw)
    got = mips_kernel.block_maxima_grouped(tq, torch.from_numpy(q8), block=block, group=group,
                                           **tkw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    if kind == "scale_bounds":  # the bounds dominate the true row-scaled maxima
        raw = tq.float().numpy() @ q8.astype(np.float32).T
        true_max = (raw * rs[None, :]).reshape(q, -1, block).max(-1)       # [Q, NB]
        bounds = got[0].numpy().transpose(1, 0, 2).reshape(q, -1)
        assert (bounds >= true_max - 1e-3).all()


def test_mips_topk_v2_scales_matches_jax():
    """K5's pipeline at a ragged N (padding and a straddling block): the
    top-k of the dequantized corpus, as the JAX pipeline finds it."""
    n, q, k, block = 5003, 32, 9, 16
    q8, sc = quant.quantize_rows(_emb(n, seed=40), block=block)
    queries = _queries(q, seed=3)
    rv, ri = map(np.asarray, jax_mips.mips_topk_reference(
        jnp.asarray(queries), jnp.asarray(quant.dequantize_rows(q8, sc, block)), k))
    pv, pi = map(np.asarray, pallas_mips.mips_topk_pallas_v2(
        jnp.asarray(queries), jnp.asarray(q8), k, block=block, group=8, tile_q=32,
        sub_chunks=2, scales=jnp.asarray(sc), interpret=True))
    gv, gi = mips_kernel.mips_topk_v2(torch.from_numpy(queries), torch.from_numpy(q8), k,
                                      block=block, group=8, scales=torch.from_numpy(sc))
    gv, gi = gv.numpy(), gi.numpy()
    assert gi.max() < n
    assert topk_disagreements(gv, gi, pv, pi, atol=ATOL) == 0
    assert topk_disagreements(gv, gi, rv, ri, atol=ATOL) == 0


def test_mips_topk_v2_row_scales_matches_jax():
    """K7's pipeline: every returned value is the exact row-scaled score of
    its row; at kb = 16k the top-k is found; at kb = k the bound's selection
    loses recall in the port as it does in JAX (the heuristic is kept, not
    repaired)."""
    n, q, k, block = 5003, 32, 9, 16
    q8, rs = quant.quantize_rows(_emb(n, seed=43, lo=0.1, hi=10.0), block=1)
    queries = _queries(q, seed=4)
    jq, jc, jrs = jnp.asarray(queries), jnp.asarray(q8), jnp.asarray(rs)
    tq, tc, trs = torch.from_numpy(queries), torch.from_numpy(q8), torch.from_numpy(rs)
    _, want_i = map(np.asarray, jax_mips.mips_topk_reference(
        jq, jnp.asarray(q8, jnp.float32), k, scales=jrs))
    raw = queries @ q8.astype(np.float32).T
    recalls = {}
    for kb in (16 * k, None):
        pv, pi = map(np.asarray, pallas_mips.mips_topk_pallas_v2(
            jq, jc, k, block=block, group=8, tile_q=32, sub_chunks=2, row_scales=jrs, kb=kb,
            interpret=True))
        gv, gi = mips_kernel.mips_topk_v2(tq, tc, k, block=block, group=8, row_scales=trs, kb=kb)
        gv, gi = gv.numpy(), gi.numpy()
        np.testing.assert_allclose(gv, np.take_along_axis(raw * rs[None, :], gi, axis=1),
                                   atol=ROW_ATOL, rtol=0)
        assert topk_disagreements(gv, gi, pv, pi, atol=ROW_ATOL) == 0
        recalls[kb] = (_recall(gi, want_i), _recall(pi, want_i))
    assert recalls[16 * k] == (1.0, 1.0)
    assert recalls[None][0] == recalls[None][1] < 0.9, recalls


@pytest.mark.parametrize("n_valid,negative", [(None, False), (5003, True)])
def test_mips_topk_v1_matches_jax(n_valid, negative):
    """The v1 pipeline around K8 (block 256, kb 128, tile_n 2048)."""
    rng = np.random.default_rng(7)
    queries = rng.standard_normal((256, 128)).astype(np.float32) / np.sqrt(128)
    corpus = rng.standard_normal((6144, 128)).astype(np.float32) / np.sqrt(128)
    if negative:  # every real score < 0: an unmasked zero padding row would win
        queries, corpus = np.abs(queries), -np.abs(corpus)
    corpus = corpus[:n_valid]
    jq, jc = jnp.asarray(queries), jnp.asarray(corpus)
    pv, pi = map(np.asarray, pallas_mips.mips_topk_pallas(jq, jc, 80, n_valid=n_valid,
                                                          interpret=True))
    rv, ri = map(np.asarray, jax_mips.mips_topk_reference(jq, jc, 80))
    want_bmax = np.asarray(pallas_mips.block_maxima(
        jq, jnp.pad(jc, ((0, (-len(corpus)) % 2048), (0, 0))), interpret=True))
    tq, tc = torch.from_numpy(queries), torch.from_numpy(corpus)
    got_bmax = mips_kernel.block_maxima(tq, mips.pad_rows(tc, 2048))
    assert got_bmax.shape == want_bmax.shape == (24, 256)
    np.testing.assert_allclose(got_bmax.numpy(), want_bmax, atol=ATOL, rtol=0)
    gv, gi = mips_kernel.mips_topk_v1(tq, tc, 80, n_valid=n_valid)
    gv, gi = gv.numpy(), gi.numpy()
    assert gi.max() < len(corpus)
    assert topk_disagreements(gv, gi, pv, pi, atol=ATOL) == 0
    assert topk_disagreements(gv, gi, rv, ri, atol=ATOL) == 0


@pytest.fixture
def v2_calls(monkeypatch):
    """Records the (query count, block) of every mips_topk_v2 call."""
    calls = []
    real = mips_kernel.mips_topk_v2

    def spy(queries, corpus, k, **kw):
        calls.append((queries.shape[0], kw["block"], kw.get("scales") is not None))
        return real(queries, corpus, k, **kw)

    monkeypatch.setattr(mips_kernel, "mips_topk_v2", spy)
    return calls


@pytest.mark.parametrize("q,quant_block,want_calls", [
    (256, 16, [(256, 16, True)]),                     # the K5 branch
    (256, 32, [(256, 32, True)]),                     # a coarser block is memory-safe
    (2100, 16, [(2048, 16, True), (52, 16, True)]),   # chunks of 2,048 queries
    (256, 8, []),                                     # finer than 16: row-scored path
    (256, 1, []),                                     # per-row scales
])
def test_mips_topk_int8_dispatch_matches_jax(q, quant_block, want_calls, v2_calls):
    """mips_topk(scales=, quant_block=) takes the kernel branch exactly when
    the JAX dispatch does, and returns the JAX results (JAX off the TPU runs
    its row-scored block-max path, the exact reference of the same scores)."""
    n, k, n_valid = 8192, 40, 8100
    q8, sc = quant.quantize_rows(_emb(n, seed=quant_block), block=quant_block)
    queries = _queries(q, seed=q).astype(np.float32)
    jv, ji = map(np.asarray, jax_mips.mips_topk(
        jnp.asarray(queries, jnp.bfloat16), jnp.asarray(q8), k, n_valid=n_valid,
        scales=jnp.asarray(sc), quant_block=quant_block))
    gv, gi = mips.mips_topk(torch.from_numpy(queries).bfloat16(), torch.from_numpy(q8), k,
                            n_valid=n_valid, scales=torch.from_numpy(sc),
                            quant_block=quant_block)
    assert v2_calls == want_calls
    assert gv.shape == gi.shape == (q, k) and gi.max().item() < n_valid
    assert topk_disagreements(gv.numpy(), gi.numpy(), jv, ji, atol=ATOL) == 0


def test_row_scored_paths_with_scales_match_jax():
    """The row-scored paths an int8 corpus can reach besides the kernel's:
    the streaming path (exact=False) and the block-max path, with per-row
    scales expanded from per-block ones."""
    n, q, k, qb = 6000, 64, 40, 16
    q8, sc = quant.quantize_rows(_emb(n, seed=12), block=qb)
    queries = _queries(q, seed=13)
    rows = quant.expand_scales(sc, qb, n)
    rv, ri = map(np.asarray, jax_mips.mips_topk_reference(
        jnp.asarray(queries), jnp.asarray(q8, jnp.float32), k, n_valid=5990,
        scales=jnp.asarray(rows)))
    tq, tc = torch.from_numpy(queries), torch.from_numpy(q8)
    for gv, gi in (mips.mips_topk(tq, tc, k, exact=False, n_valid=5990,
                                  scales=torch.from_numpy(sc), quant_block=qb),
                   mips.mips_topk_chunked_approx(tq, tc, k, chunk=1024, n_valid=5990,
                                                 scales=torch.from_numpy(rows)),
                   mips.mips_topk_blockmax(tq, tc, k, block=64, q_chunk=32, n_valid=5990,
                                           scales=torch.from_numpy(rows))):
        assert topk_disagreements(gv.numpy(), gi.numpy(), rv, ri, atol=ATOL) == 0


@pytest.mark.parametrize("n", [5003, 300])
def test_dense_index_int8_matches_jax(tmp_path, n):
    """The same quant block, codes and scales as JAX, the same search up to
    ties (n > 4096 reaches the K5 pipeline, n = 300 the naive path), `take`,
    and save/load round trips read by both packages."""
    emb, queries = _emb(n, seed=n), _queries(40, seed=5)
    ids = [f"p{i}" for i in range(n)]
    jidx = JaxDenseIndex.from_embeddings(emb, JaxIdMap(ids), dtype="int8")
    tidx = DenseIndex.from_embeddings(emb, IdMap(ids), device="cpu", dtype="int8")
    assert tidx.is_quantized and tidx.embeddings.dtype == torch.int8
    assert tidx.quant_block == jidx.quant_block == 16 and tidx.n == n
    assert tidx._query_dtype == torch.bfloat16
    np.testing.assert_array_equal(tidx.embeddings.numpy(), np.asarray(jidx.embeddings))
    assert tidx.scales.numpy().tobytes() == np.asarray(jidx.scales).tobytes()
    jv, ji, jids = jidx.search_ids(queries, 20)
    tv, ti, tids = tidx.search_ids(queries, 20)
    assert tv.dtype == np.float32 and ti.dtype == np.int32
    assert topk_disagreements(tv, ti, jv, ji, atol=ATOL) == 0
    assert [t[0] for t in tids] == [j[0] for j in jids]
    rows = np.array([0, 7, n - 1, -1])
    np.testing.assert_allclose(tidx.take(rows), jidx.take(rows), atol=1e-6, rtol=1e-6)
    # the port's artifact is the dequantized f32 matrix; both packages
    # quantize it again to the same codes
    tidx.save(str(tmp_path / "t"))
    saved = np.load(tmp_path / "t" / "embeddings.npy")
    np.testing.assert_allclose(saved, jidx.take(np.arange(n)), atol=1e-6, rtol=1e-6)
    for back in (DenseIndex.load(str(tmp_path / "t"), device="cpu", dtype="int8"),
                 JaxDenseIndex.load(str(tmp_path / "t"), dtype="int8")):
        np.testing.assert_array_equal(np.asarray(back.embeddings[: back.n]),
                                      tidx.embeddings[:n].numpy())
        np.testing.assert_allclose(np.asarray(back.scales), tidx.scales.numpy(), rtol=1e-6)
    jidx.save(str(tmp_path / "j"))
    again = DenseIndex.load(str(tmp_path / "j"), device="cpu", dtype=torch.int8)
    np.testing.assert_array_equal(again.embeddings.numpy(), tidx.embeddings.numpy())


def test_dense_index_int8_from_tensor_and_f32_take():
    """A tensor corpus quantizes as its numpy copy does; take on a float
    index returns the stored rows (clipped indices)."""
    emb = _emb(2000, seed=9)
    a = DenseIndex.from_embeddings(torch.from_numpy(emb), device="cpu", dtype=torch.int8)
    b = DenseIndex.from_embeddings(emb, device="cpu", dtype="int8")
    assert torch.equal(a.embeddings, b.embeddings) and torch.equal(a.scales, b.scales)
    f = DenseIndex.from_embeddings(emb, device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(f.take(np.array([3, -1, 5000])),     # 5000: a padding row
                                  np.stack([emb[3], emb[0], np.zeros(128, np.float32)]))
