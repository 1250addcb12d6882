"""Live index updates in the port against the JAX package: add (in place,
power-of-two write buckets, 1.5x growth, int8 straddled-block
requantization), tombstones (over-fetch and host filter), compact and save.

Twins of tests/test_index_updates.py and of
tests/test_int8_index.py::test_int8_add_remove_exact_over_own_codes: each
runs one add/remove/compact sequence on the JAX index and on the port's,
built from the same seeded numpy rows in f32 on the CPU, and holds the
port's buffer, scales, n, version, tombstones and search results to the
JAX index's, and the results to a rebuilt index's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from proqa_tpu.index import DenseIndex as JaxDenseIndex, IdMap as JaxIdMap  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.index.idmap import IdMap  # noqa: E402
from proqa_tpu_torch.ops import quant  # noqa: E402

# f32 scores of 8-128-wide rows, the two packages' products summing in
# other orders: ~1e-7 relative; buffers and codes are copies, held exactly
ATOL = 1e-5


def _rows(n, d=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _pair(n, d=8, seed=0, ids=False, dtype="float32", **kw):
    """The same rows as a JAX index and a port index: (rows, jax, port)."""
    emb = _rows(n, d, seed)
    names = [f"doc{i}" for i in range(n)]
    jdt, tdt = (("int8", "int8") if dtype == "int8" else (jnp.float32, torch.float32))
    j = JaxDenseIndex.from_embeddings(emb, JaxIdMap(list(names)) if ids else None,
                                      dtype=jdt, **kw)
    t = DenseIndex.from_embeddings(emb, IdMap(list(names)) if ids else None, device="cpu",
                                   dtype=tdt, **kw)
    return emb, j, t


def _q(nq=4, d=8, seed=9):
    return _rows(nq, d, seed)


def _assert_state_equal(j, t):
    """Buffer (capacity included), scales, n, version and tombstones."""
    np.testing.assert_array_equal(t.embeddings.numpy(), np.asarray(j.embeddings))
    assert t.n == j.n and t.version == j.version and len(t) == len(j)
    assert t.n_deleted == j.n_deleted
    if j._deleted is not None:
        np.testing.assert_array_equal(t._deleted, j._deleted)
    assert (t.scales is None) == (j.scales is None) and t.quant_block == j.quant_block
    if j.scales is not None:
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    if j.id_map is not None:
        assert t.id_map.rows_to_ids(range(t.n)) == j.id_map.rows_to_ids(range(j.n))


def _assert_search_equal(j, t, q, k):
    jv, ji = j.search(q, k)
    tv, ti = t.search(q, k)
    assert tv.dtype == np.float32 and ti.dtype == np.int32 and tv.shape == (len(q), k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=ATOL)
    return tv, ti


def test_add_matches_rebuilt():
    emb, j, t = _pair(20)
    extra = _rows(7, seed=1)
    j.add(extra)
    t.add(extra)
    assert len(t) == 27 and t.version == 1
    _assert_state_equal(j, t)
    rebuilt = DenseIndex.from_embeddings(np.concatenate([emb, extra]), device="cpu",
                                         dtype=torch.float32)
    tv, ti = _assert_search_equal(j, t, _q(), 5)
    rv, ri = rebuilt.search(_q(), 5)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_allclose(tv, rv, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(t.take([26])[0], extra[6])


def test_add_grows_capacity():
    emb, j, t = _pair(10, pad_multiple=16)
    cap0 = t.embeddings.shape[0]
    big = _rows(cap0 + 5, seed=2)
    j.add(big)
    t.add(big)
    assert t.embeddings.shape[0] >= t.n >= cap0 + 15
    _assert_state_equal(j, t)
    assert (t.embeddings[t.n:] == 0).all()  # the capacity tail stays zero
    rebuilt = DenseIndex.from_embeddings(np.concatenate([emb, big]), device="cpu",
                                         dtype=torch.float32)
    _, ti = _assert_search_equal(j, t, _q(), 8)
    np.testing.assert_array_equal(ti, rebuilt.search(_q(), 8)[1])


def test_add_repeated_small_buckets():
    emb, j, t = _pair(4, pad_multiple=16)
    parts = [emb]
    for i, m in enumerate((1, 3, 2, 5, 1)):
        p = _rows(m, seed=3 + i)
        j.add(p)
        t.add(p)
        parts.append(p)
        _assert_state_equal(j, t)
    rebuilt = DenseIndex.from_embeddings(np.concatenate(parts), device="cpu",
                                         dtype=torch.float32)
    tv, ti = _assert_search_equal(j, t, _q(), 6)
    rv, ri = rebuilt.search(_q(), 6)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_allclose(tv, rv, rtol=0, atol=ATOL)


def test_add_idmap_roundtrip():
    _, j, t = _pair(6, ids=True)
    extra = _rows(2, seed=4)
    j.add(extra, ids=["new0", "new1"])
    t.add(torch.from_numpy(extra), ids=["new0", "new1"])  # a tensor adds as numpy does
    _assert_state_equal(j, t)
    assert t.id_map.rows_to_ids([6, 7]) == ["new0", "new1"]
    assert t.id_map.ids_to_rows(["new1"]) == [7]
    for call in (lambda: t.add(extra, ids=["only-one"]),  # id count mismatch
                 lambda: t.add(extra)):                     # a map needs ids
        with pytest.raises(ValueError):
            call()
    _, _, bare = _pair(4)
    with pytest.raises(ValueError):
        bare.add(extra, ids=["a", "b"])  # no map, no ids
    with pytest.raises(ValueError):
        bare.add(_rows(2, d=5))          # wrong width
    _assert_state_equal(j, t)           # the refused adds changed nothing


def test_remove_rows_matches_rebuilt():
    emb, j, t = _pair(30)
    q = _q()
    _, top = t.search(q, 1)
    dead = np.unique(top.reshape(-1))[:3]  # the top rows: filtering must change results
    assert t.remove_rows(dead) == j.remove_rows(dead) == dead.size
    assert t.remove_rows(dead) == 0        # idempotent, no version bump
    j.remove_rows(dead)
    assert len(t) == 30 - dead.size
    _assert_state_equal(j, t)
    _, ti = _assert_search_equal(j, t, q, 5)
    keep = np.setdiff1d(np.arange(30), dead)
    rebuilt = DenseIndex.from_embeddings(emb[keep], device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(keep[rebuilt.search(q, 5)[1]], ti)
    assert not np.isin(ti, dead).any()


def test_remove_ids_and_duplicates():
    emb, j, t = _pair(8, ids=True)
    for idx in (j, t):
        idx.add(emb[:1], ids=["doc0"])    # doc0 now on rows 0 and 8
    assert t.live_rows(["doc0"]) == j.live_rows(["doc0"]) == [0, 8]
    assert t.remove_ids(["doc0"]) == j.remove_ids(["doc0"]) == 2
    assert t.live_rows(["doc0"]) == [] and t.live_rows(["doc1"]) == [1]
    _assert_state_equal(j, t)
    _, ti = _assert_search_equal(j, t, _q(), 4)
    assert not np.isin(ti, [0, 8]).any()


def test_remove_underfill_padding_contract():
    _, j, t = _pair(5)
    for idx in (j, t):
        idx.remove_rows([0, 1, 2])
    tv, ti = _assert_search_equal(j, t, _q(), 4)  # 2 live rows < k
    assert np.isfinite(tv[:, :2]).all()
    assert (tv[:, 2:] == -np.inf).all() and (ti[:, 2:] == 0).all()
    assert not np.isin(ti[:, :2], [0, 1, 2]).any()


def test_remove_out_of_range():
    _, _, t = _pair(5)
    for rows in ([5], [-1]):
        with pytest.raises(ValueError):
            t.remove_rows(rows)
    assert t.version == 0 and t.n_deleted == 0


def test_compact_and_save(tmp_path):
    _, j, t = _pair(12, ids=True)
    for idx in (j, t):
        idx.remove_ids(["doc3", "doc7"])
    jc, tc = j.compact(), t.compact()
    assert len(tc) == len(t) == 10 and tc.n_deleted == 0 and tc.version == 0
    _assert_state_equal(jc, tc)
    assert tc.id_map.rows_to_ids([3]) == ["doc4"]  # renumbered past the hole
    q = _q()
    tv, _ = _assert_search_equal(j, t, q, 4)
    cv, ci = _assert_search_equal(jc, tc, q, 4)
    np.testing.assert_allclose(tv, cv, rtol=0, atol=ATOL)
    # save() compacts first; the port's artifact equals the JAX package's
    t.save(str(tmp_path / "t"))
    j.save(str(tmp_path / "j"))
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "embeddings.npy"),
                                  np.load(tmp_path / "j" / "embeddings.npy"))
    assert (tmp_path / "t" / "idx_id.json").read_bytes() == \
        (tmp_path / "j" / "idx_id.json").read_bytes()
    loaded = DenseIndex.load(str(tmp_path / "t"), device="cpu", dtype=torch.float32)
    assert len(loaded) == 10
    np.testing.assert_array_equal(loaded.search(q, 4)[1], ci)


def test_fused_and_ivf_guards():
    """The JAX twin also checks fused_search_fn, which the port does not
    have (ROADMAP Queue 3): here the IVF guards alone."""
    emb, _, t = _pair(40)
    t.remove_rows([1])
    with pytest.raises(ValueError, match="compact"):
        t.to_ivf(nlist=2, nprobe=1, niter=2)
    ivf = t.compact().to_ivf(nlist=2, nprobe=1, niter=2)
    for call in (lambda: ivf.add(emb[:1]), lambda: ivf.remove_rows([0])):
        with pytest.raises(ValueError, match="to_ivf"):
            call()
    assert ivf.n == 39 and ivf.version == 0


def test_version_bumps_and_sharded_guard():
    """The JAX twin's mesh-sharded guard has no counterpart: the port has no
    row sharding yet (ROADMAP Queue 1, item 15). Every mutation bumps the
    version as the JAX index's does; a no-op does not."""
    emb, j, t = _pair(16)
    assert t.version == 0
    for idx in (j, t):
        idx.add(emb[:2])
        idx.remove_rows([0])
        idx.remove_rows([0])
        idx.add(emb[:0])
    assert t.version == j.version == 2
    _assert_state_equal(j, t)


def test_int8_add_remove_exact_over_own_codes():
    """An int8 index through an add that starts inside a quantization block
    (the straddled block requantized), removals and compaction: the port's
    codes, scales and results equal the JAX index's; the search equals the
    exact top-k of its own codes with the tombstones excluded; stored rows
    stay within one quantization step of the originals; compact() equals
    from_embeddings of the dequantized survivors."""
    emb, j, t = _pair(1500, d=128, ids=True, dtype="int8")
    qb = t.quant_block
    assert 1500 % qb != 0  # the add below starts inside a block
    extra = _rows(64, d=128, seed=3)
    names = [f"x{i}" for i in range(64)]
    j.add(extra, names)
    t.add(extra, names)
    assert t.n == 1564
    assert t.remove_ids(["doc3", "doc77", "x5"]) == j.remove_ids(["doc3", "doc77", "x5"]) == 3
    _assert_state_equal(j, t)
    queries = _q(16, d=128, seed=5)
    tv, ti = _assert_search_equal(j, t, queries, 9)

    # the exact top-9 of the index's own codes at the scoring precision (bf16
    # queries, exact integer products in f64), tombstones excluded
    row_sc = quant.expand_scales(t.scales, qb, t.n)
    q16 = torch.from_numpy(queries).bfloat16().double().numpy()
    scores = (q16 @ t.embeddings[:t.n].double().numpy().T) * row_sc.double().numpy()
    scores[:, t._deleted] = -np.inf
    want = np.argsort(-scores, axis=1, kind="stable")[:, :9]
    np.testing.assert_array_equal(ti, want)

    stored = t.take(np.arange(t.n))
    err = np.abs(stored - np.concatenate([emb, extra])).max(axis=1)
    assert (err <= row_sc.numpy() * 1.01 + 1e-7).all()

    comp = t.compact()
    _assert_state_equal(j.compact(), comp)
    live = np.setdiff1d(np.arange(t.n), t._deleted)
    fresh = DenseIndex.from_embeddings(t.take(live), IdMap(t.id_map.rows_to_ids(live)),
                                       device="cpu", dtype="int8")
    assert comp.is_quantized and len(comp) == t.n - 3
    np.testing.assert_array_equal(comp.embeddings.numpy(), fresh.embeddings.numpy())
    v1, _, ids1 = comp.search_ids(queries, 9)
    v2, _, ids2 = fresh.search_ids(queries, 9)
    np.testing.assert_array_equal(v1, v2)
    assert ids1 == ids2


def test_int8_add_grows_and_keeps_quant_block():
    """Growth past the capacity keeps the quantization block that
    construction chose (envelope_block of the new size may differ) and the
    scale vector's length in step with the buffer."""
    _, j, t = _pair(1000, d=16, dtype="int8")
    qb = t.quant_block
    extra = _rows(700, d=16, seed=6)
    j.add(extra)
    t.add(extra)
    assert t.quant_block == qb and t.embeddings.shape[0] > 1024
    assert t.scales.shape[0] * qb == t.embeddings.shape[0]
    _assert_state_equal(j, t)
    _assert_search_equal(j, t, _q(8, d=16), 10)


def test_overfetch_past_512_equals_compact():
    """Enough tombstones to push the over-fetch to k_fetch = 1,024 on a
    corpus past the naive-search cut: the fetch takes the chunked path
    (exact k > 512), and the result equals compact()'s search, and the JAX
    index's."""
    _, j, t = _pair(5000, d=16, seed=7)
    dead = np.random.default_rng(8).choice(5000, 600, replace=False)
    for idx in (j, t):
        idx.remove_rows(dead)
    q = _q(8, d=16, seed=10)
    with pytest.warns(UserWarning, match="k=1024"):
        tv, ti = t.search(q, 80)
    assert min(t.n, 1 << (80 + 600 - 1).bit_length()) == 1024
    with pytest.warns(UserWarning):
        jv, ji = j.search(q, 80)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=ATOL)
    comp = t.compact()
    cv, ci = comp.search(q, 80)
    keep = np.setdiff1d(np.arange(5000), dead)
    np.testing.assert_array_equal(keep[ci], ti)
    np.testing.assert_allclose(cv, tv, rtol=0, atol=ATOL)
