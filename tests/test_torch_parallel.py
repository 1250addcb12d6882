"""The port's sharded search (parallel/search.py) and row-sharded DenseIndex,
twins of tests/test_parallel.py: the port shards over a mesh of 8 CPU
entries, the JAX package over its 8-device virtual CPU mesh, and each case
holds the port against the JAX package's sharded search and against the
exact reference, ids exact and values within rtol 1e-6. Then the sharded
int8 index against the JAX package's, and --dp-encode's data-parallel
encode against the one-device encode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from proqa_tpu.index import DenseIndex as JaxDenseIndex  # noqa: E402
from proqa_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from proqa_tpu.parallel import shard_rows as jax_shard_rows  # noqa: E402
from proqa_tpu.parallel import sharded_mips_topk as jax_sharded  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.index.idmap import IdMap  # noqa: E402
from proqa_tpu_torch.ops.mips import NEG_INF, mips_topk_reference  # noqa: E402
from proqa_tpu_torch.parallel import (  # noqa: E402
    make_mesh, replicate, shard_rows, sharded_matvec_stats, sharded_mips_topk,
)

RTOL = 1e-6  # f32 scores of the same products, summed in other orders


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh(eight_devices):
    return jax_make_mesh(8)


def _both(corpus, queries, k, mesh, jmesh, **kw):
    """(port, JAX) sharded results as numpy."""
    tv, ti = sharded_mips_topk(torch.from_numpy(queries), shard_rows(mesh, torch.from_numpy(corpus)),
                               k, mesh, **kw)
    jv, ji = jax_sharded(jnp.asarray(queries), jax_shard_rows(jmesh, jnp.asarray(corpus)), k,
                         jmesh, **kw)
    return (tv.numpy(), ti.numpy()), (np.asarray(jv), np.asarray(ji))


def _ref(queries, corpus, k):
    v, i = mips_topk_reference(torch.from_numpy(queries), torch.from_numpy(corpus), k)
    return v.numpy(), i.numpy()


def test_sharded_equals_reference(mesh, jmesh):
    rng = np.random.default_rng(0)
    n, d, q, k = 8 * 1024, 32, 16, 37
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    (tv, ti), (jv, ji) = _both(corpus, queries, k, mesh, jmesh)
    rv, ri = _ref(queries, corpus, k)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, rv, rtol=RTOL)
    np.testing.assert_allclose(tv, jv, rtol=RTOL)


def test_sharded_k_exceeds_shard_rows(mesh, jmesh):
    """k larger than a shard's rows: each shard offers its whole slab padded
    to k columns, and the merge still finds the global top-k, also with
    trailing padded rows masked by global index."""
    rng = np.random.default_rng(3)
    n, d, q, k = 8 * 16, 32, 4, 40   # local rows 16 < k
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    (tv, ti), (jv, ji) = _both(corpus, queries, k, mesh, jmesh)
    rv, ri = _ref(queries, corpus, k)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, rv, rtol=RTOL)
    n_valid = n - 20
    (tv, ti), (jv, ji) = _both(corpus, queries, k, mesh, jmesh, n_valid=n_valid)
    _, ri = _ref(queries, corpus[:n_valid], k)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=RTOL)


def test_sharded_blockmax_path(mesh, jmesh):
    """Shards past 4,096 rows take the block-max search on every shard (the
    K1 pipeline: its plain version on the CPU)."""
    rng = np.random.default_rng(1)
    n, d, q, k = 8 * 8192, 8, 8, 16
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    (tv, ti), (jv, ji) = _both(corpus, queries, k, mesh, jmesh)
    _, ri = _ref(queries, corpus, k)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=RTOL)


def test_shard_layout(mesh, jmesh):
    corpus = torch.arange(64 * 4, dtype=torch.float32).view(64, 4)
    shards = shard_rows(mesh, corpus)
    assert len(shards) == 8 and all(s.shape == (8, 4) for s in shards)
    assert all(s.device == torch.device("cpu") for s in shards)
    assert torch.equal(torch.cat(shards), corpus)
    assert len(jax_shard_rows(jmesh, jnp.zeros((64, 4))).sharding.device_set) == 8
    rows, sq = sharded_matvec_stats(shards)
    assert rows == 64 and sq == pytest.approx(float(corpus.square().sum()))
    assert all(torch.equal(r, corpus) for r in replicate(mesh, corpus))
    with pytest.raises(ValueError, match="divide"):
        shard_rows(mesh, corpus[:60])


def test_sharded_padding_negative_scores_deterministic(mesh, jmesh):
    """Zero-vector pad rows score exactly 0 and must not evict genuine
    negative-score rows from the padded shard's local top-k: 1020 rows pad
    to 1024 over 8 shards, the last holding 4 pads."""
    n, d, k = 1020, 16, 4
    emb = np.zeros((n, d), np.float32)
    emb[:, 0] = -100.0
    for rank, row in enumerate([900, 910, 920, 930]):
        emb[row, 0] = -float(rank + 1)  # scores -1..-4, all on the last shard
    queries = np.zeros((3, d), np.float32)
    queries[:, 0] = 1.0
    index = DenseIndex.from_embeddings(emb, mesh=mesh, dtype=torch.float32, pad_multiple=8)
    assert index.capacity == 1024 and len(index.embeddings) == 8
    vals, idx = index.search(queries, k)
    np.testing.assert_array_equal(idx, np.tile([900, 910, 920, 930], (3, 1)))
    np.testing.assert_allclose(vals, np.tile([-1.0, -2.0, -3.0, -4.0], (3, 1)))
    jindex = JaxDenseIndex.from_embeddings(emb, mesh=jmesh, dtype=jnp.float32, pad_multiple=8)
    jv, ji = jindex.search(queries, k)
    np.testing.assert_array_equal(idx, ji)


def test_sharded_padding_negative_scores_randomized(mesh, jmesh):
    """All-negative scores with lcm padding: the sharded result holds the
    exact top-k's ids."""
    rng = np.random.default_rng(7)
    n, d, k = 4196, 16, 32
    emb = -np.abs(rng.standard_normal((n, d))).astype(np.float32)
    queries = np.abs(rng.standard_normal((6, d))).astype(np.float32)
    index = DenseIndex.from_embeddings(emb, mesh=mesh, dtype=torch.float32)
    assert index.capacity > n
    vals, idx = index.search(queries, k)
    rv, ri = _ref(queries, emb, k)
    jv, ji = JaxDenseIndex.from_embeddings(emb, mesh=jmesh, dtype=jnp.float32).search(queries, k)
    for qi in range(queries.shape[0]):
        assert set(idx[qi].tolist()) == set(ri[qi].tolist()) == set(ji[qi].tolist())
    np.testing.assert_allclose(vals, rv, rtol=RTOL)
    np.testing.assert_allclose(vals, jv, rtol=RTOL)


def test_sharded_padding_blockmax_path(mesh, jmesh):
    """Padding and negative scores with shards large enough for the
    block-max search (each shard's valid count masks inside it)."""
    rng = np.random.default_rng(11)
    n, d, k = 40000, 8, 16
    emb = -np.abs(rng.standard_normal((n, d))).astype(np.float32)
    queries = np.abs(rng.standard_normal((4, d))).astype(np.float32)
    index = DenseIndex.from_embeddings(emb, mesh=mesh, dtype=torch.float32)
    assert index.capacity // 8 > 4096
    vals, idx = index.search(queries, k)
    _, ri = _ref(queries, emb, k)
    _, ji = JaxDenseIndex.from_embeddings(emb, mesh=jmesh, dtype=jnp.float32).search(queries, k)
    for qi in range(queries.shape[0]):
        assert set(idx[qi].tolist()) == set(ri[qi].tolist()) == set(ji[qi].tolist())


def test_dense_index_sharded(mesh, jmesh):
    """A sharded DenseIndex: padding, id mapping, search, gathers across the
    shards, the unsharded save, and the mutations a sharded index refuses
    with the JAX package's messages."""
    rng = np.random.default_rng(5)
    n, d = 1000, 16  # not divisible by 8
    emb = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    index = DenseIndex.from_embeddings(emb, IdMap.from_doc_ids(ids), mesh=mesh,
                                       dtype=torch.float32, pad_multiple=8)
    assert index.capacity % 8 == 0 and index.device == torch.device("cpu")
    queries = rng.standard_normal((5, d)).astype(np.float32)
    vals, idx, got_ids = index.search_ids(queries, 7)
    _, ri = _ref(queries, emb, 7)
    np.testing.assert_array_equal(idx, ri)
    assert got_ids[0][0] == f"d{int(ri[0, 0])}"
    _, _, jids = JaxDenseIndex.from_embeddings(
        emb, jax_index_idmap(ids), mesh=jmesh, dtype=jnp.float32, pad_multiple=8
    ).search_ids(queries, 7)
    assert got_ids == jids
    rows = np.array([[0, 999, 124, -1], [125, 500, 750, 1200]])  # -1 and past the end clip
    np.testing.assert_array_equal(index.take(rows), emb[np.clip(rows, 0, n - 1)])
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        index.save(tmp)
        np.testing.assert_array_equal(np.load(f"{tmp}/embeddings.npy"), emb)
    with pytest.raises(ValueError, match="mesh-sharded index is not supported"):
        index.add(emb[:2], ["x", "y"])
    with pytest.raises(ValueError, match="mesh-sharded index is not supported"):
        index.remove_ids(["d1"])
    with pytest.raises(ValueError, match="mesh-sharded index is not supported"):
        index.check_mutable()


def jax_index_idmap(ids):
    from proqa_tpu.index import IdMap as JaxIdMap

    return JaxIdMap.from_doc_ids(ids)


def test_sharded_fully_padded_shards_follow_degenerate_contract(mesh, jmesh):
    """n_valid inside the first shard: the other 7 are all padding, and the
    merged output keeps the (NEG_INF, row 0) contract, never a padded id."""
    rng = np.random.default_rng(7)
    n, d, q, k, n_valid = 8 * 16, 32, 4, 12, 5
    corpus = np.zeros((n, d), np.float32)
    corpus[:n_valid] = rng.standard_normal((n_valid, d))
    queries = rng.standard_normal((q, d)).astype(np.float32)
    (sv, si), (jv, ji) = _both(corpus, queries, k, mesh, jmesh, n_valid=n_valid)
    rv, ri = _ref(queries, corpus[:n_valid], n_valid)
    np.testing.assert_array_equal(si[:, :n_valid], ri)
    np.testing.assert_allclose(sv[:, :n_valid], rv, rtol=RTOL)
    assert (sv[:, n_valid:] <= NEG_INF).all()
    assert (si[:, n_valid:] == 0).all()
    assert (si < n_valid).all()
    np.testing.assert_array_equal(si, ji)


def test_sharded_int8_index_matches_jax(mesh, jmesh):
    """An int8 index sharded over 8 entries quantizes per shard (the block
    envelope_block(rows per shard)) as the JAX package's does, and the
    merged search over the scaled codes gives the JAX package's ids, the
    unsharded int8 index's and the dequantized rows' exact top-k."""
    rng = np.random.default_rng(2)
    n = 8 * 256 + 3
    emb = rng.standard_normal((n, 128)).astype(np.float32)
    queries = rng.standard_normal((8, 128)).astype(np.float32)
    index = DenseIndex.from_embeddings(emb, mesh=mesh, dtype="int8")
    jindex = JaxDenseIndex.from_embeddings(emb, mesh=jmesh, dtype="int8")
    assert index.is_quantized and index.quant_block == jindex.quant_block
    vals, idx = index.search(queries, 7)
    jv, ji = jindex.search(queries, 7)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_allclose(vals, jv, rtol=1e-5)
    uv, ui = DenseIndex.from_embeddings(emb, device="cpu", dtype="int8").search(queries, 7)
    np.testing.assert_array_equal(idx, ui)
    deq = index.take(np.arange(n))
    q16 = torch.from_numpy(queries).bfloat16().float().numpy()
    _, ri = _ref(q16, deq, 7)
    np.testing.assert_array_equal(idx, ri)


def test_dp_encode_matches_one_device():
    """--dp-encode's encode over a mesh of 4 CPU entries (one replica each,
    every bucketed batch split into 4 row ranges) equals the one-device
    encode in f32, rows in dataset order, with a ragged tail; a batch size
    off the mesh's multiple is refused."""
    from proqa_tpu_torch.index.build import encode_corpus
    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.retriever import Retriever

    rng = np.random.default_rng(3)
    n_rows = 3 * 4 + 1  # a ragged tail on purpose
    rows = [rng.integers(5, 128, int(rng.integers(4, 17))).tolist() for _ in range(n_rows)]

    class _Rows:
        max_len = 16

        def __len__(self):
            return n_rows

        def __getitem__(self, i):
            return rows[i]

    model = Retriever(BertConfig.tiny(dtype=torch.float32)).reset_parameters(3).eval()
    one = encode_corpus(model, _Rows(), batch_size=8, buckets=(8, 16))
    dp = encode_corpus(model, _Rows(), batch_size=8, buckets=(8, 16),
                       mesh=make_mesh(devices=["cpu"] * 4))
    assert dp.shape == (n_rows, 128)
    np.testing.assert_allclose(dp, one, rtol=0, atol=1e-5)
    q_one = encode_corpus(model, _Rows(), batch_size=8, is_query=True, buckets=(8, 16))
    q_dp = encode_corpus(model, _Rows(), batch_size=8, is_query=True, buckets=(8, 16),
                         mesh=make_mesh(devices=["cpu"] * 2))
    np.testing.assert_allclose(q_dp, q_one, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="does not split over 3 devices"):
        encode_corpus(model, _Rows(), batch_size=8, buckets=(8, 16),
                      mesh=make_mesh(devices=["cpu"] * 3))
