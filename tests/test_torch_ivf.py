"""The port's IVF index against the JAX package's: twins of
tests/test_ivf.py on the same seeded data in f32 on the CPU.

k-means draws differ by design (torch.Generator against jax.random,
ops/kmeans.py), so the parity cases give both packages the same initial
centroids (the k-means++ seeding replaced by the same rows, as
tests/test_torch_kmeans.py does): then build_ivf lays out the same slabs,
slab rows and overflow, and the search returns the same rows. The port's
own draws are held to the properties the JAX tests hold (recall, exactness
at full probe, overflow found, no padding row escaping).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from proqa_tpu.index import ivf as jax_ivf  # noqa: E402
from proqa_tpu.index.dense import (  # noqa: E402
    DenseIndex as JaxDenseIndex, IVFDenseIndex as JaxIVFDenseIndex,
)
from proqa_tpu.ops import kmeans as jax_kmeans  # noqa: E402
from proqa_tpu_torch.index import ivf  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex, IVFDenseIndex  # noqa: E402
from proqa_tpu_torch.index.idmap import IdMap  # noqa: E402
from proqa_tpu_torch.ops import kmeans  # noqa: E402
from proqa_tpu_torch.ops.mips import NEG_INF, mips_topk_reference  # noqa: E402
from proqa_tpu_torch.testing import topk_disagreements  # noqa: E402

# f32 scores over 32-wide rows of magnitude ~100, summed in other orders by
# the two packages: a few f32 ulps (3e-7 relative read); k-means centroids
# after 15 iterations: tests/test_torch_kmeans.py's 1e-5
RTOL, ATOL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((32, 32)) * 2  # 32 blobs
    pts = (centers[rng.integers(0, 32, size=4096)]
           + 0.3 * rng.standard_normal((4096, 32))).astype(np.float32)
    queries = (centers[rng.integers(0, 32, size=16)]
               + 0.3 * rng.standard_normal((16, 32))).astype(np.float32)
    return pts, queries


def _exact(pts, queries, k):
    _, i = mips_topk_reference(torch.from_numpy(queries), torch.from_numpy(pts), k)
    return i.numpy()


def _recall(got, want):
    k = want.shape[1]
    return np.mean([len(set(got[r]) & set(want[r])) / k for r in range(len(want))])


def _same_init(monkeypatch, rows):
    """Both packages' k-means++ seeding replaced by the same training rows."""
    monkeypatch.setattr(jax_kmeans, "_kmeanspp_init",
                        lambda rng, train, k, spherical: jnp.asarray(train)[jnp.asarray(rows)])
    monkeypatch.setattr(kmeans, "_kmeanspp_init",
                        lambda gen, train, k, spherical: train[torch.as_tensor(rows)].float())


def _assert_layout_equal(t, j):
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), rtol=0, atol=ATOL)
    for name in ("slabs", "slab_rows", "overflow", "overflow_rows"):
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (t.nprobe, t.spherical, t.capacity) == (j.nprobe, j.spherical, j.capacity)


def _assert_search_equal(t, j, queries, k):
    tv, ti = t.search(queries, k)
    jv, ji = j.search(queries, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    return tv.numpy(), ti.numpy()


def test_ivf_recall(data, monkeypatch):
    pts, queries = data
    index = ivf.build_ivf(pts, nlist=32, nprobe=8, niter=15, dtype=torch.float32)
    v, i = index.search(queries, 20)
    assert _recall(i.numpy(), _exact(pts, queries, 20)) > 0.8
    assert (np.diff(v.numpy(), axis=1) <= 1e-5).all()
    # from the same initial centroids: the JAX package's layout and results
    _same_init(monkeypatch, list(range(0, 4096, 128)))
    t = ivf.build_ivf(pts, nlist=32, nprobe=8, niter=15, dtype=torch.float32)
    j = jax_ivf.build_ivf(pts, nlist=32, nprobe=8, niter=15, dtype=jnp.float32)
    _assert_layout_equal(t, j)
    _assert_search_equal(t, j, queries, 20)


def test_ivf_full_probe_exact(data, monkeypatch):
    """nprobe == nlist scans every row: the exact top-k."""
    pts, queries = data
    index = ivf.build_ivf(pts, nlist=16, nprobe=16, niter=10, capacity_factor=1.2,
                          dtype=torch.float32)
    _, i = index.search(queries, 10)
    assert _recall(i.numpy(), _exact(pts, queries, 10)) == 1.0
    _same_init(monkeypatch, list(range(3, 4096, 256)))
    t = ivf.build_ivf(pts, nlist=16, nprobe=16, niter=10, capacity_factor=1.2,
                      dtype=torch.float32)
    j = jax_ivf.build_ivf(pts, nlist=16, nprobe=16, niter=10, capacity_factor=1.2,
                          dtype=jnp.float32)
    _assert_layout_equal(t, j)
    assert t.overflow.shape[0] > 0  # capacity 1.2x: some clusters overflow
    _assert_search_equal(t, j, queries, 10)


def test_ivf_overflow_not_dropped(monkeypatch):
    """A tiny capacity forces overflow; those rows are still found (the
    overflow is always scanned)."""
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((512, 16)).astype(np.float32)
    index = ivf.build_ivf(pts, nlist=4, nprobe=1, niter=5, capacity_factor=0.25,
                          dtype=torch.float32)
    assert index.overflow.shape[0] > 0
    over_rows = set(int(r) for r in index.overflow_rows if r >= 0)
    queries = rng.standard_normal((64, 16)).astype(np.float32)
    exact1 = _exact(pts, queries, 1)[:, 0]
    hits = [qi for qi in range(64) if int(exact1[qi]) in over_rows]
    assert hits, "test setup: no query resolved to an overflow row"
    _, ivf1 = index.search(queries[hits], 1)
    np.testing.assert_array_equal(ivf1.numpy()[:, 0], exact1[hits])
    _same_init(monkeypatch, [0, 1, 2, 3])
    t = ivf.build_ivf(pts, nlist=4, nprobe=1, niter=5, capacity_factor=0.25,
                      dtype=torch.float32)
    j = jax_ivf.build_ivf(pts, nlist=4, nprobe=1, niter=5, capacity_factor=0.25,
                          dtype=jnp.float32)
    _assert_layout_equal(t, j)
    _assert_search_equal(t, j, queries, 5)


def test_ivf_no_padding_indices(data):
    pts, queries = data
    index = ivf.build_ivf(pts, nlist=32, nprobe=4, niter=5, dtype=torch.float32)
    _, i = index.search(queries, 50)
    assert i.dtype == torch.int32
    assert (i >= 0).all() and (i < len(pts)).all()


def test_ivf_underfilled_k_never_leaks_padding(data, monkeypatch):
    """Probed clusters and overflow holding fewer than k real rows: the tail
    is (NEG_INF, row 0), DenseIndex's contract, never row -1."""
    pts, queries = data
    _same_init(monkeypatch, list(range(0, 192, 6)))
    kw = dict(nlist=32, nprobe=2, niter=5, capacity_factor=1.0)
    index = ivf.build_ivf(pts[:200], dtype=torch.float32, **kw)
    vals, idx = index.search(queries, 150)
    vals, idx = vals.numpy(), idx.numpy()
    assert (idx >= 0).all() and (idx < 200).all()
    padding = vals <= float(NEG_INF)
    assert padding.any(), "test setup: expected an under-filled top-k"
    assert (idx[padding] == 0).all()
    first_pad = padding.argmax(axis=1)
    for r in range(len(queries)):
        if padding[r].any():
            assert padding[r, first_pad[r]:].all()  # real rows rank ahead of padding
    j = jax_ivf.build_ivf(pts[:200], dtype=jnp.float32, **kw)
    _assert_layout_equal(index, j)
    _assert_search_equal(index, j, queries, 150)


def test_ivf_dense_index_adapter(data, monkeypatch):
    """DenseIndex.to_ivf: the sampler's search API over the IVF layout, with
    the exact bypass and the gathers intact; the same results as the JAX
    package's to_ivf from the same initial centroids."""
    pts, queries = data
    names = [f"d{i}" for i in range(len(pts))]
    dense = DenseIndex.from_embeddings(pts, IdMap(names), device="cpu", dtype=torch.float32,
                                       pad_multiple=8)
    view = dense.to_ivf(nlist=16, nprobe=16, niter=8)
    assert isinstance(view, IVFDenseIndex) and view.embeddings is dense.embeddings
    v1, i1 = view.search(queries, 10)
    v2, i2 = view.search(queries, 10, exact=True)
    assert i1.dtype == np.int32 and _recall(i1, i2) == 1.0
    emb = view.take(i1[0])
    assert emb.shape == (10, pts.shape[1])
    assert view.id_map.rows_to_ids(i1[0][:2])[0].startswith("d")
    _same_init(monkeypatch, list(range(5, 4096, 256)))
    jdense = JaxDenseIndex.from_embeddings(pts, dtype=jnp.float32, pad_multiple=8)
    jview = jdense.to_ivf(nlist=16, nprobe=4, niter=8)
    tview = dense.to_ivf(nlist=16, nprobe=4, niter=8)
    _assert_layout_equal(tview.ivf, jview.ivf)
    for q in (queries, queries[:3]):  # a ragged batch pads to a power of two
        jv, ji = jview.search(q, 10)
        tv, ti = tview.search(q, 10)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)


def test_ivf_search_chunks_large_query_batches(data):
    """A batch whose slab gather passes the budget runs in padded chunks,
    with the results of one unchunked search."""
    pts, queries = data
    index = ivf.build_ivf(pts, nlist=16, nprobe=4, niter=5, dtype=torch.float32)
    big_q = np.concatenate([queries] * 5)  # 80 queries, not a chunk multiple
    v_ref, i_ref = index.search(big_q, 10)
    per_q = index.nprobe * index.capacity * pts.shape[1] * 4
    index.GATHER_BUDGET_BYTES = per_q * 24  # chunks of 24 < 80
    calls = []
    real = index._search_call
    index._search_call = lambda q, k: calls.append(q.shape[0]) or real(q, k)
    v, i = index.search(big_q, 10)
    assert calls == [24, 24, 24, 24]
    np.testing.assert_array_equal(i.numpy(), i_ref.numpy())
    np.testing.assert_allclose(v.numpy(), v_ref.numpy(), rtol=0, atol=1e-6)


def _l2_case():
    """c0 small-norm, c1 huge-norm; the best row x = [0.5, 0] is L2-assigned
    to c0. Raw inner-product probing would pick c1 (10 against 0.1) and
    return row 1; L2 probing picks c0 (0.095 against -40) and row 0."""
    return dict(centroids=[[0.1, 0.0], [10.0, 0.0]],
                slabs=[[[0.5, 0.0]] * 8, [[0.0, 0.2]] * 8],
                slab_rows=[[0] + [-1] * 7, [1] + [-1] * 7])


def _both_ivf(centroids, slabs, slab_rows, nprobe, spherical):
    t = ivf.IVFIndex(centroids=torch.tensor(centroids), slabs=torch.tensor(slabs),
                     slab_rows=torch.tensor(slab_rows, dtype=torch.int32),
                     overflow=torch.zeros(0, 2), overflow_rows=torch.zeros(0, dtype=torch.int32),
                     nprobe=nprobe, spherical=spherical)
    j = jax_ivf.IVFIndex(centroids=jnp.asarray(centroids, jnp.float32),
                         slabs=jnp.asarray(slabs, jnp.float32),
                         slab_rows=jnp.asarray(slab_rows, jnp.int32),
                         overflow=jnp.zeros((0, 2), jnp.float32),
                         overflow_rows=jnp.zeros((0,), jnp.int32),
                         nprobe=nprobe, spherical=spherical)
    return t, j


def test_ivf_l2_quantizer_probes_l2_geometry():
    t, j = _both_ivf(**_l2_case(), nprobe=1, spherical=False)
    q = np.asarray([[1.0, 0.0]], np.float32)
    _, idx = _assert_search_equal(t, j, q, 1)
    assert int(idx[0, 0]) == 0


def test_ivf_fused_search_uses_quantizer_geometry():
    """The JAX twin drives fused_search_fn, which the port does not have
    (ROADMAP Queue 3): the port's IVFDenseIndex.search is the one path, and
    it probes in the quantizer's own (L2) geometry."""
    t, _ = _both_ivf(**_l2_case(), nprobe=1, spherical=False)
    index = IVFDenseIndex(embeddings=torch.tensor([[0.5, 0.0], [0.0, 0.2]]), n=2, ivf=t)
    vals, idx = index.search(np.asarray([[1.0, 0.0]], np.float32), 1)
    assert int(idx[0, 0]) == 0 and vals[0, 0] == pytest.approx(0.5)


def test_fused_search_pads_to_full_k_width():
    """The search returns k columns even where the probed slabs and the
    overflow hold fewer rows (2 lists x 4 slots < k), as the JAX package's
    unfused search does; the slots past the real rows are (NEG_INF or -inf,
    row 0). The dense search of 3 rows pads alike. Rows 0 and 1 hold the
    same vector: torch.topk may order that tie either way, where JAX's top-k
    puts the lower index first, so the rows agree up to equal-score ties."""
    k = 12
    kw = dict(centroids=[[1.0, 0.0], [0.0, 1.0]], slabs=[[[0.5, 0.0]] * 4, [[0.0, 0.2]] * 4],
              slab_rows=[[0, 1, -1, -1], [2, -1, -1, -1]])
    t, j = _both_ivf(**kw, nprobe=2, spherical=True)
    emb = [[0.5, 0.0], [0.4, 0.0], [0.0, 0.2]]
    tindex = IVFDenseIndex(embeddings=torch.tensor(emb), n=3, ivf=t)
    jindex = JaxIVFDenseIndex(embeddings=jnp.asarray(emb, jnp.float32), n=3, ivf=j)
    q = np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32)
    tv, ti = tindex.search(q, k)
    jv, ji = jindex.search(q, k)
    assert tv.shape == ti.shape == (2, k)
    np.testing.assert_array_equal(tv, jv)
    assert topk_disagreements(tv, ti, jv, ji, atol=0.0) == 0
    assert set(ti[0, :2]) == {0, 1} and tv[0, 0] == 0.5  # the tied best rows lead
    assert (tv[:, 3:] <= float(NEG_INF)).all() and (ti[:, 3:] == 0).all()
    dense = DenseIndex(embeddings=torch.tensor(emb), n=3)
    dv, di = dense.search(q, k)
    assert dv.shape == (2, k) and (dv[:, 3:] <= float(NEG_INF)).all() and (di[:, 3:] == 0).all()
