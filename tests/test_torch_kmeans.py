"""Port parity for k-means and `cluster-corpus`: the chunk scores, the
assignment, Lloyd's iteration (with an empty cluster), whole runs from the
same initial centroids (spherical and L2) against proqa_tpu/ops/kmeans.py,
the port's own draws (k-means++, random rows, the per-centroid cap), and the
shards of both CLIs byte for byte."""
import json
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from proqa_tpu.cli.main import main as jax_main  # noqa: E402
from proqa_tpu.ops import kmeans as jax_kmeans  # noqa: E402
from proqa_tpu_torch.cli.main import main as torch_main  # noqa: E402
from proqa_tpu_torch.data.datasets import ClusterPairDataset, cluster_batch_order  # noqa: E402
from proqa_tpu_torch.ops import kmeans  # noqa: E402
from proqa_tpu_torch.text.wordpiece import BertTokenizer  # noqa: E402

# f32 on both sides; the products and the cluster sums run in other orders
# (XLA's one-hot product against index_add_): ~1e-7 relative. The L2
# objective is a mean of scores of magnitude 1-10 that nearly cancel, so it
# is held to TOL absolute as well
TOL = 1e-5


def _blobs(n=600, d=32, centers=6, seed=0, noise=0.25):
    """Rows around `centers` random unit directions (scaled by 1-3), so each
    row's nearest centroid leads clearly."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d))
    c = c / np.linalg.norm(c, axis=1, keepdims=True) * rng.uniform(1, 3, size=(centers, 1))
    x = c[rng.integers(0, centers, size=n)] + noise * rng.standard_normal((n, d))
    return x.astype(np.float32)


@pytest.mark.parametrize("spherical", [False, True])
def test_chunk_scores_and_assignment_match_jax(spherical):
    x = _blobs(n=300)
    cents = _blobs(n=6, seed=1)
    want = np.asarray(jax_kmeans._chunk_scores(jnp.asarray(x), jnp.asarray(cents), spherical))
    got = kmeans._chunk_scores(torch.from_numpy(x), torch.from_numpy(cents), spherical).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # 300 rows in chunks of 64: a partial last chunk
    ja, jv = jax_kmeans.assign_clusters(jnp.asarray(x), jnp.asarray(cents), spherical=spherical,
                                        chunk=64)
    ta, tv = kmeans.assign_clusters(torch.from_numpy(x), torch.from_numpy(cents),
                                    spherical=spherical, chunk=64)
    assert ta.dtype == torch.int32 and ta.shape == (300,)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("spherical", [False, True])
def test_lloyd_iter_matches_jax_with_an_empty_cluster(spherical):
    """From the same centroids, one of them a duplicate that wins no row
    (ties go to the lower index): the same update, the empty cluster keeping
    its centroid."""
    x = _blobs(n=500, seed=2)
    init = x[[0, 100, 200, 300, 400, 0]].copy()
    if spherical:
        init /= np.linalg.norm(init, axis=1, keepdims=True)
    jc, jobj = jax_kmeans._lloyd_iter(jnp.asarray(x), jnp.asarray(init), k=6,
                                      spherical=spherical, chunk=128)
    tc, tobj = kmeans._lloyd_iter(torch.from_numpy(x), torch.from_numpy(init), k=6,
                                  spherical=spherical, chunk=128)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
    assert float(tobj) == pytest.approx(float(jobj), rel=TOL, abs=TOL)
    np.testing.assert_array_equal(tc[5].numpy(), init[5])  # the empty cluster


def _same_init(monkeypatch, rows):
    """Both packages' k-means++ seeding replaced by the same rows of the
    training data: their random streams differ by design."""
    monkeypatch.setattr(jax_kmeans, "_kmeanspp_init",
                        lambda rng, train, k, spherical: jnp.asarray(train)[jnp.asarray(rows)])
    monkeypatch.setattr(kmeans, "_kmeanspp_init",
                        lambda gen, train, k, spherical: train[torch.as_tensor(rows)].float())


@pytest.mark.parametrize("spherical", [False, True])
def test_kmeans_from_the_same_init_matches_jax(monkeypatch, spherical):
    x = _blobs(n=700, seed=3)
    rows = [5, 6, 7, 8, 9, 10]  # near-random rows: several start in one blob
    _same_init(monkeypatch, rows)
    want = jax_kmeans.kmeans(jax.random.PRNGKey(0), jnp.asarray(x), 6, niter=8,
                             spherical=spherical, chunk=256)
    got = kmeans.kmeans(torch.Generator().manual_seed(0), torch.from_numpy(x), 6, niter=8,
                        spherical=spherical, chunk=256)
    np.testing.assert_array_equal(got.assignments.numpy(), np.asarray(want.assignments))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               rtol=TOL, atol=TOL)
    assert float(got.objective) == pytest.approx(float(want.objective), rel=TOL, abs=TOL)
    assert len(np.unique(got.assignments.numpy())) > 1


def test_kmeanspp_picks_distinct_points_and_survives_duplicates():
    """k-means++ never draws a point at distance 0 from a chosen one while
    others remain: over 5 distinct points repeated it picks all 5. With more
    centroids than distinct points it falls back to uniform draws."""
    pts = np.eye(5, 8, dtype=np.float32) * 3
    data = torch.from_numpy(np.repeat(pts, 20, axis=0))
    init = kmeans._kmeanspp_init(torch.Generator().manual_seed(1), data, 5, False)
    assert sorted(map(tuple, init.numpy())) == sorted(map(tuple, pts))
    more = kmeans._kmeanspp_init(torch.Generator().manual_seed(1), data, 8, False)
    assert more.shape == (8, 8) and torch.isfinite(more).all()
    again = kmeans._kmeanspp_init(torch.Generator().manual_seed(1), data, 8, False)
    assert torch.equal(more, again)


def test_random_init_and_per_centroid_cap(monkeypatch):
    """init="random" starts from distinct data rows; max_points_per_centroid
    trains on k * cap rows drawn without replacement, and the final
    assignment covers every row."""
    x = torch.from_numpy(_blobs(n=500, seed=4))
    seen = []
    real = kmeans._lloyd_iter

    def spy(train, centroids, **kw):
        seen.append((train.shape[0], centroids.clone()))
        return real(train, centroids, **kw)

    monkeypatch.setattr(kmeans, "_lloyd_iter", spy)
    res = kmeans.kmeans(torch.Generator().manual_seed(2), x, 4, niter=3,
                        max_points_per_centroid=50, init="random")
    assert [s for s, _ in seen] == [200, 200, 200]
    first = seen[0][1]
    assert len({tuple(r) for r in first.numpy()}) == 4
    assert all(bool((x == r).all(-1).any()) for r in first)
    assert res.assignments.shape == (500,)
    want, _ = kmeans.assign_clusters(x, res.centroids)
    assert torch.equal(res.assignments, want)
    again = kmeans.kmeans(torch.Generator().manual_seed(2), x, 4, niter=3,
                          max_points_per_centroid=50, init="random")
    assert torch.equal(again.assignments, res.assignments)


def test_cluster_corpus_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """Both CLIs from the same initial centroids: the same histogram JSON and
    byte-equal shards, which the port's ClusterPairDataset reads back."""
    x = _blobs(n=90, d=128, centers=4, seed=5)
    np.save(tmp_path / "emb.npy", x)
    with open(tmp_path / "pairs.jsonl", "w") as f:
        for i in range(90):
            f.write(json.dumps({"Question": f"what is about tok{i % 60}",
                                "Paragraph": f"tok{i % 60} tok{(i + 1) % 60}",
                                "Answer": f"tok{i % 60}"}) + "\n")
    _same_init(monkeypatch, [0, 1, 2, 3, 4])
    outs = {}
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        main(["cluster-corpus", "--embeddings", str(tmp_path / "emb.npy"),
              "--pairs", str(tmp_path / "pairs.jsonl"), "--output-dir", str(tmp_path / name),
              "--ncentroids", "5", "--niter", "6", *extra])
        outs[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert outs["torch"] == outs["jax"] and outs["torch"]["shards"] > 1
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "what", "is", "about"]
        + [f"tok{i}" for i in range(60)]) + "\n")
    tok = BertTokenizer.from_vocab_file(str(tmp_path / "vocab.txt"))
    ds = ClusterPairDataset(tok, str(tmp_path / "torch"), 12, 64)
    assert len(ds) == 90 and len(ds.index_clusters) == outs["torch"]["shards"]
    order = cluster_batch_order(ds, 4, random.Random(0))
    assert order and set(order) <= set(range(90))


@pytest.mark.parametrize("call", ["assign_clusters", "mips_scores"])
def test_f32_products_pin_tf32_off_per_call(monkeypatch, call):
    """Every f32 product of k-means and of the f32 search runs with TF32 off,
    whatever the caller set (the JAX package passes HIGHEST precision to each
    one), and the caller's settings come back after: a spy inside
    torch.matmul records both switches, set on before the call."""
    from proqa_tpu_torch.ops import mips

    seen = []
    real = torch.matmul

    def spy(*args, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(*args, **kw)

    x = torch.from_numpy(_blobs(n=64))
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        monkeypatch.setattr(torch, "matmul", spy)
        if call == "assign_clusters":
            kmeans.assign_clusters(x, x[:4], chunk=16)
        else:
            mips._scores(x[:3], x)
        monkeypatch.undo()
        assert seen and set(seen) == {(False, False)}
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == \
            (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_f32_pin_holds_across_threads(monkeypatch):
    """Two threads in f32 products at once: the first one's restore of the
    caller's TF32 switches must not land inside the second one's product.
    The first thread's spy waits (half a second at most) for the second to
    be inside its product, then returns; the second's spy records the
    switches once the first has finished. Pinned per block under one lock,
    the second product starts only after the first restored, so it still
    runs with TF32 off; without the lock it would read them turned on."""
    import threading

    from proqa_tpu_torch.ops.dot import dot_f32

    real = torch.matmul
    first_in, second_in, first_done = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def spy(*args, **kw):
        if not first_in.is_set():
            first_in.set()
            second_in.wait(timeout=0.5)
            seen["first"] = (torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32)
        else:
            second_in.set()
            first_done.wait(timeout=5)
            seen["second"] = (torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32)
        return real(*args, **kw)

    def first():
        dot_f32(x, x.T)
        first_done.set()

    def second():
        first_in.wait(timeout=5)
        dot_f32(x, x.T)

    x = torch.from_numpy(_blobs(n=16))
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        monkeypatch.setattr(torch, "matmul", spy)
        threads = [threading.Thread(target=first), threading.Thread(target=second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        monkeypatch.undo()
        assert not any(t.is_alive() for t in threads)
        assert seen == {"first": (False, False), "second": (False, False)}
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == \
            (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
