"""Port parity: block maxima (kernel K1), the block-max MIPS pipeline and
DenseIndex search, against the JAX package on the same numpy inputs (Pallas in
interpret mode)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from proqa_tpu.index.dense import DenseIndex as JaxDenseIndex  # noqa: E402
from proqa_tpu.index.idmap import IdMap as JaxIdMap  # noqa: E402
from proqa_tpu.ops import mips as jax_mips  # noqa: E402
from proqa_tpu.ops import pallas_mips  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.index.idmap import IdMap  # noqa: E402
from proqa_tpu_torch.ops import mips, mips_kernel  # noqa: E402
from proqa_tpu_torch.testing import topk_disagreements  # noqa: E402

# f32 scores of 128-d unit-scale rows: summation order moves them by ~1e-6
ATOL = 1e-4


def _data(q, n, d=128, seed=0, negative=False):
    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((q, d)).astype(np.float32) / np.sqrt(d)
    corpus = rng.standard_normal((n, d)).astype(np.float32) / np.sqrt(d)
    if negative:  # every real score < 0: an unmasked zero padding row would win
        queries, corpus = np.abs(queries), -np.abs(corpus)
    return queries, corpus


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_maxima_grouped_matches_jax(dtype):
    queries, corpus = _data(256, 2048)
    want = pallas_mips.block_maxima_grouped(
        jnp.asarray(queries, getattr(jnp, dtype)), jnp.asarray(corpus, getattr(jnp, dtype)),
        block=16, group=8, tile_q=256, interpret=True)
    got = mips_kernel.block_maxima_grouped(
        torch.from_numpy(queries).to(getattr(torch, dtype)),
        torch.from_numpy(corpus).to(getattr(torch, dtype)), block=16, group=8)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("k,n_valid,negative", [
    (1, None, False),
    (80, None, False),
    (80, 8192 - 1000 + 5, True),   # n_valid inside a block: the straddler patch
    (80, 50, True),                # k > n_valid: (NEG_INF, row 0) tail
])
def test_mips_topk_matches_jax(k, n_valid, negative):
    queries, corpus = _data(256, 8192, seed=k, negative=negative)
    jq, jc = jnp.asarray(queries), jnp.asarray(corpus)
    rv, ri = map(np.asarray, jax_mips.mips_topk_reference(jq, jc, k, n_valid=n_valid))
    pv, pi = pallas_mips.mips_topk_pallas_v2(
        jq, jc, k, block=16, group=128, tile_q=256, n_valid=n_valid, interpret=True)
    if n_valid is not None:
        pv, pi = jax_mips.sanitize_padding(pv, pi)
    pv, pi = np.asarray(pv), np.asarray(pi)
    gv, gi = mips.mips_topk(torch.from_numpy(queries), torch.from_numpy(corpus), k,
                            n_valid=n_valid)
    gv, gi = gv.numpy(), gi.numpy()
    assert gv.shape == gi.shape == (256, k)
    assert topk_disagreements(gv, gi, rv, ri, atol=ATOL) == 0
    assert topk_disagreements(gv, gi, pv, pi, atol=ATOL) == 0
    if n_valid is not None and n_valid < k:
        assert (gv[:, n_valid:] == mips.NEG_INF).all() and (gi[:, n_valid:] == 0).all()


def test_mips_topk_bf16_matches_jax_pipeline():
    queries, corpus = _data(256, 8192, seed=7)
    jq, jc = jnp.asarray(queries, jnp.bfloat16), jnp.asarray(corpus, jnp.bfloat16)
    pv, pi = map(np.asarray, pallas_mips.mips_topk_pallas_v2(
        jq, jc, 80, block=16, group=128, tile_q=256, interpret=True))
    gv, gi = mips.mips_topk(torch.from_numpy(queries).bfloat16(),
                            torch.from_numpy(corpus).bfloat16(), 80)
    assert topk_disagreements(gv.numpy(), gi.numpy(), pv, pi, atol=ATOL) == 0


def _full_mask_select(queries, corpus, k, *, block, group, n_valid, scales=None,
                      row_scales=None):
    """select_blocks's stage 2 as it was: the padding mask over every group,
    out of place, then every group maximum taken again."""
    q, n = queries.shape[0], corpus.shape[0]
    cg = -(-n // (group * block))
    nb = cg * group
    bounds = None
    if row_scales is not None:
        rs = row_scales.view(n // block, block)
        bounds = (rs.amax(dim=1), rs.amin(dim=1))
    bmax3, gmax = mips_kernel.block_maxima_grouped_reference(
        queries, corpus, block=block, group=group, scales=scales, scale_bounds=bounds)
    if n_valid != nb * block:
        block_ids = torch.arange(nb).view(cg, 1, group)
        bmax3 = bmax3.masked_fill(block_ids * block >= n_valid, mips.NEG_INF)
        if n_valid % block:
            sb, patched = mips_kernel._straddler_maxima(queries, corpus, block, n_valid, scales,
                                                        row_scales)
            bmax3[sb // group, :, sb % group] = patched
        gmax = bmax3.amax(dim=-1)[:, None, :]
    kb_g, kb_b = min(k, cg), min(k, nb)
    top_groups = mips.exact_topk(gmax.view(cg, q).T, kb_g).indices
    cand = bmax3[top_groups, torch.arange(q)[:, None]]
    sel = mips.exact_topk(cand.reshape(q, kb_g * group), kb_b).indices
    return torch.gather(top_groups, 1, sel // group) * group + sel % group


# block 16, group 4: 64 rows a group. (corpus rows, n_valid, groups masked)
TAIL_CASES = {
    "whole_groups": (640, 640, 0),
    "block_edge": (608, 608, 1),            # inside the last group, on a block edge
    "straddler": (624, 613, 1),             # inside the last group, inside a block
    "grown_tail": (768, 613, 3),            # two whole groups of capacity past it
    "below_one_group": (48, 37, 1),
}


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "scales", "row_scales"])
@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_tail_group_mask_matches_full_mask(case, kind):
    """select_blocks masks only the tail groups, in place: its block ids,
    and mips_topk_v2's values and rows, are those of the full mask over
    every group, over negative scores (an unmasked zero padding row would
    win), and tail_mask_groups counts the groups masked."""
    n, n_valid, groups = TAIL_CASES[case]
    block, group, k = 16, 4, 6
    queries, corpus = _data(40, n, seed=n_valid, negative=True)
    queries, corpus = torch.from_numpy(queries), torch.from_numpy(corpus)
    corpus[n_valid:] = 0  # padding rows, as an index's capacity tail holds
    kw = {}
    if kind in ("float32", "bfloat16"):
        queries, corpus = queries.to(getattr(torch, kind)), corpus.to(getattr(torch, kind))
    else:
        queries = queries.bfloat16()
        g = torch.Generator().manual_seed(n_valid)
        corpus = -torch.randint(1, 128, (n, corpus.shape[1]), generator=g, dtype=torch.int8)
        corpus[n_valid:] = 0
        count = n // block if kind == "scales" else n
        kw[kind] = torch.rand(count, generator=g) * 0.05 + 1e-3
    want_ids = _full_mask_select(queries, corpus, k, block=block, group=group,
                                 n_valid=n_valid, **kw)
    mips_kernel.tail_mask_groups = 0
    ids = mips_kernel.select_blocks(queries, corpus, k, block=block, group=group,
                                    n_valid=n_valid, **kw)
    assert mips_kernel.tail_mask_groups == groups
    assert torch.equal(ids, want_ids)

    vals, rows = mips_kernel.mips_topk_v2(queries, corpus, k, block=block, group=group,
                                          n_valid=n_valid, **kw)
    assert mips_kernel.tail_mask_groups == 2 * groups
    want_vals, want_rows = mips.rescore_block_candidates(
        queries, want_ids, corpus.view(n // block, block, -1), k=k, block=block,
        n_valid=n_valid, block_scales=kw.get("scales"), row_scales=kw.get("row_scales"))
    assert torch.equal(vals, want_vals) and torch.equal(rows, want_rows)
    assert (rows < n_valid).all() and (vals > mips.NEG_INF).all()
    if kind != "row_scales":  # selection by K7's bound is a heuristic
        rv, ri = mips.mips_topk_reference(
            queries, corpus, k, n_valid=n_valid,
            scales=None if "scales" not in kw else kw["scales"].repeat_interleave(block))
        assert topk_disagreements(vals.numpy(), rows.numpy(), rv.numpy(), ri.numpy(),
                                  atol=ATOL) == 0


@pytest.mark.parametrize("path", ["blockmax", "chunked"])
def test_other_search_paths_match_reference(path):
    queries, corpus = _data(64, 6000, seed=3, negative=True)
    tq, tc = torch.from_numpy(queries), torch.from_numpy(corpus)
    rv, ri = map(np.asarray, jax_mips.mips_topk_reference(
        jnp.asarray(queries), jnp.asarray(corpus), 40, n_valid=5990))
    if path == "blockmax":
        gv, gi = mips.mips_topk_blockmax(tq, tc, 40, block=64, q_chunk=32, n_valid=5990)
    else:
        gv, gi = mips.mips_topk_chunked_approx(tq, tc, 40, chunk=1024, n_valid=5990)
    assert topk_disagreements(gv.numpy(), gi.numpy(), rv, ri, atol=ATOL) == 0


def test_envelope_block_and_pad_queries_match_jax():
    for n in (8192, 4 << 20, 16 << 20, 67 << 20):
        assert mips.envelope_block(n) == jax_mips.envelope_block(n)
    padded, qn = mips.pad_queries(torch.ones(5, 4), 8)
    assert qn == 5 and padded.shape == (8, 4) and padded[5:].abs().sum() == 0


def test_topk_disagreements_allows_boundary_ties_only():
    va = np.array([[3.0, 2.0, 1.0]])
    assert topk_disagreements(va, np.array([[0, 1, 2]]), va, np.array([[0, 1, 7]]),
                                   atol=1e-6) == 0     # a tie at the k-th score
    assert topk_disagreements(va, np.array([[0, 1, 2]]), va, np.array([[0, 7, 2]]),
                                   atol=1e-6) == 1     # a swap above the boundary


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_index_search_matches_jax(tmp_path, dtype):
    queries, corpus = _data(300, 8003, seed=11)
    ids = [f"p{i}" for i in range(len(corpus))]
    jidx = JaxDenseIndex.from_embeddings(corpus, JaxIdMap(ids), dtype=getattr(jnp, dtype))
    tidx = DenseIndex.from_embeddings(corpus, IdMap(ids), device="cpu",
                                      dtype=getattr(torch, dtype))
    assert tidx.embeddings.shape == jidx.embeddings.shape  # padded to 1024 alike
    jv, ji, jids = jidx.search_ids(queries, 80)
    tv, ti, tids = tidx.search_ids(queries, 80)
    assert tv.dtype == np.float32 and ti.dtype == np.int32
    assert topk_disagreements(tv, ti, jv, ji, atol=ATOL) == 0
    assert [t[0] for t in tids] == [j[0] for j in jids]
    # the artifacts are shared: the port's save loads in the JAX package
    tidx.save(str(tmp_path / "idx"))
    back = JaxDenseIndex.load(str(tmp_path / "idx"), dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(back.embeddings[: back.n]),
                                  _np(tidx.embeddings[: tidx.n]))


def test_dense_index_small_and_unported(tmp_path):
    queries, corpus = _data(3, 10, seed=2)
    idx = DenseIndex.from_embeddings(corpus, device="cpu", dtype=torch.float32)
    vals, rows = idx.search(queries, 12)      # k beyond the row count
    jv, jr = JaxDenseIndex.from_embeddings(corpus, dtype=jnp.float32).search(queries, 12)
    np.testing.assert_allclose(vals, jv, atol=ATOL)
    np.testing.assert_array_equal(rows, jr)
    # live updates and the IVF view, once unported, now run on the small
    # index and match the JAX index (tests/test_torch_index_updates.py and
    # tests/test_torch_ivf.py hold them in full)
    jidx = JaxDenseIndex.from_embeddings(corpus, dtype=jnp.float32)
    extra = _data(1, 2, seed=5)[1]
    for i in (idx, jidx):
        i.add(extra)
        i.remove_rows([0])
    vals, rows = idx.search(queries, 12)
    jv, jr = jidx.search(queries, 12)
    np.testing.assert_allclose(vals, jv, atol=ATOL)
    np.testing.assert_array_equal(rows, jr)
    assert (idx.n, idx.version, len(idx.compact())) == (12, 2, 11)
    ivf = idx.compact().to_ivf(nlist=2, nprobe=2, niter=2)
    np.testing.assert_array_equal(ivf.search(queries, 5)[1], idx.compact().search(queries, 5)[1])


def test_idmap_file_is_byte_identical(tmp_path):
    ids = ["p0", "doc 1", "ü-3", "42"]
    IdMap(ids).save(str(tmp_path / "t.json"))
    JaxIdMap(ids).save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert IdMap.load(str(tmp_path / "j.json")).rows_to_ids([3, 0]) == ["42", "p0"]
    assert json.loads((tmp_path / "t.json").read_text())["2"] == "ü-3"
