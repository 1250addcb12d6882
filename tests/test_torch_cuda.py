"""The port's CUDA kernels against their plain PyTorch versions on the GPU.

Every test here needs an NVIDIA GPU and skips elsewhere. This file imports no
JAX, so it runs on the GPU machine, where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which that machine lacks.)
"""
import pytest

torch = pytest.importorskip("torch")

from proqa_tpu_torch.models.bert import BertConfig  # noqa: E402
from proqa_tpu_torch.models.retriever import Retriever  # noqa: E402
from proqa_tpu_torch.ops import (  # noqa: E402
    attention, fused_bert, mips, mips_kernel, quant, rescore,
)
from proqa_tpu_torch.testing import topk_disagreements  # noqa: E402

pytestmark = pytest.mark.cuda

# attention: see tests/test_torch_attention.py; encoder: tests/test_torch_bert.py;
# MIPS scores of unit-scale rows
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ENCODER_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MIPS_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attention_inputs(t, b, h, dh, device, dtype):
    g = torch.Generator().manual_seed(t + dh)
    q, k, v = (torch.randn(b, h, t, dh, generator=g).to(device, dtype) for _ in range(3))
    mask = torch.ones(b, t, dtype=torch.int32)
    mask[0, t // 3:] = 0
    mask[1] = 0  # all padding
    return q, k, v, mask.to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,dh", [(128, 64), (512, 64), (256, 16), (1024, 64), (128, 16),
                                  (128, 32), (512, 32), (256, 128), (1024, 128), (256, 48),
                                  (256, 256), (1024, 256), (128, 192), (256, 384), (128, 768),
                                  (384, 320)])
def test_attention_kernel_matches_plain(cuda, t, dh, dtype):
    q, k, v, mask = _attention_inputs(t, 3, 4, dh, cuda, getattr(torch, dtype))
    before = attention.launches
    got = attention.fused_attention(q, k, v, mask, sm_scale=dh ** -0.5)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention.fused_attention_reference(q, k, v, mask, sm_scale=dh ** -0.5)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_TOL[dtype], rtol=0)


def _mips_inputs(q, n, device, dtype, seed=0, negative=False):
    g = torch.Generator().manual_seed(seed)
    queries = torch.randn(q, 128, generator=g) / 128 ** 0.5
    corpus = torch.randn(n, 128, generator=g) / 128 ** 0.5
    if negative:
        queries, corpus = queries.abs(), -corpus.abs()
    return queries.to(device, dtype), corpus.to(device, dtype)


def _k1_counter(dtype: str) -> str:
    """K1's launch counter: f32 runs csrc/block_maxima_f32.cu, bf16 the rest."""
    return "f32_launches" if dtype == "float32" else "launches"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,block,group", [(300, 16, 128), (64, 32, 8), (2048, 16, 128)])
def test_block_maxima_kernel_matches_plain(cuda, q, block, group, dtype):
    queries, corpus = _mips_inputs(q, block * group * 3, cuda, getattr(torch, dtype), seed=q)
    before = getattr(mips_kernel, _k1_counter(dtype))
    got = mips_kernel.block_maxima_grouped(queries, corpus, block=block, group=group)
    torch.cuda.synchronize()
    assert getattr(mips_kernel, _k1_counter(dtype)) == before + 1
    want = mips_kernel.block_maxima_grouped_reference(queries, corpus, block=block, group=group)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=MIPS_ATOL, rtol=0)


@pytest.mark.parametrize("q", [1, 7, 32, 300, 2048])
@pytest.mark.parametrize("block", mips_kernel.WGMMA_BLOCKS)
@pytest.mark.parametrize("group", [8, 128])
def test_wgmma_block_maxima_match_plain(cuda, q, block, group):
    """K1's Hopper kernel (csrc/block_maxima_wgmma.cu) at every block it
    takes, one warpgroup (Q <= 64) and two, ragged query tiles; with group 8
    there are 20 groups, so a persistent block walks several."""
    assert mips_kernel.kernel_for(torch.bfloat16, torch.bfloat16, block=block, group=group,
                                  grouped=True, scaled=False) == "wgmma"
    groups = 20 if group == 8 else 3
    queries, corpus = _mips_inputs(q, block * group * groups, cuda, torch.bfloat16,
                                   seed=q + block + group)
    before = mips_kernel.launches
    got = mips_kernel.block_maxima_grouped(queries, corpus, block=block, group=group)
    torch.cuda.synchronize()
    assert mips_kernel.launches == before + 1
    want = mips_kernel.block_maxima_grouped_reference(queries, corpus, block=block, group=group)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=MIPS_ATOL, rtol=0)


@pytest.mark.parametrize("grown", [False, True], ids=["tight", "grown"])
@pytest.mark.parametrize("block", mips_kernel.WGMMA_BLOCKS)
def test_wgmma_pipeline_with_n_valid_inside_a_block(cuda, block, grown):
    """mips_topk_v2 through the Hopper K1 over a corpus whose last real row
    falls inside a block: the blocks past it are masked, the straddling one
    patched; every real score is negative, so an unmasked zero padding row
    would win. Grown: the corpus is a buffer of four groups, so the padding
    spans the rest of the second group and two whole groups, all three
    masked in place."""
    n_valid = 128 * block + 3 * block + block // 2
    n = 4 * 128 * block if grown else n_valid
    queries, corpus = _mips_inputs(64, n, cuda, torch.bfloat16, seed=block, negative=True)
    corpus[n_valid:] = 0
    before = mips_kernel.launches
    mips_kernel.tail_mask_groups = 0
    gv, gi = mips_kernel.mips_topk_v2(queries, corpus, 80, block=block, n_valid=n_valid)
    assert mips_kernel.launches == before + 1
    assert mips_kernel.tail_mask_groups == (3 if grown else 1)
    rv, ri = mips.mips_topk_reference(queries, corpus, 80, n_valid=n_valid)
    assert topk_disagreements(gv.cpu().numpy(), gi.cpu().numpy(), rv.cpu().numpy(),
                              ri.cpu().numpy(), atol=MIPS_ATOL) == 0
    assert (gi < n_valid).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mips_topk_on_gpu_matches_reference(cuda, dtype):
    queries, corpus = _mips_inputs(256, 9000, cuda, getattr(torch, dtype), seed=6,
                                   negative=True)
    before = getattr(mips_kernel, _k1_counter(dtype))
    gv, gi = mips.mips_topk(queries, corpus, 80, n_valid=8995)
    assert getattr(mips_kernel, _k1_counter(dtype)) == before + 1
    rv, ri = mips.mips_topk_reference(queries, corpus, 80, n_valid=8995)
    assert topk_disagreements(gv.cpu().numpy(), gi.cpu().numpy(), rv.cpu().numpy(),
                              ri.cpu().numpy(), atol=MIPS_ATOL) == 0
    assert (gi < 8995).all()


def test_kernels_reject_what_they_do_not_take(cuda):
    q, c = _mips_inputs(64, 2048, cuda, torch.bfloat16)
    # every width that is a multiple of 16 runs; another raises, naming it
    with pytest.raises(ValueError, match="D=72"):
        mips_kernel.block_maxima_grouped(q[:, :72].contiguous(), c[:, :72].contiguous(),
                                         block=16)
    with pytest.raises(TypeError):
        mips_kernel.block_maxima_grouped(q, c.float(), block=16)
    # every head dim runs (padded where no form is built for it): 160 as 256;
    # only a head dim that does not exist raises
    q, k, v, mask = _attention_inputs(128, 2, 2, 160, cuda, torch.bfloat16)
    got = attention.fused_attention(q, k, v, mask, sm_scale=0.1)
    want = attention.fused_attention_reference(q, k, v, mask, sm_scale=0.1)
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_TOL["bfloat16"], rtol=0)
    with pytest.raises(ValueError, match="head dim"):
        attention.kernel_head_dim(0)


# --- K1 over f32 (csrc/block_maxima_f32.cu) and K8 on the Hopper kernel ---

# f32 sums of 128 f32 products in another order than the plain version's
F32_BMAX_TOL = 1e-5


@pytest.mark.parametrize("q", [1, 64, 65, 200])
@pytest.mark.parametrize("block", [16, 32, 128, 256])
def test_f32_block_maxima_match_plain(cuda, block, q):
    """K1's f32 kernel at blocks 16-256 (256 spans two chunks), ragged query
    tiles, 20 groups of 8 blocks, so a persistent block walks several."""
    assert mips_kernel.kernel_for(torch.float32, torch.float32, block=block, group=8,
                                  grouped=True, scaled=False) == "f32"
    queries, corpus = _mips_inputs(q, block * 8 * 20, cuda, torch.float32, seed=q + block)
    before = mips_kernel.f32_launches
    got = mips_kernel.block_maxima_grouped(queries, corpus, block=block, group=8)
    torch.cuda.synchronize()
    assert mips_kernel.f32_launches == before + 1
    want = mips_kernel.block_maxima_grouped_reference(queries, corpus, block=block, group=8)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=F32_BMAX_TOL, rtol=0)


@pytest.mark.parametrize("block", [16, 256])
def test_f32_pipeline_with_n_valid_inside_a_block(cuda, block):
    """mips_topk_v2 over f32 through K1's f32 kernel, the last real row
    inside a block: every real score is negative, so an unmasked zero
    padding row would win."""
    n_valid = 128 * block + 3 * block + block // 2
    queries, corpus = _mips_inputs(64, n_valid, cuda, torch.float32, seed=block, negative=True)
    before = mips_kernel.f32_launches
    gv, gi = mips_kernel.mips_topk_v2(queries, corpus, 80, block=block, n_valid=n_valid)
    assert mips_kernel.f32_launches == before + 1
    rv, ri = mips.mips_topk_reference(queries, corpus, 80, n_valid=n_valid)
    assert topk_disagreements(gv.cpu().numpy(), gi.cpu().numpy(), rv.cpu().numpy(),
                              ri.cpu().numpy(), atol=F32_BMAX_TOL) == 0
    assert (gi < n_valid).all()


@pytest.mark.parametrize("q", [1, 64, 65, 200])
@pytest.mark.parametrize("block,tile_n", [(16, 128), (16, 2048), (64, 128), (64, 2048),
                                          (256, 2048)])
def test_wgmma_block_major_matches_plain(cuda, block, tile_n, q):
    """K8 on the Hopper kernel (the block-major store), one warpgroup and
    two, ragged query tiles; 40 tiles of 128 rows or 5 of 2,048, so a
    persistent block walks several. The tolerance is MIPS_ATOL (f32 sums of
    128 bf16 products in another order)."""
    assert mips_kernel.kernel_for(torch.bfloat16, torch.bfloat16, block=block,
                                  group=tile_n // block, grouped=False, scaled=False) == "wgmma"
    tiles = 40 if tile_n == 128 else 5
    queries, corpus = _mips_inputs(q, tile_n * tiles, cuda, torch.bfloat16, seed=q + block)
    before = mips_kernel.block_major_launches
    got = mips_kernel.block_maxima(queries, corpus, block=block, tile_n=tile_n)
    torch.cuda.synchronize()
    assert mips_kernel.block_major_launches == before + 1
    assert got.shape == (tile_n * tiles // block, q)
    torch.testing.assert_close(got, mips_kernel.block_maxima_reference(
        queries, corpus, block=block, tile_n=tile_n), atol=MIPS_ATOL, rtol=0)


@pytest.mark.parametrize("block,tile_n", [(256, 2048), (16, 128)])
def test_v1_topk_matches_exact(cuda, block, tile_n):
    """mips_topk_v1 through K8's Hopper kernel at a ragged N of negative
    scores (the padding must never win) against the exact top-80."""
    queries, corpus = _mips_inputs(200, 9000, cuda, torch.bfloat16, seed=block, negative=True)
    before = mips_kernel.block_major_launches
    gv, gi = mips_kernel.mips_topk_v1(queries, corpus, 80, block=block, tile_n=tile_n,
                                      n_valid=8995)
    assert mips_kernel.block_major_launches == before + 1
    rv, ri = mips.mips_topk_reference(queries, corpus, 80, n_valid=8995)
    assert topk_disagreements(gv.cpu().numpy(), gi.cpu().numpy(), rv.cpu().numpy(),
                              ri.cpu().numpy(), atol=MIPS_ATOL) == 0
    assert (gi < 8995).all()


@pytest.mark.parametrize("entry", ["proqa_block_maxima_f32",
                                   "proqa_block_maxima_wgmma_block_major"])
def test_hopper_block_maxima_entry_points_reject_what_they_do_not_take(cuda, entry):
    """The two entry points' own checks: a block outside 16-256, a group of
    64 rows, N not a multiple of a block (a partial last group runs), D not
    a multiple of 16; each launch is refused with an error, never run."""
    from proqa_tpu_torch import _build

    dtype = torch.float32 if entry.endswith("f32") else torch.bfloat16
    q, c = _mips_inputs(64, 4096, cuda, dtype)
    out = torch.empty(4096 * 64, device=cuda)
    extra = (out.data_ptr(),) if entry.endswith("f32") else ()  # gmax
    for n, dim, block, group in ((4096, 128, 8, 16), (4096, 128, 16, 4), (4008, 128, 16, 8),
                                 (4096, 72, 16, 8)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.launch(entry, q.device, q.data_ptr(), c.data_ptr(), out.data_ptr(), *extra,
                          64, n, dim, block, group)
    torch.cuda.synchronize()


# --- the search family: K5, K7, K8 and K6/K9 ---


def _int8_inputs(q, n, block, device, qdtype, seed, per_row=False):
    """Codes and scales of rows of varied norm, and queries of qdtype."""
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn(n, 128, generator=g) * torch.empty(n, 1).uniform_(0.25, 4.0, generator=g)
    codes, sc = quant.quantize_rows(emb.numpy(), block=1 if per_row else block)
    queries = torch.randn(q, 128, generator=g)
    return (queries.to(device, qdtype), torch.from_numpy(codes).to(device),
            torch.from_numpy(sc).to(device))


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["scales", "scale_bounds"])
@pytest.mark.parametrize("q,block,group", [(300, 16, 128), (64, 32, 8), (2048, 128, 128)])
def test_int8_block_maxima_kernels_match_plain(cuda, kind, q, block, group, qdtype):
    """K5 (per-block scales) and K7 (per-row scale bounds) against their
    plain version, on int8 codes with ragged query counts."""
    per_row = kind == "scale_bounds"
    queries, codes, sc = _int8_inputs(q, block * group * 3, block, cuda,
                                      getattr(torch, qdtype), seed=q + block, per_row=per_row)
    if per_row:
        rs = sc.view(-1, block)
        kw = {"scale_bounds": (rs.amax(dim=1), rs.amin(dim=1))}
    else:
        kw = {"scales": sc}
    counter = "bounded_launches" if per_row else "scaled_launches"
    before = getattr(mips_kernel, counter)
    got = mips_kernel.block_maxima_grouped(queries, codes, block=block, group=group, **kw)
    torch.cuda.synchronize()
    assert getattr(mips_kernel, counter) == before + 1
    want = mips_kernel.block_maxima_grouped_reference(queries, codes, block=block, group=group,
                                                      **kw)
    # scores of ~100 (norms up to 4 x 127 codes): f32 sums in another order
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=MIPS_ATOL * 100, rtol=1e-6)


def _int8_kwargs(kind, sc, block):
    """The keywords of K5 (per-block scales) or K7 (bounds of per-row scales)."""
    if kind == "scales":
        return {"scales": sc}, "scaled_launches"
    rs = sc.view(-1, block)
    return {"scale_bounds": (rs.amax(dim=1), rs.amin(dim=1))}, "bounded_launches"


@pytest.mark.parametrize("kind", ["scales", "scale_bounds"])
@pytest.mark.parametrize("q", [1, 7, 32, 300, 2048])
@pytest.mark.parametrize("block", mips_kernel.WGMMA_BLOCKS)
@pytest.mark.parametrize("group", [8, 128])
def test_wgmma_int8_block_maxima_match_plain(cuda, q, block, group, kind):
    """K5 and K7 on the Hopper kernel (csrc/block_maxima_wgmma.cu: int8
    codes widened to bf16 by the producer warpgroup, the epilogue on the
    accumulators) at every block it takes, one warpgroup and two, ragged
    query tiles; with group 8 a persistent block walks several groups. The
    tolerance is test_int8_block_maxima_kernels_match_plain's."""
    assert mips_kernel.kernel_for(torch.bfloat16, torch.int8, block=block, group=group,
                                  grouped=True, scaled=True) == "wgmma"
    groups = 20 if group == 8 else 3
    queries, codes, sc = _int8_inputs(q, block * group * groups, block, cuda, torch.bfloat16,
                                      seed=q + block + group, per_row=kind == "scale_bounds")
    kw, counter = _int8_kwargs(kind, sc, block)
    before = getattr(mips_kernel, counter)
    got = mips_kernel.block_maxima_grouped(queries, codes, block=block, group=group, **kw)
    torch.cuda.synchronize()
    assert getattr(mips_kernel, counter) == before + 1
    want = mips_kernel.block_maxima_grouped_reference(queries, codes, block=block, group=group,
                                                      **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=MIPS_ATOL * 100, rtol=1e-6)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    print(f"K{5 if kind == 'scales' else 7} q={q} block={block} group={group}: "
          f"max abs err {err:.3g}")


@pytest.mark.parametrize("kind", ["scales", "scale_bounds"])
@pytest.mark.parametrize("block", mips_kernel.WGMMA_BLOCKS)
def test_wgmma_int8_edge_inputs(cuda, block, kind):
    """Codes at +-127 (the widening's extremes, and -128), all-zero blocks
    with scale 1, and blocks whose every score is below zero (K7's smin
    branch), for 300 queries of one sign."""
    group = 8
    n = block * group * 4
    nb = n // block
    g = torch.Generator().manual_seed(block)
    codes = torch.randint(-127, 128, (nb, block, 128), generator=g, dtype=torch.int8)
    codes[0::4] = 127 * torch.sign(torch.randn(codes[0::4].shape, generator=g)).to(torch.int8)
    codes[1::4] = 0
    codes[2::4] = -codes[2::4].abs()           # scores <= 0 against positive queries
    codes[3, 0] = -128
    codes = codes.view(n, 128).to(cuda)
    queries = (torch.rand(300, 128, generator=g) / 128 ** 0.5).to(cuda, torch.bfloat16)
    if kind == "scales":
        sc = torch.rand(nb, generator=g) * 0.05 + 1e-3
        sc[1::4] = 1.0
    else:
        sc = torch.rand(n, generator=g) * 0.05 + 1e-3
        sc.view(nb, block)[1::4] = 1.0
    kw, counter = _int8_kwargs(kind, sc.to(cuda), block)
    before = getattr(mips_kernel, counter)
    got = mips_kernel.block_maxima_grouped(queries, codes, block=block, group=group, **kw)
    torch.cuda.synchronize()
    assert getattr(mips_kernel, counter) == before + 1
    want = mips_kernel.block_maxima_grouped_reference(queries, codes, block=block, group=group,
                                                      **kw)
    assert (want[0] < 0).any() and (want[0] == 0).any()
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=MIPS_ATOL * 100, rtol=1e-6)


@pytest.mark.parametrize("kind", ["scales", "row_scales"])
@pytest.mark.parametrize("block", mips_kernel.WGMMA_BLOCKS)
def test_wgmma_int8_pipeline_with_n_valid_inside_a_block(cuda, block, kind):
    """mips_topk_v2 over int8 codes through the Hopper K5 / K7, the last
    real row inside a block: every real score is negative, so an unmasked
    zero padding row would win. K5's top-80 is the exact top-80 of the
    scaled codes; K7's values are the exact row-scaled scores of its rows."""
    n_valid = 128 * block + 3 * block + block // 2
    g = torch.Generator().manual_seed(block + 1)
    codes = -torch.randint(1, 128, (n_valid, 128), generator=g, dtype=torch.int8)
    queries = (torch.rand(64, 128, generator=g) / 128 ** 0.5).to(cuda, torch.bfloat16)
    codes = codes.to(cuda)
    if kind == "scales":
        sc = (torch.rand(-(-n_valid // block), generator=g) * 0.05 + 1e-3).to(cuda)
        before = mips_kernel.scaled_launches
        gv, gi = mips_kernel.mips_topk_v2(queries, codes, 80, block=block, n_valid=n_valid,
                                          scales=sc)
        assert mips_kernel.scaled_launches == before + 1
        rows = quant.expand_scales(sc, block, n_valid)
        rv, ri = mips.mips_topk_reference(queries, codes, 80, n_valid=n_valid, scales=rows)
        assert topk_disagreements(gv.cpu().numpy(), gi.cpu().numpy(), rv.cpu().numpy(),
                                  ri.cpu().numpy(), atol=MIPS_ATOL * 100) == 0
    else:
        rs = (torch.rand(n_valid, generator=g) * 0.05 + 1e-3).to(cuda)
        before = mips_kernel.bounded_launches
        gv, gi = mips_kernel.mips_topk_v2(queries, codes, 20, block=block, n_valid=n_valid,
                                          row_scales=rs, kb=320)
        assert mips_kernel.bounded_launches == before + 1
        exact = torch.gather(mips.dot_f32(queries, codes.bfloat16().T) * rs, 1, gi)
        torch.testing.assert_close(gv, exact, atol=MIPS_ATOL * 100, rtol=1e-6)
    assert (gi < n_valid).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,block,tile_n", [(300, 256, 2048), (64, 16, 128)])
def test_block_major_kernel_matches_plain(cuda, q, block, tile_n, dtype):
    """K8 against its plain version."""
    queries, corpus = _mips_inputs(q, tile_n * 3, cuda, getattr(torch, dtype), seed=q)
    before = mips_kernel.block_major_launches
    got = mips_kernel.block_maxima(queries, corpus, block=block, tile_n=tile_n)
    torch.cuda.synchronize()
    assert mips_kernel.block_major_launches == before + 1
    assert got.shape == (tile_n * 3 // block, q)
    torch.testing.assert_close(got, mips_kernel.block_maxima_reference(
        queries, corpus, block=block, tile_n=tile_n), atol=MIPS_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,nb,block,kb", [(300, 512, 16, 80), (7, 40, 64, 3), (64, 100, 1, 33)])
def test_gather_score_kernel_matches_plain(cuda, q, nb, block, kb, dtype):
    """K6 and K9 (one kernel, two counters) against their plain version."""
    g = torch.Generator().manual_seed(nb)
    corpus = torch.randn(nb, block, 128, generator=g).to(cuda, getattr(torch, dtype))
    queries = torch.randn(q, 128, generator=g).to(cuda, getattr(torch, dtype))
    ids = torch.randint(0, nb, (q, kb), generator=g).to(cuda)
    want = rescore.gather_rescore_reference(queries, corpus, ids, block=block)
    for fn, counter in ((rescore.gather_rescore, "launches"),
                        (rescore.gather_score, "score_launches")):
        before = getattr(rescore, counter)
        got = fn(queries, corpus, ids, block=block)
        torch.cuda.synchronize()
        assert getattr(rescore, counter) == before + 1
        torch.testing.assert_close(got, want, atol=MIPS_ATOL * 10, rtol=1e-6)


# K6/K9 on the ring kernel against the plain gather and product: f32 sums of
# 128 exact products of unit-scale rows in another order (~1e-7 apart)
BMAX_TOL = 1e-4


def _rescore_inputs(q, nb, block, kb, device, dtype, seed):
    """Unit-scale rows and queries; ids with the last block NB - 1 and a
    repeat in every query, and query 1 asking for query 0's blocks."""
    g = torch.Generator().manual_seed(seed)
    corpus = (torch.randn(nb, block, 128, generator=g) / 128 ** 0.5).to(device, dtype)
    queries = (torch.randn(q, 128, generator=g) / 128 ** 0.5).to(device, dtype)
    ids = torch.randint(0, nb, (q, kb), generator=g)
    ids[:, 0] = nb - 1
    if kb > 1:
        ids[:, -1] = ids[:, 0]
    if q > 1:
        ids[1] = ids[0]
    return queries, corpus, ids.to(device)


def _rescore_reference(queries, corpus, ids, block, chunk=64):
    """The plain version, a chunk of queries at a time (its [Q, kb, block,
    D] f32 gather would not fit at Q = 2,048, block 256)."""
    return torch.cat([rescore.gather_rescore_reference(queries[s:s + chunk], corpus,
                                                       ids[s:s + chunk], block=block)
                      for s in range(0, queries.shape[0], chunk)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kb", [1, 3, 80])
@pytest.mark.parametrize("block", [16, 64, 256])
@pytest.mark.parametrize("q", [1, 5, 256, 2048])
def test_gather_rescore_ring_matches_plain(cuda, q, block, kb, dtype):
    queries, corpus, ids = _rescore_inputs(q, 2 * kb + 37, block, kb, cuda,
                                           getattr(torch, dtype), seed=q + block + kb)
    want = _rescore_reference(queries, corpus, ids, block)
    for fn, counter in ((rescore.gather_rescore, "launches"),
                        (rescore.gather_score, "score_launches")):
        before = getattr(rescore, counter)
        got = fn(queries, corpus, ids, block=block)
        torch.cuda.synchronize()
        assert getattr(rescore, counter) == before + 1
        assert got.shape == (q, kb * block) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=BMAX_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rescore_ring_on_a_row_offset_view(cuda, dtype):
    """A corpus that starts 3 rows and 8 elements into its storage (16-byte
    aligned, not row aligned) and ends before the storage does."""
    queries, corpus, ids = _rescore_inputs(300, 90, 16, 80, cuda, getattr(torch, dtype), seed=3)
    offset = 3 * 128 + 8
    storage = torch.zeros((90 * 16 + 8) * 128, device=cuda, dtype=corpus.dtype)
    storage[offset:offset + corpus.numel()] = corpus.flatten()
    view = storage[offset:offset + corpus.numel()].view(90, 16, 128)
    row_bytes = 128 * corpus.element_size()
    assert view.data_ptr() % 16 == 0 and (view.data_ptr() - storage.data_ptr()) % row_bytes
    want = _rescore_reference(queries, corpus, ids, 16)
    for fn in (rescore.gather_rescore, rescore.gather_score):
        torch.testing.assert_close(fn(queries, view, ids, block=16), want, atol=BMAX_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_index_search_rescores_through_k6(cuda, dtype):
    """A bf16 and an f32 DenseIndex.search on CUDA launch K6 once, and their
    top-80 equals the take rescore's up to equal-score ties."""
    from proqa_tpu_torch.index.dense import DenseIndex

    queries, corpus = _mips_inputs(200, 9000, cuda, getattr(torch, dtype), seed=11)
    index = DenseIndex.from_embeddings(corpus, device=cuda, dtype=getattr(torch, dtype))
    before = rescore.launches
    gv, gi = index.search(queries, 80)
    assert rescore.launches == before + 1
    padded, _ = mips.pad_queries(queries, 256)
    tv, ti = mips_kernel.mips_topk_v2(padded, index.embeddings, 80, block=16, n_valid=index.n,
                                      rescore_impl="take")
    assert rescore.launches == before + 1
    assert topk_disagreements(gv, gi, tv[:200].cpu().numpy(), ti[:200].cpu().numpy(),
                              atol=MIPS_ATOL) == 0


def test_int8_and_stream_pipelines_on_gpu(cuda):
    """mips_topk over int8 codes (K5) and mips_topk_v2 with the streamed
    rescore (K6), v1 (K8) and per-row bounds (K7) at a ragged N, against
    their exact references."""
    queries, codes, sc = _int8_inputs(256, 9000, 16, cuda, torch.bfloat16, seed=7)
    before = mips_kernel.scaled_launches
    gv, gi = mips.mips_topk(queries, codes, 80, n_valid=8995, scales=sc, quant_block=16)
    assert mips_kernel.scaled_launches == before + 1
    rows = quant.expand_scales(sc, 16, 9000)
    rv, ri = mips.mips_topk_reference(queries, codes, 80, n_valid=8995, scales=rows)
    assert topk_disagreements(gv.cpu().numpy(), gi.cpu().numpy(), rv.cpu().numpy(),
                              ri.cpu().numpy(), atol=MIPS_ATOL * 100) == 0

    queries, corpus = _mips_inputs(256, 9000, cuda, torch.bfloat16, seed=8, negative=True)
    rv, ri = mips.mips_topk_reference(queries, corpus, 80, n_valid=8995)
    before = rescore.launches, mips_kernel.block_major_launches
    for got in (mips_kernel.mips_topk_v2(queries, corpus, 80, block=16, n_valid=8995,
                                         rescore_impl="stream"),
                mips_kernel.mips_topk_v1(queries, corpus, 80, n_valid=8995)):
        assert topk_disagreements(got[0].cpu().numpy(), got[1].cpu().numpy(), rv.cpu().numpy(),
                                  ri.cpu().numpy(), atol=MIPS_ATOL) == 0
    # v1 rescores through K6 too (its default rescore on CUDA over bf16)
    assert (rescore.launches, mips_kernel.block_major_launches) == (before[0] + 2, before[1] + 1)

    queries, codes, rs = _int8_inputs(256, 9000, 16, cuda, torch.bfloat16, seed=9, per_row=True)
    before = mips_kernel.bounded_launches
    gv, gi = mips_kernel.mips_topk_v2(queries, codes, 20, block=16, row_scales=rs, kb=320)
    assert mips_kernel.bounded_launches == before + 1
    exact = torch.gather(mips.dot_f32(queries, codes.bfloat16().T) * rs, 1, gi)
    torch.testing.assert_close(gv, exact, atol=MIPS_ATOL * 100, rtol=1e-6)


def test_search_kernels_reject_what_they_do_not_take(cuda):
    q, c = _mips_inputs(64, 2048, cuda, torch.bfloat16)
    codes = torch.zeros(2048, 128, dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):   # int16 is neither the queries' dtype nor int8
        mips_kernel.block_maxima_grouped(q, codes.to(torch.int16), block=16)
    with pytest.raises(ValueError, match="per-block scales"):
        mips_kernel.block_maxima_grouped(q, codes, block=16, scales=torch.ones(64, device=cuda))
    with pytest.raises(ValueError, match="not both"):
        mips_kernel.block_maxima_grouped(q, codes, block=16, scales=torch.ones(128, device=cuda),
                                         scale_bounds=(torch.ones(128, device=cuda),) * 2)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        mips_kernel.block_maxima(q, c[:1000], block=256)
    with pytest.raises(ValueError, match="D=72"):
        mips_kernel.block_maxima(q[:, :72].contiguous(), c[:, :72].contiguous(), block=16,
                                 tile_n=128)
    ids = torch.zeros(64, 4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        rescore.gather_rescore(q, c.float().view(128, 16, 128), ids, block=16)
    with pytest.raises(TypeError):
        rescore.gather_score(q, c.view(128, 16, 128), ids.float(), block=16)
    with pytest.raises(ValueError, match="D=72"):
        rescore.gather_rescore(q[:, :72].contiguous(), c[:, :72].contiguous().view(128, 16, 72),
                               ids, block=16)
    with pytest.raises(ValueError, match="D=4112"):   # an f32 row past 16 KB
        wide = torch.zeros(16, 4112, device=cuda)
        rescore.gather_rescore(wide[:4], wide.view(1, 16, 4112), ids[:4, :1], block=16)
    with pytest.raises(ValueError, match="corpus_blocked"):
        rescore.gather_rescore(q, c.view(64, 32, 128), ids, block=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_towers_on_gpu_match_cpu(cuda, dtype):
    """The GPU path (K2, f32-output bf16 GEMMs) against the CPU path, which
    tests/test_torch_bert.py holds to the JAX package."""
    cfg = BertConfig.tiny(max_position_embeddings=128, flash_attention=True,
                          dtype=getattr(torch, dtype))
    model = Retriever(cfg).reset_parameters(0).eval()
    g = torch.Generator().manual_seed(1)
    for tower, t in (("context", 128), ("query", 30)):
        ids = torch.randint(5, 128, (4, t), generator=g)
        mask = (torch.arange(t)[None] < torch.tensor([t, t // 2, 7, 0])[:, None]).to(torch.int32)
        ids = ids * mask
        with torch.no_grad():
            want = getattr(model.cpu(), f"encode_{tower}")(ids, mask)
            before = attention.launches
            got = getattr(model.to(cuda), f"encode_{tower}")(ids.to(cuda), mask.to(cuda))
        assert attention.launches - before == (cfg.num_layers if t % 128 == 0 else 0)
        torch.testing.assert_close(got.cpu(), want, atol=ENCODER_TOL[dtype], rtol=0)


@pytest.mark.parametrize("heads", [12, 8, 2, 1])
def test_towers_at_head_dims_on_gpu_match_cpu(cuda, heads):
    """Two layers at MiniLM's widths (hidden 384, intermediate 1,536): 12
    heads of 32, which K2/K3 are built for, and 8 heads of 48, which the
    encoder pads to 64 in its copy of q, k and v; 2 heads of 192 (padded to
    256) and 1 of 384 (the loop forms). f32, dropout 0: the card's
    embeddings, loss and gradients against the CPU's plain versions (held
    to the JAX package by tests/test_torch_head_dims.py), one K2 and one K3
    launch a context layer."""
    from proqa_tpu_torch.train.retriever_trainer import in_batch_loss

    cfg = BertConfig(vocab_size=128, hidden_size=384, num_layers=2, num_heads=heads,
                     intermediate_size=1536, max_position_embeddings=128, flash_attention=True,
                     dtype=torch.float32, hidden_dropout=0.0, attention_dropout=0.0)
    g = torch.Generator().manual_seed(6)
    batch = {"input_ids_q": torch.randint(5, 128, (8, 16), generator=g),
             "input_ids_c": torch.randint(5, 128, (8, 128), generator=g),
             "input_mask_q": torch.ones(8, 16, dtype=torch.int32)}
    batch["input_mask_c"] = (torch.arange(128)[None] < torch.arange(60, 124, 8)[:, None]).int()
    results = []
    for device in ("cpu", cuda):
        model = Retriever(cfg).reset_parameters(0).to(device).train()
        fwd, bwd = attention.launches, attention.backward_launches
        out = model({k: v.to(device) for k, v in batch.items()},
                    generator=torch.Generator().manual_seed(0))
        loss, _ = in_batch_loss(out)
        loss.backward()
        if device != "cpu":  # the context tower at T = 128; queries at T = 16 are vanilla
            assert (attention.launches - fwd, attention.backward_launches - bwd) == (2, 2)
        results.append((loss.item(), out["c"].detach().cpu(),
                        {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
    (loss_c, emb_c, grads_c), (loss_g, emb_g, grads_g) = results
    assert abs(loss_c - loss_g) < 1e-5
    torch.testing.assert_close(emb_g, emb_c, atol=ENCODER_TOL["float32"], rtol=0)
    for k, gc in grads_c.items():
        # zero in exact arithmetic, rounding noise on both devices
        # (test_train_step_on_gpu_matches_cpu, tests/test_torch_train.py)
        if k == "proj_c.bias" or k.endswith(".k.bias"):
            continue
        torch.testing.assert_close(grads_g[k], gc, atol=1e-4 * gc.abs().max().item() + 1e-9,
                                   rtol=0, msg=k)


# --- the training slice: K4 dropout, K2 with dropout, K3, dot_f32's gradient ---

# K3's outputs are bf16 (or f32) sums over T products; the kernel recomputes
# the scores with the key and query roles swapped for dk and dv, so a
# summation-order difference can flip a bf16 rounding of ds or pd before the
# product: a few bf16 ulps of outputs of magnitude ~1 (f32: f32 noise)
BWD_TOL = {"float32": 1e-4, "bfloat16": 6e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(80, 512, 768), (80, 12, 32, 32), (7, 13)])
def test_dropout_kernel_is_bit_equal_to_plain(cuda, shape, dtype):
    from proqa_tpu_torch.ops import dropout as drop

    g = torch.Generator().manual_seed(len(shape))
    x = torch.randn(*shape, generator=g).to(cuda, getattr(torch, dtype))
    before = drop.launches
    got = drop.dropout(x, 0.1, seed=2**40 + 7)
    torch.cuda.synchronize()
    assert drop.launches == before + 1
    want = drop.dropout_reference(x, 0.1, seed=2**40 + 7)
    assert torch.equal(got, want)
    kept = (got != 0).float().mean().item()
    n = x.numel()
    assert abs(kept - 0.9) <= 5 * (0.09 / n) ** 0.5 + 1e-6
    # backward: the same mask applied to the cotangent
    xr = x.clone().requires_grad_(True)
    gy = torch.randn(*shape, generator=g).to(cuda, x.dtype)
    drop.dropout(xr, 0.1, seed=2**40 + 7).backward(gy)
    assert torch.equal(xr.grad, drop.dropout_reference(gy, 0.1, seed=2**40 + 7))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(80, 512, 768), (7, 13), "unaligned"])
def test_dropout_kernel_without_autograd(cuda, shape, dtype):
    """The launch that skips the autograd node (grad mode off, or an input
    that needs no gradient) is bit-equal to the plain version; an input that
    is not 16-byte aligned takes the element-at-a-time kernel."""
    from proqa_tpu_torch.ops import dropout as drop

    g = torch.Generator().manual_seed(5)
    if shape == "unaligned":
        x = torch.randn(1001, generator=g).to(cuda, getattr(torch, dtype))[1:]
        assert x.data_ptr() % 16
    else:
        x = torch.randn(*shape, generator=g).to(cuda, getattr(torch, dtype))
    want = drop.dropout_reference(x, 0.1, seed=2**33 + 1)
    xr = x.clone().requires_grad_(True)
    before = drop.launches
    with torch.no_grad():
        got_no_grad = drop.dropout(xr, 0.1, seed=2**33 + 1)
    got_plain = drop.dropout(x, 0.1, seed=2**33 + 1)
    torch.cuda.synchronize()
    assert drop.launches == before + 2
    assert got_no_grad.grad_fn is None and got_plain.grad_fn is None
    assert torch.equal(got_no_grad, want) and torch.equal(got_plain, want)
    # with autograd: the backward applies the forward's mask
    gy = torch.randn(x.shape, generator=g).to(cuda, x.dtype)
    drop.dropout(xr, 0.1, seed=2**33 + 1).backward(gy)
    assert torch.equal(xr.grad, drop.dropout_reference(gy, 0.1, seed=2**33 + 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,dh", [(128, 64), (512, 64), (256, 16), (256, 32), (512, 128),
                                  (128, 48), (512, 256), (128, 384)])
def test_attention_dropout_kernel_matches_plain(cuda, t, dh, dtype):
    q, k, v, mask = _attention_inputs(t, 3, 4, dh, cuda, getattr(torch, dtype))
    got = attention.fused_attention(q, k, v, mask, sm_scale=dh ** -0.5, dropout_rate=0.1,
                                    seed=99)
    want = attention.fused_attention_reference(q, k, v, mask, sm_scale=dh ** -0.5,
                                               dropout_rate=0.1, seed=99)
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_TOL[dtype], rtol=0)
    other = attention.fused_attention(q, k, v, mask, sm_scale=dh ** -0.5, dropout_rate=0.1,
                                      seed=100)
    assert not torch.equal(got, other)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,dh", [(128, 64), (512, 64), (256, 16), (1024, 64), (128, 32),
                                  (512, 32), (256, 128), (1024, 128), (256, 48), (256, 256),
                                  (1024, 256), (128, 192), (256, 384), (128, 768), (384, 320)])
def test_attention_backward_kernel_matches_plain(cuda, t, dh, dtype, rate):
    q, k, v, mask = _attention_inputs(t, 2, 3, dh, cuda, getattr(torch, dtype))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(cuda, q.dtype)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    before = attention.backward_launches
    out = attention.fused_attention(qr, kr, vr, mask, sm_scale=dh ** -0.5, dropout_rate=rate,
                                    seed=11)
    out.backward(do)
    torch.cuda.synchronize()
    assert attention.backward_launches == before + 1
    want = attention.fused_attention_backward_reference(q, k, v, mask, do, sm_scale=dh ** -0.5,
                                                        dropout_rate=rate, seed=11)
    for got, w in zip((qr.grad, kr.grad, vr.grad), want):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), w.float(), atol=BWD_TOL[dtype], rtol=0)


def _edge_inputs(t, dh, device, dtype):
    """Padding that starts inside a 64-key tile (row 0 at key 100, row 2 at
    T - 37, in the last tile) and one all-padding row (row 1)."""
    g = torch.Generator().manual_seed(3 * t + dh)
    q, k, v, do = (torch.randn(3, 2, t, dh, generator=g).to(device, dtype) for _ in range(4))
    mask = torch.ones(3, t, dtype=torch.int32)
    mask[0, 100:] = 0
    mask[1] = 0
    mask[2, t - 37:] = 0
    return q, k, v, do, mask.to(device)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [16, 64, 32, 128, 256, 384])
@pytest.mark.parametrize("t", [128, 384, 640, 1024])
def test_attention_kernels_at_tile_edges(cuda, t, dh, dtype, rate):
    """K2 and K3 at sequence lengths that are odd multiples of 64 keys of a
    128-row block (384, 640) and at both ends of the range."""
    q, k, v, do, mask = _edge_inputs(t, dh, cuda, getattr(torch, dtype))
    kw = dict(sm_scale=dh ** -0.5, dropout_rate=rate, seed=2**33 + t)
    got = attention.fused_attention(q, k, v, mask, **kw)
    want = attention.fused_attention_reference(q, k, v, mask, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_TOL[dtype], rtol=0)
    grads = attention._backward_kernel(q, k, v, mask, do, kw["sm_scale"], rate, kw["seed"])
    want = attention.fused_attention_backward_reference(q, k, v, mask, do, **kw)
    for g, w in zip(grads, want):
        assert torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), atol=BWD_TOL[dtype], rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_backward_kernel_is_deterministic(cuda, dtype, rate):
    """K3 uses no atomics: two launches on the same inputs give the same bits."""
    q, k, v, do, mask = _edge_inputs(384, 64, cuda, getattr(torch, dtype))
    first = attention._backward_kernel(q, k, v, mask, do, 0.125, rate, 77)
    second = attention._backward_kernel(q, k, v, mask, do, 0.125, rate, 77)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [32, 128, 48, 256, 192, 384])
def test_attention_backward_kernel_is_deterministic_at_head_dim(cuda, dh, dtype, rate):
    """The same at the head dims added after 16 and 64, built (32, 128, 256),
    padded (48, 192) and looped (384)."""
    q, k, v, do, mask = _edge_inputs(384, dh, cuda, getattr(torch, dtype))
    first = attention._backward_kernel(q, k, v, mask, do, dh ** -0.5, rate, 78)
    second = attention._backward_kernel(q, k, v, mask, do, dh ** -0.5, rate, 78)
    for a, b in zip(first, second):
        assert a.shape == q.shape and torch.equal(a, b)


@pytest.mark.parametrize("dh", [16, 32, 64, 128, 48, 100, 256, 192, 384, 768])
def test_attention_kernels_launch_once_a_call(cuda, dh):
    """Each forward and each backward is one launch of K2 and of K3, padded
    head dims too (the padding is a copy, not a launch of either)."""
    q, k, v, mask = _attention_inputs(256, 2, 3, dh, cuda, torch.bfloat16)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fwd, bwd = attention.launches, attention.backward_launches
    out = attention.fused_attention(*leaves, mask, sm_scale=dh ** -0.5, dropout_rate=0.1, seed=5)
    assert (attention.launches, attention.backward_launches) == (fwd + 1, bwd)
    out.backward(torch.ones_like(out))
    assert (attention.launches, attention.backward_launches) == (fwd + 1, bwd + 1)
    assert out.shape == q.shape and all(x.grad.shape == q.shape for x in leaves)


def test_attention_arithmetic_is_exact(cuda, tmp_path):
    """The attention kernels' branch-free division equals __fdiv_rn for every
    normal quotient, and their per-row mask shortcut equals proqa_keep
    (csrc/checks/attention_exactness.cu, billions of cases on the card)."""
    import subprocess

    from proqa_tpu_torch import _build

    exe = tmp_path / "attention_exactness"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(exe),
                    str(_build.CSRC / "checks" / "attention_exactness.cu")],
                   check=True, capture_output=True, timeout=600)
    run = subprocess.run([str(exe)], capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "0 differ with a normal quotient" in run.stdout and "draws, 0 differ" in run.stdout


def test_dot_f32_gradient_on_cuda(cuda):
    """bf16 x bf16 -> f32 products have no PyTorch derivative; dot_f32 gives
    them JAX's: gradients flow through a BERT layer on the card."""
    from proqa_tpu_torch.ops.dot import dot_f32

    g = torch.Generator().manual_seed(3)
    a = torch.randn(4, 5, 32, generator=g).to(cuda, torch.bfloat16).requires_grad_(True)
    b = torch.randn(32, 16, generator=g).to(cuda, torch.bfloat16).requires_grad_(True)
    gy = torch.randn(4, 5, 16, generator=g, device="cpu").to(cuda)
    dot_f32(a, b).backward(gy)
    ga = (gy.bfloat16().float() @ b.float().T).bfloat16()
    gb = (a.float().reshape(-1, 32).T @ gy.bfloat16().float().reshape(-1, 16)).bfloat16()
    torch.testing.assert_close(a.grad, ga, atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(b.grad, gb, atol=1e-2, rtol=1e-2)

    cfg = BertConfig.tiny(max_position_embeddings=128, flash_attention=True)
    model = Retriever(cfg).reset_parameters(0).to(cuda).train()
    ids = torch.randint(5, 128, (4, 128), generator=g).to(cuda)
    mask = torch.ones(4, 128, dtype=torch.int32, device=cuda)
    emb = model.encode_context(ids, mask, generator=torch.Generator().manual_seed(1))
    emb.square().sum().backward()
    for name, p in model.bert_c.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert model.bert_c.layers[0].q.kernel.grad.abs().sum() > 0


@pytest.mark.parametrize("flash", [True, False])
def test_train_step_on_gpu_matches_cpu(cuda, flash):
    """One f32 train step at dropout 0 on the card (K2/K3 when flash) against
    the same step on the CPU (their plain versions): the loss and every
    gradient, then the parameters after AdamW. Adam divides each gradient by
    its own magnitude, so an element whose gradient is ~0 can move by up to
    the learning rate on one side and less on the other: the parameters are
    held to 2 * lr, the gradients to 1e-4 of each tensor's largest. But
    proj_c.bias's gradient is zero in exact arithmetic (a constant added to
    every context embedding leaves the in-batch loss as it is), so each
    device returns rounding noise, which 1e-4 of its own largest cannot
    hold; the gradient reaching proj_c already differs between the devices
    by more than that. It is held to ZERO_GRAD_ULPS f32 rounding units of
    the CPU's column sums of |dout| (dout: the gradient at proj_c's output)
    on each device and between the two; the ratios are printed."""
    from proqa_tpu_torch.testing import ZERO_GRAD_ULPS, zero_grad_ratio, zero_grad_unit
    from proqa_tpu_torch.train.optim import AdamW, init_train_state
    from proqa_tpu_torch.train.retriever_trainer import in_batch_loss, train_step

    cfg = BertConfig.tiny(dtype=torch.float32, max_position_embeddings=128, flash_attention=flash,
                          hidden_dropout=0.0, attention_dropout=0.0, remat=True)
    g = torch.Generator().manual_seed(4)
    batch = {"input_ids_q": torch.randint(5, 128, (8, 16), generator=g),
             "input_ids_c": torch.randint(5, 128, (8, 128), generator=g)}
    batch["input_mask_q"] = torch.ones(8, 16, dtype=torch.int32)
    batch["input_mask_c"] = (torch.arange(128)[None] < torch.arange(60, 124, 8)[:, None]).int()
    lr, results = 1e-3, []
    for device in ("cpu", cuda):
        model = Retriever(cfg).reset_parameters(0).to(device).train()
        douts = []  # the gradient at proj_c's output, once a backward

        def keep_dout(module, args, out):  # returns None: the output stays as it is
            out.register_hook(lambda g: douts.append(g.cpu()))

        model.proj_c.register_forward_hook(keep_dout)
        dev_batch = {k: v.to(device) for k, v in batch.items()}
        loss, _ = in_batch_loss(model(dev_batch, generator=torch.Generator().manual_seed(0)))
        loss.backward()
        grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()}
        state = init_train_state(dict(model.named_parameters()))
        before = attention.backward_launches
        state, m = train_step(model, state, AdamW(lr), dev_batch,
                              torch.Generator().manual_seed(0))
        if device != "cpu" and flash:
            assert attention.backward_launches - before == cfg.num_layers  # context tower
        assert abs(float(m["loss"]) - loss.item()) < 1e-6
        results.append((loss.item(), grads,
                        {k: p.detach().cpu() for k, p in state.params.items()}, douts[0]))
    (loss_c, grads_c, params_c, dout_c), (loss_g, grads_g, params_g, _) = results
    assert abs(loss_c - loss_g) < 1e-5
    for k, gc in grads_c.items():
        if k != "proj_c.bias":
            torch.testing.assert_close(grads_g[k], gc, atol=1e-4 * gc.abs().max().item() + 1e-9,
                                       rtol=0)
        torch.testing.assert_close(params_g[k], params_c[k], atol=2 * lr, rtol=0)
    unit = zero_grad_unit(dout_c)
    bias_c, bias_g = grads_c["proj_c.bias"], grads_g["proj_c.bias"]
    ratios = {"cpu": zero_grad_ratio(bias_c, unit), "gpu": zero_grad_ratio(bias_g, unit),
              "gpu - cpu": zero_grad_ratio(bias_g - bias_c, unit)}
    print(f"proj_c.bias gradient (flash={flash}), in units of 2^-24 * max column sum of "
          f"|dout| ({unit:.4e}): {ratios}")
    assert all(r <= ZERO_GRAD_ULPS for r in ratios.values()), ratios


# --- the QA answering slice: the reader on K2, the sampler's search on the card ---

# reader outputs, K2 against the vanilla attention path over two layers: f32
# noise in f32 (absolute); in bf16 a share of each output's largest magnitude
# (the span logits inside the paragraph), the limit tests/test_torch_reader.py
# measures for the port against JAX, where one more rounding to float8 e4m3
# (the lower-precision control, checked to fail it) reads 1.38-5.33%
READER_F32_ATOL, READER_BF16_REL = 1e-4, 1.1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reader_with_k2_matches_vanilla_at_512(cuda, dtype):
    """QAModel at BERT-base width (two layers) over [2, 3, 512] reader rows,
    one of them all padding (a batch_pad row K2 must take): the fused path
    launches K2 once a layer and gives the vanilla path's logits."""
    import dataclasses

    from proqa_tpu_torch.models.reader import QAConfig, QAModel, decode_spans

    cfg = BertConfig(num_layers=2, vocab_size=128, flash_attention=True,
                     dtype=getattr(torch, dtype))
    k2 = QAModel(cfg, QAConfig(add_select=True)).reset_parameters(0).to(cuda).eval()
    plain = QAModel(dataclasses.replace(cfg, flash_attention=False), QAConfig(add_select=True))
    plain.load_state_dict(k2.state_dict())
    plain = plain.to(cuda).eval()
    g = torch.Generator().manual_seed(2)
    b, k, t, tq = 2, 3, 512, 30
    ids = torch.randint(5, 128, (b, k, t), generator=g)
    lengths = torch.tensor([[512, 300, 40], [129, 0, 511]])
    mask = (torch.arange(t) < lengths[..., None]).int()
    batch = {"input_ids": ids * mask, "input_mask": mask,
             "segment_ids": ((torch.arange(t) >= 12) & (mask == 1)).long(),
             "paragraph_mask": ((torch.arange(t) >= 12) & (torch.arange(t) < lengths[..., None] - 1)).int(),
             "input_ids_q": torch.randint(5, 128, (b, tq), generator=g),
             "input_mask_q": torch.ones(b, tq, dtype=torch.int32),
             "para_embed": torch.randn(b, 7, 128, generator=g)}
    batch = {key: v.to(cuda) for key, v in batch.items()}
    with torch.inference_mode():
        before = attention.launches
        got = k2(batch)
        torch.cuda.synchronize()
        assert attention.launches - before == cfg.num_layers  # the reader; queries are T=30
        want = plain(batch)
    in_para = batch["paragraph_mask"] == 1
    for key in ("start_logits", "end_logits", "select_logits", "rank_logits", "q_embed"):
        assert torch.isfinite(got[key]).all(), key
        g, w = got[key], want[key]
        if key in ("start_logits", "end_logits"):
            torch.testing.assert_close(g[~in_para], w[~in_para], atol=0, rtol=0)
            g, w = g[in_para], w[in_para]
        if dtype == "float32":
            torch.testing.assert_close(g, w, atol=READER_F32_ATOL, rtol=0)
            continue
        atol = READER_BF16_REL * w.abs().max().item()
        torch.testing.assert_close(g, w, atol=atol, rtol=0)
        control = g.to(torch.float8_e4m3fn).float()
        assert (control - w).abs().max().item() > atol, key
    if dtype == "float32":
        for a, w in zip(decode_spans(got["start_logits"], got["end_logits"]),
                        decode_spans(want["start_logits"], want["end_logits"])):
            torch.testing.assert_close(a, w, atol=READER_F32_ATOL, rtol=0)


def test_eval_load_on_gpu_matches_cpu(cuda, tmp_path):
    """One eval_load pass of the online sampler with the index and the query
    tower on the card (an f32 index of 4,500 rows: K1's f32 kernel, then K6)
    against the same pass on the CPU (their plain versions): the same
    paragraphs in the same order, the same rank-head rows."""
    import json

    import numpy as np

    from proqa_tpu_torch.data.docdb import DocDB
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.index.idmap import IdMap
    from proqa_tpu_torch.models.reader import QAConfig
    from proqa_tpu_torch.qa.sampler import OnlineSampler, OnlineSamplerConfig
    from proqa_tpu_torch.text.wordpiece import BertTokenizer
    from proqa_tpu_torch.train.qa_trainer import QATrainer, QATrainerConfig

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(60)] + [
        "what", "is", "about"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    rng = np.random.default_rng(0)
    paras = [(f"p{i}", " ".join(f"tok{t}" for t in rng.integers(0, 60, size=rng.integers(1, 40))))
             for i in range(4500)]
    db = DocDB.create(str(tmp_path / "docs.db"), paras)
    emb = rng.standard_normal((4500, 128)).astype(np.float32) / np.sqrt(128)
    qa = [{"question": f"what is about tok{a} tok{b}", "answer": [f"tok{a}"]}
          for a, b in rng.integers(0, 60, size=(12, 2))]
    tok = BertTokenizer.from_vocab_file(str(tmp_path / "vocab.txt"))
    cfg = BertConfig.tiny(dtype=torch.float32, initializer_range=0.3)
    scfg = OnlineSamplerConfig(max_query_length=12, max_length=64, question_batch=8,
                               exact_search=True)
    batches = []
    for device in ("cpu", cuda):
        trainer = QATrainer(cfg, QAConfig(), QATrainerConfig(output_dir=str(tmp_path / "run")),
                            device=device)
        index = DenseIndex.from_embeddings(emb, IdMap([p for p, _ in paras]), device=device,
                                           dtype=torch.float32)
        sampler = OnlineSampler(qa, tok, db, index, scfg)
        k1, k6 = mips_kernel.f32_launches, rescore.launches
        batches.append(list(sampler.eval_load(trainer.query_encoder(), k=5)))
        if device != "cpu":
            assert mips_kernel.f32_launches > k1 and rescore.launches > k6
    cpu_batches, gpu_batches = batches
    assert [len(b["id"]) for b in gpu_batches] == [8, 4]
    for want, got in zip(cpu_batches, gpu_batches):
        for key, value in want["net_input"].items():
            np.testing.assert_array_equal(got["net_input"][key], value, err_msg=key)
        assert json.dumps(got["doc_tokens"]) == json.dumps(want["doc_tokens"])


# --- QA finetuning and k-means ---


def _qa_train_batch(b=4, k=2, t=128, tq=8, m=12, n_rows=40, vocab=128):
    """A host batch as the sampler makes it for QATrainer._train_step:
    paragraphs after a 6-token question, span targets, rank candidates as
    index rows (-1 for an under-filled slot), the last question a padded
    copy of the first (question_mask 0)."""
    import numpy as np

    rng = np.random.default_rng(5)
    ids = rng.integers(5, vocab, size=(b, k, t)).astype(np.int32)
    ids[..., 0], ids[..., 6] = 2, 3
    lengths = rng.integers(40, t + 1, size=(b, k))
    live = np.arange(t)[None, None] < lengths[..., None]
    ids = np.where(live, ids, 0)
    seg = (np.arange(t)[None, None] >= 7) & live
    sp = rng.integers(7, 38, size=(b, k, 3))
    sp[rng.random((b, k, 3)) < 0.5] = -1
    rows = rng.integers(0, n_rows, size=(b, m)).astype(np.int32)
    rows[:, -1] = -1
    q = rng.integers(5, vocab, size=(b, tq)).astype(np.int32)
    q[:, 0], q[:, 5:] = 2, 0
    net = {"input_ids": ids, "input_mask": (ids != 0).astype(np.int32),
           "segment_ids": seg.astype(np.int32),
           "paragraph_mask": (seg & (np.arange(t) < lengths[..., None] - 1)).astype(np.int32),
           "input_ids_q": q, "input_mask_q": (q != 0).astype(np.int32), "para_rows": rows,
           "start_positions": sp.astype(np.int32),
           "end_positions": np.where(sp >= 0, sp + 1, -1).astype(np.int32),
           "para_targets": (sp >= 0).any(-1).astype(np.int32),
           "top5000_labels": (rng.random((b, m)) < 0.2).astype(np.int32)}
    net = {key: np.concatenate([v[:b - 1], v[:1]]) for key, v in net.items()}
    net["question_mask"] = (np.arange(b) < b - 1).astype(np.int32)
    return net, rng.standard_normal((n_rows, 128)).astype(np.float32)


@pytest.mark.parametrize("flash", [True, False])
def test_qa_train_step_on_gpu_matches_cpu(cuda, tmp_path, flash):
    """One f32 QATrainer train step at dropout 0 on the card (the reader's
    attention through K2/K3 when flash, candidates gathered from a device
    index) against the same step on the CPU: the loss components, then the
    parameters after AdamW (held to 2 * lr, as the retriever's step)."""
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.models.reader import QAConfig, QAModel
    from proqa_tpu_torch.train.qa_trainer import QATrainer, QATrainerConfig

    cfg = BertConfig.tiny(dtype=torch.float32, max_position_embeddings=128, flash_attention=flash,
                          hidden_dropout=0.0, attention_dropout=0.0, remat=True,
                          initializer_range=0.1)
    qcfg = QAConfig(shared_norm=True)
    params = QAModel(cfg, qcfg).reset_parameters(1).state_dict()
    net, emb = _qa_train_batch()
    lr, results = 1e-3, []
    for device in ("cpu", cuda):
        trainer = QATrainer(cfg, qcfg, QATrainerConfig(
            questions_per_batch=4, accumulate_gradients=2, learning_rate=lr,
            output_dir=str(tmp_path / str(device))), params=params, device=device)
        trainer.set_corpus(DenseIndex.from_embeddings(emb, device=device, dtype=torch.float32))
        before = attention.backward_launches
        comp = trainer._train_step(dict(net))
        if device != "cpu" and flash:
            assert attention.backward_launches - before == 2 * cfg.num_layers  # 2 microbatches
        results.append(({key: float(v) for key, v in comp.items()},
                        {key: p.detach().cpu() for key, p in trainer.state.params.items()}))
    (comp_c, params_c), (comp_g, params_g) = results
    assert set(comp_g) == set(comp_c)
    for key in comp_c:
        assert abs(comp_g[key] - comp_c[key]) < 1e-5 * max(1.0, abs(comp_c[key])), key
    for key, p in params_c.items():
        torch.testing.assert_close(params_g[key], p, atol=2 * lr, rtol=0)


def test_kmeans_on_gpu_matches_cpu(cuda):
    """k-means on the card (f32 scores with TF32 off, cluster sums by
    index_add_) against the same run on the CPU from the same draws: equal
    assignments wherever the best centroid leads by more than the f32 noise,
    and centroids within it."""
    from proqa_tpu_torch.ops import kmeans

    g = torch.Generator().manual_seed(3)
    centers = torch.randn(64, 128, generator=g)
    data = centers[torch.randint(0, 64, (20000,), generator=g)] + \
        0.3 * torch.randn(20000, 128, generator=g)
    res = {}
    for device in ("cpu", cuda):
        res[str(device)] = kmeans.kmeans(torch.Generator().manual_seed(4), data.to(device), 64,
                                         niter=5, init="random", chunk=4096)
    cpu, gpu = res["cpu"], res[str(cuda)]
    torch.testing.assert_close(gpu.centroids.cpu(), cpu.centroids, atol=1e-4, rtol=0)
    differ = (gpu.assignments.cpu() != cpu.assignments).nonzero().flatten()
    if len(differ):
        scores = kmeans._chunk_scores(data[differ].double(), cpu.centroids.double(), False)
        gap = (scores.gather(1, cpu.assignments[differ, None].long())
               - scores.gather(1, gpu.assignments.cpu()[differ, None].long())).abs()
        assert gap.max().item() < 1e-3, gap.max().item()
    a, _ = kmeans.assign_clusters(data.to(cuda), cpu.centroids.to(cuda))
    assert (a.cpu() != cpu.assignments).float().mean().item() < 1e-3


# --- live index updates, the over-fetch, IVF and the f32 pin on the card ------------------

def _rows(n, seed):
    import numpy as np

    return (np.random.default_rng(seed).standard_normal((n, 128)) / 128 ** 0.5).astype("float32")


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_index_growth_on_the_card(cuda, dtype):
    """Adds within the capacity (int8: starting inside a quantization block)
    and past it (1.5x growth) give the CPU index's buffer and scales, and
    searches through K1 (K5 over int8, still on the Hopper kernel after
    growth) that agree with the CPU's up to ties."""
    from proqa_tpu_torch.index.dense import DenseIndex

    dt = torch.bfloat16 if dtype == "bfloat16" else "int8"
    gpu = DenseIndex.from_embeddings(_rows(5000, 20), device=cuda, dtype=dt)
    cpu = DenseIndex.from_embeddings(_rows(5000, 20), device="cpu", dtype=dt)
    cap0 = gpu.embeddings.shape[0]
    for m, seed in ((64, 21), (3000, 22)):
        gpu.add(_rows(m, seed))
        cpu.add(_rows(m, seed))
    assert gpu.embeddings.shape[0] > cap0 and gpu.n == 8064 and gpu.version == 2
    assert torch.equal(gpu.embeddings.cpu(), cpu.embeddings)
    if dtype == "int8":
        assert gpu.quant_block == cpu.quant_block
        assert torch.equal(gpu.scales.cpu(), cpu.scales)
        assert mips_kernel.kernel_for(torch.bfloat16, torch.int8, block=gpu.quant_block,
                                      group=mips_kernel.GROUP, grouped=True,
                                      scaled=True) == "wgmma"
    before = (mips_kernel.launches, mips_kernel.scaled_launches)
    q = _rows(64, 23)
    gv, gi = gpu.search(q, 80)
    torch.cuda.synchronize()
    after = (mips_kernel.launches, mips_kernel.scaled_launches)
    assert after[dtype == "int8"] > before[dtype == "int8"]
    cv, ci = cpu.search(q, 80)
    assert topk_disagreements(gv, gi, cv, ci, atol=MIPS_ATOL) == 0


def test_overfetch_past_512_equals_compact_on_the_card(cuda):
    """600 tombstones push the over-fetch to k = 1,024 over 5,000 rows: the
    chunked path (exact k > 512); its filtered top-80 equals the top-80 of
    compact(), which searches through K1, up to ties."""
    import numpy as np

    from proqa_tpu_torch.index.dense import DenseIndex

    index = DenseIndex.from_embeddings(_rows(5000, 24), device=cuda, dtype=torch.bfloat16)
    dead = np.random.default_rng(25).choice(5000, 600, replace=False)
    index.remove_rows(dead)
    q = _rows(32, 26)
    with pytest.warns(UserWarning, match="k=1024"):
        vals, rows = index.search(q, 80)
    before = mips_kernel.launches
    cv, ci = index.compact().search(q, 80)
    assert mips_kernel.launches > before
    keep = np.setdiff1d(np.arange(5000), dead)
    assert not np.isin(rows, dead).any()
    assert topk_disagreements(vals, rows, cv, keep[ci], atol=MIPS_ATOL) == 0


def test_ivf_full_probe_equals_exact_on_the_card(cuda):
    """An IVF view at nprobe = nlist scans every row: its bf16 top-80 equals
    the exact search's (K1 and K6) up to ties, at Q = 1 and 8."""
    from proqa_tpu_torch.index.dense import DenseIndex

    index = DenseIndex.from_embeddings(_rows(8192, 27), device=cuda, dtype=torch.bfloat16)
    view = index.to_ivf(nlist=16, nprobe=16, niter=5)
    assert view.ivf.slabs.device.type == "cuda" and view.ivf.slabs.dtype == torch.bfloat16
    for nq in (1, 8):
        q = _rows(nq, 28)
        v, i = view.search(q, 80)
        ev, ei = index.search(q, 80)
        assert topk_disagreements(v, i, ev, ei, atol=MIPS_ATOL) == 0


def test_kmeans_assignments_with_tf32_set_equal_the_cpu(cuda):
    """With TF32 switched on by the caller, assign_clusters still scores in
    full f32 on the card (ops/dot.py:full_f32): its assignments equal the
    CPU's, except where a row's two best scores lie within 1e-5 (f32 sums in
    another order); the caller's switch is restored."""
    from proqa_tpu_torch.ops import kmeans

    x = torch.from_numpy(_rows(4096, 29))
    c = torch.from_numpy(_rows(1000, 30))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ga, _ = kmeans.assign_clusters(x.to(cuda), c.to(cuda))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ca, _ = kmeans.assign_clusters(x, c)
    ga = ga.cpu()
    differ = (ga != ca).nonzero().flatten()
    scores = x.double() @ c.double().T
    gap = (scores[differ, ga[differ].long()] - scores[differ, ca[differ].long()]).abs()
    assert bool((gap <= 1e-5).all()), gap.max()


# --- multi-device: the sharded search over one card, data parallel over NCCL ---

@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_sharded_search_on_the_card(cuda, dtype):
    """A DenseIndex row-sharded over [cuda:0] * 4 (16,384 rows a shard, so
    each shard's search runs the block-max pipeline) against the unsharded
    index: equal top-k up to ties, and one launch of K1 (bf16; K5 over int8)
    and, over bf16, of K6 on every shard."""
    import numpy as np

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.parallel import make_mesh

    emb = (torch.randn(4 * 16384, 128, generator=torch.Generator().manual_seed(2))
           / 128 ** 0.5).numpy()
    queries = (torch.randn(64, 128, generator=torch.Generator().manual_seed(3))
               / 128 ** 0.5).numpy()
    kind = torch.bfloat16 if dtype == "bfloat16" else "int8"
    sharded = DenseIndex.from_embeddings(emb, mesh=make_mesh(devices=["cuda:0"] * 4), dtype=kind)
    whole = DenseIndex.from_embeddings(emb, device=cuda, dtype=kind)
    assert sharded.quant_block == whole.quant_block
    counter = "launches" if dtype == "bfloat16" else "scaled_launches"
    before_k1, before_k6 = getattr(mips_kernel, counter), rescore.launches
    vals, idx = sharded.search(queries, 16)
    assert getattr(mips_kernel, counter) - before_k1 == 4
    assert rescore.launches - before_k6 == (4 if dtype == "bfloat16" else 0)
    wv, wi = whole.search(queries, 16)
    assert np.isfinite(vals).all()
    assert topk_disagreements(vals, idx, wv, wi, atol=MIPS_ATOL) == 0


def test_world_one_nccl_retriever_step_matches_plain(cuda, tmp_path):
    """A retriever trainer in an NCCL group of one (its q and c all-gathered,
    its gradients all-reduced) against the trainer with no group: the same
    losses over 3 f32 steps at dropout 0, accumulation 2, and the same
    parameters."""
    import numpy as np
    import torch.distributed as dist

    from proqa_tpu_torch.train.retriever_trainer import RetrieverTrainer, RetrieverTrainerConfig

    cfg = BertConfig.tiny(dtype=torch.float32, hidden_dropout=0.0, attention_dropout=0.0)
    g = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        q = g.integers(5, 128, size=(8, 6)).astype(np.int32)
        c = g.integers(5, 128, size=(8, 12)).astype(np.int32)
        batches.append({"input_ids_q": q, "input_mask_q": np.ones_like(q),
                        "input_ids_c": c, "input_mask_c": np.ones_like(c)})
    runs = []
    for grouped in (True, False):
        tcfg = RetrieverTrainerConfig(learning_rate=1e-3, accumulate_gradients=2, seed=1,
                                      output_dir=str(tmp_path / f"run{grouped}"))
        if grouped:
            dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                                    rank=0, world_size=1)
        try:
            trainer = RetrieverTrainer(cfg, tcfg, device="cuda")
            assert trainer.dp.backend == ("nccl" if grouped else None)
            losses = [float(trainer.step(b)["loss"]) for b in batches]
            runs.append((losses, {k: p.detach().cpu() for k, p in trainer.state.params.items()}))
        finally:
            if grouped:
                dist.destroy_process_group()
    (l_dp, p_dp), (l_one, p_one) = runs
    np.testing.assert_allclose(l_dp, l_one, rtol=0, atol=1e-6)
    for k, p in p_one.items():
        torch.testing.assert_close(p_dp[k], p, rtol=0, atol=1e-5)


# --- the BERT layer's fused epilogues: F1 (dense epilogue) and F2 (add + LayerNorm) ---

# F2 in f32: the two row sums run in another order than ATen's, so the mean
# and variance differ by a few f32 ulps of the row's scale
LN_F32_TOL = 1e-5
# F2 in bf16: one bf16 ulp at the larger magnitude of the two outputs, or of
# 2^-8 below it, where an output that cancels to near zero in y * scale + bias
# moves by the f32 difference of its O(1) terms (chip_smoke.py:LN_ULP_FLOOR)
LN_ULP_FLOOR = 2.0 ** -8


def _bf16_ulps(got, want, floor: float = LN_ULP_FLOOR) -> float:
    """The largest |got - want| in bf16 ulps at the larger magnitude of the
    two, or of `floor` below it."""
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(floor)
    return ((got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max().item()


def _epilogue_inputs(shape, device, seed):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(*shape, generator=g) * 2.0
    return y.to(device), (torch.randn(shape[-1], generator=g) * 0.1).to(device)


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(1, 768), (37, 768), (513, 3072), (4, 33, 768), (37, 2),
                                   (5, 1), (9, 40), (7, 12)])
def test_dense_epilogue_kernel_equals_plain(cuda, shape, out_dtype, gelu):
    """F1 bit-equal to its plain version: one f32 add, round-to-nearest-even,
    ATen's exact-GELU expression; odd row counts, widths that take the
    vector body (multiples of 8) and the element body (2, 1, 12)."""
    y, b = _epilogue_inputs(shape, cuda, seed=sum(shape))
    dt = getattr(torch, out_dtype)
    before = fused_bert.launches("F1")
    got = fused_bert.dense_epilogue(y, b, dt, gelu)
    torch.cuda.synchronize()
    assert fused_bert.launches("F1") == before + 1
    want = fused_bert.dense_epilogue_reference(y, b, dt, gelu)
    assert got.dtype == dt and got.shape == y.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("gelu", [False, True])
def test_dense_epilogue_kernel_unaligned(cuda, gelu):
    """A product 4 bytes past a 16-byte boundary takes the element body."""
    y, b = _epilogue_inputs((37, 768), cuda, seed=3)
    shifted = torch.empty(y.numel() + 1, device=cuda)[1:].view_as(y)
    shifted.copy_(y)
    got = fused_bert.dense_epilogue(shifted, b, torch.bfloat16, gelu)
    assert torch.equal(got, fused_bert.dense_epilogue_reference(y, b, torch.bfloat16, gelu))


def _ln_inputs(rows, h, device, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, h, generator=g)
    r = torch.randn(rows, h, generator=g) * 0.5 + 0.25
    scale = 1.0 + 0.1 * torch.randn(h, generator=g)
    bias = 0.1 * torch.randn(h, generator=g)
    return (x.to(device, dtype), r.to(device, dtype), scale.to(device), bias.to(device))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("rows,h", [(1, 768), (37, 768), (513, 768), (9, 32), (7, 1024),
                                    (5, 100), (3, 1), (11, 40), (6, 36)])
def test_add_layer_norm_kernel_matches_plain(cuda, rows, h, residual, dtype):
    """F2 within one bf16 ulp of its plain version (at magnitudes of at least
    LN_ULP_FLOOR; LN_F32_TOL in f32): the same rounding points, the row sums
    in another order; odd row counts,
    widths that take the vector body and the element body (100, 1, 36)."""
    x, r, scale, bias = _ln_inputs(rows, h, cuda, getattr(torch, dtype), seed=rows * h)
    r = r if residual else None
    before = fused_bert.launches("F2")
    got = fused_bert.add_layer_norm(x, r, scale, bias, 1e-12)
    torch.cuda.synchronize()
    assert fused_bert.launches("F2") == before + 1
    want = fused_bert.add_layer_norm_reference(x, r, scale, bias, 1e-12)
    assert got.dtype == x.dtype and got.shape == x.shape and torch.isfinite(got).all()
    if dtype == "bfloat16":
        assert _bf16_ulps(got, want) <= 1.0
    else:
        torch.testing.assert_close(got, want, atol=LN_F32_TOL, rtol=LN_F32_TOL)


def test_add_layer_norm_kernel_unaligned(cuda):
    """Rows 2 bytes past a 16-byte boundary take the element body."""
    x, r, scale, bias = _ln_inputs(37, 768, cuda, torch.bfloat16, seed=8)
    shifted = torch.empty(x.numel() + 1, device=cuda, dtype=x.dtype)[1:].view_as(x)
    shifted.copy_(x)
    got = fused_bert.add_layer_norm(shifted, r, scale, bias, 1e-12)
    assert _bf16_ulps(got, fused_bert.add_layer_norm_reference(x, r, scale, bias, 1e-12)) <= 1.0


def test_fused_epilogues_reject_what_they_do_not_take(cuda):
    """Wrong dtypes, a mismatched residual and a gradient asked of the
    no-graph route raise; every width runs (12,289 columns, width 1,025:
    the first of the wide forms, equal to their plain versions)."""
    y, b = _epilogue_inputs((4, 12_289), cuda, seed=1)
    assert torch.equal(fused_bert.dense_epilogue(y, b, torch.bfloat16),
                       fused_bert.dense_epilogue_reference(y, b, torch.bfloat16))
    with pytest.raises(TypeError):
        fused_bert.dense_epilogue(y[:, :8].bfloat16(), b[:8], torch.bfloat16)
    x, r, scale, bias = _ln_inputs(4, 1025, cuda, torch.bfloat16, seed=2)
    assert _bf16_ulps(fused_bert.add_layer_norm(x, r, scale, bias, 1e-12),
                      fused_bert.add_layer_norm_reference(x, r, scale, bias, 1e-12),
                      LN_ULP_FLOOR) <= 1.0
    with pytest.raises(TypeError):
        fused_bert.add_layer_norm(x[:, :8].half(), None, scale[:8], bias[:8], 1e-12)
    with pytest.raises(ValueError, match="residual"):
        fused_bert.add_layer_norm(x[:, :8], r[:, :8].float(), scale[:8], bias[:8], 1e-12)
    leaf = b[:8].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_bert.dense_epilogue(y[:, :8].contiguous(), leaf, torch.bfloat16)
    with torch.no_grad():
        fused_bert.dense_epilogue(y[:, :8].contiguous(), leaf, torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_with_fused_epilogues_matches_autograd_route(cuda, dtype):
    """A BERT-base-width context tower (two layers, T = 128): inference mode
    (F1 and F2 on every dense layer and LayerNorm, nothing saved) against the
    same weights and inputs with grad on (the training route: the same
    kernels, saving what their backward reads), bit-equal, each launching F1
    and F2 6 L + 2 and 2 L + 1 times; and against the plain chain under
    autograd (fused_bert._eager_chain) within the encoder tolerances."""
    cfg = BertConfig(num_layers=2, vocab_size=128, flash_attention=True,
                     dtype=getattr(torch, dtype))
    model = Retriever(cfg).reset_parameters(1).to(cuda).eval()
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(5, 128, (6, 128), generator=g)
    mask = (torch.arange(128) < torch.tensor([128, 100, 64, 7, 1, 128])[:, None]).int()
    ids, mask = (ids * mask).to(cuda), mask.to(cuda)
    once = (6 * 2 + 2, 2 * 2 + 1)
    launches = fused_bert.launches("F1"), fused_bert.launches("F2")
    with torch.inference_mode():
        fused = model.encode_context(ids, mask)
    torch.cuda.synchronize()
    assert (fused_bert.launches("F1") - launches[0],
            fused_bert.launches("F2") - launches[1]) == once
    launches = fused_bert.launches("F1"), fused_bert.launches("F2")
    routed = model.encode_context(ids, mask)
    assert routed.requires_grad
    assert (fused_bert.launches("F1") - launches[0],
            fused_bert.launches("F2") - launches[1]) == once
    assert torch.equal(fused, routed.detach())
    launches = fused_bert.launches("F1"), fused_bert.launches("F2")
    with fused_bert._eager_chain():
        plain = model.encode_context(ids, mask)
    assert plain.requires_grad
    assert (fused_bert.launches("F1"), fused_bert.launches("F2")) == launches
    assert torch.isfinite(fused).all()
    torch.testing.assert_close(fused, plain.detach(), atol=ENCODER_TOL[dtype], rtol=0)


# --- the training route: F1's and F2's backward kernels ---

# F2's dx against its plain versions: two bf16 ulps at magnitudes of at least
# LN_ULP_FLOOR (g - mean(g) - x^ mean(g x^) sums O(1) terms whose f32 sums run
# in another order, which moves a near-zero dx by a few f32 ulps of 1); f32
# within LN_F32_TOL
BWD_ULPS = 2.0
# column sums: within this share of the sum of the column's |terms|
COLSUM_REL = 1e-5


def _colsum_ok(got, want, terms) -> bool:
    """got within COLSUM_REL of want, relative to the sum of the column's
    |terms| (terms [rows, cols])."""
    limit = COLSUM_REL * terms.double().abs().sum(0) + 1e-30
    return bool(((got.double() - want.double()).abs() <= limit).all())


def _tickets_left_at_zero() -> bool:
    """The backward kernels' scratch keeps its ticket counters (its first
    4,096 bytes, csrc/column_sums.cuh) at zero between launches."""
    torch.cuda.synchronize()
    return all(int(ws[:4096].count_nonzero()) == 0 for ws in fused_bert._WORKSPACES.values())


def _dense_bwd_inputs(rows, cols, device, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    z = (torch.randn(rows, cols, generator=g) * 2.0).to(device, dtype)
    dout = torch.randn(rows, cols, generator=g).to(device, dtype)
    return dout, z


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,cols", [(1, 768), (7, 768), (37, 768), (100, 768), (5633, 768),
                                       (5003, 768), (10240, 768), (1029, 3072), (10240, 3072),
                                       (300, 2), (7, 1), (9, 40), (11, 12), (100, 30)])
def test_dense_epilogue_backward_kernel_matches_plain(cuda, rows, cols, dtype, gelu):
    """F1's backward: with GELU, dz bit-equal to the plain chain's
    (aten::gelu_backward in f32, one rounding); the bias gradient within
    COLSUM_REL of the plain column sum, two launches bit-equal and the
    scratch's ticket counters left at zero; row
    counts off the blocks' 8 rows, fewer rows than a slab's 64 (1, 7, 37),
    one past the count that fills 88 slabs of 64 at width 768 on 132 SMs
    (5,633: slabs of 65, the last ones empty), the QA train step's 10,240
    rows; widths of the vector body (768, 3,072, 40) and of the element body
    (2, 1, 12, 30)."""
    dt = getattr(torch, dtype)
    dout, z = _dense_bwd_inputs(rows, cols, cuda, dt, seed=rows + cols)
    before = fused_bert.launches("F1 backward")
    dz, db = fused_bert._dense_epilogue_backward_kernel(dout, z, gelu, True, True)
    torch.cuda.synchronize()
    assert fused_bert.launches("F1 backward") == before + 1
    want_dz, want_db = fused_bert.dense_epilogue_backward_reference(dout, z, gelu)
    assert dz.dtype == dt and db.dtype == torch.float32 and db.shape == (cols,)
    assert torch.equal(dz, want_dz)
    assert _colsum_ok(db, want_db, 1.2 * dout.float())
    dz2, db2 = fused_bert._dense_epilogue_backward_kernel(dout, z, gelu, True, True)
    assert torch.equal(dz2, dz) and torch.equal(db2, db)
    assert _tickets_left_at_zero()


@pytest.mark.parametrize("rows,cols", [(513, 768), (7, 12)])
@pytest.mark.parametrize("need_dz,need_dbias", [(True, False), (False, True), (False, False)])
@pytest.mark.parametrize("gelu", [False, True])
def test_dense_epilogue_backward_kernel_frozen(cuda, gelu, need_dz, need_dbias, rows, cols):
    """A frozen bias (no column sum) or no input wanting dz: what is computed
    equals the full call's, bit for bit; nothing asked launches nothing. The
    vector body (768) and the element body (12)."""
    dout, z = _dense_bwd_inputs(rows, cols, cuda, torch.bfloat16, seed=4)
    full_dz, full_db = fused_bert._dense_epilogue_backward_kernel(dout, z, gelu, True, True)
    before = fused_bert.launches("F1 backward")
    dz, db = fused_bert._dense_epilogue_backward_kernel(dout, z, gelu, need_dz, need_dbias)
    launched = fused_bert.launches("F1 backward") - before
    assert launched == int(need_dbias or (gelu and need_dz))
    assert (dz is None) == (not need_dz) and (db is None) == (not need_dbias)
    if need_dz:
        assert torch.equal(dz, full_dz)
    if need_dbias:
        assert torch.equal(db, full_db)


@pytest.mark.parametrize("gelu", [False, True])
def test_dense_epilogue_backward_kernel_unaligned(cuda, gelu):
    """dout 2 bytes past a 16-byte boundary takes the element body."""
    dout, z = _dense_bwd_inputs(37, 768, cuda, torch.bfloat16, seed=6)
    shifted = torch.empty(dout.numel() + 1, device=cuda, dtype=dout.dtype)[1:].view_as(dout)
    shifted.copy_(dout)
    dz, db = fused_bert._dense_epilogue_backward_kernel(shifted, z, gelu, True, True)
    want_dz, want_db = fused_bert.dense_epilogue_backward_reference(dout, z, gelu)
    assert torch.equal(dz, want_dz) and _colsum_ok(db, want_db, 1.2 * dout.float())


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(37, 3072), (9, 12)])
def test_dense_epilogue_training_forward_saves_z(cuda, shape, out_dtype):
    """The training forward with GELU: the same output as the inference one,
    and z = round(y + b) bit for bit."""
    y, b = _epilogue_inputs(shape, cuda, seed=sum(shape))
    dt = getattr(torch, out_dtype)
    out, z = fused_bert._dense_epilogue_kernel(y, b, dt, True, save_z=True)
    assert torch.equal(out, fused_bert.dense_epilogue(y, b, dt, True))
    assert torch.equal(z, (y + b).to(dt))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("rows,h", [(1, 768), (7, 768), (37, 768), (100, 768), (4225, 768),
                                    (5003, 768), (10240, 768), (9, 32), (7, 1024), (3169, 1024),
                                    (5, 100), (3, 1), (11, 40), (301, 6)])
def test_add_layer_norm_backward_kernel_matches_plain(cuda, rows, h, residual, dtype):
    """F2's forward mean and rstd against the plain ones, and its backward:
    dx within BWD_ULPS bf16 ulps (at magnitudes of at least LN_ULP_FLOOR;
    LN_F32_TOL in f32) of the plain formula and of autograd through the plain
    chain, the share of differing elements printed; dscale and dbias within
    COLSUM_REL; two launches bit-equal, the scratch's ticket counters left at
    zero. Row counts off the tiles' rows (8 at 768, 6 at 1,024 in bf16),
    fewer than a block's two tiles (1, 7), one past the count that fills 264
    blocks of two tiles on 132 SMs (4,225 = 264 * 16 + 1 at 768; 3,169 =
    264 * 12 + 1 at 1,024 in bf16: one block takes three tiles), the QA
    train step's 10,240 rows; widths of the vector body and of the element
    body (100, 1, 6)."""
    dt = getattr(torch, dtype)
    x, r, scale, bias = _ln_inputs(rows, h, cuda, dt, seed=rows * h + 1)
    r = r if residual else None
    dy = torch.randn(rows, h, generator=torch.Generator().manual_seed(h)).to(cuda, dt)
    out, mean, rstd = fused_bert._add_layer_norm_kernel(x, r, scale, bias, 1e-12,
                                                        save_stats=True)
    _, want_mean, want_rstd = fused_bert._layer_norm_plain(x, r, scale, bias, 1e-12)
    assert torch.equal(out, fused_bert.add_layer_norm(x, r, scale, bias, 1e-12))
    torch.testing.assert_close(mean, want_mean, atol=LN_F32_TOL, rtol=0)
    torch.testing.assert_close(rstd, want_rstd, atol=0, rtol=LN_F32_TOL)
    before = fused_bert.launches("F2 backward")
    dx, dscale, dbias = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale,
                                                                   True, True)
    torch.cuda.synchronize()
    assert fused_bert.launches("F2 backward") == before + 1
    plain = fused_bert.add_layer_norm_backward_reference(dy, x, r, mean, rstd, scale)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, scale, bias)]
    fused_bert.add_layer_norm_reference(leaves[0], r, leaves[1], leaves[2], 1e-12).backward(dy)
    for name, want in (("plain", plain[0]), ("autograd", leaves[0].grad)):
        assert dx.dtype == dt and dx.shape == x.shape
        if dtype == "bfloat16":
            ulps = _bf16_ulps(dx, want)
            print(f"F2 backward [{rows}, {h}] vs {name}: {ulps} bf16 ulps, "
                  f"{(dx != want).float().mean().item():.4%} of elements differ")
            assert ulps <= BWD_ULPS
        else:
            torch.testing.assert_close(dx, want, atol=LN_F32_TOL, rtol=0)
    s = (x if r is None else x + r).float()
    xh = (s - mean[:, None]) * rstd[:, None]
    terms = (dy.float() * xh, dy.float())
    for got, want, t in zip((dscale, dbias), plain[1:], terms):
        assert got.dtype == torch.float32 and _colsum_ok(got, want, t)
    again = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale, True, True)
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, dscale, dbias)))
    assert _tickets_left_at_zero()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,h", [(515, 768), (9, 100)])
@pytest.mark.parametrize("need_dx,need_params", [(True, False), (False, True), (False, False)])
def test_add_layer_norm_backward_kernel_frozen(cuda, need_dx, need_params, rows, h, dtype):
    """A frozen scale and bias (no column sums) or no input wanting dx: what
    is computed equals the full call's bit for bit; nothing asked launches
    nothing. The vector body (768) and the element body (100)."""
    dt = getattr(torch, dtype)
    x, r, scale, bias = _ln_inputs(rows, h, cuda, dt, seed=9)
    dy = torch.randn(rows, h, generator=torch.Generator().manual_seed(1)).to(cuda, dt)
    _, mean, rstd = fused_bert._add_layer_norm_kernel(x, r, scale, bias, 1e-12, save_stats=True)
    full = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale, True, True)
    before = fused_bert.launches("F2 backward")
    got = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale, need_dx,
                                                     need_params)
    assert fused_bert.launches("F2 backward") - before == int(need_dx or need_params)
    wanted = (need_dx, need_params, need_params)
    for g, f, w in zip(got, full, wanted):
        assert (g is None) == (not w) and (g is None or torch.equal(g, f))


def test_training_route_rejects_what_it_does_not_take(cuda):
    """The Functions raise on the card where a kernel cannot take its
    inputs: no fallback to the plain chain. Every width runs: 12,289 columns
    and width 1,025 launch the wide forms, forward and backward, and match
    the plain chain under autograd."""
    x = torch.randn(4, 8, device=cuda).bfloat16().requires_grad_(True)
    kernel = torch.randn(8, 12_289, device=cuda).bfloat16()
    bias = torch.zeros(12_289, device=cuda, requires_grad=True)
    dout = torch.randn(4, 12_289, device=cuda).bfloat16()
    launches = fused_bert.launches("F1"), fused_bert.launches("F1 backward")
    y = fused_bert.dense(x, kernel, bias, torch.bfloat16)
    got = torch.autograd.grad(y, (x, bias), dout)
    assert (fused_bert.launches("F1") - launches[0],
            fused_bert.launches("F1 backward") - launches[1]) == (1, 1)
    with fused_bert._eager_chain():
        y_p = fused_bert.dense(x, kernel, bias, torch.bfloat16)
        want = torch.autograd.grad(y_p, (x, bias), dout)
    assert torch.equal(y, y_p) and torch.equal(got[0], want[0])
    assert _colsum_ok(got[1], want[1], dout.float())
    wide = torch.randn(4, 1025, device=cuda).bfloat16().requires_grad_(True)
    scale, ln_bias = torch.ones(1025, device=cuda), torch.zeros(1025, device=cuda)
    dy = torch.randn(4, 1025, device=cuda).bfloat16()
    launches = fused_bert.launches("F2"), fused_bert.launches("F2 backward")
    out = fused_bert.add_layer_norm_grad(wide, None, scale, ln_bias, 1e-12)
    (dx,) = torch.autograd.grad(out, (wide,), dy)
    assert (fused_bert.launches("F2") - launches[0],
            fused_bert.launches("F2 backward") - launches[1]) == (1, 1)
    with fused_bert._eager_chain():
        out_p = fused_bert.add_layer_norm_grad(wide, None, scale, ln_bias, 1e-12)
        (dx_p,) = torch.autograd.grad(out_p, (wide,), dy)
    assert _bf16_ulps(out, out_p, LN_ULP_FLOOR) <= 1.0
    assert _bf16_ulps(dx, dx_p, LN_ULP_FLOOR) <= BWD_ULPS


@pytest.mark.parametrize("gelu,out", [(False, None), (True, None), (False, "float32")])
@pytest.mark.parametrize("cols", [768, 3072, 2])
def test_dense_function_matches_the_eager_chain(cuda, cols, gelu, out):
    """fused_bert.dense on the card (F1 forward saving z, F1's backward, the
    products) against the plain chain under autograd (_eager_chain): the same
    output bit for bit, dz's products on the same operands, so dx and
    dkernel bit-equal and dbias within COLSUM_REL; frozen kernel and bias."""
    g = torch.Generator().manual_seed(cols)
    x = torch.randn(4, 33, 64, generator=g).to(cuda).bfloat16()
    kernel = (torch.randn(64, cols, generator=g) * 0.2).to(cuda)
    bias = (torch.randn(cols, generator=g) * 0.1).to(cuda)
    out_dt = torch.float32 if out else torch.bfloat16
    dout = torch.randn(4, 33, cols, generator=g).to(cuda, out_dt)

    def run(frozen=()):
        leaves = {"x": x.clone().requires_grad_("x" not in frozen),
                  "kernel": kernel.clone().requires_grad_("kernel" not in frozen),
                  "bias": bias.clone().requires_grad_("bias" not in frozen)}
        y = fused_bert.dense(leaves["x"], leaves["kernel"].bfloat16(), leaves["bias"], out_dt,
                             gelu)
        y.backward(dout)
        return y.detach(), {k: v.grad for k, v in leaves.items()}

    before = fused_bert.launches("F1"), fused_bert.launches("F1 backward")
    y_k, g_k = run()
    assert (fused_bert.launches("F1") - before[0],
            fused_bert.launches("F1 backward") - before[1]) == (1, 1)
    with fused_bert._eager_chain():
        y_p, g_p = run()
    assert torch.equal(y_k, y_p)
    assert torch.equal(g_k["x"], g_p["x"]) and torch.equal(g_k["kernel"], g_p["kernel"])
    dz = dout.float() * (1.2 if gelu else 1.0)
    assert _colsum_ok(g_k["bias"], g_p["bias"], dz.reshape(-1, cols))
    for frozen in (("bias",), ("kernel", "bias")):
        _, g_f = run(frozen)
        for name, grad in g_f.items():
            assert (grad is None) if name in frozen else torch.equal(grad, g_k[name])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_remat_step_is_bit_equal_on_the_card(cuda, dtype):
    """A BERT-base-width retriever (two layers, T = 128, dropout on, K2/K3/K4,
    F1/F2 and their backward kernels): every gradient with remat (layer and
    MLP scope) equals the one without, bit for bit; the backward kernels
    launch on every route."""
    from proqa_tpu_torch.train.retriever_trainer import in_batch_loss

    g = torch.Generator().manual_seed(8)
    ids = torch.randint(5, 128, (6, 128), generator=g)
    mask = (torch.arange(128) < torch.tensor([128, 100, 64, 7, 1, 128])[:, None]).int()
    batch = {"input_ids_q": ids[:, :16].to(cuda), "input_mask_q": torch.ones(6, 16,
                                                                            dtype=torch.int32,
                                                                            device=cuda),
             "input_ids_c": (ids * mask).to(cuda), "input_mask_c": mask.to(cuda)}
    grads = []
    torch.use_deterministic_algorithms(True, warn_only=True)  # the embeddings' index_put
    try:
        for remat, scope in ((False, "layer"), (True, "layer"), (True, "mlp")):
            cfg = BertConfig(num_layers=2, vocab_size=128, max_position_embeddings=128,
                             flash_attention=True, remat=remat, remat_scope=scope,
                             dtype=getattr(torch, dtype))
            model = Retriever(cfg).reset_parameters(0).to(cuda).train()
            before = fused_bert.launches("F1 backward"), fused_bert.launches("F2 backward")
            loss, _ = in_batch_loss(model(batch, generator=torch.Generator().manual_seed(5)))
            loss.backward()
            assert (fused_bert.launches("F1 backward") > before[0]
                    and fused_bert.launches("F2 backward") > before[1])
            grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    finally:
        torch.use_deterministic_algorithms(False)
    for other in grads[1:]:
        bad = [k for k in grads[0] if not torch.equal(other[k], grads[0][k])]
        assert not bad, bad[:5]


# --- the wide forms: F1 past 12,288 columns, F2 past 1,024 ---

def _form_counts() -> dict:
    torch.cuda.synchronize()
    return dict(fused_bert.form_launches)


def _rose(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(3, 12_289), (5, 16_384), (2, 40_000), (3, 131_080),
                                   "unaligned"])
def test_wide_dense_epilogue_equals_plain(cuda, shape, out_dtype, gelu):
    """F1's wide forms (the bias through the read-only cache) bit-equal to
    the plain version, with z bit-equal where the training forward saves
    it; one launch a call, counted under its form."""
    dt = getattr(torch, out_dtype)
    if shape == "unaligned":
        y, b = _epilogue_inputs((3, 16_384), cuda, seed=9)
        shifted = torch.empty(y.numel() + 1, device=cuda)[1:].view_as(y)
        y = shifted.copy_(y)
    else:
        y, b = _epilogue_inputs(shape, cuda, seed=sum(shape))
    before = _form_counts()
    got, z = fused_bert._dense_epilogue_kernel(y, b, dt, gelu, save_z=gelu)
    form = fused_bert.dense_form(y.shape[-1], y.data_ptr() % 16 == 0)
    assert _rose(before, _form_counts()) == {f"F1 {form.removesuffix('_scalar')}": 1}
    assert form.startswith("wide")
    assert torch.equal(got, fused_bert.dense_epilogue_reference(y, b, dt, gelu))
    if gelu:
        assert torch.equal(z, (y + b).to(dt))


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,cols", [(37, 12_289), (1029, 16_384), (5, 40_000),
                                       (9, 131_080)])
def test_wide_dense_epilogue_backward_matches_plain(cuda, rows, cols, dtype, gelu):
    """F1's backward past 12,288 columns: the ticketed slabs up to 131,072
    (16,384: 64 column blocks and 4 slabs on 132 SMs), one slab past it
    (131,080: the direct form). dz bit-equal with GELU, the bias sum within
    COLSUM_REL, two launches bit-equal, the counters left at zero."""
    dt = getattr(torch, dtype)
    dout, z = _dense_bwd_inputs(rows, cols, cuda, dt, seed=rows + cols)
    before = _form_counts()
    dz, db = fused_bert._dense_epilogue_backward_kernel(dout, z, gelu, True, True)
    form = fused_bert.dense_form(cols, True, backward=True)
    assert _rose(before, _form_counts()) == {f"F1 backward {form.removesuffix('_scalar')}": 1}
    want_dz, want_db = fused_bert.dense_epilogue_backward_reference(dout, z, gelu)
    assert torch.equal(dz, want_dz)
    assert _colsum_ok(db, want_db, 1.2 * dout.float())
    again = fused_bert._dense_epilogue_backward_kernel(dout, z, gelu, True, True)
    assert torch.equal(again[0], dz) and torch.equal(again[1], db)
    assert _tickets_left_at_zero()


WIDE_LN = [(3, 1025), (5, 1152), (9, 2048), (4, 2560), (3, 3001), (6, 4096), (2, 8192),
           (3, 8200), (2, 32_768), (3, 65_536)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("rows,h", WIDE_LN)
def test_wide_add_layer_norm_matches_plain(cuda, rows, h, residual, dtype):
    """F2's wide forms, a block a row in registers (to 8,192) and streamed
    (past it), the element body at odd widths: within one bf16 ulp of the
    plain version (LN_F32_TOL in f32), the saved mean and rstd with them,
    one launch counted under its form."""
    dt = getattr(torch, dtype)
    x, r, scale, bias = _ln_inputs(rows, h, cuda, dt, seed=rows * h)
    r = r if residual else None
    before = _form_counts()
    got, mean, rstd = fused_bert._add_layer_norm_kernel(x, r, scale, bias, 1e-12,
                                                        save_stats=True)
    form = fused_bert.layer_norm_form(h, dt, True)
    assert _rose(before, _form_counts()) == {f"F2 {form.removesuffix('_scalar')}": 1}
    want, want_mean, want_rstd = fused_bert._layer_norm_plain(x, r, scale, bias, 1e-12)
    assert torch.equal(got, fused_bert.add_layer_norm(x, r, scale, bias, 1e-12))
    if dtype == "bfloat16":
        assert _bf16_ulps(got, want) <= 1.0
    else:
        torch.testing.assert_close(got, want, atol=LN_F32_TOL, rtol=LN_F32_TOL)
    torch.testing.assert_close(mean, want_mean, atol=LN_F32_TOL, rtol=0)
    torch.testing.assert_close(rstd, want_rstd, atol=0, rtol=LN_F32_TOL)


@pytest.mark.parametrize("h", [2048, 8200])
def test_wide_add_layer_norm_unaligned(cuda, h):
    """Rows 2 bytes past a 16-byte boundary take the wide forms' element
    bodies."""
    x, r, scale, bias = _ln_inputs(5, h, cuda, torch.bfloat16, seed=h)
    shifted = torch.empty(x.numel() + 1, device=cuda, dtype=x.dtype)[1:].view_as(x)
    shifted.copy_(x)
    got = fused_bert.add_layer_norm(shifted, r, scale, bias, 1e-12)
    assert _bf16_ulps(got, fused_bert.add_layer_norm_reference(x, r, scale, bias, 1e-12)) <= 1.0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("rows,h", [(1, 1152), (7, 2048), (265, 2048), (600, 2048), (3, 3001),
                                    (37, 4096), (5, 4104), (40, 8192), (3, 32_768)])
def test_wide_add_layer_norm_backward_matches_plain(cuda, rows, h, residual, dtype):
    """F2's backward past 1,024: the row form (to 4,096) and the stream
    form (past it; 40 rows: sub-slabs of 16 carried in the partials), one
    row a block and several (265, 600 rows on 264 blocks). dx within
    BWD_ULPS of the plain formula and of autograd through the plain chain,
    dscale and dbias within COLSUM_REL, two launches bit-equal, the
    counters left at zero, one launch counted under its form."""
    dt = getattr(torch, dtype)
    x, r, scale, bias = _ln_inputs(rows, h, cuda, dt, seed=rows * h + 1)
    r = r if residual else None
    dy = torch.randn(rows, h, generator=torch.Generator().manual_seed(h)).to(cuda, dt)
    _, mean, rstd = fused_bert._add_layer_norm_kernel(x, r, scale, bias, 1e-12, save_stats=True)
    before = _form_counts()
    dx, dscale, dbias = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale,
                                                                   True, True)
    form = fused_bert.layer_norm_form(h, dt, True, backward=True)
    assert _rose(before, _form_counts()) == {f"F2 backward {form.removesuffix('_scalar')}": 1}
    plain = fused_bert.add_layer_norm_backward_reference(dy, x, r, mean, rstd, scale)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, scale, bias)]
    fused_bert.add_layer_norm_reference(leaves[0], r, leaves[1], leaves[2], 1e-12).backward(dy)
    for want in (plain[0], leaves[0].grad):
        if dtype == "bfloat16":
            assert _bf16_ulps(dx, want) <= BWD_ULPS
        else:
            torch.testing.assert_close(dx, want, atol=LN_F32_TOL, rtol=0)
    s = (x if r is None else x + r).float()
    xh = (s - mean[:, None]) * rstd[:, None]
    for got, want, t in zip((dscale, dbias), plain[1:], (dy.float() * xh, dy.float())):
        assert _colsum_ok(got, want, t)
    again = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale, True, True)
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, dscale, dbias)))
    assert _tickets_left_at_zero()
    # what is computed alone equals the full call's
    only_dx = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale, True, False)
    only_params = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale, False,
                                                             True)
    assert torch.equal(only_dx[0], dx)
    assert torch.equal(only_params[1], dscale) and torch.equal(only_params[2], dbias)


def test_entry_points_refuse_a_form_they_would_not_pick(cuda):
    """The C side checks the wrapper's form: a launch naming another one is
    refused before it runs."""
    from proqa_tpu_torch import _build

    x, r, scale, bias = _ln_inputs(4, 2048, cuda, torch.bfloat16, seed=3)
    out = torch.empty_like(x)
    warp = fused_bert.LN_FORMS.index("warp")  # the form of widths up to 1,024
    with pytest.raises(RuntimeError, match="proqa_add_layer_norm"):
        _build.launch("proqa_add_layer_norm", x.device, x.data_ptr(), r.data_ptr(),
                      scale.data_ptr(), bias.data_ptr(), out.data_ptr(), None, None, 4, 2048,
                      1e-12, 1, warp)
    y, b = _epilogue_inputs((4, 768), cuda, seed=4)
    o = torch.empty(4, 768, device=cuda, dtype=torch.bfloat16)
    wide = fused_bert.DENSE_FORMS.index("wide")
    with pytest.raises(RuntimeError, match="proqa_dense_epilogue"):
        _build.launch("proqa_dense_epilogue", y.device, y.data_ptr(), b.data_ptr(),
                      o.data_ptr(), None, 4, 768, 1, 0, wide)


# --- the search kernels at every embedding width (the K-loop forms) ---

# the narrowest widths the kernels take (TMA boxes and slices wider than the
# row), then chip_smoke.py phase 34 (a)'s; 128 runs the forms first built for it
WIDTHS = (16, 32, 48, 64, 96, 256, 384, 768, 1024)


def _width_inputs(q, n, d, device, dtype, seed):
    """Queries and corpus rows of unit scale at width d."""
    g = torch.Generator().manual_seed(seed)
    queries = torch.randn(q, d, generator=g) / d ** 0.5
    corpus = torch.randn(n, d, generator=g) / d ** 0.5
    return queries.to(device, dtype), corpus.to(device, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q", [32, 300])
@pytest.mark.parametrize("d", WIDTHS + (128,))
def test_block_maxima_at_every_width(cuda, d, q, dtype):
    """K1 over bf16 (the wgmma kernel's K loop) and over f32 (the FMA
    kernel's) at each width, one and two warpgroups / query tiles, over a
    corpus whose last group is partial (its rows past N score 0). MIPS_ATOL:
    f32 sums of d exact products of unit-scale rows in another order."""
    block, group = 16, 128
    queries, corpus = _width_inputs(q, block * group * 2 + block * 40, d, cuda,
                                    getattr(torch, dtype), seed=d + q)
    before = getattr(mips_kernel, _k1_counter(dtype))
    got = mips_kernel.block_maxima_grouped(queries, corpus, block=block, group=group)
    torch.cuda.synchronize()
    assert getattr(mips_kernel, _k1_counter(dtype)) == before + 1
    want = mips_kernel.block_maxima_grouped_reference(queries, corpus, block=block, group=group)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] == 3
        torch.testing.assert_close(g, w, atol=MIPS_ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["scales", "scale_bounds"])
@pytest.mark.parametrize("block", [16, 64])
@pytest.mark.parametrize("d", WIDTHS)
def test_int8_block_maxima_at_every_width(cuda, d, block, kind):
    """K5 and K7 (int8 codes widened slice by slice) at each width, against
    their plain versions, with test_int8_block_maxima_kernels_match_plain's
    tolerance (scores of ~100 summed in another order)."""
    g = torch.Generator().manual_seed(d + block)
    n = block * 128 * 2
    emb = torch.randn(n, d, generator=g) * torch.empty(n, 1).uniform_(0.25, 4.0, generator=g)
    codes, sc = quant.quantize_rows(emb.numpy(), block=1 if kind == "scale_bounds" else block)
    queries = torch.randn(300, d, generator=g).to(cuda, torch.bfloat16)
    codes, sc = torch.from_numpy(codes).to(cuda), torch.from_numpy(sc).to(cuda)
    kw, counter = _int8_kwargs(kind, sc, block)
    assert mips_kernel.kernel_for(torch.bfloat16, torch.int8, block=block, group=128,
                                  grouped=True, scaled=True) == "wgmma"
    before = getattr(mips_kernel, counter)
    got = mips_kernel.block_maxima_grouped(queries, codes, block=block, **kw)
    torch.cuda.synchronize()
    assert getattr(mips_kernel, counter) == before + 1
    want = mips_kernel.block_maxima_grouped_reference(queries, codes, block=block, **kw)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=MIPS_ATOL * 100, rtol=1e-6)


@pytest.mark.parametrize("d", WIDTHS)
def test_block_major_at_every_width(cuda, d):
    """K8 (the wgmma kernel's block-major store) at each width."""
    queries, corpus = _width_inputs(300, 8192, d, cuda, torch.bfloat16, seed=d)
    before = mips_kernel.block_major_launches
    got = mips_kernel.block_maxima(queries, corpus, block=32, tile_n=1024)
    torch.cuda.synchronize()
    assert mips_kernel.block_major_launches == before + 1
    want = mips_kernel.block_maxima_reference(queries, corpus, block=32, tile_n=1024)
    torch.testing.assert_close(got, want, atol=MIPS_ATOL, rtol=0)


@pytest.mark.parametrize("case", ["f32 over int8", "bf16 block 48", "f32 block-major"])
@pytest.mark.parametrize("d", WIDTHS + (128,))
def test_simple_body_at_every_width(cuda, d, case):
    """csrc/block_maxima.cu's body over 128-column slices: f32 queries over
    int8 codes, a block the Hopper kernels do not reduce at, and f32 K8,
    each over a partial last group where the entry takes one."""
    g = torch.Generator().manual_seed(d)
    if case == "f32 over int8":
        codes = torch.randint(-127, 128, (16 * 128 + 16 * 9, d), generator=g,
                              dtype=torch.int8).to(cuda)
        queries = torch.randn(70, d, generator=g).to(cuda)
        sc = (torch.rand(codes.shape[0] // 16, generator=g) * 0.01 + 1e-3).to(cuda)
        assert mips_kernel.kernel_for(torch.float32, torch.int8, block=16, group=128,
                                      grouped=True, scaled=True) == "simple"
        got = mips_kernel.block_maxima_grouped(queries, codes, block=16, scales=sc)
        want = mips_kernel.block_maxima_grouped_reference(queries, codes, block=16, scales=sc)
        atol = MIPS_ATOL * 100
    elif case == "bf16 block 48":
        queries, corpus = _width_inputs(70, 48 * 8 * 3 + 48, d, cuda, torch.bfloat16, seed=d)
        assert mips_kernel.kernel_for(torch.bfloat16, torch.bfloat16, block=48, group=8,
                                      grouped=True, scaled=False) == "simple"
        got = mips_kernel.block_maxima_grouped(queries, corpus, block=48, group=8)
        want = mips_kernel.block_maxima_grouped_reference(queries, corpus, block=48, group=8)
        atol = MIPS_ATOL
    else:
        queries, corpus = _width_inputs(70, 4096, d, cuda, torch.float32, seed=d)
        got = (mips_kernel.block_maxima(queries, corpus, block=32, tile_n=1024),)
        want = (mips_kernel.block_maxima_reference(queries, corpus, block=32, tile_n=1024),)
        atol = MIPS_ATOL
    torch.cuda.synchronize()
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=atol, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [16, 64])
@pytest.mark.parametrize("d", WIDTHS + (4096,))
def test_gather_rescore_at_every_width(cuda, d, block, dtype):
    """K6 and K9 (gather_score_wide_kernel) at each width, up to a 16 KB f32
    row (two rows a stage), against the plain gather and product: BMAX_TOL,
    f32 sums of d exact products of unit-scale rows in another order."""
    g = torch.Generator().manual_seed(d + block)
    nb, kb, q = 41, 33, 70
    corpus = (torch.randn(nb, block, d, generator=g) / d ** 0.5).to(cuda, getattr(torch, dtype))
    queries = (torch.randn(q, d, generator=g) / d ** 0.5).to(cuda, getattr(torch, dtype))
    ids = torch.randint(0, nb, (q, kb), generator=g).to(cuda)
    assert rescore.kernel_takes(d, getattr(torch, dtype))
    want = _rescore_reference(queries, corpus, ids, block)
    for fn, counter in ((rescore.gather_rescore, "launches"),
                        (rescore.gather_score, "score_launches")):
        before = getattr(rescore, counter)
        got = fn(queries, corpus, ids, block=block)
        torch.cuda.synchronize()
        assert getattr(rescore, counter) == before + 1
        torch.testing.assert_close(got, want, atol=BMAX_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [16, 64])
@pytest.mark.parametrize("d", [96, 768])
def test_gather_rescore_wide_at_the_search_shape(cuda, d, block, dtype):
    """K6's wide form at a search's shape (Q = 2,048, kb = 80 over 4,096
    blocks): thousands of turns of each ring stage a CTA, every candidate
    block of a query distinct, against the plain version. BMAX_TOL as above."""
    g = torch.Generator().manual_seed(d * block)
    nb, kb, q = 4096, 80, 2048
    corpus = (torch.randn(nb, block, d, generator=g) / d ** 0.5).to(cuda, getattr(torch, dtype))
    queries = (torch.randn(q, d, generator=g) / d ** 0.5).to(cuda, getattr(torch, dtype))
    ids = torch.argsort(torch.rand(q, nb, generator=g), dim=1)[:, :kb].to(cuda)
    got = rescore.gather_rescore(queries, corpus, ids, block=block)
    torch.testing.assert_close(got, _rescore_reference(queries, corpus, ids, block, chunk=16),
                               atol=BMAX_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 48, 96, 768])
def test_search_at_every_width_matches_reference(cuda, d, dtype):
    """mips_topk through K1 and K6 at a width other than 128, over an index
    whose rows end inside a block and inside the last group (searched where
    they lie), against the exact top-80 up to ties."""
    n_valid = 16 * 128 * 3 + 16 * 7 + 5
    queries, corpus = _width_inputs(300, 16 * 128 * 3 + 16 * 8, d, cuda, getattr(torch, dtype),
                                    seed=d)
    k1 = _k1_counter(dtype)
    before, before_k6 = getattr(mips_kernel, k1), rescore.launches
    gv, gi = mips.mips_topk(queries, corpus, 80, n_valid=n_valid)
    assert getattr(mips_kernel, k1) == before + 1 and rescore.launches == before_k6 + 1
    rv, ri = mips.mips_topk_reference(queries, corpus, 80, n_valid=n_valid)
    assert topk_disagreements(gv.cpu().numpy(), gi.cpu().numpy(), rv.cpu().numpy(),
                              ri.cpu().numpy(), atol=MIPS_ATOL) == 0
    assert (gi < n_valid).all()


def d128_outputs(device) -> dict:
    """Each search kernel's outputs at D = 128 on inputs drawn from seeds:
    K1 over bf16 and f32, K5, K7, K8, K6 over bf16 and f32, and the simple
    body (f32 queries over int8 codes)."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        queries, corpus = _mips_inputs(300, 16 * 128 * 3, device, dtype, seed=11)
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        out[f"K1 {name}"] = mips_kernel.block_maxima_grouped(queries, corpus, block=16)
        ids = torch.randint(0, 16 * 3 * 8, (300, 80),
                            generator=torch.Generator().manual_seed(12)).to(device)
        out[f"K6 {name}"] = (rescore.gather_rescore(queries, corpus.view(-1, 16, 128), ids,
                                                    block=16),)
        if dtype == torch.bfloat16:
            out["K8"] = (mips_kernel.block_maxima(queries, corpus, block=32, tile_n=1024),)
    for qdtype, kind in ((torch.bfloat16, "scales"), (torch.bfloat16, "scale_bounds"),
                         (torch.float32, "scales")):
        queries, codes, sc = _int8_inputs(300, 16 * 128 * 3, 16, device, qdtype, seed=13,
                                          per_row=kind == "scale_bounds")
        kw, _ = _int8_kwargs(kind, sc, 16)
        name = {"scales": "K5", "scale_bounds": "K7"}[kind]
        if qdtype == torch.float32:
            name = "simple K5 f32 queries"
        out[name] = mips_kernel.block_maxima_grouped(queries, codes, block=16, **kw)
    return out


def output_digests(outputs: dict) -> dict:
    import hashlib

    digests = {}
    for name, tensors in outputs.items():
        h = hashlib.sha256()
        for x in tensors:
            h.update(x.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
        digests[name] = h.hexdigest()
    return digests


# SHA-256 of d128_outputs as the forms first built for D = 128 gave them,
# before the K-loop forms existed (NVIDIA H100 80GB HBM3, 700 W; the same
# on the tree that added them): the D = 128 kernels are unchanged
D128_DIGESTS = {
    "K1 bf16": "6cccf0d06d937ee9352cb1ddd27336a7e8b17afb747a8fe8aae89d99930e6971",
    "K6 bf16": "3a814249290515077da7ec347f52308e4f8bcb4df5627dfe6721817b22d390c9",
    "K8": "646f8bf1dd995097f2dcf8607ce4345098ef78b37b4f17c31844a98e81f85b65",
    "K1 f32": "66856f5fef7e362015b3100abaed120502c951f523926c4de39148cf115f5bf6",
    "K6 f32": "daccfe0abe11f90e261473659ad15b4f3b3606d10e5ab7afebf7a8e871056bd7",
    "K5": "796ce7607e92b19fe65f3111ffca265f0acb246e4c0709c3bcb906a3b6fa2dca",
    "K7": "78440ceb6706f93a88460e2baac31630117cf49ba74ac864e129c786aad99566",
    "simple K5 f32 queries": "8c91dec1a49227c3cfc22f318045fcf232c6167a9178020017380939170c59f4"
}


def test_d128_outputs_are_bit_equal_to_the_first_forms(cuda):
    assert output_digests(d128_outputs(cuda)) == D128_DIGESTS


def attention_outputs(device) -> dict:
    """K2's and K3's outputs at head dims 16, 32, 64 and 128 (and 48, padded
    to 64) on inputs drawn from seeds: bf16 and f32, rates 0 and 0.1, random
    key padding with one all-padding row."""
    out = {}
    for dh in (16, 32, 64, 128, 48):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do, mask = _edge_inputs(384, dh, device, dtype)
            for rate in (0.0, 0.1):
                name = f"Dh {dh} {str(dtype)[6:]} rate {rate}"
                kw = dict(sm_scale=dh ** -0.5, dropout_rate=rate, seed=2**40 + dh)
                out[f"K2 {name}"] = (attention.fused_attention(q, k, v, mask, **kw),)
                out[f"K3 {name}"] = attention._backward_kernel(q, k, v, mask, do, kw["sm_scale"],
                                                               rate, kw["seed"])
    return out


# SHA-256 of attention_outputs as the kernels built for head dims up to 128
# gave them before the forms past 128 existed (NVIDIA H100 80GB HBM3, 700 W):
# those kernels are unchanged
ATTENTION_DIGESTS = {
    "K2 Dh 16 bfloat16 rate 0.0": "ab663c3efa6042c22fed8ac30da13af41bebfd65dd3f23113b006e6cf66e8b1a",
    "K3 Dh 16 bfloat16 rate 0.0": "c5802f1d50b20329044e8b7ac28fa15ae051f9e32140231c3e6703daed37a0f2",
    "K2 Dh 16 bfloat16 rate 0.1": "4580334ac448ded017be66f089423bd50d2fadd38adbf2e629f12999b63a2258",
    "K3 Dh 16 bfloat16 rate 0.1": "122679c8dd7d3716019441224bdcfed0f46e512e329c1ce73ba0451b3be938a2",
    "K2 Dh 16 float32 rate 0.0": "928b52ff817ff00a13bcbe51c81634b4b6307bbebf6bbd37cb9da4c74fe10430",
    "K3 Dh 16 float32 rate 0.0": "cbb0bcf2be81f643ca8889c6330509564993b75abcb245824d17959c91a83861",
    "K2 Dh 16 float32 rate 0.1": "4d8c7eb0ff8d3c00b93862fa1f3e704d470fa8ee99bff52944e72d46dd6919d8",
    "K3 Dh 16 float32 rate 0.1": "fd9ef34997f260b1d2c1e22cdef2f8169b0cb7d652fdf897f5d98be62e643f4d",
    "K2 Dh 32 bfloat16 rate 0.0": "e57d10b44a98b0b04829259fe6e4a1a5009fb9792bc3c070691841a9436cb746",
    "K3 Dh 32 bfloat16 rate 0.0": "4218f190199fd9e1b32515fc532cbe60166110a215eff9c578f21dcfcda6c436",
    "K2 Dh 32 bfloat16 rate 0.1": "a978eef046303b48737956290ca7862ccf28e583d8bc15c46bfa65d7dad3bdab",
    "K3 Dh 32 bfloat16 rate 0.1": "166c15c1acb9d70f360d0f911f50db6400f631e2b6575b786f791d2c08be7c96",
    "K2 Dh 32 float32 rate 0.0": "bf946e6d7ba009a2a14d43401a8ab64cbb65a9c8331bfe63164bf0ce1e5db176",
    "K3 Dh 32 float32 rate 0.0": "20d365aba6f1ceb82045304bee37502601743f2a15c75fe9d09708ed8dfb2977",
    "K2 Dh 32 float32 rate 0.1": "089f37b00b903afba9600451a283ba5a1a5e214cf314c1be693f4b7e76cf052c",
    "K3 Dh 32 float32 rate 0.1": "dbf290882773c8df2e25bcda7e64c49b2534b98104fba8fe28a3c0717028319d",
    "K2 Dh 64 bfloat16 rate 0.0": "f22119d5b9249dca7dff33d7a94fcf7c01633dd127c5a3358e611fc918ac04b5",
    "K3 Dh 64 bfloat16 rate 0.0": "06b9d915cdbb841405e78c9e0e52b3bb834a806493a5f84d15234da0b0e77e4d",
    "K2 Dh 64 bfloat16 rate 0.1": "c4c591d402c9e3969739e9d6bc1ec8e59772717ba069af9662d1f7ca44f2eb80",
    "K3 Dh 64 bfloat16 rate 0.1": "2799efec087c32909a48debf3e31a0f8ff28d447d0a735edc1eaac6a0407602d",
    "K2 Dh 64 float32 rate 0.0": "00bee581d522a54ac0cc313d0873949cc342ca83117ee90a21e925da8a972700",
    "K3 Dh 64 float32 rate 0.0": "c5751fd34883d76000df2088f4d262f97c05855b9107ceba169e78309d76ab2a",
    "K2 Dh 64 float32 rate 0.1": "c5ccc81a83504295ff1f3e5bc3b425033173cb737f63020f56d9cb5bc375a6a1",
    "K3 Dh 64 float32 rate 0.1": "96f294d6f9ea3090cfec74a72c8a284671986688bb82b0cf38a3b6873b378489",
    "K2 Dh 128 bfloat16 rate 0.0": "4c79c75446fa74896a1dc59f166f4a4f83c18c62e66730e9ae325125459c2d5d",
    "K3 Dh 128 bfloat16 rate 0.0": "d8fab97568a975e93024ab8424351661bc2d6f5231d48dc0128f0fb72798d76d",
    "K2 Dh 128 bfloat16 rate 0.1": "33d19eb48911e23f930e31be9214e4cead09d6aa38d67fc1bcc8aede6c454d58",
    "K3 Dh 128 bfloat16 rate 0.1": "67db8d636ef1dc2a0ac66e4c382645b25cb83355bb246cade8e05de87602e55e",
    "K2 Dh 128 float32 rate 0.0": "278227f353b0524e8d91a11127773c163c62ec2e5693dd88deb1e4540dfa6139",
    "K3 Dh 128 float32 rate 0.0": "0b3f81ed6bcf6026417f36bafc600dbfdb3b118aac62c4176e5c9337bd103333",
    "K2 Dh 128 float32 rate 0.1": "74c1f8cabd0b20f111c5975f915e190bdc24cd38484c575052c119205b785af2",
    "K3 Dh 128 float32 rate 0.1": "2599bb756433c8146785b85ecae8e2c4e3b64a90250f88ac4f5fb54d8728a440",
    "K2 Dh 48 bfloat16 rate 0.0": "ee452ac15794d54a2bb49a0cd4db029bf19679c2a3e9c844ddcf29e82e36746c",
    "K3 Dh 48 bfloat16 rate 0.0": "7f83acfe6b878b72027525732416d9e2caa5d1fe0950255844fed912db2daad6",
    "K2 Dh 48 bfloat16 rate 0.1": "3a01b306a95e3b8df7c875d05763f97d770303a46692369dd57b27b7889641d5",
    "K3 Dh 48 bfloat16 rate 0.1": "d231feb1f4deecf2f2c5de8017bde9f9cb5cfac77a0a8e67b126284750598349",
    "K2 Dh 48 float32 rate 0.0": "53bdb2735a525c7ccb873702132a8fd0f6b82d205f359950ce400b27a3638d73",
    "K3 Dh 48 float32 rate 0.0": "4d2b71e591ecdae51a0e4e209d104e563d2083caa6617e8a1712107b09e684ce",
    "K2 Dh 48 float32 rate 0.1": "0330e2e69ba4516d0bbc1733d55e22a230bdbebaa8f8851940894df973fd0ad8",
    "K3 Dh 48 float32 rate 0.1": "edc6cb4ae4c77746e772354c96fd972083e07aca06024af60715d4bf65c8cba2",
}


def test_attention_outputs_to_dh128_are_bit_equal_to_the_first_forms(cuda):
    assert output_digests(attention_outputs(cuda)) == ATTENTION_DIGESTS
