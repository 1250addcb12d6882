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
from proqa_tpu_torch.ops import attention, mips, mips_kernel, quant, rescore  # noqa: E402
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
@pytest.mark.parametrize("t,dh", [(128, 64), (512, 64), (256, 16), (1024, 64), (128, 16)])
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,block,group", [(300, 16, 128), (64, 32, 8), (2048, 16, 128)])
def test_block_maxima_kernel_matches_plain(cuda, q, block, group, dtype):
    queries, corpus = _mips_inputs(q, block * group * 3, cuda, getattr(torch, dtype), seed=q)
    before = mips_kernel.launches
    got = mips_kernel.block_maxima_grouped(queries, corpus, block=block, group=group)
    torch.cuda.synchronize()
    assert mips_kernel.launches == before + 1
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


@pytest.mark.parametrize("block", mips_kernel.WGMMA_BLOCKS)
def test_wgmma_pipeline_with_n_valid_inside_a_block(cuda, block):
    """mips_topk_v2 through the Hopper K1 over a corpus whose last real row
    falls inside a block: the blocks past it are masked, the straddling one
    patched; every real score is negative, so an unmasked zero padding row
    would win."""
    n_valid = 128 * block + 3 * block + block // 2
    queries, corpus = _mips_inputs(64, n_valid, cuda, torch.bfloat16, seed=block, negative=True)
    before = mips_kernel.launches
    gv, gi = mips_kernel.mips_topk_v2(queries, corpus, 80, block=block, n_valid=n_valid)
    assert mips_kernel.launches == before + 1
    rv, ri = mips.mips_topk_reference(queries, corpus, 80, n_valid=n_valid)
    assert topk_disagreements(gv.cpu().numpy(), gi.cpu().numpy(), rv.cpu().numpy(),
                              ri.cpu().numpy(), atol=MIPS_ATOL) == 0
    assert (gi < n_valid).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mips_topk_on_gpu_matches_reference(cuda, dtype):
    queries, corpus = _mips_inputs(256, 9000, cuda, getattr(torch, dtype), seed=6,
                                   negative=True)
    before = mips_kernel.launches
    gv, gi = mips.mips_topk(queries, corpus, 80, n_valid=8995)
    assert mips_kernel.launches == before + 1
    rv, ri = mips.mips_topk_reference(queries, corpus, 80, n_valid=8995)
    assert topk_disagreements(gv.cpu().numpy(), gi.cpu().numpy(), rv.cpu().numpy(),
                              ri.cpu().numpy(), atol=MIPS_ATOL) == 0
    assert (gi < 8995).all()


def test_kernels_reject_what_they_do_not_take(cuda):
    q, c = _mips_inputs(64, 2048, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="D=128"):
        mips_kernel.block_maxima_grouped(q[:, :64].contiguous(), c[:, :64].contiguous(),
                                         block=16)
    with pytest.raises(TypeError):
        mips_kernel.block_maxima_grouped(q, c.float(), block=16)
    q, k, v, mask = _attention_inputs(128, 2, 2, 48, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        attention.fused_attention(q, k, v, mask, sm_scale=0.1)


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
    assert (rescore.launches, mips_kernel.block_major_launches) == (before[0] + 1, before[1] + 1)

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
    with pytest.raises(ValueError, match="D=128"):
        mips_kernel.block_maxima(q[:, :64].contiguous(), c[:, :64].contiguous(), block=16,
                                 tile_n=128)
    ids = torch.zeros(64, 4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        rescore.gather_rescore(q, c.float().view(128, 16, 128), ids, block=16)
    with pytest.raises(TypeError):
        rescore.gather_score(q, c.view(128, 16, 128), ids.float(), block=16)
    with pytest.raises(ValueError, match="D=128"):
        rescore.gather_rescore(q[:, :64].contiguous(), c[:, :64].contiguous().view(128, 16, 64),
                               ids, block=16)
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
@pytest.mark.parametrize("t,dh", [(128, 64), (512, 64), (256, 16)])
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
@pytest.mark.parametrize("t,dh", [(128, 64), (512, 64), (256, 16), (1024, 64)])
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
@pytest.mark.parametrize("dh", [16, 64])
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
    held to 2 * lr, the gradients to 1e-4 of each tensor's largest."""
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
                        {k: p.detach().cpu() for k, p in state.params.items()}))
    (loss_c, grads_c, params_c), (loss_g, grads_g, params_g) = results
    assert abs(loss_c - loss_g) < 1e-5
    for k, gc in grads_c.items():
        torch.testing.assert_close(grads_g[k], gc, atol=1e-4 * gc.abs().max().item() + 1e-9,
                                   rtol=0)
        torch.testing.assert_close(params_g[k], params_c[k], atol=2 * lr, rtol=0)
