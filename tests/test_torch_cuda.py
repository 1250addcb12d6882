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
from proqa_tpu_torch.ops import attention, mips, mips_kernel  # noqa: E402
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
