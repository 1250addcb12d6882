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
