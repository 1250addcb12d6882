"""Port parity at every head dim the JAX attention kernel takes: the port's
`fused_attention` and its VJP against the JAX package's (Pallas interpret
mode, rate 0) at head dims 32 and 128, which kernels K2/K3 are built for, and
at 26 and 48, which the card pads to the next built head dim; the padding
helper against the unpadded plain version; and two-layer towers at MiniLM's
widths (hidden 384, 12 heads of 32, intermediate 1,536) and at 8 heads of 128
(hidden 1,024) with `flash_attention` on, against the JAX encoder and one
train step's gradients. On the CPU the wrapper runs its plain versions,
which take any head dim as it is: the padding runs only on the card
(tests/test_torch_cuda.py)."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from proqa_tpu.models import bert as jax_bert  # noqa: E402
from proqa_tpu.models.retriever import init_retriever_params, retriever_forward  # noqa: E402
from proqa_tpu.ops.pallas_attention import fused_attention as jax_fused_attention  # noqa: E402
from proqa_tpu.train import retriever_trainer as jax_trainer  # noqa: E402
from proqa_tpu_torch.models import bert as torch_bert  # noqa: E402
from proqa_tpu_torch.models import convert  # noqa: E402
from proqa_tpu_torch.models.bert import BertConfig  # noqa: E402
from proqa_tpu_torch.models.retriever import Retriever  # noqa: E402
from proqa_tpu_torch.ops import attention  # noqa: E402
from proqa_tpu_torch.train.retriever_trainer import in_batch_loss  # noqa: E402

# the tolerances of tests/test_torch_attention.py (forward TOL, backward
# BWD_TOL) and tests/test_torch_bert.py (encoder TOL), with their reasons there
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
ENCODER_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# the padded plain version against the unpadded one, f32: the zero columns
# add exact zeros, but a product of another inner length may sum in another
# order (a few f32 ulps of outputs of magnitude ~1)
PAD_TOL = 1e-6
# one train step's f32 gradients against jax.grad, as a share of each
# tensor's largest JAX gradient: other summation orders over two layers
# (measured at most 7e-6 of it, both configurations)
GRAD_REL = 1e-4
# the bf16 towers, in bf16 ulps at the magnitude of the largest output: at
# these widths the products sum 384 to 4,096 terms in another order than
# XLA's, and a flipped bf16 rounding early on grows through LayerNorm and the
# next layer. Measured 2 ulps (0.0625 at magnitudes in [4, 8)) with the
# fused attention path and the same with the vanilla one, at both widths
TOWER_BF16_ULPS = 4

HEAD_DIMS = [32, 128, 26, 48]  # built for 32 and 128; 26 and 48 padded on the card


def _inputs(t, dh, seed=0, b=2, h=2):
    rng = np.random.default_rng(seed + dh)
    q, k, v, do = (rng.standard_normal((b, h, t, dh)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, t), np.int32)
    mask[0, t // 3:] = 0  # padded tail
    mask[1, :] = 0        # all padding: uniform attention, never NaN
    return q, k, v, do, mask


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_fused_attention_matches_jax_at_head_dim(dh, t, dtype):
    q, k, v, _, mask = _inputs(t, dh)
    scale = 1.0 / np.sqrt(dh)
    want = jax_fused_attention(*(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)),
                               jnp.asarray(mask), sm_scale=scale, interpret=True)
    got = attention.fused_attention(*(_to_torch(x, dtype) for x in (q, k, v)),
                                    torch.from_numpy(mask), sm_scale=scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=ATTN_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_fused_attention_vjp_matches_jax_at_head_dim(dh, t, dtype):
    q, k, v, do, mask = _inputs(t, dh, seed=1)
    scale = 1.0 / np.sqrt(dh)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_fused_attention(
        q_, k_, v_, jnp.asarray(mask), sm_scale=scale, interpret=True),
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jdt))]
    leaves = [_to_torch(x, dtype).requires_grad_(True) for x in (q, k, v)]
    attention.fused_attention(*leaves, torch.from_numpy(mask),
                              sm_scale=scale).backward(_to_torch(do, dtype))
    for x, w in zip(leaves, want):
        assert x.grad.dtype == getattr(torch, dtype) and x.grad.shape == q.shape
        np.testing.assert_allclose(x.grad.float().numpy(), w, atol=BWD_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dh,built", [(1, 16), (16, 16), (17, 32), (26, 32), (32, 32),
                                      (48, 64), (64, 64), (65, 128), (80, 128), (128, 128)])
def test_kernel_head_dim(dh, built):
    assert attention.kernel_head_dim(dh) == built
    assert built in attention.HEAD_DIMS


@pytest.mark.parametrize("dh", [129, 160, 256])
def test_kernel_head_dim_raises_above_128(dh):
    with pytest.raises(ValueError, match="head dim"):
        attention.kernel_head_dim(dh)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dh", [26, 48, 80, 100])
def test_padded_plain_version_matches_unpadded(dh, rate):
    """Pad q, k, v (and do) to the next built head dim, run the plain
    versions, slice: the unpadded plain versions' numbers, forward and
    backward, with dropout too (the mask does not depend on Dh)."""
    q, k, v, do, mask = (torch.from_numpy(x) for x in _inputs(256, dh, seed=2))
    kw = dict(sm_scale=dh ** -0.5, dropout_rate=rate, seed=2**40 + dh)
    built = attention.kernel_head_dim(dh)
    padded = [attention.pad_head_dim(x, built) for x in (q, k, v, do)]
    assert all(p.shape[-1] == built and p.is_contiguous() for p in padded)
    assert all(torch.equal(p[..., :dh], x) and not p[..., dh:].any()
               for p, x in zip(padded, (q, k, v, do)))
    got = attention.fused_attention_reference(*padded[:3], mask, **kw)
    want = attention.fused_attention_reference(q, k, v, mask, **kw)
    assert not got[..., dh:].any()  # zero columns of v give zero output columns
    torch.testing.assert_close(got[..., :dh], want, atol=PAD_TOL, rtol=0)
    got = attention.fused_attention_backward_reference(*padded[:3], mask, padded[3], **kw)
    want = attention.fused_attention_backward_reference(q, k, v, mask, do, **kw)
    for g, w in zip(got, want):
        assert not g[..., dh:].any()
        torch.testing.assert_close(g[..., :dh], w, atol=PAD_TOL, rtol=0)


@pytest.mark.parametrize("dh", [26, 160])
def test_cpu_route_never_pads(monkeypatch, dh):
    """On the CPU the encoder hands the plain version q, k, v at their own
    head dim (above 128 too): the padding helper is not called."""
    calls = []
    real = torch_bert.pad_head_dim
    monkeypatch.setattr(torch_bert, "pad_head_dim",
                        lambda x, d: (calls.append((x.shape[-1], d)), real(x, d))[1])
    cfg = BertConfig.tiny(hidden_size=2 * dh, num_heads=2, max_position_embeddings=128,
                          flash_attention=True, dtype=torch.float32)
    model = Retriever(cfg).reset_parameters(0).eval()
    ids = torch.randint(5, 128, (2, 128), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        emb = model.encode_context(ids, torch.ones(2, 128, dtype=torch.int32))
    assert torch.isfinite(emb).all()
    assert calls and all(d == dh == x for x, d in calls)


# two-layer towers at the widths of MiniLM-L12-H384 (microsoft/MiniLM-L12-H384-
# uncased's config.json) and of 8 heads of 128
TOWERS = {"minilm": dict(hidden_size=384, num_heads=12, intermediate_size=1536),
          "dh128": dict(hidden_size=1024, num_heads=8, intermediate_size=4096)}


def _configs(tower, dtype, **extra):
    kw = dict(vocab_size=512, num_layers=2, max_position_embeddings=128, flash_attention=True,
              **TOWERS[tower], **extra)
    return (jax_bert.BertConfig(dtype=getattr(jnp, dtype), **kw),
            BertConfig(dtype=getattr(torch, dtype), **kw))


_PARAMS = {}


def _jax_params(tower):
    if tower not in _PARAMS:
        jcfg, _ = _configs(tower, "float32")
        _PARAMS[tower] = jax.tree.map(
            np.asarray, init_retriever_params(jax.random.PRNGKey(7), jcfg))
    return _PARAMS[tower]


def _batch(seed=0, b=4, tq=16, tc=128):
    """Contexts at T = 128 (the fused path), questions at T = 16 (vanilla);
    one context row all padding, one half."""
    rng = np.random.default_rng(seed)
    ids_c = rng.integers(5, 512, size=(b, tc)).astype(np.int32)
    mask_c = (np.arange(tc)[None] < np.array([tc, tc // 2, 9, 0])[:, None]).astype(np.int32)
    ids_q = rng.integers(5, 512, size=(b, tq)).astype(np.int32)
    return {"input_ids_q": ids_q, "input_mask_q": np.ones((b, tq), np.int32),
            "input_ids_c": ids_c * mask_c, "input_mask_c": mask_c}


def _model(tower, tcfg):
    model = Retriever(tcfg)
    model.load_state_dict(convert.params_from_jax(_jax_params(tower)))
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tower", list(TOWERS))
def test_tower_at_head_dim_matches_jax(tower, dtype):
    jcfg, tcfg = _configs(tower, dtype)
    assert tcfg.head_dim == {"minilm": 32, "dh128": 128}[tower]
    batch = _batch()
    ids, mask = batch["input_ids_c"], batch["input_mask_c"]
    jseq, jpooled = jax_bert.bert_encoder(_jax_params(tower)["bert_c"], jcfg, jnp.asarray(ids),
                                          jnp.asarray(mask))
    with torch.no_grad():
        tseq, tpooled = _model(tower, tcfg).eval().bert_c(torch.from_numpy(ids).long(),
                                                          torch.from_numpy(mask))
    assert tseq.dtype == getattr(torch, dtype)
    for got, want in ((tseq, jseq), (tpooled, jpooled)):
        want = np.asarray(want.astype(jnp.float32))
        atol = ENCODER_TOL[dtype]
        if dtype == "bfloat16":
            atol = TOWER_BF16_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("tower", list(TOWERS))
def test_train_step_gradients_at_head_dim_match_jax(tower):
    """One retriever step's loss and gradients (f32, dropout 0, remat): the
    context tower's attention runs the fused path on both sides."""
    jcfg, tcfg = _configs(tower, "float32", hidden_dropout=0.0, attention_dropout=0.0)
    tcfg = dataclasses.replace(tcfg, remat=True)
    params = _jax_params(tower)
    batch = _batch(seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_trainer.in_batch_loss(retriever_forward(p, jcfg, jbatch))[0])(params)
    model = _model(tower, tcfg).train()
    tbatch = {k: torch.from_numpy(v).long() if k.startswith("input_ids") else torch.from_numpy(v)
              for k, v in batch.items()}
    loss_t, _ = in_batch_loss(model(tbatch, generator=torch.Generator().manual_seed(0)))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) < ENCODER_TOL["float32"]
    got = convert.params_to_jax({k: p.grad.detach() for k, p in model.named_parameters()})
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(grads_j)):
        keys = tuple(p.key for p in path)
        # zero in exact arithmetic, rounding noise on both sides (a constant
        # added to every score of a softmax row): tests/test_torch_train.py
        if keys[-3:] == ("layers", "k", "bias") or keys == ("proj_c", "bias"):
            continue
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, atol=GRAD_REL * np.abs(b).max(), rtol=0,
                                   err_msg=str(path))
