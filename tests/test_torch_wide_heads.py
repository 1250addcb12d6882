"""Port parity at head dims past 128: the port's `fused_attention` and its VJP
against the JAX package's (Pallas interpret mode, rate 0) at head dims 192,
256, 384 and 768; the padding rule past 128 (`kernel_head_dim`: 256, then
multiples of 128) and the padded plain versions against the unpadded ones;
and two-layer towers at BERT-base's widths (hidden 768, intermediate 3,072)
with 3 heads of 256, 2 of 384 and 1 of 768, `flash_attention` on, against
the JAX encoder and one train step's gradients. On the CPU the wrapper runs
its plain versions at the head dim as it is; the card's forms (the Dh 256
instantiations and the loop forms past it) are held to the same plain
versions by tests/test_torch_cuda.py."""
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
from proqa_tpu_torch.models import convert  # noqa: E402
from proqa_tpu_torch.models.bert import BertConfig  # noqa: E402
from proqa_tpu_torch.models.retriever import Retriever  # noqa: E402
from proqa_tpu_torch.ops import attention  # noqa: E402
from proqa_tpu_torch.train.retriever_trainer import in_batch_loss  # noqa: E402

# the tolerances of tests/test_torch_head_dims.py, with their reasons there
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
ENCODER_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
PAD_TOL = 1e-6
GRAD_REL = 1e-4
TOWER_BF16_ULPS = 4

# Gemma's head dim (256; 192 reaches it padded) and the loop forms' 384 and 768
HEAD_DIMS = [192, 256, 384, 768]


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
def test_fused_attention_matches_jax_at_wide_head_dim(dh, t, dtype):
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
def test_fused_attention_vjp_matches_jax_at_wide_head_dim(dh, t, dtype):
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


@pytest.mark.parametrize("dh,built", [(129, 256), (192, 256), (255, 256), (256, 256),
                                      (257, 384), (320, 384), (384, 384), (385, 512),
                                      (768, 768), (1000, 1024), (4096, 4096)])
def test_kernel_head_dim_past_128(dh, built):
    """(128, 256] pads to 256, the Dh 256 form; past it, to the next multiple
    of 128, the loop forms' chunk."""
    assert attention.kernel_head_dim(dh) == built


def test_no_head_dim_up_to_4096_raises():
    """Every head dim from 1 to 4,096 has a form: itself or the next larger
    native one, or past 256 the next multiple of 128 (under 128 columns of
    padding); only a head dim below 1 raises."""
    for dh in range(1, 4097):
        built = attention.kernel_head_dim(dh)
        assert built >= dh
        if dh <= attention.HEAD_DIMS[-1]:
            assert built in attention.HEAD_DIMS
        else:
            assert built % attention.LOOP_CHUNK == 0 and built - dh < attention.LOOP_CHUNK
    for dh in (0, -1):
        with pytest.raises(ValueError, match="head dim"):
            attention.kernel_head_dim(dh)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dh", [160, 192, 320, 500])
def test_padded_plain_version_matches_unpadded_past_128(dh, rate):
    """Pad q, k, v (and do) to the head dim the card runs (256, 384, 512),
    run the plain versions, slice: the unpadded plain versions' numbers,
    forward and backward, with dropout too."""
    q, k, v, do, mask = (torch.from_numpy(x) for x in _inputs(128, dh, seed=2))
    kw = dict(sm_scale=dh ** -0.5, dropout_rate=rate, seed=2**40 + dh)
    built = attention.kernel_head_dim(dh)
    assert built > dh
    padded = [attention.pad_head_dim(x, built) for x in (q, k, v, do)]
    assert all(p.shape[-1] == built and p.is_contiguous() for p in padded)
    got = attention.fused_attention_reference(*padded[:3], mask, **kw)
    want = attention.fused_attention_reference(q, k, v, mask, **kw)
    assert not got[..., dh:].any()
    torch.testing.assert_close(got[..., :dh], want, atol=PAD_TOL, rtol=0)
    got = attention.fused_attention_backward_reference(*padded[:3], mask, padded[3], **kw)
    want = attention.fused_attention_backward_reference(q, k, v, mask, do, **kw)
    for g, w in zip(got, want):
        assert not g[..., dh:].any()
        torch.testing.assert_close(g[..., :dh], w, atol=PAD_TOL, rtol=0)


# two-layer towers at BERT-base's widths with heads of 256 (Gemma's and
# EmbeddingGemma's attention width), 384 and 768
TOWERS = {3: 256, 2: 384, 1: 768}


def _configs(heads, dtype, **extra):
    kw = dict(vocab_size=512, num_layers=2, max_position_embeddings=128, flash_attention=True,
              hidden_size=768, num_heads=heads, intermediate_size=3072, **extra)
    return (jax_bert.BertConfig(dtype=getattr(jnp, dtype), **kw),
            BertConfig(dtype=getattr(torch, dtype), **kw))


_PARAMS = {}


def _jax_params(heads):
    if heads not in _PARAMS:
        jcfg, _ = _configs(heads, "float32")
        _PARAMS[heads] = jax.tree.map(
            np.asarray, init_retriever_params(jax.random.PRNGKey(9), jcfg))
    return _PARAMS[heads]


def _batch(seed=0, b=4, tq=16, tc=128):
    """Contexts at T = 128 (the fused path), questions at T = 16 (vanilla);
    one context row all padding, one half."""
    rng = np.random.default_rng(seed)
    ids_c = rng.integers(5, 512, size=(b, tc)).astype(np.int32)
    mask_c = (np.arange(tc)[None] < np.array([tc, tc // 2, 9, 0])[:, None]).astype(np.int32)
    ids_q = rng.integers(5, 512, size=(b, tq)).astype(np.int32)
    return {"input_ids_q": ids_q, "input_mask_q": np.ones((b, tq), np.int32),
            "input_ids_c": ids_c * mask_c, "input_mask_c": mask_c}


def _model(heads, tcfg):
    model = Retriever(tcfg)
    model.load_state_dict(convert.params_from_jax(_jax_params(heads)))
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", list(TOWERS))
def test_tower_at_wide_head_dim_matches_jax(heads, dtype):
    jcfg, tcfg = _configs(heads, dtype)
    assert tcfg.head_dim == TOWERS[heads]
    batch = _batch()
    ids, mask = batch["input_ids_c"], batch["input_mask_c"]
    jseq, jpooled = jax_bert.bert_encoder(_jax_params(heads)["bert_c"], jcfg, jnp.asarray(ids),
                                          jnp.asarray(mask))
    with torch.no_grad():
        tseq, tpooled = _model(heads, tcfg).eval().bert_c(torch.from_numpy(ids).long(),
                                                          torch.from_numpy(mask))
    assert tseq.dtype == getattr(torch, dtype)
    for got, want in ((tseq, jseq), (tpooled, jpooled)):
        want = np.asarray(want.astype(jnp.float32))
        atol = ENCODER_TOL[dtype]
        if dtype == "bfloat16":
            atol = TOWER_BF16_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("heads", list(TOWERS))
def test_train_step_gradients_at_wide_head_dim_match_jax(heads):
    """One retriever step's loss and gradients (f32, dropout 0, remat): the
    context tower's attention runs the fused path on both sides."""
    jcfg, tcfg = _configs(heads, "float32", hidden_dropout=0.0, attention_dropout=0.0)
    tcfg = dataclasses.replace(tcfg, remat=True)
    params = _jax_params(heads)
    batch = _batch(seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_trainer.in_batch_loss(retriever_forward(p, jcfg, jbatch))[0])(params)
    model = _model(heads, tcfg).train()
    tbatch = {k: torch.from_numpy(v).long() if k.startswith("input_ids") else torch.from_numpy(v)
              for k, v in batch.items()}
    loss_t, _ = in_batch_loss(model(tbatch, generator=torch.Generator().manual_seed(0)))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) < ENCODER_TOL["float32"]
    got = convert.params_to_jax({k: p.grad.detach() for k, p in model.named_parameters()})
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(grads_j)):
        keys = tuple(p.key for p in path)
        # zero in exact arithmetic, rounding noise on both sides
        # (tests/test_torch_head_dims.py)
        if keys[-3:] == ("layers", "k", "bias") or keys == ("proj_c", "bias"):
            continue
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, atol=GRAD_REL * np.abs(b).max(), rtol=0,
                                   err_msg=str(path))
