"""The BERT layer's fused epilogues (ops/fused_bert.py: F1, the dense
epilogue; F2, the residual add with LayerNorm) against the JAX package, and
the model's route between them and its differentiable ops.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
are held against those on the card (tests/test_torch_cuda.py). Inputs are
made with numpy from a seed and fed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from proqa_tpu.models import bert as jax_bert  # noqa: E402
from proqa_tpu.models import retriever as jax_retriever  # noqa: E402
from proqa_tpu_torch.models import bert  # noqa: E402
from proqa_tpu_torch.models import convert  # noqa: E402
from proqa_tpu_torch.models.retriever import Retriever  # noqa: E402
from proqa_tpu_torch.ops import fused_bert  # noqa: E402

EPS = 1e-12
# F2 in f32: the same arithmetic, the row sums in another order than XLA's
LN_F32_ATOL = 1e-6
# the BERT tower against JAX: tests/test_torch_bert.py's tolerances and reasons
TOWER_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _bf16_ulp(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """One bf16 ulp at the larger magnitude of the two, elementwise (8
    significant bits: an ulp is 2^(exponent - 7))."""
    mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float64)
    return np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)


def _bf16_ulps(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| in bf16 ulps (_bf16_ulp)."""
    return float(np.max(np.abs(got.astype(np.float64) - want) / _bf16_ulp(got, want)))


def _to_np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _product(rows: int, cols: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """An f32 product of unit scale (a BERT layer's pre-activation) and a bias."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((rows, cols)).astype(np.float32) * 2.0
    b = rng.standard_normal(cols).astype(np.float32) * 0.1
    return y, b


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,cols", [(37, 768), (5, 3072), (16, 2), (3, 1)])
def test_dense_epilogue_reference_equals_jax(rows, cols, dtype):
    y, b = _product(rows, cols, seed=cols + rows)
    want = (jnp.asarray(y) + jnp.asarray(b)).astype(getattr(jnp, dtype))
    got = fused_bert.dense_epilogue_reference(torch.from_numpy(y), torch.from_numpy(b),
                                              getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_to_np(got), _to_np(want))


@pytest.mark.parametrize("rows,cols", [(37, 3072), (64, 64)])
def test_dense_epilogue_gelu_reference_matches_jax(rows, cols):
    """Both rounding points of bert.py:273-274: within one bf16 ulp, the CPU
    erf implementations of XLA and ATen differing in the last f32 bits. Below
    x = -3 ATen's expression adds |x| 2^-24 more: 1 + erf(x / sqrt 2) cancels
    in f32 (at x = -6.3 it gives 0 where XLA's gelu gives -8.7e-10)."""
    y, b = _product(rows, cols, seed=cols)
    t = (jnp.asarray(y) + jnp.asarray(b)).astype(jnp.bfloat16)
    want = jax.nn.gelu(t.astype(jnp.float32), approximate=False).astype(jnp.bfloat16)
    got = fused_bert.dense_epilogue_reference(torch.from_numpy(y), torch.from_numpy(b),
                                              torch.bfloat16, gelu=True)
    assert got.dtype == torch.bfloat16
    got, want, x = _to_np(got), _to_np(want), _to_np(t)
    cancel = np.abs(x) * 2.0 ** -24
    assert np.all(np.abs(got - want) <= _bf16_ulp(got, want) + cancel)
    assert _bf16_ulps(got[x > -3], want[x > -3]) <= 1.0


def _ln_inputs(rows: int, h: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, h)).astype(np.float32)
    r = rng.standard_normal((rows, h)).astype(np.float32) * 0.5 + 0.25
    scale = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(h)).astype(np.float32)
    return x, r, scale, bias


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("h", [32, 768])
def test_add_layer_norm_reference_matches_jax(h, residual, dtype):
    """F2's plain version against _layer_norm(x + r) (bert.py:137-144, :277,
    :286): within one bf16 ulp in bf16, LN_F32_ATOL in f32."""
    x, r, scale, bias = _ln_inputs(41, h, seed=h + residual)
    jx, jr = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, r))
    want = jax_bert._layer_norm(jx + jr if residual else jx,
                                {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, EPS)
    tx, tr = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, r))
    got = fused_bert.add_layer_norm_reference(tx, tr if residual else None,
                                              torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        assert _bf16_ulps(_to_np(got), _to_np(want)) <= 1.0
    else:
        np.testing.assert_allclose(_to_np(got), _to_np(want), atol=LN_F32_ATOL, rtol=0)


def test_cpu_wrappers_run_the_plain_versions():
    """On the CPU the wrappers are their plain versions bit for bit and
    launch nothing; another device raises."""
    y, b = _product(9, 64, seed=1)
    x, r, scale, bias = (torch.from_numpy(a) for a in _ln_inputs(9, 64, seed=2))
    before = fused_bert.launches("F1"), fused_bert.launches("F2")
    for gelu in (False, True):
        assert torch.equal(
            fused_bert.dense_epilogue(torch.from_numpy(y), torch.from_numpy(b), torch.bfloat16,
                                      gelu),
            fused_bert.dense_epilogue_reference(torch.from_numpy(y), torch.from_numpy(b),
                                                torch.bfloat16, gelu))
    for res in (r.bfloat16(), None):
        assert torch.equal(fused_bert.add_layer_norm(x.bfloat16(), res, scale, bias, EPS),
                           fused_bert.add_layer_norm_reference(x.bfloat16(), res, scale, bias,
                                                               EPS))
    assert (fused_bert.launches("F1"), fused_bert.launches("F2")) == before
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bert.dense_epilogue(torch.empty(2, 8, device="meta"), torch.empty(8),
                                  torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bert.add_layer_norm(torch.empty(2, 8, device="meta"), None, torch.empty(8),
                                  torch.empty(8), EPS)


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jax_bert.BertConfig.tiny(max_position_embeddings=128)
    params = jax_retriever.init_retriever_params(jax.random.PRNGKey(3), jcfg)
    return jax.tree.map(np.asarray, params)


def _retriever(jax_params, dtype, flash=True):
    cfg = bert.BertConfig.tiny(dtype=getattr(torch, dtype), max_position_embeddings=128,
                               flash_attention=flash)
    model = Retriever(cfg)
    model.load_state_dict(convert.params_from_jax(jax_params))
    return model.eval()


def _batch(t: int, seed: int, b: int = 4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 128, size=(b, t))
    mask = (np.arange(t)[None] < np.array([t, t // 2, 9, 1])[:, None]).astype(np.int32)
    return torch.from_numpy(ids * mask), torch.from_numpy(mask)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t", [128, 30])
def test_tower_in_inference_mode_equals_the_autograd_route(jax_params, t, dtype):
    """The BERT tower where no graph is recorded (the fused ops' route) and
    where one is (the differentiable chain): bit-equal on the CPU, where the
    fused ops run their plain versions."""
    model = _retriever(jax_params, dtype)
    ids, mask = _batch(t, seed=t)
    with torch.inference_mode():
        seq_i, pooled_i = model.bert_c(ids, mask)
    seq_g, pooled_g = model.bert_c(ids, mask)
    assert pooled_g.requires_grad and not pooled_i.requires_grad
    assert torch.equal(seq_i, seq_g.detach()) and torch.equal(pooled_i, pooled_g.detach())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tower_with_fused_ops_matches_jax(jax_params, dtype):
    """The slice as a whole: both retriever towers under inference mode (F1
    and F2 on every dense layer and LayerNorm) against the JAX package."""
    jcfg = jax_bert.BertConfig.tiny(dtype=getattr(jnp, dtype), max_position_embeddings=128,
                                    flash_attention=True)
    model = _retriever(jax_params, dtype)
    for tower, t in (("query", 30), ("context", 128)):
        ids, mask = _batch(t, seed=t + 1)
        want = getattr(jax_retriever, f"encode_{tower}")(
            jax_params, jcfg, jnp.asarray(ids.numpy().astype(np.int32)),
            jnp.asarray(mask.numpy()))
        with torch.inference_mode():
            got = getattr(model, f"encode_{tower}")(ids, mask)
        np.testing.assert_allclose(_to_np(got), _to_np(want), atol=TOWER_TOL[dtype], rtol=0)


def test_route_spy(jax_params, monkeypatch):
    """Where no graph is recorded (inference mode, no_grad) the model calls
    the fused ops once a dense layer and LayerNorm; the autograd route calls
    neither."""
    calls = {"dense": 0, "ln": 0}
    dense, ln = bert.dense_epilogue, bert.add_layer_norm

    def spy_dense(*args, **kw):
        calls["dense"] += 1
        return dense(*args, **kw)

    def spy_ln(*args, **kw):
        calls["ln"] += 1
        return ln(*args, **kw)

    monkeypatch.setattr(bert, "dense_epilogue", spy_dense)
    monkeypatch.setattr(bert, "add_layer_norm", spy_ln)
    model = _retriever(jax_params, "bfloat16")
    layers = model.cfg.num_layers
    ids, mask = _batch(128, seed=5)
    model.encode_context(ids, mask)
    assert calls == {"dense": 0, "ln": 0}
    # q, k, v, attn_out, mlp_in, mlp_out a layer, the pooler, the projection;
    # attn_ln and mlp_ln a layer, the embedding LayerNorm
    once = {"dense": 6 * layers + 2, "ln": 2 * layers + 1}
    for mode in (torch.inference_mode, torch.no_grad):
        calls["dense"] = calls["ln"] = 0
        with mode():
            model.encode_context(ids, mask)
        assert calls == once
