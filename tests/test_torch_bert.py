"""Port parity: BERT encoder and retriever towers against the JAX package,
with the JAX weights converted by `params_from_jax`. T=128 reaches the fused
attention path (kernel K2's plain version here, Pallas interpret mode in JAX),
T=30 the vanilla one."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from proqa_tpu.models import bert as jax_bert  # noqa: E402
from proqa_tpu.models import retriever as jax_retriever  # noqa: E402
from proqa_tpu_torch.models import convert  # noqa: E402
from proqa_tpu_torch.models.bert import BertConfig  # noqa: E402
from proqa_tpu_torch.models.retriever import Retriever  # noqa: E402

# f32: same arithmetic, other summation orders (measured 7e-7). bf16: both
# sides round at the same points, but a summation-order difference can flip a
# bf16 rounding, one ulp: 0.03125 for LayerNorm outputs in [4, 8) (measured)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _configs(dtype, flash=True):
    kw = dict(max_position_embeddings=128, flash_attention=flash)
    return (jax_bert.BertConfig.tiny(dtype=getattr(jnp, dtype), **kw),
            BertConfig.tiny(dtype=getattr(torch, dtype), **kw))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs("float32")
    params = jax_retriever.init_retriever_params(jax.random.PRNGKey(0), jcfg)
    return jax.tree.map(np.asarray, params)


def _model(jax_params, tcfg):
    model = Retriever(tcfg)
    model.load_state_dict(convert.params_from_jax(jax_params))
    return model.eval()


def _batch(t, seed=0, b=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 128, size=(b, t)).astype(np.int32)
    lengths = [t, t // 2, 7, 0]              # the last row is all padding
    mask = (np.arange(t)[None, :] < np.array(lengths)[:, None]).astype(np.int32)
    return ids * mask, mask


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [128, 30])
def test_bert_encoder_matches_jax(jax_params, t, dtype):
    jcfg, tcfg = _configs(dtype)
    ids, mask = _batch(t)
    jseq, jpooled = jax_bert.bert_encoder(jax_params["bert_c"], jcfg, jnp.asarray(ids),
                                          jnp.asarray(mask))
    with torch.no_grad():
        tseq, tpooled = _model(jax_params, tcfg).bert_c(torch.from_numpy(ids).long(),
                                                        torch.from_numpy(mask))
    assert tseq.dtype == getattr(torch, dtype) and tpooled.dtype == tseq.dtype
    np.testing.assert_allclose(_np(tseq), _np(jseq), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(_np(tpooled), _np(jpooled), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_retriever_towers_match_jax(jax_params, dtype):
    jcfg, tcfg = _configs(dtype)
    model = _model(jax_params, tcfg)
    for tower, t in (("query", 30), ("context", 128)):
        ids, mask = _batch(t, seed=t)
        want = getattr(jax_retriever, f"encode_{tower}")(
            jax_params, jcfg, jnp.asarray(ids), jnp.asarray(mask))
        with torch.no_grad():
            got = getattr(model, f"encode_{tower}")(torch.from_numpy(ids).long(),
                                                     torch.from_numpy(mask))
        assert got.dtype == torch.float32 and got.shape == (4, 128)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL[dtype], rtol=0)


def test_fused_and_vanilla_attention_agree(jax_params):
    """At T=128 the flash switch changes the path, not the numbers."""
    ids, mask = _batch(128, seed=3)
    outs = []
    for flash in (True, False):
        _, tcfg = _configs("float32", flash=flash)
        with torch.no_grad():
            outs.append(_model(jax_params, tcfg).encode_context(
                torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=0)


def test_params_round_trip_and_npz(jax_params, tmp_path):
    _, tcfg = _configs("float32")
    state = convert.params_from_jax(jax_params)
    assert set(state) == set(Retriever(tcfg).state_dict())
    back = convert.params_to_jax(state)
    for (path, a), (path_b, b) in zip(sorted(jax.tree_util.tree_leaves_with_path(jax_params),
                                             key=lambda x: str(x[0])),
                                      sorted(jax.tree_util.tree_leaves_with_path(back),
                                             key=lambda x: str(x[0]))):
        assert str(path) == str(path_b)
        np.testing.assert_array_equal(a, b)
    # a TrainState-shaped .npz unwraps to its params; a .pt loads as saved
    path = str(tmp_path / "state.npz")
    convert.save_npz(path, {"step": np.int32(3), "params": jax_params,
                            "opt_state": {"mu": jax_params["proj_q"]}})
    loaded = convert.load_params(path)
    assert all(torch.equal(loaded[k], state[k]) for k in state)
    torch.save(state, tmp_path / "state.pt")
    soup = convert.load_params(f"{tmp_path / 'state.pt'};{path}")
    assert all(torch.equal(soup[k], state[k]) for k in state)


def test_reset_parameters_is_seeded():
    _, tcfg = _configs("float32")
    a, b = Retriever(tcfg).reset_parameters(1), Retriever(tcfg).reset_parameters(1)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    std = a.bert_q.layers[0].q.kernel.std().item()
    assert abs(std - tcfg.initializer_range) < 0.005
