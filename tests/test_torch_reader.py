"""Port parity: the QA reader (QAModel, decode_spans) against the JAX
package's qa_forward and decode_spans, with the JAX weights converted by
`params_from_jax`. T = 64 runs the vanilla attention path; T = 128 with fused
attention reaches K2 (Pallas interpret mode in JAX, the kernel's plain
version here)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from proqa_tpu.models import bert as jax_bert  # noqa: E402
from proqa_tpu.models import reader as jax_reader  # noqa: E402
from proqa_tpu_torch.models import convert  # noqa: E402
from proqa_tpu_torch.models.bert import BertConfig  # noqa: E402
from proqa_tpu_torch.models.reader import NEG, QAConfig, QAModel, decode_spans  # noqa: E402

# f32: the same arithmetic in other summation orders (tests/test_torch_bert.py
# measures 7e-7 on the encoder). bf16: both packages round at the same points
# but sum in other orders, so the port differs from JAX by bf16 noise. Over six
# batch seeds in both candidate modes that noise measured 0.15-0.79% of each
# output's largest magnitude (the span logits inside the paragraph; this file's
# __main__ prints the readings). BF16_REL sits between that and a
# lower-precision control, one more rounding of the port's outputs to float8
# e4m3 (1.38-5.33% over the same runs), and the test checks that the control
# fails it.
F32_ATOL, BF16_REL = 1e-4, 1.1e-2
SPAN_KEYS = ("start_logits", "end_logits")
B, K, TQ, M = 3, 2, 12, 6


def _configs(dtype, t, flash):
    kw = dict(max_position_embeddings=t, flash_attention=flash)
    return (jax_bert.BertConfig.tiny(dtype=getattr(jnp, dtype), **kw),
            BertConfig.tiny(dtype=getattr(torch, dtype), **kw))


def _jax_params(add_select: bool, t: int = 128):
    jcfg, _ = _configs("float32", t, False)
    params = jax_reader.init_qa_params(jax.random.PRNGKey(1), jcfg,
                                       jax_reader.QAConfig(add_select=add_select))
    return jax.tree.map(np.asarray, params)


def _model(params, tcfg, add_select):
    model = QAModel(tcfg, QAConfig(add_select=add_select))
    model.load_state_dict(convert.params_from_jax(params), strict=True)
    return model.eval()


def _batch(t, seed=0):
    """A [B, K, T] reader batch in the sampler's layout: [CLS] q [SEP] p
    [SEP], a varied paragraph length per row (one row all padding, as
    batch_pad never makes but K2 must take), and M rank candidates."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 128, size=(B, K, t)).astype(np.int32)
    qlen = 7
    lengths = rng.integers(qlen + 3, t + 1, size=(B, K))
    lengths[-1, -1] = 0
    pos = np.arange(t)
    mask = (pos < lengths[..., None]).astype(np.int32)
    ids = ids * mask
    segment = ((pos >= qlen) & (mask == 1)).astype(np.int32)
    para = ((pos >= qlen) & (pos < lengths[..., None] - 1)).astype(np.int32)
    ids_q = rng.integers(5, 128, size=(B, TQ)).astype(np.int32)
    mask_q = (np.arange(TQ) < np.array([TQ, 5, 9])[:, None]).astype(np.int32)
    ids_q *= mask_q
    return {"input_ids": ids, "input_mask": mask, "segment_ids": segment,
            "paragraph_mask": para, "input_ids_q": ids_q, "input_mask_q": mask_q}


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("add_select", [False, True])
def test_qa_model_loads_jax_tree_strict(add_select):
    params = _jax_params(add_select)
    _, tcfg = _configs("float32", 128, False)
    model = _model(params, tcfg, add_select)
    state = convert.params_from_jax(params)
    assert set(model.state_dict()) == set(state)
    assert hasattr(model, "select_outputs") == add_select
    np.testing.assert_array_equal(model.qa_outputs.kernel.detach().numpy(),
                                  params["qa_outputs"]["kernel"])
    # reset_parameters draws the JAX package's shapes: same keys, std 0.02
    fresh = QAModel(tcfg, QAConfig(add_select=add_select)).reset_parameters(0)
    assert set(fresh.state_dict()) == set(state)
    assert fresh.bert.embeddings.word.detach().std().item() == pytest.approx(0.02, rel=0.1)
    assert float(fresh.qa_outputs.bias.detach().abs().max()) == 0.0


def _forward_pair(dtype, t, flash, mode, add_select, seed):
    """The port's and JAX's reader outputs on one batch drawn from `seed`,
    with the rank-head candidates given as para_embed or as para_rows."""
    params = _jax_params(add_select, t=128)
    jcfg, tcfg = _configs(dtype, t, flash)
    # the JAX tree was drawn at 128 positions; cut the table to T
    params["bert"]["embeddings"]["position"] = params["bert"]["embeddings"]["position"][:t]
    params["retriever"]["bert_q"]["embeddings"]["position"] = \
        params["retriever"]["bert_q"]["embeddings"]["position"][:t]
    params["retriever"]["bert_c"]["embeddings"]["position"] = \
        params["retriever"]["bert_c"]["embeddings"]["position"][:t]
    batch = _batch(t, seed=seed)
    rng = np.random.default_rng(5)
    corpus = rng.standard_normal((40, 128)).astype(np.float32) / 128 ** 0.5
    if mode == "para_embed":
        batch["para_embed"] = corpus[rng.integers(0, 40, size=(B, M))]
    else:
        rows = rng.integers(0, 40, size=(B, M)).astype(np.int32)
        rows[0, -2:] = -1  # an under-filled search's slots gather row 0
        batch["para_rows"] = rows
    qcfg = jax_reader.QAConfig(add_select=add_select)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if mode == "para_rows":
        jbatch["corpus_emb"] = jnp.asarray(corpus)
    want = jax_reader.qa_forward(params, jcfg, qcfg, jbatch, deterministic=True)

    tbatch = _to_torch(batch)
    if mode == "para_rows":
        tbatch["corpus_emb"] = torch.from_numpy(corpus)
    with torch.inference_mode():
        got = _model(params, tcfg, add_select)(tbatch)
    return got, want, batch, corpus


def _compared(key, got, want, batch):
    """One output of both packages as f32 numpy; the span logits only inside
    the paragraph (NEG outside it)."""
    g, w = _np(got[key]), _np(want[key])
    if key in SPAN_KEYS:
        in_para = batch["paragraph_mask"] == 1
        g, w = g[in_para], w[in_para]
    return g, w


def _e4m3(x):
    return torch.from_numpy(x).to(torch.float8_e4m3fn).float().numpy()


@pytest.mark.parametrize("mode,add_select", [("para_embed", False), ("para_rows", True)])
@pytest.mark.parametrize("dtype,t,flash", [("float32", 64, False), ("float32", 128, True),
                                           ("bfloat16", 128, True)])
def test_forward_matches_qa_forward(dtype, t, flash, mode, add_select):
    got, want, batch, corpus = _forward_pair(dtype, t, flash, mode, add_select, seed=t)
    keys = {"start_logits", "end_logits", "rank_logits", "q_embed"} | (
        {"select_logits"} if add_select else set())
    assert set(got) == keys
    for key in keys:
        assert got[key].dtype == torch.float32, key
        g, w = _compared(key, got, want, batch)  # NEG outside: checked exactly below
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=F32_ATOL, rtol=0, err_msg=key)
            continue
        atol = BF16_REL * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=key)
        assert np.abs(_e4m3(g) - w).max() > atol, key
    # outside the paragraph both sides hold exactly NEG
    outside = batch["paragraph_mask"] == 0
    assert (got["start_logits"].numpy()[outside] == NEG).all()
    assert (np.asarray(want["start_logits"])[outside] == NEG).all()
    if mode == "para_rows":
        want_rank = np.einsum("bd,bmd->bm", _np(got["q_embed"]),
                              corpus[np.maximum(batch["para_rows"], 0)])
        np.testing.assert_allclose(got["rank_logits"].numpy(), want_rank, atol=1e-5, rtol=0)


def _decode_cases():
    rng = np.random.default_rng(9)
    b, k, l = 2, 3, 24
    start = rng.standard_normal((b, k, l)).astype(np.float32)
    end = rng.standard_normal((b, k, l)).astype(np.float32)
    start[0, 0], end[0, 0] = NEG, NEG                  # a row of all NEG
    start[0, 1, 5:] = NEG                              # a partly masked row
    end[0, 1, :3] = NEG
    start[1, 0] = 1.0                                  # exact ties everywhere
    end[1, 0] = 1.0
    start[1, 1, [4, 9]] = 3.0                          # two tied best starts
    end[1, 1, [6, 11]] = 3.0
    q = np.round(rng.standard_normal((b, k, l)) * 2) / 2   # many ties on a grid
    start[1, 2], end[1, 2] = q[1, 2].astype(np.float32), q[0, 2].astype(np.float32)
    return start, end


@pytest.mark.parametrize("max_answer_len", [0, 1, 10])
def test_decode_spans_matches_jax(max_answer_len):
    start, end = _decode_cases()
    js, je, jsc = jax_reader.decode_spans(jnp.asarray(start), jnp.asarray(end), max_answer_len)
    ts, te, tsc = decode_spans(torch.from_numpy(start), torch.from_numpy(end), max_answer_len)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    # every row with a finite logit keeps the band; in the all-NEG row an
    # out-of-band -1e10 beats the in-band NEG + NEG, in both packages
    width = (te - ts)[torch.from_numpy(start).amax(-1) > NEG]
    assert (width >= 0).all() and (width <= max_answer_len).all()


if __name__ == "__main__":
    # the bf16 readings behind BF16_REL: per batch seed and output, the
    # port's distance from JAX and the e4m3 control's, each as a share of
    # the output's largest magnitude (PYTHONPATH=. python tests/test_torch_reader.py)
    for mode, add_select in (("para_embed", False), ("para_rows", True)):
        for seed in range(6):
            got, want, batch, _ = _forward_pair("bfloat16", 128, True, mode, add_select, seed)
            shares = []
            for key in sorted(got):
                g, w = _compared(key, got, want, batch)
                scale = np.abs(w).max()
                shares.append(f"{key} {np.abs(g - w).max() / scale:.4f} "
                              f"(e4m3 {np.abs(_e4m3(g) - w).max() / scale:.4f})")
            print(mode, f"seed {seed}:", "; ".join(shares), flush=True)
