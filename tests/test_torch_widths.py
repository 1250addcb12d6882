"""The BERT layer's fused epilogues at the widths past their first forms:
F1 past 12,288 columns, F2 past 1,024 (BERT-xlarge's hidden 2,048,
ALBERT-xxlarge's 4,096 and feed-forward 16,384), against the JAX package.

On the CPU the wrappers run their plain versions, so these tests hold the
port's arithmetic at those widths to `proqa_tpu/models/bert.py` (`_dense`,
`_layer_norm` and their `jax.vjp`), the form each width takes on the card
(`fused_bert.dense_form`, `layer_norm_form`) and the index the wrappers
pass for it, a 1-layer tower at BERT-xlarge's widths, and one train step's
gradients at hidden 1,152, where F2's backward takes its row form. The
kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py). Inputs are made with numpy from
a seed and fed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from proqa_tpu.models import bert as jax_bert  # noqa: E402
from proqa_tpu.models.retriever import init_retriever_params, retriever_forward  # noqa: E402
from proqa_tpu.train import retriever_trainer as jax_trainer  # noqa: E402
from proqa_tpu_torch import _build  # noqa: E402
from proqa_tpu_torch.models import bert, convert  # noqa: E402
from proqa_tpu_torch.models.retriever import Retriever  # noqa: E402
from proqa_tpu_torch.ops import fused_bert  # noqa: E402
from proqa_tpu_torch.train.retriever_trainer import in_batch_loss  # noqa: E402

EPS = 1e-12
# F2 in f32 against XLA: the same arithmetic, the row sums in another order;
# over 4,096 terms the mean and variance move by a few f32 ulps of the row's
# sums, the normalised outputs (magnitude up to ~4) by at most a few 1e-7
LN_F32_ATOL = 2e-6
# F2 in bf16: one ulp at the larger magnitude of the two outputs, or of 2^-8
# below it: an output that cancels to near zero in y * scale + bias moves by
# the f32 difference of its O(1) terms (chip_smoke.py's LN_ULP_FLOOR; at
# width 3,001 one output of 7e-7 reads 4 ulps of its own)
LN_ULP_FLOOR = 2.0 ** -8
# f32 gradients against jax.vjp: the same formulas, sums in another order
F32_JAX_ATOL = 1e-5
# bf16 dx: two bf16 ulps at the larger magnitude of the two, or of ULP_FLOOR
# below it (a gradient that cancels to near zero carries the f32 difference
# of its terms' sums; tests/test_torch_fused_bert_grad.py)
BF16_ULPS, ULP_FLOOR = 2.0, 2.0 ** -8
# column sums: within this share of the sum of the column's |terms|
COLSUM_REL = 1e-5
# the tower against JAX: tests/test_torch_bert.py's tolerances and reasons
TOWER_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# a train step's f32 gradients against JAX, as a share of each tensor's
# largest: other sums' orders through one layer, a pooler and the loss
GRAD_REL = 1e-4

WIDE_COLS = [1152, 2048, 4096, 12289, 16384]  # F1: up to and past 12,288 (an odd one)
WIDE_H = [1152, 2048, 3001, 4096]             # F2: past 1,024 (an odd one)


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32), dtype=np.float64)


def _bf16_ulps(got, want, floor: float = 2.0 ** -126) -> float:
    """The largest |got - want| in bf16 ulps at the larger magnitude of the
    two, or of `floor` below it."""
    got, want = _np(got), _np(want)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), floor)
    return float(np.max(np.abs(got - want) / np.exp2(np.floor(np.log2(mag)) - 7)))


def _close(got, want, dtype: str, atol: float) -> None:
    if dtype == "bfloat16":
        assert _bf16_ulps(got, want, ULP_FLOOR) <= BF16_ULPS
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _colsum_close(got, want, terms: np.ndarray) -> None:
    limit = COLSUM_REL * np.abs(terms).sum(0) + 1e-30
    assert np.all(np.abs(_np(got) - _np(want)) <= limit)


# --- F1 ---

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("cols", WIDE_COLS)
def test_dense_epilogue_reference_equals_jax_wide(cols, dtype):
    """F1's plain version is _dense's epilogue (bert.py:147-150) bit for bit
    at every width: one f32 add, one rounding."""
    rng = np.random.default_rng(cols)
    y = rng.standard_normal((5, cols)).astype(np.float32) * 2.0
    b = rng.standard_normal(cols).astype(np.float32) * 0.1
    want = (jnp.asarray(y) + jnp.asarray(b)).astype(getattr(jnp, dtype))
    got = fused_bert.dense_epilogue(torch.from_numpy(y), torch.from_numpy(b),
                                    getattr(torch, dtype))
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("cols", [8192, 16384])
def test_dense_epilogue_gelu_reference_matches_jax_wide(cols):
    """With the GELU of bert.py:273-274 (BERT-xlarge's 8,192, ALBERT-xxlarge's
    16,384): within one bf16 ulp, plus |x| 2^-24 where ATen's expression
    cancels below x = -3 (tests/test_torch_fused_bert.py)."""
    rng = np.random.default_rng(cols + 1)
    y = rng.standard_normal((3, cols)).astype(np.float32) * 2.0
    b = rng.standard_normal(cols).astype(np.float32) * 0.1
    t = (jnp.asarray(y) + jnp.asarray(b)).astype(jnp.bfloat16)
    want = _np(jax.nn.gelu(t.astype(jnp.float32), approximate=False).astype(jnp.bfloat16))
    got = _np(fused_bert.dense_epilogue(torch.from_numpy(y), torch.from_numpy(b),
                                        torch.bfloat16, gelu=True))
    x = _np(t)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulp + np.abs(x) * 2.0 ** -24)
    assert _bf16_ulps(got[x > -3], want[x > -3]) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cols,gelu", [(2048, False), (8192, True), (12289, False),
                                       (16384, True)])
def test_dense_backward_matches_jax_wide(cols, gelu, dtype):
    """dense's plain backward (F1's backward, then the products) against
    jax.vjp of _dense with its GELU: dx in the activation dtype, dkernel and
    dbias as f32 sums; dx sums `cols` terms."""
    rng = np.random.default_rng(cols + gelu)
    rows, k = 6, 32
    # one nonzero a row: the product is exact in any order, so both packages
    # round the same pre-activation z and the comparison is the epilogue's
    x = np.zeros((rows, k), np.float32)
    x[np.arange(rows), rng.permutation(k)[:rows]] = rng.uniform(0.5, 2.0, rows)
    kernel = (rng.standard_normal((k, cols)) / np.sqrt(k)).astype(np.float32) * 2.0
    bias = (0.1 * rng.standard_normal(cols)).astype(np.float32)
    dout = rng.standard_normal((rows, cols)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_fn(jx, jk, jb):
        y = jax_bert._dense(jx, {"kernel": jk, "bias": jb})
        return jax.nn.gelu(y.astype(jnp.float32), approximate=False).astype(jx.dtype) if gelu \
            else y

    _, vjp = jax.vjp(jax_fn, jnp.asarray(x).astype(jd), jnp.asarray(kernel), jnp.asarray(bias))
    jdx, jdk, jdb = vjp(jnp.asarray(dout).astype(jd))
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    tk = torch.from_numpy(kernel).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    fused_bert.dense(tx, tk.to(td), tb, td, gelu).backward(torch.from_numpy(dout).to(td))
    # dz, the gradient at the GELU's input: the port's is ATen's exact-GELU
    # backward, the JAX package's XLA's; their erf implementations differ in
    # the last f32 bits, which may put a rounded bf16 dz one ulp apart. Each
    # sum below carries exactly that difference (`delta`) on top of its own
    # rounding, and nothing else.
    dz = torch.from_numpy(dout).to(td)
    delta = np.zeros((rows, cols))
    if gelu:
        jz = jax_bert._dense(jnp.asarray(x).astype(jd), {"kernel": jnp.asarray(kernel),
                                                         "bias": jnp.asarray(bias)})
        _, gelu_vjp = jax.vjp(
            lambda t: jax.nn.gelu(t.astype(jnp.float32), approximate=False).astype(t.dtype), jz)
        jdz = gelu_vjp(jnp.asarray(dout).astype(jd))[0]
        dz = fused_bert.dense_epilogue_backward_reference(
            dz, torch.from_numpy(np.array(jz.astype(jnp.float32))).to(td), True)[0]
        delta = np.abs(_np(dz) - _np(jdz))
        # one rounding apart (2^-7 of the value in bf16, a few f32 ulps in
        # f32), or where the derivative cancels (x < -3) a few f32 ulps of 1
        # times dout
        mag = np.maximum(np.abs(_np(dz)), np.abs(_np(jdz)))
        rel = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -20
        assert np.all(delta <= mag * rel + np.abs(_np(torch.from_numpy(dout).to(td))) * 2.0 ** -20)
    dz = np.abs(_np(dz))
    for got, want, terms, moved in (
            (tx.grad, jdx, dz @ np.abs(kernel).T, delta @ np.abs(kernel).T),
            (tk.grad, jdk, np.abs(x).T.astype(np.float64) @ dz, np.abs(x).T @ delta)):
        err = np.abs(_np(got) - _np(want))
        if dtype == "float32":  # f32 sums of `cols` (dx) and `rows` (dkernel) terms
            assert np.all(err <= COLSUM_REL * terms + moved)
        else:  # two bf16 ulps of the result
            mag = np.maximum(np.maximum(np.abs(_np(got)), np.abs(_np(want))), ULP_FLOOR)
            assert np.all(err <= BF16_ULPS * np.exp2(np.floor(np.log2(mag)) - 7) + moved)
    limit = COLSUM_REL * dz.sum(0) + delta.sum(0) + 1e-30
    assert np.all(np.abs(_np(tb.grad) - _np(jdb)) <= limit)


# --- F2 ---

def _ln_inputs(rows: int, h: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, h)).astype(np.float32)
    r = rng.standard_normal((rows, h)).astype(np.float32) * 0.5 + 0.25
    scale = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(h)).astype(np.float32)
    dy = rng.standard_normal((rows, h)).astype(np.float32)
    return x, r, scale, bias, dy


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("h", WIDE_H)
def test_add_layer_norm_reference_matches_jax_wide(h, residual, dtype):
    """F2's plain version against _layer_norm(x + r) (bert.py:137-144):
    within one bf16 ulp in bf16, LN_F32_ATOL in f32."""
    x, r, scale, bias, _ = _ln_inputs(7, h, seed=h + residual)
    jx, jr = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, r))
    want = jax_bert._layer_norm(jx + jr if residual else jx,
                                {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, EPS)
    tx, tr = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, r))
    got = fused_bert.add_layer_norm(tx, tr if residual else None, torch.from_numpy(scale),
                                    torch.from_numpy(bias), EPS)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        assert _bf16_ulps(got, want, LN_ULP_FLOOR) <= 1.0
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=LN_F32_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("h", [1152, 2048, 4096])
def test_layer_norm_backward_matches_jax_wide(h, residual, dtype):
    """add_layer_norm_grad's plain backward against jax.vjp of
    _layer_norm(x + r): dx and dr in the activation dtype, dscale and dbias
    as f32 column sums."""
    x, r, scale, bias, dy = _ln_inputs(9, h, seed=h + 7 * residual)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_fn(jx, jr, jsc, jb):
        return jax_bert._layer_norm(jx + jr if residual else jx, {"scale": jsc, "bias": jb}, EPS)

    _, vjp = jax.vjp(jax_fn, jnp.asarray(x).astype(jd), jnp.asarray(r).astype(jd),
                     jnp.asarray(scale), jnp.asarray(bias))
    jdx, jdr, jdsc, jdb = vjp(jnp.asarray(dy).astype(jd))
    leaf = lambda a, d: torch.from_numpy(a).to(d).requires_grad_(True)  # noqa: E731
    tx, tr = leaf(x, td), leaf(r, td)
    tsc, tb = leaf(scale, torch.float32), leaf(bias, torch.float32)
    fused_bert.add_layer_norm_grad(tx, tr if residual else None, tsc, tb, EPS).backward(
        torch.from_numpy(dy).to(td))
    _close(tx.grad, jdx, dtype, F32_JAX_ATOL)
    if residual:
        assert torch.equal(tr.grad, tx.grad)
        _close(tr.grad, jdr, dtype, F32_JAX_ATOL)
    s = torch.from_numpy(x).to(td) + (torch.from_numpy(r).to(td) if residual else 0)
    s = s.double()
    xh = ((s - s.mean(-1, keepdim=True)) / s.var(-1, unbiased=False, keepdim=True).sqrt())
    d = torch.from_numpy(dy).to(td).double()
    _colsum_close(tsc.grad, jdsc, (d * xh).numpy())
    _colsum_close(tb.grad, jdb, d.numpy())


# --- the forms the card takes ---

_SWEEP = sorted(set(range(1, 70)) | {w + d for w in (fused_bert.LN_WARP_WIDTH,
                                                     fused_bert.LN_BWD_ROW_WIDTH,
                                                     fused_bert.LN_ROW_WIDTH,
                                                     fused_bert.DENSE_STAGED_COLS,
                                                     fused_bert.DENSE_SLAB_COLS)
                                     for d in (-8, -1, 0, 1, 8)}
                | {768, 2048, 3001, 4096, 16384, 32768, 65536, 65537, 10 ** 6})


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layer_norm_form_covers_every_width(dtype, backward):
    """Every width from 1 up has a form: a warp a row (the backward's tiles)
    up to 1,024, a block a row in registers up to 8,192 (backward 4,096),
    streamed past that; the vector body exactly where the width is whole
    16-byte vectors and the pointers are aligned."""
    dt = getattr(torch, dtype)
    vec = 16 // dt.itemsize
    limit = fused_bert.LN_BWD_ROW_WIDTH if backward else fused_bert.LN_ROW_WIDTH
    names = fused_bert.LN_BWD_FORMS if backward else fused_bert.LN_FORMS
    for h in _SWEEP:
        for aligned in (True, False):
            form = fused_bert.layer_norm_form(h, dt, aligned, backward)
            assert form in names
            layout = form.removesuffix("_scalar")
            want = ("tile" if backward else "warp") if h <= 1024 else \
                "row" if h <= limit else "stream"
            assert layout == want, (h, aligned, form)
            assert form.endswith("_scalar") == (not aligned or h % vec != 0), (h, aligned, form)
    with pytest.raises(ValueError):
        fused_bert.layer_norm_form(0, dt, True, backward)


@pytest.mark.parametrize("backward", [False, True])
def test_dense_form_covers_every_width(backward):
    """Every column count from 1 up has a form: the bias staged in shared
    memory up to 12,288 and read through the read-only cache past it; the
    backward's ticketed slabs up to 131,072 and one slab past it."""
    names = fused_bert.DENSE_BWD_FORMS if backward else fused_bert.DENSE_FORMS
    for cols in _SWEEP:
        for aligned in (True, False):
            form = fused_bert.dense_form(cols, aligned, backward)
            assert form in names
            vector = aligned and cols % 8 == 0
            if backward:
                want = "direct" if cols > 131_072 else "slabs" if vector else "slabs_scalar"
            else:
                want = ("staged" if cols <= 12_288 else "wide") + ("" if vector else "_scalar")
            assert form == want, (cols, aligned, form)
    with pytest.raises(ValueError):
        fused_bert.dense_form(0, True, backward)


@pytest.fixture
def recorded_launches(monkeypatch):
    """The kernel library's launches and size queries recorded instead of
    run (the C side decides the real scratch size)."""
    calls = []
    fused_bert._scratch_bytes.cache_clear()
    monkeypatch.setattr(_build, "query", lambda entry, *args: 4160)
    monkeypatch.setattr(_build, "launch",
                        lambda entry, device, *args: calls.append((entry, args)))
    monkeypatch.setattr(fused_bert, "_workspace",
                        lambda device, nbytes: torch.zeros(nbytes, dtype=torch.uint8))
    monkeypatch.setattr(fused_bert, "form_launches", {})
    yield calls
    fused_bert._scratch_bytes.cache_clear()


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """t's values in a tensor that starts 2 elements past a 16-byte boundary."""
    out = torch.empty(t.numel() + 2, dtype=t.dtype)[2:].view_as(t)
    return out.copy_(t)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("h", [768, 2048, 3001, 8192, 8200])
def test_layer_norm_wrappers_pass_their_form(recorded_launches, h, aligned):
    """F2's wrappers pass the index of layer_norm_form's answer for the
    shape and the pointers they launch on, forward and backward, and count
    the launch under its form."""
    x = torch.zeros(3, h, dtype=torch.bfloat16)
    x = x if aligned else _unaligned(x)
    scale, bias = torch.ones(h), torch.zeros(h)
    _, mean, rstd = fused_bert._add_layer_norm_kernel(x, x, scale, bias, EPS, save_stats=True)
    fused_bert._add_layer_norm_backward_kernel(x, x, x, mean, rstd, scale, True, True)
    (fwd_entry, fwd), (bwd_entry, bwd) = recorded_launches
    assert (fwd_entry, bwd_entry) == ("proqa_add_layer_norm", "proqa_add_layer_norm_bwd")
    vector = aligned and h % 8 == 0
    want = (fused_bert.layer_norm_form(h, torch.bfloat16, vector),
            fused_bert.layer_norm_form(h, torch.bfloat16, vector, backward=True))
    assert (fused_bert.LN_FORMS[fwd[-1]], fused_bert.LN_BWD_FORMS[bwd[-1]]) == want
    layouts = [w.removesuffix("_scalar") for w in want]
    assert fused_bert.form_launches == {f"F2 {layouts[0]}": 1, f"F2 backward {layouts[1]}": 1}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("cols", [3072, 12289, 16384, 131_080])
def test_dense_wrappers_pass_their_form(recorded_launches, cols, aligned):
    """F1's wrappers pass the index of dense_form's answer, forward (saving
    z) and backward, and count the launch under its form."""
    y = torch.zeros(2, cols)
    y = y if aligned else _unaligned(y)
    bias = torch.zeros(cols)
    out, z = fused_bert._dense_epilogue_kernel(y, bias, torch.bfloat16, True, save_z=True)
    fused_bert._dense_epilogue_backward_kernel(out, z, True, True, True)
    (_, fwd), (_, bwd) = recorded_launches
    want = (fused_bert.dense_form(cols, aligned and cols % 8 == 0),
            fused_bert.dense_form(cols, True, backward=True))  # out, z, dz are fresh
    assert (fused_bert.DENSE_FORMS[fwd[-1]], fused_bert.DENSE_BWD_FORMS[bwd[-1]]) == want
    layouts = [w.removesuffix("_scalar") for w in want]
    assert fused_bert.form_launches == {f"F1 {layouts[0]}": 1, f"F1 backward {layouts[1]}": 1}


# --- the model at these widths ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlarge_width_layer_matches_jax(dtype):
    """One layer at BERT-xlarge's widths (hidden 2,048, 32 heads of 64, FFN
    8,192; vocab 128, the vanilla attention path): the JAX weights carried
    across by params_from_jax, the encoder's sequence output and pooled
    output within tests/test_torch_bert.py's tolerances."""
    kw = dict(vocab_size=128, hidden_size=2048, num_layers=1, num_heads=32,
              intermediate_size=8192, max_position_embeddings=64, flash_attention=False)
    jcfg = jax_bert.BertConfig(dtype=getattr(jnp, dtype), **kw)
    params = jax.tree.map(np.asarray, jax_bert.init_bert_params(jax.random.PRNGKey(3), jcfg))
    model = bert.BertEncoder(bert.BertConfig(dtype=getattr(torch, dtype), **kw)).eval()
    model.load_state_dict(convert.params_from_jax(params))
    rng = np.random.default_rng(5)
    ids = rng.integers(5, 128, size=(3, 30)).astype(np.int32)
    mask = (np.arange(30)[None] < np.array([[30], [17], [4]])).astype(np.int32)
    ids = ids * mask
    jseq, jpooled = jax_bert.bert_encoder(params, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        tseq, tpooled = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert tseq.shape == (3, 30, 2048) and tseq.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(tseq), _np(jseq), atol=TOWER_TOL[dtype], rtol=0)
    np.testing.assert_allclose(_np(tpooled), _np(jpooled), atol=TOWER_TOL[dtype], rtol=0)


def test_train_step_gradients_at_hidden_1152_match_jax():
    """One retriever step's gradients (f32, dropout 0, the vanilla attention
    path) at hidden 1,152 (18 heads of 64, FFN 4,608, 1 layer), where every
    LayerNorm's backward is F2's row form on the card: each within GRAD_REL
    of the tensor's largest of the JAX package's jax.grad. The key bias and
    proj_c.bias, zero in exact arithmetic, carry rounding noise alone in both
    packages and are held to an absolute bound of that size."""
    kw = dict(vocab_size=128, hidden_size=1152, num_layers=1, num_heads=18,
              intermediate_size=4608, max_position_embeddings=64, flash_attention=False,
              hidden_dropout=0.0, attention_dropout=0.0)
    jcfg = jax_bert.BertConfig(dtype=jnp.float32, **kw)
    jparams = jax.tree.map(np.asarray, init_retriever_params(jax.random.PRNGKey(6), jcfg))
    rng = np.random.default_rng(7)
    q = rng.integers(5, 128, size=(4, 12)).astype(np.int32)
    c = rng.integers(5, 128, size=(4, 40)).astype(np.int32)
    mask_c = (np.arange(40)[None] < np.array([[40], [33], [21], [8]])).astype(np.int32)
    batch = {"input_ids_q": q, "input_mask_q": np.ones_like(q),
             "input_ids_c": c * mask_c, "input_mask_c": mask_c}
    jgrads = jax.grad(lambda p: jax_trainer.in_batch_loss(
        retriever_forward(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}))[0])(jparams)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads))

    model = Retriever(bert.BertConfig(dtype=torch.float32, remat=True, **kw)).train()
    model.load_state_dict(convert.params_from_jax(jparams))
    tbatch = {k: torch.from_numpy(v).long() if k.startswith("input_ids") else torch.from_numpy(v)
              for k, v in batch.items()}
    in_batch_loss(model(tbatch, generator=torch.Generator().manual_seed(0)))[0].backward()
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    noise = [n for n in got if n.endswith(".k.bias") or n == "proj_c.bias"]
    for name, g in got.items():
        scale = want[name].abs().max().item()
        if name in noise:  # rounding noise of sums of terms as large as the kernel's
            scale = want[name.removesuffix("bias") + "kernel"].abs().max().item()
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=GRAD_REL * scale + 1e-12, err_msg=name)
