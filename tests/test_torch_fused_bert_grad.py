"""The training route of the BERT layer's fused epilogues (ops/fused_bert.py:
`dense`, the product with F1, and `add_layer_norm_grad`, F2, each an autograd
Function with a backward kernel on the card): their plain backward against
jax.vjp of the JAX package's own functions and against torch autograd of
the plain forward, the frozen-parameter cases, and the model's route.

On the CPU the Functions run their plain versions: the forward chains and
explicit formulas of the gradients. The CUDA kernels are held against those
on the card (tests/test_torch_cuda.py). Inputs are made with numpy from a
seed and fed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from proqa_tpu.models import bert as jax_bert  # noqa: E402
from proqa_tpu_torch import _build  # noqa: E402
from proqa_tpu_torch.models import bert  # noqa: E402
from proqa_tpu_torch.models.retriever import Retriever  # noqa: E402
from proqa_tpu_torch.ops import fused_bert  # noqa: E402
from proqa_tpu_torch.ops.dot import dot_f32  # noqa: E402

EPS = 1e-12
# f32 gradients: the same formulas, sums in another order (XLA's autodiff of
# the mean and variance against one closed formula; ATen's reductions)
F32_JAX_ATOL, F32_TORCH_ATOL = 1e-5, 1e-6
# bf16 dx and dz: two bf16 ulps at the larger magnitude of the two, or of
# ULP_FLOOR below it. A gradient that cancels to near zero (the LayerNorm's
# g - mean(g) - x^ mean(g x^) over O(1) terms; a product's sum of O(1)
# terms) carries the f32 difference of its terms' sums, which is a few f32
# ulps of 1 whatever the result's own size; the bf16 ulp at 2^-8 (2^-16) is
# far above that
BF16_ULPS, ULP_FLOOR = 2.0, 2.0 ** -8
# column sums: within this share of the sum of the column's |terms|
COLSUM_REL = 1e-5


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32), dtype=np.float64)


def _bf16_ulps(got, want, floor: float = ULP_FLOOR) -> float:
    got, want = _np(got), _np(want)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), floor)
    return float(np.max(np.abs(got - want) / np.exp2(np.floor(np.log2(mag)) - 7)))


def _close(got, want, dtype: str, atol: float) -> None:
    if dtype == "bfloat16":
        assert _bf16_ulps(got, want) <= BF16_ULPS
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _colsum_close(got, want, terms: np.ndarray) -> None:
    """Column sums within COLSUM_REL of the sum of their terms' magnitudes
    (terms: [rows, cols])."""
    limit = COLSUM_REL * np.abs(terms).sum(0) + 1e-30
    assert np.all(np.abs(_np(got) - _np(want)) <= limit)


def _ln_inputs(rows: int, h: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, h)).astype(np.float32)
    r = rng.standard_normal((rows, h)).astype(np.float32) * 0.5 + 0.25
    scale = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(h)).astype(np.float32)
    dy = rng.standard_normal((rows, h)).astype(np.float32)
    return x, r, scale, bias, dy


def _torch_ln_grads(x, r, scale, bias, dy, dtype, fn):
    """(out, dx, dr, dscale, dbias) of fn(x, r, scale, bias) under autograd."""
    t = lambda a, d: torch.from_numpy(a).to(d).requires_grad_(True)  # noqa: E731
    tx, tsc, tb = t(x, dtype), t(scale, torch.float32), t(bias, torch.float32)
    tr = None if r is None else t(r, dtype)
    out = fn(tx, tr, tsc, tb)
    out.backward(torch.from_numpy(dy).to(dtype))
    return out, tx.grad, None if tr is None else tr.grad, tsc.grad, tb.grad


def _ln_terms(x, r, dy, dtype):
    """The column sums' terms: dy x^ (for dscale) and dy (for dbias), in f32
    from the rounded inputs."""
    s = torch.from_numpy(x).to(dtype)
    if r is not None:
        s = s + torch.from_numpy(r).to(dtype)
    s = s.double()
    xh = (s - s.mean(-1, keepdim=True)) / s.var(-1, unbiased=False, keepdim=True).sqrt()
    d = torch.from_numpy(dy).to(dtype).double()
    return (d * xh).numpy(), d.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("h", [32, 768])
def test_layer_norm_backward_matches_jax(h, residual, dtype):
    """add_layer_norm_grad's plain backward against jax.vjp of
    _layer_norm(x + r) (proqa_tpu/models/bert.py:137-144, :277, :286; without
    the residual, :241): dx and dr in the activation dtype, dscale and dbias
    as f32 column sums."""
    x, r, scale, bias, dy = _ln_inputs(41, h, seed=h + 7 * residual)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_fn(jx, jr, jsc, jb):
        s = jx + jr if residual else jx
        return jax_bert._layer_norm(s, {"scale": jsc, "bias": jb}, EPS)

    primals = (jnp.asarray(x).astype(jd), jnp.asarray(r).astype(jd), jnp.asarray(scale),
               jnp.asarray(bias))
    _, vjp = jax.vjp(jax_fn, *primals)
    jdx, jdr, jdsc, jdb = vjp(jnp.asarray(dy).astype(jd))
    _, dx, dr, dsc, db = _torch_ln_grads(
        x, r if residual else None, scale, bias, dy, td,
        lambda a, b, c, d: fused_bert.add_layer_norm_grad(a, b, c, d, EPS))
    assert dx.dtype == td and dsc.dtype == db.dtype == torch.float32
    _close(dx, jdx, dtype, F32_JAX_ATOL)
    if residual:
        assert torch.equal(dr, dx)
        _close(dr, jdr, dtype, F32_JAX_ATOL)
    terms_sc, terms_b = _ln_terms(x, r if residual else None, dy, td)
    _colsum_close(dsc, jdsc, terms_sc)
    _colsum_close(db, jdb, terms_b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("h", [32, 768])
def test_layer_norm_backward_matches_torch_autograd(h, residual, dtype):
    """The same against torch autograd of the plain forward
    (add_layer_norm_reference), whose output it equals bit for bit."""
    x, r, scale, bias, dy = _ln_inputs(37, h, seed=h + 3 * residual + 1)
    td = getattr(torch, dtype)
    rr = r if residual else None
    out_f, dx_f, dr_f, dsc_f, db_f = _torch_ln_grads(
        x, rr, scale, bias, dy, td,
        lambda a, b, c, d: fused_bert.add_layer_norm_grad(a, b, c, d, EPS))
    out_a, dx_a, dr_a, dsc_a, db_a = _torch_ln_grads(
        x, rr, scale, bias, dy, td,
        lambda a, b, c, d: fused_bert.add_layer_norm_reference(a, b, c, d, EPS))
    assert torch.equal(out_f, out_a)
    _close(dx_f, dx_a, dtype, F32_TORCH_ATOL)
    if residual:
        _close(dr_f, dr_a, dtype, F32_TORCH_ATOL)
    terms_sc, terms_b = _ln_terms(x, rr, dy, td)
    _colsum_close(dsc_f, dsc_a, terms_sc)
    _colsum_close(db_f, db_a, terms_b)


def _dense_inputs(rows: int, k: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    kernel = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32) * 2.0
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, kernel, bias


def _jax_dense(gelu: bool, out_dtype: str | None):
    """_dense (bert.py:147-150), with the GELU of :273-274 after it, or with
    an f32 output (the projections and heads: the product plus the bias,
    kept in f32)."""
    def fn(jx, jk, jb):
        if out_dtype == "float32":
            y = jnp.einsum("...d,df->...f", jx, jk.astype(jx.dtype),
                           preferred_element_type=jnp.float32)
            return y + jb
        y = jax_bert._dense(jx, {"kernel": jk, "bias": jb})
        if gelu:
            y = jax.nn.gelu(y.astype(jnp.float32), approximate=False).astype(jx.dtype)
        return y
    return fn


def _torch_dense_grads(x, kernel, bias, dout, dtype, out_dtype, gelu, fn, frozen=()):
    """(out, dx, dkernel, dbias) of fn(x, kernel in x's dtype, bias) under
    autograd; the names in `frozen` do not require a gradient."""
    tx = torch.from_numpy(x).to(dtype).requires_grad_("x" not in frozen)
    tk = torch.from_numpy(kernel).requires_grad_("kernel" not in frozen)
    tb = torch.from_numpy(bias).requires_grad_("bias" not in frozen)
    out = fn(tx, tk.to(dtype), tb, out_dtype, gelu)
    out.backward(torch.from_numpy(dout).to(out_dtype))
    return out, tx.grad, tk.grad, tb.grad


def _plain_dense(x, kernel, bias, out_dtype, gelu):
    return fused_bert.dense_epilogue_reference(dot_f32(x, kernel), bias, out_dtype, gelu)


DENSE_CASES = [  # (rows, k, n, gelu, out_dtype): q/k/v/attn_out, mlp_in, the span head,
    (37, 64, 32, False, None), (29, 32, 128, True, None), (23, 32, 2, False, "float32"),
    (9, 32, 40, True, None)]                             # a GELU width past the vector


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,k,n,gelu,out", DENSE_CASES)
def test_dense_backward_matches_jax(rows, k, n, gelu, out, dtype):
    """dense's plain backward (F1's backward, then the products) against
    jax.vjp of _dense with and without the GELU, and of the f32-output head:
    dx in the activation dtype, dkernel and dbias in f32."""
    x, kernel, bias = _dense_inputs(rows, k, n, seed=rows + n)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    out_t = torch.float32 if out == "float32" else td
    dout = np.random.default_rng(n).standard_normal((rows, n)).astype(np.float32)
    _, vjp = jax.vjp(_jax_dense(gelu, out), jnp.asarray(x).astype(jd), jnp.asarray(kernel),
                     jnp.asarray(bias))
    jdx, jdk, jdb = vjp(jnp.asarray(dout).astype(jnp.float32 if out else jd))
    _, dx, dk, db = _torch_dense_grads(x, kernel, bias, dout, td, out_t, gelu, fused_bert.dense)
    assert dx.dtype == td and dk.dtype == db.dtype == torch.float32
    _close(dx, jdx, dtype, F32_JAX_ATOL)
    # dz: dout, or with GELU dout times a derivative of at most 1.13
    dz = 1.2 * torch.from_numpy(dout).to(out_t).double().numpy()
    # dkernel: sums over the rows of x dz, rounded to the operand dtype
    if dtype == "bfloat16":
        assert _bf16_ulps(dk, jdk) <= BF16_ULPS
    else:
        terms = np.abs(x).T.astype(np.float64) @ np.abs(dz)
        assert np.all(np.abs(_np(dk) - _np(jdk)) <= COLSUM_REL * terms)
    _colsum_close(db, jdb, dz)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,k,n,gelu,out", DENSE_CASES)
def test_dense_backward_matches_torch_autograd(rows, k, n, gelu, out, dtype):
    """The same against torch autograd of the plain chain
    (dense_epilogue_reference over dot_f32), whose output it equals bit for
    bit; the GELU's dz is aten::gelu_backward's, so dbias and the products
    see the same operands."""
    x, kernel, bias = _dense_inputs(rows, k, n, seed=rows * n)
    td = getattr(torch, dtype)
    out_t = torch.float32 if out == "float32" else td
    dout = np.random.default_rng(k).standard_normal((rows, n)).astype(np.float32)
    got = _torch_dense_grads(x, kernel, bias, dout, td, out_t, gelu, fused_bert.dense)
    want = _torch_dense_grads(x, kernel, bias, dout, td, out_t, gelu, _plain_dense)
    assert torch.equal(got[0], want[0])
    _close(got[1], want[1], dtype, F32_TORCH_ATOL)
    if dtype == "bfloat16":
        assert _bf16_ulps(got[2], want[2]) <= BF16_ULPS
    else:
        np.testing.assert_allclose(_np(got[2]), _np(want[2]), atol=F32_TORCH_ATOL, rtol=0)
    dz = torch.from_numpy(dout).to(out_t).double().numpy()
    _colsum_close(got[3], want[3], 1.2 * dz)


@pytest.mark.parametrize("rows,n,gelu,out", [(33, 64, True, None), (15, 2, False, "float32")])
def test_gelu_and_head_epilogue_backward_equals_autograd(rows, n, gelu, out):
    """F1's plain backward alone: dz bit-equal to autograd's through the plain
    epilogue (the GELU's rounding of its f32 gradient, or the f32 head's
    identity), dbias the column sum of f32(dz)."""
    rng = np.random.default_rng(rows)
    y = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32) * 2.0)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1)
    dt = torch.float32 if out else torch.bfloat16
    dout = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(dt)
    y.requires_grad_(True)
    b.requires_grad_(True)
    fused_bert.dense_epilogue_reference(y, b, dt, gelu).backward(dout)
    z = (y.detach() + b.detach()).to(dt)
    dz, dbias = fused_bert.dense_epilogue_backward_reference(dout, z if gelu else None, gelu)
    assert dz.dtype == dt and torch.equal(dz.float(), y.grad)
    _colsum_close(dbias, b.grad, dz.double().numpy())


@pytest.mark.parametrize("frozen", [("bias",), ("kernel",), ("kernel", "bias"), ("x",)])
@pytest.mark.parametrize("gelu", [False, True])
def test_dense_honours_frozen_inputs(frozen, gelu):
    """A frozen bias or kernel (QA training's requires_grad_(False) groups), or
    an input that wants no gradient: no gradient for it, the others' bit-equal
    to the all-trainable case's."""
    x, kernel, bias = _dense_inputs(19, 32, 64, seed=11)
    dout = np.random.default_rng(12).standard_normal((19, 64)).astype(np.float32)
    args = (x, kernel, bias, dout, torch.bfloat16, torch.bfloat16, gelu, fused_bert.dense)
    full = dict(zip(("x", "kernel", "bias"), _torch_dense_grads(*args)[1:]))
    part = dict(zip(("x", "kernel", "bias"), _torch_dense_grads(*args, frozen=frozen)[1:]))
    for name in full:
        if name in frozen:
            assert part[name] is None
        else:
            assert torch.equal(part[name], full[name])


@pytest.mark.parametrize("frozen", [("scale",), ("bias",), ("scale", "bias"), ("x", "r")])
def test_layer_norm_honours_frozen_inputs(frozen):
    """A frozen scale or bias, or inputs that want no gradient: no gradient
    for them, the others' bit-equal to the all-trainable case's."""
    x, r, scale, bias, dy = _ln_inputs(21, 64, seed=13)

    def grads(frozen=()):
        t = {"x": torch.from_numpy(x).bfloat16(), "r": torch.from_numpy(r).bfloat16(),
             "scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
        for name, v in t.items():
            v.requires_grad_(name not in frozen)
        out = fused_bert.add_layer_norm_grad(t["x"], t["r"], t["scale"], t["bias"], EPS)
        out.backward(torch.from_numpy(dy).bfloat16())
        return {name: v.grad for name, v in t.items()}

    full, part = grads(), grads(frozen)
    for name in full:
        if name in frozen:
            assert part[name] is None
        else:
            assert torch.equal(part[name], full[name])


def _tiny_retriever(dtype, **kw):
    cfg = bert.BertConfig.tiny(dtype=getattr(torch, dtype), max_position_embeddings=128,
                               flash_attention=True, hidden_dropout=0.0, attention_dropout=0.0,
                               **kw)
    return Retriever(cfg).reset_parameters(0).train()


def _batch(seed: int, b: int = 4, t: int = 128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 128, size=(b, t))
    mask = (np.arange(t)[None] < np.array([t, t // 2, 9, 1])[:, None]).astype(np.int32)
    return {"input_ids_q": torch.from_numpy(ids[:, :16] * mask[:, :16] + (mask[:, :16] == 0)),
            "input_mask_q": torch.ones(b, 16, dtype=torch.int32),
            "input_ids_c": torch.from_numpy(ids * mask), "input_mask_c": torch.from_numpy(mask)}


def _tower_grads(model, batch):
    from proqa_tpu_torch.train.retriever_trainer import in_batch_loss

    model.zero_grad(set_to_none=True)
    loss, _ = in_batch_loss(model(batch))
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_retriever_gradients_match_the_eager_chain(dtype):
    """The slice as a whole on the CPU: a tiny retriever's loss and every
    gradient through the Functions against the same model under
    fused_bert._eager_chain() (the plain chain under autograd): the same
    loss bit for bit, gradients within f32 noise in f32 and within a few
    bf16 roundings of each tensor's largest in bf16."""
    model, batch = _tiny_retriever(dtype), _batch(3)
    loss_f, grads_f = _tower_grads(model, batch)
    with fused_bert._eager_chain():
        loss_e, grads_e = _tower_grads(model, batch)
    assert loss_f == loss_e
    for name, g in grads_f.items():
        scale = grads_e[name].abs().max().item()
        tol = (1e-5 if dtype == "float32" else 2e-2) * scale + 1e-12
        torch.testing.assert_close(g, grads_e[name], atol=tol, rtol=0, msg=name)


def test_training_forward_takes_the_functions(monkeypatch):
    """A training forward on the CPU (grad on) calls dense once a dense layer
    and add_layer_norm_grad once a LayerNorm, and the no-graph entry points
    never; under no_grad it is the other way round; _eager_chain() runs
    neither Function."""
    calls = {"dense": 0, "ln": 0, "dense_apply": 0, "ln_apply": 0}
    wrap = lambda key, fn: lambda *a, **k: (calls.__setitem__(key, calls[key] + 1),  # noqa: E731
                                            fn(*a, **k))[1]
    monkeypatch.setattr(bert, "dense", wrap("dense", bert.dense))
    monkeypatch.setattr(bert, "add_layer_norm_grad", wrap("ln", bert.add_layer_norm_grad))
    monkeypatch.setattr(fused_bert._Dense, "apply",
                        wrap("dense_apply", fused_bert._Dense.apply))
    monkeypatch.setattr(fused_bert._AddLayerNorm, "apply",
                        wrap("ln_apply", fused_bert._AddLayerNorm.apply))
    model = _tiny_retriever("bfloat16")
    layers = model.cfg.num_layers
    ids, mask = _batch(5)["input_ids_c"], _batch(5)["input_mask_c"]
    # q, k, v, attn_out, mlp_in, mlp_out a layer, the pooler, the projection;
    # attn_ln and mlp_ln a layer, the embedding LayerNorm
    once = (6 * layers + 2, 2 * layers + 1)
    model.encode_context(ids, mask).sum().backward()
    assert (calls["dense"], calls["ln"]) == once
    assert (calls["dense_apply"], calls["ln_apply"]) == once
    for key in calls:
        calls[key] = 0
    with torch.no_grad():
        model.encode_context(ids, mask)
    assert calls == {"dense": 0, "ln": 0, "dense_apply": 0, "ln_apply": 0}
    with fused_bert._eager_chain():
        model.encode_context(ids, mask).sum().backward()
    assert (calls["dense"], calls["ln"]) == once
    assert (calls["dense_apply"], calls["ln_apply"]) == (0, 0)


def test_training_route_refuses_other_devices():
    """dense and add_layer_norm_grad take CPU and CUDA tensors only."""
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bert.dense(torch.empty(2, 8, device="meta"), torch.empty(8, 8, device="meta"),
                         torch.empty(8, device="meta"), torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bert.add_layer_norm_grad(torch.empty(2, 8, device="meta"), None,
                                       torch.empty(8, device="meta"),
                                       torch.empty(8, device="meta"), EPS)


@pytest.fixture
def fake_library(monkeypatch):
    """The kernel library's size queries and launches and the scratch the
    wrappers take, recorded instead of run: each query answers 4,160 bytes
    (the C side decides the real size)."""
    calls = []
    fused_bert._scratch_bytes.cache_clear()  # the answers below are not the card's
    monkeypatch.setattr(_build, "query",
                        lambda entry, *args: (calls.append((entry, args)), 4160)[1])
    monkeypatch.setattr(_build, "launch",
                        lambda entry, device, *args: calls.append((entry, args)))

    def workspace(device, nbytes):
        calls.append(("workspace", nbytes))
        return torch.zeros(nbytes, dtype=torch.uint8)

    monkeypatch.setattr(fused_bert, "_workspace", workspace)
    yield calls
    fused_bert._scratch_bytes.cache_clear()


@pytest.mark.parametrize("gelu,need_dz,need_dbias", [
    (True, True, True), (True, True, False), (True, False, True), (True, False, False),
    (False, True, True), (False, True, False), (False, False, True)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_backward_wrapper_host_side(fake_library, dtype, gelu, need_dz, need_dbias):
    """F1's backward wrapper without the card: it asks the C side for the
    scratch of the [rows, cols] problem (rows of a [2, 3, cols] input), takes
    a workspace of that size, passes null for what is not asked and the
    index of its form, launches once where anything is asked (the bias
    gradient, or dz with GELU) and returns dz (dout itself without GELU) and
    an f32 bias gradient [cols]."""
    dt = getattr(torch, dtype)
    dout, z = torch.zeros(2, 3, 40, dtype=dt), torch.zeros(2, 3, 40, dtype=dt)
    before = fused_bert.launches("F1 backward")
    dz, db = fused_bert._dense_epilogue_backward_kernel(dout, z if gelu else None, gelu,
                                                        need_dz, need_dbias)
    launched = need_dbias or (gelu and need_dz)
    assert fused_bert.launches("F1 backward") - before == int(launched)
    queries = [c for c in fake_library if c[0] == "proqa_dense_epilogue_bwd_workspace"]
    assert queries == ([("proqa_dense_epilogue_bwd_workspace", (6, 40, int(gelu), None))]
                       if need_dbias else [])
    launches = [args for entry, args in fake_library if entry == "proqa_dense_epilogue_bwd"]
    assert len(launches) == int(launched)
    assert (("workspace", 4160) in fake_library) == need_dbias
    if launched:
        _, zp, dzp, workspace, dbias, rows, cols, is_bf16, g, form = launches[0]
        assert (rows, cols, is_bf16, g) == (6, 40, int(dtype == "bfloat16"), int(gelu))
        assert fused_bert.DENSE_BWD_FORMS[form] == "slabs"
        assert (zp is None) == (not gelu) and (dzp is None) == (not (gelu and need_dz))
        assert (workspace is None) == (dbias is None) == (not need_dbias)
    assert (dz is None) == (not need_dz) and (db is None) == (not need_dbias)
    if need_dz:
        assert dz.shape == dout.shape and dz.dtype == dt and (gelu or dz is dout)
    if need_dbias:
        assert db.shape == (40,) and db.dtype == torch.float32


@pytest.mark.parametrize("need_dx,need_params", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layer_norm_backward_wrapper_host_side(fake_library, dtype, residual, need_dx,
                                               need_params):
    """F2's backward wrapper without the card: it asks the C side for the
    scratch of the [rows, h] problem in its dtype (the tiles' rows follow the
    width and the dtype), takes a workspace of that size, passes null for
    what is not asked and the index of its form, launches once, and returns
    dx like x and the f32 scale and bias gradients [h]."""
    dt = getattr(torch, dtype)
    x = torch.zeros(2, 3, 24, dtype=dt)
    r = torch.zeros_like(x) if residual else None
    stats = torch.zeros(2, 3)
    before = fused_bert.launches("F2 backward")
    dx, dscale, dbias = fused_bert._add_layer_norm_backward_kernel(
        torch.zeros_like(x), x, r, stats, stats, torch.ones(24), need_dx, need_params)
    assert fused_bert.launches("F2 backward") - before == 1
    queries = [c for c in fake_library if c[0] == "proqa_add_layer_norm_bwd_workspace"]
    assert queries == ([("proqa_add_layer_norm_bwd_workspace",
                         (6, 24, int(dtype == "bfloat16"), None))] if need_params else [])
    assert (("workspace", 4160) in fake_library) == need_params
    (entry, args), = [c for c in fake_library if c[0] == "proqa_add_layer_norm_bwd"]
    _, _, rp, _, _, _, dxp, workspace, dparams, rows, h, is_bf16, form = args
    assert (rows, h, is_bf16) == (6, 24, int(dtype == "bfloat16"))
    assert fused_bert.LN_BWD_FORMS[form] == "tile"
    assert (rp is None) == (not residual) and (dxp is None) == (not need_dx)
    assert (workspace is None) == (dparams is None) == (not need_params)
    assert (dx is None) == (not need_dx)
    assert (dscale is None) == (dbias is None) == (not need_params)
    if need_dx:
        assert dx.shape == x.shape and dx.dtype == dt
    if need_params:
        assert dscale.shape == dbias.shape == (24,) and dscale.dtype == torch.float32
