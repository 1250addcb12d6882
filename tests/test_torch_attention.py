"""Port parity: fused attention (kernels K2 and K3, through their plain
versions) against the JAX package's `fused_attention` and its custom VJP in
Pallas interpret mode, on the same numpy inputs. At dropout rate > 0 the TPU's
hardware bits cannot be replayed, so the port is held to its own mask: the
keep rate, and forward/backward consistency through the linearity-in-v
identity of tools/attention_tpu_check.py."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from proqa_tpu.ops.pallas_attention import fused_attention as jax_fused_attention  # noqa: E402
from proqa_tpu_torch.ops import attention, random  # noqa: E402

# bf16: both sides round p and the output to bf16 at the same points; what
# differs is the f32 summation order, which can flip a rounding by one bf16
# ulp (2^-8 relative) of outputs of magnitude ~1
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(t, seed=0, b=2, h=2, dh=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, t), np.int32)
    mask[0, t // 3:] = 0        # padded tail
    mask[1, :] = 0              # all padding: uniform attention, never NaN
    return q, k, v, mask


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [128, 256])
def test_fused_attention_matches_jax(t, dtype):
    q, k, v, mask = _inputs(t)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = jax_fused_attention(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)), jnp.asarray(mask),
        sm_scale=scale, interpret=True,
    )
    want = np.asarray(want.astype(jnp.float32))
    got = attention.fused_attention(
        *(_to_torch(x, dtype) for x in (q, k, v)), torch.from_numpy(mask), sm_scale=scale)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)
    # the all-padding row attends uniformly: every output row is the mean of v
    v_mean = _to_torch(v, dtype).float().numpy()[1].mean(axis=1, keepdims=True)
    np.testing.assert_allclose(got[1], np.broadcast_to(v_mean, got[1].shape),
                               atol=TOL[dtype], rtol=0)


def test_fused_attention_counts_no_cpu_launch():
    before = attention.launches
    q, k, v, mask = _inputs(128)
    attention.fused_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              torch.from_numpy(mask), sm_scale=0.125)
    assert attention.launches == before  # the plain version is not the kernel


@pytest.mark.parametrize("case", ["rate", "length", "mask_shape"])
def test_fused_attention_rejects_what_it_does_not_take(case):
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(128))
    kw = {"sm_scale": 0.125}
    if case == "rate":
        kw["dropout_rate"] = 1.0
        err = ValueError
    elif case == "length":
        q, k, v, mask = q[:, :, :96], k[:, :, :96], v[:, :, :96], mask[:, :96]
        err = ValueError
    else:
        mask = mask[:, :64]
        err = ValueError
    with pytest.raises(err):
        attention.fused_attention(q, k, v, mask, **kw)


@pytest.mark.parametrize("case", ["dropout", "grad"])
def test_fused_attention_takes_what_it_did_not_take(case):
    """Dropout and gradients, which the inference slice refused, now run."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(128))
    if case == "dropout":
        out = attention.fused_attention(q, k, v, mask, sm_scale=0.125, dropout_rate=0.1, seed=5)
        assert not torch.equal(out, attention.fused_attention(q, k, v, mask, sm_scale=0.125))
    else:
        q.requires_grad_(True)
        attention.fused_attention(q, k, v, mask, sm_scale=0.125).sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad).all()


# bf16: dq, dk, dv are rounded to bf16 at the same points on both sides (pd,
# ds, the outputs); f32 summation orders differ, which can flip one bf16
# rounding of ds before its product: a few bf16 ulps of outputs of magnitude ~1
BWD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [128, 256])
def test_fused_attention_backward_matches_jax_vjp(t, dtype):
    q, k, v, mask = _inputs(t, seed=1)
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jax_fused_attention(q_, k_, v_, jnp.asarray(mask), sm_scale=scale,
                                               interpret=True),
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jdt))]
    tq, tk, tv = (_to_torch(x, dtype).requires_grad_(True) for x in (q, k, v))
    attention.fused_attention(tq, tk, tv, torch.from_numpy(mask),
                              sm_scale=scale).backward(_to_torch(do, dtype))
    plain = attention.fused_attention_backward_reference(
        *(_to_torch(x, dtype) for x in (q, k, v)), torch.from_numpy(mask),
        _to_torch(do, dtype), sm_scale=scale)
    for got, ref, w in zip((tq.grad, tk.grad, tv.grad), plain, want):
        assert got.dtype == getattr(torch, dtype)
        assert torch.equal(got, ref)  # autograd runs the plain backward on the CPU
        np.testing.assert_allclose(got.float().numpy(), w, atol=BWD_TOL[dtype], rtol=0)


def test_plain_backward_agrees_with_autograd_of_the_plain_forward():
    """K3's plain version (the TPU kernel's formulas) against torch autograd
    through K2's plain version, f32, with dropout."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(128, seed=3))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(4))
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    attention.fused_attention_reference(qr, kr, vr, mask, sm_scale=0.2, dropout_rate=0.2,
                                        seed=9).backward(do)
    plain = attention.fused_attention_backward_reference(q, k, v, mask, do, sm_scale=0.2,
                                                         dropout_rate=0.2, seed=9)
    for got, want in zip(plain, (qr.grad, kr.grad, vr.grad)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_attention_dropout_keep_rate_and_mask():
    b, h, t, rate = 2, 2, 256, 0.1
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(t, seed=5))
    keep = random.keep_mask(123, attention.STREAM, rate, (b, h, t, t), "cpu")
    n = keep.numel()
    assert abs(keep.double().mean().item() - (1 - rate)) < 5 * (rate * (1 - rate) / n) ** 0.5
    got = attention.fused_attention(q, k, v, mask, sm_scale=0.125, dropout_rate=rate, seed=123)
    bias = torch.where(mask[:, None, None, :] != 0, 0.0, attention.MASK_BIAS)
    p = torch.softmax(q @ k.transpose(-1, -2) * 0.125 + bias, dim=-1)
    want = torch.where(keep, p * torch.tensor(1 / (1 - rate)), 0.0) @ v
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_attention_dropout_forward_backward_consistency():
    """For a fixed mask the output is linear in v, so <do, out(v)> equals
    <dv, v> when the backward regenerates the forward's mask; a backward with
    another seed breaks the identity (the control)."""
    q, k, v, mask = (torch.from_numpy(x).double().float() for x in _inputs(256, seed=6))
    mask = mask.to(torch.int32)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(7))
    vr = v.clone().requires_grad_(True)
    out = attention.fused_attention(q, k, vr, mask, sm_scale=0.125, dropout_rate=0.3, seed=42)
    out.backward(do)
    lhs = (do.double() * out.detach().double()).sum().item()
    rhs = (vr.grad.double() * v.double()).sum().item()
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)
    _, _, dv_other = attention.fused_attention_backward_reference(
        q, k, v, mask, do, sm_scale=0.125, dropout_rate=0.3, seed=43)
    control = (dv_other.double() * v.double()).sum().item()
    assert abs(lhs - control) > 100 * abs(lhs - rhs)
