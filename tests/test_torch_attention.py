"""Port parity: fused attention (kernel K2) against the JAX package's
`fused_attention` in Pallas interpret mode, on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from proqa_tpu.ops.pallas_attention import fused_attention as jax_fused_attention  # noqa: E402
from proqa_tpu_torch.ops import attention  # noqa: E402

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


@pytest.mark.parametrize("case", ["dropout", "grad", "length", "mask_shape"])
def test_fused_attention_rejects_what_it_does_not_take(case):
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(128))
    kw = {"sm_scale": 0.125}
    if case == "dropout":
        kw["dropout_rate"] = 0.1
        err = NotImplementedError
    elif case == "grad":
        q.requires_grad_(True)
        err = NotImplementedError
    elif case == "length":
        q, k, v, mask = q[:, :, :96], k[:, :, :96], v[:, :, :96], mask[:, :96]
        err = ValueError
    else:
        mask = mask[:, :64]
        err = ValueError
    with pytest.raises(err):
        attention.fused_attention(q, k, v, mask, **kw)
