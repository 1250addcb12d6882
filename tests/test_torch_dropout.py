"""Counter-based random bits, fused dropout (kernel K4's plain version) and
dot_f32's backward, on the CPU.

The TPU kernels draw their masks from a hardware PRNG that no other machine
replays, so the port is held to: its own bits computed two ways (Python ints
and torch integer ops, the second being what the CUDA kernels compute), the
keep rate, and a backward that applies the forward's mask."""
import random as pyrandom

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from proqa_tpu_torch.ops import dot, dropout, random  # noqa: E402


def _bits_py(k0, k1, n):
    return random.mix32(random.mix32((n & random.MASK32) ^ k0) ^ (n >> 32) ^ k1)


def test_bits_match_python_integers():
    rng = pyrandom.Random(0)
    for c in (0x7FEB352D, 0x846CA68B, 0xFFFFFFFF, 1):
        xs = [rng.getrandbits(32) for _ in range(200)] + [0, random.MASK32]
        got = random._mul32(torch.tensor(xs), c).tolist()
        assert got == [(x * c) & random.MASK32 for x in xs]
    k0, k1 = random.keys(2**63 - 5, stream=3)
    counters = [rng.getrandbits(40) for _ in range(300)] + [0, 2**32 - 1, 2**32]
    got = random.bits(k0, k1, torch.tensor(counters)).tolist()
    assert got == [_bits_py(k0, k1, n) for n in counters]


def test_keys_depend_on_seed_and_stream():
    seen = {random.keys(s, t) for s in (0, 1, 2**32, 2**63) for t in (0, 1, 2)}
    assert len(seen) == 12
    assert all(0 <= k < 2**32 for pair in seen for k in pair)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_within_five_sigma(rate):
    n = 1 << 20
    keep = random.keep_mask(12345, 0, rate, (n,), "cpu").double().mean().item()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep - (1 - rate)) < 5 * sigma
    assert random.threshold(rate) == int(rate * 2**32)


def test_masks_of_other_seeds_are_independent():
    a = random.keep_mask(1, 0, 0.5, (1 << 16,), "cpu")
    b = random.keep_mask(2, 0, 0.5, (1 << 16,), "cpu")
    c = random.keep_mask(1, 1, 0.5, (1 << 16,), "cpu")
    for other in (b, c):
        agree = (a == other).double().mean().item()
        assert abs(agree - 0.5) < 5 * (0.25 / (1 << 16)) ** 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_forward_and_backward(dtype):
    x = torch.randn(6, 33, 16, generator=torch.Generator().manual_seed(0))
    x = x.to(getattr(torch, dtype)).requires_grad_(True)
    y = dropout.dropout(x, 0.25, seed=77)
    keep = random.keep_mask(77, 0, 0.25, x.shape, "cpu")
    scale = torch.tensor(1 / 0.75, dtype=torch.float32)
    want = torch.where(keep, x.detach().float() * scale, 0.0).to(x.dtype)
    assert y.dtype == x.dtype and torch.equal(y, want)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(x.dtype)
    y.backward(g)
    assert torch.equal(x.grad, torch.where(keep, g.float() * scale, 0.0).to(x.dtype))
    assert dropout.dropout(x, 0.0, seed=77) is x
    with pytest.raises(ValueError):
        dropout.dropout(x, 1.0, seed=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "input_needs_no_grad"])
def test_dropout_without_a_gradient_builds_no_autograd_node(dtype, mode):
    """Where no gradient is asked for, the wrapper calls the kernel (here its
    plain version) directly: the same values, no autograd node."""
    x = torch.randn(5, 7, 16, generator=torch.Generator().manual_seed(2)).to(getattr(torch, dtype))
    want = dropout.dropout_reference(x, 0.3, seed=9)
    if mode == "input_needs_no_grad":
        y = dropout.dropout(x, 0.3, seed=9)
    else:
        xr = x.clone().requires_grad_(True)
        with torch.no_grad() if mode == "no_grad" else torch.inference_mode():
            y = dropout.dropout(xr, 0.3, seed=9)
    assert y.grad_fn is None and not y.requires_grad
    assert torch.equal(y, want)
    yg = dropout.dropout(x.clone().requires_grad_(True), 0.3, seed=9)
    assert yg.grad_fn is not None and torch.equal(yg.detach(), want)


def test_dropout_counts_no_cpu_launch():
    before = dropout.launches
    dropout.dropout(torch.ones(8, 8), 0.5, seed=3)
    assert dropout.launches == before


@pytest.mark.parametrize("batched", [False, True])
def test_dot_f32_backward_formula(monkeypatch, batched):
    """The CUDA branch's backward, run here through the Function with the
    f32-result product emulated on the CPU: the cotangent is rounded to the
    operand dtype, multiplied with f32 accumulation, rounded again."""
    monkeypatch.setattr(dot, "_mm_f32", lambda a, b: torch.matmul(a.float(), b.float()))
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((3, 5, 8)).astype(np.float32)).bfloat16()
    b_shape = (3, 8, 4) if batched else (8, 4)
    b = torch.from_numpy(rng.standard_normal(b_shape).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((3, 5, 4)).astype(np.float32))

    class Ctx:
        saved_tensors = (a, b)
        needs_input_grad = (True, True)

    da, db = dot._DotF32.backward(Ctx, g)
    gr = g.bfloat16().float()
    want_da = (gr @ b.float().transpose(-1, -2)).bfloat16()
    if batched:
        want_db = (a.float().transpose(-1, -2) @ gr).bfloat16()
    else:
        want_db = (a.float().reshape(-1, 8).T @ gr.reshape(-1, 4)).bfloat16()
    assert da.dtype == torch.bfloat16 and db.dtype == torch.bfloat16
    assert torch.equal(da, want_da) and torch.equal(db, want_db)
    assert db.shape == b.shape and da.shape == a.shape
