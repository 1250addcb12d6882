"""Helpers for the tests, chip_smoke.py and profile_slice: holding one top-k
search result against another, making an int8 corpus on the device, and the
bound on a gradient that is zero in exact arithmetic."""
from __future__ import annotations

import numpy as np
import torch


def topk_disagreements(va, ia, vb, ib, *, atol: float) -> int:
    """Rows where two top-k results differ by more than equal-score ties.

    Values must agree position by position within atol, and the id sets may
    differ only in ids whose score lies within atol of the row's k-th score
    (the rule of tests/test_pallas_mips.py: ties can swap equal values, never
    lose recall). Arguments are numpy arrays [Q, k]."""
    bad = 0
    for r in range(va.shape[0]):
        if not np.allclose(va[r], vb[r], atol=atol, rtol=0.0):
            bad += 1
            continue
        kth = min(va[r, -1], vb[r, -1])
        score = dict(zip(ia[r].tolist(), va[r].tolist()))
        score.update(zip(ib[r].tolist(), vb[r].tolist()))
        diff = set(ia[r].tolist()) ^ set(ib[r].tolist())
        if any(abs(score[i] - kth) > atol for i in diff):
            bad += 1
    return bad


# A bias gradient that is zero in exact arithmetic (the retriever's context
# head: a constant added to every context embedding moves each query's
# in-batch scores alike, so the loss does not move) is rounding noise. It is
# held to this many units of f32 rounding (2^-24) of the column sums' terms:
# a few ulps of error in each element of the gradient reaching the layer
# (the softmax chain above it), and the rows' sum.
ZERO_GRAD_ULPS = 64


def zero_grad_unit(dout: torch.Tensor) -> float:
    """One f32 rounding unit of the largest column sum of |dout| (dout: the
    gradient at the biased layer's output, [rows, cols]): 2^-24 * max_c
    sum_r |dout[r, c]|. A zero bias gradient is noise within ZERO_GRAD_ULPS
    of it."""
    return 2.0 ** -24 * dout.double().abs().reshape(-1, dout.shape[-1]).sum(0).max().item()


def zero_grad_ratio(grad: torch.Tensor, unit: float) -> float:
    """max |grad| in units of zero_grad_unit: at most ZERO_GRAD_ULPS for a
    gradient that is zero in exact arithmetic."""
    return grad.double().abs().max().item() / unit


def random_int8_corpus(n: int, d: int, block: int, *, seed: int, device,
                       chunk: int = 1 << 21, norm_range: tuple[float, float] | None = None):
    """A random corpus quantized on the device: (codes int8 [n, d], scales f32
    [n / block]), the scheme of ops/quant.py (symmetric absmax over blocks of
    `block` rows) applied to standard-normal rows / sqrt(d), each row scaled
    by a factor uniform in norm_range when it is given. Made chunk by chunk,
    so that no f32 copy of the whole corpus exists: at 67M x 128 that copy
    would be 34 GB. n and chunk must be multiples of block."""
    if n % block or chunk % block:
        raise ValueError(f"n={n} and chunk={chunk} must be multiples of block={block}")
    g = torch.Generator(device=device).manual_seed(seed)
    codes = torch.empty(n, d, dtype=torch.int8, device=device)
    scales = torch.empty(n // block, dtype=torch.float32, device=device)
    for s in range(0, n, chunk):
        rows = min(chunk, n - s)
        part = torch.randn(rows, d, device=device, generator=g) / d ** 0.5
        if norm_range is not None:
            lo, hi = norm_range
            part *= torch.empty(rows, 1, device=device).uniform_(lo, hi, generator=g)
        amax = part.view(rows // block, block * d).abs().amax(dim=1)
        sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.round(part / sc.repeat_interleave(block)[:, None]).clamp_(-127, 127)
        codes[s:s + rows] = q.to(torch.int8)
        scales[s // block:(s + rows) // block] = sc
    return codes, scales
