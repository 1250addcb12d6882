"""Per-block symmetric int8 corpus quantization for the dense index.

Counterpart of proqa_tpu/ops/quant.py. `quantize_rows` and
`dequantize_rows` are copies of its numpy code, so both packages produce
byte-equal codes and scales from the same matrix; `expand_scales` takes
torch tensors where the JAX package takes jax arrays.

Scheme: symmetric absmax over blocks of `block` consecutive rows. For block b
covering rows x: scale s_b = max|x| / 127, codes q = round(x / s_b) in
[-127, 127] (all-zero blocks get s = 1). The quantized score used everywhere
is

    score(query, row) = s_block(row) * (query . q_row)

The quantization block equals the search kernel's reduce block (kernel K5,
ops/mips_kernel.py): a per-block scale is constant inside each block's
max-reduce, so it multiplies the reduced block maximum and every emitted
maximum is still an achieved quantized score. block=1 degenerates to per-row
scales, which the row-scored fallback paths and kernel K7 take.

int8 codes convert to bf16 losslessly (integers up to 256 are exact in bf16's
8-bit mantissa), so scoring converted rows in bf16 with f32 accumulation is
exact integer arithmetic times the query.
"""
from __future__ import annotations

import numpy as np
import torch


def quantize_rows(emb: np.ndarray, block: int = 1, chunk: int = 1 << 20):
    """Quantize a host [N, D] float matrix to int8 with per-block scales.

    Returns (codes int8 [N, D], scales f32 [ceil(N/block)]). N % block need
    not be 0: the last partial block is scaled over its real rows. Chunked
    so that a memmapped matrix never needs a second full-size float copy in
    host memory.
    """
    n, d = emb.shape
    nb = -(-n // block)
    q = np.empty((n, d), np.int8)
    scales = np.empty((nb,), np.float32)
    chunk = max(block, chunk - chunk % block)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        part = np.asarray(emb[s:e], np.float32)
        rows = e - s
        pb = -(-rows // block)
        pad = pb * block - rows
        if pad:
            part = np.concatenate([part, np.zeros((pad, d), np.float32)])
        amax = np.abs(part.reshape(pb, -1)).max(axis=1)
        sc = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        codes = np.clip(
            np.rint(part / np.repeat(sc, block)[:, None]), -127, 127
        ).astype(np.int8)
        q[s:e] = codes[:rows]
        scales[s // block : s // block + pb] = sc
    return q, scales


def dequantize_rows(q: np.ndarray, scales: np.ndarray, block: int = 1) -> np.ndarray:
    """Inverse of quantize_rows (up to rounding): f32 [N, D]."""
    n = q.shape[0]
    row_sc = np.repeat(np.asarray(scales, np.float32), block)[:n]
    return q.astype(np.float32) * row_sc[:, None]


def expand_scales(scales, block: int, n: int):
    """Per-block [NB] -> per-row [n] scales, for the row-scored paths. Works
    on numpy arrays or torch tensors."""
    if block == 1:
        return scales[:n]
    if isinstance(scales, np.ndarray):
        return np.repeat(scales, block)[:n]
    return torch.repeat_interleave(scales, block)[:n]
