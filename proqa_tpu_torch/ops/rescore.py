"""Gathered scoring of each query's candidate corpus blocks: kernels K6 and K9.

Counterpart of proqa_tpu/ops/pallas_rescore.py:gather_rescore (K6, the
`impl="stream"` rescore of ops/mips.py) and
proqa_tpu/ops/pallas_gather_score.py:gather_score (K9). Both return
[Q, kb * block] f32 with

    out[q, j * block + b] = corpus_blocked[block_ids[q, j], b] . queries[q]

They are the same function (the two TPU kernels differ only in how Mosaic
fetched the slabs), so both wrappers launch the one CUDA kernel of
csrc/gather_rescore.cu, each with its own launch counter. The TPU's layout
limits (128 % block == 0, Q % 8 == 0, per-call query chunks) do not apply.
CPU tensors run `gather_rescore_reference`, the plain version.
"""
from __future__ import annotations

import torch

from proqa_tpu_torch import _build

KERNEL_DIM = 128  # the embedding width the CUDA kernel takes

# kernel launches since the last reset (the main path's proof of use)
launches = 0        # K6: gather_rescore
score_launches = 0  # K9: gather_score


def _check_shapes(queries, corpus_blocked, block_ids, block: int) -> None:
    if (queries.dim() != 2 or corpus_blocked.dim() != 3 or block_ids.dim() != 2
            or corpus_blocked.shape[1] != block or corpus_blocked.shape[2] != queries.shape[1]
            or block_ids.shape[0] != queries.shape[0]):
        raise ValueError(f"need queries [Q, D], corpus_blocked [NB, {block}, D] and block_ids "
                         f"[Q, kb], got {tuple(queries.shape)}, {tuple(corpus_blocked.shape)} "
                         f"and {tuple(block_ids.shape)}")


def gather_rescore_reference(queries, corpus_blocked, block_ids, *, block: int):
    """Plain PyTorch version of K6 / K9: the gathered candidates, scored in
    f32 (bf16 products are exact in f32)."""
    _check_shapes(queries, corpus_blocked, block_ids, block)
    q, d = queries.shape
    cand = corpus_blocked[block_ids.long()].to(queries.dtype).float()   # [Q, kb, B, D]
    return torch.einsum("qkbd,qd->qkb", cand, queries.float()).reshape(q, -1)


def _launch(queries, corpus_blocked, block_ids, block: int):
    _check_shapes(queries, corpus_blocked, block_ids, block)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    q, d = queries.shape
    if d != KERNEL_DIM:
        raise ValueError(f"the K6/K9 kernel takes D={KERNEL_DIM}, got D={d}")
    if queries.dtype not in (torch.bfloat16, torch.float32) or corpus_blocked.dtype != queries.dtype:
        raise TypeError(f"queries and corpus must share a dtype of bf16 or f32, "
                        f"got {queries.dtype} and {corpus_blocked.dtype}")
    if block_ids.dtype.is_floating_point or block_ids.dtype == torch.bool:
        raise TypeError(f"block_ids must be integers, got {block_ids.dtype}")
    ids = block_ids.to(torch.int64).contiguous()
    for name, x in (("queries", queries), ("corpus", corpus_blocked), ("block_ids", ids)):
        if x.device != queries.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor "
                             f"on {queries.device}")
    kb = ids.shape[1]
    out = torch.empty(q, kb * block, dtype=torch.float32, device=queries.device)
    _build.launch("proqa_gather_score", queries.device, queries.data_ptr(),
                  corpus_blocked.data_ptr(), ids.data_ptr(), out.data_ptr(), q,
                  corpus_blocked.shape[0], kb, block, d, int(queries.dtype == torch.bfloat16))
    return out


def gather_rescore(queries, corpus_blocked, block_ids, *, block: int):
    """K6: [Q, kb * block] f32 scores of each query's candidate blocks
    (queries [Q, D], corpus_blocked [NB, block, D], block_ids [Q, kb] in
    [0, NB)), without materializing the [Q, kb, block, D] gather."""
    global launches
    if queries.device.type == "cpu":
        return gather_rescore_reference(queries, corpus_blocked, block_ids, block=block)
    out = _launch(queries, corpus_blocked, block_ids, block)
    launches += 1
    return out


def gather_score(queries, corpus_blocked, block_ids, *, block: int):
    """K9: the same function as gather_rescore, under the JAX package's
    other name for it (pallas_gather_score.py)."""
    global score_launches
    if queries.device.type == "cpu":
        return gather_rescore_reference(queries, corpus_blocked, block_ids, block=block)
    out = _launch(queries, corpus_blocked, block_ids, block)
    score_launches += 1
    return out
