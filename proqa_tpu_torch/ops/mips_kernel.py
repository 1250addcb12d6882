"""Block-max MIPS pipeline around kernel K1.

Counterpart of proqa_tpu/ops/pallas_mips.py:block_maxima_grouped (K1) and
mips_topk_pallas_v2, the three-stage search around it:

  1. K1: block maxima bmax3 [CG, Q, G] and group maxima gmax [CG, 1, Q];
  2. select: the top-k groups from gmax, then the top-k blocks among the
     k * G block maxima of those groups;
  3. rescore: gather those k blocks' rows and take the exact top-k.

Stages 2 and 3 are torch ops, as they are XLA ops in the JAX package. CUDA
tensors run K1 as the hand-written kernel in csrc/block_maxima.cu; CPU
tensors run `block_maxima_grouped_reference`, its plain PyTorch version.
"""
from __future__ import annotations

import torch

from proqa_tpu_torch import _build
from proqa_tpu_torch.ops.dot import dot_f32
from proqa_tpu_torch.ops.mips import NEG_INF, exact_topk, pad_rows, rescore_block_candidates

GROUP = 128  # blocks per group, as the JAX package pins it
KERNEL_DIM = 128  # the embedding width the CUDA kernel takes

# kernel launches since the last reset (the main path's proof of use)
launches = 0


def _check_shapes(queries, corpus, block: int, group: int) -> int:
    if queries.dim() != 2 or corpus.dim() != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} and corpus {tuple(corpus.shape)} "
                         "must be [Q, D] and [N, D]")
    n = corpus.shape[0]
    if n % (group * block):
        raise ValueError(f"N={n} must be a multiple of group*block={group * block}")
    return n // (group * block)


def block_maxima_grouped_reference(queries, corpus, *, block: int, group: int = GROUP):
    """Plain PyTorch version of K1: the full score matrix, reduced."""
    cg = _check_shapes(queries, corpus, block, group)
    s = dot_f32(corpus.to(queries.dtype), queries.T)             # [N, Q] f32
    bm = s.view(cg, group, block, queries.shape[0]).amax(dim=2)  # [CG, G, Q]
    bmax3 = bm.transpose(1, 2).contiguous()                      # [CG, Q, G]
    return bmax3, bmax3.amax(dim=2)[:, None, :]


def block_maxima_grouped(queries, corpus, *, block: int, group: int = GROUP):
    """Fused scoring + two-level maxima: bmax3 [CG, Q, G] (block maxima, the G
    blocks of a group contiguous per query) and gmax [CG, 1, Q] (group
    maxima), both f32. N must be a multiple of group * block."""
    global launches
    cg = _check_shapes(queries, corpus, block, group)
    if queries.device.type == "cpu":
        return block_maxima_grouped_reference(queries, corpus, block=block, group=group)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    q, d = queries.shape
    if d != KERNEL_DIM:
        raise ValueError(f"the K1 kernel takes D={KERNEL_DIM}, got D={d}")
    if queries.dtype not in (torch.bfloat16, torch.float32) or corpus.dtype != queries.dtype:
        raise TypeError(f"queries and corpus must share a dtype of bf16 or f32, "
                        f"got {queries.dtype} and {corpus.dtype}")
    if block % 16 or (group * block) % 64:
        raise ValueError(f"block={block} must be a multiple of 16 and group*block of 64")
    for name, x in (("queries", queries), ("corpus", corpus)):
        if x.device != queries.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor "
                             f"on {queries.device}")
    bmax3 = torch.empty(cg, q, group, dtype=torch.float32, device=queries.device)
    gmax = torch.empty(cg, 1, q, dtype=torch.float32, device=queries.device)
    with torch.cuda.device(queries.device):
        code = _build.library().proqa_block_maxima(
            queries.data_ptr(), corpus.data_ptr(), bmax3.data_ptr(), gmax.data_ptr(),
            q, corpus.shape[0], d, block, group, int(queries.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "block_maxima")
    launches += 1
    return bmax3, gmax


def mips_topk_v2(queries, corpus, k: int, *, block: int, group: int = GROUP,
                 n_valid: int | None = None):
    """Exact MIPS top-k through the three stages above; returns (values
    [Q, k] f32, row indices [Q, k] int64). Rows at or past n_valid are
    padding and never returned with a real score. Stage 2 keeps k groups and
    k blocks, the least that keeps the search exact."""
    q, d = queries.shape
    if n_valid is None:
        n_valid = corpus.shape[0]
    corpus = pad_rows(corpus.to(queries.dtype), group * block)
    n = corpus.shape[0]
    nb, cg = n // block, n // (group * block)
    kb_g, kb_b = min(k, cg), min(k, nb)   # groups, blocks to visit

    bmax3, gmax = block_maxima_grouped(queries, corpus, block=block, group=group)

    if n_valid != n:
        # blocks wholly past n_valid can never hold a result
        block_ids = torch.arange(nb, device=bmax3.device).view(cg, 1, group)
        bmax3 = bmax3.masked_fill(block_ids * block >= n_valid, NEG_INF)
        if n_valid % block:
            # the block straddling n_valid holds zero-score padding rows; its
            # maxima are recomputed over the valid rows alone
            sb = min(n_valid // block, nb - 1)
            s = dot_f32(queries, corpus[sb * block:(sb + 1) * block].T)   # [Q, block]
            row_valid = sb * block + torch.arange(block, device=s.device) < n_valid
            bmax3[sb // group, :, sb % group] = torch.where(row_valid, s, NEG_INF).amax(dim=1)
        gmax = bmax3.amax(dim=-1)[:, None, :]

    top_groups = exact_topk(gmax.view(cg, q).T, kb_g).indices            # [Q, kb_g]
    cand = bmax3[top_groups, torch.arange(q, device=bmax3.device)[:, None]]  # [Q, kb_g, G]
    sel = exact_topk(cand.reshape(q, kb_g * group), kb_b).indices
    top_blocks = torch.gather(top_groups, 1, sel // group) * group + sel % group
    return rescore_block_candidates(queries, top_blocks, corpus.view(nb, block, d), k=k,
                                    block=block, n_valid=n_valid)
