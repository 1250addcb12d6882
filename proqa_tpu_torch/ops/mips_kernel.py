"""Block-max MIPS pipelines around kernels K1, K5, K7 and K8.

Counterpart of proqa_tpu/ops/pallas_mips.py: block_maxima_grouped (K1; K5
with per-block scales of an int8 corpus; K7 with per-row scale bounds),
block_maxima (K8), and the two search pipelines around them. mips_topk_v2
(mips_topk_pallas_v2) runs three stages:

  1. K1/K5/K7: block maxima bmax3 [CG, Q, G] and group maxima gmax [CG, 1, Q];
  2. select: the top-k groups from gmax, then the top-k blocks among the
     k * G block maxima of those groups;
  3. rescore: score those k blocks' rows and take the exact top-k (kernel
     K6 on CUDA over bf16 or f32, else the `take` gather:
     ops/mips.py:rescore_impl_for).

mips_topk_v1 (mips_topk_pallas) is the older two-stage pipeline: K8's block
maxima [NB, Q], the top-kb blocks of each query, the rescore.

Stage 2 and stage 3's selection are torch ops, as they are XLA ops in the
JAX package. CUDA tensors run a hand-written block-maxima kernel
(`kernel_for` chooses): K1 over a bf16 corpus, K5 and K7 over int8 codes,
all with bf16 queries, and K8 over bf16 in csrc/block_maxima_wgmma.cu; K1
over f32 in csrc/block_maxima_f32.cu; f32 K8, f32 queries over int8 codes
and the shapes neither takes in csrc/block_maxima.cu. CPU tensors run their
plain PyTorch versions (`*_reference`).

Widths: every kernel takes any embedding width D that is a multiple of 16
(`kernel_takes_dim`), with no upper limit: D = 128 runs the forms first
built for it, every other width their K-loop forms, which stream the
queries' slices beside the corpus's. Another width raises on the card,
naming it; the JAX package's Pallas kernel takes d % 128 == 0 and its XLA
path any d (ROADMAP Queue 3).

The last group of the grouped output may be partial: N need only be a
multiple of block, and the rows past N score 0, as zero padding rows would.
So mips_topk_v2 searches an index's rows where they lie, with no padded copy
of the corpus (a 21M x 768 bf16 index is 32 GB).
"""
from __future__ import annotations

import torch

from proqa_tpu_torch import _build
from proqa_tpu_torch.ops.dot import dot_f32
from proqa_tpu_torch.ops.mips import (
    NEG_INF, exact_topk, pad_ones, pad_rows, rescore_block_candidates,
)
from proqa_tpu_torch.ops.rescore import DIM_MULTIPLE, kernel_takes_dim
from proqa_tpu_torch.utils.profiling import span

GROUP = 128  # blocks per group, as the JAX package pins it

# kernel launches since the last reset (the main path's proof of use), one
# count for each TPU kernel this module replaces
launches = 0              # K1: block_maxima_grouped, bf16 (and the simple body)
f32_launches = 0          # K1: block_maxima_grouped, f32, csrc/block_maxima_f32.cu
scaled_launches = 0       # K5: block_maxima_grouped(scales=)
bounded_launches = 0      # K7: block_maxima_grouped(scale_bounds=)
block_major_launches = 0  # K8: block_maxima
# groups of block maxima that select_blocks masked for padding since the
# last reset (the tail from the first block at or past n_valid; 0 when the
# valid rows fill whole groups)
tail_mask_groups = 0


def _check_shapes(queries, corpus, block: int, group: int, scales=None,
                  scale_bounds=None) -> int:
    """The number of groups, the last one possibly partial."""
    if queries.dim() != 2 or corpus.dim() != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} and corpus {tuple(corpus.shape)} "
                         "must be [Q, D] and [N, D]")
    n = corpus.shape[0]
    if n % block:
        raise ValueError(f"N={n} must be a multiple of block={block}")
    if scales is not None and scale_bounds is not None:
        raise ValueError("pass scales or scale_bounds, not both")
    for s in (scales,) if scale_bounds is None else scale_bounds:
        if s is not None and tuple(s.shape) != (n // block,):
            raise ValueError(f"need per-block scales [{n // block}], got {tuple(s.shape)}: the "
                             "quantization block must equal the kernel block")
    return -(-n // (group * block))


def _epilogue(bm, scales, scale_bounds):
    """Raw block maxima bm [NB, Q] -> times their block's scale (K5), or the
    sign-aware bound of row-scaled scores (K7)."""
    if scales is not None:
        return bm * scales.float()[:, None]
    if scale_bounds is not None:
        smax, smin = (s.float()[:, None] for s in scale_bounds)
        return torch.where(bm >= 0, bm * smax, bm * smin)
    return bm


def _raw_block_maxima(queries, corpus, block: int):
    """[NB, Q] f32 maxima of the full score matrix, block by block."""
    s = dot_f32(corpus.to(queries.dtype), queries.T)             # [N, Q] f32
    return s.view(-1, block, queries.shape[0]).amax(dim=1)


def _grid_scales(scales, scale_bounds, nb: int):
    """The scales (K5) or bounds (K7) padded with 1.0 to the nb blocks of the
    whole groups (the blocks past N hold zero rows)."""
    if scales is not None:
        scales = pad_ones(scales, nb)
    if scale_bounds is not None:
        scale_bounds = tuple(pad_ones(s, nb) for s in scale_bounds)
    return scales, scale_bounds


def block_maxima_grouped_reference(queries, corpus, *, block: int, group: int = GROUP,
                                   scales=None, scale_bounds=None):
    """Plain PyTorch version of K1, K5 and K7: the full score matrix, reduced
    (a partial last group completed with zero rows)."""
    cg = _check_shapes(queries, corpus, block, group, scales, scale_bounds)
    scales, scale_bounds = _grid_scales(scales, scale_bounds, cg * group)
    corpus = pad_rows(corpus, group * block)
    bm = _epilogue(_raw_block_maxima(queries, corpus, block), scales, scale_bounds)
    bmax3 = bm.view(cg, group, -1).transpose(1, 2).contiguous()  # [CG, Q, G]
    return bmax3, bmax3.amax(dim=2)[:, None, :]


WGMMA_BLOCKS = (16, 32, 64, 128, 256)  # blocks the Hopper kernels reduce at
WGMMA_CHUNK = 128  # corpus rows of their chunks: group * block must be a multiple


def kernel_for(queries_dtype, corpus_dtype, *, block: int, group: int, grouped: bool,
               scaled: bool) -> str:
    """Which CUDA kernel a launch takes, from dtypes and shapes alone. Both
    Hopper kernels take a block in WGMMA_BLOCKS and group * block a multiple
    of WGMMA_CHUNK (for K8, group = tile_n / block). Then "wgmma"
    (csrc/block_maxima_wgmma.cu) for bf16 queries and either the grouped
    output over a bf16 corpus without scales (K1) or over int8 codes with
    scales or scale bounds (K5, K7), or the block-major output over a bf16
    corpus (K8); "f32" (csrc/block_maxima_f32.cu) for f32 queries, an f32
    corpus and the grouped output without scales (K1); "simple"
    (csrc/block_maxima.cu's body: f32 K8, f32 queries over int8, other
    shapes) else."""
    if block not in WGMMA_BLOCKS or (group * block) % WGMMA_CHUNK:
        return "simple"
    if queries_dtype == torch.bfloat16:
        if grouped and (corpus_dtype, scaled) in ((torch.bfloat16, False), (torch.int8, True)):
            return "wgmma"
        if not grouped and corpus_dtype == torch.bfloat16 and not scaled:
            return "wgmma"
    if (queries_dtype == torch.float32 and corpus_dtype == torch.float32 and grouped
            and not scaled):
        return "f32"
    return "simple"


def _launch(queries, corpus, bmax, gmax, *, block: int, group: int, scales=None,
            scale_bounds=None) -> str:
    """Checks what the kernels take, launches the one kernel_for picks and
    returns its name. gmax None: the block-major output (K8)."""
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    q, d = queries.shape
    if not kernel_takes_dim(d):
        raise ValueError(f"the block-maxima kernels take D a multiple of {DIM_MULTIPLE}, "
                         f"got D={d}")
    if queries.dtype not in (torch.bfloat16, torch.float32) or corpus.dtype not in (
            queries.dtype, torch.int8):
        raise TypeError(f"queries must be bf16 or f32 and the corpus of their dtype or int8, "
                        f"got {queries.dtype} and {corpus.dtype}")
    if block % 16 or (group * block) % 64:
        raise ValueError(f"block={block} must be a multiple of 16 and group*block of 64")
    scale_a, scale_b = scales, None
    if scale_bounds is not None:
        scale_a, scale_b = scale_bounds
    scale_a, scale_b = (None if s is None else s.to(torch.float32).contiguous()
                        for s in (scale_a, scale_b))
    for name, x in (("queries", queries), ("corpus", corpus), ("scales", scale_a),
                    ("scale bounds", scale_b)):
        if x is not None and (x.device != queries.device or not x.is_contiguous()
                              or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor "
                             f"on {queries.device}")
    n = corpus.shape[0]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    route = kernel_for(queries.dtype, corpus.dtype, block=block, group=group,
                       grouped=gmax is not None, scaled=scale_a is not None)
    if route == "wgmma" and gmax is None:
        _build.launch("proqa_block_maxima_wgmma_block_major", queries.device, queries.data_ptr(),
                      corpus.data_ptr(), bmax.data_ptr(), q, n, d, block, group)
    elif route == "wgmma" and corpus.dtype == torch.bfloat16:
        _build.launch("proqa_block_maxima_wgmma", queries.device, queries.data_ptr(),
                      corpus.data_ptr(), bmax.data_ptr(), gmax.data_ptr(), q, n, d, block, group)
    elif route == "wgmma":
        _build.launch("proqa_block_maxima_wgmma_int8", queries.device, queries.data_ptr(),
                      corpus.data_ptr(), scale_a.data_ptr(), ptr(scale_b), bmax.data_ptr(),
                      gmax.data_ptr(), q, n, d, block, group)
    elif route == "f32":
        _build.launch("proqa_block_maxima_f32", queries.device, queries.data_ptr(),
                      corpus.data_ptr(), bmax.data_ptr(), gmax.data_ptr(), q, n, d, block, group)
    else:
        _build.launch("proqa_block_maxima", queries.device, queries.data_ptr(),
                      corpus.data_ptr(), ptr(scale_a), ptr(scale_b), bmax.data_ptr(), ptr(gmax),
                      q, n, d, block, group, int(queries.dtype == torch.bfloat16),
                      int(corpus.dtype == torch.int8))
    return route


def block_maxima_grouped(queries, corpus, *, block: int, group: int = GROUP, scales=None,
                         scale_bounds=None):
    """Fused scoring + two-level maxima: bmax3 [CG, Q, G] (block maxima, the G
    blocks of a group contiguous per query) and gmax [CG, 1, Q] (group
    maxima), both f32. N must be a multiple of block; CG = ceil(N / (group *
    block)), and the rows past N in the last group score 0.

    The corpus is the queries' dtype, or int8 codes (scored exactly in the
    queries' dtype). scales [N / block] f32: each block maximum times its
    block's scale (K5). scale_bounds (smax, smin), each [N / block]: the
    bound m * smax if m >= 0 else m * smin of a per-row-scaled corpus (K7).
    Without either, K1."""
    global launches, f32_launches, scaled_launches, bounded_launches
    cg = _check_shapes(queries, corpus, block, group, scales, scale_bounds)
    if queries.device.type == "cpu":
        return block_maxima_grouped_reference(queries, corpus, block=block, group=group,
                                              scales=scales, scale_bounds=scale_bounds)
    q = queries.shape[0]
    scales, scale_bounds = _grid_scales(scales, scale_bounds, cg * group)
    bmax3 = torch.empty(cg, q, group, dtype=torch.float32, device=queries.device)
    gmax = torch.empty(cg, 1, q, dtype=torch.float32, device=queries.device)
    route = _launch(queries, corpus, bmax3, gmax, block=block, group=group, scales=scales,
                    scale_bounds=scale_bounds)
    if scales is not None:
        scaled_launches += 1
    elif scale_bounds is not None:
        bounded_launches += 1
    elif route == "f32":
        f32_launches += 1
    else:
        launches += 1
    return bmax3, gmax


def _check_v1(queries, corpus, block: int, tile_n: int) -> None:
    if queries.dim() != 2 or corpus.dim() != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} and corpus {tuple(corpus.shape)} "
                         "must be [Q, D] and [N, D]")
    if tile_n % block or corpus.shape[0] % tile_n:
        raise ValueError(f"N={corpus.shape[0]} must be a multiple of tile_n={tile_n}, "
                         f"and tile_n of block={block}")


def block_maxima_reference(queries, corpus, *, block: int = 256, tile_n: int = 2048):
    """Plain PyTorch version of K8."""
    _check_v1(queries, corpus, block, tile_n)
    return _raw_block_maxima(queries, corpus, block)


def block_maxima(queries, corpus, *, block: int = 256, tile_n: int = 2048):
    """K8: per-(corpus block, query) score maxima [N / block, Q] f32, with
    no group level. N must be a multiple of tile_n, the corpus rows one CUDA
    block reduces, and tile_n of block."""
    global block_major_launches
    _check_v1(queries, corpus, block, tile_n)
    if queries.device.type == "cpu":
        return block_maxima_reference(queries, corpus, block=block, tile_n=tile_n)
    bmax = torch.empty(corpus.shape[0] // block, queries.shape[0], dtype=torch.float32,
                       device=queries.device)
    _launch(queries, corpus, bmax, None, block=block, group=tile_n // block)
    block_major_launches += 1
    return bmax


def _straddler_maxima(queries, corpus, block: int, n_valid: int, scales=None,
                      row_scales=None):
    """(sb, [Q] maxima) of the block straddling n_valid, over its valid rows
    alone: its zero-score padding rows would otherwise inflate its max."""
    nb = corpus.shape[0] // block
    sb = min(n_valid // block, nb - 1)
    s = dot_f32(queries, corpus[sb * block:(sb + 1) * block].to(queries.dtype).T)  # [Q, block]
    if scales is not None:
        s = s * scales[sb]
    elif row_scales is not None:
        s = s * row_scales[sb * block:(sb + 1) * block]
    row_valid = sb * block + torch.arange(block, device=s.device) < n_valid
    return sb, torch.where(row_valid, s, NEG_INF).amax(dim=1)


def select_blocks(queries, corpus, k: int, *, block: int, group: int = GROUP,
                  kb: int | None = None, n_valid: int | None = None, scales=None,
                  row_scales=None):
    """Stages 1 and 2 of mips_topk_v2: each query's candidate block ids
    [Q, min(kb, NB)] int64, NB the blocks of the whole groups (those past the
    corpus's N rows, a multiple of block, hold zero rows and never a result:
    rescore_block_candidates masks them); kb defaults to k.

    Padding is masked in place in the tail groups alone, from the group of
    the first block at or past n_valid: their blocks wholly past n_valid
    are set to NEG_INF, the straddling block is scored over its valid rows,
    and their group maxima are taken again. The groups before the tail keep
    the kernel's group maxima, which are exact (tail_mask_groups counts the
    groups masked)."""
    global tail_mask_groups
    q = queries.shape[0]
    n = corpus.shape[0]
    if n_valid is None:
        n_valid = n
    cg = -(-n // (group * block))
    nb = cg * group
    if kb is None:
        kb = k
    kb_g, kb_b = min(kb, cg), min(kb, nb)   # groups, blocks to visit
    if kb_g < min(k, cg) or kb_b < min(k, nb):
        raise ValueError("kb < k breaks the exactness guarantee")

    with span("proqa.search.block_maxima"):
        scale_bounds = None
        if row_scales is not None:
            rs = row_scales.view(n // block, block)
            scale_bounds = (rs.amax(dim=1), rs.amin(dim=1))
        bmax3, gmax = block_maxima_grouped(queries, corpus, block=block, group=group,
                                           scales=scales, scale_bounds=scale_bounds)

    with span("proqa.search.select"):
        if n_valid < nb * block:
            # bmax3 and gmax are this call's own, so they are written in place
            g0 = n_valid // block // group
            tail = bmax3[g0:]
            block_ids = torch.arange((cg - g0) * group, device=bmax3.device).view(-1, 1, group)
            tail.masked_fill_(block_ids * block >= n_valid - g0 * group * block, NEG_INF)
            if n_valid % block:
                sb, patched = _straddler_maxima(queries, corpus, block, n_valid, scales,
                                                row_scales)
                bmax3[sb // group, :, sb % group] = patched
            gmax[g0:, 0, :] = tail.amax(dim=-1)
            tail_mask_groups += cg - g0

        top_groups = exact_topk(gmax.view(cg, q).T, kb_g).indices            # [Q, kb_g]
        cand = bmax3[top_groups, torch.arange(q, device=bmax3.device)[:, None]]  # [Q, kb_g, G]
        sel = exact_topk(cand.reshape(q, kb_g * group), kb_b).indices
        return torch.gather(top_groups, 1, sel // group) * group + sel % group


def mips_topk_v2(queries, corpus, k: int, *, block: int, group: int = GROUP,
                 kb: int | None = None, n_valid: int | None = None, scales=None,
                 row_scales=None, rescore_impl: str | None = None):
    """Exact MIPS top-k through the three stages above; returns (values
    [Q, k] f32, row indices [Q, k] int64). Rows at or past n_valid are
    padding and never returned with a real score. Stage 2 keeps kb (default
    k) groups and blocks; k is the least that keeps the search exact.

    An int8 corpus stays int8 up to the kernel. scales: per-block f32
    [ceil(N / block)] (quantization block == block, ops/quant.py); results
    are exact with respect to the scaled quantized scores (K5). row_scales:
    per-row f32 [N]; stages 1-2 select blocks by a per-block upper bound (K7)
    and stage 3 rescores with the exact row scales. Selection by a bound is a
    heuristic, as in the JAX package: widen kb (16 * k) to recover recall.
    rescore_impl: "take", "stream" (kernel K6, no int8 scales) or None, the
    choice of ops/mips.py:rescore_impl_for ("stream" on CUDA over bf16 or
    f32)."""
    d = queries.shape[1]
    if n_valid is None:
        n_valid = corpus.shape[0]
    if scales is not None and row_scales is not None:
        raise ValueError("pass scales or row_scales, not both")
    if corpus.dtype != torch.int8:
        corpus = corpus.to(queries.dtype)
    # whole blocks only: the kernels search a partial last group in place
    corpus = pad_rows(corpus, block)   # keeps the corpus's dtype
    n = corpus.shape[0]
    nb = n // block
    if scales is not None:
        scales = pad_ones(scales, nb)
    if row_scales is not None:
        row_scales = pad_ones(row_scales, n)
    top_blocks = select_blocks(queries, corpus, k, block=block, group=group, kb=kb,
                               n_valid=n_valid, scales=scales, row_scales=row_scales)
    with span("proqa.search.rescore"):
        return rescore_block_candidates(queries, top_blocks, corpus.view(nb, block, d), k=k,
                                        block=block, n_valid=n_valid, impl=rescore_impl,
                                        block_scales=scales, row_scales=row_scales)


def mips_topk_v1(queries, corpus, k: int, *, block: int = 256, kb: int = 128,
                 q_chunk: int = 256, tile_n: int = 2048, n_valid: int | None = None):
    """Exact MIPS top-k through K8's block maxima and a rescore of each
    query's top-kb blocks, q_chunk queries at a time (mips_topk_pallas, the
    JAX package's first pipeline), the rescore chosen by
    ops/mips.py:rescore_impl_for. Returns (values [Q, k] f32, row indices
    [Q, k] int64)."""
    q, d = queries.shape
    if n_valid is None:
        n_valid = corpus.shape[0]
    corpus = pad_rows(corpus.to(queries.dtype), tile_n)
    nb = corpus.shape[0] // block
    kb = min(kb, nb)
    if kb < min(k, nb):
        raise ValueError("kb < k breaks the exactness guarantee")

    bmax = block_maxima(queries, corpus, block=block, tile_n=tile_n)       # [NB, Q]
    # blocks wholly past n_valid can never hold a result
    past = torch.arange(nb, device=bmax.device) * block >= n_valid
    bmax = bmax.masked_fill(past[:, None], NEG_INF)
    if n_valid % block:
        sb, patched = _straddler_maxima(queries, corpus, block, n_valid)
        bmax[sb] = patched
    top_blocks = exact_topk(bmax.T, kb).indices                            # [Q, kb]

    corpus_blocks = corpus.view(nb, block, d)
    parts = [rescore_block_candidates(queries[s:s + q_chunk], top_blocks[s:s + q_chunk],
                                      corpus_blocks, k=k, block=block, n_valid=n_valid)
             for s in range(0, q, q_chunk)]
    return torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])
