"""Exact maximum-inner-product search (MIPS) top-k.

Counterpart of proqa_tpu/ops/mips.py. The corpus is a [N, D] bf16 (or f32)
matrix on the device, or int8 codes with f32 scales (ops/quant.py), the
scores then being scale * (query . codes). Exact top-k with k <= 512 over a
corpus too large for a full [Q, N] top-k runs the three-stage block-max
pipeline of ops/mips_kernel.py, whose first stage is kernel K1 (K5 over int8
codes) on a CUDA corpus, and whose rescore is kernel K6 over a CUDA bf16 or
f32 corpus (rescore_impl_for).

Exactness of the block-max selection (unchanged from the JAX package): if row
r is among the true top-k, its block's max >= score(r) >= v_k; any block
ranked above r's block holds an element >= score(r), so with kb >= k blocks
visited r's block is always visited. Ties can swap equal-valued results, never
lose recall.

All search functions return (values [Q, k] f32, indices [Q, k] int64) sorted
descending. The int32 row ids of the JAX package appear at DenseIndex.search.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from proqa_tpu_torch.ops.dot import dot_f32
from proqa_tpu_torch.ops.quant import expand_scales
from proqa_tpu_torch.ops.rescore import gather_rescore, kernel_takes

NEG_INF = float(np.float32(-3.0e38))  # finite in bf16 too; the f32 value exactly
# the `take` rescore gathers [Q, kb, block, D] candidate rows: at most this
# many bytes at once (Q = 2,048, kb = 80, block 64, D = 768 would be 16 GB
# of bf16), the queries taken in as many chunks as that needs
TAKE_BYTES = 1 << 30


def _scores(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    return dot_f32(queries, corpus.to(queries.dtype).T)


def pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """[N, D] -> [N rounded up to `multiple`, D], the new rows zero."""
    n_pad = (-x.shape[0]) % multiple
    if n_pad:
        x = torch.cat([x, x.new_zeros(n_pad, x.shape[1])])
    return x


def pad_ones(x: torch.Tensor, n: int) -> torch.Tensor:
    """A [M] f32 scale vector padded with 1.0 to [n] (padding rows and
    blocks are zero codes, so any scale leaves their scores 0)."""
    x = x.float()
    if x.shape[0] < n:
        x = torch.cat([x, x.new_ones(n - x.shape[0])])
    return x


def _mask_padding(scores: torch.Tensor, n_valid: int | None) -> torch.Tensor:
    n = scores.shape[-1]
    if n_valid is None or n_valid >= n:
        return scores
    valid = torch.arange(n, device=scores.device) < n_valid
    return torch.where(valid[None, :], scores, NEG_INF)


def exact_topk(scores: torch.Tensor, k: int):
    """Exact top-k along the last axis. The JAX package's group hierarchy
    exists to keep XLA's TPU top-k narrow; torch.topk needs no such help."""
    return torch.topk(scores, k, dim=-1)


def rescore_impl_for(device, queries_dtype, corpus_dtype, dim: int, scaled: bool) -> str:
    """The rescore a search takes by default, from its arguments alone,
    before any launch: "stream" (kernel K6, ops/rescore.py) for CUDA tensors
    whose queries and corpus share a dtype of bf16 or f32, with no int8
    scales, at every width the kernel takes (ops/rescore.py:kernel_takes);
    "take" everywhere else (the CPU, int8 corpora, other widths). The JAX
    package defaults to "take" everywhere, since its stream kernel lost on a
    v5e (proqa_tpu/ops/pallas_rescore.py:3-11); on the H100
    K6 is the faster of the two (PERF.md section 6)."""
    if (torch.device(device).type == "cuda" and not scaled and corpus_dtype == queries_dtype
            and queries_dtype in (torch.bfloat16, torch.float32)
            and kernel_takes(dim, queries_dtype)):
        return "stream"
    return "take"


def rescore_block_candidates(q_emb, blocks_ids, corpus_blocks, *, k: int, block: int,
                             n_valid: int, impl: str | None = None, block_scales=None,
                             row_scales=None):
    """Exact top-k among each query's candidate blocks: the rescore stage
    shared by every block-max path.

    q_emb [QC, D]; blocks_ids [QC, kb] candidate block ids; corpus_blocks
    [NB, block, D]. Returns (values [QC, k] f32, row indices [QC, k] int64).

    impl: "take" gathers the candidate rows ([QC, kb, block, D], at most
    TAKE_BYTES of them at once) and scores them with batched products;
    "stream" scores them where they lie,
    kernel K6 (ops/rescore.py), and takes no int8 scales; None picks by
    rescore_impl_for.
    block_scales: per-block f32 [NB] of an int8 corpus; row_scales: per-row
    f32 [NB * block] (the row-scored paths). Candidate scores are multiplied
    by them before the selection. A candidate id past corpus_blocks (a block
    of zero rows past the corpus, mips_kernel.select_blocks) reads the last
    block and is masked as padding."""
    qc, kb = blocks_ids.shape
    d = q_emb.shape[1]
    flat_ids = blocks_ids
    blocks_ids = blocks_ids.clamp(max=corpus_blocks.shape[0] - 1)
    if block_scales is not None and row_scales is not None:
        raise ValueError("pass block_scales or row_scales, not both")
    if impl is None:
        impl = rescore_impl_for(q_emb.device, q_emb.dtype, corpus_blocks.dtype, d,
                                block_scales is not None or row_scales is not None)
    if impl == "stream":
        if block_scales is not None or row_scales is not None:
            raise ValueError("stream rescore does not support int8")
        s = gather_rescore(q_emb.contiguous(), corpus_blocks, blocks_ids, block=block)
    elif impl == "take":
        row_bytes = kb * block * d * max(corpus_blocks.element_size(), q_emb.element_size())
        step = max(1, TAKE_BYTES // row_bytes)

        def take(lo):
            cand = corpus_blocks[blocks_ids[lo:lo + step]].to(q_emb.dtype).view(-1, kb * block, d)
            return dot_f32(cand, q_emb[lo:lo + step, :, None]).view(-1, kb * block)

        s = take(0) if step >= qc else torch.cat([take(lo) for lo in range(0, qc, step)])
    else:
        raise ValueError(f"unknown rescore impl {impl!r}")
    if block_scales is not None:
        s = (s.view(qc, kb, block) * block_scales[blocks_ids][:, :, None]).view(qc, kb * block)
    elif row_scales is not None:
        s = s * row_scales.view(-1, block)[blocks_ids].view(qc, kb * block)
    offs = torch.arange(block, device=blocks_ids.device)
    flat_idx = (flat_ids[:, :, None] * block + offs).view(qc, kb * block)
    s = torch.where(flat_idx < n_valid, s, NEG_INF)
    vals, sel = exact_topk(s, k)
    return vals, torch.gather(flat_idx, 1, sel)


def sanitize_padding(vals: torch.Tensor, idx: torch.Tensor):
    """Degenerate-tail contract: slots whose score is the padding sentinel
    (masked padded rows, k > real rows) come back as (NEG_INF, row 0), never
    a padded row's index."""
    invalid = vals <= NEG_INF
    return vals.masked_fill(invalid, NEG_INF), idx.masked_fill(invalid, 0)


def mips_topk_reference(queries, corpus, k: int, *, n_valid: int | None = None,
                        scales=None):
    """Naive full-score top-k: ground truth for tests, and the search for
    small N. scales: per-row f32 [N] of an int8 corpus."""
    scores = _scores(queries, corpus)
    if scales is not None:
        scores = scores * scales[None, :]
    if n_valid is None:
        return exact_topk(scores, k)
    vals, idx = exact_topk(_mask_padding(scores, n_valid), k)
    return sanitize_padding(vals, idx)


def mips_topk_blockmax(queries, corpus, k: int, *, block: int = 256, kb: int | None = None,
                       q_chunk: int = 256, n_valid: int | None = None, scales=None):
    """Exact two-phase block-max top-k without the kernel: block maxima of
    the full [Q, N] score matrix, then a rescore of each query's top-kb
    blocks. The JAX package's path off the TPU; here reached by direct call,
    and by mips_topk for an int8 corpus whose quantization block the kernel
    cannot reduce at. scales: per-row f32 [N] of an int8 corpus."""
    q, d = queries.shape
    n_unpadded = corpus.shape[0]
    corpus = pad_rows(corpus, block)
    if n_valid is None:
        n_valid = n_unpadded
    nb = corpus.shape[0] // block
    if scales is not None:
        scales = pad_ones(scales, corpus.shape[0])
    if kb is None:
        kb = max(k, min(128, nb))
    kb = min(kb, nb)
    if kb < min(k, nb):
        raise ValueError("kb < k breaks the exactness guarantee")
    corpus_blocks = corpus.view(nb, block, d)
    out_v, out_i = [], []
    for s in range(0, q, q_chunk):
        qe = queries[s:s + q_chunk]
        scores = _scores(qe, corpus)
        if scales is not None:
            scores = scores * scales[None, :]
        bmax = _mask_padding(scores, n_valid).view(qe.shape[0], nb, block).amax(dim=-1)
        top_blocks = exact_topk(bmax, kb).indices
        v, i = rescore_block_candidates(qe, top_blocks, corpus_blocks, k=k, block=block,
                                        n_valid=n_valid, row_scales=scales)
        out_v.append(v)
        out_i.append(i)
    return torch.cat(out_v), torch.cat(out_i)


def mips_topk_chunked_approx(queries, corpus, k: int, *, chunk: int = 1 << 19,
                             n_valid: int | None = None, scales=None):
    """Streaming top-k for large k (the QA trainer's top-5000 candidates).
    The JAX package takes `lax.approx_max_k` of each chunk; torch has no
    counterpart, so each chunk keeps its exact top-k, a superset of the
    approximate one, and one final top-k merges the chunks. scales: per-row
    f32 [N] of an int8 corpus."""
    n = corpus.shape[0]
    if n_valid is None:
        n_valid = n
    if scales is not None:
        scales = pad_ones(scales, n)
    cand_v, cand_i = [], []
    for off in range(0, n, chunk):
        s = _scores(queries, corpus[off:off + chunk])
        if scales is not None:
            s = s * scales[None, off:off + chunk]
        rows = off + torch.arange(s.shape[1], device=s.device)
        s = torch.where(rows[None, :] < n_valid, s, NEG_INF)
        v, i = exact_topk(s, min(k, s.shape[1]))
        cand_v.append(v)
        cand_i.append(i + off)
    cv, ci = torch.cat(cand_v, dim=1), torch.cat(cand_i, dim=1)
    if cv.shape[1] < k:  # degenerate small-corpus call: keep k output columns
        pad = k - cv.shape[1]
        cv = torch.nn.functional.pad(cv, (0, pad), value=NEG_INF)
        ci = torch.nn.functional.pad(ci, (0, pad))
    vals, sel = exact_topk(cv, k)
    return vals, torch.gather(ci, 1, sel)


def envelope_block(n: int, qp: int = 2048) -> int:
    """Stage-1 reduce-block size at corpus size n: block=16 halves the
    rescore gather, but bmax3 is N/block * Qpad * 4 bytes, so grow block until
    it fits ~4.5 GB. Kept unchanged from the JAX package: DenseIndex pins an
    int8 index's quantization block with it, so both packages quantize alike."""
    block = 16
    while block < 256 and (n / block) * qp * 4 > 4.5e9:
        block *= 2
    return block


def mips_topk(queries, corpus, k: int, *, exact: bool = True, n_valid: int | None = None,
              scales=None, quant_block: int = 1):
    """Dispatch to the search strategy for (k, N), as the JAX package does:
    the naive path while a full [Q, N] top-k is cheap, the block-max pipeline
    (kernel K1 on a CUDA corpus) for exact k <= 512, and the streaming path
    for larger k. n_valid masks pre-padded corpus rows.

    scales: f32 [ceil(N / quant_block)] of an int8 corpus (ops/quant.py);
    results are exact with respect to the scaled quantized scores. The
    pipeline's kernel (K5) reduces at the quantization block, so it runs
    when quant_block is at least the block the corpus size asks for
    (envelope_block), at most 256 and a multiple of 16: DenseIndex pins it
    so. Any other granularity takes the row-scored block-max path. The
    choice is made from the shapes, before any launch."""
    n = corpus.shape[0]
    # envelope_block grows with the padded query count: above 2,048 queries
    # it could outgrow the index's quant_block and push an int8 search onto
    # the row-scored path (N f32 row scales); chunks of 2,048 keep the kernel
    if (exact and k <= 512 and scales is not None and queries.shape[0] > 2048
            and n > 4096 and n > 4 * k):
        parts = [mips_topk(queries[s:s + 2048], corpus, k, exact=True, n_valid=n_valid,
                           scales=scales, quant_block=quant_block)
                 for s in range(0, queries.shape[0], 2048)]
        return torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])

    def row_scales():
        # only the row-scored paths expand the scales (N f32 values)
        return None if scales is None else pad_ones(expand_scales(scales, quant_block, n), n)

    if exact and k > 512 and n > 4096 and n > 4 * k:
        warnings.warn(
            f"mips_topk(exact=True, k={k}): exact search supports k<=512; "
            "falling back to the streaming path. Pass exact=False to silence.",
            stacklevel=2,
        )
    if n <= 4096 or n <= 4 * k:
        return mips_topk_reference(queries, corpus, min(k, n), n_valid=n_valid,
                                   scales=row_scales())
    if exact and k <= 512:
        from proqa_tpu_torch.ops.mips_kernel import mips_topk_v2

        # the block size follows the JAX package's padded query count, so the
        # two packages reduce over the same blocks
        q = queries.shape[0]
        tile_q = min(2048, max(256, 1 << (q - 1).bit_length()))
        qp = -(-q // tile_q) * tile_q
        block = envelope_block(n, qp)
        if scales is None:
            vals, idx = mips_topk_v2(queries, corpus, k, block=block, n_valid=n_valid)
        elif block <= quant_block <= 256 and quant_block % 16 == 0:
            vals, idx = mips_topk_v2(queries, corpus, k, block=quant_block, n_valid=n_valid,
                                     scales=scales)
        else:
            vals, idx = mips_topk_blockmax(queries, corpus, k, n_valid=n_valid,
                                           scales=row_scales())
    else:
        vals, idx = mips_topk_chunked_approx(queries, corpus, k, n_valid=n_valid,
                                             scales=row_scales())
    if n_valid is not None:
        vals, idx = sanitize_padding(vals, idx)
    return vals, idx


def pad_queries(queries: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """Pad the query batch with zero rows to a multiple; returns (padded,
    original count)."""
    return pad_rows(queries, multiple), queries.shape[0]
