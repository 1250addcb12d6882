#!/usr/bin/env python3
"""Smoke test of the PyTorch port (proqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases, each of which must pass. The dense-retrieval slice:
  1. build the hand-written CUDA kernels from proqa_tpu_torch/csrc;
  2. the BERT-base context tower (B = 64, T = 512) with fused attention
     (K2) against the vanilla attention path, and with the fused epilogues
     (F1, F2: inference mode) bit-equal to the training route (grad on, the
     same kernels saving what their backward reads) and against the plain
     epilogue chain under autograd (fused_bert._eager_chain); the encode's
     throughput with every kernel;
  3. K1, block maxima: the kernel against its plain version at the
     reference's operating point, a 4,194,304 x 128 bf16 corpus and 2,048
     queries, and at 32 queries (a small batch), then DenseIndex top-80
     search against an exact reference, K6's counter (its rescore) reset
     before the search and read after;
  4. the main path through the CLI (build-db, build-index, encode-queries,
     eval-retrieval, retrieve) on a synthetic world of 8,192 paragraphs with
     random BERT-base retriever weights, with the kernels' launch counters
     (K1, K2, K6, F1, F2) reset before and read after, the eval's top-80 checked, and
     K1 held against its plain version at the shapes this search gave it;
  5. K2 against its plain version, checked and timed at the shapes
     build-index gave it (B=512, H=12, Dh=64, T in 128..512, bf16, random key
     padding with one all-padding row).
The retriever-pretraining slice:
  6. K4, fused dropout, bit-equal to its plain version at [80, 512, 768]
     bf16 and [80, 12, 32, 32] f32, rate 0.1, with the keep rate within 5
     sigma of 0.9 and a backward that applies the forward's mask; timed by
     one call and queued beside F.dropout;
  7. K2 at dropout rate 0.1 (the same bits as its plain version) and K3, the
     attention backward, at rates 0 and 0.1, against their plain versions
     (for K3 also against autograd through K2's plain version, and two
     launches on the same inputs bit-equal) at the train step's shapes
     (B=80, H=12, Dh=64, T in 128..512, bf16, one all-padding row), both
     timed at rates 0.1 and 0 beside F.scaled_dot_product_attention;
  8. a full-width train step (BERT-base retriever, bf16, remat, fused
     attention, dropout 0.1, 80 x (32 + 512) tokens, AdamW lr 1e-4): 20 steps
     on one batch whose loss must fall, K2/K3/K4 and F1/F2 (forward and
     backward) launch counters read, and one dropout-0 step with the kernels
     against the vanilla attention path and against the plain epilogue chain
     (gradient cosine);
  9. the slice's main path through the CLI: pretrain-retriever (BERT-base,
     contexts of T=256, so K2/K3 run; queries of T=30 on the vanilla path
     with K4 on their probabilities), then build-index from its
     checkpoint_last.pt and retrieve over it (K1, K6), with every counter
     reset before and read after, and the index checked against the plain
     encoder.
The int8 index and the rest of the search kernels:
 10. K5, scaled block maxima over int8 codes (the Hopper kernel of
     csrc/block_maxima_wgmma.cu, which widens the codes to bf16 in shared
     memory), against its plain version at 4,194,304 x 128 (block 16,
     Q = 2,048, and Q = 32, retrieve's batch, whose bound is the bytes;
     codes made on the device), then a DenseIndex(dtype="int8") quantized on
     the host from an f32 corpus: top-80 search qps, and 256 queries against
     the exact top-80 of the dequantized corpus;
 11. K5 at the capacity point, 67,108,864 x 128 int8 (block 128), made on
     the device: the kernel against its plain version in chunks, mips_topk's
     qps and peak memory, and 64 queries against a chunked exact reference;
 12. K7, per-row scale bounds, at 4.2M: equal to the formula, dominating the
     true row-scaled block maxima, and mips_topk_v2(row_scales=, kb=16k)
     returning exact row-scaled scores;
 13. K8, block-major maxima (the Hopper kernel of csrc/block_maxima_wgmma.cu
     with its block-major store), against its plain version at 4.2M bf16,
     and mips_topk_v1's top-80 against the K1 pipeline's;
 14. K6/K9, gathered candidate scoring (csrc/gather_rescore.cu), on the
     candidate blocks the K1 pipeline selects at 4.2M (Q = 2,048, k = kb =
     80, block 16) and on those mips_topk_v1 rescores (its first chunk of
     256 queries, kb = 128, block 256), over the bf16 corpus and over the
     same corpus in f32, each against the plain gather and product, timed
     beside the `take` path and its bound (each distinct candidate block read
     once), and the streamed rescore's top-80 against the take rescore's;
 15. the int8 CLI path: eval-retrieval and retrieve with --int8-index on the
     retrieval world of phase 4 (8,192 rows, quant block 16, so K5 runs),
     with every counter reset before and read after, and a direct int8
     DenseIndex.search against the exact reference of its own codes.
The f32 (parity) path:
 16. K1 over f32 (csrc/block_maxima_f32.cu, full-f32 FMA products) against
     its plain version at 4,194,304 x 128 f32, Q = 2,048 and 32, block 16,
     its bound at the f32 FMA rate; then a DenseIndex(dtype=float32): top-80
     search qps, and 256 queries against the exact f32 top-80, K6's counter
     read around the search;
 17. the f32 CLI path: eval-retrieval and retrieve with --f32 on the
     retrieval world of phase 4, the counters of the f32 kernel and of K6
     reset before and read after, and the recall JSON checked.
The QA answering path:
 18. on the retrieval world of phase 4 with a BERT-base reader of random
     seeded weights (one QA .npz): eval-qa (T = 512, eval_k 5, 8 questions
     a group, 256 questions, --save-pred), answer and answer --int8-index,
     with the counters of K1, K2, K5, K6, F1 and F2 reset before each run and
     read after (K1, K2, K6, F1, F2 by eval-qa and answer, K5 by the int8
     answer); the EM JSON, the
     256 prediction rows and the answer rows' keys checked; the sampler's
     retrieved rows over the bf16 and the int8 index against the exact
     search of each up to ties (answer's one question padded to 8, then the
     32 groups); K1 and K5 (Q = 8 over the 8,192 rows) and K2 (B = 40,
     T = 512) at this path's shapes against their plain versions; four
     reader batches with K2 against the vanilla path (span logits within
     READER_REL of the batch's largest, beside an e4m3 control; equal
     decoded spans wherever the best span leads by more than
     SPAN_MARGIN_ERRS times the batch's error); questions/s and reader
     tokens/s logged.
QA finetuning, k-means and cluster-batched pretraining:
 19. the QA train step at full width on the retrieval world of phase 4: a
     BERT-base reader and retriever in bf16 (remat, fused attention,
     dropout 0.1, qa_drop 0.1), 4 questions x 5 paragraphs at T = 512,
     queries at T = 30, 5,000 candidates a question gathered from the device
     index; 20 steps on one batch (the loss must fall, K2/K3/K4 and F1/F2
     forward and backward counted), step ms and peak memory; a dropout-0
     step with the kernels against the vanilla attention path and against
     the plain epilogue chain (gradient cosine; where it falls below
     GRAD_COS, each route's distance from the vanilla f32 gradient); K2, K3
     and K4 at these shapes against their plain versions, timed beside
     SDPA / F.dropout and the bound;
 20. finetune-qa through the CLI on that world (random BERT-base weights,
     the retriever of phase 9's checkpoint_last.pt, 16 questions, evals
     every 2 steps), the counters of K1, K2, K3, K4 and K6 reset before and
     read after; --resume from checkpoint_last.pt for a second epoch; eval-qa
     from the best-model.pt it wrote must give training's best EM;
 21. k-means at the reference's settings (10,000 centroids, 1,000 points a
     centroid) over 2,097,152 x 128 f32 rows made on the card, KMEANS_NITER
     iterations: seconds per Lloyd iteration beside the f32 FMA bound, and
     8,192 sampled assignments against the CPU's;
 22. on the pretraining world of phase 9: build-index over the pairs'
     paragraphs, cluster-corpus into 3 shards, and pretrain-retriever reading
     the shards (K2, K3, K4 counted).
Multi-device and the remaining commands:
 27. pretrain-retriever on phase 9's world (3 steps) under
     `python -m torch.distributed.run --nproc-per-node 1` (NCCL, one rank)
     and without the launcher, each in a child process that counts its own
     launches (`--cli-worker`): the same losses step by step within 1e-3,
     the backend nccl, K2/K3/K4 launched, the step ms of both;
 28. convert-hf of a numpy-seeded BERT-base reference retriever state dict
     (HF key layout, `module.` prefix) into the port's .pt, then
     encode-queries and build-index --dp-encode through it on phase 4's
     world: rows bit-equal to the same weights through the .npz route, one
     recall JSON, K2 counted;
 29. phase 3's corpus row-sharded over [cuda:0] * 4 (Q = 2,048, k = 80),
     bf16 then int8: one K1 (K5) and K6 launch a shard, ids equal to the
     unsharded index's up to ties (int8 also to the exact top-k of its own
     codes), the degenerate contract with n_valid inside the first shard,
     search ms and peak memory; eval-retrieval --shard-index and an
     in-process evaluation over the four shards with phase 4's recall JSON.
The BERT layer's fused epilogues:
 30. F1, the dense epilogue (csrc/dense_epilogue.cu), bit-equal to its plain
     version at the encode's shapes, [262,144, 768] and [262,144, 3,072]
     with GELU, bf16 and f32 out; F2, residual add + LayerNorm
     (csrc/layer_norm.cu), at [262,144, 768] with and without a residual,
     within one bf16 ulp at magnitudes of at least LN_ULP_FLOOR (the share
     of elements that differ logged; f32 within LN_F32_TOL); each timed
     beside its plain version, its bound and the nearest library call
     (torch.add into a bf16 output; F.layer_norm). Their launches are
     counted on the retrieval CLI (phase 4), the QA CLI (phase 18), serve
     (phase 24), and the training paths: pretrain-retriever (phase 9),
     finetune-qa (20), pretraining on cluster shards (22) and DDP (27);
 31. their backward kernels at the training steps' shapes (the retriever
     step's 40,960 and the QA step's 10,240 rows, bf16): F1's with GELU at
     [N, 3,072] (dz bit-equal to the plain chain's aten::gelu_backward, the
     bias column sum within COLSUM_REL of its terms), without at [N, 768]
     (the column sum alone), F2's with a residual at [N, 768] (dx within
     BWD_ULPS bf16 ulps at magnitudes of at least LN_ULP_FLOOR of the plain
     formula and of autograd through the plain chain; dscale, dbias within
     COLSUM_REL), two launches of each bit-equal; each timed by one call,
     queued and by its kernels alone (kernel_ms) beside its plain version,
     its bound and one library call (aten::gelu_backward, torch.sum(dim=0),
     aten::native_layer_norm_backward). F1's GELU form's bound is the larger
     of its bytes bound and an instruction-issue bound from the SASS of its
     loop (proqa_tpu_torch/sass_count.py). Every run is an entry of the
     kernels line. Their launches are counted on the training paths of
     phases 8, 9, 19, 20, 22 and 27.
MiniLM-L12-H384 (microsoft/MiniLM-L12-H384-uncased's config.json: BERT, 12
heads of 32, hidden 384, intermediate 1,536; random seeded weights):
 32. (a) K2 and K3 at head dims 32 and 128 and at 48 (the wrapper pads it to
     64) against their plain versions, bf16 and f32, T in 128, 512, 1,024,
     rates 0 and 0.1, one all-padding row (ATTN_TOL, BWD_TOL; row by row
     ATTN_ROW_REL, BWD_ROW_REL, beside controls that leave out a key tile
     or a head-dim chunk), K3's two launches bit-equal, and each new form
     timed at the slice's shapes beside its plain version, SDPA and its
     bound; (b) the context tower
     over 512 rows at T = 512 with K2 and F1/F2 against the vanilla path
     (ENCODER_COS), then 2,048 encoded questions searched over those rows
     and a seeded bf16 corpus (262,144 rows) against the exact top-80; (c)
     the QA reader over 8 x 5 x 512 rows with K2 against the vanilla path
     (READER_REL, beside the e4m3 control); (d) the retriever train step at
     80 x (32 + 512), remat, dropout 0.1: the loss falls over 3 steps, and a
     dropout-0 step's gradients against the vanilla path and the plain
     epilogue chain (GRAD_COS, else GRAD_NOISE against f32); then a tower
     of 8 heads of 128 (hidden 1,024, 2 layers): an encode against vanilla
     and a train step. K2/K3 launches are counted in (b)-(d) and on that
     tower; (b)-(d) log wall time and peak memory.
BERT-xlarge (ALBERT, arXiv:1909.11942, Table 1: 24 layers, hidden 2,048, 32
heads of 64, FFN 8,192; random weights drawn on the card):
 33. (a) F2 at widths 1,025-32,768 (its row and stream forms, an odd width;
     bf16 and f32, with and without a residual, one unaligned) and F1 at
     12,289-40,000 columns (its wide form, with and without GELU), forward
     and backward, against their plain versions (F1 bit-equal, F2 within one
     bf16 ulp at >= LN_ULP_FLOOR, dx BWD_ULPS, column sums COLSUM_REL; two
     backward launches bit-equal), and the new forms timed at the slice's
     shapes beside plain, bound and library; (b) the context tower over 256
     rows at T = 512 (K2, F1/F2, no graph) against the plain epilogue chain
     (ENCODER_COS), then 2,048 encoded questions searched over those rows
     and a seeded bf16 corpus against the exact top-80; (c) the reader over
     8 x 5 x 512 rows with K2, at 24 layers finite (its distances from the
     vanilla and f32 routes logged) and cut to 4 layers against the vanilla
     path (READER_REL, beside the e4m3 control); (d) three retriever train
     steps at 80 x (32 + 512), remat, dropout 0.1, the loss falling, and a
     dropout-0 step's gradients at 16 pairs against the plain chain, at 24
     layers finite (cosines logged) and cut to 4 layers at GRAD_COS; (e) a
     2-layer tower at ALBERT-xxlarge's widths (hidden 4,096, FFN 16,384): an
     encode against the plain chain and a train step. The wide forms'
     launches are counted in (b)-(e), the reader's on its K2 route alone;
     each part logs its wall time and peak memory.
Every embedding width (DPR's Wikipedia index, psgs_w100 of Karpukhin et al.
2020: 21,015,324 passages x 768):
 34. (a) at D = 64, 96, 256, 384, 768 and 1,024 over 262,144 rows: K1 (bf16
     and f32), K5 and K7 at Q = 2,048 and 32, K8, K6 and K9 at blocks 16 and
     64, and the simple body (f32 queries over int8, f32 K8) against their
     plain versions (BMAX_TOL), and mips_topk in bf16 and f32 against the
     exact top-80 (TOPK_TOL); the K-loop forms timed at D = 768 beside plain,
     take path (K6) and bound, and the pipelines of K7, K8 and K9 driven
     once at D = 768 with the counters at 0; (b) the 21,015,324 x 768 index
     made on the card as a DenseIndex, searched top-80 at Q = 2,048 through
     K1 and K6 (counters at 0 before, read after), 256 queries against the
     exact top-80, qps and K1's time beside its bound; then int8 codes of the
     same size through K5, and 4,194,304 x 768 f32 through K1's f32 body,
     each corpus freed before the next; (c) a BERT-base retriever with
     768-wide projections (random weights) through build-db, build-index,
     encode-queries and eval-retrieval on 4,608 paragraphs (K1, K2, K6
     counted), the eval's top-80 against the exact search, and one eval-qa
     group over the 768-wide index; each part's seconds logged.
Heads wider than 128 (no public BERT has them; Gemma's decoders and the
EmbeddingGemma encoder attend with heads of 256):
 35. (a) K2 and K3 at head dims 192 (padded to 256), 256 and the loop forms'
     384 and 768 against their plain versions (bf16 and f32, T in 128,
     512, 1,024, rates 0 and 0.1; row by row, beside controls that leave
     out a key tile or a head-dim chunk; K3's two launches bit-equal), each new
     form timed beside its plain version, SDPA and its bound; (b) BERT-base's
     widths with 3 heads of 256 (WIDE_HEADS, random weights drawn on the
     card): the context tower over 512 x 512 and the reader over 8 x 5 x
     512 against the vanilla path, three retriever train steps at 80 x (32
     + 512) and a dropout-0 step's gradients; (c) 2-layer towers at hidden
     768 with 2 heads of 384 and 1 of 768: an encode against the vanilla
     path, a train step and its dropout-0 gradients. K2/K3 launches counted
     in (b) and (c).
E5-Mistral-7B (intfloat/e5-mistral-7b-instruct: Mistral-7B's decoder, 32
layers, hidden 4,096, 32 query heads over 8 kv heads of 128, FFN 14,336;
random weights drawn on the card):
 36. (a) at the E5 cell's batch (512 rows of 28-58 ids, 18,308 real
     tokens): F1's SwiGLU form at [18,308, 2 x 14,336], F2's RMSNorm form
     at [18,308, 4,096] (with and without a residual) and the RoPE copy
     from [18,308, 6,144] into q [512, 8, 232, 128], k and v [512, 8, 58,
     128], against their plain versions (SwiGLU and RoPE bit-equal; F2's
     sum bit-equal, its output within one bf16 ulp at >= LN_ULP_FLOOR),
     each timed beside its plain version, its bound and (F2) torch's
     rms_norm; (b) the retrieve path: the same 512 rows on the host through
     encode_query, then DenseIndex.search top-100 over 262,144 seeded
     4,096-d bf16 rows, with every counter reset before and read after (the
     three kernels, K1, K6, and the tower's tokens), the embeddings
     unit-norm and every query against the exact top-100; the call's time
     and peak memory logged. The kernels line gains "... (E5 tower)"
     entries, their launches those of that one call.
Phases 23-25 run after phase 18, phase 26 after phase 22, 27-29 after 20,
30 and 31 after 2, 32-36 last. Each of phases 12-14 first drives its kernel's public pipeline
once with the counters at 0 and reads them, then compares and times the
kernel. Kernel
times are device times by CUDA events around one call (cuda_ms); phases 6
and 7 also log K4's, K2's, K3's, F.dropout's and SDPA's mean over 10
back-to-back calls ("queued").

Prints the GPU's name and power limit first, a JSON line of per-kernel
results second to last, and {"ok": true, "device": ...} last. Exits non-zero,
printing no result, when there is no GPU or any phase fails. Runs under
PYTHONHASHSEED=0, re-executing itself when that is unset (pin_hash_seed);
qa_dropout0_sweep.py runs phase 19 under other hash seeds.
"""
from __future__ import annotations

import contextlib
import io
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# tolerances, with their reasons
ATTN_TOL = 2e-2    # bf16 outputs of magnitude ~1: one bf16 rounding flip is 2^-8 relative
BMAX_TOL = 1e-4    # f32 sums of 128 bf16 products in another order: ~1e-7 here
TOPK_TOL = 1e-4    # scores within this of the k-th count as ties (ids may swap)
# embeddings with and without K2, and with and without F1/F2 (F2 within one
# bf16 ulp of the plain LayerNorm, its row sums in another order), 12 bf16
# layers apart
ENCODER_COS = 0.999
# F2 in f32 against its plain version: the two row sums run in another order
# than ATen's, so the mean and variance move by a few f32 ulps of the row
LN_F32_TOL = 1e-5
# F2 in bf16 is held to one bf16 ulp at the larger magnitude of the two
# outputs, or of 2^-8 below it: an output that cancels to near zero in
# y * scale + bias moves by the f32 difference of its O(1) terms, which a
# mean one f32 ulp away makes 240 of its own bf16 ulps at 1e-8 (measured on
# the CPU by shifting the mean of 65,536 rows of 768 by one ulp: every
# element past one ulp had |out| <= 1.2e-5); the ulp at 2^-8 (2^-16) is
# ~100x that f32 difference
LN_ULP_FLOOR = 2.0 ** -8
ENCODE_TOKENS = 512 * 512  # build-index's batch: 512 rows at the 512 bucket
# K3 against its plain version: both round pd and ds to bf16 at the same
# points, but the kernel recomputes the scores with the key and query roles
# swapped for dk and dv, and sums in another order; one flipped bf16 rounding
# of ds or pd before a T-long product moves an output by a few bf16 ulps of
# values of magnitude ~1 (tests/test_torch_cuda.py holds the same bound)
BWD_TOL = 6e-2
# K2 and K3 against their plain versions row by row (_row_rel: an output
# row's largest error over its largest plain value), by dtype. In bf16 both
# round at the same points, and a flipped rounding moves an element by one
# ulp, 2^-8 of it and at most 2^-7 of its row's largest: on an H100 the
# largest reading over head dims 16-768 and the timed shapes was 0.0078
# (K2) and 0.0084 (K3), so the limit is 2^-6. In f32 the sums differ in
# order only: K2 read 0 and K3 at most 1.3e-6. The controls beside them,
# the plain version with one key tile or one head-dim chunk left out
# (_attention_controls), read 0.75 and more in both dtypes
ATTN_ROW_REL = {"bfloat16": 2.0 ** -6, "float32": 1e-5}
BWD_ROW_REL = {"bfloat16": 2.0 ** -6, "float32": 1e-5}
# K3 against torch autograd through K2's plain version: autograd rounds do v^T
# to bf16 (the backward of the probabilities' cast) where the TPU kernel's
# formula keeps it in f32, one more rounding before each product; dv and dk
# reach magnitudes of 8-16 at T = 128, where one bf16 ulp is 0.0625, so this
# check counts bf16 ulps at each output's largest magnitude (2^-7 of it)
AUTOGRAD_ULPS = 2.0
GRAD_COS = 0.99   # dropout-0 gradients, K2/K3 against the vanilla path, bf16
# a QA gradient that is a near-cancelling sum (the query tower's last-layer
# q and k feed only the [CLS] row's softmax) carries bf16 noise above
# 1 - GRAD_COS on both routes: the vanilla bf16 route itself reads cosine
# 0.954-0.968 to the f32 gradient there, and the kernels' distance from it
# 0.96-1.04 times vanilla's (nine batches on an H100). Such a tensor is held
# to the f32 gradient: the kernels' error at most GRAD_NOISE times vanilla's
GRAD_NOISE = 1.5
LOSS_DROP = 1.0   # nats the train step's loss must fall over 20 steps on one batch
# the reader's f32 span logits with K2 against the vanilla path, 12 bf16
# layers apart, as a share of the largest in-paragraph logit of the batch:
# both paths round at the same points but sum in other orders, and each
# flipped bf16 rounding drifts through the 12 layers. On an H100 this phase
# read 0.0174 over its four batches, and the lower-precision control beside
# it (one more rounding of the vanilla logits to float8 e4m3) 0.0386
READER_REL = 0.025
# a span's score is a start plus an end logit, each within the batch's
# measured error, so the lead of the best span over the runner-up moves by
# at most 4 times it: past that lead the decoded span cannot change
SPAN_MARGIN_ERRS = 4
READER_BATCHES = 4  # reader batches held against the vanilla path (32 questions)
KMEANS_NITER = 250  # Lloyd iterations of the k-means phase, the reference's

# H100 SXM peaks (NVIDIA's data sheet): dense bf16 tensor-core rate, f32
# rate outside the tensor cores (the FMA pipe), HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take for this work, and what bounds
    it: each input read once and each output written once at the HBM rate,
    or the operations at `peak` FLOP/s (the bf16 tensor-core rate, or the
    f32 FMA rate for work the reference pins to full f32)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int = 5, calls: int = 1) -> float:
    """Median device time of fn() in ms, by CUDA events, after one warm-up.
    With calls > 1 the events enclose that many back-to-back calls and the
    time is their mean, so the host's per-call overhead, which one call
    between two events includes, hides behind the queued work."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def kernel_ms(fn, reps: int = 3, tries: int = 40) -> dict:
    """The device time of the kernels one call of fn launches, after one
    warm-up: the kernels alone, without the host path that one call between
    CUDA events also holds. On the H100 machine torch.profiler loses most
    kernel records (a trace holds the cudaLaunchKernel call but not its
    kernel, in 4-8 of 8 traces whether or not the CPU is traced too or the
    card idles 5 ms before or after the call; one trace around three calls
    kept one kernel), so a trace counts only if it holds as many kernels as
    the fullest trace seen: up to `tries` traces, one a call, until `reps`
    count. Returns {"kernel_ms": the median of those (None if no trace held
    a kernel), "kernel_traces": [traces counted, traces taken]}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    traces = []  # (kernels, ms) a trace
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        traces.append((len(kernels), sum(e.device_time_total for e in kernels) / 1e3))
        most = max(n for n, _ in traces)
        full = [ms for n, ms in traces if n == most and n > 0]
        if len(full) >= reps:
            break
    return {"kernel_ms": statistics.median(full) if full else None,
            "kernel_traces": [len(full), len(traces)]}


K2_BUCKETS = (128, 256, 384, 512)  # encode buckets that reach K2 (T % 128 == 0)


def phase_attention(device, b: int) -> dict:
    """K2 against its plain version on random bf16 [b, 12, T, 64] inputs for
    each bucket T that reaches it, with random key padding and one
    all-padding row; both timed by CUDA events."""
    import torch

    from proqa_tpu_torch.ops import attention

    h, dh = 12, 64
    g = torch.Generator(device=device).manual_seed(2)
    worst, per_t = 0.0, {}
    for t in K2_BUCKETS:
        q, k, v = (torch.randn(b, h, t, dh, device=device, generator=g).bfloat16()
                   for _ in range(3))
        lengths = torch.randint(1, t + 1, (b,), device=device, generator=g)
        lengths[0] = 0
        mask = (torch.arange(t, device=device)[None] < lengths[:, None]).to(torch.int32)
        got = attention.fused_attention(q, k, v, mask, sm_scale=dh ** -0.5)
        want = attention.fused_attention_reference(q, k, v, mask, sm_scale=dh ** -0.5)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), f"K2 B={b} T={t}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        check(err <= ATTN_TOL, f"K2 B={b} T={t}: max abs err {err} > {ATTN_TOL}")
        del got, want
        ms = cuda_ms(lambda: attention.fused_attention(q, k, v, mask, sm_scale=dh ** -0.5))
        plain = cuda_ms(lambda: attention.fused_attention_reference(q, k, v, mask,
                                                                    sm_scale=dh ** -0.5))
        per_t[t] = {"max_abs_err": err, "ms": ms, "plain_ms": plain}
        worst = max(worst, err)
        log(f"K2 B={b} H={h} T={t} Dh={dh} bf16: max_abs_err {err:.3g} (tol {ATTN_TOL}), "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms")
    return {"max_abs_err": worst, "ms": per_t[512]["ms"], "plain_ms": per_t[512]["plain_ms"]}


def phase_encoder(device) -> None:
    """BERT-base context tower at T=512 with K2 against the vanilla path,
    with F1 and F2 (inference mode) against the differentiable route (grad
    on, the same weights and inputs), and the encoder's device throughput
    with every kernel."""
    import dataclasses

    import torch

    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.retriever import Retriever
    from proqa_tpu_torch.ops import fused_bert

    cfg = BertConfig(flash_attention=True)
    model = Retriever(cfg).reset_parameters(5).to(device).eval()
    plain = Retriever(dataclasses.replace(cfg, flash_attention=False)).to(device).eval()
    plain.load_state_dict(model.state_dict())
    g = torch.Generator(device=device).manual_seed(3)
    bsz, t = 64, 512
    ids = torch.randint(5, 68, (bsz, t), device=device, generator=g)
    lengths = torch.randint(100, t + 1, (bsz,), device=device, generator=g)
    mask = (torch.arange(t, device=device)[None] < lengths[:, None]).to(torch.int32)
    ids = ids * mask
    with torch.inference_mode():
        fused = model.encode_context(ids, mask)
        vanilla = plain.encode_context(ids, mask)
        cos = torch.nn.functional.cosine_similarity(fused, vanilla, dim=1).min().item()
        ms = cuda_ms(lambda: model.encode_context(ids, mask), reps=3)
    del plain
    check(bool(torch.isfinite(fused).all()) and fused.shape == (bsz, 128),
          "encoder: bad embeddings")
    check(cos >= ENCODER_COS, f"encoder with K2 vs vanilla: min cosine {cos} < {ENCODER_COS}")
    # grad on and the parameters requiring it: the training route, the same
    # F1/F2 kernels saving what their backward reads, so the same bits
    f1, f2 = fused_bert.launches("F1"), fused_bert.launches("F2")
    routed = model.encode_context(ids, mask)
    check(routed.requires_grad and fused_bert.launches("F1") > f1
          and fused_bert.launches("F2") > f2, "encoder with grad on: F1/F2 not launched")
    check(torch.equal(routed.detach(), fused), "encoder with grad on: not the inference bits")
    del routed
    route_ms = cuda_ms(lambda: model.encode_context(ids, mask), reps=3)
    # the plain chain under autograd, the yardstick of the kernels
    f1, f2 = fused_bert.launches("F1"), fused_bert.launches("F2")
    with fused_bert._eager_chain():
        plain_out = model.encode_context(ids, mask).detach()
        plain_ms = cuda_ms(lambda: model.encode_context(ids, mask), reps=3)
    check((fused_bert.launches("F1"), fused_bert.launches("F2")) == (f1, f2),
          "encoder under _eager_chain: F1/F2 launched")
    route_cos = torch.nn.functional.cosine_similarity(fused, plain_out, dim=1).min().item()
    route_err = (fused - plain_out).abs().max().item()
    del plain_out
    check(route_cos >= ENCODER_COS, f"encoder with F1/F2 vs the plain chain: min "
                                    f"cosine {route_cos} < {ENCODER_COS}")
    log(f"encoder BERT-base bf16 B={bsz} T={t}: K2 vs vanilla min cosine {cos:.6f} "
        f"(tol {ENCODER_COS}); F1/F2 (inference mode) bit-equal to the training route (grad "
        f"on), and against the plain chain under autograd min cosine {route_cos:.6f} (tol "
        f"{ENCODER_COS}), max abs err {route_err:.3g}; with every kernel {ms:.2f} ms per "
        f"batch = {bsz * t / ms * 1e3:.0f} padded tokens/s (grad on, autograd recording "
        f"included: the training route {route_ms:.2f} ms, the plain chain {plain_ms:.2f} ms)")


def _bf16_ulps(got, want, floor: float = 2.0 ** -126) -> float:
    """The largest |got - want| in bf16 ulps at the larger magnitude of the
    two, or of `floor` below it."""
    import torch

    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(floor)
    return ((got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max().item()


def phase_fused_bert(device) -> tuple[dict, dict]:
    """F1 and F2 against their plain versions at the encode's shapes
    (ENCODE_TOKENS rows of BERT-base widths), each timed by one call beside
    its plain version, its bound and the nearest library call. The entry of
    each in the kernels line is its bf16 [N, 768] run (F2 with a residual),
    the most launched shape; the others are logged."""
    import torch

    from proqa_tpu_torch.ops import fused_bert

    n, h, inter = ENCODE_TOKENS, 768, 3072
    g = torch.Generator(device=device).manual_seed(12)
    runs = {}
    for cols, gelu in ((h, False), (inter, True)):
        y = torch.randn(n, cols, device=device, generator=g) * 2.0
        b = torch.randn(cols, device=device, generator=g) * 0.1
        for dt in (torch.bfloat16, torch.float32):
            got = fused_bert.dense_epilogue(y, b, dt, gelu)
            want = fused_bert.dense_epilogue_reference(y, b, dt, gelu)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            label = f"F1 [{n}, {cols}]{' GELU' if gelu else ''} {str(dt)[6:]}"
            check(torch.equal(got, want), f"{label}: max abs err {err}, not bit-equal")
            del got, want
            library = None
            if not gelu:  # one call for round(y + b): the add into an output of dtype dt
                out = torch.empty(n, cols, device=device, dtype=dt)
                library = cuda_ms(lambda: torch.add(y, b, out=out))
                del out
            # an add an element; GELU 4 more operations and erff's ~20
            bound_ms, by = bound(n * cols * (4 + dt.itemsize) + cols * 4,
                                 n * cols * (25 if gelu else 1), PEAK_F32_FLOPS)
            runs[label] = {
                "max_abs_err": err, "bound_ms": bound_ms, "bound_by": by, "library_ms": library,
                "ms": cuda_ms(lambda: fused_bert.dense_epilogue(y, b, dt, gelu)),
                "plain_ms": cuda_ms(lambda: fused_bert.dense_epilogue_reference(y, b, dt, gelu))}
            log(f"{label}: bit-equal to its plain version; {json.dumps(runs[label])}")
        del y, b
    f1 = runs[f"F1 [{n}, {h}] bfloat16"]
    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(n, h, device=device, generator=g).to(dt)
        r = (torch.randn(n, h, device=device, generator=g) * 0.5 + 0.25).to(dt)
        scale = 1.0 + 0.1 * torch.randn(h, device=device, generator=g)
        bias = 0.1 * torch.randn(h, device=device, generator=g)
        for res in (r, None):
            got = fused_bert.add_layer_norm(x, res, scale, bias, 1e-12)
            want = fused_bert.add_layer_norm_reference(x, res, scale, bias, 1e-12)
            torch.cuda.synchronize()
            label = f"F2 [{n}, {h}] {str(dt)[6:]}{' + residual' if res is not None else ''}"
            err = (got.float() - want.float()).abs().max().item()
            differ = (got != want).float().mean().item()
            if dt is torch.bfloat16:
                ulps = _bf16_ulps(got, want, LN_ULP_FLOOR)
                check(ulps <= 1.0, f"{label}: {ulps} bf16 ulps (at magnitudes of at least "
                                   f"{LN_ULP_FLOOR}) from its plain version")
                raw_ulps = _bf16_ulps(got, want)
            else:
                ulps = raw_ulps = None
                check(torch.allclose(got, want, atol=LN_F32_TOL, rtol=LN_F32_TOL),
                      f"{label}: max abs err {err} > {LN_F32_TOL}")
            del got, want
            sc, bi = scale.to(dt), bias.to(dt)
            bound_ms, by = bound((3 if res is not None else 2) * x.numel() * dt.itemsize
                                 + 2 * h * 4, 10 * x.numel(), PEAK_F32_FLOPS)
            runs[label] = {
                "max_abs_err": err, "bf16_ulps": ulps, "bf16_ulps_no_floor": raw_ulps,
                "differ_share": differ,
                "bound_ms": bound_ms, "bound_by": by,
                "ms": cuda_ms(lambda: fused_bert.add_layer_norm(x, res, scale, bias, 1e-12)),
                "plain_ms": cuda_ms(lambda: fused_bert.add_layer_norm_reference(
                    x, res, scale, bias, 1e-12)),
                # the nearest library call: no residual, no rounding point of its own
                "library_ms": cuda_ms(lambda: torch.nn.functional.layer_norm(
                    x, (h,), sc, bi, 1e-12))}
            log(f"{label}: {json.dumps(runs[label])}")
            worst[label] = err
        del x, r
    f2 = dict(runs[f"F2 [{n}, {h}] bfloat16 + residual"])
    f2["max_abs_err"] = max(v for k, v in worst.items() if "bfloat16" in k)
    f1["max_abs_err"] = max(v["max_abs_err"] for k, v in runs.items() if k.startswith("F1"))
    return f1, f2


# the training steps' rows of BERT-base activations: the retriever step's
# context tower (80 x 512) and the QA step's reader (4 x 5 x 512)
TRAIN_ROWS = {"retriever": 80 * 512, "qa": 4 * 5 * 512}
BWD_ULPS = 2.0      # F2's dx against its plain versions, bf16 ulps at >= LN_ULP_FLOOR
COLSUM_REL = 1e-5   # column sums: this share of the sum of the column's |terms|


def _colsum_err(got, want, terms) -> float:
    """The largest |got - want| of column sums as a share of the sum of the
    column's |terms| (terms [rows, cols])."""
    import torch

    scale = terms.double().abs().sum(0).clamp_min(1e-30)
    return ((got.double() - want.double()).abs() / scale).max().item()


def gelu_backward_issue(device) -> dict:
    """The instruction-issue bound of F1's GELU backward: the SASS of its
    main loop (proqa_tpu_torch/sass_count.py: instructions, and the 16-byte
    dz stores, one a row of 8 columns, which give the elements an
    iteration) at one warp instruction a clock on each of an SM's 4
    schedulers, at the card's top SM clock (nvidia-smi clocks.max.sm)."""
    import torch

    from proqa_tpu_torch import _build, sass_count

    loop = sass_count.loop_counts(str(_build.library_path()),
                                  {"gelu": sass_count.KERNELS["F1 backward GELU"]})["gelu"]
    check(loop is not None and loop["global_stores_128"] > 0,
          f"F1 backward GELU: no main loop with 16-byte stores in its SASS: {loop}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_element = loop["instructions"] / (8 * loop["global_stores_128"])
    return {**loop, "instructions_per_element": per_element, "sm_clock_mhz": mhz, "sms": sms,
            # thread instructions a second: 4 warp instructions a clock an SM
            "issue_rate": sms * 4 * 32 * mhz * 1e6}


def phase_fused_bert_backward(device) -> list[tuple[str, str, dict]]:
    """F1's and F2's backward kernels at the training steps' shapes
    (TRAIN_ROWS rows of BERT-base widths, bf16): F1 with GELU at [N, 3,072]
    (dz bit-equal to the plain chain's aten::gelu_backward, the bias column
    sum within COLSUM_REL), F1 without at [N, 768] (the column sum alone), F2
    with a residual at [N, 768] (dx within BWD_ULPS bf16 ulps at magnitudes
    of at least LN_ULP_FLOOR of the plain formula and of autograd through
    the plain chain, the share of differing elements logged; dscale and dbias
    within COLSUM_REL); two launches of each bit-equal. Each timed by one call
    and queued (10 back-to-back calls) beside its plain version, its bound
    and one library call (aten::gelu_backward, torch.sum(dim=0),
    aten::native_layer_norm_backward); F1's GELU form's bound is the larger of
    its bytes bound and its instruction-issue bound (gelu_backward_issue).
    Returns (kernel, shape label, result) for every run, in the kernels
    line's order."""
    import torch

    from proqa_tpu_torch.ops import fused_bert

    h, inter, eps = 768, 3072, 1e-12
    g = torch.Generator(device=device).manual_seed(31)
    issue = gelu_backward_issue(device)
    log(f"F1 backward GELU's main loop (SASS): {json.dumps(issue)}")
    runs = []
    for step, n in TRAIN_ROWS.items():
        for cols, gelu in ((inter, True), (h, False)):
            dout = torch.randn(n, cols, device=device, generator=g).bfloat16()
            z = (torch.randn(n, cols, device=device, generator=g) * 2.0).bfloat16()
            zz = z if gelu else None
            got = fused_bert._dense_epilogue_backward_kernel(dout, zz, gelu, True, True)
            again = fused_bert._dense_epilogue_backward_kernel(dout, zz, gelu, True, True)
            want = fused_bert.dense_epilogue_backward_reference(dout, zz, gelu)
            torch.cuda.synchronize()
            label = f"[{n}, {cols}]{' GELU' if gelu else ''} bf16 ({step} step)"
            check(torch.equal(got[0], want[0]), f"F1 backward {label}: dz not bit-equal to the "
                                                f"plain chain's")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"F1 backward {label}: two launches differ")
            sum_err = _colsum_err(got[1], want[1], want[0].float())
            check(sum_err <= COLSUM_REL, f"F1 backward {label}: bias column sum off by "
                                         f"{sum_err} of its terms (tol {COLSUM_REL})")
            err = (got[0].float() - want[0].float()).abs().max().item()  # dz's
            del got, again, want
            if gelu:
                library = cuda_ms(lambda: torch.ops.aten.gelu_backward(dout, z,
                                                                       approximate="none"))
                # read dout and z, write dz, write the f32 bias gradient; or
                # issue the loop's instructions for every element
                bytes_ms = bound(n * cols * 6 + cols * 4, 0)[0]
                issue_ms = n * cols * issue["instructions_per_element"] / issue["issue_rate"] * 1e3
                bound_ms, by = max((bytes_ms, "bytes"), (issue_ms, "operations"))
                extra = {"bytes_bound_ms": bytes_ms, "issue_bound_ms": issue_ms}
            else:
                library = cuda_ms(lambda: torch.sum(dout, dim=0, dtype=torch.float32))
                bound_ms, by = bound(n * cols * 2 + cols * 4, n * cols, PEAK_F32_FLOPS)
                extra = {}
            run = lambda: fused_bert._dense_epilogue_backward_kernel(  # noqa: E731
                dout, zz, gelu, True, True)
            result = {
                "max_abs_err": err, "colsum_rel_err": sum_err, "bound_ms": bound_ms,
                "bound_by": by, **extra, "library_ms": library, "ms": cuda_ms(run),
                "queued_ms": cuda_ms(run, calls=10), **kernel_ms(run),
                "plain_ms": cuda_ms(lambda: fused_bert.dense_epilogue_backward_reference(
                    dout, zz, gelu))}
            runs.append(("F1", label, result))
            log(f"F1 backward {label}: dz bit-equal, two launches bit-equal; "
                f"{json.dumps(result)}")
            del dout, z, zz
        x = torch.randn(n, h, device=device, generator=g).bfloat16()
        r = (torch.randn(n, h, device=device, generator=g) * 0.5 + 0.25).bfloat16()
        dy = torch.randn(n, h, device=device, generator=g).bfloat16()
        scale = 1.0 + 0.1 * torch.randn(h, device=device, generator=g)
        bias = 0.1 * torch.randn(h, device=device, generator=g)
        _, mean, rstd = fused_bert._add_layer_norm_kernel(x, r, scale, bias, eps, save_stats=True)
        got = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale, True, True)
        again = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale, True,
                                                           True)
        want = fused_bert.add_layer_norm_backward_reference(dy, x, r, mean, rstd, scale)
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, scale, bias)]
        fused_bert.add_layer_norm_reference(leaves[0], r, leaves[1], leaves[2], eps).backward(dy)
        torch.cuda.synchronize()
        label = f"[{n}, {h}] bf16 + residual ({step} step)"
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"F2 backward {label}: two launches differ")
        ulps = {name: _bf16_ulps(got[0], w, LN_ULP_FLOOR)
                for name, w in (("plain", want[0]), ("autograd", leaves[0].grad))}
        differ = {name: (got[0] != w).float().mean().item()
                  for name, w in (("plain", want[0]), ("autograd", leaves[0].grad))}
        check(max(ulps.values()) <= BWD_ULPS,
              f"F2 backward {label}: dx {ulps} bf16 ulps (at magnitudes of at least "
              f"{LN_ULP_FLOOR}) from its plain versions (tol {BWD_ULPS})")
        s32 = (x + r).float()
        xh = (s32 - mean[:, None]) * rstd[:, None]
        sum_err = max(_colsum_err(got[1], want[1], dy.float() * xh),
                      _colsum_err(got[2], want[2], dy.float()))
        check(sum_err <= COLSUM_REL, f"F2 backward {label}: dscale/dbias off by {sum_err} of "
                                     f"their terms (tol {COLSUM_REL})")
        err = (got[0].float() - want[0].float()).abs().max().item()  # dx's
        del got, again, want, leaves, s32, xh
        # the library call: ATen's LayerNorm backward of the rounded sum, with
        # its own mean and rstd (no residual, parameters in bf16)
        s = x + r
        sc, bi = scale.bfloat16(), bias.bfloat16()
        _, a_mean, a_rstd = torch.ops.aten.native_layer_norm(s, [h], sc, bi, eps)
        bound_ms, by = bound(n * h * 2 * 4 + n * 8 + h * 4 + 2 * h * 4, n * h * 12,
                             PEAK_F32_FLOPS)
        run = lambda: fused_bert._add_layer_norm_backward_kernel(  # noqa: E731
            dy, x, r, mean, rstd, scale, True, True)
        result = {
            "max_abs_err": err, "bf16_ulps": ulps, "differ_share": differ,
            "colsum_rel_err": sum_err, "bound_ms": bound_ms, "bound_by": by,
            "ms": cuda_ms(run), "queued_ms": cuda_ms(run, calls=10), **kernel_ms(run),
            "plain_ms": cuda_ms(lambda: fused_bert.add_layer_norm_backward_reference(
                dy, x, r, mean, rstd, scale)),
            "library_ms": cuda_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, s, [h], a_mean, a_rstd, sc, bi, [True, True, True]))}
        runs.append(("F2", label, result))
        log(f"F2 backward {label}: {json.dumps(result)}")
        del x, r, dy, s, mean, rstd, a_mean, a_rstd
        torch.cuda.empty_cache()
    order = {"F1": 0, "F2": 1}
    return sorted(runs, key=lambda run: order[run[0]])


def grouped_against_plain(name, queries, corpus, *, block, chunk_groups=128, reps=3,
                          peak=PEAK_BF16_FLOPS, **scale_kw) -> dict:
    """block_maxima_grouped (K1, K5 or K7 by its keywords) against its plain
    version, which runs chunk_groups groups at a time (the whole [Q, N] f32
    score matrix would not fit); both timed by CUDA events, the plain one as
    the sum of its chunks. Scales are sliced with their chunk. The bound's
    operations run at `peak` FLOP/s."""
    import torch

    from proqa_tpu_torch.ops import mips_kernel

    n, q, rows = corpus.shape[0], queries.shape[0], mips_kernel.GROUP * block
    run = lambda: mips_kernel.block_maxima_grouped(queries, corpus, block=block,  # noqa: E731
                                                   **scale_kw)
    bmax3, gmax = run()
    torch.cuda.synchronize()
    scale_bytes = sum(s.numel() * 4 for v in scale_kw.values()
                      for s in (v if isinstance(v, tuple) else (v,)))
    nbytes = (corpus.numel() * corpus.element_size() + queries.numel() * queries.element_size()
              + scale_bytes + (bmax3.numel() + gmax.numel()) * 4)
    bound_ms, bound_by = bound(nbytes, 2.0 * n * q * corpus.shape[1], peak)
    ms = cuda_ms(run, reps=reps)
    err, plain_ms, chunk = 0.0, 0.0, chunk_groups * rows
    for r0 in range(0, n, chunk):
        sl = slice(r0 // block, (r0 + chunk) // block)
        kw = {key: tuple(x[sl] for x in v) if isinstance(v, tuple) else v[sl]
              for key, v in scale_kw.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rb, rg = mips_kernel.block_maxima_grouped_reference(queries, corpus[r0:r0 + chunk],
                                                            block=block, **kw)
        end.record()
        end.synchronize()
        plain_ms += start.elapsed_time(end)
        g0, g1 = r0 // rows, (r0 + chunk) // rows
        err = max(err, (bmax3[g0:g1] - rb).abs().max().item(),
                  (gmax[g0:g1] - rg).abs().max().item())
        del rb, rg
    check(err <= BMAX_TOL, f"{name}: max abs err {err} > {BMAX_TOL}")
    log(f"{name} N={n} Q={q} block={block} {corpus.dtype}: max_abs_err {err:.3g} (tol "
        f"{BMAX_TOL}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (sum of {-(-n // chunk)} "
        f"chunks), bound {bound_ms:.3f} ms ({bound_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "out": (bmax3, gmax)}


def bf16_corpus(device, n: int = 4_194_304, q: int = 2048, d: int = 128):
    """phase_mips's corpus and queries, from its seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(4)
    corpus = (torch.randn(n, d, device=device, generator=g) / d ** 0.5).bfloat16()
    queries = torch.randn(q, d, device=device, generator=g) / d ** 0.5
    return corpus, queries


def phase_mips(device) -> dict:
    import numpy as np
    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.ops import mips, rescore
    from proqa_tpu_torch.ops.dot import dot_f32
    from proqa_tpu_torch.testing import topk_disagreements

    corpus, queries = bf16_corpus(device)
    (n, d), q, k = corpus.shape, queries.shape[0], 80
    block = mips.envelope_block(n, q)
    qb = queries.bfloat16()
    k1 = grouped_against_plain("K1", qb, corpus, block=block)
    del k1["out"]
    # the small-batch search's shape: one warpgroup a CUDA block, bytes-bound
    k1_small = grouped_against_plain("K1 Q=32", qb[:32].contiguous(), corpus, block=block)
    del k1_small["out"]

    index = DenseIndex.from_embeddings(corpus, device=device, dtype=torch.bfloat16)
    rescore.launches = 0
    vals, idx = index.search(queries, k)
    check(rescore.launches > 0, "search: K6 was not launched by the bf16 DenseIndex.search")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        index.search(queries, k)     # ends in a device-to-host copy: synchronised
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    check(vals.shape == (q, k) and np.isfinite(vals).all(), "search: bad values")
    n_check = 256
    bad = 0
    for s in range(0, n_check, 64):
        ref = torch.topk(dot_f32(qb[s:s + 64], corpus.T), k)
        bad += topk_disagreements(vals[s:s + 64], idx[s:s + 64],
                                  ref.values.cpu().numpy(), ref.indices.cpu().numpy(),
                                  atol=TOPK_TOL)
    check(bad == 0, f"search: {bad} of {n_check} queries disagree with the exact top-{k}")
    log(f"search top-{k} N={n} Q={q} bf16: {q / wall:.1f} qps ({wall * 1e3:.2f} ms per "
        f"batch, host clock); {n_check} queries agree with the exact reference up to ties; "
        f"its rescore launched K6")
    return {**k1, "max_abs_err": max(k1["max_abs_err"], k1_small["max_abs_err"]), "qps": q / wall}


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(60)] + [
    "what", "is", "about",
]


def write_world(root: str, n_paras: int, n_questions: int, seed: int) -> int:
    """The verify skill's vocabulary; paragraphs of 100..510 words, so their
    token counts spread over the 128..512 buckets. Returns the corpus's token
    count (one token per word, plus [CLS] and [SEP])."""
    import numpy as np

    rng = np.random.default_rng(seed)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    tokens = 0
    with open(os.path.join(root, "corpus.jsonl"), "w") as f:
        for i in range(n_paras):
            words = rng.integers(0, 60, size=int(rng.integers(100, 511)))
            tokens += len(words) + 2
            f.write(json.dumps({"text": " ".join(f"tok{w}" for w in words), "id": f"p{i}"}) + "\n")
    with open(os.path.join(root, "qa.jsonl"), "w") as f:
        for i in range(n_questions):
            a, b = rng.integers(0, 60, size=2)
            f.write(json.dumps({"question": f"what is about tok{a} tok{b}",
                                "answer": [f"tok{b} tok{a}"]}) + "\n")
    return tokens


def run_cli(argv: list[str]) -> tuple[dict, float]:
    """One proqa-torch command in this process; returns (its final JSON
    line, wall seconds)."""
    from proqa_tpu_torch.cli.main import main as cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue().strip().splitlines()
    check(bool(out), f"{argv[0]}: printed nothing")
    log(f"$ proqa-torch {argv[0]}: {out[-1]}  ({wall:.2f} s)")
    return json.loads(out[-1]), wall


def phase_cli(device, root: str) -> dict:
    import numpy as np
    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.convert import params_to_jax, save_npz
    from proqa_tpu_torch.models.retriever import Retriever
    from proqa_tpu_torch.ops import attention, fused_bert, mips, mips_kernel, rescore
    from proqa_tpu_torch.testing import topk_disagreements

    n_paras, n_q, k, batch = 8192, 256, 80, 512
    tokens = write_world(root, n_paras, n_q, seed=6)
    ckpt = os.path.join(root, "retriever.npz")
    save_npz(ckpt, params_to_jax(Retriever(BertConfig()).reset_parameters(7).state_dict()))
    p = lambda name: os.path.join(root, name)  # noqa: E731
    common = ["--vocab", p("vocab.txt"), "--init-checkpoint", ckpt, "--device", str(device)]

    attention.launches = 0
    mips_kernel.launches = rescore.launches = 0
    fused_bert.form_launches.clear()
    walls = {}
    _, walls["build-db"] = run_cli(["build-db", "--corpus", p("corpus.jsonl"), "--db", p("docs.db")])
    built, walls["build-index"] = run_cli(["build-index", *common, "--max-seq-length", "512",
                                           "--predict-batch-size", str(batch),
                                           "--corpus", p("corpus.jsonl"), "--output-dir", p("index")])
    _, walls["encode-queries"] = run_cli(["encode-queries", *common, "--queries", p("qa.jsonl"),
                                          "--output", p("q.npy")])
    recall, walls["eval-retrieval"] = run_cli(["eval-retrieval", p("qa.jsonl"), p("index"),
                                               p("q.npy"), p("docs.db"), "--topk", str(k),
                                               "--device", str(device)])
    hit, walls["retrieve"] = run_cli(["retrieve", *common, "--question", "what is about tok3 tok7",
                                      "--index", p("index"), "--db", p("docs.db"), "--topk", "5"])
    launches = {"attention": attention.launches, "block_maxima": mips_kernel.launches,
                "rescore": rescore.launches, "F1": fused_bert.launches("F1"),
                "F2": fused_bert.launches("F2")}
    log(f"kernel launches during the CLI run: {json.dumps(launches)}")
    check(launches["attention"] > 0, "K2 was not launched on the main path")
    check(launches["F1"] > 0, "F1 was not launched on the main path")
    check(launches["F2"] > 0, "F2 was not launched on the main path")
    check(launches["block_maxima"] > 0, "K1 was not launched on the main path")
    check(launches["rescore"] > 0, "K6 was not launched on the main path")

    check(built == {"rows": n_paras, "dim": 128, "saved": p("index")}, f"build-index: {built}")
    emb = np.load(p("index/embeddings.npy"))
    check(emb.shape == (n_paras, 128) and np.isfinite(emb).all(), "index: bad embeddings")
    check(set(recall) == {f"recall@{r}" for r in (5, 10, 20, 50, 80)}, f"recall keys {recall}")
    check(len(hit["topk"]) == 5 and all(r["text"] for r in hit["topk"]), "retrieve: bad hits")
    # the eval's top-80 (kernel path) against the plain search of the same index
    q = np.load(p("q.npy"))
    check(q.shape == (n_q, 128) and np.isfinite(q).all(), "encode-queries: bad embeddings")
    index = DenseIndex.load(p("index"), device=device)
    vals, idx = index.search(q, k)
    qt = torch.from_numpy(q).to(device, torch.bfloat16)
    rv, ri = mips.mips_topk_reference(qt, index.embeddings, k, n_valid=index.n)
    bad = topk_disagreements(vals, idx, rv.cpu().numpy(), ri.cpu().numpy(), atol=TOPK_TOL)
    check(bad == 0, f"eval top-{k}: {bad} of {n_q} queries disagree with the plain search")
    # K1 at the shapes this search gave it: 256 queries, the whole index
    block = mips.envelope_block(index.embeddings.shape[0], 256)
    got = mips_kernel.block_maxima_grouped(qt, index.embeddings, block=block)
    want = mips_kernel.block_maxima_grouped_reference(qt, index.embeddings, block=block)
    k1_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    check(k1_err <= BMAX_TOL, f"K1 at the CLI's shapes: max abs err {k1_err} > {BMAX_TOL}")
    log(f"recall: {json.dumps(recall)}")
    log(f"eval top-{k}: all {n_q} queries agree with the plain search up to ties; K1 at "
        f"Q={n_q} N={index.embeddings.shape[0]} block={block}: max_abs_err {k1_err:.3g}")
    log(f"build-index: {tokens} tokens in {walls['build-index']:.2f} s = "
        f"{tokens / walls['build-index']:.0f} tokens/s (wall: host tokenization, weight "
        f"loading and saving included)")
    log(f"wall seconds per command: {json.dumps(walls)}")
    return launches, k1_err, batch, recall


def phase_dropout(device) -> dict:
    """K4 against its plain version: bit-equal outputs, the keep rate, and a
    backward that applies the forward's mask to the cotangent."""
    import torch
    import torch.nn.functional as F

    from proqa_tpu_torch.ops import dropout as drop

    g = torch.Generator(device=device).manual_seed(8)
    out = {}
    for shape, dtype in (((80, 512, 768), torch.bfloat16), ((80, 12, 32, 32), torch.float32)):
        x = torch.randn(*shape, device=device, generator=g).to(dtype)
        cot = torch.randn(*shape, device=device, generator=g).to(dtype)
        got = drop.dropout(x, 0.1, seed=2**61 + 5)
        want = drop.dropout_reference(x, 0.1, seed=2**61 + 5)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K4 {shape}: not bit-equal to its plain version")
        n = x.numel()
        kept = (got != 0).double().mean().item()
        sigma = (0.1 * 0.9 / n) ** 0.5
        check(abs(kept - 0.9) <= 5 * sigma, f"K4 {shape}: keep rate {kept} beyond 5 sigma")
        xr = x.clone().requires_grad_(True)
        drop.dropout(xr, 0.1, seed=2**61 + 5).backward(cot)
        check(torch.equal(xr.grad, drop.dropout_reference(cot, 0.1, seed=2**61 + 5)),
              f"K4 {shape}: backward does not apply the forward's mask")
        kernel = lambda: drop.dropout(x, 0.1, seed=3)  # noqa: E731
        library = lambda: F.dropout(x, 0.1, training=True)  # noqa: E731
        ms, lib = cuda_ms(kernel, reps=20), cuda_ms(library, reps=20)
        queued, lib_queued = cuda_ms(kernel, calls=10), cuda_ms(library, calls=10)
        plain = cuda_ms(lambda: drop.dropout_reference(x, 0.1, seed=3), reps=5)
        bms, by = bound(2 * n * x.element_size(), 0)
        log(f"K4 {tuple(shape)} {dtype}: bit-equal, keep rate {kept:.6f} "
            f"(5 sigma {5 * sigma:.2e}), kernel {ms:.4f} ms (queued {queued:.4f}), plain "
            f"{plain:.4f} ms, F.dropout {lib:.4f} ms (queued {lib_queued:.4f}), bound "
            f"{bms:.4f} ms")
        out.setdefault("first", {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                                 "library_ms": lib, "bound_ms": bms, "bound_by": by})
        del x, cot, got, want, xr
    return out["first"]


def _attention_inputs(device, b, h, t, dh, seed):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, t, dh, device=device, generator=g).bfloat16()
                   for _ in range(4))
    lengths = torch.randint(1, t + 1, (b,), device=device, generator=g)
    lengths[0] = 0  # one all-padding row
    mask = (torch.arange(t, device=device)[None] < lengths[:, None]).to(torch.int32)
    return q, k, v, do, mask


def phase_attention_train(device, b: int = 80) -> tuple[dict, dict]:
    """K2 at rate 0.1 and K3 at rates 0 and 0.1 against their plain versions
    at the train step's shapes, K3's two launches on the same inputs
    bit-equal; both kernels timed at rates 0.1 and 0 beside SDPA (rate 0)
    with a float mask, by one call and by 10 back-to-back calls."""
    import torch
    import torch.nn.functional as F

    from proqa_tpu_torch.ops import attention

    h, dh, rate, seed = 12, 64, 0.1, 2**50 + 3
    k2, k3 = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    for t in K2_BUCKETS:
        q, k, v, do, mask = _attention_inputs(device, b, h, t, dh, seed=t)
        scale = dh ** -0.5
        got = attention.fused_attention(q, k, v, mask, sm_scale=scale, dropout_rate=rate, seed=seed)
        want = attention.fused_attention_reference(q, k, v, mask, sm_scale=scale,
                                                   dropout_rate=rate, seed=seed)
        torch.cuda.synchronize()
        err2 = (got.float() - want.float()).abs().max().item()
        check(bool(torch.isfinite(got.float()).all()) and err2 <= ATTN_TOL,
              f"K2 rate {rate} B={b} T={t}: max abs err {err2} > {ATTN_TOL}")
        k2["max_abs_err"] = max(k2["max_abs_err"], err2)
        del got, want
        errs3, errs_autograd = {}, {}
        for r in (0.0, rate):
            got = attention._backward_kernel(q, k, v, mask, do, scale, r, seed)
            again = attention._backward_kernel(q, k, v, mask, do, scale, r, seed)
            want = attention.fused_attention_backward_reference(q, k, v, mask, do, sm_scale=scale,
                                                                dropout_rate=r, seed=seed)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K3 rate {r} B={b} T={t}: two launches on the same inputs differ")
            del again
            errs3[r] = max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want))
            check(all(bool(torch.isfinite(a.float()).all()) for a in got) and errs3[r] <= BWD_TOL,
                  f"K3 rate {r} B={b} T={t}: max abs err {errs3[r]} > {BWD_TOL}")
            # and against torch autograd through K2's plain version, in bf16
            # ulps at each output's largest magnitude
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            attention.fused_attention_reference(*leaves, mask, sm_scale=scale, dropout_rate=r,
                                                seed=seed).backward(do)
            errs_autograd[r] = max(
                (a.float() - x.grad.float()).abs().max().item()
                / (2.0 ** -7 * x.grad.float().abs().max().item()) for a, x in zip(got, leaves))
            check(errs_autograd[r] <= AUTOGRAD_ULPS, f"K3 rate {r} B={b} T={t} against autograd: "
                  f"{errs_autograd[r]} bf16 ulps > {AUTOGRAD_ULPS}")
            del got, want, leaves
        k3["max_abs_err"] = max(k3["max_abs_err"], *errs3.values())
        bias = torch.where(mask[:, None, None, :] != 0, 0.0, attention.MASK_BIAS).to(q.dtype)
        qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias)
        calls = {  # kernel and SDPA at rate 0.1 and 0, forward and backward
            "fwd": {
                "ms": lambda: attention.fused_attention(q, k, v, mask, sm_scale=scale,
                                                        dropout_rate=rate, seed=seed),
                "ms_rate0": lambda: attention.fused_attention(q, k, v, mask, sm_scale=scale),
                "library_ms": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
            },
            "bwd": {
                "ms": lambda: attention._backward_kernel(q, k, v, mask, do, scale, rate, seed),
                "ms_rate0": lambda: attention._backward_kernel(q, k, v, mask, do, scale, 0.0,
                                                               seed),
                "library_ms": lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                                          retain_graph=True),
            },
        }
        fwd = {key: cuda_ms(fn) for key, fn in calls["fwd"].items()}
        fwd["plain_ms"] = cuda_ms(lambda: attention.fused_attention_reference(
            q, k, v, mask, sm_scale=scale, dropout_rate=rate, seed=seed), reps=3)
        bwd = {key: cuda_ms(fn) for key, fn in calls["bwd"].items()}
        bwd["plain_ms"] = cuda_ms(lambda: attention.fused_attention_backward_reference(
            q, k, v, mask, do, sm_scale=scale, dropout_rate=rate, seed=seed), reps=3)
        queued = {way: {key: cuda_ms(fn, calls=10) for key, fn in fns.items()}
                  for way, fns in calls.items()}
        del calls, lib_out, qs, ks, vs, bias
        n = b * h * t * dh * 2  # bytes of one [B, H, T, Dh] bf16 tensor
        fwd["bound_ms"], fwd["bound_by"] = bound(4 * n + mask.numel() * 4, 4 * b * h * t * t * dh)
        bwd["bound_ms"], bwd["bound_by"] = bound(7 * n + mask.numel() * 4, 10 * b * h * t * t * dh)
        log(f"K2 rate {rate} B={b} H={h} T={t} Dh={dh} bf16: max_abs_err {err2:.3g} (tol "
            f"{ATTN_TOL}), kernel {fwd['ms']:.4f} ms (rate 0 {fwd['ms_rate0']:.4f}), plain "
            f"{fwd['plain_ms']:.4f} ms, SDPA at rate 0 {fwd['library_ms']:.4f} ms, bound "
            f"{fwd['bound_ms']:.4f} ms ({fwd['bound_by']})")
        log(f"K3 B={b} H={h} T={t} Dh={dh} bf16: max_abs_err rate 0 {errs3[0.0]:.3g}, rate {rate} "
            f"{errs3[rate]:.3g} (tol {BWD_TOL}); against autograd of the plain forward "
            f"{errs_autograd[0.0]:.3g}, {errs_autograd[rate]:.3g} top-magnitude bf16 ulps "
            f"(tol {AUTOGRAD_ULPS}); two launches bit-equal; kernel {bwd['ms']:.4f} ms (rate 0 "
            f"{bwd['ms_rate0']:.4f}), "
            f"plain {bwd['plain_ms']:.4f} ms, SDPA backward at rate 0 "
            f"{bwd['library_ms']:.4f} ms, bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']})")
        log(f"K2/K3 T={t} queued (mean of 10 back-to-back calls, ms): {json.dumps(queued)}")
        if t == 512:
            k2.update(fwd)
            k3.update(bwd)
        del q, k, v, do, mask
        torch.cuda.empty_cache()
    return k2, k3


def _fused_counts() -> dict:
    """F1's and F2's launch counters, forward and backward."""
    from proqa_tpu_torch.ops import fused_bert

    return {"F1": fused_bert.launches("F1"), "F2": fused_bert.launches("F2"),
            "F1 backward": fused_bert.launches("F1 backward"),
            "F2 backward": fused_bert.launches("F2 backward")}


def _reset_fused_counts() -> None:
    from proqa_tpu_torch.ops import fused_bert

    fused_bert.form_launches.clear()


def _cosines(grads_a: dict, grads_b: dict, skip=()) -> dict:
    import torch

    return {k: torch.nn.functional.cosine_similarity(g.flatten(), grads_b[k].flatten(),
                                                     dim=0).item()
            for k, g in grads_a.items() if k not in skip and not k.endswith(".k.bias")}


def _grads(model, batch, generator):
    import torch

    from proqa_tpu_torch.train.retriever_trainer import in_batch_loss

    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = in_batch_loss(model(batch, generator=generator))
    loss.backward()
    grads = {k: p.grad.detach().float().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    return loss.item(), grads


def phase_train_step(device) -> dict:
    """The full-width train step: 20 steps on one fixed batch, the kernels'
    launch counts, and a dropout-0 step with the kernels against the vanilla
    attention path."""
    import dataclasses

    import torch

    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.retriever import Retriever
    from proqa_tpu_torch.ops import attention, dropout, fused_bert
    from proqa_tpu_torch.train.optim import AdamW, init_train_state
    from proqa_tpu_torch.train.retriever_trainer import train_step

    b, tq, tc, steps = 80, 32, 512, 20
    cfg = BertConfig(remat=True, flash_attention=True)  # bf16, dropout 0.1
    g = torch.Generator(device=device).manual_seed(9)
    ids_c = torch.randint(5, cfg.vocab_size, (b, tc), device=device, generator=g)
    lengths = torch.randint(tc // 2, tc + 1, (b,), device=device, generator=g)
    mask_c = (torch.arange(tc, device=device)[None] < lengths[:, None]).to(torch.int32)
    ids_c = ids_c * mask_c
    ids_q = ids_c[:, :tq].clone()  # each question is its paragraph's opening
    batch = {"input_ids_q": ids_q, "input_mask_q": torch.ones(b, tq, dtype=torch.int32,
                                                             device=device),
             "input_ids_c": ids_c, "input_mask_c": mask_c}

    model = Retriever(cfg).reset_parameters(10).to(device)
    state = init_train_state(dict(model.named_parameters()))
    tx = AdamW(1e-4)
    gen = torch.Generator().manual_seed(11)
    train_step(model, state, tx, batch, gen)  # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.launches = attention.backward_launches = dropout.launches = 0
    _reset_fused_counts()
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = train_step(model, state, tx, batch, gen)
        losses.append(float(m["loss"]))  # synchronises
        walls.append(time.perf_counter() - t0)
    launches = {"K2": attention.launches, "K3": attention.backward_launches,
                "K4": dropout.launches, **_fused_counts()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = statistics.median(walls) * 1e3
    log(f"train step BERT-base bf16 remat flash dropout 0.1, {b} x ({tq} + {tc}): losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {step_ms:.1f} ms per step (median of {steps}, host "
        f"clock, synchronised), {b * (tq + tc) / step_ms * 1e3:.0f} tokens/s, peak {peak:.2f} GiB; "
        f"launches in {steps} steps: {json.dumps(launches)}")
    check(all(math.isfinite(x) for x in losses), f"train step: non-finite loss {losses}")
    check(losses[-1] < losses[0] - LOSS_DROP,
          f"train step: loss {losses[0]} -> {losses[-1]} did not fall by {LOSS_DROP}")
    check(all(n > 0 for n in launches.values()), f"train step: a kernel never ran {launches}")

    # dropout 0: the fused kernels (K2 forward, K3 backward; F1, F2 and their
    # backward kernels) against the vanilla attention path, and against the
    # plain epilogue chain under autograd (fused_bert._eager_chain), same
    # weights, same batch
    cfg0 = dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)
    fused = Retriever(cfg0).to(device)
    fused.load_state_dict(model.state_dict())
    del model, state
    torch.cuda.empty_cache()
    _reset_fused_counts()
    loss_k, grads_k = _grads(fused, batch, gen)
    routed = _fused_counts()
    with fused_bert._eager_chain():
        loss_e, grads_e = _grads(fused, batch, gen)
    check(_fused_counts() == routed, "dropout-0 step under _eager_chain: F1/F2 launched")
    vanilla = Retriever(dataclasses.replace(cfg0, flash_attention=False)).to(device)
    vanilla.load_state_dict(fused.state_dict())
    del fused
    loss_p, grads_p = _grads(vanilla, batch, gen)
    # the key bias and proj_c's bias get zero gradient in exact arithmetic
    # (softmax ignores a constant added to a row): only noise, skipped
    cos = _cosines(grads_k, grads_p, skip=("proj_c.bias",))
    cos_e = _cosines(grads_k, grads_e, skip=("proj_c.bias",))
    del grads_e
    worst, worst_e = min(cos, key=cos.get), min(cos_e, key=cos_e.get)
    log(f"dropout-0 step, kernels vs vanilla attention: loss {loss_k:.6f} vs {loss_p:.6f}, min "
        f"gradient cosine {cos[worst]:.6f} ({worst}; tol {GRAD_COS}) over {len(cos)} tensors; "
        f"F1/F2 and their backward kernels ({json.dumps(routed)} launches) vs the plain chain: "
        f"loss {loss_k:.6f} vs {loss_e:.6f}, min gradient cosine {cos_e[worst_e]:.6f} "
        f"({worst_e}; tol {GRAD_COS})")
    check(all(n > 0 for n in routed.values()), f"dropout-0 step: F1/F2 not launched {routed}")
    check(cos[worst] >= GRAD_COS,
          f"dropout-0 gradients: cosine {cos[worst]} < {GRAD_COS} ({worst})")
    check(cos_e[worst_e] >= GRAD_COS, f"dropout-0 gradients, kernels vs the plain chain: cosine "
                                      f"{cos_e[worst_e]} < {GRAD_COS} ({worst_e})")
    return {"step_ms": step_ms, "tokens_per_s": b * (tq + tc) / step_ms * 1e3, "peak_gib": peak,
            "loss_first": losses[0], "loss_last": losses[-1], "min_grad_cos": cos[worst],
            "min_grad_cos_plain_chain": cos_e[worst_e], "launches": launches}


def write_pair_world(root: str, n_pairs: int, n_paras: int, seed: int) -> None:
    """Pretraining pairs whose paragraphs fill the 256-token context (254
    words and [CLS], [SEP]), 3 questions per paragraph, and a corpus of
    100..250-word paragraphs, so build-index's buckets 128 and 256 reach K2."""
    import numpy as np

    rng = np.random.default_rng(seed)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    with open(os.path.join(root, "pairs.jsonl"), "w") as f:
        for i in range(n_pairs):
            words = rng.integers(0, 60, size=300)
            para = " ".join(f"tok{w}" for w in words)
            question = f"what is about tok{words[i % 3]} tok{words[3 + i % 3]}"
            f.write(json.dumps({"Question": question, "Paragraph": para,
                                "Answer": f"tok{words[7]}"}) + "\n")
    with open(os.path.join(root, "corpus.jsonl"), "w") as f:
        for i in range(n_paras):
            words = rng.integers(0, 60, size=int(rng.integers(100, 251)))
            f.write(json.dumps({"text": " ".join(f"tok{w}" for w in words), "id": f"p{i}"}) + "\n")


def phase_pretrain_cli(device, root: str) -> dict:
    """This slice's main path through the CLI, with every launch counter
    reset just before it and read just after."""
    import numpy as np
    import torch

    from proqa_tpu_torch.data.datasets import EncodeDataset
    from proqa_tpu_torch.index.build import encode_corpus
    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.convert import load_params
    from proqa_tpu_torch.models.retriever import Retriever
    from proqa_tpu_torch.ops import attention, dropout, mips_kernel, rescore
    from proqa_tpu_torch.text.wordpiece import BertTokenizer

    n_paras = 4608  # padded index past 4,096 rows: retrieve searches through K1
    write_pair_world(root, n_pairs=96, n_paras=n_paras, seed=12)
    p = lambda name: os.path.join(root, name)  # noqa: E731
    seq = ["--vocab", p("vocab.txt"), "--max-seq-length", "286", "--max-query-length", "30",
           "--device", str(device)]
    attention.launches = attention.backward_launches = 0
    dropout.launches = mips_kernel.launches = rescore.launches = 0
    _reset_fused_counts()
    walls = {}
    trained, walls["pretrain-retriever"] = run_cli([
        "pretrain-retriever", *seq, "--train-file", p("pairs.jsonl"),
        "--predict-file", p("pairs.jsonl"), "--output-dir", p("run"), "--train-batch-size", "32",
        "--predict-batch-size", "32", "--num-train-epochs", "1", "--eval-period", "3",
        "--save-checkpoints-steps", "100", "--learning-rate", "1e-4"])
    built, walls["build-index"] = run_cli([
        "build-index", *seq, "--corpus", p("corpus.jsonl"),
        "--init-checkpoint", p("run/checkpoint_last.pt"), "--output-dir", p("index"),
        "--predict-batch-size", "512"])
    hit, walls["retrieve"] = run_cli([
        "retrieve", *seq, "--question", "what is about tok3 tok7", "--index", p("index"),
        "--init-checkpoint", p("run/checkpoint_last.pt"), "--topk", "5"])
    launches = {"K1": mips_kernel.launches, "K2": attention.launches,
                "K3": attention.backward_launches, "K4": dropout.launches,
                "K6": rescore.launches, **_fused_counts()}
    log(f"kernel launches during pretrain-retriever -> build-index -> retrieve: "
        f"{json.dumps(launches)}; wall seconds {json.dumps(walls)}")
    check(all(n > 0 for n in launches.values()), f"a kernel never ran on the CLI path {launches}")
    check(0.0 <= trained["best_in_batch_acc"] <= 1.0, f"pretrain-retriever: {trained}")
    check(built == {"rows": n_paras, "dim": 128, "saved": p("index")}, f"build-index: {built}")
    check(len(hit["topk"]) == 5, f"retrieve: {hit}")
    emb = np.load(p("index/embeddings.npy"))
    check(emb.shape == (n_paras, 128) and np.isfinite(emb).all(), "index: bad embeddings")
    # the index against the plain encoder (vanilla attention, no K2) on 64 rows
    model = Retriever(BertConfig(flash_attention=False))
    model.load_state_dict(load_params(p("run/checkpoint_last.pt")))
    model = model.to(device).eval()
    tok = BertTokenizer.from_vocab_file(p("vocab.txt"))
    ds = EncodeDataset(tok, p("corpus.jsonl"), max_length=286)
    ds.data = ds.data[:64]
    plain = encode_corpus(model, ds, batch_size=64)
    cos = torch.nn.functional.cosine_similarity(torch.from_numpy(plain),
                                                torch.from_numpy(emb[:64]), dim=1).min().item()
    log(f"index rows vs the plain encoder from checkpoint_last.pt: min cosine {cos:.6f} "
        f"(tol {ENCODER_COS})")
    check(cos >= ENCODER_COS, f"index vs plain encoder: min cosine {cos} < {ENCODER_COS}")
    return launches


def check_hopper_route(name, queries, codes, block: int) -> None:
    """Fails unless the int8 launch of K5 or K7 at these dtypes and block
    takes the Hopper kernel (csrc/block_maxima_wgmma.cu), not the simple
    body: the launch counters alone do not tell the two apart."""
    from proqa_tpu_torch.ops import mips_kernel

    route = mips_kernel.kernel_for(queries.dtype, codes.dtype, block=block,
                                   group=mips_kernel.GROUP, grouped=True, scaled=True)
    check(route == "wgmma", f"{name} at block {block} takes the {route} kernel")


def _search_qps(fn, q: int, reps: int = 3) -> float:
    """Queries per second of fn(), which ends synchronised (median of reps,
    host clock, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return q / statistics.median(walls)


def _exact_top(queries, codes, row_scales, k: int, chunk: int):
    """The exact top-k of (scale *) query . codes over the whole corpus, a
    chunk of rows at a time (the global top-k is the top-k of the chunks');
    row_scales None: the rows unscaled."""
    import torch

    from proqa_tpu_torch.ops import mips

    cand_v, cand_i = [], []
    for r0 in range(0, codes.shape[0], chunk):
        v, i = mips.mips_topk_reference(queries, codes[r0:r0 + chunk], k,
                                        scales=None if row_scales is None
                                        else row_scales[r0:r0 + chunk])
        cand_v.append(v)
        cand_i.append(i + r0)
    vals, sel = torch.topk(torch.cat(cand_v, dim=1), k)
    return vals, torch.gather(torch.cat(cand_i, dim=1), 1, sel)


def phase_int8(device) -> dict:
    """K5 at 4,194,304 x 128: the kernel against its plain version on codes
    made on the device, then an int8 DenseIndex quantized on the host from an
    f32 corpus, its top-80 qps and 256 queries against the exact reference."""
    import numpy as np
    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.ops import mips, quant
    from proqa_tpu_torch.testing import random_int8_corpus, topk_disagreements

    n, q, d, k = 4_194_304, 2048, 128, 80
    block = mips.envelope_block(n, q)
    codes, scales = random_int8_corpus(n, d, block, seed=14, device=device)
    g = torch.Generator(device=device).manual_seed(15)
    queries = torch.randn(q, d, device=device, generator=g) / d ** 0.5
    qb = queries.bfloat16()
    check_hopper_route("K5", qb, codes, block)
    k5 = grouped_against_plain("K5", qb, codes, block=block, scales=scales)
    del k5["out"]
    # retrieve's batch: the bytes bound it (the corpus once, 0.54 GB)
    k5_small = grouped_against_plain("K5 Q=32", qb[:32].contiguous(), codes, block=block,
                                     scales=scales)
    del k5_small["out"], codes, scales

    host = (torch.randn(n, d, generator=torch.Generator().manual_seed(16)) / d ** 0.5).numpy()
    t0 = time.perf_counter()
    index = DenseIndex.from_embeddings(host, device=device, dtype="int8")
    build_s = time.perf_counter() - t0
    del host
    check(index.quant_block == block and index.embeddings.dtype == torch.int8,
          f"int8 index: quant block {index.quant_block}, dtype {index.embeddings.dtype}")
    vals, idx = index.search(queries, k)
    qps = _search_qps(lambda: index.search(queries, k), q)
    check(vals.shape == (q, k) and np.isfinite(vals).all(), "int8 search: bad values")
    rows = quant.expand_scales(index.scales, index.quant_block, n)
    n_check, bad = 256, 0
    for s in range(0, n_check, 64):
        rv, ri = mips.mips_topk_reference(qb[s:s + 64], index.embeddings, k, scales=rows)
        bad += topk_disagreements(vals[s:s + 64], idx[s:s + 64], rv.cpu().numpy(),
                                  ri.cpu().numpy(), atol=TOPK_TOL)
    check(bad == 0, f"int8 search: {bad} of {n_check} queries disagree with the exact top-{k} "
                    "of the dequantized corpus")
    log(f"int8 index N={n} quant block {index.quant_block}: quantized on the host and placed in "
        f"{build_s:.1f} s; search top-{k} Q={q}: {qps:.1f} qps (host clock); {n_check} queries "
        f"agree with the exact top-{k} of the dequantized corpus up to ties")
    return {**k5, "max_abs_err": max(k5["max_abs_err"], k5_small["max_abs_err"]), "qps": qps}


def phase_int8_capacity(device) -> dict:
    """K5 at the capacity point the int8 index exists for: 67,108,864 x 128
    codes (8.6 GB) made on the device, block 128."""
    import torch

    from proqa_tpu_torch.ops import mips, quant
    from proqa_tpu_torch.testing import random_int8_corpus, topk_disagreements

    n, q, d, k = 67_108_864, 2048, 128, 80
    block = mips.envelope_block(n, q)
    codes, scales = random_int8_corpus(n, d, block, seed=13, device=device)
    g = torch.Generator(device=device).manual_seed(17)
    qb = (torch.randn(q, d, device=device, generator=g) / d ** 0.5).bfloat16()
    check_hopper_route("K5 capacity", qb, codes, block)
    # plain chunks of 64 groups: a [2048, 1,048,576] f32 score matrix, 8.6 GB
    k5 = grouped_against_plain("K5 capacity", qb, codes, block=block, chunk_groups=64, reps=2,
                               scales=scales)
    del k5["out"]
    search = lambda: mips.mips_topk(qb, codes, k, scales=scales, quant_block=block)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vals, idx = search()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    qps = _search_qps(search, q, reps=2)
    rows = quant.expand_scales(scales, block, n)
    rv, ri = _exact_top(qb[:64], codes, rows, k, chunk=1 << 22)
    bad = topk_disagreements(vals[:64].cpu().numpy(), idx[:64].cpu().numpy(), rv.cpu().numpy(),
                             ri.cpu().numpy(), atol=TOPK_TOL)
    check(bad == 0, f"int8 capacity search: {bad} of 64 queries disagree with the exact top-{k}")
    log(f"int8 capacity point N={n} block={block}: mips_topk top-{k} Q={q} {qps:.1f} qps (host "
        f"clock), peak device memory {peak:.2f} GiB (index {codes.numel() / 2**30:.2f} GiB); 64 "
        f"queries agree with the chunked exact reference up to ties")
    return {**k5, "qps": qps, "peak_gib": peak}


def phase_bounded(device) -> tuple[dict, int]:
    """K7 at 4.2M per-row int8: mips_topk_v2(row_scales=, kb=16k) once with
    the counters at 0, its values the exact row-scaled scores of its rows;
    then the bounds against their formula (the plain version) and above the
    true row-scaled block maxima."""
    import torch

    from proqa_tpu_torch.ops import mips_kernel
    from proqa_tpu_torch.ops.dot import dot_f32
    from proqa_tpu_torch.testing import random_int8_corpus

    n, q, d, k, block = 4_194_304, 2048, 128, 80, 16
    codes, rs = random_int8_corpus(n, d, 1, seed=18, device=device, norm_range=(0.1, 10.0))
    g = torch.Generator(device=device).manual_seed(19)
    qb = (torch.randn(q, d, device=device, generator=g) / d ** 0.5).bfloat16()
    mips_kernel.bounded_launches = 0
    vals, idx = mips_kernel.mips_topk_v2(qb, codes, k, block=block, row_scales=rs, kb=16 * k)
    torch.cuda.synchronize()
    launches = mips_kernel.bounded_launches
    check(launches > 0, "K7 was not launched by mips_topk_v2(row_scales=)")
    rows = codes[idx].bfloat16()                                       # [Q, k, D]
    exact = dot_f32(rows, qb[:, :, None])[..., 0] * rs[idx]
    v_err = (vals - exact).abs().max().item()
    check(v_err <= BMAX_TOL * 10, f"K7 pipeline: values {v_err} from the exact row-scaled scores")
    del rows, exact, vals, idx

    rsb = rs.view(-1, block)
    bounds = (rsb.amax(dim=1), rsb.amin(dim=1))
    check_hopper_route("K7", qb, codes, block)
    k7 = grouped_against_plain("K7", qb, codes, block=block, scale_bounds=bounds)
    bmax3, _ = k7.pop("out")
    per_block = bmax3.transpose(1, 2).reshape(-1, q)                   # [NB, Q]
    worst, chunk = float("inf"), 1 << 20                  # bound minus true maximum
    for r0 in range(0, n, chunk):
        s = dot_f32(codes[r0:r0 + chunk].bfloat16(), qb.T) * rs[r0:r0 + chunk, None]
        true = s.view(-1, block, q).amax(dim=1)                         # [blocks, Q]
        b0 = r0 // block
        worst = min(worst, (per_block[b0:b0 + true.shape[0]] - true).min().item())
        del s, true
    check(worst >= -BMAX_TOL, f"K7: a bound lies {-worst} under its true row-scaled maximum")
    log(f"K7 bounds dominate the true row-scaled block maxima (least margin {worst:.3g}); "
        f"mips_topk_v2(row_scales=, kb={16 * k}) values within {v_err:.3g} of the exact "
        f"row-scaled scores of its rows")
    return k7, launches


def phase_v1(device) -> tuple[dict, int]:
    """K8 at 4.2M bf16: mips_topk_v1 once with the counters at 0, its top-80
    against the K1 pipeline's; then block_maxima against its plain version."""
    import torch

    from proqa_tpu_torch.ops import mips_kernel
    from proqa_tpu_torch.testing import topk_disagreements

    corpus, queries = bf16_corpus(device)
    (n, d), q, k = corpus.shape, queries.shape[0], 80
    qb = queries.bfloat16()
    block, tile_n = 256, 2048   # mips_topk_v1's defaults
    route = mips_kernel.kernel_for(qb.dtype, corpus.dtype, block=block, group=tile_n // block,
                                   grouped=False, scaled=False)
    check(route == "wgmma", f"K8 at block {block} takes the {route} kernel")
    mips_kernel.block_major_launches = 0
    v1 = mips_kernel.mips_topk_v1(qb, corpus, k, block=block, tile_n=tile_n)
    torch.cuda.synchronize()
    launches = mips_kernel.block_major_launches
    check(launches > 0, "K8 was not launched by mips_topk_v1")
    v2 = mips_kernel.mips_topk_v2(qb, corpus, k, block=16)
    bad = topk_disagreements(*(x.cpu().numpy() for x in (*v1, *v2)), atol=TOPK_TOL)
    check(bad == 0, f"mips_topk_v1: {bad} of {q} queries disagree with the K1 pipeline")
    del v1, v2

    bmax = mips_kernel.block_maxima(qb, corpus, block=block, tile_n=tile_n)
    torch.cuda.synchronize()
    bound_ms, bound_by = bound(corpus.numel() * 2 + qb.numel() * 2 + bmax.numel() * 4,
                               2.0 * n * q * d)
    ms = cuda_ms(lambda: mips_kernel.block_maxima(qb, corpus, block=block, tile_n=tile_n), reps=3)
    err, plain_ms, chunk = 0.0, 0.0, 1 << 18
    for r0 in range(0, n, chunk):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = mips_kernel.block_maxima_reference(qb, corpus[r0:r0 + chunk], block=block,
                                                  tile_n=tile_n)
        end.record()
        end.synchronize()
        plain_ms += start.elapsed_time(end)
        err = max(err, (bmax[r0 // block:(r0 + chunk) // block] - want).abs().max().item())
    check(err <= BMAX_TOL, f"K8: max abs err {err} > {BMAX_TOL}")
    log(f"K8 N={n} Q={q} block={block} bf16: max_abs_err {err:.3g} (tol {BMAX_TOL}), kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms (sum of {n // chunk} chunks), bound "
        f"{bound_ms:.3f} ms ({bound_by}); mips_topk_v1 top-{k} agrees with the K1 pipeline's "
        "up to ties")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}, launches


def phase_rescore(device) -> tuple[dict, dict, dict]:
    """K6 and K9 (csrc/gather_rescore.cu) on the candidate blocks the K1
    pipeline selects at 4.2M (Q = 2,048, k = kb = 80, block 16) and on those
    mips_topk_v1 rescores (its first chunk: 256 queries, kb = 128, block
    256): mips_topk_v2(rescore_impl="stream") and gather_score once with the
    counters at 0; then both kernels over the bf16 corpus and over the same
    corpus in f32 against the plain gather and product, timed beside the
    `take` path (the gather and dot_f32) and the bound, and the streamed
    top-80 against the take top-80. The kernels line keeps block 16 bf16."""
    import torch

    from proqa_tpu_torch.ops import mips_kernel, rescore
    from proqa_tpu_torch.ops.dot import dot_f32
    from proqa_tpu_torch.testing import topk_disagreements

    corpus, queries = bf16_corpus(device)
    (n, d), q, k = corpus.shape, queries.shape[0], 80
    qb = queries.bfloat16()
    ids16 = mips_kernel.select_blocks(qb, corpus, k, block=16)           # [Q, 80]
    rescore.launches = rescore.score_launches = 0
    stream = mips_kernel.mips_topk_v2(qb, corpus, k, block=16, rescore_impl="stream")
    rescore.gather_score(qb, corpus.view(-1, 16, d), ids16, block=16)
    torch.cuda.synchronize()
    launches = {"K6": rescore.launches, "K9": rescore.score_launches}
    check(all(v > 0 for v in launches.values()), f"K6/K9 not launched: {launches}")
    take = mips_kernel.mips_topk_v2(qb, corpus, k, block=16, rescore_impl="take")
    bad = topk_disagreements(*(x.cpu().numpy() for x in (*stream, *take)), atol=TOPK_TOL)
    check(bad == 0, f"stream rescore: {bad} of {q} queries disagree with the take rescore")
    del stream, take
    # mips_topk_v1's first rescore: the top-128 blocks of 256 rows of its
    # first 256 queries by K8's maxima
    q256 = qb[:256].contiguous()
    ids256 = torch.topk(mips_kernel.block_maxima(q256, corpus, block=256, tile_n=2048).T,
                        128).indices
    corpus_f32 = corpus.float()

    def run(name, fn, qs, flat, ids, block):
        blocks = flat.view(-1, block, d)
        kb, nq = ids.shape[1], qs.shape[0]
        want = rescore.gather_rescore_reference(qs, blocks, ids, block=block)
        got = fn(qs, blocks, ids, block=block)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= BMAX_TOL, f"{name}: max abs err {err} > {BMAX_TOL}")
        del got, want

        def take_path():
            cand = blocks[ids].view(nq, kb * block, d)
            return dot_f32(cand, qs[:, :, None]).view(nq, kb * block)

        ms = cuda_ms(lambda: fn(qs, blocks, ids, block=block), reps=20)
        queued = cuda_ms(lambda: fn(qs, blocks, ids, block=block), calls=10)
        plain_ms = cuda_ms(lambda: rescore.gather_rescore_reference(qs, blocks, ids,
                                                                    block=block), reps=3)
        library_ms = cuda_ms(take_path, reps=10)
        # bytes this data needs: each distinct candidate block read once
        distinct = torch.unique(ids).numel()
        elt = flat.element_size()
        nbytes = (distinct * block * d * elt + qs.numel() * elt + ids.numel() * 8
                  + nq * kb * block * 4)
        bound_ms, bound_by = bound(nbytes, 2.0 * nq * kb * block * d)
        log(f"{name} Q={nq} kb={kb} block={block} {flat.dtype} ({distinct} distinct candidate "
            f"blocks of {ids.numel()}): max_abs_err {err:.3g} (tol {BMAX_TOL}), kernel {ms:.4f} "
            f"ms (queued {queued:.4f}), plain {plain_ms:.4f} ms, take path (gather + dot_f32) "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        return {"max_abs_err": err, "ms": ms, "queued_ms": queued, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}

    results = {}
    for label, flat, qs16, qs256 in (("bf16", corpus, qb, q256),
                                     ("f32", corpus_f32, queries, q256.float())):
        for name, fn in (("K6", rescore.gather_rescore), ("K9", rescore.gather_score)):
            results[name, label, 16] = run(name, fn, qs16, flat, ids16, 16)
            results[name, label, 256] = run(name, fn, qs256, flat, ids256, 256)
    del corpus_f32
    log(f"streamed rescore top-{k}: all {q} queries agree with the take rescore up to ties")
    out = {}
    for name in ("K6", "K9"):
        out[name] = {**results[name, "bf16", 16],
                     "max_abs_err": max(r["max_abs_err"] for key, r in results.items()
                                        if key[0] == name)}
    return out["K6"], out["K9"], launches


def phase_int8_cli(device, root: str, recall_bf16: dict) -> tuple[int, float]:
    """The int8 CLI path on phase_cli's retrieval world, with every counter
    reset before and read after; then a direct int8 DenseIndex.search
    against the exact reference of its own codes, and K5 at the shapes that
    search gave it."""
    import numpy as np
    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.ops import attention, mips, mips_kernel, quant
    from proqa_tpu_torch.testing import topk_disagreements

    p = lambda name: os.path.join(root, name)  # noqa: E731
    k = 80
    attention.launches = 0
    mips_kernel.launches = mips_kernel.scaled_launches = 0
    recall, wall_eval = run_cli(["eval-retrieval", p("qa.jsonl"), p("index"), p("q.npy"),
                                 p("docs.db"), "--topk", str(k), "--int8-index",
                                 "--device", str(device)])
    hit, wall_retrieve = run_cli(["retrieve", "--vocab", p("vocab.txt"), "--init-checkpoint",
                                  p("retriever.npz"), "--device", str(device), "--question",
                                  "what is about tok3 tok7", "--index", p("index"), "--db",
                                  p("docs.db"), "--topk", "5", "--int8-index"])
    launches = {"K5": mips_kernel.scaled_launches, "K1": mips_kernel.launches,
                "K2": attention.launches}
    log(f"kernel launches during eval-retrieval and retrieve --int8-index: "
        f"{json.dumps(launches)}")
    check(launches["K5"] > 0, "K5 was not launched on the int8 CLI path")
    check(set(recall) == set(recall_bf16), f"int8 recall keys {recall}")
    check(len(hit["topk"]) == 5 and all(r["text"] for r in hit["topk"]), "retrieve: bad hits")
    log(f"recall, bf16 index: {json.dumps(recall_bf16)}")
    log(f"recall, int8 index: {json.dumps(recall)} (eval {wall_eval:.2f} s, retrieve "
        f"{wall_retrieve:.2f} s wall)")

    q = np.load(p("q.npy"))
    index = DenseIndex.load(p("index"), device=device, dtype="int8")
    vals, idx = index.search(q, k)
    qt = torch.from_numpy(q).to(device, torch.bfloat16)
    rows = quant.expand_scales(index.scales, index.quant_block, index.embeddings.shape[0])
    rv, ri = mips.mips_topk_reference(qt, index.embeddings, k, n_valid=index.n, scales=rows)
    bad = topk_disagreements(vals, idx, rv.cpu().numpy(), ri.cpu().numpy(), atol=TOPK_TOL)
    check(bad == 0, f"int8 index search: {bad} of {len(q)} queries disagree with the exact "
                    "reference of its codes")
    block = index.quant_block
    check_hopper_route("the int8 CLI path's K5", qt, index.embeddings, block)
    got = mips_kernel.block_maxima_grouped(qt, index.embeddings, block=block, scales=index.scales)
    want = mips_kernel.block_maxima_grouped_reference(qt, index.embeddings, block=block,
                                                      scales=index.scales)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    check(err <= BMAX_TOL, f"K5 at the CLI's shapes: max abs err {err} > {BMAX_TOL}")
    log(f"int8 index (quant block {block}): all {len(q)} queries agree with the exact reference "
        f"up to ties; K5 at Q={len(q)} N={index.embeddings.shape[0]}: max_abs_err {err:.3g}")
    return launches["K5"], err


def phase_f32(device) -> dict:
    """K1 over f32 at 4,194,304 x 128 (csrc/block_maxima_f32.cu), Q = 2,048
    and 32, against its plain version, its bound at the f32 FMA rate; then a
    DenseIndex(dtype=float32): top-80 qps and 256 queries against the exact
    f32 top-80."""
    import numpy as np
    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.ops import mips, mips_kernel, rescore
    from proqa_tpu_torch.ops.dot import dot_f32
    from proqa_tpu_torch.testing import topk_disagreements

    n, q, d, k = 4_194_304, 2048, 128, 80
    g = torch.Generator(device=device).manual_seed(20)
    corpus = torch.randn(n, d, device=device, generator=g) / d ** 0.5
    queries = torch.randn(q, d, device=device, generator=g) / d ** 0.5
    block = mips.envelope_block(n, q)
    route = mips_kernel.kernel_for(queries.dtype, corpus.dtype, block=block,
                                   group=mips_kernel.GROUP, grouped=True, scaled=False)
    check(route == "f32", f"K1 over f32 at block {block} takes the {route} kernel")
    k1 = grouped_against_plain("K1 f32", queries, corpus, block=block, peak=PEAK_F32_FLOPS)
    del k1["out"]
    k1_small = grouped_against_plain("K1 f32 Q=32", queries[:32].contiguous(), corpus,
                                     block=block, peak=PEAK_F32_FLOPS)
    del k1_small["out"]

    index = DenseIndex.from_embeddings(corpus, device=device, dtype=torch.float32)
    rescore.launches = 0
    vals, idx = index.search(queries, k)
    check(rescore.launches > 0, "f32 search: K6 was not launched by the f32 DenseIndex.search")
    qps = _search_qps(lambda: index.search(queries, k), q)  # ends in a device-to-host copy
    check(vals.shape == (q, k) and np.isfinite(vals).all(), "f32 search: bad values")
    n_check, bad = 256, 0
    for s in range(0, n_check, 64):
        ref = torch.topk(dot_f32(queries[s:s + 64], corpus.T), k)
        bad += topk_disagreements(vals[s:s + 64], idx[s:s + 64], ref.values.cpu().numpy(),
                                  ref.indices.cpu().numpy(), atol=TOPK_TOL)
    check(bad == 0, f"f32 search: {bad} of {n_check} queries disagree with the exact top-{k}")
    log(f"f32 search top-{k} N={n} Q={q}: {qps:.1f} qps (host clock); {n_check} queries agree "
        f"with the exact f32 top-{k} up to ties; its rescore launched K6")
    return {**k1, "max_abs_err": max(k1["max_abs_err"], k1_small["max_abs_err"]), "qps": qps}


def phase_f32_cli(device, root: str, recall_bf16: dict) -> int:
    """The f32 CLI path on phase_cli's retrieval world: eval-retrieval and
    retrieve with --f32, the counters of the f32 kernel and of K6 reset
    before and read after."""
    import numpy as np
    import torch

    from proqa_tpu_torch.ops import mips, mips_kernel, rescore

    p = lambda name: os.path.join(root, name)  # noqa: E731
    rows = np.load(p("index/embeddings.npy"), mmap_mode="r").shape[0]
    route = mips_kernel.kernel_for(torch.float32, torch.float32, block=mips.envelope_block(rows),
                                   group=mips_kernel.GROUP, grouped=True, scaled=False)
    check(route == "f32", f"the f32 CLI path's K1 takes the {route} kernel")
    mips_kernel.f32_launches = rescore.launches = 0
    recall, wall_eval = run_cli(["eval-retrieval", p("qa.jsonl"), p("index"), p("q.npy"),
                                 p("docs.db"), "--topk", "80", "--f32", "--device", str(device)])
    hit, wall_retrieve = run_cli(["retrieve", "--vocab", p("vocab.txt"), "--init-checkpoint",
                                  p("retriever.npz"), "--device", str(device), "--question",
                                  "what is about tok3 tok7", "--index", p("index"), "--db",
                                  p("docs.db"), "--topk", "5", "--f32"])
    launches, k6 = mips_kernel.f32_launches, rescore.launches
    log(f"K1 f32 launches during eval-retrieval and retrieve --f32 ({rows} rows): {launches}; "
        f"K6: {k6}")
    check(launches > 0, "K1's f32 kernel was not launched on the f32 CLI path")
    check(k6 > 0, "K6 was not launched on the f32 CLI path")
    check(set(recall) == set(recall_bf16) and all(0.0 <= v <= 1.0 for v in recall.values()),
          f"f32 recall {recall}")
    check(len(hit["topk"]) == 5 and all(r["text"] for r in hit["topk"]), "retrieve --f32: bad hits")
    log(f"recall, f32 index: {json.dumps(recall)} (eval {wall_eval:.2f} s, retrieve "
        f"{wall_retrieve:.2f} s wall)")
    return launches, k6


def _span_margin(start, end, max_answer_len: int = 10):
    """Per paragraph, the best band span's score minus the runner-up's."""
    import torch

    from proqa_tpu_torch.models.reader import NEG

    l = start.shape[-1]
    scores = start[..., :, None] + end[..., None, :]
    i = torch.arange(l, device=start.device)
    band = (i[None, :] >= i[:, None]) & (i[None, :] <= i[:, None] + max_answer_len)
    top2 = torch.where(band, scores, NEG).flatten(-2).topk(2).values
    return top2[..., 0] - top2[..., 1]


def phase_qa(device, root: str) -> dict:
    """The QA answering path on phase_cli's retrieval world (8,192
    paragraphs, its BERT-base retriever and index) with a BERT-base reader of
    random seeded weights saved as one QA .npz: eval-qa over the 256
    questions (T = 512, eval_k 5, 8 questions a group), answer, and answer
    --int8-index, the counters of K1, K2, K5 and K6 reset before each run and
    read after; then the sampler's retrieved rows against the exact search,
    K1 and K2 at the shapes this path gives them against their plain
    versions, and one reader batch with K2 against the vanilla path."""
    import dataclasses

    import numpy as np
    import torch

    from proqa_tpu_torch.cli.main import _qa_setup, build_parser
    from proqa_tpu_torch.data.collate import pad_to
    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.convert import load_params, params_to_jax, save_npz
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.models.reader import QAConfig, QAModel, decode_spans
    from proqa_tpu_torch.ops import attention, fused_bert, mips, mips_kernel, quant, rescore
    from proqa_tpu_torch.qa.sampler import OnlineSampler
    from proqa_tpu_torch.testing import topk_disagreements

    p = lambda name: os.path.join(root, name)  # noqa: E731
    n_q, k, qpb, t, tq = 256, 5, 8, 512, 30
    model = QAModel(BertConfig(), QAConfig()).reset_parameters(9)
    model.retriever.load_state_dict(load_params(p("retriever.npz")))
    save_npz(p("qa.npz"), params_to_jax(model.state_dict()))
    del model
    # 256 distinct questions (qa.jsonl repeats some pairs, and predict keeps
    # one row a question), each with a dozen one-word gold answers
    rng = np.random.default_rng(11)
    with open(p("qa_eval.jsonl"), "w") as f:
        for pair in rng.choice(60 * 60, n_q, replace=False):
            gold = [f"tok{w}" for w in rng.choice(60, 12, replace=False)]
            f.write(json.dumps({"question": f"what is about tok{pair // 60} tok{pair % 60}",
                                "answer": gold}) + "\n")
    qa_args = ["--vocab", p("vocab.txt"), "--db", p("docs.db"), "--index", p("index"),
               "--init-checkpoint", p("qa.npz"), "--device", str(device), "--max-seq-length",
               str(t), "--eval-k", str(k), "--questions-per-batch", str(qpb),
               "--output-dir", p("qa_run")]
    question = ["--question", "what is about tok3 tok7"]

    def counted(argv):
        attention.launches = mips_kernel.launches = mips_kernel.scaled_launches = 0
        rescore.launches = 0
        fused_bert.form_launches.clear()
        out, wall = run_cli(argv)
        return out, wall, {"K1": mips_kernel.launches, "K2": attention.launches,
                           "K5": mips_kernel.scaled_launches, "K6": rescore.launches,
                           "F1": fused_bert.launches("F1"),
                           "F2": fused_bert.launches("F2")}

    em, wall_eval, launches_eval = counted(["eval-qa", *qa_args, "--predict-file",
                                            p("qa_eval.jsonl"), "--save-pred", p("pred.jsonl")])
    ans, wall_answer, launches_answer = counted(["answer", *qa_args, *question])
    ans8, wall_int8, launches_int8 = counted(["answer", *qa_args, *question, "--int8-index"])
    launches = {"eval-qa": launches_eval, "answer": launches_answer,
                "answer --int8-index": launches_int8}
    log(f"kernel launches on the QA path: {json.dumps(launches)}")
    for name in ("K1", "K2", "K6", "F1", "F2"):
        check(launches_eval[name] > 0, f"{name} was not launched by eval-qa")
    for name in ("F1", "F2"):
        check(launches_answer[name] > 0, f"{name} was not launched by answer")
    check(launches_int8["K5"] > 0, "K5 was not launched by answer --int8-index")
    check(set(em) == {"em"} and 0.0 <= em["em"] <= 1.0, f"eval-qa: {em}")
    with open(p("pred.jsonl")) as f:
        preds = [json.loads(line) for line in f if line.strip()]
    check(len(preds) == n_q, f"eval-qa --save-pred: {len(preds)} rows, not {n_q}")
    check(all(set(r) == {"question", "para", "answer", "rank_score", "span_score", "gold",
                         "alpha", "em"} for r in preds), "eval-qa --save-pred: bad row keys")
    cand_keys = {"answer", "score", "span_score", "rank_score", "passage"}
    for name, row in (("answer", ans), ("answer --int8-index", ans8)):
        check(set(row) == {"question", "answer", "alpha", "candidates"} and
              len(row["candidates"]) == 3 and
              all(set(c) == cand_keys and math.isfinite(c["score"]) for c in row["candidates"]),
              f"{name}: bad row {str(row)[:300]}")
    log(f"eval-qa: {json.dumps(em)} over {n_q} questions ({wall_eval:.2f} s wall, weights "
        f"and index loading included); answer {wall_answer:.2f} s, --int8-index "
        f"{wall_int8:.2f} s; answer: {ans['answer']!r}")

    # the same objects the CLI builds, driven piece by piece; the int8 index
    # as answer --int8-index loads it
    trainer, make_sampler = _qa_setup(build_parser().parse_args(
        ["eval-qa", *qa_args, "--predict-file", p("qa_eval.jsonl")]))
    sampler = make_sampler(p("qa_eval.jsonl"))
    enc, index = trainer.query_encoder(), sampler.index
    index8 = DenseIndex.load(p("index"), device=device, dtype="int8")
    sampler8 = OnlineSampler(sampler.qa_data, sampler.tokenizer, sampler.db, index8, sampler.cfg)
    row_scales = quant.expand_scales(index8.scales, index8.quant_block, index8.embeddings.shape[0])
    questions = [qa["question"] for qa in sampler.qa_data]
    # answer's one question (padded to the group of 8 by the search), then
    # eval-qa's 32 groups of 8
    groups = [[question[1]]] + [questions[s:s + qpb] for s in range(0, n_q, qpb)]

    def encode(group):
        """The group's query embeddings as _retrieve makes them: the group
        padded to qpb rows (pad rows attend [CLS] only), encoded, cut back
        (the query tower's bf16 sums depend on the row count)."""
        ids = pad_to([sampler.tokenizer.encode(q, max_length=tq) for q in group], tq)
        nq = ids.shape[0]
        ids = np.concatenate([ids, np.zeros((qpb - nq, tq), ids.dtype)])
        mask = (ids != 0).astype(np.int32)
        mask[nq:, 0] = 1
        return enc(ids, mask)[:nq]

    bad, bad8, k1_err, k5_err = 0, 0, 0.0, 0.0
    for gi, group in enumerate(groups):
        emb = encode(group)
        qt = emb.to(torch.bfloat16)
        for name, idx, smp in (("bf16", index, sampler), ("int8", index8, sampler8)):
            vals, rows = idx.search(emb, k, q_pad=qpb)
            _, srows, _ = smp._retrieve(group, enc, candidates=k, pad_rows=qpb)
            check(np.array_equal(srows, rows), f"{name} sampler group {gi}: rows differ from "
                                               "its search")
            scales = row_scales if idx is index8 else None
            rv, ri = mips.mips_topk_reference(qt, idx.embeddings, k, n_valid=idx.n,
                                              scales=scales)
            n_bad = topk_disagreements(vals, srows, rv.cpu().numpy(), ri.cpu().numpy(),
                                       atol=TOPK_TOL)
            if idx is index8:
                bad8 += n_bad
            else:
                bad += n_bad
        if gi <= 1:  # K1 and K5 at the shapes these searches gave them
            q8 = mips.pad_rows(qt, qpb)
            block = mips.envelope_block(index.embeddings.shape[0], 256)
            corpus = mips.pad_rows(index.embeddings, mips_kernel.GROUP * block)
            got = mips_kernel.block_maxima_grouped(q8, corpus, block=block)
            want = mips_kernel.block_maxima_grouped_reference(q8, corpus, block=block)
            k1_err = max([k1_err] + [(a - b).abs().max().item() for a, b in zip(got, want)])
            check_hopper_route("the QA path's K5", q8, index8.embeddings, index8.quant_block)
            got = mips_kernel.block_maxima_grouped(q8, index8.embeddings,
                                                   block=index8.quant_block, scales=index8.scales)
            want = mips_kernel.block_maxima_grouped_reference(
                q8, index8.embeddings, block=index8.quant_block, scales=index8.scales)
            k5_err = max([k5_err] + [(a - b).abs().max().item() for a, b in zip(got, want)])
    n_checked = n_q + 1
    check(bad == 0, f"sampler: {bad} of {n_checked} questions' top-{k} disagree with the exact "
                    "search")
    check(bad8 == 0, f"int8 sampler: {bad8} of {n_checked} questions' top-{k} disagree with the "
                     "exact search of its codes")
    check(k1_err <= BMAX_TOL, f"K1 at the QA search's shapes: max abs err {k1_err} > {BMAX_TOL}")
    check(k5_err <= BMAX_TOL, f"K5 at the int8 QA search's shapes: max abs err {k5_err} > "
                              f"{BMAX_TOL}")
    qb8 = index8.quant_block
    del index8, sampler8

    # K2 at the reader's shapes, on one batch
    batches = iter(sampler.eval_load(enc, k, qpb))
    dev = trainer._device_batch(next(batches)["net_input"])
    cfg = trainer.cfg
    rows_mask = dev["input_mask"].reshape(-1, t).to(torch.int32)
    g = torch.Generator(device=device).manual_seed(10)
    q, kk, v = (torch.randn(rows_mask.shape[0], cfg.num_heads, t, cfg.head_dim, device=device,
                            generator=g).bfloat16() for _ in range(3))
    got = attention.fused_attention(q, kk, v, rows_mask, sm_scale=cfg.head_dim ** -0.5)
    want = attention.fused_attention_reference(q, kk, v, rows_mask, sm_scale=cfg.head_dim ** -0.5)
    k2_err = (got.float() - want.float()).abs().max().item()
    check(k2_err <= ATTN_TOL, f"K2 at the reader's shapes: max abs err {k2_err} > {ATTN_TOL}")
    del q, kk, v, got, want
    with torch.inference_mode():
        reader_ms = cuda_ms(lambda: trainer.model(dev), reps=3)

    # the reader with K2 against the vanilla path over READER_BATCHES batches
    # (8 questions, 40 paragraphs each); beside it a lower-precision control,
    # the vanilla logits through one more rounding to float8 e4m3
    vanilla = QAModel(dataclasses.replace(cfg, flash_attention=False), trainer.qcfg)
    vanilla.load_state_dict(trainer.model.state_dict())
    vanilla = vanilla.to(device).eval()
    rel_err, rel_ctrl, n_clear, n_same, n_paras = 0.0, float("inf"), 0, 0, 0
    for bi in range(READER_BATCHES):
        if bi:
            dev = trainer._device_batch(next(batches)["net_input"])
        with torch.inference_mode():
            out_k2, out_v = trainer.model(dev), vanilla(dev)
        in_para = dev["paragraph_mask"] == 1
        keys = ("start_logits", "end_logits")
        scale = max(out_v[key][in_para].abs().max().item() for key in keys)
        err = max((out_k2[key] - out_v[key])[in_para].abs().max().item() for key in keys)
        ctrl = max((out_v[key][in_para].to(torch.float8_e4m3fn).float() -
                    out_v[key][in_para]).abs().max().item() for key in keys)
        rel_err, rel_ctrl = max(rel_err, err / scale), min(rel_ctrl, ctrl / scale)
        check(err <= READER_REL * scale, f"reader with K2 vs vanilla, batch {bi}: span logits "
                                         f"differ by {err} > {READER_REL} x {scale}")
        s_k2, e_k2, _ = decode_spans(out_k2["start_logits"], out_k2["end_logits"])
        s_v, e_v, _ = decode_spans(out_v["start_logits"], out_v["end_logits"])
        margin = SPAN_MARGIN_ERRS * err
        clear = _span_margin(out_v["start_logits"], out_v["end_logits"]) > margin
        same = (s_k2 == s_v) & (e_k2 == e_v)
        check(bool(same[clear].all()), f"reader with K2 vs vanilla, batch {bi}: "
                                       f"{int((~same & clear).sum())} decoded spans differ where "
                                       f"the best leads by > {margin}")
        n_clear, n_same, n_paras = (n_clear + int(clear.sum()), n_same + int(same.sum()),
                                    n_paras + clear.numel())
    del vanilla
    check(rel_ctrl > READER_REL, f"the e4m3 control ({rel_ctrl}) passes the reader's tolerance "
                                 f"{READER_REL}: the check would not see one coarser rounding")

    # rates: the whole predict (retrieve, read, decode, text) on a warm trainer
    t0 = time.perf_counter()
    em_again = trainer.predict(make_sampler(p("qa_eval.jsonl")))
    wall = time.perf_counter() - t0
    check(em_again == em["em"], f"predict on a warm trainer: EM {em_again} != {em['em']}")
    tokens = n_q * k * t
    log(f"QA sampler: all {n_checked} questions' top-{k} agree with the exact search up to "
        f"ties, over the bf16 and the int8 index; K1 at Q={qpb} N={index.embeddings.shape[0]}: "
        f"max_abs_err {k1_err:.3g}; K5 at Q={qpb} N={index.embeddings.shape[0]} (block "
        f"{qb8}): max_abs_err {k5_err:.3g}; K2 at B="
        f"{rows_mask.shape[0]} T={t}: max_abs_err {k2_err:.3g}")
    log(f"reader with K2 vs vanilla over {READER_BATCHES} batches: span logits max abs err "
        f"{rel_err:.4g} of the batch's largest logit (tol {READER_REL}; control, one e4m3 "
        f"rounding of the vanilla logits: {rel_ctrl:.4g}); decoded spans equal on all {n_clear} "
        f"of {n_paras} paragraphs whose best span leads by > {SPAN_MARGIN_ERRS} x the batch's "
        f"error ({n_same} equal in all)")
    log(f"{gpu_line()}: eval-qa predict {n_q} questions in {wall:.3f} s = {n_q / wall:.2f} "
        f"questions/s, {tokens / wall:.0f} reader tokens/s (host clock, padded, retrieval and "
        f"host text work included); one reader batch [{qpb}, {k}, {t}] {reader_ms:.3f} ms = "
        f"{qpb * k * t / reader_ms * 1e3:.0f} reader tokens/s (device, CUDA events)")
    return {"launches": launches, "k1_err": k1_err, "k2_err": k2_err, "k5_err": k5_err,
            "questions_per_s": n_q / wall, "reader_tokens_per_s": tokens / wall}


# --- QA finetuning (finetune-qa) ---------------------------------------------

# k-means: near ties between the card's f32 scores and the CPU's may pick
# other centroids; a differing assignment must be one whose two scores lie
# within this of each other (f32 sums of 128 products of magnitude ~1)
KMEANS_TIE = 1e-4


def write_qa_train_files(root: str, name: str, n_q: int, seed: int) -> tuple[str, str]:
    """n_q distinct questions whose gold answers are every one-word token
    (so a one-word span scores EM 1 and a random reader's EM is above 0),
    and a matched-paragraph file naming every 7th paragraph of the 8,192 gold.
    Returns (questions path, matched path)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gold = [f"tok{w}" for w in range(60)]
    questions = [f"what is about tok{pair // 60} tok{pair % 60}"
                 for pair in rng.choice(60 * 60, n_q, replace=False)]
    qa_path, matched = os.path.join(root, f"{name}.jsonl"), os.path.join(root, f"{name}_gold.jsonl")
    with open(qa_path, "w") as f:
        f.writelines(json.dumps({"question": q, "answer": gold}) + "\n" for q in questions)
    with open(matched, "w") as f:
        for q in questions:
            f.write(json.dumps({"question": q, "matched_paras": {
                f"p{i}": "tok1" for i in range(0, 8192, 7)}}) + "\n")
    return qa_path, matched


def _qa_kernel_checks(device, key_mask, tq: int, qpb: int) -> dict:
    """K2, K3 and K4 at the QA train step's shapes against their plain
    versions, each timed by one call beside its library call and its bound:
    K2/K3 over [B*k, 12, T, 64] bf16 with the batch's key mask at rate 0.1
    (SDPA and its backward at rate 0), K4 at the reader's [B*k, T, 768] bf16
    sites and the query tower's [B, 12, Tq, Tq] f32 probabilities."""
    import torch
    import torch.nn.functional as F

    from proqa_tpu_torch.ops import attention
    from proqa_tpu_torch.ops import dropout as drop

    b, t = key_mask.shape
    h, dh, rate, seed, scale = 12, 64, 0.1, 2**51 + 7, 64 ** -0.5
    g = torch.Generator(device=device).manual_seed(21)
    q, k, v, do = (torch.randn(b, h, t, dh, device=device, generator=g).bfloat16()
                   for _ in range(4))
    out = {}
    got = attention.fused_attention(q, k, v, key_mask, sm_scale=scale, dropout_rate=rate,
                                    seed=seed)
    want = attention.fused_attention_reference(q, k, v, key_mask, sm_scale=scale,
                                               dropout_rate=rate, seed=seed)
    err2 = (got.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(got.float()).all()) and err2 <= ATTN_TOL,
          f"K2 at the QA step's shapes: max abs err {err2} > {ATTN_TOL}")
    got = attention._backward_kernel(q, k, v, key_mask, do, scale, rate, seed)
    want = attention.fused_attention_backward_reference(q, k, v, key_mask, do, sm_scale=scale,
                                                        dropout_rate=rate, seed=seed)
    err3 = max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want))
    check(all(bool(torch.isfinite(a.float()).all()) for a in got) and err3 <= BWD_TOL,
          f"K3 at the QA step's shapes: max abs err {err3} > {BWD_TOL}")
    del got, want
    bias = torch.where(key_mask[:, None, None, :] != 0, 0.0, attention.MASK_BIAS).to(q.dtype)
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias)
    n = b * h * t * dh * 2
    out["K2"] = {"max_abs_err": err2, "shape": [b, h, t, dh],
                 "ms": cuda_ms(lambda: attention.fused_attention(
                     q, k, v, key_mask, sm_scale=scale, dropout_rate=rate, seed=seed)),
                 "plain_ms": cuda_ms(lambda: attention.fused_attention_reference(
                     q, k, v, key_mask, sm_scale=scale, dropout_rate=rate, seed=seed), reps=3),
                 "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=bias))}
    out["K2"]["bound_ms"], out["K2"]["bound_by"] = bound(4 * n + key_mask.numel() * 4,
                                                         4 * b * h * t * t * dh)
    out["K3"] = {"max_abs_err": err3, "shape": [b, h, t, dh],
                 "ms": cuda_ms(lambda: attention._backward_kernel(q, k, v, key_mask, do, scale,
                                                                  rate, seed)),
                 "plain_ms": cuda_ms(lambda: attention.fused_attention_backward_reference(
                     q, k, v, key_mask, do, sm_scale=scale, dropout_rate=rate, seed=seed), reps=3),
                 "library_ms": cuda_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                                                   retain_graph=True))}
    out["K3"]["bound_ms"], out["K3"]["bound_by"] = bound(7 * n + key_mask.numel() * 4,
                                                         10 * b * h * t * t * dh)
    del q, k, v, do, qs, ks, vs, lib_out, bias
    for name, shape, dtype in (("K4", (b, t, 768), torch.bfloat16),
                               ("K4 query probabilities", (qpb, h, tq, tq), torch.float32)):
        x = torch.randn(*shape, device=device, generator=g).to(dtype)
        got = drop.dropout(x, rate, seed=seed)
        check(torch.equal(got, drop.dropout_reference(x, rate, seed=seed)),
              f"{name} {shape}: not bit-equal to its plain version")
        res = {"max_abs_err": 0.0, "shape": list(shape),
               "ms": cuda_ms(lambda: drop.dropout(x, rate, seed=seed), reps=20),
               "plain_ms": cuda_ms(lambda: drop.dropout_reference(x, rate, seed=seed)),
               "library_ms": cuda_ms(lambda: F.dropout(x, rate, training=True), reps=20)}
        res["bound_ms"], res["bound_by"] = bound(2 * x.numel() * x.element_size(), 0)
        out[name] = res
        del x, got
    for name, res in out.items():
        log(f"{name} at the QA step's shape {res['shape']}: max_abs_err {res['max_abs_err']:.3g}, "
            f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, library "
            f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return out


def _qa_dropout0(device, state: dict, dev: dict, cfg,
                 kernels_route=contextlib.nullcontext) -> dict:
    """The QA step at dropout 0 on four routes (the kernels; vanilla
    attention; the kernels' attention with the plain epilogue chain; vanilla
    in f32) from the same weights and batch: each route's loss and, for
    every gradient tensor that is not zero in exact arithmetic, its cosine
    to the kernels' and the distances from the f32 gradient. The kernels'
    route runs inside `kernels_route()` (qa_dropout0_sweep.py audits F1/F2
    there)."""
    import dataclasses

    import torch

    from proqa_tpu_torch.models.reader import QAConfig, QAModel, qa_loss
    from proqa_tpu_torch.ops import fused_bert

    cfg0 = dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)
    # the kernels' route and the vanilla one in bf16, the kernels' attention
    # with the plain epilogue chain under autograd (no F1/F2), and the vanilla
    # one in f32 on the same weights: the bf16 routes' distance from it is the
    # rounding noise each carries
    routes = {"kernels": dict(flash_attention=True), "vanilla": dict(flash_attention=False),
              "plain chain": dict(flash_attention=True),
              "f32": dict(flash_attention=False, dtype=torch.float32)}
    losses0, grads = {}, {}
    _reset_fused_counts()
    for route, kw in routes.items():
        model = QAModel(dataclasses.replace(cfg0, **kw), QAConfig())
        model.load_state_dict(state)
        model = model.to(device).train()
        counts = _fused_counts()
        chain = fused_bert._eager_chain() if route == "plain chain" else contextlib.nullcontext()
        audited = kernels_route() if route == "kernels" else contextlib.nullcontext()
        with chain, audited:
            loss = qa_loss(model(dev), dev, model.qcfg)["loss"]
            loss.backward()
        if route == "plain chain":
            check(_fused_counts() == counts, "QA dropout-0 step under _eager_chain: F1/F2 ran")
        losses0[route] = loss.item()
        grads[route] = {name: q.grad.float() for name, q in model.named_parameters()
                        if q.grad is not None}
        del model, loss

    def cosine(a, b):
        # no eps: torch's cosine_similarity clamps the product of the norms
        # at 1e-8, which reads tensors of tiny gradient as unrelated
        a, b = a.double().flatten(), b.double().flatten()
        return (a @ b / (a.norm() * b.norm())).item()

    # zero gradient in exact arithmetic, so only rounding noise: the key bias
    # (softmax ignores a constant added to a row), and the span head's bias
    # and the reader's last LayerNorm bias (each shifts every logit of a
    # paragraph's softmax alike)
    exact_zero = (f"bert.layers.{cfg.num_layers - 1}.mlp_ln.bias", "qa_outputs.bias")
    out = {"losses": losses0, "cos": {}, "cos_e": {}, "stats": {}}
    for name, gk in grads["kernels"].items():
        if name.endswith(".k.bias") or name in exact_zero:
            continue
        gv, ge, g32 = grads["vanilla"][name], grads["plain chain"][name], grads["f32"][name]
        out["cos"][name] = cosine(gk, gv)
        out["cos_e"][name] = cosine(gk, ge)
        out["stats"][name] = {"cos_k32": cosine(gk, g32), "cos_v32": cosine(gv, g32),
                              "cos_e32": cosine(ge, g32), "norm": g32.norm().item(),
                              "err_k": (gk - g32).double().norm().item(),
                              "err_v": (gv - g32).double().norm().item(),
                              "err_e": (ge - g32).double().norm().item()}
    st = out["stats"]
    out["ratio"] = {n: s["err_k"] / s["err_v"] for n, s in st.items()}
    out["ratio_e"] = {n: s["err_k"] / s["err_e"] for n, s in st.items()}
    return out


def phase_qa_train(device, root: str) -> dict:
    """The QA train step at full width on phase_cli's retrieval world: a
    BERT-base reader and retriever (phase_cli's weights, the index's) in
    bf16 with remat, fused attention, dropout 0.1 and qa_drop 0.1, one batch
    of 4 questions x 5 paragraphs at T = 512 (queries T = 30) and 5,000
    candidates a question gathered from the device index (para_rows), made
    by the online sampler's train load. 20 steps on it: the loss must fall,
    and K2, K3 and K4 must launch; then a dropout-0 step with the kernels
    against the vanilla attention path (gradient cosine, and where that is
    under GRAD_COS, each route's distance from the vanilla f32 gradient),
    and K2, K3, K4 at these shapes against their plain versions."""
    import numpy as np
    import torch

    from proqa_tpu_torch.data.collate import batch_pad
    from proqa_tpu_torch.data.docdb import DocDB
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.convert import load_params
    from proqa_tpu_torch.models.reader import QAConfig
    from proqa_tpu_torch.ops import attention, dropout
    from proqa_tpu_torch.qa.sampler import OnlineSampler, OnlineSamplerConfig
    from proqa_tpu_torch.text.wordpiece import BertTokenizer
    from proqa_tpu_torch.train.qa_trainer import QATrainer, QATrainerConfig

    p = lambda name: os.path.join(root, name)  # noqa: E731
    qpb, k, t, tq, m, steps = 4, 5, 512, 30, 5000, 20
    cfg = BertConfig(remat=True, flash_attention=True)  # bf16, dropout 0.1
    trainer = QATrainer(cfg, QAConfig(qa_drop=0.1), QATrainerConfig(
        questions_per_batch=qpb, train_k=k, learning_rate=1e-4, seed=13,
        output_dir=p("qa_train_run")), device=device)
    trainer.model.retriever.load_state_dict(load_params(p("retriever.npz")))
    qa_path, matched = write_qa_train_files(root, "qa_train", qpb, seed=14)
    index = DenseIndex.load(p("index"), device=device)
    sampler = OnlineSampler(qa_path, BertTokenizer.from_vocab_file(p("vocab.txt")),
                            DocDB(p("docs.db")), index,
                            OnlineSamplerConfig(max_query_length=tq, max_length=t, candidates=m,
                                                question_batch=qpb, exact_search=True), matched)
    batch = next(iter(sampler.load(trainer.query_encoder(), k, qpb)))
    net, rows = batch_pad(batch["net_input"], qpb)
    net["question_mask"] = (np.arange(qpb) < rows).astype(np.int32)
    check(net["input_ids"].shape == (qpb, k, t) and net["para_rows"].shape == (qpb, m),
          f"QA train batch: {net['input_ids'].shape}, {net['para_rows'].shape}")
    check(int(net["top5000_labels"].sum()) > 0, "QA train batch: no gold among the candidates")
    trainer.set_corpus(index)
    trainer._train_step(dict(net))  # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.launches = attention.backward_launches = dropout.launches = 0
    _reset_fused_counts()
    losses, walls = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        comp = trainer._train_step(dict(net))
        losses.append(float(comp["loss"]))  # synchronises
        walls.append(time.perf_counter() - t0)
    launches = {"K2": attention.launches, "K3": attention.backward_launches,
                "K4": dropout.launches, **_fused_counts()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = statistics.median(walls) * 1e3
    tokens = qpb * k * t
    log(f"{gpu_line()}: QA train step BERT-base reader + retriever bf16 remat flash dropout 0.1 "
        f"qa_drop 0.1, {qpb} x {k} x {t} reader tokens, queries {qpb} x {tq}, {m} candidates a "
        f"question: losses {losses[0]:.4f} -> {losses[-1]:.4f}; {step_ms:.1f} ms per step "
        f"(median of {steps}, p25 {np.percentile(walls, 25) * 1e3:.1f}, p75 "
        f"{np.percentile(walls, 75) * 1e3:.1f}; host clock, synchronised), "
        f"{tokens / step_ms * 1e3:.0f} reader tokens/s, peak {peak:.2f} GiB; launches in "
        f"{steps} steps: {json.dumps(launches)}")
    check(all(math.isfinite(x) for x in losses), f"QA train step: non-finite loss {losses}")
    check(losses[-1] < losses[0] - LOSS_DROP,
          f"QA train step: loss {losses[0]} -> {losses[-1]} did not fall by {LOSS_DROP}")
    check(all(n > 0 for n in launches.values()), f"QA train step: a kernel never ran {launches}")

    # dropout 0: K2/K3 against the vanilla attention path, same weights, the
    # batch's first two questions, candidates gathered as the step gathers them
    dev = trainer._device_batch({key: v[:2] for key, v in net.items()})
    dev["para_embed"] = index.gather(dev.pop("para_rows"))
    key_mask = dev["input_mask"].reshape(-1, t).to(torch.int32)
    state = trainer.model.state_dict()
    del trainer, sampler
    torch.cuda.empty_cache()
    res = _qa_dropout0(device, state, dev, cfg)
    del state, dev
    _check_qa_dropout0(res)
    torch.cuda.empty_cache()
    kernels = _qa_kernel_checks(device, key_mask.repeat(2, 1), tq, qpb)
    return {"step_ms": step_ms, "peak_gib": peak, "launches": launches, "losses": losses,
            "min_grad_cos": min(res["cos"].values()),
            "min_grad_cos_plain_chain": min(res["cos_e"].values()), "kernels": kernels}


def _check_qa_dropout0(res: dict) -> None:
    """Logs and holds _qa_dropout0's readings: every gradient at cosine >=
    GRAD_COS to the vanilla route and to the plain chain, or else the
    kernels' distance from the f32 gradient at most GRAD_NOISE times that
    route's."""
    cos, cos_e, ratio, ratio_e = res["cos"], res["cos_e"], res["ratio"], res["ratio_e"]
    stats, losses0 = res["stats"], res["losses"]
    # where the two bf16 gradients part below GRAD_COS, the f32 one decides
    bad = [n for n in cos if cos[n] < GRAD_COS and not ratio[n] <= GRAD_NOISE]
    bad_e = [n for n in cos_e if cos_e[n] < GRAD_COS and not ratio_e[n] <= GRAD_NOISE]
    worst_e = sorted(cos_e, key=cos_e.get)[:3]
    far_e = max(ratio_e, key=ratio_e.get)
    log(f"QA dropout-0 step, F1/F2 and their backward kernels vs the plain chain (both with "
        f"K2/K3; F1/F2 launches {json.dumps(_fused_counts())}): loss {losses0['kernels']:.6f} "
        f"vs {losses0['plain chain']:.6f}; lowest gradient cosines (|kernels - f32| / "
        f"|plain chain - f32|): "
        + ", ".join(f"{n} {cos_e[n]:.6f} ({ratio_e[n]:.3f})" for n in worst_e)
        + f"; largest error ratio {ratio_e[far_e]:.3f} ({far_e}: cosine {cos_e[far_e]:.6f}, "
        f"|kernels - f32| {stats[far_e]['err_k']:.4g}, |plain chain - f32| "
        f"{stats[far_e]['err_e']:.4g}, |f32| {stats[far_e]['norm']:.4g}, plain chain-f32 cosine "
        f"{stats[far_e]['cos_e32']:.6f}); tol: cosine {GRAD_COS}, else error ratio {GRAD_NOISE}")
    check(not bad_e, f"QA dropout-0 gradients, kernels vs the plain chain: {len(bad_e)} tensors "
                     f"under cosine {GRAD_COS} with the kernels' error from the f32 gradient "
                     f"over {GRAD_NOISE}x the plain chain's, e.g. {bad_e[:3]}")
    worst = sorted(cos, key=cos.get)[:5]
    far = max(ratio, key=ratio.get)
    log(f"QA dropout-0 step, kernels vs vanilla attention vs vanilla f32: loss "
        f"{losses0['kernels']:.6f} vs {losses0['vanilla']:.6f} vs {losses0['f32']:.6f}; lowest "
        f"gradient cosines kernels-vanilla over {len(cos)} tensors (kernels-f32, vanilla-f32, "
        f"|f32 grad|, |kernels - f32| / |vanilla - f32|): "
        + ", ".join(f"{n} {cos[n]:.6f} ({stats[n]['cos_k32']:.6f}, {stats[n]['cos_v32']:.6f}, "
                    f"{stats[n]['norm']:.3g}, {ratio[n]:.3f})" for n in worst)
        + f"; largest error ratio {ratio[far]:.3f} ({far}, cosine {cos[far]:.6f}); tol: cosine "
        f"{GRAD_COS}, else error ratio {GRAD_NOISE}")
    first = (bad or worst)[0]
    check(not bad, f"QA dropout-0 gradients: {len(bad)} tensors under cosine {GRAD_COS} with the "
                   f"kernels' error from the f32 gradient over {GRAD_NOISE}x vanilla's, e.g. "
                   f"{first}: cosine {cos[first]}, error ratio {ratio[first]}")


def phase_finetune_cli(device, root: str, pretrain_root: str) -> dict:
    """finetune-qa through the CLI on phase_cli's retrieval world: random
    BERT-base weights with the retriever of phase_pretrain_cli's
    checkpoint_last.pt, 16 questions, 4 a step, 5 paragraphs at T = 512,
    5,000 candidates, evals every 2 steps and at the epoch end, the counters
    reset before and read after; then --resume from checkpoint_last.pt for a
    second epoch, and eval-qa from the best-model.pt training wrote."""
    import torch

    from proqa_tpu_torch.ops import attention, dropout, mips_kernel, rescore

    p = lambda name: os.path.join(root, name)  # noqa: E731
    qa_path, matched = write_qa_train_files(root, "qa_ft", 16, seed=15)
    run = p("ft_run")
    common = ["--vocab", p("vocab.txt"), "--db", p("docs.db"), "--index", p("index"),
              "--device", str(device), "--max-seq-length", "512", "--eval-k", "5",
              "--questions-per-batch", "4", "--output-dir", run, "--predict-file", qa_path]
    args = ["finetune-qa", *common, "--train-file", qa_path, "--matched-para-path", matched,
            "--retriever-path", os.path.join(pretrain_root, "run", "checkpoint_last.pt"),
            "--train-batch-size", "5", "--candidates", "5000", "--eval-period", "2",
            "--learning-rate", "1e-5", "--qa-drop", "0.1", "--seed", "16"]
    attention.launches = attention.backward_launches = dropout.launches = 0
    mips_kernel.launches = rescore.launches = 0
    _reset_fused_counts()
    walls = {}
    trained, walls["finetune-qa"] = run_cli([*args, "--num-train-epochs", "1"])
    launches = {"K1": mips_kernel.launches, "K2": attention.launches,
                "K3": attention.backward_launches, "K4": dropout.launches,
                "K6": rescore.launches, **_fused_counts()}
    log(f"kernel launches during finetune-qa: {json.dumps(launches)}")
    check(all(n > 0 for n in launches.values()), f"a kernel never ran on finetune-qa {launches}")
    check(set(trained) == {"best_em"} and 0.0 <= trained["best_em"] <= 1.0,
          f"finetune-qa: {trained}")
    with open(os.path.join(run, "trainer_meta.json")) as f:
        meta = json.load(f)
    step1 = torch.load(os.path.join(run, "checkpoint_last.pt"), map_location="cpu",
                       weights_only=True)["step"]
    check(meta["epoch"] == 1 and step1 == 4, f"finetune-qa: meta {meta}, step {step1}")
    resumed, walls["finetune-qa --resume"] = run_cli(
        [*args, "--num-train-epochs", "2", "--resume", os.path.join(run, "checkpoint_last.pt")])
    with open(os.path.join(run, "trainer_meta.json")) as f:
        meta = json.load(f)
    step2 = torch.load(os.path.join(run, "checkpoint_last.pt"), map_location="cpu",
                       weights_only=True)["step"]
    check(meta["epoch"] == 2 and step2 == 2 * step1 and resumed["best_em"] >= trained["best_em"],
          f"finetune-qa --resume: {resumed}, meta {meta}, step {step2}")
    best = os.path.join(run, "best-model.pt")
    check(os.path.exists(best), "finetune-qa wrote no best-model.pt")
    em, walls["eval-qa"] = run_cli(["eval-qa", *common, "--init-checkpoint", best])
    check(em == {"em": resumed["best_em"]},
          f"eval-qa from best-model.pt: {em}, training's best {resumed['best_em']}")
    log(f"finetune-qa: {json.dumps(trained)} after {step1} steps, --resume {json.dumps(resumed)} "
        f"after {step2}; eval-qa from best-model.pt {json.dumps(em)}; wall seconds "
        f"{json.dumps(walls)}")
    return launches


def phase_kmeans(device) -> dict:
    """k-means at the reference's settings (10,000 centroids,
    max_points_per_centroid 1,000; retrieval/group_paras.py:57-59) over
    2,097,152 x 128 f32 embeddings made on the card from a seed, KMEANS_NITER
    Lloyd iterations; seconds per Lloyd iteration beside the f32 FMA bound, and
    the assignments of 8,192 sampled rows against assign_clusters run on the
    CPU (its plain version)."""
    import torch

    from proqa_tpu_torch.ops import kmeans

    n, d, k, niter = 2_097_152, 128, 10_000, KMEANS_NITER
    log(f"k-means: niter {niter}, the reference's 250 (no cut)")
    g = torch.Generator(device=device).manual_seed(17)
    centers = torch.randn(4 * k, d, device=device, generator=g)
    data = centers[torch.randint(0, 4 * k, (n,), device=device, generator=g)]
    data += 0.5 * torch.randn(n, d, device=device, generator=g)
    del centers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = kmeans.kmeans(torch.Generator().manual_seed(18), data, k, niter=niter,
                        max_points_per_centroid=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    chunk = min(1 << 16, max(1024, (1 << 26) // k))
    iter_ms = cuda_ms(lambda: kmeans._lloyd_iter(data, res.centroids, k=k, spherical=False,
                                                 chunk=chunk), reps=3)
    bms, by = bound(n * d * 4 + 2 * k * d * 4, 2.0 * n * k * d, PEAK_F32_FLOPS)
    check(res.assignments.shape == (n,) and bool(torch.isfinite(res.centroids).all()),
          "k-means: bad result")
    used = int(torch.bincount(res.assignments.long(), minlength=k).gt(0).sum())
    sample = torch.randperm(n, generator=torch.Generator().manual_seed(19))[:8192]
    want, _ = kmeans.assign_clusters(data[sample.to(device)].cpu(), res.centroids.cpu())
    got = res.assignments[sample.to(device)].cpu()
    differ = (got != want).nonzero().flatten()
    gap = 0.0
    if len(differ):
        x = data[sample[differ].to(device)].cpu().double()
        sc = kmeans._chunk_scores(x, res.centroids.cpu().double(), False)
        gap = (sc.gather(1, want[differ, None].long()) -
               sc.gather(1, got[differ, None].long())).abs().max().item()
    check(gap <= KMEANS_TIE, f"k-means: {len(differ)} of 8,192 sampled assignments differ from "
                             f"the CPU's by {gap} > {KMEANS_TIE}")
    log(f"{gpu_line()}: k-means {n} x {d} f32, k={k}, max_points_per_centroid 1000, niter "
        f"{niter}: {wall:.2f} s in all ({used} clusters used, objective "
        f"{float(res.objective):.4f}), one Lloyd iteration {iter_ms / 1e3:.4f} s (CUDA events) "
        f"against a bound of {bms / 1e3:.4f} s ({by}, f32 FMA rate), peak {peak:.2f} GiB; "
        f"8,192 sampled assignments against the CPU's: {len(differ)} differ, all within "
        f"{KMEANS_TIE} (largest score gap {gap:.3g})")
    return {"seconds": wall, "iter_ms": iter_ms, "bound_ms": bms, "peak_gib": peak,
            "differ": len(differ)}


def phase_cluster_cli(device, root: str) -> dict:
    """On phase_pretrain_cli's world: build-index over the pairs' paragraphs
    from its checkpoint_last.pt, cluster-corpus into 3 shards, and
    pretrain-retriever reading those shards (contexts of T = 256: K2, K3,
    K4), the counters reset before and read after."""
    from proqa_tpu_torch.ops import attention, dropout

    p = lambda name: os.path.join(root, name)  # noqa: E731
    seq = ["--vocab", p("vocab.txt"), "--max-seq-length", "286", "--max-query-length", "30",
           "--device", str(device)]
    attention.launches = attention.backward_launches = dropout.launches = 0
    _reset_fused_counts()
    walls = {}
    built, walls["build-index"] = run_cli([
        "build-index", *seq, "--corpus", p("pairs.jsonl"),
        "--init-checkpoint", p("run/checkpoint_last.pt"), "--output-dir", p("pair_index"),
        "--predict-batch-size", "96"])
    clustered, walls["cluster-corpus"] = run_cli([
        "cluster-corpus", "--embeddings", p("pair_index/embeddings.npy"), "--pairs",
        p("pairs.jsonl"), "--output-dir", p("pair_splits"), "--ncentroids", "3", "--niter", "5",
        "--device", str(device)])
    trained, walls["pretrain-retriever"] = run_cli([
        "pretrain-retriever", *seq, "--train-file", p("pair_splits"),
        "--predict-file", p("pairs.jsonl"), "--output-dir", p("run_phase2"),
        "--train-batch-size", "8", "--predict-batch-size", "32", "--num-train-epochs", "1",
        "--eval-period", "1000", "--learning-rate", "1e-4",
        "--init-checkpoint", p("run/checkpoint_last.pt")])
    launches = {"K2": attention.launches, "K3": attention.backward_launches,
                "K4": dropout.launches, **_fused_counts()}
    shards = sorted(os.listdir(p("pair_splits")))
    lines = 0
    for name in shards:
        with open(os.path.join(p("pair_splits"), name)) as f:
            lines += sum(1 for _ in f)
    log(f"build-index over the pairs -> cluster-corpus -> pretrain-retriever on its shards: "
        f"{json.dumps(clustered)}; {len(shards)} shards, {lines} pairs; launches "
        f"{json.dumps(launches)}; wall seconds {json.dumps(walls)}")
    check(built["rows"] == 96 and clustered["shards"] == len(shards) >= 2 and lines == 96,
          f"cluster-corpus: {clustered}, {len(shards)} shards of {lines} pairs")
    check(0.0 <= trained["best_in_batch_acc"] <= 1.0, f"pretrain-retriever on shards: {trained}")
    check(all(n > 0 for n in launches.values()), f"a kernel never ran on the shards' "
                                                 f"pretraining {launches}")
    return launches


# --- serving: the streaming index writer, live index updates, serve, IVF -----

STREAM_CHUNK = 3000  # rows a streamed chunk over the 8,192-row world: a ragged last chunk
# the streamed build's rows against the in-memory build's (f32 embeddings of
# a BERT-base bf16 encoder with random weights, entries of magnitude ~0.5): a
# row meets other rows in its batch, padded to another bucket length, and
# bf16 sums follow the batch's shape. An H100 read 0.0125 (about 6 bf16 ulps
# at 0.5), and the in-memory encode of one chunk alone differed from the
# whole build as much
STREAM_TOL = 0.025
SERVE_QUESTIONS = 16  # lone /answer requests; also the burst size and --max-batch
SERVE_BURSTS = 4


def phase_stream_cli(device, root: str, recall: dict) -> dict:
    """build-index --stream-chunk on phase_cli's world, K2's launches
    counted: the same idx_id.json as the in-memory build; the ragged last
    chunk's rows bit-equal to an in-memory encode of those rows alone (the
    same batches: the streamed writer moves rows, never changes them), and
    the first chunk's too; every row within STREAM_TOL of the in-memory
    build of the whole corpus (bf16 sums differ with the batch shapes around
    a row); both recall JSONs printed (the random-weight embeddings crowd, so
    that error reorders their near-tied scores); rows/s and the growth of
    the host's peak RSS."""
    import resource

    import numpy as np

    from proqa_tpu_torch.cli.main import _bert_cfg, _load_model, _tokenizer, build_parser
    from proqa_tpu_torch.data.datasets import EncodeDataset
    from proqa_tpu_torch.index.build import encode_corpus
    from proqa_tpu_torch.ops import attention

    p = lambda name: os.path.join(root, name)  # noqa: E731
    argv = ["build-index", "--vocab", p("vocab.txt"), "--init-checkpoint", p("retriever.npz"),
            "--device", str(device), "--predict-batch-size", "512", "--corpus",
            p("corpus.jsonl"), "--output-dir", p("index_stream"), "--stream-chunk",
            str(STREAM_CHUNK)]
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    attention.launches = 0
    built, wall = run_cli(argv)
    k2 = attention.launches
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    check(k2 > 0, "K2 was not launched by the streamed build-index")
    mem = np.load(p("index/embeddings.npy"))
    streamed = np.load(p("index_stream/embeddings.npy"))
    n = mem.shape[0]
    check(built == {"rows": n, "dim": 128, "saved": p("index_stream")}, f"stream build: {built}")
    with open(p("index/idx_id.json"), "rb") as a, open(p("index_stream/idx_id.json"), "rb") as b:
        check(a.read() == b.read(), "stream build: idx_id.json differs from the in-memory build's")
    # the first chunk and the ragged last one, each encoded in memory on its
    # own: the same batches as the streamed build's, so the same bits
    args = build_parser().parse_args(argv)
    model = _load_model(args, _bert_cfg(args, flash_default=True))
    last = (n - 1) // STREAM_CHUNK * STREAM_CHUNK
    with open(p("corpus.jsonl")) as f:
        lines = f.readlines()
    batching = 0.0
    for lo, hi in ((0, STREAM_CHUNK), (last, n)):
        with open(p("chunk.jsonl"), "w") as out:
            out.writelines(lines[lo:hi])
        chunk = encode_corpus(model, EncodeDataset(_tokenizer(args), p("chunk.jsonl"),
                                                   max_length=args.max_seq_length),
                              batch_size=args.predict_batch_size)
        check(np.array_equal(chunk, streamed[lo:hi]), f"stream build: rows {lo}-{hi - 1} "
                                                       "differ from an in-memory encode of them")
        # the same rows, encoded in memory in other batches, differ as much
        batching = max(batching, float(np.abs(chunk - mem[lo:hi]).max()))
    del model, lines
    err = float(np.abs(streamed - mem).max())
    unequal = int((streamed != mem).any(axis=1).sum())
    check(np.isfinite(streamed).all() and err <= STREAM_TOL,
          f"stream build: rows differ from the in-memory build's by {err} > {STREAM_TOL}")
    got, _ = run_cli(["eval-retrieval", p("qa.jsonl"), p("index_stream"), p("q.npy"),
                      p("docs.db"), "--topk", "80", "--device", str(device)])
    log(f"build-index --stream-chunk {STREAM_CHUNK}: {n} rows in {wall:.2f} s = "
        f"{n / wall:.1f} rows/s (wall, weights and saving included); the first chunk and the "
        f"last (rows {last}-{n - 1}) bit-equal to their in-memory encodes, which differ from "
        f"the in-memory build of the whole corpus by up to {batching:.3g} (batches of other "
        f"rows); the streamed rows against that build: max abs err {err:.3g} (tol "
        f"{STREAM_TOL}), {unequal} of {n} rows not bit-equal; recall {json.dumps(got)} (in-memory "
        f"{json.dumps(recall)}: the random-weight scores lie closer than that error); host "
        f"peak RSS grew by {(rss1 - rss0) / 1024:.1f} MiB (to {rss1 / 1024:.1f} MiB); K2 "
        f"launched {k2} times")
    return {"K2": k2, "rows_per_s": n / wall, "max_abs_err": err}


def _sync_ms(fn):
    """(fn(), host ms around it), synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _own_exact(index, queries, k: int):
    """The exact top-k of the index's own rows (int8: codes times block
    scales) with the tombstoned rows excluded: what a search must return."""
    from proqa_tpu_torch.ops import mips, quant

    nd = index.n_deleted
    row_scales = (None if index.scales is None else
                  quant.expand_scales(index.scales, index.quant_block, index.embeddings.shape[0]))
    v, i = mips.mips_topk_reference(queries.to(index._query_dtype), index.embeddings, k + nd,
                                    n_valid=index.n, scales=row_scales)
    v, i = v.cpu().numpy(), i.cpu().numpy()
    return index._filter_deleted(v, i, k) if nd else (v[:, :k], i[:, :k])


def _tombstone_search(index, queries, k: int, label: str, times: dict) -> None:
    """index.search at Q = 8 and at all the queries, timed (host ms), held to
    the exact search of the index's own rows (Q = 8 and the first 256) up to
    ties; then compact(), timed (s). A bf16 index's search must also equal
    the compacted index's (rows mapped back through the survivors); an int8
    compaction requantizes the survivors in new blocks, so its scores differ
    by up to a quantization step and only its row count is held."""
    import numpy as np

    from proqa_tpu_torch.testing import topk_disagreements

    k_fetch = min(index.n, 1 << (k + index.n_deleted - 1).bit_length())
    live = {}
    for nq in (8, queries.shape[0]):
        live[nq], times[f"{label}: search Q={nq} ms"] = _sync_ms(
            lambda: index.search(queries[:nq], k))
        vals, rows = live[nq]
        check(not np.isin(rows, index._deleted).any(), f"{label}: a tombstoned row came back")
        m = min(nq, 256)
        bad = topk_disagreements(vals[:m], rows[:m], *_own_exact(index, queries[:m], k),
                                 atol=TOPK_TOL)
        check(bad == 0, f"{label} (k_fetch {k_fetch}): {bad} of {m} queries disagree with the "
                        "exact search of the index's own rows")
    comp, ms = _sync_ms(index.compact)
    times[f"{label}: compact s"] = ms / 1e3
    check(len(comp) == comp.n == len(index), f"{label}: compact() kept {comp.n} rows")
    if index.scales is None:
        keep = np.setdiff1d(np.arange(index.n), index._deleted)
        for nq, (vals, rows) in live.items():
            cv, ci = comp.search(queries[:nq], k)
            bad = topk_disagreements(vals, rows, cv, keep[ci], atol=TOPK_TOL)
            check(bad == 0, f"{label} (k_fetch {k_fetch}): {bad} of {nq} queries disagree "
                            "with the compacted index's search")
    log(f"{label}: {index.n_deleted} tombstones, k_fetch {k_fetch}: the top-{k} at Q=8 and "
        f"Q={queries.shape[0]} equal the exact search of the index's own rows up to ties"
        + (" and the compacted index's" if index.scales is None else ""))


def phase_index_updates(device) -> dict:
    """Live updates on phase_mips's corpus, bf16 then int8: an index of all
    but 1,000 rows (its capacity the full corpus), 256 rows added within the
    capacity, 1,024 more that grow it by 1.5x, the exact top-80 over the
    grown index's own rows at Q = 256; then 600 tombstones (k_fetch 1,024)
    and 400 more (1,000: k_fetch 2,048), each searched at Q = 8 and 2,048
    against that exact search and, for bf16, compact()'s search. Times, peak
    memory, the K1/K5/K6 counters, and K5's Hopper route after growth."""
    import numpy as np
    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.ops import mips, mips_kernel, rescore
    from proqa_tpu_torch.testing import topk_disagreements

    corpus, queries = bf16_corpus(device)
    n, spare, k = corpus.shape[0], 1000, 80
    n0 = n - spare
    host = corpus.float().cpu().numpy()  # the int8 build quantizes on the host
    del corpus
    fresh = (np.random.default_rng(32).standard_normal((1024 - (spare - 256), 128))
             / 128 ** 0.5).astype(np.float32)
    adds = (host[n0:n0 + 256], np.concatenate([host[n0 + 256:], fresh]))
    out = {}
    for label, dtype in (("bf16", torch.bfloat16), ("int8", "int8")):
        times = {}
        index, ms = _sync_ms(lambda: DenseIndex.from_embeddings(host[:n0], device=device,
                                                                 dtype=dtype))
        times["build s"] = ms / 1e3
        cap0 = index.embeddings.shape[0]
        mips_kernel.launches = mips_kernel.scaled_launches = rescore.launches = 0
        _, times["add 256 ms"] = _sync_ms(lambda: index.add(adds[0]))
        check(index.embeddings.shape[0] == cap0 == n, f"{label}: the first add grew the index")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, times["add 1024 (growth) ms"] = _sync_ms(lambda: index.add(adds[1]))
        peak = torch.cuda.max_memory_allocated()
        cap = index.embeddings.shape[0]
        check(cap == cap0 + cap0 // 2 and index.n == n + 280 and index.version == 2,
              f"{label}: capacity {cap0} -> {cap}, n {index.n}, version {index.version}")
        check(not index.embeddings[index.n:].any(), f"{label}: the capacity tail is not zero")
        if index.scales is not None:
            check(index.quant_block == mips.envelope_block(n0 + (-n0) % 1024),
                  f"int8: quant block {index.quant_block} changed")
            check_hopper_route("K5 after growth", queries[:8].bfloat16(), index.embeddings,
                               index.quant_block)
        # the grown index against the exact search of its own rows
        for nq in (8, queries.shape[0]):
            (vals, rows), times[f"search Q={nq} ms"] = _sync_ms(
                lambda: index.search(queries[:nq], k))
        bad = topk_disagreements(vals[:256], rows[:256], *_own_exact(index, queries[:256], k),
                                 atol=TOPK_TOL)
        check(bad == 0, f"{label}: {bad} of 256 queries disagree with the exact top-{k} "
                        "after the adds")
        rng = np.random.default_rng(33)
        first = rng.choice(index.n, 600, replace=False)
        _, times["remove 600 ms"] = _sync_ms(lambda: index.remove_rows(first))
        _tombstone_search(index, queries, k, f"{label}, 600 removed", times)
        more = rng.choice(np.setdiff1d(np.arange(index.n), index._deleted), 400, replace=False)
        _, times["remove 400 more ms"] = _sync_ms(lambda: index.remove_rows(more))
        _tombstone_search(index, queries, k, f"{label}, 1,000 removed", times)
        launches = {"K1": mips_kernel.launches, "K5": mips_kernel.scaled_launches,
                    "K6": rescore.launches}
        for name in (("K5",) if label == "int8" else ("K1", "K6")):
            check(launches[name] > 0, f"{label} index updates: {name} was not launched")
        log(f"{gpu_line()}: index updates, {label}, {n0} + 256 + 1,024 rows x 128 (capacity "
            f"{cap0} -> {cap}): {json.dumps({key: round(v, 3) for key, v in times.items()})}; "
            f"peak device memory during the growing add {peak / 2**30:.2f} GiB "
            f"({(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB before it); "
            f"launches {json.dumps(launches)}")
        out[label] = {"times": times, "peak_gib": peak / 2**30, "launches": launches}
        del index
        torch.cuda.empty_cache()
    return out


def _http(base: str, path: str, payload=None, timeout: float = 600):
    """(status, json body, host ms) of one request to the local server."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    return status, body, (time.perf_counter() - t0) * 1e3


def _pct(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values), q))


def _serve_kernel_errors(device, server, queries_f32, label: str) -> dict:
    """K1 (K5 over an int8 index) and K6 (bf16) at the shapes the serving
    search gives them, Q = 1 and 16 (a lone request and a full drain), and
    K2 at the reader's [16 x 5, T = 512] and /add's [16, 512], each against
    its plain version, on the idle server's index and trainer."""
    import torch

    from proqa_tpu_torch.ops import attention, mips, mips_kernel, rescore

    index, trainer = server.updater.index, server.updater.trainer
    errs = {"K1": 0.0, "K5": 0.0, "K6": 0.0, "K2": 0.0}
    scaled = index.scales is not None
    block = index.quant_block if scaled else mips.envelope_block(index.embeddings.shape[0], 256)
    corpus = mips.pad_rows(index.embeddings, mips_kernel.GROUP * block)
    scales = None if not scaled else mips.pad_ones(index.scales, corpus.shape[0] // block)
    if scaled:
        check_hopper_route(f"{label} K5", queries_f32.bfloat16(), corpus, block)
    for nq in (1, SERVE_QUESTIONS):
        qt = queries_f32[:nq].to(torch.bfloat16).contiguous()
        got = mips_kernel.block_maxima_grouped(qt, corpus, block=block, scales=scales)
        want = mips_kernel.block_maxima_grouped_reference(qt, corpus, block=block, scales=scales)
        name = "K5" if scaled else "K1"
        errs[name] = max([errs[name]] + [(a - b).abs().max().item() for a, b in zip(got, want)])
        if not scaled:
            ids = mips_kernel.select_blocks(qt, corpus, 80, block=block)
            blocks = corpus.view(-1, block, corpus.shape[1])
            got = rescore.gather_rescore(qt, blocks, ids, block=block)
            want = rescore.gather_rescore_reference(qt, blocks, ids, block=block)
            errs["K6"] = max(errs["K6"], (got - want).abs().max().item())
    cfg = trainer.cfg
    batch = next(iter(server.make_sampler(
        [{"question": f"what is about tok{i} tok{i + 1}"} for i in range(SERVE_QUESTIONS)]
    ).eval_load(trainer.query_encoder(), trainer.tcfg.eval_k, SERVE_QUESTIONS)))
    reader_mask = torch.from_numpy(batch["net_input"]["input_mask"]).to(device)
    add_mask = torch.ones(SERVE_QUESTIONS, reader_mask.shape[-1], dtype=torch.int32,
                          device=device)
    add_mask[:, 152:] = 0  # /add's paragraphs: 150 words, [CLS] and [SEP]
    g = torch.Generator(device=device).manual_seed(34)
    for mask in (reader_mask.reshape(-1, reader_mask.shape[-1]).to(torch.int32), add_mask):
        q, kk, v = (torch.randn(mask.shape[0], cfg.num_heads, mask.shape[1], cfg.head_dim,
                                device=device, generator=g).bfloat16() for _ in range(3))
        got = attention.fused_attention(q, kk, v, mask, sm_scale=cfg.head_dim ** -0.5)
        want = attention.fused_attention_reference(q, kk, v, mask, sm_scale=cfg.head_dim ** -0.5)
        errs["K2"] = max(errs["K2"], (got.float() - want.float()).abs().max().item())
    for name, tol in (("K1", BMAX_TOL), ("K5", BMAX_TOL), ("K6", BMAX_TOL), ("K2", ATTN_TOL)):
        check(errs[name] <= tol, f"{label}: {name} at the serving shapes: max abs err "
                                 f"{errs[name]} > {tol}")
    return errs


def _serve_run(device, root: str, label: str, flags: list) -> dict:
    """One `serve` setup (_serve_setup, port 0, in this process) over
    phase_cli's world with phase_qa's qa.npz and --max-batch 16: /healthz,
    16 lone /answer requests one after another, SERVE_BURSTS bursts of 16
    concurrent ones, every served row against trainer.answer through a
    sampler of its drain's bucket, /add of 16 paragraphs, /remove of them,
    and the kernels at the serving shapes. The launches counted are the
    serving traffic's alone, in three runs, each with the counters set to 0
    just before it and read just after, the server idle: setup with --warmup
    and every /answer up to /stats; /add; then /answer, /remove and 32
    questions in one /answer. The checks between them (a drain answered
    again, a fresh encode, a rebuilt index's search, the kernels against
    their plain versions) launch outside those runs."""
    import shutil
    import threading
    import urllib.parse

    import numpy as np
    import torch

    from proqa_tpu_torch.cli.main import _serve_setup, build_parser
    from proqa_tpu_torch.data.collate import pad_bucket
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.index.idmap import IdMap
    from proqa_tpu_torch.ops import attention, fused_bert, mips_kernel, rescore
    from proqa_tpu_torch.testing import topk_disagreements

    p = lambda name: os.path.join(root, name)  # noqa: E731
    shutil.copy(p("docs.db"), p(f"serve_{label}.db"))  # /add and /remove write to it
    args = build_parser().parse_args([
        "serve", "--vocab", p("vocab.txt"), "--db", p(f"serve_{label}.db"), "--index",
        p("index"), "--init-checkpoint", p("qa.npz"), "--device", str(device), "--eval-k", "5",
        "--max-batch", str(SERVE_QUESTIONS), "--host", "127.0.0.1", "--port", "0",
        "--warmup", "what is about tok1 tok2", "--output-dir", p(f"serve_{label}_run"),
        *flags])
    def zero():
        attention.launches = mips_kernel.launches = mips_kernel.scaled_launches = 0
        rescore.launches = 0
        fused_bert.form_launches.clear()

    def read():
        return {"K1": mips_kernel.launches, "K2": attention.launches,
                "K5": mips_kernel.scaled_launches, "K6": rescore.launches,
                "F1": fused_bert.launches("F1"), "F2": fused_bert.launches("F2")}

    search = ("K5",) if "--int8-index" in flags else ("K1", "K6")
    served_runs = {}
    zero()
    server, setup_ms = _sync_ms(lambda: _serve_setup(args))
    trainer, updater, index = server.updater.trainer, server.updater, server.updater.index
    level = trainer.logger.level
    trainer.logger.setLevel(logging.WARNING)  # one log line a request otherwise
    n0 = len(index)
    answer, drains = trainer.answer, []

    def recording(sampler, alpha, topn):
        t0 = time.perf_counter()
        rows = answer(sampler, alpha=alpha, topn=topn)
        drains.append(([qa["question"] for qa in sampler.qa_data], alpha, topn, rows,
                       (time.perf_counter() - t0) * 1e3))
        return rows

    trainer.answer = recording
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(35 if label == "bf16" else 36)
    pairs = rng.choice(60 * 60, SERVE_QUESTIONS * (1 + SERVE_BURSTS) + 32, replace=False)
    questions = [f"what is about tok{a // 60} tok{a % 60}" for a in pairs]
    served = {}
    try:
        status, body, _ = _http(base, "/healthz")
        check((status, body) == (200, {"status": "ok"}), f"{label} /healthz: {status} {body}")
        lone = []
        for q in questions[:SERVE_QUESTIONS]:
            status, row, ms = _http(base, "/answer?q=" + urllib.parse.quote_plus(q))
            check(status == 200 and row["question"] == q, f"{label} /answer: {status} {row}")
            served[q] = row
            lone.append(ms)
        burst_ms, burst_lat = [], []
        for b in range(SERVE_BURSTS):
            group = questions[SERVE_QUESTIONS * (b + 1):SERVE_QUESTIONS * (b + 2)]
            results = [None] * len(group)

            def ask(i, q):
                results[i] = _http(base, "/answer", {"question": q})

            threads = [threading.Thread(target=ask, args=(i, q)) for i, q in enumerate(group)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            burst_ms.append((time.perf_counter() - t0) * 1e3)
            for q, res in zip(group, results):
                check(res is not None and res[0] == 200 and res[1]["question"] == q,
                      f"{label} burst {b}: {str(res)[:300]}")
                served[q] = res[1]
                burst_lat.append(res[2])
        status, stats, _ = _http(base, "/stats")
        check(status == 200 and stats["items"] == SERVE_QUESTIONS * (1 + SERVE_BURSTS)
              and stats["max_batch_seen"] >= 2, f"{label} /stats: {stats}")
        served_runs["answer"] = read()
        # every served row against a fresh answer of its drain, the same
        # questions through a sampler of the same bucket (the server is idle)
        trainer.answer = answer
        burst_drains = [(len(d[0]), round(d[4], 1)) for d in drains[SERVE_QUESTIONS:]]
        replay_ms = {}
        for qs, alpha, topn, rows, _ in drains[:]:
            again, ms = _sync_ms(lambda: answer(
                server.make_sampler([{"question": q} for q in qs]), alpha=alpha, topn=topn))
            replay_ms.setdefault(pad_bucket(len(qs), SERVE_QUESTIONS), []).append(ms)
            check(again == rows, f"{label}: a drain of {len(qs)} answered differently again")
            for q, row in zip(qs, rows):
                if q in served:
                    check(served.pop(q) == row, f"{label}: the served row of {q!r} differs "
                                                "from its drain's")
        check(not served, f"{label}: {len(served)} served rows in no drain")
        replay_median = {b: round(statistics.median(v), 2) for b, v in sorted(replay_ms.items())}
        n_drains = len(drains)

        # /add 16 paragraphs, then /remove them
        texts = [" ".join(f"tok{w}" for w in rng.integers(0, 60, size=150)) for _ in range(16)]
        ids = [f"{label}-live{i}" for i in range(16)]
        zero()
        status, out, add_ms = _http(base, "/add", {"paras": [{"id": i, "text": t}
                                                             for i, t in zip(ids, texts)]})
        served_runs["add"] = read()
        check(status == 200 and out == {"added": 16, "index_rows": n0 + 16},
              f"{label} /add: {status} {out}")
        rows_new = index.live_rows(ids)
        check(len(rows_new) == 16, f"{label}: {len(rows_new)} live rows for the 16 added ids")
        fresh = updater._encode_texts(texts)
        stored = index.take(rows_new)
        fresh_t = torch.from_numpy(fresh).to(device)
        if index.scales is None:
            check(np.array_equal(stored, fresh_t.to(index.embeddings.dtype).float().cpu().numpy()),
                  f"{label}: the added rows differ from a fresh encode")
            rebuilt = DenseIndex.from_embeddings(index.embeddings[:index.n],
                                                 IdMap(index.id_map.rows_to_ids(range(index.n))),
                                                 device=device, dtype=index.embeddings.dtype)
            lv, li = index.search(fresh, 80)
            rv, ri = rebuilt.search(fresh, 80)
            del rebuilt
        else:
            step = np.repeat(index.scales.cpu().numpy(), index.quant_block)[rows_new]
            check(bool((np.abs(stored - fresh).max(axis=1) <= 0.51 * step).all()),
                  f"{label}: an added row is more than half a quantization step from its encode")
            lv, li = index.search(fresh, 80)
            rv, ri = _own_exact(index, fresh_t, 80)
        # bf16: the same K1 and K6 over the same rows, so equal values;
        # int8: the take rescore against the reference's product, other sums
        bad = topk_disagreements(lv, li, rv, ri, atol=0.0 if index.scales is None else TOPK_TOL)
        check(bad == 0, f"{label}: the live search after /add differs from "
                        + ("a rebuilt index's" if index.scales is None else "the exact search "
                           "of its codes") + f" for {bad} of 16 queries")
        # every added row is retrievable: a search at full depth returns it
        _, full = index.search(fresh[:1], len(index))
        check(np.isin(rows_new, full).all(), f"{label}: an added row is missing at full depth")
        zero()
        status, row, _ = _http(base, "/answer?q=" + urllib.parse.quote_plus(questions[0]))
        check(status == 200 and row["candidates"], f"{label} /answer after /add: {status}")
        status, out, remove_ms = _http(base, "/remove", {"ids": ids})
        check(status == 200 and out == {"removed": 16, "index_rows": n0},
              f"{label} /remove: {status} {out}")
        status, rows_after, _ = _http(base, "/answer", {"questions": questions[-32:]})
        served_runs["answer_remove"] = read()
        check(status == 200 and len(rows_after) == 32, f"{label} /answer x32: {status}")
        _, full = index.search(fresh[:1], index.n)
        check(not np.isin(full[:, :len(index)], rows_new).any(),
              f"{label}: a removed row is still retrieved")
        gone = {" ".join(t.split()) for t in texts}
        check(not any(c["passage"] in gone for r in rows_after for c in r["candidates"]),
              f"{label}: a removed paragraph is still a candidate")
        errs = _serve_kernel_errors(device, server, fresh_t, label)
    finally:
        trainer.answer = answer
        trainer.logger.setLevel(level)
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), f"{label}: the server thread did not stop")
    # the query tower and reader (K2, F1, F2) and the search (K1 + K6, or
    # K5) in every run that answers; the context tower (K2, F1, F2) in /add's
    towers = ("K2", "F1", "F2")
    for run, names in (("answer", (*towers, *search)), ("add", towers),
                       ("answer_remove", (*towers, *search))):
        for name in names:
            check(served_runs[run][name] > 0, f"serve {label}: {name} was not launched by the "
                                              f"{run} run")
    launches = {k: sum(run[k] for run in served_runs.values()) for k in read()}
    n_burst = SERVE_QUESTIONS * SERVE_BURSTS
    log(f"{gpu_line()}: serve {label} (BERT-base reader T=512, eval_k 5, --max-batch "
        f"{SERVE_QUESTIONS}, {n0} paragraphs): setup {setup_ms / 1e3:.2f} s (weights, index, "
        f"--warmup); lone /answer x{SERVE_QUESTIONS}: p50 {_pct(lone, 50):.2f} ms, p99 "
        f"{_pct(lone, 99):.2f} ms; {SERVE_BURSTS} bursts of {SERVE_QUESTIONS} concurrent: p50 "
        f"{_pct(burst_lat, 50):.2f} ms, p99 {_pct(burst_lat, 99):.2f} ms, "
        f"{n_burst / (sum(burst_ms) / 1e3):.2f} questions/s; max_batch_seen "
        f"{stats['max_batch_seen']} over {n_drains} drains, every served row equal to a fresh "
        f"answer of its drain; burst walls {[round(v, 1) for v in burst_ms]} ms, their drains "
        f"(questions, ms) {burst_drains}; a drain answered again on the idle server, median "
        f"ms by bucket {json.dumps(replay_median)}; "
        f"/add 16 {add_ms:.2f} ms, /remove 16 {remove_ms:.2f} ms (host clock, HTTP included); "
        f"launches by the serving traffic {json.dumps(launches)} (by run "
        f"{json.dumps(served_runs)}); kernels at the serving shapes, max abs err "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}")
    return {"launches": launches, "errs": errs, "lone_p50_ms": _pct(lone, 50),
            "lone_p99_ms": _pct(lone, 99), "burst_qps": n_burst / (sum(burst_ms) / 1e3)}


def phase_serve(device, root: str) -> dict:
    """`serve` on phase_cli's world: the bf16 index, then --int8-index."""
    bf16 = _serve_run(device, root, "bf16", [])
    int8 = _serve_run(device, root, "int8", ["--int8-index"])
    launches = {k: bf16["launches"][k] + int8["launches"][k] for k in bf16["launches"]}
    errs = {k: max(bf16["errs"][k], int8["errs"][k]) for k in bf16["errs"]}
    return {"launches": launches, "errs": errs, "bf16": bf16, "int8": int8}


def phase_ivf(device, root: str) -> dict:
    """to_ivf(nlist=100, nprobe=20) over phase_mips's corpus (the
    reference's online-QA setting): the build time; at nprobe = nlist the
    search equals the exact search up to ties; at nprobe 20, recall@80 over
    256 queries against the exact search, and search ms at Q = 1 and 8
    beside the exact search at the same Q; then `answer --use-ivf` on
    phase_cli's world."""
    import numpy as np
    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.testing import topk_disagreements

    corpus, queries = bf16_corpus(device)
    n, k = corpus.shape[0], 80
    index = DenseIndex.from_embeddings(corpus, device=device, dtype=torch.bfloat16)
    del corpus
    view, build_ms = _sync_ms(lambda: index.to_ivf(nlist=100, nprobe=20))
    ivf = view.ivf
    q8 = queries[:8]
    ivf.nprobe = ivf.nlist
    fv, fi = view.search(q8, k)
    ev, ei = index.search(q8, k)
    bad = topk_disagreements(fv, fi, ev, ei, atol=TOPK_TOL)
    check(bad == 0, f"IVF at full probe: {bad} of 8 queries disagree with the exact search")
    ivf.nprobe = 20
    iv, ii = view.search(queries[:256], k)
    _, ei = index.search(queries[:256], k)
    recall = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(ii, ei)]))
    check(recall > ivf.nprobe / ivf.nlist, f"IVF recall@{k} {recall} is no better than "
                                           "probing clusters at random")
    times = {}
    for nq in (1, 8):
        for name, fn in (("ivf", lambda: view.search(queries[:nq], k)),
                         ("exact", lambda: index.search(queries[:nq], k))):
            fn()
            walls = [_sync_ms(fn)[1] for _ in range(5)]
            times[f"{name} Q={nq}"] = statistics.median(walls)
    log(f"{gpu_line()}: IVF over {n} x 128 bf16, nlist {ivf.nlist}, capacity {ivf.capacity}, "
        f"overflow {int((ivf.overflow_rows >= 0).sum())} rows: built in {build_ms / 1e3:.2f} s; "
        f"full probe equals the exact top-{k} at Q=8 up to ties; nprobe 20: recall@{k} "
        f"{recall:.4f} over 256 queries against the exact search; search ms (host clock, "
        f"median of 5): {json.dumps({key: round(v, 3) for key, v in times.items()})}")
    del view, index, ivf
    torch.cuda.empty_cache()
    p = lambda name: os.path.join(root, name)  # noqa: E731
    row, wall = run_cli(["answer", "--vocab", p("vocab.txt"), "--db", p("docs.db"), "--index",
                         p("index"), "--init-checkpoint", p("qa.npz"), "--device", str(device),
                         "--eval-k", "5", "--output-dir", p("ivf_run"), "--use-ivf",
                         "--question", "what is about tok3 tok7"])
    check(set(row) == {"question", "answer", "alpha", "candidates"} and row["candidates"],
          f"answer --use-ivf: {str(row)[:300]}")
    return {"recall": recall, "build_s": build_ms / 1e3, "times": times}

# --- multi-device and the remaining commands: convert-hf, sharding, DDP ---

def _hf_retriever_state(seed: int, cfg) -> tuple[dict, dict]:
    """Random BERT-base retriever weights from a numpy seed, twice: a JAX
    layout tree (per-layer leaves stacked, kernels [in, out]) and the same
    numbers as a reference `BertForRetriever` state dict in HF key layout
    (torch Linear weights [out, in]) under DistributedDataParallel's
    `module.` prefix."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    h, inter, n_l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def w(*shape):
        return (rng.standard_normal(shape, np.float32) * cfg.initializer_range).astype(np.float32)

    def ln(*shape):
        return 1.0 + w(*shape)

    tree, state = {}, {}
    dense = {"q": ("attention.self.query", h, h), "k": ("attention.self.key", h, h),
             "v": ("attention.self.value", h, h), "attn_out": ("attention.output.dense", h, h),
             "mlp_in": ("intermediate.dense", h, inter), "mlp_out": ("output.dense", inter, h)}
    norms = {"attn_ln": "attention.output.LayerNorm", "mlp_ln": "output.LayerNorm"}
    for tower in ("bert_q", "bert_c"):
        emb = {"word": w(cfg.vocab_size, h), "position": w(cfg.max_position_embeddings, h),
               "token_type": w(cfg.type_vocab_size, h), "ln": {"scale": ln(h), "bias": w(h)}}
        layers = {name: {"kernel": w(n_l, d_in, d_out), "bias": w(n_l, d_out)}
                  for name, (_, d_in, d_out) in dense.items()}
        layers.update({name: {"scale": ln(n_l, h), "bias": w(n_l, h)} for name in norms})
        tree[tower] = {"embeddings": emb, "layers": layers,
                       "pooler": {"kernel": w(h, h), "bias": w(h)}}
        hf = {"embeddings.word_embeddings.weight": emb["word"],
              "embeddings.position_embeddings.weight": emb["position"],
              "embeddings.token_type_embeddings.weight": emb["token_type"],
              "embeddings.LayerNorm.weight": emb["ln"]["scale"],
              "embeddings.LayerNorm.bias": emb["ln"]["bias"],
              "pooler.dense.weight": tree[tower]["pooler"]["kernel"].T,
              "pooler.dense.bias": tree[tower]["pooler"]["bias"]}
        for i in range(n_l):
            base = f"encoder.layer.{i}."
            for name, (hf_name, _, _) in dense.items():
                hf[base + hf_name + ".weight"] = layers[name]["kernel"][i].T
                hf[base + hf_name + ".bias"] = layers[name]["bias"][i]
            for name, hf_name in norms.items():
                hf[base + hf_name + ".weight"] = layers[name]["scale"][i]
                hf[base + hf_name + ".bias"] = layers[name]["bias"][i]
        state.update({f"module.{tower}.{k}": v for k, v in hf.items()})
    for tower in ("proj_q", "proj_c"):
        tree[tower] = {"kernel": w(h, 128), "bias": w(128)}
        state[f"module.{tower}.weight"] = tree[tower]["kernel"].T
        state[f"module.{tower}.bias"] = tree[tower]["bias"]
    return tree, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}


def phase_convert(device, root: str) -> dict:
    """convert-hf on phase_cli's retrieval world: a BERT-base reference
    retriever state dict (HF key layout, `module.` prefix, numpy-seeded) into
    the port's .pt, then encode-queries and build-index through it with
    --dp-encode (one replica a local card), against the same weights loaded
    through the .npz route without it: bit-equal rows, and eval-retrieval
    gives one recall JSON over both indexes. K2's counter reset before the
    converted path and read after."""
    import numpy as np
    import torch

    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.convert import save_npz
    from proqa_tpu_torch.ops import attention

    p = lambda name: os.path.join(root, name)  # noqa: E731
    tree, state = _hf_retriever_state(21, BertConfig())
    save_npz(p("hf_route.npz"), tree)
    torch.save(state, p("hf_retriever.pt"))
    del tree, state
    base = ["--vocab", p("vocab.txt"), "--device", str(device)]
    walls, out = {}, {}
    attention.launches = 0
    conv, walls["convert-hf"] = run_cli(["convert-hf", *base, "--torch-checkpoint",
                                         p("hf_retriever.pt"), "--kind", "retriever",
                                         "--output", p("hf_converted.pt")])
    check(conv == {"saved": p("hf_converted.pt"), "kind": "retriever"}, f"convert-hf: {conv}")
    for route, ckpt, dp in (("pt", "hf_converted.pt", ["--dp-encode"]),
                            ("npz", "hf_route.npz", [])):
        common = [*base, "--init-checkpoint", p(ckpt), *dp]
        _, walls[f"encode-queries {route}"] = run_cli(
            ["encode-queries", *common, "--queries", p("qa.jsonl"), "--output", p(f"q_{route}.npy")])
        _, walls[f"build-index {route}"] = run_cli(
            ["build-index", *common, "--max-seq-length", "512", "--predict-batch-size", "512",
             "--corpus", p("corpus.jsonl"), "--output-dir", p(f"index_{route}")])
        if route == "pt":
            k2 = attention.launches
        out[route], _ = run_cli(["eval-retrieval", p("qa.jsonl"), p(f"index_{route}"),
                                 p(f"q_{route}.npy"), p("docs.db"), "--topk", "80",
                                 "--device", str(device)])
    check(k2 > 0, "K2 was not launched through the converted checkpoint")
    for name in ("q_{}.npy", "index_{}/embeddings.npy"):
        a, b = np.load(p(name.format("pt"))), np.load(p(name.format("npz")))
        check(a.shape == b.shape and np.isfinite(a).all() and np.array_equal(a, b),
              f"{name.format('*')}: the converted checkpoint's rows differ from the .npz route's")
    check(out["pt"] == out["npz"], f"recall through convert-hf {out['pt']} != {out['npz']}")
    log(f"convert-hf -> encode-queries and build-index --dp-encode: rows bit-equal to the .npz "
        f"route, recall {json.dumps(out['pt'])}; K2 launched {k2} times; wall seconds "
        f"{json.dumps(walls)}")
    return {"K2": k2}


def phase_sharded(device, root: str, recall: dict) -> dict:
    """phase_mips's 4,194,304 x 128 bf16 corpus row-sharded over
    [cuda:0] * 4 (1,048,576 rows a shard), Q = 2,048, k = 80: ids equal to
    the unsharded index's up to ties, values within rtol 1e-6, K1 and K6
    launched once a shard; the same as int8 with K5, held to the exact top-k
    of its own codes; the degenerate contract with n_valid inside the first
    shard; the sharded and unsharded search ms (host clock, synchronised)
    and peak memory. Then eval-retrieval --shard-index on phase_cli's world
    (every local card) and its index over [cuda:0] * 4 in-process, each with
    phase_cli's recall JSON."""
    import numpy as np
    import torch

    from proqa_tpu_torch.data.docdb import DocDB
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.index.recall import evaluate_retrieval
    from proqa_tpu_torch.ops import mips, mips_kernel, quant, rescore
    from proqa_tpu_torch.parallel import make_mesh, sharded_mips_topk
    from proqa_tpu_torch.testing import topk_disagreements

    n_shards, k = 4, 80
    mesh = make_mesh(devices=[device] * n_shards)
    corpus, queries = bf16_corpus(device)
    q = queries.shape[0]
    launches = {"K1": 0, "K5": 0, "K6": 0}
    result = {}
    for kind in (torch.bfloat16, "int8"):
        label = "bf16" if kind is torch.bfloat16 else "int8"
        src = corpus if kind is torch.bfloat16 else corpus.float().cpu().numpy()
        whole = DenseIndex.from_embeddings(src, device=device, dtype=kind)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        sharded = DenseIndex.from_embeddings(src, mesh=mesh, dtype=kind)
        del src
        check(sharded.quant_block == whole.quant_block,
              f"{label}: quant block {sharded.quant_block} per shard, {whole.quant_block} whole")
        counter = "launches" if kind is torch.bfloat16 else "scaled_launches"
        setattr(mips_kernel, counter, 0)
        rescore.launches = 0
        vals, idx = sharded.search(queries, k)
        got = {"K1" if kind is torch.bfloat16 else "K5": getattr(mips_kernel, counter),
               "K6": rescore.launches}
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        for name, n in got.items():
            launches[name] += n
        want_k6 = n_shards if kind is torch.bfloat16 else 0
        check(list(got.values()) == [n_shards, want_k6],
              f"{label} sharded search: launches {got}, want one K1/K5 and K6 a shard")
        wv, wi = whole.search(queries, k)
        bad = topk_disagreements(vals, idx, wv, wi, atol=TOPK_TOL)
        check(bad == 0 and np.allclose(vals, wv, rtol=1e-6, atol=0),
              f"{label} sharded search: {bad} of {q} queries differ from the unsharded index's")
        if kind == "int8":
            codes, scales = torch.cat(sharded.embeddings), torch.cat(sharded.scales)
            rows = quant.expand_scales(scales, sharded.quant_block, codes.shape[0])
            qb, bad = queries.bfloat16(), 0
            for s in range(0, 256, 64):
                rv, ri = mips.mips_topk_reference(qb[s:s + 64], codes, k, n_valid=sharded.n,
                                                  scales=rows)
                bad += topk_disagreements(vals[s:s + 64], idx[s:s + 64], rv.cpu().numpy(),
                                          ri.cpu().numpy(), atol=TOPK_TOL)
            del codes, scales, rows
            check(bad == 0, f"int8 sharded search: {bad} of 256 queries differ from the exact "
                            f"top-{k} of its own codes")
        ms = {}
        for name, index in (("sharded", sharded), ("unsharded", whole)):
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                index.search(queries, k)  # ends in a copy to the host: synchronised
                walls.append(time.perf_counter() - t0)
            ms[name] = statistics.median(walls) * 1e3
        result[label] = {**ms, "peak_gib": peak}
        log(f"{label} search over {n_shards} shards of one card, Q={q} k={k}: {ms['sharded']:.2f} "
            f"ms a batch against {ms['unsharded']:.2f} ms unsharded (host clock, synchronised); "
            f"the sharded index and its search peaked {peak:.2f} GiB over the corpus; launches "
            f"{json.dumps(got)}; ids equal the unsharded index's up to ties")
        del sharded, whole
        torch.cuda.empty_cache()

    # the degenerate contract: 50 valid rows, all in the first shard
    n_valid = 50
    shards = [corpus[i * (corpus.shape[0] // n_shards):(i + 1) * (corpus.shape[0] // n_shards)]
              for i in range(n_shards)]
    mips_kernel.launches = 0
    sv, si = sharded_mips_topk(queries.bfloat16(), shards, k, mesh, n_valid=n_valid)
    check(mips_kernel.launches == n_shards, f"n_valid search: K1 launched {mips_kernel.launches}")
    launches["K1"] += mips_kernel.launches
    rv, ri = mips.mips_topk_reference(queries.bfloat16(), corpus[:n_valid], n_valid)
    sv, si, rv, ri = (t.cpu().numpy() for t in (sv, si, rv, ri))
    check(topk_disagreements(sv[:, :n_valid], si[:, :n_valid], rv, ri, atol=TOPK_TOL) == 0
          and (sv[:, n_valid:] <= mips.NEG_INF).all() and (si[:, n_valid:] == 0).all()
          and (si < n_valid).all(),
          "n_valid inside the first shard: the merged lists break the (NEG_INF, row 0) contract")
    del corpus, queries, shards

    p = lambda name: os.path.join(root, name)  # noqa: E731
    cli_recall, _ = run_cli(["eval-retrieval", p("qa.jsonl"), p("index"), p("q.npy"),
                             p("docs.db"), "--topk", str(k), "--shard-index",
                             "--device", str(device)])
    index = DenseIndex.load(p("index"), mesh=mesh)
    four = evaluate_retrieval(p("qa.jsonl"), index, np.load(p("q.npy")), DocDB(p("docs.db")),
                              topk=k)
    check(cli_recall == recall and {f"recall@{r}": v for r, v in four.items()} == recall,
          f"sharded recall {cli_recall} / {four} != unsharded {recall}")
    log(f"eval-retrieval --shard-index ({torch.cuda.device_count()} local card) and over "
        f"[{device}] * {n_shards}: the unsharded recall JSON; n_valid={n_valid} inside the first "
        f"shard keeps the (NEG_INF, row 0) contract")
    return {"launches": launches, **result}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cli_worker(counts_path: str, argv: list[str]) -> int:
    """`chip_smoke.py --cli-worker COUNTS_JSON CMD ...`: one proqa-torch
    command in this process, every kernel's launch counter reset before it
    and written with the process group's backend to COUNTS_JSON after (the
    ddp phase runs it alone and under the torch.distributed launcher)."""
    import torch.distributed as dist

    from proqa_tpu_torch.cli.main import main as cli
    from proqa_tpu_torch.ops import attention, dropout, mips_kernel, rescore

    attention.launches = attention.backward_launches = dropout.launches = 0
    mips_kernel.launches = rescore.launches = 0
    _reset_fused_counts()
    cli(argv)
    counts = {"K1": mips_kernel.launches, "K2": attention.launches,
              "K3": attention.backward_launches, "K4": dropout.launches,
              "K6": rescore.launches, **_fused_counts(),
              "backend": dist.get_backend() if dist.is_initialized() else None}
    with open(counts_path, "w") as f:
        json.dump(counts, f)
    return 0


def phase_ddp(device, root: str) -> dict:
    """pretrain-retriever on phase_pretrain_cli's world (BERT-base, contexts
    of T = 256, 3 steps of 32 pairs) under `python -m torch.distributed.run
    --nproc-per-node 1`, NCCL on the card, and the same command without the
    launcher: the losses equal step by step within 1e-3 (rank 0 draws the
    dropout seeds one process draws), the backend is nccl, and K2, K3 and K4
    launch in the data-parallel run. Each run is a child process that counts
    its own launches; step ms of both from their metrics.jsonl."""
    p = lambda name: os.path.join(root, name)  # noqa: E731
    me = os.path.abspath(__file__)
    runs = {}
    for name, launcher in (("ddp", [sys.executable, "-m", "torch.distributed.run",
                                    "--nnodes", "1", "--nproc-per-node", "1",
                                    "--master-addr", "127.0.0.1",
                                    "--master-port", str(_free_port())]),
                           ("plain", [sys.executable])):
        out = p(f"{name}_run")
        argv = ["pretrain-retriever", "--vocab", p("vocab.txt"), "--max-seq-length", "286",
                "--max-query-length", "30", "--device", "cuda", "--train-file", p("pairs.jsonl"),
                "--predict-file", p("pairs.jsonl"), "--output-dir", out,
                "--train-batch-size", "32", "--predict-batch-size", "32",
                "--num-train-epochs", "1", "--eval-period", "3",
                "--save-checkpoints-steps", "100", "--learning-rate", "1e-4"]
        counts = p(f"{name}_counts.json")
        t0 = time.perf_counter()
        proc = subprocess.run([*launcher, me, "--cli-worker", counts, *argv],
                              capture_output=True, text=True, timeout=600,
                              env={**os.environ, "PYTHONPATH": os.pathsep.join(
                                  [os.path.dirname(me), os.environ.get("PYTHONPATH", "")])})
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"{name} pretrain-retriever exited {proc.returncode}: "
                                    f"{proc.stderr[-3000:]}")
        with open(counts) as f:
            launched = json.load(f)
        with open(os.path.join(out, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        losses = [m["value"] for m in metrics if m["tag"] == "train_loss"]
        step_ms = [m["value"] for m in metrics if m["tag"] == "step_p50_ms"]
        with open(os.path.join(out, "log.txt")) as f:
            log_text = f.read()
        runs[name] = {"launches": launched, "losses": losses, "step_p50_ms": step_ms[-1],
                      "wall_s": wall, "log": log_text}
    ddp, plain = runs["ddp"], runs["plain"]
    check(ddp["launches"]["backend"] == "nccl" and "data parallel: backend nccl" in ddp["log"],
          f"the launched run's backend is {ddp['launches']['backend']}, not nccl")
    check(plain["launches"]["backend"] is None, "the plain run joined a process group")
    check(len(ddp["losses"]) == len(plain["losses"]) == 3
          and all(abs(a - b) <= 1e-3 for a, b in zip(ddp["losses"], plain["losses"])),
          f"losses: data parallel {ddp['losses']} against one process {plain['losses']}")
    k = {name: ddp["launches"][name]
         for name in ("K2", "K3", "K4", "F1", "F2", "F1 backward", "F2 backward")}
    check(all(n > 0 for n in k.values()), f"a kernel never ran in the NCCL run {k}")
    log(f"pretrain-retriever under torch.distributed.run (nccl, world 1) against one process: "
        f"losses {ddp['losses']} vs {plain['losses']}; step p50 {ddp['step_p50_ms']:.1f} ms vs "
        f"{plain['step_p50_ms']:.1f} ms; wall {ddp['wall_s']:.1f} s vs {plain['wall_s']:.1f} s "
        f"(process start, model init and the kernels' load included); launches {json.dumps(k)}")
    _dp_step_at_full_width(root)
    return k


def _dp_step_at_full_width(root: str, steps: int = 8) -> None:
    """The retriever train step at phase 8's shape, 80 x (32 + 512), in this
    process: a trainer in an NCCL group of one (tcp on localhost) and one
    with no group, the same weights and batch, their steps taken in turns
    (plain, group, group, plain, ...): the same losses within 1e-3, and
    each one's median step ms (host clock; the loss read synchronises)."""
    import numpy as np
    import torch.distributed as dist

    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.train.retriever_trainer import RetrieverTrainer, RetrieverTrainerConfig

    b, tq, tc = 80, 32, 512
    rng = np.random.default_rng(9)
    ids_c = rng.integers(5, 30522, size=(b, tc))
    ids_c *= np.arange(tc)[None] < rng.integers(tc // 2, tc + 1, size=(b, 1))
    batch = {"input_ids_q": ids_c[:, :tq].copy(), "input_mask_q": np.ones((b, tq), np.int32),
             "input_ids_c": ids_c, "input_mask_c": (ids_c != 0).astype(np.int32)}
    cfg = BertConfig(remat=True, flash_attention=True)  # bf16, dropout 0.1

    def trainer(name):
        tcfg = RetrieverTrainerConfig(learning_rate=1e-4, seed=10,
                                      output_dir=os.path.join(root, name))
        return RetrieverTrainer(cfg, tcfg, device="cuda")

    plain = trainer("step_plain")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        grouped = trainer("step_nccl")
        check(grouped.dp.backend == "nccl", f"in-process group backend {grouped.dp.backend}")
        runs = {"plain": ([], []), "nccl": ([], [])}
        for i in range(steps + 1):  # the first pair warms up
            order = ("plain", "nccl") if i % 2 == 0 else ("nccl", "plain")
            for name in order:
                t0 = time.perf_counter()
                loss = float((plain if name == "plain" else grouped).step(dict(batch))["loss"])
                if i:
                    runs[name][0].append(loss)
                    runs[name][1].append(time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    (l_p, w_p), (l_d, w_d) = runs["plain"], runs["nccl"]
    check(all(abs(a - c) <= 1e-3 for a, c in zip(l_d, l_p)),
          f"80 x (32 + 512): the NCCL group's losses {l_d} against one process's {l_p}")
    ms_p, ms_d = (statistics.median(w) * 1e3 for w in (w_p, w_d))
    log(f"retriever train step {b} x ({tq} + {tc}) in turns, {steps} each: NCCL group of one "
        f"{ms_d:.1f} ms (p25-p75 {np.percentile(w_d, 25) * 1e3:.1f}-"
        f"{np.percentile(w_d, 75) * 1e3:.1f}) against no group {ms_p:.1f} ms "
        f"({np.percentile(w_p, 25) * 1e3:.1f}-{np.percentile(w_p, 75) * 1e3:.1f}); losses equal "
        f"within 1e-3 ({l_d[-1]:.4f} vs {l_p[-1]:.4f})")


# --- MiniLM-L12-H384: head dim 32 on the card ----------------------------------

# microsoft/MiniLM-L12-H384-uncased's config.json (named, not downloaded):
# the BERT architecture with exact GELU, 12 heads of 32
MINILM = dict(vocab_size=30522, hidden_size=384, num_layers=12, num_heads=12,
              intermediate_size=1536, max_position_embeddings=512, type_vocab_size=2)
MINILM_T = (128, 512, 1024)  # K2/K3 checks: both ends of the range and the slice's length
PADDED_DH = 48               # a head dim without its own kernel: padded to 64


def _row_rel(got, want) -> float:
    """The largest error of an output row (the last dim) as a share of that
    row's largest |plain value|, the share taken of at least the median of
    the tensor's nonzero row maxima: a dk or dv row of a padding key is zero
    in exact arithmetic, and a row that cancels is held at a typical row's
    scale."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    size = w.abs().amax(-1)
    nonzero = size[size > 0]
    floor = nonzero.median() if nonzero.numel() else torch.ones((), device=size.device)
    return (err / torch.maximum(size, floor)).max().item()


def _attention_controls(q, k, v, do, mask, kw) -> tuple[float, list]:
    """_row_rel of the plain versions on inputs that leave out one key tile
    (keys 0-63 masked) or one head-dim chunk (q's last 128 columns zeroed,
    its last quarter below Dh 256) against the plain versions on the inputs
    themselves: K2's, and dq's, dk's and dv's, each the smaller of the two
    controls. A limit these pass would not see a kernel drop a key tile or
    a chunk."""
    from proqa_tpu_torch.ops import attention

    fwd, bwd = attention.fused_attention_reference, attention.fused_attention_backward_reference
    want, grads = fwd(q, k, v, mask, **kw), bwd(q, k, v, mask, do, **kw)
    dh = q.shape[-1]
    tile, chunk = mask.clone(), q.clone()
    tile[:, :64] = 0
    chunk[..., dh - (128 if dh >= 256 else dh // 4):] = 0
    out_f, out_b = [], []
    for args in ((q, k, v, tile), (chunk, k, v, mask)):
        out_f.append(_row_rel(fwd(*args, **kw), want))
        out_b.append([_row_rel(x, w) for x, w in zip(bwd(*args, do, **kw), grads)])
    return min(out_f), [min(c) for c in zip(*out_b)]


def _attention_checks(device, dh: int, heads: int, b: int = 8) -> dict:
    """K2 and K3 at head dim dh against their plain versions: bf16 and f32,
    T in MINILM_T, rates 0 and 0.1, random key padding with one all-padding
    row; each output within ATTN_TOL/BWD_TOL and, row by row (_row_rel),
    within ATTN_ROW_REL/BWD_ROW_REL of its dtype, while the controls that
    leave out a key tile or a head-dim chunk (_attention_controls) exceed
    those limits for K2 and for each of dq, dk, dv; K3 twice on the same
    inputs bit-equal. Returns the largest errors, the largest row errors and
    the smallest control readings, by dtype."""
    import torch

    from proqa_tpu_torch.ops import attention

    fwd_err = bwd_err = 0.0
    rel, ctrl = {}, {}
    for t in MINILM_T:
        q, k, v, do, mask = _attention_inputs(device, b, heads, t, dh, seed=t + dh)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            lim_f, lim_b = ATTN_ROW_REL[name], BWD_ROW_REL[name]
            r, c = rel.setdefault(name, [0.0, 0.0]), ctrl.setdefault(name, [math.inf, math.inf])
            qd, kd, vd, dod = (x.to(dtype) for x in (q, k, v, do))
            for rate in (0.0, 0.1):
                case = f"Dh={dh} T={t} {name} rate {rate}"
                kw = dict(sm_scale=dh ** -0.5, dropout_rate=rate, seed=2**45 + t)
                got = attention.fused_attention(qd, kd, vd, mask, **kw)
                want = attention.fused_attention_reference(qd, kd, vd, mask, **kw)
                err = (got.float() - want.float()).abs().max().item()
                row = _row_rel(got, want)
                check(got.shape == qd.shape and bool(torch.isfinite(got.float()).all())
                      and err <= ATTN_TOL and row <= lim_f,
                      f"K2 {case}: max abs err {err} (tol {ATTN_TOL}), row error {row} (tol "
                      f"{lim_f})")
                fwd_err, r[0] = max(fwd_err, err), max(r[0], row)
                grads = attention._backward_kernel(qd, kd, vd, mask, dod, kw["sm_scale"], rate,
                                                   kw["seed"])
                again = attention._backward_kernel(qd, kd, vd, mask, dod, kw["sm_scale"], rate,
                                                   kw["seed"])
                want = attention.fused_attention_backward_reference(qd, kd, vd, mask, dod, **kw)
                check(all(torch.equal(x, y) for x, y in zip(grads, again)),
                      f"K3 {case}: two launches differ")
                err = max((x.float() - w.float()).abs().max().item() for x, w in zip(grads, want))
                rows = [_row_rel(x, w) for x, w in zip(grads, want)]
                check(all(bool(torch.isfinite(x.float()).all()) for x in grads)
                      and err <= BWD_TOL and max(rows) <= lim_b,
                      f"K3 {case}: max abs err {err} (tol {BWD_TOL}), dq, dk, dv row errors "
                      f"{rows} (tol {lim_b})")
                bwd_err, r[1] = max(bwd_err, err), max([r[1]] + rows)
                del got, want, grads, again
                cf, cb = _attention_controls(qd, kd, vd, dod, mask, kw)
                check(cf > lim_f and min(cb) > lim_b,
                      f"K2/K3 {case}: a control that leaves out a key tile or a head-dim chunk "
                      f"reads {cf} and dq, dk, dv {cb}, within the limits {lim_f}, {lim_b}")
                c[0], c[1] = min(c[0], cf), min([c[1]] + cb)
        del q, k, v, do, mask
    return {"fwd_err": fwd_err, "bwd_err": bwd_err, "row_err": rel, "control": ctrl}


def _attention_form(device, b, h, t, dh, rate) -> tuple[dict, dict]:
    """K2 and K3 at [b, h, t, dh] bf16: error against the plain version, one
    call's time beside the plain version, SDPA (rate 0) and the bound."""
    import torch
    import torch.nn.functional as F

    from proqa_tpu_torch.ops import attention

    q, k, v, do, mask = _attention_inputs(device, b, h, t, dh, seed=7 * dh)
    kw, seed = dict(sm_scale=dh ** -0.5, dropout_rate=rate, seed=2**44 + 1), 2**44 + 1
    scale = kw["sm_scale"]
    got = attention.fused_attention(q, k, v, mask, **kw)
    want = attention.fused_attention_reference(q, k, v, mask, **kw)
    fwd = {"max_abs_err": (got.float() - want.float()).abs().max().item()}
    row_f = _row_rel(got, want)
    del got, want
    grads = attention._backward_kernel(q, k, v, mask, do, scale, rate, seed)
    want = attention.fused_attention_backward_reference(q, k, v, mask, do, **kw)
    bwd = {"max_abs_err": max((x.float() - w.float()).abs().max().item()
                              for x, w in zip(grads, want))}
    row_b = max(_row_rel(x, w) for x, w in zip(grads, want))
    del grads, want
    check(fwd["max_abs_err"] <= ATTN_TOL and bwd["max_abs_err"] <= BWD_TOL
          and row_f <= ATTN_ROW_REL["bfloat16"] and row_b <= BWD_ROW_REL["bfloat16"],
          f"K2/K3 [{b}, {h}, {t}, {dh}] rate {rate}: max abs err {fwd['max_abs_err']}, "
          f"{bwd['max_abs_err']} (tol {ATTN_TOL}, {BWD_TOL}); row errors {row_f}, {row_b} (tol "
          f"{ATTN_ROW_REL['bfloat16']}, {BWD_ROW_REL['bfloat16']})")
    bias = torch.where(mask[:, None, None, :] != 0, 0.0, attention.MASK_BIAS).to(q.dtype)
    fwd["ms"] = cuda_ms(lambda: attention.fused_attention(q, k, v, mask, **kw))
    fwd["plain_ms"] = cuda_ms(lambda: attention.fused_attention_reference(q, k, v, mask, **kw),
                              reps=3)
    fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
    bwd["ms"] = cuda_ms(lambda: attention._backward_kernel(q, k, v, mask, do, scale, rate, seed))
    bwd["plain_ms"] = cuda_ms(lambda: attention.fused_attention_backward_reference(
        q, k, v, mask, do, **kw), reps=3)
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias)
    bwd["library_ms"] = cuda_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                                            retain_graph=True))
    n = b * h * t * dh * 2  # bytes of one bf16 [B, H, T, Dh] tensor
    fwd["bound_ms"], fwd["bound_by"] = bound(4 * n + mask.numel() * 4, 4 * b * h * t * t * dh)
    bwd["bound_ms"], bwd["bound_by"] = bound(7 * n + mask.numel() * 4, 10 * b * h * t * t * dh)
    log(f"K2/K3 [{b}, {h}, {t}, {dh}] bf16 rate {rate}: max_abs_err {fwd['max_abs_err']:.3g}, "
        f"{bwd['max_abs_err']:.3g}, row errors {row_f:.3g}, {row_b:.3g}; K2 {fwd['ms']:.4f} ms "
        f"(plain {fwd['plain_ms']:.4f}, SDPA "
        f"rate 0 {fwd['library_ms']:.4f}, bound {fwd['bound_ms']:.4f} {fwd['bound_by']}); K3 "
        f"{bwd['ms']:.4f} ms (plain {bwd['plain_ms']:.4f}, SDPA backward rate 0 "
        f"{bwd['library_ms']:.4f}, bound {bwd['bound_ms']:.4f} {bwd['bound_by']})")
    return fwd, bwd


def _attention_counts() -> dict:
    from proqa_tpu_torch.ops import attention

    return {"K2": attention.launches, "K3": attention.backward_launches}


def _reset_kernel_counts() -> None:
    from proqa_tpu_torch.ops import attention, dropout

    attention.launches = attention.backward_launches = dropout.launches = 0
    _reset_fused_counts()


def _minilm_batch(device, b, tq, tc, seed, vocab):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    ids_c = torch.randint(5, vocab, (b, tc), device=device, generator=g)
    lengths = torch.randint(tc // 2, tc + 1, (b,), device=device, generator=g)
    mask_c = (torch.arange(tc, device=device)[None] < lengths[:, None]).to(torch.int32)
    ids_c = ids_c * mask_c
    return {"input_ids_q": ids_c[:, :tq].clone(),  # each question is its paragraph's opening
            "input_mask_q": torch.ones(b, tq, dtype=torch.int32, device=device),
            "input_ids_c": ids_c, "input_mask_c": mask_c}


def _grad_check(label, state, cfg0, batch, device) -> dict:
    """The dropout-0 step's gradients on four routes (K2/K3 with F1/F2; the
    vanilla attention path; K2/K3 with the plain epilogue chain; vanilla in
    f32), held as phase 19 holds them: cosine >= GRAD_COS to the vanilla
    path and to the plain chain, else the kernels' distance from the f32
    gradient at most GRAD_NOISE times the other route's."""
    import dataclasses

    import torch

    from proqa_tpu_torch.models.retriever import Retriever
    from proqa_tpu_torch.ops import fused_bert

    routes = {"kernels": dict(flash_attention=True), "vanilla": dict(flash_attention=False),
              "plain chain": dict(flash_attention=True),
              "f32": dict(flash_attention=False, dtype=torch.float32)}
    losses, grads = {}, {}
    gen = torch.Generator().manual_seed(0)
    for route, kw in routes.items():
        model = Retriever(dataclasses.replace(cfg0, **kw))
        model.load_state_dict(state)
        model = model.to(device)
        chain = fused_bert._eager_chain() if route == "plain chain" else contextlib.nullcontext()
        with chain:
            losses[route], grads[route] = _grads(model, batch, gen)
        del model

    def cosine(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return (a @ b / (a.norm() * b.norm())).item()

    out = {}
    for other in ("vanilla", "plain chain"):
        cos, ratio = {}, {}
        for name, gk in grads["kernels"].items():
            # zero in exact arithmetic, only rounding noise (phase 8)
            if name.endswith(".k.bias") or name == "proj_c.bias":
                continue
            g32 = grads["f32"][name]
            cos[name] = cosine(gk, grads[other][name])
            ratio[name] = ((gk - g32).double().norm() / (grads[other][name] - g32).double().norm()
                           ).item()
        bad = [n for n in cos if cos[n] < GRAD_COS and not ratio[n] <= GRAD_NOISE]
        worst = sorted(cos, key=cos.get)[:3]
        log(f"{label} dropout-0 step, kernels vs {other}: loss {losses['kernels']:.6f} vs "
            f"{losses[other]:.6f} (f32 {losses['f32']:.6f}); lowest gradient cosines over "
            f"{len(cos)} tensors (|kernels - f32| / |{other} - f32|): "
            + ", ".join(f"{n} {cos[n]:.6f} ({ratio[n]:.3f})" for n in worst)
            + f"; tol: cosine {GRAD_COS}, else error ratio {GRAD_NOISE}")
        check(not bad, f"{label} dropout-0 gradients, kernels vs {other}: {len(bad)} tensors "
                       f"under cosine {GRAD_COS} with the kernels' error from the f32 gradient "
                       f"over {GRAD_NOISE}x, e.g. {bad[:3]}")
        out[other] = cos[worst[0]]
    return out


def phase_minilm(device) -> tuple[list, dict]:
    """MiniLM-L12-H384 (12 heads of 32) on the card, random seeded weights:
    (a) K2 and K3 at Dh 32 and 128 and a padded head dim against their plain
    versions, and timed at the slice's shapes; (b) the context tower over
    512 rows at T = 512 (K2, F1/F2, no graph) against the vanilla attention
    path, then 2,048 encoded questions searched over those rows and a seeded
    bf16 corpus against the exact search; (c) the QA reader over 8 x 5 x 512
    rows with K2 against the vanilla path; (d) the retriever train step at
    80 x (32 + 512), remat, dropout 0.1, three steps, and a dropout-0 step's
    gradients; K2/K3 counted in (b)-(d). Then a tower of 8 heads of 128
    (hidden 1,024, 2 layers): an encode and a train step, K2/K3 counted.
    Returns the kernels line's entries of the new forms and the phase's
    numbers."""
    import dataclasses

    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.reader import QAConfig, QAModel
    from proqa_tpu_torch.models.retriever import Retriever
    from proqa_tpu_torch.ops import mips, mips_kernel, rescore
    from proqa_tpu_torch.testing import topk_disagreements
    from proqa_tpu_torch.train.optim import AdamW, init_train_state
    from proqa_tpu_torch.train.retriever_trainer import train_step

    gpu = gpu_line()
    cfg = BertConfig(**MINILM, flash_attention=True)
    check(cfg.head_dim == 32, f"MiniLM head dim {cfg.head_dim}")
    vanilla_cfg = dataclasses.replace(cfg, flash_attention=False)

    # (a) the kernels
    t0 = time.perf_counter()
    errs = {32: _attention_checks(device, 32, 12), 128: _attention_checks(device, 128, 8),
            PADDED_DH: _attention_checks(device, PADDED_DH, 8)}
    forms = {32: _attention_form(device, 512, 12, 512, 32, 0.0),
             "32 train": _attention_form(device, 80, 12, 512, 32, 0.1),
             128: _attention_form(device, 64, 8, 512, 128, 0.1)}
    log(f"{gpu}: MiniLM (a) K2/K3 at Dh 32, 128 and {PADDED_DH} (padded to 64), bf16 and f32, "
        f"T in {MINILM_T}, rates 0 and 0.1: max abs err, row errors and controls "
        f"{json.dumps(errs)} (tol {ATTN_TOL}, {BWD_TOL}; rows {json.dumps(ATTN_ROW_REL)}, "
        f"{json.dumps(BWD_ROW_REL)}); K3 two launches bit-equal; "
        f"{time.perf_counter() - t0:.1f} s")

    # (b) encode, then search
    model = Retriever(cfg).reset_parameters(21).to(device).eval()
    vanilla = Retriever(vanilla_cfg).to(device).eval()
    vanilla.load_state_dict(model.state_dict())
    batch = _minilm_batch(device, 512, 32, 512, 22, cfg.vocab_size)
    ids, mask = batch["input_ids_c"], batch["input_mask_c"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _reset_kernel_counts()
    with torch.inference_mode():
        rows = model.encode_context(ids, mask)
        torch.cuda.synchronize()
        counts = {"encode": {**_attention_counts(), **_fused_counts()}}
        encode_peak = torch.cuda.max_memory_allocated() / 2**30  # the kernels' encode alone
        plain_rows = vanilla.encode_context(ids, mask)
        encode_ms = cuda_ms(lambda: model.encode_context(ids, mask), reps=3)
    cos = torch.nn.functional.cosine_similarity(rows, plain_rows, dim=1).min().item()
    check(bool(torch.isfinite(rows).all()) and rows.shape == (512, 128),
          "MiniLM encode: bad embeddings")
    check(cos >= ENCODER_COS, f"MiniLM encode with K2 vs vanilla: min cosine {cos} < "
                              f"{ENCODER_COS}")
    check(counts["encode"]["K2"] == cfg.num_layers and counts["encode"]["F1"] > 0,
          f"MiniLM encode: launches {counts['encode']}")
    del vanilla, plain_rows
    # 2,048 questions (T = 32: the vanilla path) over the 512 rows and a
    # seeded bf16 corpus of the rows' scale, 262,144 rows in all
    qbatch = _minilm_batch(device, 2048, 32, 128, 23, cfg.vocab_size)
    n_q = qbatch["input_ids_q"].shape[0]
    with torch.inference_mode():
        questions = torch.cat([model.encode_query(qbatch["input_ids_q"][i:i + 512],
                                                  qbatch["input_mask_q"][i:i + 512])
                               for i in range(0, n_q, 512)])
    g = torch.Generator(device=device).manual_seed(24)
    filler = torch.randn(262_144 - len(rows), 128, device=device, generator=g) * rows.std()
    corpus = torch.cat([rows, filler]).bfloat16()
    del filler
    index = DenseIndex.from_embeddings(corpus, device=device, dtype=torch.bfloat16)
    mips_kernel.launches = rescore.launches = 0
    vals, idx = index.search(questions, 80)
    counts["search"] = {"K1": mips_kernel.launches, "K6": rescore.launches}
    bad = 0
    qb = questions.bfloat16()
    for s in range(0, n_q, 256):
        rv, ri = mips.mips_topk_reference(qb[s:s + 256], corpus, 80)
        bad += topk_disagreements(vals[s:s + 256], idx[s:s + 256], rv.cpu().numpy(),
                                  ri.cpu().numpy(), atol=TOPK_TOL)
    check(bad == 0, f"MiniLM search: {bad} of {n_q} questions disagree with the exact top-80")
    check(all(n > 0 for n in counts["search"].values()), f"MiniLM search: {counts['search']}")
    hits = int((torch.from_numpy(idx[:, :1]) < len(rows)).sum())
    encode_wall = time.perf_counter() - t0
    log(f"{gpu}: MiniLM (b) encode 512 x 512 bf16 with K2 (Dh 32) and F1/F2: min cosine "
        f"{cos:.6f} to vanilla (tol {ENCODER_COS}); {encode_ms:.2f} ms per batch = "
        f"{512 * 512 / encode_ms * 1e3:.0f} padded tokens/s (CUDA events); search of 2,048 "
        f"encoded questions over 262,144 rows (512 encoded): all agree with the exact top-80 up "
        f"to ties ({hits} top-1 among the encoded rows); launches {json.dumps(counts)}; wall "
        f"{encode_wall:.1f} s; peak of the kernels' encode {encode_peak:.2f} GiB")
    del index, corpus, questions, rows, model

    # (c) the reader over 8 questions x 5 paragraphs of 512
    t0 = time.perf_counter()
    reader = QAModel(cfg, QAConfig()).reset_parameters(25).to(device).eval()
    plain = QAModel(vanilla_cfg, QAConfig()).to(device).eval()
    plain.load_state_dict(reader.state_dict())
    qpb, k, t, tq = 8, 5, 512, 30
    rel_err, rel_ctrl, reader_ms, reader_peak = 0.0, float("inf"), None, 0.0
    counts["reader"] = {"K2": 0, "F1": 0}
    for bi in range(READER_BATCHES):
        g = torch.Generator(device=device).manual_seed(26 + bi)
        ids = torch.randint(5, cfg.vocab_size, (qpb, k, t), device=device, generator=g)
        lengths = torch.randint(t // 2, t + 1, (qpb, k), device=device, generator=g)
        pos = torch.arange(t, device=device)
        in_mask = (pos < lengths[..., None]).to(torch.int32)
        segment = (pos >= tq + 2).to(torch.int32).expand(qpb, k, t) * in_mask
        dev = {"input_ids": ids * in_mask, "input_mask": in_mask, "segment_ids": segment,
               "paragraph_mask": segment,
               "input_ids_q": torch.randint(5, cfg.vocab_size, (qpb, tq), device=device,
                                            generator=g),
               "input_mask_q": torch.ones(qpb, tq, dtype=torch.int32, device=device),
               "para_embed": torch.randn(qpb, 16, 128, device=device, generator=g)}
        before = {**_attention_counts(), **_fused_counts()}
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            out_k2 = reader(dev)
            after = {**_attention_counts(), **_fused_counts()}
            reader_peak = max(reader_peak, torch.cuda.max_memory_allocated() / 2**30)
            out_v = plain(dev)
            if bi == 0:
                reader_ms = cuda_ms(lambda: reader(dev), reps=3)
        for name in counts["reader"]:
            counts["reader"][name] += after[name] - before[name]
        in_para = dev["paragraph_mask"] == 1
        keys = ("start_logits", "end_logits")
        scale = max(out_v[key][in_para].abs().max().item() for key in keys)
        err = max((out_k2[key] - out_v[key])[in_para].abs().max().item() for key in keys)
        ctrl = max((out_v[key][in_para].to(torch.float8_e4m3fn).float()
                    - out_v[key][in_para]).abs().max().item() for key in keys)
        rel_err, rel_ctrl = max(rel_err, err / scale), min(rel_ctrl, ctrl / scale)
        check(err <= READER_REL * scale, f"MiniLM reader with K2 vs vanilla, batch {bi}: span "
                                         f"logits differ by {err} > {READER_REL} x {scale}")
    check(rel_ctrl > READER_REL, f"MiniLM reader: the e4m3 control ({rel_ctrl}) passes "
                                 f"{READER_REL}: the check would not see one coarser rounding")
    check(counts["reader"]["K2"] == READER_BATCHES * cfg.num_layers,
          f"MiniLM reader: launches {counts['reader']}")
    reader_wall = time.perf_counter() - t0
    log(f"{gpu}: MiniLM (c) reader {qpb} x {k} x {t} bf16 with K2 vs vanilla over "
        f"{READER_BATCHES} batches: span logits max abs err {rel_err:.4g} of the batch's "
        f"largest (tol {READER_REL}; e4m3 control {rel_ctrl:.4g}); one reader batch "
        f"{reader_ms:.3f} ms = {qpb * k * t / reader_ms * 1e3:.0f} reader tokens/s (CUDA "
        f"events); launches {json.dumps(counts['reader'])}; wall {reader_wall:.1f} s; peak of "
        f"the kernels' reader {reader_peak:.2f} GiB")
    del reader, plain, out_k2, out_v, dev

    # (d) the retriever train step, then the dropout-0 gradients
    b, tq, tc, steps = 80, 32, 512, 3
    tcfg = dataclasses.replace(cfg, remat=True)  # dropout 0.1
    batch = _minilm_batch(device, b, tq, tc, 27, cfg.vocab_size)
    model = Retriever(tcfg).reset_parameters(28).to(device)
    state = init_train_state(dict(model.named_parameters()))
    tx, gen = AdamW(1e-4), torch.Generator().manual_seed(29)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _reset_kernel_counts()
    losses, walls = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        state, m = train_step(model, state, tx, batch, gen)
        losses.append(float(m["loss"]))  # synchronises
        walls.append(time.perf_counter() - t1)
    counts["train"] = {**_attention_counts(), **_fused_counts()}
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"MiniLM train step: loss {losses} did not fall")
    check(all(n > 0 for n in counts["train"].values()), f"MiniLM train step: a kernel never ran "
                                                        f"{counts['train']}")
    cfg0 = dataclasses.replace(tcfg, hidden_dropout=0.0, attention_dropout=0.0)
    trained = {name: p.detach().clone() for name, p in model.state_dict().items()}
    del model, state
    torch.cuda.empty_cache()
    grad_cos = _grad_check("MiniLM", trained, cfg0, batch, device)
    train_wall = time.perf_counter() - t0
    step_ms = statistics.median(walls) * 1e3
    log(f"{gpu}: MiniLM (d) train step bf16 remat flash dropout 0.1, {b} x ({tq} + {tc}): "
        f"losses {' -> '.join(f'{x:.4f}' for x in losses)}; {step_ms:.1f} ms per step (median "
        f"of {steps}, host clock, synchronised, the first step included), "
        f"{b * (tq + tc) / step_ms * 1e3:.0f} tokens/s; launches in {steps} steps "
        f"{json.dumps(counts['train'])}; wall {train_wall:.1f} s, peak {train_peak:.2f} GiB")
    del trained, batch

    # a tower of 8 heads of 128 (hidden 1,024, 2 layers): encode and train step
    t0 = time.perf_counter()
    wide = BertConfig(**{**MINILM, "hidden_size": 1024, "num_heads": 8,
                         "intermediate_size": 4096, "num_layers": 2}, flash_attention=True,
                      remat=True)
    check(wide.head_dim == 128, f"wide head dim {wide.head_dim}")
    model = Retriever(wide).reset_parameters(30).to(device)
    batch = _minilm_batch(device, 64, 32, 512, 31, wide.vocab_size)
    vanilla = Retriever(dataclasses.replace(wide, flash_attention=False)).to(device).eval()
    vanilla.load_state_dict(model.state_dict())
    _reset_kernel_counts()
    with torch.inference_mode():
        rows = model.eval().encode_context(batch["input_ids_c"], batch["input_mask_c"])
        counts["dh128 encode"] = _attention_counts()
        wide_cos = torch.nn.functional.cosine_similarity(
            rows, vanilla.encode_context(batch["input_ids_c"], batch["input_mask_c"]),
            dim=1).min().item()
    del vanilla, rows
    check(wide_cos >= ENCODER_COS, f"Dh 128 encode with K2 vs vanilla: min cosine {wide_cos}")
    state = init_train_state(dict(model.named_parameters()))
    _reset_kernel_counts()
    _, m = train_step(model.train(), state, AdamW(1e-4), batch, torch.Generator().manual_seed(32))
    check(math.isfinite(float(m["loss"])), f"Dh 128 train step: loss {m['loss']}")
    counts["dh128 train"] = _attention_counts()
    check(counts["dh128 encode"]["K2"] == wide.num_layers and counts["dh128 train"]["K3"] > 0,
          f"Dh 128 tower: launches {counts['dh128 encode']}, {counts['dh128 train']}")
    del model, state, batch
    log(f"{gpu}: Dh 128 tower (8 heads of 128, hidden 1,024, 2 layers), 64 x 512 bf16: encode "
        f"with K2 min cosine {wide_cos:.6f} to vanilla (tol {ENCODER_COS}); one train step; "
        f"launches {json.dumps({n: counts[n] for n in ('dh128 encode', 'dh128 train')})}; wall "
        f"{time.perf_counter() - t0:.1f} s")

    k2_32 = counts["encode"]["K2"] + counts["reader"]["K2"] + counts["train"]["K2"]
    k2_128 = counts["dh128 encode"]["K2"] + counts["dh128 train"]["K2"]
    fwd32, bwd32 = forms[32][0], forms["32 train"][1]
    entries = [
        ("fused_attention (K2) Dh=32 [512, 12, 512, 32]", "attention_fwd.cu",
         "proqa_tpu/ops/pallas_attention.py:65", k2_32,
         {**fwd32, "max_abs_err": max(errs[32]["fwd_err"], errs[PADDED_DH]["fwd_err"],
                                      fwd32["max_abs_err"], forms["32 train"][0]["max_abs_err"])}),
        ("fused_attention backward (K3) Dh=32 [80, 12, 512, 32]", "attention_bwd.cu",
         "proqa_tpu/ops/pallas_attention.py:83", counts["train"]["K3"],
         {**bwd32, "max_abs_err": max(errs[32]["bwd_err"], errs[PADDED_DH]["bwd_err"],
                                      bwd32["max_abs_err"], forms[32][1]["max_abs_err"])}),
        ("fused_attention (K2) Dh=128 [64, 8, 512, 128]", "attention_fwd.cu",
         "proqa_tpu/ops/pallas_attention.py:65", k2_128,
         {**forms[128][0], "max_abs_err": max(errs[128]["fwd_err"],
                                              forms[128][0]["max_abs_err"])}),
        ("fused_attention backward (K3) Dh=128 [64, 8, 512, 128]", "attention_bwd.cu",
         "proqa_tpu/ops/pallas_attention.py:83", counts["dh128 train"]["K3"],
         {**forms[128][1], "max_abs_err": max(errs[128]["bwd_err"],
                                              forms[128][1]["max_abs_err"])}),
    ]
    return entries, {"counts": counts, "grad_cos": grad_cos, "losses": losses,
                     "encode_cos": cos, "reader_rel": rel_err}


# --- BERT-xlarge: F1 and F2 at every width ------------------------------------

# Lan et al., ALBERT (ICLR 2020, arXiv:1909.11942), Table 1: BERT-xlarge, 24
# layers, hidden and embedding 2,048, 1,270M parameters; feed-forward 4H =
# 8,192 and H / 64 = 32 heads of 64 as that paper sets them (Megatron-LM's
# 1.3B BERT, arXiv:1909.08053, has the same widths). BERT's vocabulary, 512
# positions, 2 token types, exact GELU, post-LN as the JAX package builds it.
XLARGE = dict(vocab_size=30522, hidden_size=2048, num_layers=24, num_heads=32,
              intermediate_size=8192, max_position_embeddings=512, type_vocab_size=2)
# albert-xxlarge-v2's config.json (named, not downloaded): hidden 4,096, 64
# heads of 64, intermediate 16,384; as a 2-layer tower of the JAX package's
# BERT layer (it has no parameter sharing and no factorised embedding)
XXLARGE = dict(XLARGE, hidden_size=4096, num_layers=2, num_heads=64, intermediate_size=16384)
# F2's widths past 1,024 (both ends of the row forms, the stream form, an
# odd width) and F1's past 12,288, held against their plain versions
WIDE_LN = (1025, 1152, 2048, 2560, 3001, 4096, 8192, 32768)
WIDE_COLS = (12289, 16384, 40000)
XLARGE_GRAD_BATCH = 16  # the dropout-0 gradient check's pairs (the train steps take 80)
# the depths at which the reader's K2 route is held to the vanilla path
# within READER_REL, and the dropout-0 gradients to the plain chain at
# GRAD_COS: at XLARGE's widths with random weights two bf16 routes part
# with depth until, at 24 layers, they are as far from each other as each
# is from the f32 route (phase 33 logs both at 24: the reader's logits 0.2
# of the largest apart, the gradients' cosines near 0), so no tolerance
# there could tell a defect from rounding. At 4 layers the bf16 routes sit
# well inside both tolerances (the gradients' plain chain reads cosine
# 0.999 to f32 there, logged beside the check)
XLARGE_READER_LAYERS = 4
XLARGE_GRAD_LAYERS = 4
# the train steps' learning rate: the retriever trainer's default
# (RetrieverTrainerConfig); the other phases' 1e-4 with no warmup is too
# large a first step for 2.5B parameters (an earlier run of this phase at
# 1e-4 read losses 5.80 -> 6.31 -> 6.66)
XLARGE_LR = 1e-5


def _on_device(make, cfg, device, seed: int):
    """make() built on the card and given the JAX package's random
    initialisation there from a seeded CUDA generator (the two towers'
    2.5B f32 parameters drawn on the host would cost tens of seconds)."""
    import torch

    from proqa_tpu_torch.models.bert import init_parameters

    with torch.device(device):
        model = make()
    init_parameters(model, cfg.initializer_range,
                    torch.Generator(device=device).manual_seed(seed))
    return model


def _sharing(make, model):
    """make() on the meta device, then given model's tensors (no copy): the
    same weights on another route."""
    import torch

    with torch.device("meta"):
        other = make()
    other.load_state_dict(model.state_dict(), assign=True)
    return other


def _wide_ln_check(device, rows: int, h: int, dt, residual: bool, unaligned: bool,
                   g) -> dict:
    """F2 and its backward at [rows, h] against their plain versions; two
    backward launches bit-equal. Returns the errors."""
    import torch

    from proqa_tpu_torch.ops import fused_bert

    x = torch.randn(rows, h, device=device, generator=g).to(dt)
    if unaligned:  # 2 bytes past a 16-byte boundary: the element bodies
        x = torch.empty(x.numel() + 1, device=device, dtype=dt)[1:].view_as(x).copy_(x)
    r = (torch.randn(rows, h, device=device, generator=g) * 0.5 + 0.25).to(dt) if residual \
        else None
    dy = torch.randn(rows, h, device=device, generator=g).to(dt)
    scale = 1.0 + 0.1 * torch.randn(h, device=device, generator=g)
    bias = 0.1 * torch.randn(h, device=device, generator=g)
    label = (f"F2 [{rows}, {h}] {str(dt)[6:]}{' + residual' if residual else ''}"
             f"{' unaligned' if unaligned else ''}")
    out, mean, rstd = fused_bert._add_layer_norm_kernel(x, r, scale, bias, 1e-12,
                                                        save_stats=True)
    want, want_mean, want_rstd = fused_bert._layer_norm_plain(x, r, scale, bias, 1e-12)
    got = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale, True, True)
    again = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale, True, True)
    plain = fused_bert.add_layer_norm_backward_reference(dy, x, r, mean, rstd, scale)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{label} backward: two launches differ")
    s32 = (x if r is None else x + r).float()
    xh = (s32 - mean[:, None]) * rstd[:, None]
    sum_err = max(_colsum_err(got[1], plain[1], dy.float() * xh),
                  _colsum_err(got[2], plain[2], dy.float()))
    check(sum_err <= COLSUM_REL, f"{label} backward: dscale/dbias off by {sum_err} of their "
                                 f"terms (tol {COLSUM_REL})")
    stats_err = max((mean - want_mean).abs().max().item(),
                    ((rstd - want_rstd).abs() / want_rstd).max().item())
    check(stats_err <= LN_F32_TOL, f"{label}: mean/rstd off by {stats_err} (tol {LN_F32_TOL})")
    if dt is torch.bfloat16:
        ulps, dx_ulps = _bf16_ulps(out, want, LN_ULP_FLOOR), _bf16_ulps(got[0], plain[0],
                                                                         LN_ULP_FLOOR)
        check(ulps <= 1.0 and dx_ulps <= BWD_ULPS,
              f"{label}: {ulps} bf16 ulps forward (tol 1), dx {dx_ulps} (tol {BWD_ULPS})")
    else:
        ulps = dx_ulps = None
        for name, a, b in (("forward", out, want), ("dx", got[0], plain[0])):
            check(torch.allclose(a, b, atol=LN_F32_TOL, rtol=LN_F32_TOL),
                  f"{label} {name}: max abs err {(a - b).abs().max().item()} > {LN_F32_TOL}")
    return {"max_abs_err": (out.float() - want.float()).abs().max().item(),
            "dx_max_abs_err": (got[0].float() - plain[0].float()).abs().max().item(),
            "bf16_ulps": ulps, "dx_bf16_ulps": dx_ulps, "colsum_rel_err": sum_err}


def _wide_dense_check(device, rows: int, cols: int, gelu: bool, g) -> dict:
    """F1 (bf16 and f32 out) and its backward at [rows, cols] against their
    plain versions, bit for bit where they allow; two backward launches
    bit-equal. Returns the column sum's error."""
    import torch

    from proqa_tpu_torch.ops import fused_bert

    y = torch.randn(rows, cols, device=device, generator=g) * 2.0
    b = torch.randn(cols, device=device, generator=g) * 0.1
    label = f"F1 [{rows}, {cols}]{' GELU' if gelu else ''}"
    for dt in (torch.bfloat16, torch.float32):
        out, z = fused_bert._dense_epilogue_kernel(y, b, dt, gelu, save_z=gelu)
        check(torch.equal(out, fused_bert.dense_epilogue_reference(y, b, dt, gelu))
              and (not gelu or torch.equal(z, (y + b).to(dt))),
              f"{label} {dt}: not bit-equal to its plain version")
    dout = torch.randn(rows, cols, device=device, generator=g).bfloat16()
    z = (y + b).bfloat16() if gelu else None
    got = fused_bert._dense_epilogue_backward_kernel(dout, z, gelu, True, True)
    again = fused_bert._dense_epilogue_backward_kernel(dout, z, gelu, True, True)
    want = fused_bert.dense_epilogue_backward_reference(dout, z, gelu)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]), f"{label} backward: dz not bit-equal")
    check(all(torch.equal(a, c) for a, c in zip(got, again)),
          f"{label} backward: two launches differ")
    sum_err = _colsum_err(got[1], want[1], want[0].float())
    check(sum_err <= COLSUM_REL, f"{label} backward: bias sum off by {sum_err} (tol "
                                 f"{COLSUM_REL})")
    return {"colsum_rel_err": sum_err}


def _wide_checks(device) -> dict:
    """(a): F2 at WIDE_LN (bf16 and f32, with and without a residual, one
    unaligned row pointer in bf16) and F1 at WIDE_COLS (with and without
    GELU), forward and backward, against their plain versions; every
    launch's form counted."""
    import torch

    from proqa_tpu_torch.ops import fused_bert

    g = torch.Generator(device=device).manual_seed(33)
    fused_bert.form_launches.clear()
    worst = {"F2 bf16 ulps": 0.0, "F2 dx bf16 ulps": 0.0, "F2 max_abs_err": 0.0,
             "F2 colsum_rel_err": 0.0, "F1 colsum_rel_err": 0.0}
    for h in WIDE_LN:
        rows = max(8, min(130, 2 ** 21 // h))  # a few sub-slabs and blocks, small inputs
        for dt in (torch.bfloat16, torch.float32):
            for residual in (True, False):
                for unaligned in ((False, True) if dt is torch.bfloat16 and residual else (False,)):
                    e = _wide_ln_check(device, rows, h, dt, residual, unaligned, g)
                    worst["F2 max_abs_err"] = max(worst["F2 max_abs_err"], e["max_abs_err"])
                    worst["F2 colsum_rel_err"] = max(worst["F2 colsum_rel_err"],
                                                     e["colsum_rel_err"])
                    if dt is torch.bfloat16:
                        worst["F2 bf16 ulps"] = max(worst["F2 bf16 ulps"], e["bf16_ulps"])
                        worst["F2 dx bf16 ulps"] = max(worst["F2 dx bf16 ulps"], e["dx_bf16_ulps"])
    for cols in WIDE_COLS:
        for gelu in (False, True):
            e = _wide_dense_check(device, 257, cols, gelu, g)
            worst["F1 colsum_rel_err"] = max(worst["F1 colsum_rel_err"], e["colsum_rel_err"])
    forms = dict(fused_bert.form_launches)
    for form in ("F2 row", "F2 stream", "F2 backward row", "F2 backward stream", "F1 wide"):
        check(forms.get(form, 0) > 0, f"wide checks: form {form} never launched: {forms}")
    return {**worst, "forms": forms}


def _wide_times(device) -> list:
    """The new forms timed at the slice's shapes, each against its plain
    version first: F2's row form at the xlarge encode's [131,072, 2,048] bf16
    with a residual and its backward at the xlarge train step's [40,960,
    2,048]; F1's wide form at the xxlarge tower's [32,768, 16,384] with GELU
    and F1's backward there. Each by one call between CUDA events and its
    kernels alone (kernel_ms) beside its plain version, its bound and one
    library call where one computes the same function. Returns (name, shape,
    result) a form."""
    import torch

    from proqa_tpu_torch.ops import fused_bert

    g = torch.Generator(device=device).manual_seed(34)
    runs = []
    n, h = 256 * 512, 2048
    x, r = (torch.randn(n, h, device=device, generator=g).bfloat16() for _ in range(2))
    scale = 1.0 + 0.1 * torch.randn(h, device=device, generator=g)
    bias = 0.1 * torch.randn(h, device=device, generator=g)
    got = fused_bert.add_layer_norm(x, r, scale, bias, 1e-12)
    ulps = _bf16_ulps(got, fused_bert.add_layer_norm_reference(x, r, scale, bias, 1e-12),
                      LN_ULP_FLOOR)
    check(ulps <= 1.0, f"F2 [{n}, {h}]: {ulps} bf16 ulps")
    run = lambda: fused_bert.add_layer_norm(x, r, scale, bias, 1e-12)  # noqa: E731
    sc, bi = scale.bfloat16(), bias.bfloat16()
    bound_ms, by = bound(3 * n * h * 2 + 2 * h * 4, 10 * n * h, PEAK_F32_FLOPS)
    runs.append(("F2", f"row form [{n}, {h}] bf16 + residual (xlarge encode)", {
        "max_abs_err": (got.float() - fused_bert.add_layer_norm_reference(
            x, r, scale, bias, 1e-12).float()).abs().max().item(), "bf16_ulps": ulps,
        "ms": cuda_ms(run), "queued_ms": cuda_ms(run, calls=10), **kernel_ms(run),
        "plain_ms": cuda_ms(lambda: fused_bert.add_layer_norm_reference(x, r, scale, bias,
                                                                        1e-12)),
        "library_ms": cuda_ms(lambda: torch.nn.functional.layer_norm(x, (h,), sc, bi, 1e-12)),
        "bound_ms": bound_ms, "bound_by": by}))
    del x, r, got
    n = 80 * 512
    x, r, dy = (torch.randn(n, h, device=device, generator=g).bfloat16() for _ in range(3))
    _, mean, rstd = fused_bert._add_layer_norm_kernel(x, r, scale, bias, 1e-12, save_stats=True)
    got = fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale, True, True)
    want = fused_bert.add_layer_norm_backward_reference(dy, x, r, mean, rstd, scale)
    dx_ulps = _bf16_ulps(got[0], want[0], LN_ULP_FLOOR)
    check(dx_ulps <= BWD_ULPS, f"F2 backward [{n}, {h}]: dx {dx_ulps} bf16 ulps")
    s = x + r
    _, a_mean, a_rstd = torch.ops.aten.native_layer_norm(s, [h], sc, bi, 1e-12)
    run = lambda: fused_bert._add_layer_norm_backward_kernel(  # noqa: E731
        dy, x, r, mean, rstd, scale, True, True)
    bound_ms, by = bound(n * h * 2 * 4 + n * 8 + h * 4 + 2 * h * 4, n * h * 12, PEAK_F32_FLOPS)
    runs.append(("F2 backward", f"row form [{n}, {h}] bf16 + residual (xlarge step)", {
        "max_abs_err": (got[0].float() - want[0].float()).abs().max().item(),
        "bf16_ulps": dx_ulps, "ms": cuda_ms(run), "queued_ms": cuda_ms(run, calls=10),
        **kernel_ms(run),
        "plain_ms": cuda_ms(lambda: fused_bert.add_layer_norm_backward_reference(
            dy, x, r, mean, rstd, scale)),
        "library_ms": cuda_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, s, [h], a_mean, a_rstd, sc, bi, [True, True, True])),
        "bound_ms": bound_ms, "bound_by": by}))
    del x, r, dy, s, got, want, mean, rstd, a_mean, a_rstd
    n, cols = 64 * 512, 16384
    y = torch.randn(n, cols, device=device, generator=g) * 2.0
    b = torch.randn(cols, device=device, generator=g) * 0.1
    got = fused_bert.dense_epilogue(y, b, torch.bfloat16, True)
    check(torch.equal(got, fused_bert.dense_epilogue_reference(y, b, torch.bfloat16, True)),
          f"F1 [{n}, {cols}] GELU: not bit-equal")
    run = lambda: fused_bert.dense_epilogue(y, b, torch.bfloat16, True)  # noqa: E731
    bound_ms, by = bound(n * cols * 6 + cols * 4, n * cols * 25, PEAK_F32_FLOPS)
    out = torch.empty(n, cols, device=device, dtype=torch.bfloat16)
    no_gelu = {"ms": cuda_ms(lambda: fused_bert.dense_epilogue(y, b, torch.bfloat16)),
               "library_ms": cuda_ms(lambda: torch.add(y, b, out=out))}
    runs.append(("F1", f"wide form [{n}, {cols}] GELU bf16 (xxlarge tower)", {
        "max_abs_err": 0.0, "ms": cuda_ms(run), "queued_ms": cuda_ms(run, calls=10),
        **kernel_ms(run),
        "plain_ms": cuda_ms(lambda: fused_bert.dense_epilogue_reference(y, b, torch.bfloat16,
                                                                        True)),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": by,
        "without GELU (torch.add into bf16 as library)": no_gelu}))
    del y, out, got
    issue = gelu_backward_issue(device)
    dout = torch.randn(n, cols, device=device, generator=g).bfloat16()
    z = (torch.randn(n, cols, device=device, generator=g) * 2.0).bfloat16()
    got = fused_bert._dense_epilogue_backward_kernel(dout, z, True, True, True)
    want = fused_bert.dense_epilogue_backward_reference(dout, z, True)
    check(torch.equal(got[0], want[0]), f"F1 backward [{n}, {cols}]: dz not bit-equal")
    sum_err = _colsum_err(got[1], want[1], want[0].float())
    check(sum_err <= COLSUM_REL, f"F1 backward [{n}, {cols}]: bias sum off by {sum_err}")
    run = lambda: fused_bert._dense_epilogue_backward_kernel(dout, z, True, True, True)  # noqa
    bytes_ms = bound(n * cols * 6 + cols * 4, 0)[0]
    issue_ms = n * cols * issue["instructions_per_element"] / issue["issue_rate"] * 1e3
    bound_ms, by = max((bytes_ms, "bytes"), (issue_ms, "operations"))
    runs.append(("F1 backward", f"[{n}, {cols}] GELU bf16 (xxlarge step)", {
        "max_abs_err": 0.0, "colsum_rel_err": sum_err, "ms": cuda_ms(run),
        "queued_ms": cuda_ms(run, calls=10), **kernel_ms(run),
        "plain_ms": cuda_ms(lambda: fused_bert.dense_epilogue_backward_reference(dout, z, True)),
        "library_ms": cuda_ms(lambda: torch.ops.aten.gelu_backward(dout, z, approximate="none")),
        "bound_ms": bound_ms, "bound_by": by, "bytes_bound_ms": bytes_ms,
        "issue_bound_ms": issue_ms}))
    del dout, z, got, want
    torch.cuda.empty_cache()
    for kernel, label, result in runs:
        log(f"{kernel} {label}: {json.dumps(result)}")
    return runs


def _form_counts() -> dict:
    import torch

    from proqa_tpu_torch.ops import fused_bert

    torch.cuda.synchronize()
    return dict(fused_bert.form_launches)


def _lean_grads(model, batch, generator):
    """The loss and every parameter's gradient of one step, the gradients
    taken from the parameters (no copy)."""
    import torch

    from proqa_tpu_torch.train.retriever_trainer import in_batch_loss

    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = in_batch_loss(model(batch, generator=generator))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    return loss.item(), grads


def _xlarge_grad_check(model, cfg0, batch, device) -> dict:
    """(d)'s dropout-0 gradients, K2/K3 with F1/F2 against the plain epilogue
    chain (fused_bert._eager_chain) on the same weights and batch. At full
    depth, on the trained model: every gradient finite, the cosines logged
    (not held: see XLARGE_GRAD_LAYERS). Cut to XLARGE_GRAD_LAYERS at the same
    widths, fresh weights: every tensor at cosine >= GRAD_COS, the plain
    chain's own cosine to the f32 gradient (vanilla attention, f32
    activations) logged beside."""
    import dataclasses

    import torch

    from proqa_tpu_torch.models.retriever import Retriever
    from proqa_tpu_torch.ops import fused_bert

    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    zero = ("proj_c.bias",)  # with every k.bias: zero in exact arithmetic (phase 8)
    kern = _sharing(lambda: Retriever(cfg0), model)
    loss_k, grads_k = _lean_grads(kern, batch, gen())
    check(all(bool(torch.isfinite(g).all()) for g in grads_k.values()),
          "xlarge dropout-0 gradients: not finite")
    with fused_bert._eager_chain():
        loss_p, grads_p = _lean_grads(kern, batch, gen())
    cos = _cosines(grads_k, grads_p, skip=zero)
    full = {"loss": loss_k, "plain_loss": loss_p, "tensors": len(cos),
            "median cosine": statistics.median(cos.values()),
            "lowest cosines": {n: cos[n] for n in sorted(cos, key=cos.get)[:3]}}
    del kern, grads_k, grads_p
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg0, num_layers=XLARGE_GRAD_LAYERS)
    kern = _on_device(lambda: Retriever(cut), cut, device, 48)
    loss_k, grads_k = _lean_grads(kern, batch, gen())
    with fused_bert._eager_chain():
        loss_p, grads_p = _lean_grads(kern, batch, gen())
    f32 = _sharing(lambda: Retriever(dataclasses.replace(cut, flash_attention=False,
                                                         dtype=torch.float32)), kern)
    _, grads_f = _lean_grads(f32, batch, gen())
    cos = _cosines(grads_k, grads_p, skip=zero)
    cos_f = _cosines(grads_p, grads_f, skip=zero)
    worst = sorted(cos, key=cos.get)[:3]
    worst_f = min(cos_f, key=cos_f.get)
    del kern, f32, grads_k, grads_p, grads_f
    torch.cuda.empty_cache()
    check(cos[worst[0]] >= GRAD_COS,
          f"xlarge dropout-0 gradients ({XLARGE_GRAD_LAYERS} layers), kernels vs the plain "
          f"chain: cosine {cos[worst[0]]} < {GRAD_COS} ({worst[0]})")
    return {f"{cfg0.num_layers} layers (logged)": full,
            f"{XLARGE_GRAD_LAYERS} layers (tol {GRAD_COS})": {
                "loss": loss_k, "plain_loss": loss_p, "tensors": len(cos),
                "lowest cosines": {n: cos[n] for n in worst},
                "plain chain vs f32, lowest cosine": {worst_f: cos_f[worst_f]}}}


def _reader_batches(device, cfg, seed: int):
    """READER_BATCHES batches of 8 questions x 5 paragraphs of 512 (phase
    18's shapes), random ids of cfg's vocabulary."""
    import torch

    qpb, k, t, tq = 8, 5, 512, 30
    for bi in range(READER_BATCHES):
        g = torch.Generator(device=device).manual_seed(seed + bi)
        ids = torch.randint(5, cfg.vocab_size, (qpb, k, t), device=device, generator=g)
        lengths = torch.randint(t // 2, t + 1, (qpb, k), device=device, generator=g)
        pos = torch.arange(t, device=device)
        in_mask = (pos < lengths[..., None]).to(torch.int32)
        segment = (pos >= tq + 2).to(torch.int32).expand(qpb, k, t) * in_mask
        yield {"input_ids": ids * in_mask, "input_mask": in_mask, "segment_ids": segment,
               "paragraph_mask": segment,
               "input_ids_q": torch.randint(5, cfg.vocab_size, (qpb, tq), device=device,
                                            generator=g),
               "input_mask_q": torch.ones(qpb, tq, dtype=torch.int32, device=device),
               "para_embed": torch.randn(qpb, 16, 128, device=device, generator=g)}


def _span_logits(model, dev):
    import torch

    with torch.inference_mode():
        out = model(dev)
    in_para = dev["paragraph_mask"] == 1
    return torch.stack([out["start_logits"][in_para], out["end_logits"][in_para]])


def _counted(fn, into: dict):
    """fn(), with the launches it makes (F1/F2 by form, K2, K3) added into
    `into`: the counters zeroed just before and read just after."""
    import torch

    torch.cuda.synchronize()
    _reset_kernel_counts()
    out = fn()
    for key, n in {**_form_counts(), **_attention_counts()}.items():
        into[key] = into.get(key, 0) + n
    return out


def _xlarge_reader(device, cfg, launched: dict) -> dict:
    """(c): the QA reader at XLARGE's widths over READER_BATCHES batches of 8
    x 5 x 512 rows. Cut to XLARGE_READER_LAYERS, K2 against the vanilla path
    on the same weights within READER_REL of the batch's largest logit,
    beside phase 18's e4m3 control. At full depth the K2 route's logits must
    be finite; their distances from the vanilla bf16 and f32 routes are
    logged, not held (XLARGE_GRAD_LAYERS says why). Only the K2 route's
    launches are counted, into `launched`."""
    import dataclasses

    import torch

    from proqa_tpu_torch.models.reader import QAConfig, QAModel

    vanilla_cfg = dataclasses.replace(cfg, flash_attention=False)
    reader = _on_device(lambda: QAModel(cfg, QAConfig()), cfg, device, 39).eval()
    plain = _sharing(lambda: QAModel(vanilla_cfg, QAConfig()), reader).eval()
    f32 = _sharing(lambda: QAModel(dataclasses.replace(vanilla_cfg, dtype=torch.float32),
                                   QAConfig()), reader).eval()
    full = {"k2_from_vanilla": 0.0, "vanilla_from_f32": 0.0, "k2_from_f32": 0.0}
    for dev in _reader_batches(device, cfg, 40):
        got = _counted(lambda: _span_logits(reader, dev), launched)
        check(bool(torch.isfinite(got).all()), f"xlarge reader ({cfg.num_layers} layers): "
                                               f"logits not finite")
        van, ref = _span_logits(plain, dev), _span_logits(f32, dev)
        scale = ref.abs().max().item()
        for key, a, b in (("k2_from_vanilla", got, van), ("vanilla_from_f32", van, ref),
                          ("k2_from_f32", got, ref)):
            full[key] = max(full[key], (a - b).abs().max().item() / scale)
    del reader, plain, f32
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, num_layers=XLARGE_READER_LAYERS)
    reader = _on_device(lambda: QAModel(cut, QAConfig()), cut, device, 47).eval()
    plain = _sharing(lambda: QAModel(dataclasses.replace(cut, flash_attention=False),
                                     QAConfig()), reader).eval()
    rel_err, rel_ctrl = 0.0, float("inf")
    for bi, dev in enumerate(_reader_batches(device, cut, 48)):
        got = _counted(lambda: _span_logits(reader, dev), launched)
        van = _span_logits(plain, dev)
        scale = van.abs().max().item()
        err = (got - van).abs().max().item()
        ctrl = (van.to(torch.float8_e4m3fn).float() - van).abs().max().item()
        rel_err, rel_ctrl = max(rel_err, err / scale), min(rel_ctrl, ctrl / scale)
        check(err <= READER_REL * scale, f"xlarge reader ({XLARGE_READER_LAYERS} layers) with K2 "
                                         f"vs vanilla, batch {bi}: span logits differ by {err} > "
                                         f"{READER_REL} x {scale}")
    check(rel_ctrl > READER_REL, f"xlarge reader: the e4m3 control ({rel_ctrl}) passes "
                                 f"{READER_REL}: the check would not see one coarser rounding")
    del reader, plain
    torch.cuda.empty_cache()
    return {f"{cfg.num_layers} layers (logged), largest logit shares": full,
            f"{XLARGE_READER_LAYERS} layers, K2 from vanilla (tol {READER_REL})": rel_err,
            "e4m3 control": rel_ctrl}


def phase_xlarge(device) -> tuple[list, dict]:
    """BERT-xlarge (XLARGE; hidden 2,048, F2 past its warp form) on the card,
    random seeded weights built there: (a) F1 and F2 at every width form
    (WIDE_LN, WIDE_COLS) against their plain versions, and the new forms
    timed at the slice's shapes; (b) the context tower over 256 rows at T =
    512 (K2, F1/F2, no graph) against the plain epilogue chain, then 2,048
    encoded questions searched over those rows and a seeded bf16 corpus; (c)
    the QA reader over 8 x 5 x 512 rows with K2, cut to 4 layers against the
    vanilla path; (d) three retriever train steps at 80 x (32 + 512), remat,
    dropout 0.1, and a dropout-0 step's gradients against the plain chain,
    cut to 4 layers; (e) a 2-layer
    tower at ALBERT-xxlarge's widths (XXLARGE): an encode and a train step,
    F1 at 16,384 columns and F2 at 4,096. The forms' launches are counted in
    (b)-(e); each part logs its wall time and peak memory. Returns the
    kernels line's entries of the new forms and the phase's numbers."""
    import dataclasses

    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.reader import QAConfig, QAModel
    from proqa_tpu_torch.models.retriever import Retriever
    from proqa_tpu_torch.ops import fused_bert, mips, mips_kernel, rescore
    from proqa_tpu_torch.testing import topk_disagreements
    from proqa_tpu_torch.train.optim import AdamW, init_train_state
    from proqa_tpu_torch.train.retriever_trainer import train_step

    gpu = gpu_line()
    cfg = BertConfig(**XLARGE, flash_attention=True)
    check(cfg.head_dim == 64, f"xlarge head dim {cfg.head_dim}")
    counts, walls, peaks = {}, {}, {}

    def part(name):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_counts()
        return time.perf_counter()

    def done(name, t0, launched=None):
        counts[name] = launched or {**_form_counts(), **_attention_counts()}
        walls[name] = round(time.perf_counter() - t0, 1)
        peaks[name] = round(torch.cuda.max_memory_allocated() / 2**30, 2)

    # (a) the kernels
    t0 = time.perf_counter()
    errs = _wide_checks(device)
    times = _wide_times(device)
    walls["kernels"] = round(time.perf_counter() - t0, 1)
    log(f"{gpu}: xlarge (a) F2 at widths {WIDE_LN} (bf16 and f32, with and without a residual, "
        f"one unaligned) and F1 at {WIDE_COLS} columns (with and without GELU), forward and "
        f"backward: {json.dumps(errs)} (tol: F1 bit-equal, F2 1 bf16 ulp at >= {LN_ULP_FLOOR}, "
        f"dx {BWD_ULPS}, column sums {COLSUM_REL}); two backward launches bit-equal; "
        f"{walls['kernels']} s")

    # (b) encode against the plain chain, then search
    model = _on_device(lambda: Retriever(cfg), cfg, device, 35).eval()
    batch = _minilm_batch(device, 256, 32, 512, 36, cfg.vocab_size)
    ids, mask = batch["input_ids_c"], batch["input_mask_c"]
    t0 = part("encode")
    with torch.inference_mode():
        rows = model.encode_context(ids, mask)
    done("encode", t0)
    with torch.inference_mode():
        encode_ms = cuda_ms(lambda: model.encode_context(ids, mask), reps=3)
    plain_rows = []
    with fused_bert._eager_chain():  # the plain chain under autograd, 8 rows at a time
        for i in range(0, len(ids), 8):
            plain_rows.append(model.encode_context(ids[i:i + 8], mask[i:i + 8]).detach())
    plain_rows = torch.cat(plain_rows)
    cos = torch.nn.functional.cosine_similarity(rows, plain_rows, dim=1).min().item()
    del plain_rows
    check(bool(torch.isfinite(rows).all()) and rows.shape == (256, 128), "xlarge encode: bad rows")
    check(cos >= ENCODER_COS, f"xlarge encode with F1/F2 vs the plain chain: min cosine {cos} < "
                              f"{ENCODER_COS}")
    check(counts["encode"].get("F2 row", 0) == 2 * cfg.num_layers + 1
          and counts["encode"]["K2"] == cfg.num_layers, f"xlarge encode: {counts['encode']}")
    qbatch = _minilm_batch(device, 2048, 32, 128, 37, cfg.vocab_size)
    with torch.inference_mode():
        questions = torch.cat([model.encode_query(qbatch["input_ids_q"][i:i + 512],
                                                  qbatch["input_mask_q"][i:i + 512])
                               for i in range(0, 2048, 512)])
    g = torch.Generator(device=device).manual_seed(38)
    filler = torch.randn(262_144 - len(rows), 128, device=device, generator=g) * rows.std()
    corpus = torch.cat([rows, filler]).bfloat16()
    del filler
    index = DenseIndex.from_embeddings(corpus, device=device, dtype=torch.bfloat16)
    mips_kernel.launches = rescore.launches = 0
    vals, idx = index.search(questions, 80)
    counts["search"] = {"K1": mips_kernel.launches, "K6": rescore.launches}
    qb, bad = questions.bfloat16(), 0
    for s in range(0, 2048, 256):
        rv, ri = mips.mips_topk_reference(qb[s:s + 256], corpus, 80)
        bad += topk_disagreements(vals[s:s + 256], idx[s:s + 256], rv.cpu().numpy(),
                                  ri.cpu().numpy(), atol=TOPK_TOL)
    check(bad == 0, f"xlarge search: {bad} of 2048 questions disagree with the exact top-80")
    check(all(n > 0 for n in counts["search"].values()), f"xlarge search: {counts['search']}")
    walls["encode"] = round(time.perf_counter() - t0, 1)
    log(f"{gpu}: xlarge (b) encode 256 x 512 bf16 with K2 and F1/F2 (no graph): min cosine "
        f"{cos:.6f} to the plain epilogue chain (tol {ENCODER_COS}); {encode_ms:.2f} ms per "
        f"batch = {256 * 512 / encode_ms * 1e3:.0f} padded tokens/s (CUDA events); search of "
        f"2,048 encoded questions over 262,144 rows (256 encoded): all agree with the exact "
        f"top-80 up to ties; launches {json.dumps(counts['encode'])}, search "
        f"{json.dumps(counts['search'])}; wall {walls['encode']} s; peak of the encode "
        f"{peaks['encode']} GiB")
    del index, corpus, questions, rows, model
    torch.cuda.empty_cache()

    # (c) the reader over 8 questions x 5 paragraphs of 512: at full depth,
    # and cut to XLARGE_READER_LAYERS against vanilla; the K2 route counted
    t0 = part("reader")
    reader_launches = {}
    reader = _xlarge_reader(device, cfg, reader_launches)
    done("reader", t0, reader_launches)
    check(counts["reader"].get("F2 row", 0) > 0 and counts["reader"]["K2"] > 0,
          f"xlarge reader: {counts['reader']}")
    log(f"{gpu}: xlarge (c) reader {json.dumps(reader)}; launches (the K2 route alone) "
        f"{json.dumps(counts['reader'])}; wall {walls['reader']} s, peak {peaks['reader']} GiB")
    torch.cuda.empty_cache()

    # (d) the retriever train step, then the dropout-0 gradients
    b, tq, tc, steps = 80, 32, 512, 3
    tcfg = dataclasses.replace(cfg, remat=True)  # dropout 0.1
    batch = _minilm_batch(device, b, tq, tc, 41, cfg.vocab_size)
    model = _on_device(lambda: Retriever(tcfg), tcfg, device, 42)
    state = init_train_state(dict(model.named_parameters()))
    tx, gen = AdamW(XLARGE_LR), torch.Generator().manual_seed(43)
    losses, step_walls = [], []
    t0 = part("train")
    for _ in range(steps):
        t1 = time.perf_counter()
        state, m = train_step(model, state, tx, batch, gen)
        losses.append(float(m["loss"]))  # synchronises
        step_walls.append(time.perf_counter() - t1)
    done("train", t0)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"xlarge train step: loss {losses} did not fall")
    for form in ("F2 row", "F2 backward row", "F1 staged", "F1 backward slabs"):
        check(counts["train"].get(form, 0) > 0, f"xlarge train step: {form} never ran: "
                                                f"{counts['train']}")
    del state
    torch.cuda.empty_cache()
    cfg0 = dataclasses.replace(tcfg, hidden_dropout=0.0, attention_dropout=0.0)
    small = {key: v[:XLARGE_GRAD_BATCH] for key, v in batch.items()}
    t1 = time.perf_counter()
    grad = _xlarge_grad_check(model, cfg0, small, device)
    grad_wall = round(time.perf_counter() - t1, 1)
    step_ms = statistics.median(step_walls) * 1e3
    log(f"{gpu}: xlarge (d) train step bf16 remat flash dropout 0.1 AdamW lr {XLARGE_LR}, "
        f"{b} x ({tq} + {tc}): "
        f"losses {' -> '.join(f'{x:.4f}' for x in losses)}; {step_ms:.1f} ms per step (median "
        f"of {steps}, host clock, synchronised, the first included), "
        f"{b * (tq + tc) / step_ms * 1e3:.0f} tokens/s; launches in {steps} steps "
        f"{json.dumps(counts['train'])}; wall {walls['train']} s, peak {peaks['train']} GiB; "
        f"dropout-0 gradients at {XLARGE_GRAD_BATCH} x ({tq} + {tc}) against the plain chain: "
        f"{json.dumps(grad)}; {grad_wall} s")
    del model, batch, small
    torch.cuda.empty_cache()

    # (e) a 2-layer tower at ALBERT-xxlarge's widths: encode and train step
    wide = BertConfig(**XXLARGE, flash_attention=True, remat=True)
    check(wide.head_dim == 64, f"xxlarge head dim {wide.head_dim}")
    model = _on_device(lambda: Retriever(wide), wide, device, 44)
    batch = _minilm_batch(device, 64, 32, 512, 45, wide.vocab_size)
    t0 = part("xxlarge encode")
    with torch.inference_mode():
        rows = model.eval().encode_context(batch["input_ids_c"], batch["input_mask_c"])
    done("xxlarge encode", t0)
    plain_rows = []
    with fused_bert._eager_chain():
        for i in range(0, 64, 16):
            plain_rows.append(model.encode_context(batch["input_ids_c"][i:i + 16],
                                                   batch["input_mask_c"][i:i + 16]).detach())
    wide_cos = torch.nn.functional.cosine_similarity(rows, torch.cat(plain_rows),
                                                     dim=1).min().item()
    del rows, plain_rows
    check(wide_cos >= ENCODER_COS, f"xxlarge encode vs the plain chain: min cosine {wide_cos}")
    state = init_train_state(dict(model.named_parameters()))
    t0 = part("xxlarge train")
    _, m = train_step(model.train(), state, AdamW(1e-4), batch, torch.Generator().manual_seed(46))
    check(math.isfinite(float(m["loss"])), f"xxlarge train step: loss {m['loss']}")
    done("xxlarge train", t0)
    for name, forms in (("xxlarge encode", ("F1 wide", "F2 row")),
                        ("xxlarge train", ("F1 wide", "F2 row", "F2 backward row",
                                           "F1 backward slabs"))):
        for form in forms:
            check(counts[name].get(form, 0) > 0, f"{name}: {form} never ran: {counts[name]}")
    del model, state, batch
    torch.cuda.empty_cache()
    parts = ("xxlarge encode", "xxlarge train")
    log(f"{gpu}: xxlarge tower (hidden 4,096, 64 heads of 64, FFN 16,384, 2 layers), 64 x 512 "
        f"bf16: encode min cosine {wide_cos:.6f} to the plain chain (tol {ENCODER_COS}); one "
        f"train step; launches {json.dumps({n: counts[n] for n in parts})}; walls "
        f"{json.dumps({n: walls[n] for n in parts})} s, peaks "
        f"{json.dumps({n: peaks[n] for n in parts})} GiB")

    on_path = ("encode", "reader", "train", "xxlarge encode", "xxlarge train")
    launched = lambda form: sum(counts[n].get(form, 0) for n in on_path)  # noqa: E731
    of = {"F2": ("add_layer_norm (F2)", "layer_norm.cu", "proqa_tpu/models/bert.py:137",
                 launched("F2 row")),
          "F2 backward": ("add_layer_norm backward (F2)", "layer_norm.cu",
                          "proqa_tpu/models/bert.py:137", launched("F2 backward row")),
          "F1": ("dense_epilogue (F1)", "dense_epilogue.cu", "proqa_tpu/models/bert.py:147",
                 launched("F1 wide")),
          "F1 backward": ("dense_epilogue backward (F1)", "dense_epilogue.cu",
                          "proqa_tpu/models/bert.py:147", launched("F1 backward slabs"))}
    entries = []
    for kernel, label, result in times:
        name, source, replaces, launches = of[kernel]
        entries.append((f"{name} {label}", source, replaces, launches, result))
    return entries, {"counts": counts, "walls": walls, "peaks": peaks, "errs": errs,
                     "encode_cos": cos, "reader": reader, "losses": losses, "grad": grad,
                     "xxlarge_cos": wide_cos}


# phase 34: the exact search at every embedding width; DPR's index on the card
EMBED_WIDTHS = (64, 96, 256, 384, 768, 1024)  # (a): each kernel against its plain version
WIDTH_ROWS = 262_144
# (b): DPR's Wikipedia index, psgs_w100 (Karpukhin et al. 2020): 21,015,324
# passages of width 768; f32 cut to 4,194,304 rows (12.9 GB)
DPR_ROWS, DPR_DIM, DPR_F32_ROWS = 21_015_324, 768, 4_194_304
WIDE_PARAS = 4608  # (c): past the naive search's 4,096 rows, so the kernels run


def _rescore_against_plain(name, fn, queries, corpus, ids, block, timed: bool) -> dict:
    """K6 or K9 on the candidate blocks ids against the plain gather and
    product (64 queries at a time: its [Q, kb, block, D] gather); timed
    beside the take path (gather + dot_f32, 256 queries at a time) and the
    bound (each distinct candidate block read once) when `timed`."""
    import torch

    from proqa_tpu_torch.ops import rescore
    from proqa_tpu_torch.ops.dot import dot_f32

    d = corpus.shape[1]
    blocks = corpus.view(-1, block, d)
    nq, kb = ids.shape
    got = fn(queries, blocks, ids, block=block)
    err = 0.0
    for s in range(0, nq, 64):
        want = rescore.gather_rescore_reference(queries[s:s + 64], blocks, ids[s:s + 64],
                                                block=block)
        err = max(err, (got[s:s + 64] - want).abs().max().item())
    check(err <= BMAX_TOL, f"{name}: max abs err {err} > {BMAX_TOL}")
    if not timed:
        return {"max_abs_err": err}

    def plain():
        for s in range(0, nq, 64):
            rescore.gather_rescore_reference(queries[s:s + 64], blocks, ids[s:s + 64],
                                             block=block)

    def take_path():
        for s in range(0, nq, 256):
            cand = blocks[ids[s:s + 256]].view(-1, kb * block, d)
            dot_f32(cand, queries[s:s + 256, :, None])

    ms = cuda_ms(lambda: fn(queries, blocks, ids, block=block), reps=10)
    plain_ms, library_ms = cuda_ms(plain, reps=2), cuda_ms(take_path, reps=3)
    elt = corpus.element_size()
    nbytes = (torch.unique(ids).numel() * block * d * elt + queries.numel() * elt
              + ids.numel() * 8 + nq * kb * block * 4)
    bound_ms, bound_by = bound(nbytes, 2.0 * nq * kb * block * d)
    log(f"{name} Q={nq} kb={kb} block={block} D={d} {corpus.dtype}: max_abs_err {err:.3g} "
        f"(tol {BMAX_TOL}), kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, take path (gather + "
        f"dot_f32, 256 queries at a time) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _width_checks(device) -> tuple[dict, dict]:
    """Phase 34 (a): at each width of EMBED_WIDTHS over WIDTH_ROWS rows, K1
    (bf16 and f32), K5 and K7 at Q = 2,048 and 32, K8, K6 and K9 at blocks
    16 and 64, the simple body (f32 queries over int8 codes, f32 K8) against
    their plain versions (BMAX_TOL), and mips_topk over bf16 and f32 against
    the exact top-80 up to ties (TOPK_TOL). Returns the D = 768 results
    (timed, for the kernels line) and each kernel's largest error over the
    widths; also the K7 and K8 pipelines' and K9's launches at D = 768,
    counted from 0."""
    import torch

    from proqa_tpu_torch.ops import mips, mips_kernel, rescore
    from proqa_tpu_torch.testing import topk_disagreements

    at768, errs, launches = {}, {}, {}
    k = 80
    for d in EMBED_WIDTHS:
        t0 = time.perf_counter()
        timed = d == DPR_DIM
        g = torch.Generator(device=device).manual_seed(d)
        corpus = torch.randn(WIDTH_ROWS, d, device=device, generator=g) / d ** 0.5
        queries = torch.randn(2048, d, device=device, generator=g) / d ** 0.5
        cb, qb = corpus.bfloat16(), queries.bfloat16()
        codes = torch.randint(-127, 128, (WIDTH_ROWS, d), device=device, generator=g,
                              dtype=torch.int8)
        scales = torch.rand(WIDTH_ROWS // 16, device=device, generator=g) * 0.02 + 1e-3
        rows = torch.rand(WIDTH_ROWS, device=device, generator=g) * 0.02 + 1e-3
        bounds = (rows.view(-1, 16).amax(dim=1), rows.view(-1, 16).amin(dim=1))
        for q in (2048, 32):
            reps = 3 if timed and q == 2048 else 1
            for name, qs, c, kw, peak in (
                    ("K1", qb, cb, {}, PEAK_BF16_FLOPS),
                    ("K1 f32", queries, corpus, {}, PEAK_F32_FLOPS),
                    ("K5", qb, codes, {"scales": scales}, PEAK_BF16_FLOPS),
                    ("K7", qb, codes, {"scale_bounds": bounds}, PEAK_BF16_FLOPS)):
                r = grouped_against_plain(f"{name} D={d} Q={q}", qs[:q].contiguous(), c,
                                          block=16, reps=reps, peak=peak, **kw)
                del r["out"]
                errs[name] = max(errs.get(name, 0.0), r["max_abs_err"])
                if timed and q == 2048:
                    at768[name] = r
        # K8, block-major (its v1 pipeline's block and tile)
        run = lambda: mips_kernel.block_maxima(qb, cb, block=256, tile_n=2048)  # noqa: E731
        got = run()
        want = mips_kernel.block_maxima_reference(qb, cb, block=256, tile_n=2048)
        err = (got - want).abs().max().item()
        check(err <= BMAX_TOL, f"K8 D={d}: max abs err {err} > {BMAX_TOL}")
        errs["K8"] = max(errs.get("K8", 0.0), err)
        if timed:
            ms = cuda_ms(run, reps=3)
            plain_ms = cuda_ms(lambda: mips_kernel.block_maxima_reference(
                qb, cb, block=256, tile_n=2048), reps=2)
            bound_ms, bound_by = bound(cb.numel() * 2 + qb.numel() * 2 + got.numel() * 4,
                                       2.0 * 2048 * WIDTH_ROWS * d)
            at768["K8"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
            log(f"K8 D={d} Q=2048 block=256: max_abs_err {err:.3g}, kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
        del got, want
        # the simple body: f32 queries over int8 codes, and f32 K8 (Q = 32)
        q32 = queries[:32].contiguous()
        check(mips_kernel.kernel_for(torch.float32, torch.int8, block=16, group=128,
                                     grouped=True, scaled=True) == "simple", "simple route")
        got = mips_kernel.block_maxima_grouped(q32, codes, block=16, scales=scales)
        want = mips_kernel.block_maxima_grouped_reference(q32, codes, block=16, scales=scales)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        got = mips_kernel.block_maxima(q32, corpus, block=32, tile_n=1024)
        want = mips_kernel.block_maxima_reference(q32, corpus, block=32, tile_n=1024)
        err = max(err, (got - want).abs().max().item())
        check(err <= BMAX_TOL, f"simple body D={d}: max abs err {err} > {BMAX_TOL}")
        errs["simple"] = max(errs.get("simple", 0.0), err)
        del got, want
        # K6 and K9 at blocks 16 and 64 on the candidates the K1 pipeline selects
        for block in (16, 64):
            for label, qs, c in (("bf16", qb, cb), ("f32", queries, corpus)):
                ids = mips_kernel.select_blocks(qs, c, k, block=block)
                for name, fn in (("K6", rescore.gather_rescore), ("K9", rescore.gather_score)):
                    r = _rescore_against_plain(f"{name} D={d} {label}", fn, qs, c, ids, block,
                                               timed and block == 64 and label == "bf16")
                    errs[name] = max(errs.get(name, 0.0), r["max_abs_err"])
                    if "ms" in r:
                        at768[name] = r
                del ids
        # the search, both dtypes, against the exact top-80
        for label, qs, c in (("bf16", qb, cb), ("f32", queries, corpus)):
            gv, gi = mips.mips_topk(qs, c, k)
            rv, ri = mips.mips_topk_reference(qs, c, k)
            bad = topk_disagreements(gv.cpu().numpy(), gi.cpu().numpy(), rv.cpu().numpy(),
                                     ri.cpu().numpy(), atol=TOPK_TOL)
            check(bad == 0, f"mips_topk D={d} {label}: {bad} of 2048 queries disagree with "
                            f"the exact top-{k}")
        if timed:
            # the pipelines of K7 (row scales, kb = 16k) and K8 (v1), and K9,
            # each driven once with the counters at 0
            mips_kernel.bounded_launches = mips_kernel.block_major_launches = 0
            rescore.score_launches = 0
            mips_kernel.mips_topk_v2(qb, codes, 20, block=16, row_scales=rows, kb=320)
            mips_kernel.mips_topk_v1(qb, cb, k, block=256, tile_n=2048)
            ids = mips_kernel.select_blocks(qb, cb, k, block=64)
            rescore.gather_score(qb, cb.view(-1, 64, d), ids, block=64)
            torch.cuda.synchronize()
            launches = {"K7": mips_kernel.bounded_launches,
                        "K8": mips_kernel.block_major_launches, "K9": rescore.score_launches}
            check(all(v > 0 for v in launches.values()), f"D={d} pipelines: {launches}")
        del corpus, queries, cb, qb, codes, scales, rows, bounds
        torch.cuda.empty_cache()
        log(f"D={d}: every search kernel within BMAX_TOL of its plain version, mips_topk "
            f"(bf16, f32) equal to the exact top-{k} up to ties ({time.perf_counter() - t0:.1f} s)")
    return at768, errs, launches


def _dpr_search(device, label: str, index, queries, k: int, counters: dict,
                row_scales=None) -> dict:
    """index.search of 2,048 queries with the counters at 0 just before and
    read just after; qps over 3 more searches (host clock; each ends in a
    copy to the host); 256 queries against the exact top-k."""
    import numpy as np
    import torch

    from proqa_tpu_torch.testing import topk_disagreements

    for module, name in counters.values():
        setattr(module, name, 0)
    vals, idx = index.search(queries, k)
    launched = {key: getattr(module, name) for key, (module, name) in counters.items()}
    check(all(v > 0 for v in launched.values()), f"DPR {label} search: {launched}")
    check(vals.shape == (queries.shape[0], k) and np.isfinite(vals).all(),
          f"DPR {label} search: bad values")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        index.search(queries, k)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    q256 = queries[:256].to(device, index._query_dtype)
    n = index.n
    rv, ri = _exact_top(q256, index.embeddings[:n], None if row_scales is None
                        else row_scales[:n], k, 1 << 21)
    bad = topk_disagreements(vals[:256], idx[:256], rv.cpu().numpy(), ri.cpu().numpy(),
                             atol=TOPK_TOL)
    check(bad == 0, f"DPR {label} search: {bad} of 256 queries disagree with the exact top-{k}")
    log(f"DPR {label} search top-{k} over {index.n:,} x {index.dim}: {queries.shape[0] / wall:.1f} "
        f"qps ({wall * 1e3:.1f} ms a batch of {queries.shape[0]}, host clock); launches "
        f"{json.dumps(launched)}; 256 queries equal the exact top-{k} up to ties")
    return {**launched, "qps": queries.shape[0] / wall}


def _dpr_index(device) -> dict:
    """Phase 34 (b): DPR's 21,015,324 x 768 index in bf16, built on the card
    from a seed as a DenseIndex (rows padded to 1,024 with zeros, as a built
    index is; searched where they lie), searched through K1 and K6; then the
    same rows' size in int8 codes through K5; then 4,194,304 x 768 in f32
    through K1's f32 body. Each corpus is freed before the next."""
    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.ops import mips, mips_kernel, rescore

    n, d, q, k = DPR_ROWS, DPR_DIM, 2048, 80
    cap = n + (-n) % 1024
    g = torch.Generator(device=device).manual_seed(34)
    queries = (torch.randn(q, d, device=device, generator=g) / d ** 0.5).bfloat16()
    out = {}
    t0 = time.perf_counter()
    rows = torch.zeros(cap, d, device=device, dtype=torch.bfloat16)
    for r0 in range(0, n, 1 << 20):
        r1 = min(r0 + (1 << 20), n)
        rows[r0:r1] = torch.randn(r1 - r0, d, device=device, generator=g) / d ** 0.5
    index = DenseIndex(embeddings=rows, n=n)
    torch.cuda.synchronize()
    log(f"DPR bf16 index {n:,} x {d} ({rows.numel() * 2 / 1e9:.2f} GB) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    out["bf16"] = _dpr_search(device, "bf16", index, queries, k,
                              {"K1": (mips_kernel, "launches"), "K6": (rescore, "launches")})
    block = mips.envelope_block(cap, q)
    k1_ms = cuda_ms(lambda: mips_kernel.block_maxima_grouped(queries, rows, block=block), reps=3)
    k1_bound, k1_by = bound(rows.numel() * 2 + queries.numel() * 2
                            + (-(-cap // (128 * block)) * 128 * q * 4), 2.0 * q * cap * d)
    out["bf16"].update(k1_ms=k1_ms, k1_bound_ms=k1_bound, block=block)
    log(f"DPR K1 Q={q} N={cap:,} D={d} block {block}: {k1_ms:.2f} ms against its bound "
        f"{k1_bound:.2f} ms ({k1_by}; the bytes alone {rows.numel() * 2 / PEAK_BYTES_PER_S * 1e3:.2f} ms)")
    del index, rows
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    qb = mips.envelope_block(cap, q)
    codes = torch.zeros(cap, d, device=device, dtype=torch.int8)
    for r0 in range(0, n, 1 << 21):
        r1 = min(r0 + (1 << 21), n)
        codes[r0:r1] = torch.randint(-127, 128, (r1 - r0, d), device=device, generator=g,
                                     dtype=torch.int8)
    scales = torch.rand(cap // qb, device=device, generator=g) * 0.02 + 1e-3
    index = DenseIndex._from_quantized(codes, scales, n, qb, None)
    torch.cuda.synchronize()
    log(f"DPR int8 index {n:,} x {d} ({codes.numel() / 1e9:.2f} GB, quant block {qb}) made on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    row_scales = scales.repeat_interleave(qb)
    out["int8"] = _dpr_search(device, "int8", index, queries, k,
                              {"K5": (mips_kernel, "scaled_launches")}, row_scales=row_scales)
    k5_ms = cuda_ms(lambda: mips_kernel.block_maxima_grouped(queries, codes, block=qb,
                                                             scales=scales), reps=3)
    k5_bound, k5_by = bound(codes.numel() + queries.numel() * 2 + scales.numel() * 4
                            + (-(-cap // (128 * qb)) * 128 * q * 4), 2.0 * q * cap * d)
    out["int8"].update(k5_ms=k5_ms, k5_bound_ms=k5_bound)
    log(f"DPR K5 Q={q} N={cap:,} D={d} block {qb}: {k5_ms:.2f} ms against its bound "
        f"{k5_bound:.2f} ms ({k5_by})")
    del index, codes, scales, row_scales
    torch.cuda.empty_cache()

    n32 = DPR_F32_ROWS
    t0 = time.perf_counter()
    rows = torch.randn(n32, d, device=device, generator=g) / d ** 0.5
    index = DenseIndex(embeddings=rows, n=n32)
    qf = queries.float()
    torch.cuda.synchronize()
    log(f"f32 index {n32:,} x {d} ({rows.numel() * 4 / 1e9:.2f} GB) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    out["f32"] = _dpr_search(device, "f32", index, qf, k,
                             {"K1 f32": (mips_kernel, "f32_launches"),
                              "K6": (rescore, "launches")})
    block = mips.envelope_block(n32, q)
    f_ms = cuda_ms(lambda: mips_kernel.block_maxima_grouped(qf, rows, block=block), reps=2)
    f_bound, f_by = bound(rows.numel() * 4 + qf.numel() * 4 + n32 // block * q * 4,
                          2.0 * q * n32 * d, PEAK_F32_FLOPS)
    out["f32"].update(k1_ms=f_ms, k1_bound_ms=f_bound)
    log(f"f32 K1 Q={q} N={n32:,} D={d} block {block}: {f_ms:.2f} ms against its bound "
        f"{f_bound:.2f} ms ({f_by}, the f32 FMA rate)")
    del index, rows
    torch.cuda.empty_cache()
    return out


def _wide_cli(device, root: str) -> dict:
    """Phase 34 (c): a BERT-base retriever with 768-wide projections (random
    weights from a seed, saved as phase_cli saves its retriever) through
    build-db, build-index, encode-queries and eval-retrieval on a world of
    WIDE_PARAS paragraphs, with the counters reset before and read after;
    the eval's top-80 held to the exact search of the same index; then one
    eval-qa group (8 questions) over the 768-wide index with that retriever
    (--retriever-path) and a reader of random weights."""
    import numpy as np
    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.convert import params_to_jax, save_npz
    from proqa_tpu_torch.models.retriever import Retriever
    from proqa_tpu_torch.ops import attention, mips, mips_kernel, rescore
    from proqa_tpu_torch.testing import topk_disagreements

    n_q, k, d = 64, 80, DPR_DIM
    write_world(root, WIDE_PARAS, n_q, seed=34)
    p = lambda name: os.path.join(root, name)  # noqa: E731
    ckpt = p("retriever768.npz")
    save_npz(ckpt, params_to_jax(Retriever(BertConfig(), d).reset_parameters(34).state_dict()))
    common = ["--vocab", p("vocab.txt"), "--init-checkpoint", ckpt, "--device", str(device)]
    attention.launches = mips_kernel.launches = rescore.launches = 0
    run_cli(["build-db", "--corpus", p("corpus.jsonl"), "--db", p("docs.db")])
    built, _ = run_cli(["build-index", *common, "--max-seq-length", "512",
                        "--predict-batch-size", "512", "--corpus", p("corpus.jsonl"),
                        "--output-dir", p("index")])
    run_cli(["encode-queries", *common, "--queries", p("qa.jsonl"), "--output", p("q.npy")])
    recall, _ = run_cli(["eval-retrieval", p("qa.jsonl"), p("index"), p("q.npy"), p("docs.db"),
                         "--topk", str(k), "--device", str(device)])
    launches = {"K1": mips_kernel.launches, "K2": attention.launches, "K6": rescore.launches}
    log(f"kernel launches on the 768-wide retrieval CLI: {json.dumps(launches)}")
    check(all(v > 0 for v in launches.values()), f"768-wide CLI: {launches}")
    check(built == {"rows": WIDE_PARAS, "dim": d, "saved": p("index")}, f"build-index: {built}")
    check(set(recall) == {f"recall@{r}" for r in (5, 10, 20, 50, 80)}, f"recall keys {recall}")
    q = np.load(p("q.npy"))
    check(q.shape == (n_q, d) and np.isfinite(q).all(), "encode-queries: bad embeddings")
    index = DenseIndex.load(p("index"), device=device)
    vals, idx = index.search(q, k)
    qt = torch.from_numpy(q).to(device, torch.bfloat16)
    rv, ri = mips.mips_topk_reference(qt, index.embeddings, k, n_valid=index.n)
    bad = topk_disagreements(vals, idx, rv.cpu().numpy(), ri.cpu().numpy(), atol=TOPK_TOL)
    check(bad == 0, f"768-wide eval top-{k}: {bad} of {n_q} queries disagree with the exact "
                    "search")
    with open(p("qa8.jsonl"), "w") as f:
        for i in range(8):
            f.write(json.dumps({"question": f"what is about tok{i} tok{i + 9}",
                                "answer": [f"tok{i + 9}"]}) + "\n")
    mips_kernel.launches = rescore.launches = 0
    em, _ = run_cli(["eval-qa", "--vocab", p("vocab.txt"), "--db", p("docs.db"), "--index",
                     p("index"), "--retriever-path", ckpt, "--device", str(device),
                     "--max-seq-length", "512", "--eval-k", "5", "--questions-per-batch", "8",
                     "--predict-file", p("qa8.jsonl"), "--output-dir", p("qa_run")])
    qa_launches = {"K1": mips_kernel.launches, "K6": rescore.launches}
    check(all(v > 0 for v in qa_launches.values()), f"768-wide eval-qa: {qa_launches}")
    log(f"768-wide recall: {json.dumps(recall)}; eval top-{k}: all {n_q} queries equal the "
        f"exact search up to ties; eval-qa (one group of 8): {json.dumps(em)}, launches "
        f"{json.dumps(qa_launches)}")
    return {"K1": launches["K1"] + qa_launches["K1"], "K6": launches["K6"] + qa_launches["K6"]}


def phase_embed_widths(device) -> tuple[list, dict]:
    """Phase 34: (a) _width_checks, (b) _dpr_index, (c) _wide_cli. Returns the
    kernels line's entries of the K-loop forms (times at D = 768 over
    262,144 rows; launches from (b) and (c) and, for K7, K8 and K9, their
    own pipelines at D = 768) and the seconds of each part."""
    import torch

    seconds = {}
    t0 = time.perf_counter()
    at768, errs, own = _width_checks(device)
    seconds["a"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    dpr = _dpr_index(device)
    seconds["b"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="proqa_smoke_") as root:
        cli = _wide_cli(device, root)
    seconds["c"] = round(time.perf_counter() - t0, 1)
    torch.cuda.empty_cache()
    log(f"phase 34 seconds: {json.dumps(seconds)}")
    wgmma, f32, gather = "block_maxima_wgmma.cu", "block_maxima_f32.cu", "gather_rescore.cu"
    forms = [
        ("block_maxima_grouped (K1) D=768", wgmma, "proqa_tpu/ops/pallas_mips.py:83",
         dpr["bf16"]["K1"] + cli["K1"], "K1"),
        ("block_maxima_grouped f32 (K1) D=768", f32, "proqa_tpu/ops/pallas_mips.py:83",
         dpr["f32"]["K1 f32"], "K1 f32"),
        ("block_maxima_grouped scaled (K5) D=768", wgmma, "proqa_tpu/ops/pallas_mips.py:97",
         dpr["int8"]["K5"], "K5"),
        ("block_maxima_grouped bounded (K7) D=768", wgmma, "proqa_tpu/ops/pallas_mips.py:111",
         own["K7"], "K7"),
        ("block_maxima (K8) D=768", wgmma, "proqa_tpu/ops/pallas_mips.py:32", own["K8"], "K8"),
        ("gather_rescore (K6) D=768", gather, "proqa_tpu/ops/pallas_rescore.py:58",
         dpr["bf16"]["K6"] + dpr["f32"]["K6"] + cli["K6"], "K6"),
        ("gather_score (K9) D=768", gather, "proqa_tpu/ops/pallas_gather_score.py:35", own["K9"],
         "K9"),
    ]
    return [(name, source, replaces, launches, {**at768[key], "max_abs_err": errs[key]})
            for name, source, replaces, launches, key in forms], seconds


# --- heads wider than 128: K2 and K3 past Dh = 128 ----------------------------

# No public BERT has heads wider than 128; Gemma's decoders and the
# EmbeddingGemma retrieval encoder attend with heads of 256. BERT-base's
# widths (12 layers, hidden 768, FFN 3,072, BERT's vocabulary and positions)
# with 3 heads of 256; random weights drawn on the card
WIDE_HEADS = dict(vocab_size=30522, hidden_size=768, num_layers=12, num_heads=3,
                  intermediate_size=3072, max_position_embeddings=512, type_vocab_size=2)
# (a): head dim -> heads of the checks; 192 runs padded to 256, 384 and 768
# the loop forms
WIDE_HEAD_DIMS = {192: 4, 256: 3, 384: 2, 768: 1}


def phase_wide_heads(device) -> tuple[list, dict]:
    """Heads wider than 128 on the card: (a) K2 and K3 at head dims 192
    (padded to 256), 256, 384 and 768 (the loop forms) against their plain
    versions (bf16 and f32, T in 128, 512, 1,024, rates 0 and 0.1, one
    all-padding row; row by row, beside controls that leave out a key tile
    or a head-dim chunk; K3's two launches bit-equal), and the new forms timed
    beside their plain versions, SDPA and their bounds; (b) a tower at
    BERT-base's widths with 3 heads of 256 (WIDE_HEADS, random weights drawn
    on the card): the context tower over 512 x 512 against the vanilla path
    (ENCODER_COS), the QA reader over 8 x 5 x 512 against it (READER_REL,
    beside the e4m3 control), three retriever train steps at 80 x (32 +
    512), remat, dropout 0.1, the loss falling, and a dropout-0 step's
    gradients (_grad_check); (c) 2-layer towers at hidden 768 with 2 heads of
    384 and 1 of 768: an encode against the vanilla path, a train step, and
    the dropout-0 step's gradients (_grad_check). K2/K3 launches are counted in (b) and (c), each tower at one head dim.
    Returns the kernels line's entries of the new forms and the phase's
    numbers."""
    import dataclasses

    import torch

    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.reader import QAConfig, QAModel
    from proqa_tpu_torch.models.retriever import Retriever
    from proqa_tpu_torch.train.optim import AdamW, init_train_state
    from proqa_tpu_torch.train.retriever_trainer import train_step

    gpu = gpu_line()
    cfg = BertConfig(**WIDE_HEADS, flash_attention=True)
    check(cfg.head_dim == 256, f"wide-heads head dim {cfg.head_dim}")
    vanilla_cfg = dataclasses.replace(cfg, flash_attention=False)

    # (a) the kernels
    t0 = time.perf_counter()
    errs = {dh: _attention_checks(device, dh, heads) for dh, heads in WIDE_HEAD_DIMS.items()}
    forms = {"256 encode": _attention_form(device, 512, 3, 512, 256, 0.0),
             "256 train": _attention_form(device, 80, 3, 512, 256, 0.1),
             384: _attention_form(device, 64, 2, 512, 384, 0.1),
             768: _attention_form(device, 64, 1, 512, 768, 0.1)}
    log(f"{gpu}: wide heads (a) K2/K3 at Dh {list(WIDE_HEAD_DIMS)} (192 padded to 256; 384 "
        f"and 768 the loop forms), bf16 and f32, T in {MINILM_T}, rates 0 and 0.1: max abs "
        f"err, row errors and controls {json.dumps(errs)} (tol {ATTN_TOL}, {BWD_TOL}; rows "
        f"{json.dumps(ATTN_ROW_REL)}, {json.dumps(BWD_ROW_REL)}); K3 two launches bit-equal; "
        f"{time.perf_counter() - t0:.1f} s")

    # (b) the 12-layer tower: encode, reader, train steps, dropout-0 gradients
    t0 = time.perf_counter()
    counts = {}
    model = _on_device(lambda: Retriever(cfg), cfg, device, 51).eval()
    vanilla = _sharing(lambda: Retriever(vanilla_cfg), model).eval()
    batch = _minilm_batch(device, 512, 32, 512, 52, cfg.vocab_size)
    ids, mask = batch["input_ids_c"], batch["input_mask_c"]
    with torch.inference_mode():
        rows = _counted(lambda: model.encode_context(ids, mask), counts.setdefault("encode", {}))
        plain_rows = vanilla.encode_context(ids, mask)
        encode_ms = cuda_ms(lambda: model.encode_context(ids, mask), reps=3)
    cos = torch.nn.functional.cosine_similarity(rows, plain_rows, dim=1).min().item()
    check(bool(torch.isfinite(rows).all()) and rows.shape == (512, 128),
          "wide-heads encode: bad embeddings")
    check(cos >= ENCODER_COS, f"wide-heads encode with K2 vs vanilla: min cosine {cos} < "
                              f"{ENCODER_COS}")
    check(counts["encode"]["K2"] == cfg.num_layers, f"wide-heads encode: {counts['encode']}")
    del model, vanilla, rows, plain_rows, batch

    reader = _on_device(lambda: QAModel(cfg, QAConfig()), cfg, device, 53).eval()
    plain = _sharing(lambda: QAModel(vanilla_cfg, QAConfig()), reader).eval()
    rel_err, rel_ctrl = 0.0, float("inf")
    for bi, dev in enumerate(_reader_batches(device, cfg, 54)):
        got = _counted(lambda: _span_logits(reader, dev), counts.setdefault("reader", {}))
        van = _span_logits(plain, dev)
        scale = van.abs().max().item()
        err = (got - van).abs().max().item()
        ctrl = (van.to(torch.float8_e4m3fn).float() - van).abs().max().item()
        rel_err, rel_ctrl = max(rel_err, err / scale), min(rel_ctrl, ctrl / scale)
        check(bool(torch.isfinite(got).all()) and err <= READER_REL * scale,
              f"wide-heads reader with K2 vs vanilla, batch {bi}: span logits differ by {err} > "
              f"{READER_REL} x {scale}")
    check(rel_ctrl > READER_REL, f"wide-heads reader: the e4m3 control ({rel_ctrl}) passes "
                                 f"{READER_REL}: the check would not see one coarser rounding")
    check(counts["reader"]["K2"] == READER_BATCHES * cfg.num_layers,
          f"wide-heads reader: launches {counts['reader']}")
    del reader, plain
    torch.cuda.empty_cache()

    b, tq, tc, steps = 80, 32, 512, 3
    tcfg = dataclasses.replace(cfg, remat=True)  # dropout 0.1
    batch = _minilm_batch(device, b, tq, tc, 55, cfg.vocab_size)
    model = _on_device(lambda: Retriever(tcfg), tcfg, device, 56)
    state = init_train_state(dict(model.named_parameters()))
    tx, gen = AdamW(1e-4), torch.Generator().manual_seed(57)
    losses, walls = [], []
    _reset_kernel_counts()
    for _ in range(steps):
        t1 = time.perf_counter()
        state, m = train_step(model, state, tx, batch, gen)
        losses.append(float(m["loss"]))  # synchronises
        walls.append(time.perf_counter() - t1)
    counts["train"] = _attention_counts()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"wide-heads train step: loss {losses} did not fall")
    check(all(n > 0 for n in counts["train"].values()), f"wide-heads train step: a kernel never "
                                                        f"ran {counts['train']}")
    cfg0 = dataclasses.replace(tcfg, hidden_dropout=0.0, attention_dropout=0.0)
    trained = {name: p.detach().clone() for name, p in model.state_dict().items()}
    del model, state
    torch.cuda.empty_cache()
    grad_cos = _grad_check("wide heads", trained, cfg0, batch, device)
    del trained, batch
    torch.cuda.empty_cache()
    log(f"{gpu}: wide heads (b) BERT-base widths, 3 heads of 256: encode 512 x 512 bf16 min "
        f"cosine {cos:.6f} to vanilla (tol {ENCODER_COS}), {encode_ms:.2f} ms per batch = "
        f"{512 * 512 / encode_ms * 1e3:.0f} padded tokens/s (CUDA events); reader 8 x 5 x 512 "
        f"span logits max abs err {rel_err:.4g} of the batch's largest (tol {READER_REL}; e4m3 "
        f"control {rel_ctrl:.4g}); train step {b} x ({tq} + {tc}) remat dropout 0.1: losses "
        f"{' -> '.join(f'{x:.4f}' for x in losses)}, {statistics.median(walls) * 1e3:.1f} ms "
        f"per step (median of {steps}, host clock, synchronised, the first included); "
        f"launches {json.dumps(counts)}; wall {time.perf_counter() - t0:.1f} s")

    # (c) 2-layer towers of 2 heads of 384 and 1 of 768: encode and a train step
    t0 = time.perf_counter()
    tower_cos, tower_grad = {}, {}
    for heads in (2, 1):
        wide = dataclasses.replace(cfg, num_heads=heads, num_layers=2, remat=True)
        dh = wide.head_dim
        model = _on_device(lambda: Retriever(wide), wide, device, 58 + heads)
        vanilla = _sharing(lambda: Retriever(dataclasses.replace(wide, flash_attention=False)),
                           model).eval()
        batch = _minilm_batch(device, 64, 32, 512, 60 + heads, wide.vocab_size)
        with torch.inference_mode():
            rows = _counted(lambda: model.eval().encode_context(batch["input_ids_c"],
                                                                batch["input_mask_c"]),
                            counts.setdefault(f"dh{dh} encode", {}))
            tower_cos[dh] = torch.nn.functional.cosine_similarity(
                rows, vanilla.encode_context(batch["input_ids_c"], batch["input_mask_c"]),
                dim=1).min().item()
        del vanilla, rows
        check(tower_cos[dh] >= ENCODER_COS, f"Dh {dh} encode with K2 vs vanilla: min cosine "
                                            f"{tower_cos[dh]}")
        state = init_train_state(dict(model.named_parameters()))
        _, m = _counted(lambda: train_step(model.train(), state, AdamW(1e-4), batch,
                                           torch.Generator().manual_seed(62)),
                        counts.setdefault(f"dh{dh} train", {}))
        check(math.isfinite(float(m["loss"])), f"Dh {dh} train step: loss {m['loss']}")
        check(counts[f"dh{dh} encode"]["K2"] == wide.num_layers
              and counts[f"dh{dh} train"]["K3"] > 0,
              f"Dh {dh} tower: launches {counts[f'dh{dh} encode']}, {counts[f'dh{dh} train']}")
        trained = {name: p.detach().clone() for name, p in model.state_dict().items()}
        del model, state
        torch.cuda.empty_cache()
        tower_grad[dh] = _grad_check(f"Dh {dh} tower", trained, dataclasses.replace(
            wide, hidden_dropout=0.0, attention_dropout=0.0), batch, device)
        del trained, batch
        torch.cuda.empty_cache()
    log(f"{gpu}: wide heads (c) 2-layer towers at hidden 768, 64 x 512 bf16: encode with K2 min "
        f"cosine to vanilla {json.dumps(tower_cos)} (tol {ENCODER_COS}); one train step each, "
        f"then its dropout-0 gradients' lowest cosine to vanilla and to the plain chain "
        f"{json.dumps(tower_grad)} (_grad_check); "
        f"launches {json.dumps({n: counts[n] for n in counts if n.startswith('dh')})}; wall "
        f"{time.perf_counter() - t0:.1f} s")

    def err_of(dh, key, *results):
        return max([errs[dh][key]] + [r["max_abs_err"] for r in results])

    fwd256, bwd256 = forms["256 encode"][0], forms["256 train"][1]
    k2_256 = counts["encode"]["K2"] + counts["reader"]["K2"] + counts["train"]["K2"]
    entries = [
        ("fused_attention (K2) Dh=256 [512, 3, 512, 256]", "attention_fwd.cu",
         "proqa_tpu/ops/pallas_attention.py:65", k2_256,
         {**fwd256, "max_abs_err": err_of(256, "fwd_err", fwd256, forms["256 train"][0])}),
        ("fused_attention backward (K3) Dh=256 loop [80, 3, 512, 256]", "attention_bwd.cu",
         "proqa_tpu/ops/pallas_attention.py:83", counts["train"]["K3"],
         {**bwd256, "max_abs_err": err_of(256, "bwd_err", bwd256, forms["256 encode"][1])}),
    ]
    for dh in (384, 768):
        fwd, bwd = forms[dh]
        shape = f"[64, {WIDE_HEAD_DIMS[dh]}, 512, {dh}]"
        entries += [
            (f"fused_attention (K2) Dh={dh} loop {shape}", "attention_fwd.cu",
             "proqa_tpu/ops/pallas_attention.py:65",
             counts[f"dh{dh} encode"]["K2"] + counts[f"dh{dh} train"]["K2"],
             {**fwd, "max_abs_err": err_of(dh, "fwd_err", fwd)}),
            (f"fused_attention backward (K3) Dh={dh} loop {shape}", "attention_bwd.cu",
             "proqa_tpu/ops/pallas_attention.py:83", counts[f"dh{dh} train"]["K3"],
             {**bwd, "max_abs_err": err_of(dh, "bwd_err", bwd)})]
    return entries, {"counts": counts, "grad_cos": grad_cos, "losses": losses,
                     "encode_cos": cos, "reader_rel": rel_err, "tower_cos": tower_cos,
                     "tower_grad_cos": tower_grad}


# phase 36: E5-Mistral-7B's decoder (intfloat/e5-mistral-7b-instruct's
# config.json; random weights drawn on the card): its kernels at the E5
# cell's shapes, 512 rows of 28-58 ids (profile_slice.e5_cell_lengths, the
# cell's traffic file) padded to 58, and its retrieve path, encode_query
# then DenseIndex.search over those rows, at the published widths
E5_K = 100
E5_CORPUS = 262_144  # 4,096-d bf16 index rows searched (2 GiB), past the naive search



def _decoder_kernels(device, cfg) -> list:
    """F1's SwiGLU form, F2's RMSNorm form and the RoPE copy against their
    plain versions at the shapes of the E5 cell's batch: F1 and F2 over its
    real tokens (the packed rows the tower hands them), the RoPE copy from
    those rows into the layouts padded to the longest row. SwiGLU and RoPE
    bit-equal, F2's sum bit-equal and its output within one bf16 ulp at
    magnitudes of at least LN_ULP_FLOOR (with and without a residual). Each
    timed by one call between CUDA events, queued and by its kernels alone
    beside its plain version, its bound and, for F2, torch's rms_norm (no
    residual: a yardstick). Returns (kernel, label, result) a kernel."""
    import torch

    from proqa_tpu_torch.ops import fused_bert, rope
    from proqa_tpu_torch.profile_slice import e5_cell_lengths

    g = torch.Generator(device=device).manual_seed(70)
    lengths = torch.tensor(e5_cell_lengths())
    b, t, n = lengths.numel(), int(lengths.max()), int(lengths.sum())
    h, inter = cfg.hidden_size, cfg.intermediate_size
    runs = []

    def timed_run(run, plain, bound_ms, by, **extra):
        return {**extra, "ms": cuda_ms(run), "queued_ms": cuda_ms(run, calls=10),
                **kernel_ms(run), "plain_ms": cuda_ms(plain), "bound_ms": bound_ms,
                "bound_by": by}

    # F1's SwiGLU form: [n, 2 I] -> [n, I]; 6 B an output (two reads, one
    # write) and silu's exp, add and divide and the product, f32
    y = (torch.randn(n, 2 * inter, device=device, generator=g) * 2.0).bfloat16()
    got, want = fused_bert.swiglu(y), fused_bert.swiglu_reference(y)
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(got, want), f"F1 SwiGLU [{n}, {2 * inter}]: max abs err {err}, not "
                                  f"bit-equal")
    del got, want
    runs.append(("F1 swiglu", f"[{n}, {2 * inter}] -> [{n}, {inter}] bf16", timed_run(
        lambda: fused_bert.swiglu(y), lambda: fused_bert.swiglu_reference(y),
        *bound(n * inter * 6, n * inter * 4, PEAK_F32_FLOPS), max_abs_err=err,
        library_ms=None)))
    del y

    # F2's RMSNorm form: x + r and its norm, [n, H]; 8 B an element with a
    # residual (x, r read; the output and the sum written), 4 B without
    x, r = (torch.randn(n, h, device=device, generator=g).bfloat16() for _ in range(2))
    scale = (1.0 + 0.1 * torch.randn(h, device=device, generator=g)).bfloat16()
    worst, ulps = 0.0, 0.0
    for res in (r, None):
        got, s = fused_bert.add_rms_norm(x, res, scale, cfg.rms_norm_eps)
        want, want_s = fused_bert.add_rms_norm_reference(x, res, scale, cfg.rms_norm_eps)
        check(torch.equal(s, want_s), f"F2 RMSNorm [{n}, {h}]: the sum is not bit-equal")
        u = _bf16_ulps(got, want, LN_ULP_FLOOR)
        check(u <= 1.0, f"F2 RMSNorm [{n}, {h}]{' + residual' if res is not None else ''}: "
                        f"{u} bf16 ulps (at magnitudes of at least {LN_ULP_FLOOR})")
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        ulps = max(ulps, u)
        del got, s, want, want_s
    sx = x + r
    library = (cuda_ms(lambda: torch.nn.functional.rms_norm(sx, (h,), scale, cfg.rms_norm_eps))
               if hasattr(torch.nn.functional, "rms_norm") else None)
    del sx
    runs.append(("F2 rms_row", f"[{n}, {h}] bf16 + residual", timed_run(
        lambda: fused_bert.add_rms_norm(x, r, scale, cfg.rms_norm_eps),
        lambda: fused_bert.add_rms_norm_reference(x, r, scale, cfg.rms_norm_eps),
        *bound(n * h * 8 + h * 2, n * h * 5, PEAK_F32_FLOPS), max_abs_err=worst,
        bf16_ulps=ulps, library_ms=library)))
    del x, r

    # the RoPE copy: the n real rows of the fused product [n, (nq + 2 nkv) hd]
    # read once, every padded position of q, k and v written once (zeros past
    # a row's length); q and k rotated (6 operations an element: two
    # products, an add, the tables' two reads)
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    width = (nq + 2 * nkv) * hd
    cu = torch.zeros(b + 1, dtype=torch.int64)
    cu[1:] = lengths.cumsum(0)
    cu = cu.to(device)
    cos, sin = rope.rope_tables(t, hd, cfg.rope_theta, device)
    qkv = torch.randn(n, width, device=device, generator=g).bfloat16()
    got = rope.rope_qkv_packed(qkv, cu, t, cos, sin, nq, nkv)
    want = rope.rope_qkv_packed_reference(qkv, cu, t, cos, sin, nq, nkv)
    err = max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want))
    check(all(torch.equal(a.view(torch.int16), w.view(torch.int16)) for a, w in zip(got, want)),
          f"RoPE copy [{n}, {width}]: max abs err {err}, not bit-equal")
    del got, want
    runs.append(("RoPE", f"[{n}, {width}] -> q [{b}, {nkv}, {nq // nkv * t}, {hd}], "
                         f"k, v [{b}, {nkv}, {t}, {hd}] bf16", timed_run(
        lambda: rope.rope_qkv_packed(qkv, cu, t, cos, sin, nq, nkv),
        lambda: rope.rope_qkv_packed_reference(qkv, cu, t, cos, sin, nq, nkv),
        *bound(qkv.numel() * 2 + b * t * width * 2 + 2 * t * hd * 4 + (b + 1) * 8,
               6 * n * (nq + nkv) * hd, PEAK_F32_FLOPS), max_abs_err=err,
        library_ms=None)))
    del qkv
    torch.cuda.empty_cache()
    for kernel, label, result in runs:
        log(f"{kernel} {label}: {json.dumps(result)}")
    return runs


def phase_decoder(device) -> tuple[list, dict]:
    """E5-Mistral-7B (models/mistral.py at MistralConfig's published
    widths): (a) its kernels against their plain versions at the E5 cell's
    shapes, timed (_decoder_kernels); (b) its retrieve path: the E5 cell's
    batch (profile_slice.e5_cell_lengths) as host rows, right-padded,
    through encode_query (random weights drawn on the card), then
    DenseIndex.search top-E5_K over E5_CORPUS seeded 4,096-d bf16 rows, every launch counter reset before and read
    after (F1's SwiGLU form, F2's RMSNorm form and the RoPE copy once or
    twice a layer; K1, K6), the embeddings unit-norm and every query's
    answers against the exact top-E5_K; the call's time and peak memory
    logged. Returns the kernels line's entries of the three kernels, timed
    at the shapes this call runs, and the phase's numbers."""
    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.models import mistral
    from proqa_tpu_torch.ops import fused_bert, mips, mips_kernel, rescore, rope
    from proqa_tpu_torch.profile_slice import e5_cell_lengths
    from proqa_tpu_torch.testing import topk_disagreements

    gpu = gpu_line()
    cfg = mistral.MistralConfig()
    t0 = time.perf_counter()
    runs = _decoder_kernels(device, cfg)
    kernels_s = round(time.perf_counter() - t0, 1)

    # (b) the retrieve path, counters at 0
    t0 = time.perf_counter()
    model = mistral.MistralRetriever.on_device(cfg, device, 71)
    lengths = torch.tensor(e5_cell_lengths())
    rows = lengths.numel()
    lengths = lengths[torch.randperm(rows, generator=torch.Generator().manual_seed(72))]
    t = int(lengths.max())
    mask = (torch.arange(t)[None] < lengths[:, None]).to(torch.int32)
    ids = torch.randint(3, cfg.vocab_size, (rows, t),
                        generator=torch.Generator().manual_seed(73)) * mask
    g = torch.Generator(device=device).manual_seed(74)
    corpus = (torch.randn(E5_CORPUS, cfg.hidden_size, device=device, generator=g)
              * cfg.hidden_size ** -0.5).bfloat16()
    index = DenseIndex.from_embeddings(corpus, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_bert.form_launches.clear()
    rope.launches = mips_kernel.launches = rescore.launches = 0
    mistral.reset_counters()
    emb = model.encode_query(ids, mask)
    vals, idx = index.search(emb, E5_K)
    counts = {**_form_counts(), "RoPE": rope.launches, "K1": mips_kernel.launches,
              "K6": rescore.launches, "calls": mistral.calls, "positions": mistral.positions,
              "tokens": mistral.tokens}
    peak = round(torch.cuda.max_memory_allocated() / 2**30, 2)
    layers = cfg.num_layers
    check(counts.get("F1 swiglu", 0) == layers and counts.get("F2 rms_row", 0) == 2 * layers + 1
          and counts["RoPE"] == layers and counts["K1"] > 0 and counts["K6"] > 0
          and counts["tokens"] == int(lengths.sum()), f"E5 retrieve path: launches {counts}")
    norms = emb.norm(dim=-1)
    check(bool(torch.isfinite(emb).all()) and emb.shape == (rows, cfg.hidden_size)
          and float((norms - 1).abs().max()) < 1e-3, "E5 retrieve path: bad embeddings")
    qb, bad = emb.bfloat16(), 0
    for s in range(0, rows, 128):
        rv, ri = mips.mips_topk_reference(qb[s:s + 128], corpus, E5_K)
        bad += topk_disagreements(vals[s:s + 128], idx[s:s + 128], rv.cpu().numpy(),
                                  ri.cpu().numpy(), atol=TOPK_TOL)
    check(bad == 0, f"E5 retrieve path: {bad} of {rows} queries disagree with the exact "
                    f"top-{E5_K}")
    call_ms = cuda_ms(lambda: index.search(model.encode_query(ids, mask), E5_K), reps=3)
    path_s = round(time.perf_counter() - t0, 1)
    log(f"{gpu}: decoder (b) E5-Mistral-7B retrieve path, {rows} rows of "
        f"{int(lengths.min())}-{t} ids ({counts['tokens']} real of {counts['positions']} "
        f"positions): encode_query then DenseIndex.search top-{E5_K} over {E5_CORPUS} x "
        f"{cfg.hidden_size} bf16: unit-norm embeddings, every query's answers agree with the "
        f"exact top-{E5_K} up to ties; launches {json.dumps(counts)}; {call_ms:.2f} ms a call "
        f"({rows / call_ms * 1e3:.1f} queries/s, CUDA events); peak {peak} GiB; kernels "
        f"{kernels_s} s, path {path_s} s")
    del index, corpus, model, emb, qb
    torch.cuda.empty_cache()

    of = {"F1 swiglu": ("dense_epilogue SwiGLU form (F1)", "dense_epilogue.cu",
                        counts["F1 swiglu"]),
          "F2 rms_row": ("add_layer_norm RMSNorm form (F2)", "layer_norm.cu",
                         counts["F2 rms_row"]),
          "RoPE": ("rope_qkv_packed (RoPE copy)", "rope.cu", counts["RoPE"])}
    entries = []
    for kernel, label, result in runs:
        name, source, launches = of[kernel]
        entries.append((f"{name} {label} (E5 tower)", source,
                        "none: the JAX package has no decoder", launches, result))
    return entries, {"counts": counts, "call_ms": call_ms, "peak_gib": peak}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        from proqa_tpu_torch import _build
        from proqa_tpu_torch.ops.dot import pin_f32_precision

        log(gpu_line())
        pin_f32_precision()
        device = torch.device("cuda", 0)
        t0 = time.perf_counter()
        lib = _build.build()
        log(f"kernel build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
        _build.library()
        phases = {}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            phases[name] = round(time.perf_counter() - t0, 1)
            torch.cuda.empty_cache()
            return out

        # the dense-retrieval slice
        timed("encoder", phase_encoder, device)
        f1, f2 = timed("fused_bert", phase_fused_bert, device)
        f_backward = timed("fused_bert_backward", phase_fused_bert_backward, device)
        k1 = timed("mips", phase_mips, device)
        with tempfile.TemporaryDirectory(prefix="proqa_smoke_") as root, \
                tempfile.TemporaryDirectory(prefix="proqa_smoke_") as pretrain_root:
            retrieval, k1_cli_err, batch, recall = timed("retrieval_cli", phase_cli, device, root)
            k5_launches, k5_cli_err = timed("int8_cli", phase_int8_cli, device, root, recall)
            f32_launches, k6_f32_cli = timed("f32_cli", phase_f32_cli, device, root, recall)
            # the QA answering slice, on the same retrieval world
            qa = timed("qa_cli", phase_qa, device, root)
            # serving: the streaming index writer, serve with live updates, IVF
            stream = timed("stream_cli", phase_stream_cli, device, root, recall)
            serve = timed("serve", phase_serve, device, root)
            ivf = timed("ivf", phase_ivf, device, root)
            k2_encode = timed("attention_encode", phase_attention, device, batch)
            # the retriever-pretraining slice
            k4 = timed("dropout", phase_dropout, device)
            k2, k3 = timed("attention_train", phase_attention_train, device)
            timed("train_step", phase_train_step, device)
            pretrain = timed("pretrain_cli", phase_pretrain_cli, device, pretrain_root)
            # QA finetuning, on the retrieval world with the pretrained retriever
            qa_train = timed("qa_train", phase_qa_train, device, root)
            finetune = timed("finetune_cli", phase_finetune_cli, device, root, pretrain_root)
            # multi-device and the remaining commands
            ddp = timed("ddp", phase_ddp, device, pretrain_root)
            convert = timed("convert", phase_convert, device, root)
            sharded = timed("sharded", phase_sharded, device, root, recall)
            # k-means, then cluster-batched pretraining on the pretraining world
            timed("kmeans", phase_kmeans, device)
            cluster = timed("cluster_cli", phase_cluster_cli, device, pretrain_root)
        timed("index_updates", phase_index_updates, device)
        # the int8 index and the rest of the search kernels
        k5 = timed("int8", phase_int8, device)
        k5_cap = timed("int8_capacity", phase_int8_capacity, device)
        k7, k7_launches = timed("bounded", phase_bounded, device)
        k8, k8_launches = timed("v1", phase_v1, device)
        k6, k9, rescore_launches = timed("rescore", phase_rescore, device)
        # the f32 parity path
        k1_f32 = timed("f32", phase_f32, device)
        # MiniLM-L12-H384: head dim 32 (and 128, and a padded one) on the card
        minilm, _ = timed("minilm", phase_minilm, device)
        # BERT-xlarge: F1 and F2 past their first forms (hidden 2,048; 4,096 and 16,384)
        xlarge, _ = timed("xlarge", phase_xlarge, device)
        # the exact search at every embedding width; DPR's 21M x 768 index
        wide_search, _ = timed("embed_widths", phase_embed_widths, device)
        # heads wider than 128: 3 heads of 256 at BERT-base's widths, 384 and 768
        wide_heads, _ = timed("wide_heads", phase_wide_heads, device)
        # E5-Mistral-7B's decoder: its kernels and its retrieve path
        decoder, _ = timed("decoder", phase_decoder, device)
        log(f"phase seconds: {json.dumps(phases)}")
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "proqa_tpu"))
        check(not loaded, f"the port imported {loaded[:5]}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    def entry(name, source, replaces, launches, result, max_abs_err=None):
        if max_abs_err is None:
            max_abs_err = result["max_abs_err"]
        return {"name": name, "route": "cuda", "source": f"proqa_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err,
                **{key: result[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms", "colsum_rel_err", "queued_ms",
                                                "kernel_ms", "kernel_traces", "bytes_bound_ms",
                                                "issue_bound_ms")
                   if key in result}}

    qa_runs = [*qa["launches"].values(), serve["launches"]]
    at_shards = sharded["launches"]
    qa_launches = {name: sum(run[name] for run in qa_runs)
                   for name in ("K1", "K2", "K5", "K6", "F1", "F2")}
    at_serve = serve["errs"]
    at_qa_train = qa_train["kernels"]
    trained = {name: pretrain[name] + finetune[name] + cluster[name] + ddp[name]
               for name in ("F1", "F2", "F1 backward", "F2 backward")}
    # launches: the main paths' runs (retrieval CLI, pretraining CLI, QA CLI,
    # serve with /add and /remove, bf16 and int8, finetune-qa, pretraining on
    # cluster shards, and the streamed build-index)
    kernels = [
        entry("block_maxima_grouped (K1)", "block_maxima_wgmma.cu",
              "proqa_tpu/ops/pallas_mips.py:83",
              retrieval["block_maxima"] + pretrain["K1"] + qa_launches["K1"] + finetune["K1"]
              + at_shards["K1"], k1,
              max(k1["max_abs_err"], k1_cli_err, qa["k1_err"], at_serve["K1"])),
        entry("fused_attention (K2)", "attention_fwd.cu", "proqa_tpu/ops/pallas_attention.py:65",
              retrieval["attention"] + pretrain["K2"] + qa_launches["K2"] + finetune["K2"]
              + cluster["K2"] + stream["K2"] + convert["K2"] + ddp["K2"], k2,
              max(k2["max_abs_err"], k2_encode["max_abs_err"], qa["k2_err"],
                  at_qa_train["K2"]["max_abs_err"], at_serve["K2"])),
        entry("fused_attention backward (K3)", "attention_bwd.cu",
              "proqa_tpu/ops/pallas_attention.py:83",
              pretrain["K3"] + finetune["K3"] + cluster["K3"] + ddp["K3"], k3,
              max(k3["max_abs_err"], at_qa_train["K3"]["max_abs_err"])),
        entry("dropout (K4)", "dropout.cu", "proqa_tpu/ops/pallas_dropout.py:32",
              pretrain["K4"] + finetune["K4"] + cluster["K4"] + ddp["K4"], k4, k4["max_abs_err"]),
        # launches: the int8 CLI paths (K5: retrieval and answer) and each
        # kernel's own pipeline (K7-K9); times at 4.2M rows (K5 at 67.1M: in
        # the log above)
        entry("block_maxima_grouped scaled (K5)", "block_maxima_wgmma.cu",
              "proqa_tpu/ops/pallas_mips.py:97", k5_launches + qa_launches["K5"] + at_shards["K5"],
              k5,
              max(k5["max_abs_err"], k5_cap["max_abs_err"], k5_cli_err, qa["k5_err"],
                  at_serve["K5"])),
        # launches: the retrieval, pretraining, f32, QA CLI and serve paths (K6
        # is the rescore of every bf16 and f32 search); K9: its own pipeline's run
        entry("gather_rescore (K6)", "gather_rescore.cu", "proqa_tpu/ops/pallas_rescore.py:58",
              retrieval["rescore"] + pretrain["K6"] + k6_f32_cli + qa_launches["K6"]
              + finetune["K6"] + at_shards["K6"], k6, max(k6["max_abs_err"], at_serve["K6"])),
        entry("block_maxima_grouped bounded (K7)", "block_maxima_wgmma.cu",
              "proqa_tpu/ops/pallas_mips.py:111", k7_launches, k7),
        entry("block_maxima (K8)", "block_maxima_wgmma.cu", "proqa_tpu/ops/pallas_mips.py:32",
              k8_launches, k8),
        entry("gather_score (K9)", "gather_rescore.cu",
              "proqa_tpu/ops/pallas_gather_score.py:35", rescore_launches["K9"], k9),
        # launches: the f32 CLI path (eval-retrieval and retrieve --f32)
        entry("block_maxima_grouped f32 (K1)", "block_maxima_f32.cu",
              "proqa_tpu/ops/pallas_mips.py:83", f32_launches, k1_f32),
        # the XLA fusions around the BERT layer's products; launches: the
        # retrieval CLI, the QA CLI and serve (no graph recorded), and the
        # pretraining, finetune-qa, cluster-shard and DDP paths (training)
        entry("dense_epilogue (F1)", "dense_epilogue.cu", "proqa_tpu/models/bert.py:147",
              retrieval["F1"] + qa_launches["F1"] + trained["F1"], f1),
        entry("add_layer_norm (F2)", "layer_norm.cu", "proqa_tpu/models/bert.py:137",
              retrieval["F2"] + qa_launches["F2"] + trained["F2"], f2),
    ]
    # their backward kernels, the transposes of the same fusions, at both
    # train steps' shapes (launches: the kernel's, in each of its entries)
    backward_of = {"F1": ("dense_epilogue", "dense_epilogue.cu", "proqa_tpu/models/bert.py:147"),
                   "F2": ("add_layer_norm", "layer_norm.cu", "proqa_tpu/models/bert.py:137")}
    for kernel, label, result in f_backward:
        name, source, replaces = backward_of[kernel]
        kernels.append(entry(f"{name} backward ({kernel}) {label}", source, replaces,
                             trained[f"{kernel} backward"], result))
    # K2/K3 at head dims 32 and 128 (launches: the MiniLM path's encode,
    # reader and train steps at Dh 32; the Dh 128 tower's encode and step)
    kernels += [entry(*form) for form in minilm]
    # F1's and F2's wide forms at the xlarge path's shapes (launches: the form's
    # on the xlarge encode, reader and train step and the xxlarge tower; F1's
    # backward at 16,384 columns: the xxlarge train step's)
    kernels += [entry(*form) for form in xlarge]
    # the search kernels' K-loop forms at D = 768 (launches: DPR's index in
    # bf16, int8 and f32 and the 768-wide CLI; K7, K8, K9: their own
    # pipelines at D = 768)
    kernels += [entry(*form) for form in wide_search]
    # K2/K3 past Dh = 128 (launches: the 3-heads-of-256 tower's encode, reader
    # and train steps; the loop forms: the Dh 384 and 768 towers' encode and step)
    kernels += [entry(*form) for form in wide_heads]
    # the decoder's F1 and F2 forms and RoPE copy at the E5 cell's shapes
    # (launches: one E5 retrieve call at the published widths)
    kernels += [entry(*form) for form in decoder]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def pin_hash_seed() -> None:
    """Re-executes this script with PYTHONHASHSEED=0 unless it runs so. The
    QA sampler, as the reference and the JAX package do, keeps the first
    max_spans answer spans of a paragraph in the iteration order of a set of
    strings (text/matching.py:match_answer_span), which follows Python's
    per-process string hash: unpinned, phase 19's train batch, and so its
    trained weights and dropout-0 inputs, differed in every process."""
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})


if __name__ == "__main__":
    pin_hash_seed()
    if len(sys.argv) > 2 and sys.argv[1] == "--cli-worker":
        sys.exit(cli_worker(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
