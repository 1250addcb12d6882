#!/usr/bin/env python3
"""Smoke test of the PyTorch port (proqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases, each of which must pass. The dense-retrieval slice:
  1. build the hand-written CUDA kernels from proqa_tpu_torch/csrc;
  2. the BERT-base context tower with fused attention (K2) against the
     vanilla attention path;
  3. K1, block maxima: the kernel against its plain version at the
     reference's operating point, a 4,194,304 x 128 bf16 corpus and 2,048
     queries, and at 32 queries (a small batch), then DenseIndex top-80
     search against an exact reference;
  4. the main path through the CLI (build-db, build-index, encode-queries,
     eval-retrieval, retrieve) on a synthetic world of 8,192 paragraphs with
     random BERT-base retriever weights, with both kernels' launch counters
     reset before and read after, the eval's top-80 checked, and K1 held
     against its plain version at the shapes this search gave it;
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
     on one batch whose loss must fall, K2/K3/K4 launch counters read, and one
     dropout-0 step with the kernels against the vanilla attention path
     (gradient cosine);
  9. the slice's main path through the CLI: pretrain-retriever (BERT-base,
     contexts of T=256, so K2/K3 run; queries of T=30 on the vanilla path
     with K4 on their probabilities), then build-index from its
     checkpoint_last.pt and retrieve over it (K1), with every counter reset
     before and read after, and the index checked against the plain encoder.
The int8 index and the rest of the search kernels:
 10. K5, scaled block maxima over int8 codes, against its plain version at
     4,194,304 x 128 (block 16, Q = 2,048; codes made on the device), then a
     DenseIndex(dtype="int8") quantized on the host from an f32 corpus: top-80
     search qps, and 256 queries against the exact top-80 of the dequantized
     corpus;
 11. K5 at the capacity point, 67,108,864 x 128 int8 (block 128), made on
     the device: the kernel against its plain version in chunks, mips_topk's
     qps and peak memory, and 64 queries against a chunked exact reference;
 12. K7, per-row scale bounds, at 4.2M: equal to the formula, dominating the
     true row-scaled block maxima, and mips_topk_v2(row_scales=, kb=16k)
     returning exact row-scaled scores;
 13. K8, block-major maxima, against its plain version at 4.2M bf16, and
     mips_topk_v1's top-80 against the K1 pipeline's;
 14. K6/K9, gathered candidate scoring, on the candidate blocks the K1
     pipeline selects at 4.2M (Q = 2,048, k = 80), against the plain gather
     and product, timed beside the `take` path, and the streamed rescore's
     top-80 against the take rescore's;
 15. the int8 CLI path: eval-retrieval and retrieve with --int8-index on the
     retrieval world of phase 4 (8,192 rows, quant block 16, so K5 runs),
     with every counter reset before and read after, and a direct int8
     DenseIndex.search against the exact reference of its own codes.
Each of phases 12-14 first drives its kernel's public pipeline once with the
counters at 0 and reads them, then compares and times the kernel. Kernel
times are device times by CUDA events around one call (cuda_ms); phases 6
and 7 also log K4's, K2's, K3's, F.dropout's and SDPA's mean over 10
back-to-back calls ("queued").

Prints the GPU's name and power limit first, a JSON line of per-kernel
results second to last, and {"ok": true, "device": ...} last. Exits non-zero,
printing no result, when there is no GPU or any phase fails.
"""
from __future__ import annotations

import contextlib
import io
import json
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
ENCODER_COS = 0.999  # embeddings with and without K2, 12 bf16 layers apart
# K3 against its plain version: both round pd and ds to bf16 at the same
# points, but the kernel recomputes the scores with the key and query roles
# swapped for dk and dv, and sums in another order; one flipped bf16 rounding
# of ds or pd before a T-long product moves an output by a few bf16 ulps of
# values of magnitude ~1 (tests/test_torch_cuda.py holds the same bound)
BWD_TOL = 6e-2
# K3 against torch autograd through K2's plain version: autograd rounds do v^T
# to bf16 (the backward of the probabilities' cast) where the TPU kernel's
# formula keeps it in f32, one more rounding before each product; dv and dk
# reach magnitudes of 8-16 at T = 128, where one bf16 ulp is 0.0625, so this
# check counts bf16 ulps at each output's largest magnitude (2^-7 of it)
AUTOGRAD_ULPS = 2.0
GRAD_COS = 0.99   # dropout-0 gradients, K2/K3 against the vanilla path, bf16
LOSS_DROP = 1.0   # nats the train step's loss must fall over 20 steps on one batch

# H100 SXM peaks (NVIDIA's data sheet): dense bf16 tensor-core rate, HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take for this work, and what bounds
    it: each input read once and each output written once at the HBM rate,
    or the operations at the bf16 tensor-core rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
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
    and the encoder's device throughput."""
    import dataclasses

    import torch

    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.retriever import Retriever

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
    log(f"encoder BERT-base bf16 B={bsz} T={t}: K2 vs vanilla min cosine {cos:.6f} "
        f"(tol {ENCODER_COS}); {ms:.2f} ms per batch = {bsz * t / ms * 1e3:.0f} padded tokens/s")


def grouped_against_plain(name, queries, corpus, *, block, chunk_groups=128, reps=3,
                          **scale_kw) -> dict:
    """block_maxima_grouped (K1, K5 or K7 by its keywords) against its plain
    version, which runs chunk_groups groups at a time (the whole [Q, N] f32
    score matrix would not fit); both timed by CUDA events, the plain one as
    the sum of its chunks. Scales are sliced with their chunk."""
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
    bound_ms, bound_by = bound(nbytes, 2.0 * n * q * corpus.shape[1])
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
    from proqa_tpu_torch.ops import mips
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
    vals, idx = index.search(queries, k)
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
        f"batch, host clock); {n_check} queries agree with the exact reference up to ties")
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
    from proqa_tpu_torch.ops import attention, mips, mips_kernel
    from proqa_tpu_torch.testing import topk_disagreements

    n_paras, n_q, k, batch = 8192, 256, 80, 512
    tokens = write_world(root, n_paras, n_q, seed=6)
    ckpt = os.path.join(root, "retriever.npz")
    save_npz(ckpt, params_to_jax(Retriever(BertConfig()).reset_parameters(7).state_dict()))
    p = lambda name: os.path.join(root, name)  # noqa: E731
    common = ["--vocab", p("vocab.txt"), "--init-checkpoint", ckpt, "--device", str(device)]

    attention.launches = 0
    mips_kernel.launches = 0
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
    launches = {"attention": attention.launches, "block_maxima": mips_kernel.launches}
    log(f"kernel launches during the CLI run: {json.dumps(launches)}")
    check(launches["attention"] > 0, "K2 was not launched on the main path")
    check(launches["block_maxima"] > 0, "K1 was not launched on the main path")

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
    from proqa_tpu_torch.ops import attention, dropout
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
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = train_step(model, state, tx, batch, gen)
        losses.append(float(m["loss"]))  # synchronises
        walls.append(time.perf_counter() - t0)
    launches = {"K2": attention.launches, "K3": attention.backward_launches,
                "K4": dropout.launches}
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

    # dropout 0: the fused kernels (K2 forward, K3 backward) against the
    # vanilla attention path, same weights, same batch
    cfg0 = dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)
    fused = Retriever(cfg0).to(device)
    fused.load_state_dict(model.state_dict())
    del model, state
    torch.cuda.empty_cache()
    loss_k, grads_k = _grads(fused, batch, gen)
    vanilla = Retriever(dataclasses.replace(cfg0, flash_attention=False)).to(device)
    vanilla.load_state_dict(fused.state_dict())
    del fused
    loss_p, grads_p = _grads(vanilla, batch, gen)
    cos = {}
    for k, gk in grads_k.items():
        # the key bias and proj_c's bias get zero gradient in exact arithmetic
        # (softmax ignores a constant added to a row): only noise, skipped
        if k.endswith(".k.bias") or k == "proj_c.bias":
            continue
        cos[k] = torch.nn.functional.cosine_similarity(gk.flatten(), grads_p[k].flatten(),
                                                       dim=0).item()
    worst = min(cos, key=cos.get)
    log(f"dropout-0 step, kernels vs vanilla attention: loss {loss_k:.6f} vs {loss_p:.6f}, min "
        f"gradient cosine {cos[worst]:.6f} ({worst}; tol {GRAD_COS}) over {len(cos)} tensors")
    check(cos[worst] >= GRAD_COS,
          f"dropout-0 gradients: cosine {cos[worst]} < {GRAD_COS} ({worst})")
    return {"step_ms": step_ms, "tokens_per_s": b * (tq + tc) / step_ms * 1e3, "peak_gib": peak,
            "loss_first": losses[0], "loss_last": losses[-1], "min_grad_cos": cos[worst]}


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
    from proqa_tpu_torch.ops import attention, dropout, mips_kernel
    from proqa_tpu_torch.text.wordpiece import BertTokenizer

    n_paras = 4608  # padded index past 4,096 rows: retrieve searches through K1
    write_pair_world(root, n_pairs=96, n_paras=n_paras, seed=12)
    p = lambda name: os.path.join(root, name)  # noqa: E731
    seq = ["--vocab", p("vocab.txt"), "--max-seq-length", "286", "--max-query-length", "30",
           "--device", str(device)]
    attention.launches = attention.backward_launches = 0
    dropout.launches = mips_kernel.launches = 0
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
                "K3": attention.backward_launches, "K4": dropout.launches}
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
    """The exact top-k of scale * (query . codes) over the whole corpus, a
    chunk of rows at a time (the global top-k is the top-k of the chunks')."""
    import torch

    from proqa_tpu_torch.ops import mips

    cand_v, cand_i = [], []
    for r0 in range(0, codes.shape[0], chunk):
        v, i = mips.mips_topk_reference(queries, codes[r0:r0 + chunk], k,
                                        scales=row_scales[r0:r0 + chunk])
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
    k5 = grouped_against_plain("K5", qb, codes, block=block, scales=scales)
    del k5["out"], codes, scales

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
    return {**k5, "qps": qps}


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
    mips_kernel.block_major_launches = 0
    v1 = mips_kernel.mips_topk_v1(qb, corpus, k)
    torch.cuda.synchronize()
    launches = mips_kernel.block_major_launches
    check(launches > 0, "K8 was not launched by mips_topk_v1")
    v2 = mips_kernel.mips_topk_v2(qb, corpus, k, block=16)
    bad = topk_disagreements(*(x.cpu().numpy() for x in (*v1, *v2)), atol=TOPK_TOL)
    check(bad == 0, f"mips_topk_v1: {bad} of {q} queries disagree with the K1 pipeline")
    del v1, v2

    block, tile_n = 256, 2048
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
    """K6 and K9 on the candidate blocks the K1 pipeline selects at 4.2M
    (Q = 2,048, k = 80): mips_topk_v2(rescore_impl="stream") and gather_score
    once with the counters at 0; then both against the plain gather and
    product, timed beside the `take` path (the gather and dot_f32), and the
    streamed top-80 against the take top-80."""
    import torch

    from proqa_tpu_torch.ops import mips_kernel, rescore
    from proqa_tpu_torch.ops.dot import dot_f32
    from proqa_tpu_torch.testing import topk_disagreements

    corpus, queries = bf16_corpus(device)
    (n, d), q, k, block = corpus.shape, queries.shape[0], 80, 16
    qb = queries.bfloat16()
    blocks = corpus.view(-1, block, d)
    ids = mips_kernel.select_blocks(qb, corpus, k, block=block)          # [Q, 80]
    rescore.launches = rescore.score_launches = 0
    stream = mips_kernel.mips_topk_v2(qb, corpus, k, block=block, rescore_impl="stream")
    rescore.gather_score(qb, blocks, ids, block=block)
    torch.cuda.synchronize()
    launches = {"K6": rescore.launches, "K9": rescore.score_launches}
    check(all(v > 0 for v in launches.values()), f"K6/K9 not launched: {launches}")
    take = mips_kernel.mips_topk_v2(qb, corpus, k, block=block)
    bad = topk_disagreements(*(x.cpu().numpy() for x in (*stream, *take)), atol=TOPK_TOL)
    check(bad == 0, f"stream rescore: {bad} of {q} queries disagree with the take rescore")

    want = rescore.gather_rescore_reference(qb, blocks, ids, block=block)
    kb = ids.shape[1]

    def take_path():
        cand = blocks[ids].view(q, kb * block, d)
        return dot_f32(cand, qb[:, :, None]).view(q, kb * block)

    results = {}
    for name, fn in (("K6", rescore.gather_rescore), ("K9", rescore.gather_score)):
        got = fn(qb, blocks, ids, block=block)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= BMAX_TOL, f"{name}: max abs err {err} > {BMAX_TOL}")
        results[name] = {"max_abs_err": err,
                         "ms": cuda_ms(lambda: fn(qb, blocks, ids, block=block), reps=20)}
    plain_ms = cuda_ms(lambda: rescore.gather_rescore_reference(qb, blocks, ids, block=block))
    library_ms = cuda_ms(take_path, reps=20)
    # bytes this data needs: each distinct candidate block read once
    distinct = torch.unique(ids).numel()
    nbytes = distinct * block * d * 2 + qb.numel() * 2 + ids.numel() * 8 + want.numel() * 4
    bound_ms, bound_by = bound(nbytes, 2.0 * q * kb * block * d)
    for name, r in results.items():
        r.update(plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"{name} Q={q} kb={kb} block={block} bf16 ({distinct} distinct candidate blocks): "
            f"max_abs_err {r['max_abs_err']:.3g} (tol {BMAX_TOL}), kernel {r['ms']:.4f} ms, "
            f"plain {plain_ms:.4f} ms, take path (gather + dot_f32) {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
    log(f"streamed rescore top-{k}: all {q} queries agree with the take rescore up to ties")
    return results["K6"], results["K9"], launches


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
    got = mips_kernel.block_maxima_grouped(qt, index.embeddings, block=block, scales=index.scales)
    want = mips_kernel.block_maxima_grouped_reference(qt, index.embeddings, block=block,
                                                      scales=index.scales)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    check(err <= BMAX_TOL, f"K5 at the CLI's shapes: max abs err {err} > {BMAX_TOL}")
    log(f"int8 index (quant block {block}): all {len(q)} queries agree with the exact reference "
        f"up to ties; K5 at Q={len(q)} N={index.embeddings.shape[0]}: max_abs_err {err:.3g}")
    return launches["K5"], err


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
        k1 = timed("mips", phase_mips, device)
        with tempfile.TemporaryDirectory(prefix="proqa_smoke_") as root:
            retrieval, k1_cli_err, batch, recall = timed("retrieval_cli", phase_cli, device, root)
            k5_launches, k5_cli_err = timed("int8_cli", phase_int8_cli, device, root, recall)
        k2_encode = timed("attention_encode", phase_attention, device, batch)
        # the retriever-pretraining slice
        k4 = timed("dropout", phase_dropout, device)
        k2, k3 = timed("attention_train", phase_attention_train, device)
        timed("train_step", phase_train_step, device)
        with tempfile.TemporaryDirectory(prefix="proqa_smoke_") as root:
            pretrain = timed("pretrain_cli", phase_pretrain_cli, device, root)
        # the int8 index and the rest of the search kernels
        k5 = timed("int8", phase_int8, device)
        k5_cap = timed("int8_capacity", phase_int8_capacity, device)
        k7, k7_launches = timed("bounded", phase_bounded, device)
        k8, k8_launches = timed("v1", phase_v1, device)
        k6, k9, rescore_launches = timed("rescore", phase_rescore, device)
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
                                                "library_ms")}}

    # launches: both main paths' runs (retrieval CLI, then pretraining CLI)
    kernels = [
        entry("block_maxima_grouped (K1)", "block_maxima_wgmma.cu",
              "proqa_tpu/ops/pallas_mips.py:83",
              retrieval["block_maxima"] + pretrain["K1"], k1,
              max(k1["max_abs_err"], k1_cli_err)),
        entry("fused_attention (K2)", "attention_fwd.cu", "proqa_tpu/ops/pallas_attention.py:65",
              retrieval["attention"] + pretrain["K2"], k2,
              max(k2["max_abs_err"], k2_encode["max_abs_err"])),
        entry("fused_attention backward (K3)", "attention_bwd.cu",
              "proqa_tpu/ops/pallas_attention.py:83", pretrain["K3"], k3, k3["max_abs_err"]),
        entry("dropout (K4)", "dropout.cu", "proqa_tpu/ops/pallas_dropout.py:32", pretrain["K4"],
              k4, k4["max_abs_err"]),
        # launches: the int8 CLI path (K5) and each kernel's own pipeline
        # (K6-K9); times at 4.2M rows (K5 at 67.1M: in the log above)
        entry("block_maxima_grouped scaled (K5)", "block_maxima.cu",
              "proqa_tpu/ops/pallas_mips.py:97", k5_launches, k5,
              max(k5["max_abs_err"], k5_cap["max_abs_err"], k5_cli_err)),
        entry("gather_rescore (K6)", "gather_rescore.cu", "proqa_tpu/ops/pallas_rescore.py:58",
              rescore_launches["K6"], k6),
        entry("block_maxima_grouped bounded (K7)", "block_maxima.cu",
              "proqa_tpu/ops/pallas_mips.py:111", k7_launches, k7),
        entry("block_maxima (K8)", "block_maxima.cu", "proqa_tpu/ops/pallas_mips.py:32",
              k8_launches, k8),
        entry("gather_score (K9)", "gather_rescore.cu",
              "proqa_tpu/ops/pallas_gather_score.py:35", rescore_launches["K9"], k9),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
