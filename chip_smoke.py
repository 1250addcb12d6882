#!/usr/bin/env python3
"""Smoke test of the PyTorch port (proqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases, each of which must pass. The dense-retrieval slice:
  1. build the hand-written CUDA kernels from proqa_tpu_torch/csrc;
  2. the BERT-base context tower with fused attention (K2) against the
     vanilla attention path;
  3. K1, block maxima: the kernel against its plain version at the
     reference's operating point, a 4,194,304 x 128 bf16 corpus and 2,048
     queries, then DenseIndex top-80 search against an exact reference;
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
     sigma of 0.9 and a backward that applies the forward's mask;
  7. K2 at dropout rate 0.1 (the same bits as its plain version) and K3, the
     attention backward, at rates 0 and 0.1, against their plain versions
     (for K3 also against autograd through K2's plain version) at the train
     step's shapes (B=80, H=12, Dh=64, T in 128..512, bf16, one
     all-padding row), timed beside F.scaled_dot_product_attention;
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


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of fn() in ms, by CUDA events, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def phase_mips(device) -> dict:
    import numpy as np
    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.ops import mips, mips_kernel
    from proqa_tpu_torch.ops.dot import dot_f32
    from proqa_tpu_torch.testing import topk_disagreements

    n, q, d, k = 4_194_304, 2048, 128, 80
    block = mips.envelope_block(n, q)
    rows = mips_kernel.GROUP * block
    g = torch.Generator(device=device).manual_seed(4)
    corpus = (torch.randn(n, d, device=device, generator=g) / d ** 0.5).bfloat16()
    queries = torch.randn(q, d, device=device, generator=g) / d ** 0.5
    qb = queries.bfloat16()

    bmax3, gmax = mips_kernel.block_maxima_grouped(qb, corpus, block=block)
    torch.cuda.synchronize()
    nbytes = (corpus.numel() + qb.numel()) * 2 + (bmax3.numel() + gmax.numel()) * 4
    bound_ms, bound_by = bound(nbytes, 2.0 * n * q * d)
    ms = cuda_ms(lambda: mips_kernel.block_maxima_grouped(qb, corpus, block=block), reps=3)
    err, plain_ms, chunk = 0.0, 0.0, 128 * rows     # plain version chunked: [Q, N] is 34 GB
    for r0 in range(0, n, chunk):
        c = corpus[r0:r0 + chunk]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rb, rg = mips_kernel.block_maxima_grouped_reference(qb, c, block=block)
        end.record()
        end.synchronize()
        plain_ms += start.elapsed_time(end)
        g0, g1 = r0 // rows, (r0 + c.shape[0]) // rows
        err = max(err, (bmax3[g0:g1] - rb).abs().max().item(),
                  (gmax[g0:g1] - rg).abs().max().item())
    check(err <= BMAX_TOL, f"K1: max abs err {err} > {BMAX_TOL}")
    log(f"K1 N={n} Q={q} D={d} block={block} bf16: max_abs_err {err:.3g} (tol {BMAX_TOL}), "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (sum of {n // chunk} chunks)")
    del bmax3, gmax

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
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "qps": q / wall,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


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
    return launches, k1_err, batch


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
        ms = cuda_ms(lambda: drop.dropout(x, 0.1, seed=3), reps=20)
        plain = cuda_ms(lambda: drop.dropout_reference(x, 0.1, seed=3), reps=5)
        lib = cuda_ms(lambda: F.dropout(x, 0.1, training=True), reps=20)
        bms, by = bound(2 * n * x.element_size(), 0)
        log(f"K4 {tuple(shape)} {dtype}: bit-equal, keep rate {kept:.6f} "
            f"(5 sigma {5 * sigma:.2e}), "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, F.dropout {lib:.4f} ms, bound {bms:.4f} ms")
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
    at the train step's shapes, each timed beside SDPA with a float mask."""
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
            want = attention.fused_attention_backward_reference(q, k, v, mask, do, sm_scale=scale,
                                                                dropout_rate=r, seed=seed)
            torch.cuda.synchronize()
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
        fwd = {
            "ms": cuda_ms(lambda: attention.fused_attention(q, k, v, mask, sm_scale=scale,
                                                            dropout_rate=rate, seed=seed)),
            "plain_ms": cuda_ms(lambda: attention.fused_attention_reference(
                q, k, v, mask, sm_scale=scale, dropout_rate=rate, seed=seed), reps=3),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)),
        }
        qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias)
        bwd = {
            "ms": cuda_ms(lambda: attention._backward_kernel(q, k, v, mask, do, scale, rate, seed)),
            "ms_rate0": cuda_ms(lambda: attention._backward_kernel(q, k, v, mask, do, scale, 0.0,
                                                                   seed)),
            "plain_ms": cuda_ms(lambda: attention.fused_attention_backward_reference(
                q, k, v, mask, do, sm_scale=scale, dropout_rate=rate, seed=seed), reps=3),
            "library_ms": cuda_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                                              retain_graph=True)),
        }
        del lib_out, qs, ks, vs, bias
        n = b * h * t * dh * 2  # bytes of one [B, H, T, Dh] bf16 tensor
        fwd["bound_ms"], fwd["bound_by"] = bound(4 * n + mask.numel() * 4, 4 * b * h * t * t * dh)
        bwd["bound_ms"], bwd["bound_by"] = bound(7 * n + mask.numel() * 4, 10 * b * h * t * t * dh)
        log(f"K2 rate {rate} B={b} H={h} T={t} Dh={dh} bf16: max_abs_err {err2:.3g} (tol "
            f"{ATTN_TOL}), kernel {fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, SDPA at rate "
            f"0 {fwd['library_ms']:.4f} ms, bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']})")
        log(f"K3 B={b} H={h} T={t} Dh={dh} bf16: max_abs_err rate 0 {errs3[0.0]:.3g}, rate {rate} "
            f"{errs3[rate]:.3g} (tol {BWD_TOL}); against autograd of the plain forward "
            f"{errs_autograd[0.0]:.3g}, {errs_autograd[rate]:.3g} top-magnitude bf16 ulps "
            f"(tol {AUTOGRAD_ULPS}); kernel {bwd['ms']:.4f} ms (rate 0 {bwd['ms_rate0']:.4f}), "
            f"plain {bwd['plain_ms']:.4f} ms, SDPA backward at rate 0 "
            f"{bwd['library_ms']:.4f} ms, bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']})")
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
            retrieval, k1_cli_err, batch = timed("retrieval_cli", phase_cli, device, root)
        k2_encode = timed("attention_encode", phase_attention, device, batch)
        # the retriever-pretraining slice
        k4 = timed("dropout", phase_dropout, device)
        k2, k3 = timed("attention_train", phase_attention_train, device)
        timed("train_step", phase_train_step, device)
        with tempfile.TemporaryDirectory(prefix="proqa_smoke_") as root:
            pretrain = timed("pretrain_cli", phase_pretrain_cli, device, root)
        log(f"phase seconds: {json.dumps(phases)}")
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "proqa_tpu"))
        check(not loaded, f"the port imported {loaded[:5]}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    def entry(name, source, replaces, launches, result, max_abs_err):
        return {"name": name, "route": "cuda", "source": f"proqa_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err,
                **{key: result[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")}}

    # launches: both main paths' runs (retrieval CLI, then pretraining CLI)
    kernels = [
        entry("block_maxima_grouped (K1)", "block_maxima.cu", "proqa_tpu/ops/pallas_mips.py:83",
              retrieval["block_maxima"] + pretrain["K1"], k1,
              max(k1["max_abs_err"], k1_cli_err)),
        entry("fused_attention (K2)", "attention_fwd.cu", "proqa_tpu/ops/pallas_attention.py:65",
              retrieval["attention"] + pretrain["K2"], k2,
              max(k2["max_abs_err"], k2_encode["max_abs_err"])),
        entry("fused_attention backward (K3)", "attention_bwd.cu",
              "proqa_tpu/ops/pallas_attention.py:83", pretrain["K3"], k3, k3["max_abs_err"]),
        entry("dropout (K4)", "dropout.cu", "proqa_tpu/ops/pallas_dropout.py:32", pretrain["K4"],
              k4, k4["max_abs_err"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
