#!/usr/bin/env python3
"""Smoke test of the PyTorch port (proqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases, each of which must pass:
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

Prints the GPU's name and power limit first, a JSON line of per-kernel
results second to last, and {"ok": true, "device": ...} last. Exits non-zero,
printing no result, when there is no GPU or any phase fails.
"""
from __future__ import annotations

import contextlib
import io
import json
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
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "qps": q / wall}


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
        phase_encoder(device)
        k1 = phase_mips(device)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="proqa_smoke_") as root:
            launches, k1_cli_err, batch = phase_cli(device, root)
        torch.cuda.empty_cache()
        k2 = phase_attention(device, batch)
        check("jax" not in sys.modules, "the port imported jax")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    kernels = [
        {"name": "block_maxima_grouped (K1)", "route": "cuda",
         "source": "proqa_tpu_torch/csrc/block_maxima.cu",
         "replaces": "proqa_tpu/ops/pallas_mips.py:83", "launches": launches["block_maxima"],
         "max_abs_err": max(k1["max_abs_err"], k1_cli_err),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "fused_attention (K2)", "route": "cuda",
         "source": "proqa_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "proqa_tpu/ops/pallas_attention.py:65", "launches": launches["attention"],
         "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
