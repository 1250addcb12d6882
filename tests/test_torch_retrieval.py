"""The dense-retrieval slice end to end: the `proqa` (JAX) and `proqa-torch`
CLIs run build-index, encode-queries, eval-retrieval and retrieve on one
synthetic world from one checkpoint, in --f32, and must agree.

The world has 4,500 paragraphs, so the padded index (5,120 rows) is past the
4,096-row naive-search cut: the port searches through the block-max pipeline
of kernel K1 (its plain version on the CPU). `--tiny` caps positions at 64
(BertConfig.tiny), so the CLIs run at --max-seq-length 64 and the fused
attention path is covered at T=128 by test_torch_bert.py instead.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from proqa_tpu.cli.main import main as jax_main  # noqa: E402
from proqa_tpu.index.dense import DenseIndex as JaxDenseIndex  # noqa: E402
from proqa_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from proqa_tpu.models.retriever import init_retriever_params  # noqa: E402
from proqa_tpu.train.checkpoint import save_checkpoint  # noqa: E402
from proqa_tpu_torch.cli.main import main as torch_main  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.models.convert import save_npz  # noqa: E402
from proqa_tpu_torch.ops import mips_kernel  # noqa: E402
from proqa_tpu_torch.testing import topk_disagreements  # noqa: E402

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(60)] + [
    "what", "is", "about",
]
N_PARAS, N_QUESTIONS = 4500, 40


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_world")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    rng = np.random.default_rng(0)
    with open(root / "corpus.jsonl", "w") as f:
        for i in range(N_PARAS):
            toks = rng.integers(0, 60, size=rng.integers(8, 60))
            f.write(json.dumps({"text": " ".join(f"tok{t}" for t in toks), "id": f"p{i}"}) + "\n")
    with open(root / "qa.jsonl", "w") as f:
        for i in range(N_QUESTIONS):
            f.write(json.dumps({"question": f"what is about tok{i} tok{(7 * i) % 60}",
                                "answer": [f"tok{(i + 5) % 60} tok{(i + 9) % 60}"]}) + "\n")
    # a seeded JAX checkpoint as flax msgpack, and converted to the port's .npz
    params = init_retriever_params(jax.random.PRNGKey(1), JaxBertConfig.tiny())
    save_checkpoint(str(root / "ckpt.msgpack"), params)
    with open(root / "ckpt.msgpack", "rb") as f:
        state = serialization.msgpack_restore(f.read())
    save_npz(str(root / "ckpt.npz"), jax.tree.map(np.asarray, state))
    return root


def _run(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _common(world, ckpt):
    return ["--vocab", str(world / "vocab.txt"), "--tiny", "--f32", "--max-seq-length", "64",
            "--max-query-length", "12", "--init-checkpoint", str(world / ckpt)]


def test_cli_slice_matches_jax(world, capsys):
    w = str(world)
    out = _run(torch_main, ["build-db", "--corpus", f"{w}/corpus.jsonl", "--db",
                            f"{w}/docs.db"], capsys)
    assert out == {"documents": N_PARAS, "db": f"{w}/docs.db"}
    runs = {}
    for name, main, ckpt, extra in (("jax", jax_main, "ckpt.msgpack", []),
                                    ("torch", torch_main, "ckpt.npz", ["--device", "cpu"])):
        r = runs[name] = {}
        r["build"] = _run(main, ["build-index", *_common(world, ckpt), *extra, "--corpus",
                                 f"{w}/corpus.jsonl", "--output-dir", f"{w}/{name}_idx"], capsys)
        r["encode"] = _run(main, ["encode-queries", *_common(world, ckpt), *extra, "--queries",
                                  f"{w}/qa.jsonl", "--output", f"{w}/{name}_q.npy"], capsys)
        r["eval"] = _run(main, ["eval-retrieval", f"{w}/qa.jsonl", f"{w}/{name}_idx",
                                f"{w}/{name}_q.npy", f"{w}/docs.db", "--topk", "80", "--f32",
                                *extra], capsys)
        r["retrieve"] = _run(main, ["retrieve", *_common(world, ckpt), *extra, "--question",
                                    "what is about tok3 tok21", "--index", f"{w}/{name}_idx",
                                    "--db", f"{w}/docs.db", "--topk", "10"], capsys)

    jax_run, torch_run = runs["jax"], runs["torch"]
    assert torch_run["build"] == {**jax_run["build"], "saved": f"{w}/torch_idx"}
    assert torch_run["encode"]["queries"] == jax_run["encode"]["queries"] == N_QUESTIONS
    assert torch_run["eval"] == jax_run["eval"]
    assert set(torch_run["eval"]) == {f"recall@{k}" for k in (5, 10, 20, 50, 80)}

    # the artifacts agree: embeddings, id maps, query embeddings
    emb_j = np.load(f"{w}/jax_idx/embeddings.npy")
    emb_t = np.load(f"{w}/torch_idx/embeddings.npy")
    assert emb_t.shape == emb_j.shape == (N_PARAS, 128) and emb_t.dtype == np.float32
    np.testing.assert_allclose(emb_t, emb_j, atol=1e-4, rtol=0)
    assert (world / "torch_idx" / "idx_id.json").read_bytes() == \
        (world / "jax_idx" / "idx_id.json").read_bytes()
    q_j, q_t = np.load(f"{w}/jax_q.npy"), np.load(f"{w}/torch_q.npy")
    np.testing.assert_allclose(q_t, q_j, atol=1e-4, rtol=0)

    # top-k ids agree up to equal-score ties: the one-shot retrieve ...
    rj, rt = jax_run["retrieve"]["topk"], torch_run["retrieve"]["topk"]
    assert topk_disagreements(
        np.array([[r["score"] for r in rt]]), np.array([[r["row"] for r in rt]]),
        np.array([[r["score"] for r in rj]]), np.array([[r["row"] for r in rj]]),
        atol=2e-4) == 0
    assert all(r["text"] for r in rt)
    # ... and every eval question's top 80, each package searching its own index
    jv, ji = JaxDenseIndex.load(f"{w}/jax_idx", dtype=jnp.float32).search(q_j, 80)
    tv, ti = DenseIndex.load(f"{w}/torch_idx", device="cpu", dtype=torch.float32).search(q_t, 80)
    assert topk_disagreements(tv, ti, jv, ji, atol=2e-4) == 0


def test_cli_rejects_unported_flags(world, capsys, monkeypatch):
    """--dp-encode (ROADMAP Queue 1, item 15, once refused here as unported)
    runs on both encoding commands: over a mesh of 3 CPU entries the batch
    size rounds up to a multiple of 3 with the JAX CLI's note, and the
    embeddings equal the one-device encode's (f32) in dataset order."""
    from proqa_tpu_torch.cli import main as cli

    monkeypatch.setattr(cli, "_local_mesh", lambda args: [torch.device("cpu")] * 3)
    common = [*_common(world, "ckpt.npz"), "--device", "cpu", "--predict-batch-size", "8"]
    w = str(world)
    for dp in ([], ["--dp-encode"]):
        tag = "dp" if dp else "one"
        torch_main(["build-index", *common, *dp, "--corpus", f"{w}/corpus.jsonl",
                    "--output-dir", f"{w}/{tag}_idx"])
        torch_main(["encode-queries", *common, *dp, "--queries", f"{w}/qa.jsonl",
                    "--output", f"{w}/{tag}_q.npy"])
        out = capsys.readouterr().out
        assert out.count("predict-batch-size 8 -> 9 (multiple of 3 devices)") == (2 if dp else 0)
    np.testing.assert_allclose(np.load(f"{w}/dp_idx/embeddings.npy"),
                               np.load(f"{w}/one_idx/embeddings.npy"), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.load(f"{w}/dp_q.npy"), np.load(f"{w}/one_q.npy"),
                               rtol=0, atol=1e-5)
    assert (world / "dp_idx" / "idx_id.json").read_bytes() == \
        (world / "one_idx" / "idx_id.json").read_bytes()


def test_cli_int8_index_matches_jax(world, capsys, monkeypatch):
    """eval-retrieval and retrieve with --int8-index: both CLIs quantize one
    f32 index (built by the JAX CLI) at load and give the same recall JSON
    and the same top-k; the port searches through K5's pipeline (its plain
    version here) and scores in bf16 although --f32 is given."""
    w = str(world)
    _run(torch_main, ["build-db", "--corpus", f"{w}/corpus.jsonl", "--db", f"{w}/int8.db"],
         capsys)
    _run(jax_main, ["build-index", *_common(world, "ckpt.msgpack"), "--corpus",
                    f"{w}/corpus.jsonl", "--output-dir", f"{w}/int8_idx"], capsys)
    _run(jax_main, ["encode-queries", *_common(world, "ckpt.msgpack"), "--queries",
                    f"{w}/qa.jsonl", "--output", f"{w}/int8_q.npy"], capsys)
    k5_calls = []
    real = mips_kernel.mips_topk_v2

    def spy(queries, corpus, k, **kw):
        k5_calls.append((corpus.dtype, kw["block"], kw.get("scales") is not None,
                         queries.dtype))
        return real(queries, corpus, k, **kw)

    monkeypatch.setattr(mips_kernel, "mips_topk_v2", spy)
    evals, hits = {}, {}
    for name, main, ckpt, extra in (("jax", jax_main, "ckpt.msgpack", []),
                                    ("torch", torch_main, "ckpt.npz", ["--device", "cpu"])):
        evals[name] = _run(main, ["eval-retrieval", f"{w}/qa.jsonl", f"{w}/int8_idx",
                                  f"{w}/int8_q.npy", f"{w}/int8.db", "--topk", "80", "--f32",
                                  "--int8-index", *extra], capsys)
        hits[name] = _run(main, ["retrieve", *_common(world, ckpt), *extra, "--question",
                                 "what is about tok3 tok21", "--index", f"{w}/int8_idx",
                                 "--db", f"{w}/int8.db", "--topk", "10", "--int8-index"],
                          capsys)["topk"]
    assert evals["torch"] == evals["jax"]
    assert set(evals["torch"]) == {f"recall@{k}" for k in (5, 10, 20, 50, 80)}
    assert k5_calls == [(torch.int8, 16, True, torch.bfloat16)] * 2  # eval, then retrieve
    assert topk_disagreements(
        np.array([[r["score"] for r in hits["torch"]]]), np.array([[r["row"] for r in hits["torch"]]]),
        np.array([[r["score"] for r in hits["jax"]]]), np.array([[r["row"] for r in hits["jax"]]]),
        atol=2e-4) == 0
    assert all(r["text"] for r in hits["torch"])
    # --shard-index (once refused here as unported) over a mesh of 4 CPU
    # entries: an int8 index quantized per shard, the same recall JSON
    from proqa_tpu_torch.cli import main as cli

    monkeypatch.setattr(cli, "_local_mesh", lambda args: [torch.device("cpu")] * 4)
    sharded = _run(torch_main, ["eval-retrieval", f"{w}/qa.jsonl", f"{w}/int8_idx",
                                f"{w}/int8_q.npy", f"{w}/int8.db", "--topk", "80", "--int8-index",
                                "--shard-index", "--device", "cpu"], capsys)
    assert sharded == evals["jax"]
