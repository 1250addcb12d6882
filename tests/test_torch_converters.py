"""Twins of tests/test_converters.py: the port's dataset converters
(data/converters.py) write the same files, and return the same counts and
recall, as the JAX package's on the same inputs; the CLI's convert-trec and
convert-msmarco print the JAX CLI's JSON lines."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from proqa_tpu.cli.main import main as jax_main  # noqa: E402
from proqa_tpu.data import converters as jax_conv  # noqa: E402
from proqa_tpu.index import DenseIndex as JaxDenseIndex  # noqa: E402
from proqa_tpu.index import IdMap as JaxIdMap  # noqa: E402
from proqa_tpu_torch.cli.main import main as torch_main  # noqa: E402
from proqa_tpu_torch.data import converters  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.index.idmap import IdMap  # noqa: E402


def _both(tmp_path, name, fn, *args):
    """fn of each package on the same inputs, writing <pkg>_<name>: the
    returns, and the written files' text."""
    out = {}
    for pkg, mod in (("jax", jax_conv), ("torch", converters)):
        path = str(tmp_path / f"{pkg}_{name}")
        out[pkg] = (getattr(mod, fn)(*args, path), open(path).read())
    return out["torch"], out["jax"]


def test_trec_prepare_corpus(tmp_path):
    (tmp_path / "collection.tsv").write_text("0\tfirst passage\n1\tsecond\tstill second\n\n")
    got, want = _both(tmp_path, "corpus.jsonl", "trec_prepare_corpus",
                      str(tmp_path / "collection.tsv"))
    assert got == want and got[0] == 2
    rows = [json.loads(line) for line in got[1].splitlines()]
    assert rows[0] == {"text": "first passage", "id": 0}
    assert rows[1]["text"] == "second\tstill second"  # only the first tab splits


def test_trec_extract_labels(tmp_path):
    (tmp_path / "queries.tsv").write_text("7\twhat is x?\n9\tname y\n")
    (tmp_path / "qrels.tsv").write_text("7\t0\t101\t1\n7\t0\t102\t1\n9\t0\t103\t1\n")
    got, want = _both(tmp_path, "labels.jsonl", "trec_extract_labels",
                      str(tmp_path / "qrels.tsv"), str(tmp_path / "queries.tsv"))
    assert got == want and got[0] == 2
    rows = {r["qid"]: r for r in map(json.loads, got[1].splitlines())}
    assert rows[7]["question"] == "what is x" and rows[7]["labels"] == [101, 102]


def test_trec_extract_labels_skips_unknown_qids(tmp_path, capsys):
    (tmp_path / "queries.tsv").write_text("7\twhat is x?\n")
    (tmp_path / "qrels.tsv").write_text("7\t0\t101\t1\n42\t0\t999\t1\n")
    got, want = _both(tmp_path, "labels.jsonl", "trec_extract_labels",
                      str(tmp_path / "qrels.tsv"), str(tmp_path / "queries.tsv"))
    assert got == want and got[0] == 1
    assert capsys.readouterr().out.count("skipped 1 judged qids") == 2


def test_retrieve_topk_labels(tmp_path):
    """Top-k rows and gold labels of retrieve-yourself queries over each
    package's f32 index of the same rows: the same file and recall."""
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((64, 8)).astype(np.float32)
    ids = [str(100 + i) for i in range(64)]
    index = DenseIndex.from_embeddings(emb, IdMap.from_doc_ids(ids), device="cpu",
                                       dtype=torch.float32, pad_multiple=8)
    jindex = JaxDenseIndex.from_embeddings(emb, JaxIdMap.from_doc_ids(ids), dtype=jnp.float32,
                                           pad_multiple=8)
    queries = emb[:4] * 3
    qin = tmp_path / "queries.jsonl"
    qin.write_text("".join(json.dumps({"question": f"q{i}", "labels": [100 + i], "qid": i}) + "\n"
                           for i in range(4)))
    recall = converters.retrieve_topk_labels(index, queries, str(qin),
                                             str(tmp_path / "torch_topk.jsonl"), topk=8)
    jrecall = jax_conv.retrieve_topk_labels(jindex, queries, str(qin),
                                            str(tmp_path / "jax_topk.jsonl"), topk=8)
    assert recall == jrecall == 1.0
    assert (tmp_path / "torch_topk.jsonl").read_text() == (tmp_path / "jax_topk.jsonl").read_text()
    for r in map(json.loads, (tmp_path / "torch_topk.jsonl").read_text().splitlines()):
        assert len(r["para_embed_idx"]) == 8
        for idx, lab in zip(r["para_embed_idx"], r["para_labels"]):
            assert not lab or 100 + idx in r["labels"]


def _marco(tmp_path):
    data = {
        "answers": {"0": ["an answer"], "1": ["No Answer Present."], "2": ["x"]},
        "query": {"0": "q zero", "1": "q one", "2": "q two"},
        "passages": {
            "0": [{"is_selected": 1, "passage_text": "p a"},
                  {"is_selected": 0, "passage_text": "p b"}],
            "1": [{"is_selected": 1, "passage_text": "p c"}],
            "2": [{"is_selected": 0, "passage_text": "p d"}],
        },
    }
    src = tmp_path / "marco.json"
    src.write_text(json.dumps(data))
    return str(src)


def test_msmarco_extract_qa(tmp_path):
    got, want = _both(tmp_path, "qa.jsonl", "msmarco_extract_qa", _marco(tmp_path))
    assert got == want and got[0] == 1  # unanswerable and no-selected rows dropped
    assert json.loads(got[1]) == {"q": "q zero", "answer": ["an answer"], "para": "p a"}


def test_cli_convert_trec_and_msmarco_match_jax(tmp_path, capsys):
    """convert-trec (corpus and labels in one call) and convert-msmarco:
    the same JSON lines and files from both CLIs."""
    (tmp_path / "collection.tsv").write_text("3\tsome text\n4\tmore text\n")
    (tmp_path / "queries.tsv").write_text("7\twhat is x?\n")
    (tmp_path / "qrels.tsv").write_text("7\t0\t3\t1\n")
    src = _marco(tmp_path)
    outs = {}
    for pkg, main in (("jax", jax_main), ("torch", torch_main)):
        main(["convert-trec", "--collection", str(tmp_path / "collection.tsv"),
              "--corpus-out", str(tmp_path / f"{pkg}_c.jsonl"),
              "--qrels", str(tmp_path / "qrels.tsv"), "--queries", str(tmp_path / "queries.tsv"),
              "--labels-out", str(tmp_path / f"{pkg}_l.jsonl")])
        main(["convert-msmarco", "--input", src, "--output", str(tmp_path / f"{pkg}_m.jsonl")])
        outs[pkg] = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert outs["torch"] == outs["jax"] == [{"corpus_rows": 2}, {"labeled_queries": 1},
                                            {"qa_pairs": 1}]
    for name in ("c", "l", "m"):
        assert (tmp_path / f"torch_{name}.jsonl").read_text() == \
            (tmp_path / f"jax_{name}.jsonl").read_text()
