"""Twins of tests/test_offline_qa.py: the port's offline QA data path
(qa/offline_data.py: MRQA loading, openqa tokenization, grouped batching,
top-k retrieval files) gives the JAX package's outputs on the same inputs,
each with its own package's tokenizer."""
import json
import random

import numpy as np
import pytest

from proqa_tpu.qa import offline_data as jax_oqa
from proqa_tpu.text.wordpiece import BertTokenizer as JaxTokenizer
from proqa_tpu_torch.qa import offline_data as oqa
from proqa_tpu_torch.text.wordpiece import BertTokenizer

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + [f"tok{i}" for i in range(40)] + ["what", "is"]


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    p = tmp_path_factory.mktemp("oqa") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n")
    return BertTokenizer.from_vocab_file(str(p)), JaxTokenizer.from_vocab_file(str(p))


def _equal(a, b):
    """Nested dicts / lists / arrays equal, arrays by dtype, shape and value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_load_mrqa(tmp_path):
    path = tmp_path / "mrqa.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps({"header": True}) + "\n")
        f.write(json.dumps({
            "id": "d1", "context": "tok1 tok2 tok3",
            "qas": [{"qid": "q1", "question": "what is tok1", "answers": ["tok2"],
                     "detected_answers": [{"text": "tok2", "char_spans": [[5, 8]]}]}],
        }) + "\n")
    rows = oqa.load_mrqa_dataset(str(path))
    assert len(rows) == 1 and rows[0]["qid"] == "q1"
    _equal(rows, jax_oqa.load_mrqa_dataset(str(path)))


def test_load_topk_retrieval(tmp_path):
    path = tmp_path / "topk.jsonl"
    path.write_text("".join(json.dumps({"question": f"what is tok{i}", "para_embed_idx": [i, 7],
                                        "para_labels": [i % 2, 1]}) + "\n" for i in range(3)))
    got = oqa.load_topk_retrieval(str(path))
    assert len(got) == 3
    _equal(got, jax_oqa.load_topk_retrieval(str(path)))


def test_tokenize_qa_item(toks):
    sample = {
        "qid": "q1", "question": "what is tok1", "context": "tok1 tok2 tok3",
        "matched_answers": [{"text": "tok2", "char_spans": [[5, 8]]}],
        "true_answers": ["tok2"],
    }
    ex = oqa.tokenize_qa_item(sample, toks[0])
    assert ex["doc_subtoks"] == ["tok1", "tok2", "tok3"]
    assert ex["starts"] == [1] and ex["ends"] == [1]
    _equal(ex, jax_oqa.tokenize_qa_item(sample, toks[1]))


def test_tokenize_openqa_item(toks):
    sample = {
        "question": "what is tok1",
        "answer": ["tok5"],
        "retrieved": [
            {"para": "tok4 tok5 tok6", "matched_answer": "tok5"},
            {"para": "tok7 tok8", "matched_answer": ""},
        ],
    }
    exs = oqa.tokenize_openqa_item(sample, toks[0])
    assert len(exs) == 2
    assert exs[0]["no_answer"] == 0 and exs[0]["starts"] == [1]
    assert exs[1]["no_answer"] == 1 and exs[1]["starts"] == [-1]
    _equal(exs, jax_oqa.tokenize_openqa_item(sample, toks[1]))


def test_openqa_dataset_batches(toks, tmp_path):
    raw = tmp_path / "raw.jsonl"
    with open(raw, "w") as f:
        for qi in range(3):
            f.write(json.dumps({
                "question": f"what is tok{qi}",
                "answer": [f"tok{qi+10}"],
                "retrieved": [
                    {"para": f"tok{qi+10} tok1 tok2", "matched_answer": f"tok{qi+10}"},
                    {"para": "tok20 tok21", "matched_answer": ""},
                    {"para": "tok22 tok23", "matched_answer": ""},
                ],
            }) + "\n")
    n = oqa.tokenize_openqa_file(str(raw), toks[0], str(tmp_path / "tokenized.jsonl"))
    jn = jax_oqa.tokenize_openqa_file(str(raw), toks[1], str(tmp_path / "jax_tokenized.jsonl"))
    assert n == jn == 9
    assert (tmp_path / "tokenized.jsonl").read_text() == \
        (tmp_path / "jax_tokenized.jsonl").read_text()

    kw = dict(max_query_length=8, max_length=24, max_spans=4)
    ds = oqa.OpenQADataset(toks[0], str(tmp_path / "tokenized.jsonl"), **kw)
    jds = jax_oqa.OpenQADataset(toks[1], str(tmp_path / "tokenized.jsonl"), **kw)
    batches = list(ds.train_batches(3, random.Random(0)))
    assert len(batches) == 3
    b = batches[0]["net_input"]
    assert b["input_ids"].shape == (1, 3, 24) and b["start_positions"].shape == (1, 3, 4)
    assert b["para_targets"].sum() >= 1  # the positive is in every batch
    _equal(batches, list(jds.train_batches(3, random.Random(0))))
    evals = list(ds.eval_batches(2))
    assert len(evals) == 3 and evals[0]["net_input"]["input_ids"].shape == (1, 2, 24)
    assert "start_positions" not in evals[0]["net_input"]
    _equal(evals, list(jds.eval_batches(2)))
