"""Port parity: the copied host code of text/squad.py and qa/prepro.py gives
the JAX package's outputs on a fixed set of strings, and match-paras'
process_ground_paras writes a byte-equal file."""
import json

import pytest

pytest.importorskip("torch")

from proqa_tpu.data.docdb import DocDB as JaxDocDB  # noqa: E402
from proqa_tpu.qa import prepro as jax_prepro  # noqa: E402
from proqa_tpu.text import squad as jax_squad  # noqa: E402
from proqa_tpu.text.simple import SimpleTokenizer as JaxSimple  # noqa: E402
from proqa_tpu.text.wordpiece import BertTokenizer as JaxBertTokenizer  # noqa: E402
from proqa_tpu_torch.data.docdb import DocDB  # noqa: E402
from proqa_tpu_torch.qa import prepro  # noqa: E402
from proqa_tpu_torch.text import squad  # noqa: E402
from proqa_tpu_torch.text.simple import SimpleTokenizer  # noqa: E402
from proqa_tpu_torch.text.wordpiece import BertTokenizer  # noqa: E402

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat", "sat", "on", "mat", ",",
         ".", "!", "'", "(", ")", "-", "##s", "un", "##able", "##ed", "hello", "world", "john",
         "smith", "paris", "is", "in", "france", "1", "##9", "##8", "##4", "$", "caf", "##e",
         "new", "york", "city", "big", "apple", "jo", "##hn", "st", "##rong"]

TEXTS = [
    "The cat sat on the mat.",
    "  Hello,   world!  John Smith's cat is unable  ",
    "Paris is in France (1984) -- the café, New York City's Big Apple.",
    "Johnstrong sat on $1984 mats\tin\nParis.",
    "",
    "Ünable café CAFÉ",
]
ANSWERS = ["the mat", "John Smith", "1984", "New York City", "Paris", "cat", "café", "France"]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("squad") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    return str(path)


@pytest.fixture(scope="module", params=["uncased", "cased", "python"])
def tokenizers(request, vocab_file):
    """(JAX, port) tokenizer pairs: uncased and cased with their native
    path, and the pure-Python path."""
    lower = request.param != "cased"
    jtok = JaxBertTokenizer.from_vocab_file(vocab_file, do_lower_case=lower)
    ttok = BertTokenizer.from_vocab_file(vocab_file, do_lower_case=lower)
    if request.param == "python":
        jtok._native = ttok._native = None
    return jtok, ttok


def test_prepare_and_answer_spans_match_jax(tokenizers):
    jtok, ttok = tokenizers
    for text in TEXTS:
        want = jax_squad.prepare_context(text, jtok)
        got = squad.prepare_context(text, ttok)
        assert got == want, text
        doc_tokens, c2w, o2t, _t2o, pieces = got
        for answer in ANSWERS:
            spans = squad.char_spans_of(text, answer)
            assert spans == jax_squad.char_spans_of(text, answer)
            if not doc_tokens:
                continue
            assert squad.find_answer_spans(answer, spans, c2w, doc_tokens, pieces, o2t, ttok) == \
                jax_squad.find_answer_spans(answer, spans, c2w, doc_tokens, pieces, o2t, jtok)
            assert squad.improve_answer_span(pieces, 0, len(pieces) - 1, ttok, answer) == \
                jax_squad.improve_answer_span(pieces, 0, len(pieces) - 1, jtok, answer)


def test_char_spans_of_overlapping_and_empty():
    for text, needle in (("aaaa", "aa"), ("abcabc", "c"), ("abc", ""), ("", "x")):
        assert squad.char_spans_of(text, needle) == jax_squad.char_spans_of(text, needle)


@pytest.mark.parametrize("do_lower_case", [True, False])
def test_get_final_text_matches_jax(do_lower_case):
    cases = [
        ("john smith", "John Smith's"),
        ("john smith ' s", "John Smith's"),
        ("paris", "(Paris)."),
        ("1984", "$1984,"),
        ("new york city", "New York City's"),
        ("cafe", "Café"),
        ("not there", "Something else."),
        ("steve", "Steve-o!"),
        ("hello , world", "Hello,world"),
        ("John Smith", "John Smith's"),     # the cased projections
        ("Paris", "(Paris)."),
        ("Caf", "Café"),
    ]
    for pred, orig in cases:
        assert squad.get_final_text(pred, orig, do_lower_case=do_lower_case) == \
            jax_squad.get_final_text(pred, orig, do_lower_case=do_lower_case), (pred, orig)


def test_wordpieces_to_text_matches_jax():
    for pieces in (["jo", "##hn", "smith"], ["##s"], [], ["un", "##able", ",", "the"],
                   ["19", "##8", "##4", "##"], ["  a ", "b"]):
        assert squad.wordpieces_to_text(pieces) == jax_squad.wordpieces_to_text(pieces)


def _world(root):
    paras = [("p0", "John Smith lives in Paris, France."),
             ("p1", "The cat sat on the mat in 1984."),
             ("p2", "New York City is the Big Apple."),
             ("p3", "Nothing to see here."),
             ("p4", "Paris Hilton is not in France.")]
    qa = [{"question": "Where does John Smith live?", "answer": ["Paris"]},
          {"question": "When did the cat sit?", "answer": ["1984", "nineteen"]},
          {"question": "What is the Big Apple?", "answer": ["New York City"]},
          {"question": "Who is nowhere?", "answer": ["Nobody"]},
          {"question": "Regex question", "answer": ["Par(is|ma)"]}]
    retrieved = [{"para_id": ["p0", "p4", "p3"]}, {"para_id": ["p1", "p9"]},
                 {"para_id": ["p2", "p0"]}, {"para_id": ["p3"]},
                 {"para_id": ["p4", "p0", "p2"]}]
    for name, rows in (("raw.jsonl", qa), ("retrieved.jsonl", retrieved)):
        with open(root / name, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return paras, qa


def test_prepro_matches_jax(tmp_path):
    paras, qa = _world(tmp_path)
    JaxDocDB.create(str(tmp_path / "jax.db"), paras)
    DocDB.create(str(tmp_path / "torch.db"), paras)
    for item in qa:
        assert prepro.hash_question(item["question"]) == jax_prepro.hash_question(item["question"])
    jdb, tdb = JaxDocDB(str(tmp_path / "jax.db")), DocDB(str(tmp_path / "torch.db"))
    for match in ("string", "regex"):
        for item in qa:
            ids = ["p0", "p1", "p2", "p3", "p4", "missing"]
            assert prepro.match_question_paras(item, ids, tdb, SimpleTokenizer(), match) == \
                jax_prepro.match_question_paras(item, ids, jdb, JaxSimple(), match)
    for match, k, workers in (("string", 10000, 0), ("regex", 2, 2)):
        outs = []
        for name, fn in (("jax", jax_prepro.process_ground_paras),
                         ("torch", prepro.process_ground_paras)):
            out = tmp_path / f"{name}_{match}.jsonl"
            cov = fn(str(tmp_path / "retrieved.jsonl"), str(tmp_path / "raw.jsonl"), str(out),
                     str(tmp_path / f"{name}.db"), k=k, match=match, num_workers=workers)
            outs.append((cov, out.read_bytes()))
        assert outs[0] == outs[1]
        assert 0.0 < outs[1][0] < 1.0
