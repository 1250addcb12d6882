"""Offline QA preprocessing: weak-supervision gold-paragraph matching.

Copy of proqa_tpu/qa/prepro.py: the port keeps its own host code and imports
nothing of the JAX package.

Equivalent of upstream qa/prepro_dense.py:76-158
(process_ground_paras): for every training question, string/regex-match its
answers inside its pre-retrieved top-k paragraphs and record the matched
paragraph ids + surface strings. The output jsonl feeds OnlineSampler as the
qid -> matched_paras gold set (reference online_sampler.py:89-94).

The reference parallelizes with a 40-process fork pool; here a thread pool is
used (sqlite + regex release the GIL poorly, but the box may be single-core —
workers configurable, 0 = inline).
"""
from __future__ import annotations

import hashlib
import json
from concurrent.futures import ThreadPoolExecutor

from proqa_tpu_torch.data.docdb import DocDB
from proqa_tpu_torch.text.matching import normalize, para_has_answer, regex_match
from proqa_tpu_torch.text.simple import SimpleTokenizer


def hash_question(q: str) -> str:
    """Stable question id (md5 — reference qa/prepro_utils.py:12-14)."""
    return hashlib.md5(q.encode()).hexdigest()


def match_question_paras(
    qa: dict, para_ids, db: DocDB, tokenizer: SimpleTokenizer, match: str = "string"
) -> dict:
    """Returns qa with `matched_paras`: {para_id: matched surface string(s)}."""
    matched_paras = {}
    for pid in para_ids:
        text = db.get_doc_text(pid)
        if text is None:
            continue
        p = normalize(text)
        if match == "regex":
            # empty-string matches (nullable patterns) dropped: matched_paras
            # is TRAIN supervision — '' would mark every paragraph gold
            found = [m for m in regex_match(p, normalize(qa["answer"][0])) if m]
            if found:
                matched_paras[pid] = found
        else:
            covered, surface = para_has_answer(p, qa["answer"], tokenizer)
            if covered:
                matched_paras[pid] = surface
    out = dict(qa)
    out["matched_paras"] = matched_paras
    return out


def process_ground_paras(
    retrieved_path: str,
    raw_data_path: str,
    save_path: str,
    db_path: str,
    *,
    k: int = 10000,
    match: str = "string",
    num_workers: int = 0,
) -> float:
    """retrieved_path: jsonl with per-question {"para_id": [...]} (top-k
    retrieval results); raw_data_path: jsonl {"question", "answer"}. Writes
    annotated jsonl; returns the top-k gold coverage rate."""
    with open(retrieved_path) as f:
        retrieved = [json.loads(l) for l in f if l.strip()]
    with open(raw_data_path) as f:
        raw = [json.loads(l) for l in f if l.strip()]
    assert len(retrieved) == len(raw)

    db = DocDB(db_path)
    tok = SimpleTokenizer()

    def work(pair):
        qa, res = pair
        return match_question_paras(qa, res["para_id"][:k], db, tok, match)

    pairs = list(zip(raw, retrieved))
    if num_workers > 0:
        with ThreadPoolExecutor(num_workers) as pool:
            results = list(pool.map(work, pairs))
    else:
        results = [work(p) for p in pairs]

    covered = sum(1 for r in results if r["matched_paras"]) / max(len(results), 1)
    with open(save_path, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    db.close()
    return covered
