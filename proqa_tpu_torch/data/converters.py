"""Dataset converters: TREC-2019 / MS MARCO corpora and qrels into the
jsonl formats of this package, plus top-k retrieval label files.

Copy of proqa_tpu/data/converters.py (upstream retrieval/trec_process.py:8-94
and qa/msmarco_process.py:4-20): host-side text plumbing, so the port keeps
its own copy. The top-k labeling step searches the port's DenseIndex.
"""
from __future__ import annotations

import json
from collections import defaultdict

import numpy as np


def trec_prepare_corpus(collection_tsv: str, save_path: str) -> int:
    """`pid \\t text` collection -> {"text", "id"} jsonl corpus."""
    n = 0
    with open(collection_tsv) as f, open(save_path, "w") as g:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            pid, text = line.split("\t", 1)
            g.write(json.dumps({"text": text, "id": int(pid)}) + "\n")
            n += 1
    return n


def trec_extract_labels(qrels_tsv: str, queries_tsv: str, output: str) -> int:
    """qrels + queries -> {"question", "labels", "qid"} jsonl (gold passage
    ids per query; trailing '?' stripped like the reference)."""
    qid2query = {}
    with open(queries_tsv) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            q = parts[1]
            if q.endswith("?"):
                q = q[:-1]
            qid2query[int(parts[0])] = q

    qid2ground = defaultdict(list)
    with open(qrels_tsv) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            qid2ground[int(parts[0])].append(int(parts[2]))

    n = skipped = 0
    with open(output, "w") as g:
        for qid, labels in qid2ground.items():
            if qid not in qid2query:
                # qrels routinely judge qids outside a subset/split query
                # file — skip them instead of aborting mid-write
                skipped += 1
                continue
            g.write(json.dumps({
                "question": qid2query[qid], "labels": labels, "qid": qid,
            }) + "\n")
            n += 1
    if skipped:
        print(f"trec_extract_labels: skipped {skipped} judged qids absent "
              f"from the queries file")
    return n


def retrieve_topk_labels(
    index, query_embeds: np.ndarray, query_input: str, output: str, topk: int = 10000
) -> float:
    """Attach top-k retrieved row indices + binary gold labels to each query
    (consumed by downstream matched-para prepro); returns label recall."""
    with open(query_input) as f:
        raw = [json.loads(l) for l in f if l.strip()]
    assert len(raw) == query_embeds.shape[0]
    _, rows = index.search(query_embeds, topk, exact=topk <= 512)
    covered = []
    with open(output, "w") as g:
        for sample, rr in zip(raw, rows):
            gold = set(sample["labels"])
            idxs = [int(r) for r in rr]
            labels = [
                int(int(index.id_map[r]) in gold if index.id_map is not None
                    else r in gold)
                for r in idxs
            ]
            sample["para_embed_idx"] = idxs
            sample["para_labels"] = labels
            if index.id_map is not None:
                sample["para_id"] = [index.id_map[r] for r in idxs]
            covered.append(int(sum(labels) > 0))
            g.write(json.dumps(sample) + "\n")
    return float(np.mean(covered)) if covered else 0.0


def msmarco_extract_qa(path: str, output: str) -> int:
    """MS MARCO QA v2.1 json -> {"q", "answer", "para"} jsonl of answerable
    questions with their selected passages."""
    with open(path) as f:
        data = json.load(f)
    n = 0
    with open(output, "w") as g:
        for id_, answers in data["answers"].items():
            if answers[0] == "No Answer Present.":
                continue
            selected = [
                p["passage_text"] for p in data["passages"][id_] if p["is_selected"]
            ]
            if not selected:
                continue
            g.write(json.dumps({
                "q": data["query"][id_], "answer": answers, "para": " ".join(selected),
            }) + "\n")
            n += 1
    return n
