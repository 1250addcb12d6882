"""Retrieval quality: answer recall@k over the dense index.

Counterpart of proqa_tpu/index/recall.py (the reference's
eval_retrieval.py:78-123): exact MIPS top-k for every question, then uncased
token-subsequence answer matching in the retrieved paragraphs' text.
"""
from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from proqa_tpu_torch.data.docdb import DocDB
from proqa_tpu_torch.index.dense import DenseIndex
from proqa_tpu_torch.text.matching import para_has_answer
from proqa_tpu_torch.text.simple import SimpleTokenizer


def load_qa_pairs(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def recall_at_k(qa_pairs: list[dict], retrieved_ids: list[list[str]], db: DocDB,
                ks=(5, 10, 20, 50, 80), num_workers: int = 0) -> dict[int, float]:
    """qa_pairs: [{"question", "answer": [...]}...]; retrieved_ids: top-k doc
    ids per question (k >= max(ks))."""
    tok = SimpleTokenizer()
    kmax = max(ks)

    def covered_flags(args):
        qa, doc_ids = args
        flags = []
        for did in doc_ids[:kmax]:
            text = db.get_doc_text(did)
            flags.append(bool(text) and para_has_answer(text, qa["answer"], tok)[0])
        return flags

    pairs = list(zip(qa_pairs, retrieved_ids))
    if num_workers > 0:
        with ThreadPoolExecutor(num_workers) as pool:
            all_flags = list(pool.map(covered_flags, pairs))
    else:
        all_flags = [covered_flags(p) for p in pairs]
    return {k: float(np.mean([any(f[:k]) for f in all_flags])) for k in ks}


def evaluate_retrieval(qa_path: str, index: DenseIndex, query_embeds: np.ndarray, db: DocDB,
                       *, topk: int = 80, ks=(5, 10, 20, 50, 80),
                       num_workers: int = 0) -> dict[int, float]:
    """Search + recall scoring. query_embeds: [Q, D], row-aligned with
    qa_path. Recall at the full depth `topk` is always reported."""
    qa_pairs = load_qa_pairs(qa_path)
    if len(qa_pairs) != query_embeds.shape[0]:
        raise ValueError(f"{len(qa_pairs)} QA pairs in {qa_path} but "
                         f"{query_embeds.shape[0]} query embeddings: rows must align")
    ks = tuple(k for k in ks if k < topk) + (topk,)
    _, _, ids = index.search_ids(query_embeds, topk)
    return recall_at_k(qa_pairs, ids, db, ks=ks, num_workers=num_workers)
