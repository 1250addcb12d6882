"""Offline-retrieval QA datasets: pre-tokenized paragraphs with span targets.

Copy of proqa_tpu/qa/offline_data.py, on the port's own text and data
modules (upstream qa/datasets.py:31-296, OpenQADataset / OpenQASampler /
BatchSampler / openqa_collate, and qa/prepro_utils.py:101-263,
tokenize_item / tokenize_item_openqa):
examples are pre-tokenized {q_subtoks, doc_subtoks, starts, ends, ...} rows,
grouped by question; training batches hold one positive + (B-1) sampled
negatives for a question; eval batches hold all its paragraphs. Collation
emits the same static-shape [B, L] tensors the reader consumes.

Scope note: like its reference counterpart (whose only consumer, qa/train.py,
has broken imports — SURVEY.md §3.5), this is a DATA path, not a wired
training path. Batches carry reader inputs + span targets but not the
rank-head candidate inputs (para_embed/para_rows, top5000_labels) that
`qa_forward`/`qa_loss` additionally require — those exist only in the online
sampler, which is the framework's (and the reference's) actual QA training
route.
"""
from __future__ import annotations

import json
import random
from typing import Iterator

import numpy as np

from proqa_tpu_torch.data.collate import pad_to
from proqa_tpu_torch.qa.prepro import hash_question
from proqa_tpu_torch.text.matching import normalize
from proqa_tpu_torch.text.squad import char_spans_of, find_answer_spans, prepare_context


# ---------------------------------------------------------------------------
# offline tokenization (prepro_utils.tokenize_item* equivalents)
# ---------------------------------------------------------------------------


def load_topk_retrieval(path: str) -> dict:
    """Precomputed top-k retrieval per question (reference
    qa/datasets.py:271-296 top5k_generator): jsonl rows with question +
    para_embed_idx + para_labels -> {qid: (row indices, binary labels)}."""
    out = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            item = json.loads(line)
            qid = item.get("qid") or hash_question(item["question"])
            out[qid] = (
                np.asarray(item["para_embed_idx"], np.int32),
                np.asarray(item["para_labels"], np.int32),
            )
    return out


def load_mrqa_dataset(path: str) -> list[dict]:
    """MRQA-format jsonl (header line + {context, qas}) -> flat QA rows."""
    with open(path) as f:
        lines = f.readlines()[1:]
    out = []
    for line in lines:
        item = json.loads(line)
        for qa in item["qas"]:
            out.append({
                "qid": qa["qid"],
                "question": qa["question"],
                "context": item["context"],
                "matched_answers": qa.get("detected_answers", []),
                "true_answers": qa.get("answers", []),
            })
    return out


def tokenize_qa_item(sample: dict, tokenizer) -> dict:
    """One (question, context, detected answers) row -> pre-tokenized example
    with wordpiece-level span targets."""
    doc_tokens, c2w, o2t, t2o, pieces = prepare_context(sample["context"], tokenizer)
    starts, ends, texts = [], [], []
    for ans in sample["matched_answers"]:
        spans = find_answer_spans(
            ans["text"], ans["char_spans"], c2w, doc_tokens, pieces, o2t, tokenizer
        )
        for s, e in spans:
            starts.append(s)
            ends.append(e)
            texts.append(ans["text"])
    return {
        "qid": sample["qid"],
        "q": sample.get("question", ""),
        "q_subtoks": tokenizer.tokenize(sample.get("question", "")),
        "doc_toks": doc_tokens,
        "doc_subtoks": pieces,
        "tok_to_orig_index": t2o,
        "starts": starts,
        "ends": ends,
        "span_texts": texts,
        "true_answers": sample.get("true_answers", []),
    }


def tokenize_openqa_item(sample: dict, tokenizer) -> list[dict]:
    """One question with its retrieved paragraphs (each carrying a
    matched_answer surface string or "") -> one example per paragraph."""
    q_subtoks = tokenizer.tokenize(sample["question"])
    qid = hash_question(sample["question"])
    out = []
    for para_idx, para in enumerate(sample["retrieved"]):
        context = normalize(para["para"])
        doc_tokens, c2w, o2t, t2o, pieces = prepare_context(context, tokenizer)
        starts, ends, texts = [], [], []
        no_answer = 1
        matched = para.get("matched_answer", "")
        if matched:
            no_answer = 0
            spans = find_answer_spans(
                matched, char_spans_of(context, matched), c2w, doc_tokens, pieces, o2t, tokenizer
            )
            for s, e in spans:
                starts.append(s)
                ends.append(e)
                texts.append(matched)
        else:
            starts, ends, texts = [-1], [-1], [""]
        out.append({
            "qid": qid,
            "q": sample["question"],
            "q_subtoks": q_subtoks,
            "para_id": para_idx,
            "doc_toks": doc_tokens,
            "doc_subtoks": pieces,
            "tok_to_orig_index": t2o,
            "starts": starts,
            "ends": ends,
            "span_texts": texts,
            "true_answers": sample.get("gold_answer", sample.get("answer", [])),
            "no_answer": no_answer,
        })
    return out


def tokenize_openqa_file(path: str, tokenizer, save_path: str, filter_no_answer: bool = False) -> int:
    """jsonl of {question, retrieved: [{para, matched_answer}, ...]} ->
    pre-tokenized example jsonl (one line per paragraph)."""
    n = 0
    with open(path) as f, open(save_path, "w") as g:
        for line in f:
            if not line.strip():
                continue
            sample = json.loads(line)
            if filter_no_answer and not any(
                p.get("matched_answer") for p in sample["retrieved"]
            ):
                continue
            for ex in tokenize_openqa_item(sample, tokenizer):
                g.write(json.dumps(ex) + "\n")
                n += 1
    return n


# ---------------------------------------------------------------------------
# dataset + batching
# ---------------------------------------------------------------------------


class OpenQADataset:
    """Pre-tokenized open-QA examples grouped by question.

    train mode: `train_batches(B)` yields one positive + (B-1) random
    paragraphs of the SAME question per batch (reference OpenQASampler
    semantics); eval mode: `eval_batches(k)` yields each question's first k
    paragraphs.
    """

    def __init__(self, tokenizer, path: str, max_query_length: int = 30, max_length: int = 512,
                 max_spans: int = 30):
        self.tokenizer = tokenizer
        self.max_query_length = max_query_length
        self.max_length = max_length
        self.max_spans = max_spans
        with open(path) as f:
            self.examples = [json.loads(l) for l in f if l.strip()]
        self.by_qid: dict[str, list[int]] = {}
        for i, ex in enumerate(self.examples):
            self.by_qid.setdefault(ex["qid"], []).append(i)

    def __len__(self) -> int:
        return len(self.examples)

    def _tensorize(self, ex: dict) -> dict:
        q_ids = [self.tokenizer.cls_id] + self.tokenizer.convert_tokens_to_ids(
            ex["q_subtoks"][: self.max_query_length - 2]
        ) + [self.tokenizer.sep_id]
        para_offset = len(q_ids)
        max_p = self.max_length - para_offset - 1
        p_ids = self.tokenizer.convert_tokens_to_ids(ex["doc_subtoks"][:max_p])
        plen = len(p_ids)
        input_ids = q_ids + p_ids + [self.tokenizer.sep_id]
        segment_ids = [0] * para_offset + [1] * (plen + 1)
        paragraph_mask = [0] * para_offset + [1] * plen + [0]
        starts, ends = [], []
        for s, e in zip(ex["starts"], ex["ends"]):
            if s < 0 or s >= plen:
                continue
            starts.append(min(s, plen - 1) + para_offset)
            ends.append(min(e, plen - 1) + para_offset)
        starts, ends = starts[: self.max_spans], ends[: self.max_spans]
        if not starts:
            starts, ends = [-1], [-1]
        return {
            "input_ids": input_ids,
            "segment_ids": segment_ids,
            "paragraph_mask": paragraph_mask,
            "starts": starts,
            "ends": ends,
            "covered": int(starts[0] >= 0),
            "q_ids": q_ids,
            "para_offset": para_offset,
            "meta": ex,
        }

    def _collate(self, items: list[dict], with_targets: bool) -> dict:
        L, S = self.max_length, self.max_spans
        ids = pad_to([it["input_ids"] for it in items], L)
        net = {
            "input_ids": ids[None],
            "input_mask": (ids != 0).astype(np.int32)[None],
            "segment_ids": pad_to([it["segment_ids"] for it in items], L)[None],
            "paragraph_mask": pad_to([it["paragraph_mask"] for it in items], L)[None],
            "input_ids_q": pad_to([items[0]["q_ids"]], self.max_query_length),
        }
        net["input_mask_q"] = (net["input_ids_q"] != 0).astype(np.int32)
        if with_targets:
            net["start_positions"] = pad_to([it["starts"] for it in items], S, -1)[None]
            net["end_positions"] = pad_to([it["ends"] for it in items], S, -1)[None]
            net["para_targets"] = np.asarray([[it["covered"] for it in items]], np.int32)
        return {
            "net_input": net,
            "id": [items[0]["meta"]["qid"]],
            "q": [items[0]["meta"]["q"]],
            "true_answers": [items[0]["meta"]["true_answers"]],
            "para_offset": [[it["para_offset"] for it in items]],
            "doc_tokens": [[it["meta"]["doc_toks"] for it in items]],
            "wp_tokens": [[it["meta"]["doc_subtoks"] for it in items]],
            "tok_to_orig_index": [[it["meta"]["tok_to_orig_index"] for it in items]],
        }

    def train_batches(self, batch_size: int, rng: random.Random | None = None) -> Iterator[dict]:
        """Per answerable question: 1 positive + (B-1) sampled other
        paragraphs of the same question."""
        rng = rng or random
        qids = list(self.by_qid.keys())
        rng.shuffle(qids)
        for qid in qids:
            idxs = self.by_qid[qid]
            pos = [i for i in idxs if self.examples[i].get("no_answer", 0) == 0]
            if not pos:
                continue
            chosen = [rng.choice(pos)]
            rest = [i for i in idxs if i != chosen[0]]
            rng.shuffle(rest)
            chosen += rest[: batch_size - 1]
            while len(chosen) < batch_size and idxs:
                chosen.append(rng.choice(idxs))
            items = [self._tensorize(self.examples[i]) for i in chosen]
            yield self._collate(items, with_targets=True)

    def eval_batches(self, k: int) -> Iterator[dict]:
        for qid, idxs in self.by_qid.items():
            items = [self._tensorize(self.examples[i]) for i in idxs[:k]]
            yield self._collate(items, with_targets=False)
