"""Retriever-pretraining and encoding datasets with their batch-order

Copy of proqa_tpu/data/datasets.py: the port keeps its own host code and imports
nothing of the JAX package.
invariants.

Equivalents of upstream retrieval/datasets.py:
* PairDataset (ReDataset :153-209): jsonl {Question, Paragraph, Answer} pairs;
  optional filter (paragraph <20 words, or answer contained in question);
  the corpus interleaves 3 generated questions per paragraph, so example i
  shares its paragraph with i±1 mod 3.
* grouped_shuffle_order (ReSampler :212-229): shuffle each residue-class group
  independently then concatenate — a batch never holds two questions for the
  same paragraph, keeping in-batch negatives valid.
* ClusterPairDataset + cluster_batch_order (ClusterDataset/ClusterSampler
  :48-150): cluster-sharded corpus; every batch is drawn from one k-means
  cluster (hard negatives), with batch start offsets shuffled globally so
  adjacent batches come from different clusters.
* EncodeDataset (EmDataset :257-305): corpus/query encoding inputs.
"""
from __future__ import annotations

import json
import os
import random
from typing import Iterator

import numpy as np

from proqa_tpu_torch.data.collate import batch_pad, collate_tokens
from proqa_tpu_torch.text.metrics import normalize_answer

NUM_QUESTION_GROUPS = 3  # generated questions per paragraph in the pretrain corpus


def _filter_pair(item: dict) -> bool:
    if len(item["Paragraph"].split()) < 20:
        return False
    if normalize_answer(item["Answer"]) in normalize_answer(item["Question"]):
        return False
    return True


def load_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class PairDataset:
    def __init__(
        self,
        tokenizer,
        data_path: str,
        max_query_length: int = 30,
        max_length: int = 512,
        filter: bool = False,
    ):
        self.tokenizer = tokenizer
        self.max_query_length = max_query_length
        self.max_c_length = max_length - max_query_length
        self.data = load_jsonl(data_path)
        if filter:
            self.data = [d for d in self.data if _filter_pair(d)]
        self.group_indexs = [
            list(range(len(self.data)))[i::NUM_QUESTION_GROUPS]
            for i in range(NUM_QUESTION_GROUPS)
        ]

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        sample = self.data[index]
        q_ids = self.tokenizer.encode(sample["Question"], max_length=self.max_query_length)
        c_ids = self.tokenizer.encode(sample["Paragraph"], max_length=self.max_c_length)
        return {"input_ids_q": q_ids, "input_ids_c": c_ids}

    def batches(
        self, order, batch_size: int, *, q_len: int | None = None,
        c_len: int | None = None, drop_last: bool = False,
    ) -> Iterator[dict]:
        """Collated static-shape numpy batches following `order`. Trailing
        partial batches are padded back to batch_size (true count in
        "__rows__") or dropped (drop_last=True — required for contrastive
        training, where a padded duplicate row corrupts in-batch negatives)."""
        q_len = q_len or self.max_query_length
        c_len = c_len or self.max_c_length
        for start in range(0, len(order), batch_size):
            idxs = order[start : start + batch_size]
            if drop_last and len(idxs) < batch_size:
                return
            items = [self[i] for i in idxs]
            batch = {
                "input_ids_q": collate_tokens([it["input_ids_q"] for it in items], length=q_len),
                "input_ids_c": collate_tokens([it["input_ids_c"] for it in items], length=c_len),
            }
            batch["input_mask_q"] = (batch["input_ids_q"] != 0).astype(np.int32)
            batch["input_mask_c"] = (batch["input_ids_c"] != 0).astype(np.int32)
            batch, rows = batch_pad(batch, batch_size)
            batch["__rows__"] = rows
            yield batch


def grouped_shuffle_order(dataset: PairDataset, rng: random.Random | None = None) -> list[int]:
    rng = rng or random
    order: list[int] = []
    for group in dataset.group_indexs:
        g = list(group)
        rng.shuffle(g)
        order += g
    return order


class ClusterPairDataset(PairDataset):
    """Loads a directory of per-cluster jsonl shards, tracking which index
    range belongs to which cluster."""

    def __init__(
        self,
        tokenizer,
        data_folder: str,
        max_query_length: int = 30,
        max_length: int = 512,
        filter: bool = False,
    ):
        self.tokenizer = tokenizer
        self.max_query_length = max_query_length
        self.max_c_length = max_length - max_query_length
        self.data = []
        self.index_clusters: list[list[int]] = []
        for fname in sorted(os.listdir(data_folder)):
            shard = load_jsonl(os.path.join(data_folder, fname))
            if filter:
                shard = [d for d in shard if _filter_pair(d)]
            idxs = list(range(len(self.data), len(self.data) + len(shard)))
            self.index_clusters.append(idxs)
            self.data.extend(shard)
        self.group_indexs = [
            list(range(len(self.data)))[i::NUM_QUESTION_GROUPS]
            for i in range(NUM_QUESTION_GROUPS)
        ]


def cluster_batch_order(
    dataset: ClusterPairDataset, batch_size: int, rng: random.Random | None = None
) -> list[int]:
    """Within each cluster: split into the 3 paragraph-sharing groups and
    shuffle; then shuffle batch start offsets globally. Every batch is a
    contiguous slice of one cluster (hard in-batch negatives)."""
    rng = rng or random
    flat: list[int] = []
    for cluster in dataset.index_clusters:
        groups = [cluster[i::NUM_QUESTION_GROUPS] for i in range(NUM_QUESTION_GROUPS)]
        rng.shuffle(groups)
        for g in groups:
            g = list(g)
            rng.shuffle(g)
            flat += g
    order: list[int] = []
    starts = list(range(0, len(dataset), batch_size))
    rng.shuffle(starts)
    for s in starts:
        order += flat[s : s + batch_size]
    assert len(order) == len(dataset)
    return order


class EncodeDataset:
    """Inputs for corpus ("text") or query ("question") encoding.

    Pair-format rows are accepted too ("Paragraph"/"Question" fields): the
    progressive-pretraining recipe encodes the TRAIN PAIR file's paragraphs
    (one embedding per pair line) before clustering them — reference
    group_paras.py:12-18 reads train_para_embed.npy aligned with
    retrieve_train.txt lines."""

    def __init__(
        self,
        tokenizer,
        data_path: str,
        max_query_length: int = 30,
        max_length: int = 512,
        is_query: bool = False,
    ):
        self.tokenizer = tokenizer
        self.is_query = is_query
        self.max_len = max_query_length if is_query else max_length
        self.data = load_jsonl(data_path)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> list[int]:
        sample = self.data[index]
        if self.is_query:
            text = sample.get("question", sample.get("Question"))
        else:
            text = sample.get("text", sample.get("Paragraph"))
        if text is None:
            raise KeyError(
                "row has neither 'text'/'Paragraph' (corpus/pair) nor "
                f"'question'/'Question' fields: {list(sample)[:6]}"
            )
        return self.tokenizer.encode(text, max_length=self.max_len)

    def batches(self, batch_size: int) -> Iterator[dict]:
        for start in range(0, len(self), batch_size):
            items = [self[i] for i in range(start, min(start + batch_size, len(self)))]
            ids = collate_tokens(items, length=self.max_len)
            batch = {"input_ids": ids, "input_mask": (ids != 0).astype(np.int32)}
            batch, rows = batch_pad(batch, batch_size)
            batch["__rows__"] = rows
            yield batch
