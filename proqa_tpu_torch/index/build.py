"""Corpus and query encoding into dense embeddings (index building).

Counterpart of proqa_tpu/index/build.py: jsonl text through a retriever tower
into an [N, D] f32 embedding matrix. Rows are tokenized on the host, sorted by
length and padded to the smallest fitting length bucket; trailing partial
batches are padded to the batch size by repeating row 0 (`batch_pad`), and the
outputs return to the original row order. Buckets of 128, 256, 384 and 512
tokens reach kernel K2 when the config turns flash attention on.

The bounded-memory streaming build (`--stream-chunk`) is not ported yet
(ROADMAP Queue 1, item 5).
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from proqa_tpu.data.collate import batch_pad, collate_tokens
from proqa_tpu.data.datasets import EncodeDataset
from proqa_tpu.data.loader import BatchLoader
from proqa_tpu_torch.index.dense import DenseIndex
from proqa_tpu_torch.index.idmap import IdMap
from proqa_tpu_torch.models.retriever import Retriever

DEFAULT_BUCKETS = (64, 128, 192, 256, 384, 512)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def encode_corpus(model: Retriever, dataset: EncodeDataset, *, batch_size: int = 512,
                  is_query: bool = False, prefetch: int = 4, progress: bool = False,
                  buckets: tuple | None = DEFAULT_BUCKETS) -> np.ndarray:
    """Encode every row of the dataset with the question (is_query) or
    context tower; returns an [N, D] f32 host array in row order. Without
    `buckets`, every batch pads to the dataset's max length in file order."""
    encode = model.encode_query if is_query else model.encode_context
    device = _device(model)
    n = len(dataset)

    def run(batch) -> np.ndarray:
        ids = torch.from_numpy(batch["input_ids"]).to(device, torch.int64)
        mask = torch.from_numpy(batch["input_mask"]).to(device)
        return encode(ids, mask).float().cpu().numpy()

    if buckets is None:
        out = []
        for batch in BatchLoader(dataset.batches(batch_size), prefetch=prefetch):
            out.append(run(batch)[: batch["__rows__"]])
        return np.concatenate(out, axis=0)

    buckets = tuple(b for b in buckets if b <= dataset.max_len)
    if not buckets or buckets[-1] < dataset.max_len:
        buckets = buckets + (dataset.max_len,)
    ids_all = [dataset[i] for i in range(n)]  # host tokenization
    order = np.argsort([len(x) for x in ids_all], kind="stable")

    def gen():
        for start in range(0, n, batch_size):
            sel = order[start:start + batch_size]
            ids = collate_tokens([ids_all[i] for i in sel], buckets=buckets)
            batch, rows = batch_pad(
                {"input_ids": ids, "input_mask": (ids != 0).astype(np.int32)}, batch_size)
            yield sel, batch, rows

    out_arr = None
    done = 0
    for sel, batch, rows in BatchLoader(gen(), prefetch=prefetch):
        emb = run(batch)[:rows]
        if out_arr is None:
            out_arr = np.empty((n, emb.shape[1]), np.float32)
        out_arr[sel] = emb
        done += rows
        if progress and done % (50 * batch_size) < batch_size:
            print(f"encoded {done} / {n}", flush=True)
    return out_arr if out_arr is not None else np.empty((0, 0), np.float32)


def build_index(model: Retriever, corpus_jsonl: str, *, doc_ids: Iterable[str] | None = None,
                tokenizer=None, max_length: int = 512, batch_size: int = 512,
                dtype=torch.bfloat16, save_path: str | None = None,
                stream_chunk: int = 0) -> DenseIndex:
    """Encode a {"text", ["id"]} jsonl corpus into a DenseIndex on the
    model's device (and save it when save_path is given)."""
    if stream_chunk > 0:
        raise NotImplementedError(
            "the streaming build (--stream-chunk) is not ported to PyTorch yet "
            "(ROADMAP Queue 1, item 5)"
        )
    dataset = EncodeDataset(tokenizer, corpus_jsonl, max_length=max_length, is_query=False)
    if doc_ids is None:
        # string ids, as the JAX package and build-db store them
        doc_ids = [str(row.get("id", i)) for i, row in enumerate(dataset.data)]
    embeds = encode_corpus(model, dataset, batch_size=batch_size, progress=True)
    index = DenseIndex.from_embeddings(embeds, IdMap.from_doc_ids(doc_ids),
                                       device=_device(model), dtype=dtype)
    if save_path:
        index.save(save_path)
    return index
