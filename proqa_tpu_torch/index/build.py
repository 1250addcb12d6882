"""Corpus and query encoding into dense embeddings (index building).

Counterpart of proqa_tpu/index/build.py: jsonl text through a retriever tower
into an [N, D] f32 embedding matrix. Rows are tokenized on the host, sorted by
length and padded to the smallest fitting length bucket; trailing partial
batches are padded to the batch size by repeating row 0 (`batch_pad`), and the
outputs return to the original row order. Buckets of 128, 256, 384 and 512
tokens reach kernel K2 when the config turns flash attention on.

The streaming build (`--stream-chunk`, `encode_corpus_streaming`) keeps host
memory bounded by the chunk: it reads the jsonl twice, and writes each
chunk's rows straight into the `.npy` memmap the index then loads from.

`mesh=` (a device list of parallel/mesh.py; the CLI's `--dp-encode`) encodes
data-parallel, as the JAX package's `_encode_jit_mesh` does: one replica of
the retriever per device, each batch split into len(mesh) equal row ranges,
one range a device, the rows gathered back in dataset order. The batch size
must be a multiple of the mesh size; a ragged tail is padded as any batch.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Iterable

import numpy as np
import torch

from proqa_tpu_torch.data.collate import batch_pad, collate_tokens
from proqa_tpu_torch.data.datasets import EncodeDataset
from proqa_tpu_torch.data.loader import BatchLoader
from proqa_tpu_torch.index.dense import DenseIndex
from proqa_tpu_torch.index.idmap import IdMap
from proqa_tpu_torch.models.retriever import Retriever

DEFAULT_BUCKETS = (64, 128, 192, 256, 384, 512)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _encoder(model: Retriever, is_query: bool, mesh: list | None = None):
    """A batch of host ids and mask -> [B, D] f32 host embeddings. With a
    mesh, each device's replica encodes its equal share of the rows."""
    mesh = [_device(model)] if mesh is None else mesh
    replicas: dict = {_device(model): model}
    for dev in mesh:
        if dev not in replicas:
            replicas[dev] = copy.deepcopy(model).to(dev)
    encoders = [replicas[dev].encode_query if is_query else replicas[dev].encode_context
                for dev in mesh]

    def run(batch) -> np.ndarray:
        rows = batch["input_ids"].shape[0]
        if rows % len(mesh):
            raise ValueError(f"a batch of {rows} rows does not split over {len(mesh)} devices")
        share = rows // len(mesh)
        ids_all = torch.from_numpy(batch["input_ids"])
        mask_all = torch.from_numpy(batch["input_mask"])
        # every device's share is launched before any result is read back
        outs = [encode(ids_all[i * share:(i + 1) * share].to(dev, torch.int64),
                       mask_all[i * share:(i + 1) * share].to(dev))
                for i, (encode, dev) in enumerate(zip(encoders, mesh))]
        return torch.cat([o.float().cpu() for o in outs]).numpy()

    return run


def _place(model: Retriever, mesh: list | None) -> dict:
    """from_embeddings' placement: the mesh, else the model's device."""
    return {"device": _device(model)} if mesh is None else {"mesh": mesh}


def _fit_buckets(buckets: tuple, max_len: int) -> tuple:
    """The buckets up to max_len, ending at max_len."""
    buckets = tuple(b for b in buckets if b <= max_len)
    if not buckets or buckets[-1] < max_len:
        buckets = buckets + (max_len,)
    return buckets


def _bucketed_batches(seqs: list, batch_size: int, buckets: tuple):
    """(rows of `seqs`, padded batch, real row count) for each batch of the
    token lists sorted by length (stable), each padded to the smallest
    fitting bucket and to `batch_size` rows."""
    order = np.argsort([len(x) for x in seqs], kind="stable")
    for start in range(0, len(seqs), batch_size):
        sel = order[start:start + batch_size]
        ids = collate_tokens([seqs[i] for i in sel], buckets=buckets)
        batch, rows = batch_pad(
            {"input_ids": ids, "input_mask": (ids != 0).astype(np.int32)}, batch_size)
        yield sel, batch, rows


@torch.inference_mode()
def encode_corpus(model: Retriever, dataset: EncodeDataset, *, batch_size: int = 512,
                  is_query: bool = False, prefetch: int = 4, progress: bool = False,
                  buckets: tuple | None = DEFAULT_BUCKETS,
                  mesh: list | None = None) -> np.ndarray:
    """Encode every row of the dataset with the question (is_query) or
    context tower; returns an [N, D] f32 host array in row order. Without
    `buckets`, every batch pads to the dataset's max length in file order.
    mesh: encode data-parallel over these devices."""
    run = _encoder(model, is_query, mesh)
    n = len(dataset)

    if buckets is None:
        out = []
        for batch in BatchLoader(dataset.batches(batch_size), prefetch=prefetch):
            out.append(run(batch)[: batch["__rows__"]])
        return np.concatenate(out, axis=0)

    ids_all = [dataset[i] for i in range(n)]  # host tokenization
    batches = _bucketed_batches(ids_all, batch_size, _fit_buckets(buckets, dataset.max_len))
    out_arr = None
    done = 0
    for sel, batch, rows in BatchLoader(batches, prefetch=prefetch):
        emb = run(batch)[:rows]
        if out_arr is None:
            out_arr = np.empty((n, emb.shape[1]), np.float32)
        out_arr[sel] = emb
        done += rows
        if progress and done % (50 * batch_size) < batch_size:
            print(f"encoded {done} / {n}", flush=True)
    return out_arr if out_arr is not None else np.empty((0, 0), np.float32)


@torch.inference_mode()
def encode_corpus_streaming(model: Retriever, corpus_jsonl: str, tokenizer, out_path: str, *,
                            max_length: int = 512, batch_size: int = 512,
                            chunk_rows: int = 65536, buckets: tuple = DEFAULT_BUCKETS,
                            prefetch: int = 4, progress: bool = False,
                            mesh: list | None = None) -> tuple[np.ndarray, list[str]]:
    """The context-tower encode of a {"text" or "Paragraph", ["id"]} jsonl
    with host memory bounded by `chunk_rows` (proqa_tpu/index/build.py:122).
    Pass 1 reads only the doc ids and the row count; pass 2 tokenizes,
    length-buckets and encodes chunks of `chunk_rows` rows, each batch's
    rows written straight into the [N, D] f32 `.npy` memmap at `out_path`.
    Returns (that memmap, the doc ids). mesh: encode data-parallel over
    these devices."""
    doc_ids: list[str] = []
    with open(corpus_jsonl) as f:
        for line in f:
            if line.strip():
                doc_ids.append(str(json.loads(line).get("id", len(doc_ids))))
    n = len(doc_ids)
    dim = model.proj_c.bias.shape[0]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    out = np.lib.format.open_memmap(out_path, mode="w+", dtype=np.float32, shape=(n, dim))
    run = _encoder(model, is_query=False, mesh=mesh)
    buckets = _fit_buckets(buckets, max_length)

    def chunk_texts():
        texts, base = [], 0
        with open(corpus_jsonl) as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                # pair rows encode their Paragraph, as EncodeDataset does
                text = row.get("text", row.get("Paragraph"))
                if text is None:
                    raise KeyError(f"corpus row has neither 'text' nor 'Paragraph': "
                                   f"{list(row)[:6]}")
                texts.append(text)
                if len(texts) == chunk_rows:
                    yield base, texts
                    base += len(texts)
                    texts = []
        if texts:
            yield base, texts

    def batches():
        for base, texts in chunk_texts():
            ids_chunk = [tokenizer.encode(t, max_length=max_length) for t in texts]
            for sel, batch, rows in _bucketed_batches(ids_chunk, batch_size, buckets):
                yield base + sel, batch, rows

    done = 0
    for rows_out, batch, rows in BatchLoader(batches(), prefetch=prefetch):
        out[rows_out] = run(batch)[:rows]
        done += rows
        if progress and done % (50 * batch_size) < batch_size:
            print(f"encoded {done} / {n}", flush=True)
    out.flush()
    return out, doc_ids


def build_index(model: Retriever, corpus_jsonl: str, *, doc_ids: Iterable[str] | None = None,
                tokenizer=None, max_length: int = 512, batch_size: int = 512,
                dtype=torch.bfloat16, save_path: str | None = None,
                stream_chunk: int = 0, mesh: list | None = None) -> DenseIndex:
    """Encode a {"text", ["id"]} jsonl corpus into a DenseIndex on the
    model's device (and save it when save_path is given). With a mesh the
    encode is data-parallel over it and the index row-sharded over it.

    stream_chunk > 0 takes the bounded-memory path, which needs save_path:
    the rows go into `<save_path>/embeddings.npy` as they are encoded, and
    the index loads from that memmap a million rows at a time."""
    if stream_chunk > 0:
        if not save_path:
            raise ValueError("the streaming build writes into save_path: give one")
        os.makedirs(save_path, exist_ok=True)
        embeds, ids = encode_corpus_streaming(
            model, corpus_jsonl, tokenizer, os.path.join(save_path, "embeddings.npy"),
            max_length=max_length, batch_size=batch_size, chunk_rows=stream_chunk,
            progress=True, mesh=mesh)
        id_map = IdMap.from_doc_ids(doc_ids if doc_ids is not None else ids)
        id_map.save(os.path.join(save_path, "idx_id.json"))
        return DenseIndex.from_embeddings(embeds, id_map, dtype=dtype, **_place(model, mesh))
    dataset = EncodeDataset(tokenizer, corpus_jsonl, max_length=max_length, is_query=False)
    if doc_ids is None:
        # string ids, as the JAX package and build-db store them
        doc_ids = [str(row.get("id", i)) for i, row in enumerate(dataset.data)]
    embeds = encode_corpus(model, dataset, batch_size=batch_size, progress=True, mesh=mesh)
    index = DenseIndex.from_embeddings(embeds, IdMap.from_doc_ids(doc_ids), dtype=dtype,
                                       **_place(model, mesh))
    if save_path:
        index.save(save_path)
    return index
