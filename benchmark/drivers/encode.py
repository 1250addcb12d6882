"""Corpus encode: index/build.py:encode_corpus over shards of pre-tokenized
paragraphs, whole calls back to back, with the program's batch and length
buckets.

Set-up draws the retriever's weights on the card (weights.py) and a pool
of shards on the host (traffic.paragraph_shards: log-normal lengths on a
fixed quantile grid, permuted by the seed), then warms up one batch at each
bucket length. The window runs whole calls for `seconds`: the rate is the
real (unpadded) tokens of every call over the time from the window's start
to the last call's end.

Correctness: a few rows of every call's output, drawn from the seed, and
the call's longest row are kept; once the window has closed and the model
is freed, up to traffic["check_rows"] of them are encoded again by the
plain tower (reference/bert.py) at their own lengths, and compared: the
largest distance of a row from the reference's, over the spread of the
reference's rows (reference/bert.py:worst_gap).
"""
from __future__ import annotations

import dataclasses
import sys
import time

import torch

from benchmark import traffic as gen
from benchmark import weights as wts
from benchmark.harness import Outcome
from benchmark.reference import bert as ref
from benchmark.trace import BATCH, traced


@dataclasses.dataclass
class TokenShard:
    """What encode_corpus reads of a dataset: its length, its rows of token
    ids, and the longest row it may hold."""
    rows: list
    max_len: int

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> list:
        return self.rows[i]

    @property
    def tokens(self) -> int:
        return sum(len(r) for r in self.rows)


def bert_config(cfg: dict):
    """The program's BertConfig for a configuration file, as the build-index
    command runs it: bf16 activations, fused attention on."""
    from proqa_tpu_torch.models.bert import BertConfig

    return BertConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"], hidden_dropout=cfg["hidden_dropout_prob"],
        attention_dropout=cfg["attention_probs_dropout_prob"],
        layer_norm_eps=cfg["layer_norm_eps"], initializer_range=cfg["initializer_range"],
        dtype=getattr(torch, cfg["activation_dtype"]), flash_attention=True)


def build_model(seed: int, cfg: dict, device):
    from proqa_tpu_torch.models.retriever import Retriever

    with torch.device(device):
        model = Retriever(bert_config(cfg), cfg["projection_dim"])
    model.load_state_dict(wts.retriever_weights(seed, cfg, device))
    return model.eval()


class BatchRecorder:
    """Forward hooks on the context tower, in traced runs only: each batch's
    [B, T] shape and mask, and a BATCH span around the tower's call, so that
    the trace attributes kernels to batches."""

    def __init__(self, tower):
        self.shapes, self.masks, self._spans = [], [], []
        self._hooks = [tower.register_forward_pre_hook(self._pre),
                       tower.register_forward_hook(self._post)]

    def _pre(self, module, args):
        ids, mask = args[0], args[1]
        self.shapes.append(tuple(ids.shape))
        self.masks.append(mask)
        span = torch.profiler.record_function(BATCH)
        span.__enter__()
        self._spans.append(span)

    def _post(self, module, args, out):
        self._spans.pop().__exit__(None, None, None)

    def reset(self) -> None:
        """Forget the batches of a traced window that was dropped."""
        self.shapes, self.masks = [], []

    def close(self) -> dict:
        for h in self._hooks:
            h.remove()
        return {"batch_shapes": self.shapes,
                "batch_lengths": [m.sum(1).tolist() for m in self.masks]}


def run(cell, *, seed: int, seconds: float, trace: bool, device, clock) -> Outcome:
    from proqa_tpu_torch.index.build import DEFAULT_BUCKETS, encode_corpus

    cfg, tr = cell.config, cell.traffic
    model = build_model(seed, cfg, device)
    shards = [TokenShard(rows, tr["max_length"])
              for rows in gen.paragraph_shards(seed, tr, cfg["vocab_size"])]
    for t in DEFAULT_BUCKETS:  # one batch at each bucket length
        encode_corpus(model, TokenShard([[101] + [1000] * (t - 2) + [102]] * tr["batch"],
                                        tr["max_length"]), batch_size=tr["batch"])
    pick = gen.rng(seed, 5)
    kept = []  # (shard, row, length, embedding)

    def one(i: int) -> int:
        s = i % len(shards)
        emb = encode_corpus(model, shards[s], batch_size=tr["batch"])
        rows = shards[s].rows
        longest = max(range(len(rows)), key=lambda r: len(rows[r]))
        for r in [longest, *pick.choice(len(rows), tr["kept_rows_per_call"], replace=False)]:
            kept.append((s, int(r), len(rows[r]), emb[r].copy()))
        return shards[s].tokens

    window_start = time.perf_counter()
    summary, work = None, {}
    if trace:
        recorder = BatchRecorder(model.bert_c)

        def window():
            recorder.reset()
            return [one(i) for i in range(tr["trace_calls"])]

        summary, tokens = traced(window)
        work = recorder.close()
        calls = len(tokens)
        work.update(calls=calls, tokens=sum(tokens), passes=1, row_lengths=[
            len(r) for i in range(calls) for r in shards[i % len(shards)].rows])
    else:
        tokens = []
        while time.perf_counter() - window_start < seconds:
            tokens.append(one(len(tokens)))
        calls = len(tokens)
    window_s = time.perf_counter() - window_start
    print(f"calls: {len(tokens)} in {window_s:.3f} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del model

    checks = check(cell, seed, shards, kept, device)
    return Outcome(
        attempted=calls * len(shards[0]), failed=0,
        end_to_end={"setup_s": window_start - clock.start,
                    "encode_tokens_per_s": sum(tokens) / window_s},
        checks=checks, memory_peak_bytes=peak, trace=summary, work=work)


def sample(seed: int, kept: list, count: int) -> list:
    """Up to `count` of the kept rows drawn from the seed, always with the
    longest kept row."""
    r = gen.rng(seed, 6)
    longest = max(range(len(kept)), key=lambda i: kept[i][2])
    rest = [i for i in range(len(kept)) if i != longest]
    chosen = r.choice(rest, min(count - 1, len(rest)), replace=False).tolist() if rest else []
    return [kept[i] for i in sorted([longest, *chosen])]


def check(cell, seed: int, shards: list, kept: list, device) -> dict:
    cfg = cell.config
    chosen = sample(seed, kept, cell.traffic["check_rows"])
    rows = [shards[s].rows[r] for s, r, *_ in chosen]
    w = wts.retriever_weights(seed, cfg, device)
    want = ref.embed_rows(rows, w, cfg, device)
    got = {"embed_gap": ref.worst_gap([torch.from_numpy(e).to(device) for *_, e in chosen],
                                      want)}
    return {name: (got[name], cell.limits[name]) for name in cell.limits}


def control(cell, seed: int, device) -> dict:
    """The control's reading: the tower in fp8 in the program's place,
    compared with the bf16 reference over as many rows as a run checks,
    drawn from the shard pool, the pool's longest row among them."""
    cfg, tr = cell.config, cell.traffic
    shards = gen.paragraph_shards(seed, tr, cfg["vocab_size"])
    r = gen.rng(seed, 7)
    rows = [shards[0][max(range(len(shards[0])), key=lambda i: len(shards[0][i]))]]
    rows += [shards[int(s)][int(i)] for s, i in zip(
        r.integers(0, len(shards), tr["check_rows"] - 1),
        r.integers(0, tr["shard_rows"], tr["check_rows"] - 1))]
    w = wts.retriever_weights(seed, cfg, device)
    want = ref.embed_rows(rows, w, cfg, device)
    got = ref.embed_rows(rows, w, cfg, device, rnd=ref.fp8)
    return {"embed_gap": ref.worst_gap(got, want)}
