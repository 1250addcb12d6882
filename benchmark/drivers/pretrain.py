"""Retriever pretraining: RetrieverTrainer.step, optimizer steps back to
back, each over traffic["accumulate"] microbatches of traffic["micro"]
(question, paragraph) pairs.

Set-up builds one trainer from weights drawn on the card (weights.py) and
a pool of step batches made on the host from the seed (every row
distinct), then drives that trainer through its first `checked_steps`
steps, which also warm every shape up: their losses, step 1's gradient as
the optimizer took it (its first moment over 1 - b1) and every leaf's
change after them are kept. The same trainer then runs whole steps for
`seconds`: the rate is the real question and paragraph tokens of every step
over the time from the window's start to the last step's end (each step
ends synchronised, on its loss).

Correctness: once the window has closed and the trainer is freed, the
plain reference (reference/train.py) runs the checked steps from the same
weights, batches and dropout seeds, and the losses, the gradient norms and
the change norms are compared leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import statistics
import tempfile
import sys
import time

import torch

from benchmark import traffic as gen
from benchmark import weights as wts
from benchmark.drivers.encode import bert_config
from benchmark.harness import Outcome
from benchmark.reference import train as ref
from benchmark.trace import traced

# leaves whose reference gradient is under this share of the median leaf's
# (a key's bias under softmax) move by round-off alone: left out of the change
MIN_GRAD_SHARE = 1e-3


def optimizer(tr: dict) -> dict:
    return {"lr": tr["learning_rate"], "max_grad_norm": tr["max_grad_norm"], "b1": 0.9,
            "b2": 0.999, "eps": 1e-8, "accumulate": tr["accumulate"]}


def dropout_seed(seed: int) -> int:
    return gen.stream_seed(seed, 9)


def real_tokens(batch: dict) -> int:
    return int(batch["input_mask_q"].sum() + batch["input_mask_c"].sum())


def run(cell, *, seed: int, seconds: float, trace: bool, device, clock) -> Outcome:
    from proqa_tpu_torch.train.retriever_trainer import RetrieverTrainer, RetrieverTrainerConfig

    cfg, tr = cell.config, cell.traffic
    opt = optimizer(tr)
    checked = tr["checked_steps"]
    batches = gen.pair_batches(seed, tr, cfg["vocab_size"], checked + tr["pool"])
    with tempfile.TemporaryDirectory() as logs:
        tcfg = RetrieverTrainerConfig(
            learning_rate=opt["lr"], weight_decay=0.0, max_grad_norm=opt["max_grad_norm"],
            adam_eps=opt["eps"], accumulate_gradients=opt["accumulate"],
            seed=dropout_seed(seed), output_dir=logs)
        bert = dataclasses.replace(bert_config(cfg), remat=True)
        trainer = RetrieverTrainer(bert, tcfg, params=wts.retriever_weights(seed, cfg, device),
                                   device=device)
        state = trainer.state
        start = {k: p.detach().clone() for k, p in state.params.items()}
        losses = []
        for s in range(checked):
            losses.append(float(trainer.step(batches[s])["loss"]))
            if s == 0:
                grad_norms = {k: float(m.norm() / (1 - opt["b1"]))
                              for k, m in state.opt_state["mu"].items()}
        update_norms = {k: float((p.detach() - start[k]).norm())
                        for k, p in state.params.items()}
        del start

        def one(i: int) -> int:
            batch = batches[checked + i % tr["pool"]]
            float(trainer.step(batch)["loss"])
            return real_tokens(batch)

        window_start = time.perf_counter()
        summary = None
        if trace:
            summary, tokens = traced(lambda: [one(i) for i in range(tr["trace_calls"])])
        else:
            tokens = []
            while time.perf_counter() - window_start < seconds:
                tokens.append(one(len(tokens)))
        window_s = time.perf_counter() - window_start
        print(f"calls: {len(tokens)} in {window_s:.3f} s", file=sys.stderr)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        del trainer, state
    steps = len(tokens)
    window = [batches[checked + i % tr["pool"]] for i in range(steps)]
    work = {"steps": steps, "tokens": sum(tokens), "passes": 3,
            "row_lengths": [n for b in window for key in ("input_mask_q", "input_mask_c")
                            for n in b[key].sum(1).tolist()],
            "c_lengths": [n for b in window for n in b["input_mask_c"].sum(1).tolist()]}
    program = {"losses": losses, "grad_norms": grad_norms, "update_norms": update_norms}
    checks = check(cell, seed, batches[:checked], program, device)
    return Outcome(
        attempted=steps, failed=0,
        end_to_end={"setup_s": window_start - clock.start,
                    "train_tokens_per_s": sum(tokens) / window_s},
        checks=checks, memory_peak_bytes=peak, trace=summary, work=work)


def compare(got: dict, want: dict, min_share: float) -> dict:
    """The numbers a pretrain cell compares:
      loss_gap: the largest |program - reference| / |reference| of a step's
        loss;
      grad_norm_gap: over the leaves, the largest gap between the norms of
        step 1's clipped gradient, over the larger of the reference leaf's
        norm and the median leaf's;
      grad_median_gap: the median over the leaves of that same gap (the
        worst leaf is a query-tower attention kernel or LayerNorm scale,
        whose gradient at near-uniform attention is a difference of nearly
        equal terms, round-off to a few percent; the median leaf is steady,
        and it is the number that a product in fp8 moves, PERF.md);
      update_norm_gap: the same of each leaf's change over the checked
        steps, leaving out leaves whose reference gradient is under
        min_share of the median leaf's (a key's bias under softmax, the
        paragraph projection's bias under the in-batch loss: they move by
        round-off alone)."""
    losses = max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))

    def gaps(a: dict, b: dict, leaves) -> list[float]:
        median = statistics.median(b[k] for k in leaves)
        return [abs(a[k] - b[k]) / max(b[k], median) for k in leaves]

    g_ref = want["grad_norms"]
    median_g = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= min_share * median_g]
    grad = gaps(got["grad_norms"], g_ref, list(g_ref))
    return {"loss_gap": losses, "grad_norm_gap": max(grad),
            "grad_median_gap": statistics.median(grad),
            "update_norm_gap": max(gaps(got["update_norms"], want["update_norms"], moving))}


def check(cell, seed: int, batches: list, program: dict, device) -> dict:
    cfg, tr = cell.config, cell.traffic
    want = ref.train(wts.retriever_weights(seed, cfg, device), cfg, optimizer(tr), batches,
                     dropout_seed(seed), device)
    got = compare(program, want, MIN_GRAD_SHARE)
    return {name: (got[name], cell.limits[name]) for name in cell.limits}


def control(cell, seed: int, device) -> dict:
    """The control's readings, and the planted faults': the reference in
    fp8 in the program's place, and the reference with each microbatch's
    second half left out (the mean over the rest), each compared with the
    bf16 reference over the checked steps. (A step that leaves the state
    unchanged reads update_norm_gap 1 by construction.)"""
    from benchmark.reference.bert import fp8

    cfg, tr = cell.config, cell.traffic
    batches = gen.pair_batches(seed, tr, cfg["vocab_size"], tr["checked_steps"])
    w = wts.retriever_weights(seed, cfg, device)
    args = (cfg, optimizer(tr), batches, dropout_seed(seed), device)
    want = ref.train(w, *args)
    out = {}
    for label, kw in (("fp8", {"rnd": fp8}), ("half_batch", {"keep_rows": 0.5})):
        got = compare(ref.train(w, *args, **kw), want, MIN_GRAD_SHARE)
        out.update({f"{label}.{k}": v for k, v in got.items()})
    return out
