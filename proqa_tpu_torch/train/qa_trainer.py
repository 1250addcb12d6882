"""Dense QA finetuning and evaluation: the joint train step, the α-sweep EM
evaluation, and the outer loop with online retrieval.

Counterpart of proqa_tpu/train/qa_trainer.py (upstream
qa/train_retrieve_qa.py:170-401), on one device or data-parallel over
torch.distributed ranks (parallel/dist.py): the online sampler feeds
static-shape [B, k, L] batches, the reader's forward, the loss zoo and the
span decode run on the device, and only the text projection and the
rank/span score sweep (reference :366-394) stay on the host.

Training: the model runs in training mode (dropout seeds from the trainer's
torch.Generator: kernels K2/K3 in the reader's attention at T % 128 == 0, K4
at every other dropout site and on `qa_drop`), the question batch splits into
`accumulate_gradients` microbatches whose gradients and loss components are
summed and divided by their count, as the JAX step's scan does, and AdamW
(train/optim.py) keeps the frozen groups of `qa_frozen_mask` out of its
chain. Rank-head candidates travel as `para_rows` and are gathered on the
device from the registered index (`set_corpus`), per microbatch. Not ported:
`_pack_batch`, the JAX trainer's one-transfer packing of a batch for a
remote TPU (ROADMAP Queue 3).

Data parallel (the JAX trainer's `data` mesh): each rank holds the whole
index and runs its own sampler over its share of the questions
(cli/main.py:_qa_setup deals them out), so a train batch is this rank's
share of each global microbatch. The ranks first sum each microbatch's
question count, and each rank scales its masked loss sum by W / that global
count, so the average over the ranks is the one-process loss of the global
microbatch. The gradients of the trainable parameters, with the loss
components riding along, are averaged in one all-reduce after the last
microbatch, before the clip. A rank whose sampler has run dry takes part in
the step with nothing to add until every rank's has. Predictions are
gathered on rank 0, which sweeps α and writes the files; its EM is sent to
every rank. Rank 0 alone writes logs, metrics and checkpoints.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import threading
from typing import Callable

import numpy as np
import torch

from proqa_tpu_torch.data.collate import batch_pad, pad_bucket
from proqa_tpu_torch.data.loader import BatchLoader
from proqa_tpu_torch.models.bert import BertConfig, init_parameters
from proqa_tpu_torch.models.reader import (
    QAConfig, QAModel, decode_spans, qa_frozen_mask, qa_loss, qa_loss_keys,
)
from proqa_tpu_torch.models.retriever import embed_dim_of
from proqa_tpu_torch.ops.dot import pin_f32_precision
from proqa_tpu_torch.parallel.dist import data_parallel, rank_seed
from proqa_tpu_torch.text.metrics import (
    exact_match_score, metric_max_over_ground_truths, regex_match_score,
)
from proqa_tpu_torch.text.squad import get_final_text, wordpieces_to_text
from proqa_tpu_torch.train import checkpoint as ckpt
from proqa_tpu_torch.train.meta import read_trainer_meta, write_trainer_meta
from proqa_tpu_torch.train.optim import AdamW, TrainState, apply_gradients, init_train_state
from proqa_tpu_torch.utils.logging import AverageMeter, MetricLogger, setup_logger
from proqa_tpu_torch.utils.profiling import StepTimer, TraceWindow, span

ALPHA_GRID = (0, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.5, 0.55, 0.6, 0.7, 0.8, 0.9, 1)

Prediction = collections.namedtuple(
    "Prediction", ["text", "rank_score", "span_score", "passage", "question"]
)


@dataclasses.dataclass
class QATrainerConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 5.0
    adam_eps: float = 1e-8
    accumulate_gradients: int = 1
    num_train_epochs: int = 20
    eval_period: int = -1          # -1: eval at epoch end only (reference default)
    wait_step: int = 100
    eval_k: int = 5
    train_k: int = 5               # paragraphs read per question (ref batch size 5)
    questions_per_batch: int = 4
    fix_para_encoder: bool = True
    freeze_retriever: bool = False
    do_lower_case: bool = True
    regex: bool = False
    max_answer_len: int = 10
    seed: int = 3
    output_dir: str = "logs/qa"
    # sampler batches built ahead of the device by a thread; 0 (no thread)
    # by default, where the JAX package builds 2: here the thread's Python
    # and the reader's per-op launches contend for the interpreter lock, and
    # an eval-qa predict on an H100 ran 1.2-1.5x slower with it
    prefetch_batches: int = 0
    profile_dir: str = ""      # torch.profiler trace of a few warm train steps here
    profile_steps: int = 3


class QATrainer:
    def __init__(self, bert_cfg: BertConfig, qa_cfg: QAConfig, tcfg: QATrainerConfig, *,
                 params: dict | None = None, device: str | torch.device = "cuda",
                 embed_dim: int | None = None):
        """params: a state dict of the whole QAModel (strict), or None for
        random weights from tcfg.seed. embed_dim: the retriever's embedding
        width, by default params' (models/retriever.py:embed_dim_of), else
        128. The model stays in eval mode outside
        the train step. Under data parallelism (parallel/dist.py) `device`
        names the device type, and questions_per_batch is this rank's."""
        pin_f32_precision()
        accum = max(1, tcfg.accumulate_gradients)
        if tcfg.questions_per_batch % accum:
            raise ValueError(f"questions_per_batch={tcfg.questions_per_batch} must divide "
                             f"over {accum} microbatches")
        self.cfg, self.qcfg, self.tcfg = bert_cfg, qa_cfg, tcfg
        self.dp, self.device = data_parallel(device)
        main = self.dp.main
        self.logger = setup_logger("proqa_torch.qa", f"{tcfg.output_dir}/log.txt" if main else None)
        self.metrics = MetricLogger(f"{tcfg.output_dir}/metrics.jsonl" if main else None)
        if self.dp.grouped:
            self.logger.info(f"data parallel: backend {self.dp.backend}, world {self.dp.world}, "
                             f"rank {self.dp.rank}, device {self.device}")
        # one generator: initial weights first, then every dropout seed
        self.generator = torch.Generator().manual_seed(tcfg.seed)
        if embed_dim is None:
            embed_dim = embed_dim_of(params or {}, "retriever.")
        self.model = QAModel(bert_cfg, qa_cfg, embed_dim)
        if params is None:
            init_parameters(self.model, bert_cfg.initializer_range, self.generator)
        else:
            self.model.load_state_dict(params)
        if self.dp.rank:
            # the same weights on every rank, dropout seeds of each rank's own
            self.generator = torch.Generator().manual_seed(rank_seed(tcfg.seed, self.dp.rank))
        self.model.to(self.device).eval()
        self.frozen = qa_frozen_mask(
            dict(self.model.named_parameters()), freeze_c_encoder=tcfg.fix_para_encoder,
            freeze_retriever=tcfg.freeze_retriever)
        # frozen parameters get no gradient: optax's set_to_zero discards it
        for name, p in self.model.named_parameters():
            p.requires_grad_(not self.frozen[name])
        self.tx = AdamW(learning_rate=tcfg.learning_rate, weight_decay=tcfg.weight_decay,
                        max_grad_norm=tcfg.max_grad_norm, adam_eps=tcfg.adam_eps)
        self._state: TrainState | None = None  # made at the first train step or resume
        self._resume_meta: dict = {}
        self._corpus_index = None
        # the train step updates the weights in place; the query encoder,
        # which a prefetch thread may run, reads them under the same lock
        self._lock = threading.Lock()

    @property
    def state(self) -> TrainState:
        """The train state over the model's own tensors (moments for the
        trainable ones), made on first use: eval-qa and answer never need it."""
        if self._state is None:
            self._state = init_train_state(dict(self.model.named_parameters()), self.frozen)
        return self._state

    # -------------------- plumbing --------------------

    def set_corpus(self, index) -> None:
        """Register the dense index the train step gathers the rank-head
        candidates of `para_rows` batches from (train() calls it)."""
        self._corpus_index = index

    def query_encoder(self) -> Callable:
        """(ids [n, Tq], mask) numpy -> [n, D] f32 query embeddings on the
        device, from the live retriever weights, with no dropout whatever the
        model's mode (JAX's encoder is deterministic, qa_trainer.py:214). Grad
        mode is thread-local, and the sampler calls this from the prefetch
        thread: the call enters inference mode itself."""
        retriever, device, lock = self.model.retriever, self.device, self._lock

        def encode(ids, mask):
            with torch.inference_mode(), lock:
                ids_t = torch.from_numpy(np.asarray(ids)).to(device, torch.int64)
                mask_t = torch.from_numpy(np.asarray(mask)).to(device, torch.int32)
                return retriever.encode_query(ids_t, mask_t, deterministic=True)

        return encode

    def _prefetched(self, batch_iter):
        if self.tcfg.prefetch_batches > 0:
            return BatchLoader(batch_iter, prefetch=self.tcfg.prefetch_batches)
        return batch_iter

    def _device_batch(self, net: dict) -> dict:
        out = {}
        for k, v in net.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.to(self.device, torch.int64 if t.dtype in (torch.int32, torch.int64)
                          else torch.float32)
        return out

    def _eval_step(self, net: dict) -> dict:
        """The reader's forward, the span decode and the rank score
        (qa_trainer.py:197-210); numpy outputs of [B, k]."""
        with torch.inference_mode():
            out = self.model(self._device_batch(net))
            # a named range: profile_slice groups the decode's kernels by it
            with span("proqa.qa.decode"):
                start, end, score = decode_spans(out["start_logits"], out["end_logits"],
                                                 self.tcfg.max_answer_len)
            rank = (out["select_logits"] if self.qcfg.add_select
                    else out["rank_logits"][:, : start.shape[1]])
            res = {"start": start, "end": end, "span_score": score, "rank_score": rank}
            return {k: v.cpu().numpy() for k, v in res.items()}

    def _train_step(self, net: dict | None) -> dict:
        """One optimizer step on a host batch (numpy [B, ...] arrays, B a
        multiple of accumulate_gradients; under data parallelism this rank's
        share, or None for a rank with no batch left); returns the loss
        components averaged over the microbatches (and the ranks), as device
        scalars (qa_trainer.py:133-183)."""
        accum = max(1, self.tcfg.accumulate_gradients)
        dp = self.dp
        batch = {} if net is None else self._device_batch(net)
        rows = batch.pop("para_rows", None)
        if rows is not None and self._corpus_index is None:
            raise ValueError("batch uses para_rows but no corpus is registered: call "
                             "trainer.set_corpus(sampler.index) (train() does this)")
        micro = 0 if net is None else batch["input_ids"].shape[0] // accum
        scales = [1.0] * accum
        if dp.grouped and (net is None or "question_mask" in net):
            # the loss is a mean over the global microbatch's questions: each
            # rank's masked sum over that global count, times W for the mean
            qmask = (np.zeros(accum * micro) if net is None
                     else np.asarray(net["question_mask"], np.float64))
            local = qmask.reshape(accum, micro).sum(axis=1) if micro else np.zeros(accum)
            total = dp.sum(local)
            scales = [dp.world * max(n, 1.0) / max(t, 1.0) for n, t in zip(local, total)]
        with self._lock:
            csum = {key: torch.zeros((), device=self.device) for key in qa_loss_keys(self.qcfg)}
            if net is not None:
                self.model.train()
                try:
                    for i in range(accum):
                        mb = {key: v[i * micro:(i + 1) * micro] for key, v in batch.items()}
                        if rows is not None:
                            mb["para_embed"] = self._corpus_index.gather(
                                rows[i * micro:(i + 1) * micro])
                        comp = qa_loss(self.model(mb, generator=self.generator), mb, self.qcfg)
                        (comp["loss"] * scales[i]).backward()
                        for key, value in comp.items():
                            csum[key] = csum[key] + value.detach() * scales[i]
                finally:
                    self.model.eval()
            params = self.state.params
            grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p)) / accum
                     for name, p in params.items() if not self.frozen[name]}
            comps = {key: value / accum for key, value in csum.items()}
            dp.all_reduce_mean([*grads.values(), *comps.values()])
            apply_gradients(self.state, grads, self.tx)
            for p in params.values():
                p.grad = None
        return comps

    def save(self, name: str) -> None:
        if self.dp.main:
            ckpt.save_checkpoint(f"{self.tcfg.output_dir}/{name}{ckpt.SUFFIX}", self.state)

    def _write_meta(self, best_em: float, wait: int, epoch: int) -> None:
        """Loop progress beside the checkpoints, so resume() continues the
        best-model race, early stopping and the epoch position (train/meta.py)."""
        if self.dp.main:
            write_trainer_meta(self.tcfg.output_dir, "best_em", best_em, wait, epoch)

    @torch.no_grad()
    def resume(self, path: str) -> None:
        """Restore a checkpoint_*.pt of this trainer: step, parameters (frozen
        ones included) and the trainable parameters' moments."""
        loaded = ckpt.load_checkpoint(path)
        state = self.state
        for name, p in state.params.items():
            p.copy_(loaded.params[name])
        for moment in ("mu", "nu"):
            if set(loaded.opt_state[moment]) != set(state.opt_state[moment]):
                raise ValueError(f"{path}: its optimizer state holds other parameter groups "
                                 "(--fix-para-encoder / --fix-retriever differ)")
            for name, m in state.opt_state[moment].items():
                m.copy_(loaded.opt_state[moment][name])
        state.step = loaded.step
        self._resume_meta = read_trainer_meta(path)
        self.logger.info(f"resumed from {path} at step {state.step}"
                         + (f" with loop progress {self._resume_meta}" if self._resume_meta
                            else ""))

    # -------------------- evaluation --------------------

    def _iter_candidate_predictions(self, sampler, B: int):
        """Retrieve + read + decode: yields one
        (qid, question, true_answers, [Prediction x eval_k]) tuple per
        question. Shared decode path of `predict` (batch EM eval) and
        `answer` (one-shot serving)."""
        t = self.tcfg
        buckets = getattr(sampler.cfg, "pad_buckets", False)
        for batch in self._prefetched(sampler.eval_load(self.query_encoder(), t.eval_k, B)):
            # pad_buckets (serving): pad the reader forward to the group's
            # power-of-two bucket, as eval_load padded its search
            target = pad_bucket(len(batch["id"]), B) if buckets else B
            net, rows = batch_pad(batch["net_input"], target)
            out = self._eval_step(net)
            start = out["start"][:rows]
            end = out["end"][:rows]
            span_score = out["span_score"][:rows]
            rank_score = out["rank_score"][:rows]

            for qi, qid in enumerate(batch["id"]):
                preds = []
                for pi in range(t.eval_k):
                    off = batch["para_offset"][qi][pi]
                    s = int(start[qi, pi]) - off
                    e = int(end[qi, pi]) - off
                    t2o = batch["tok_to_orig_index"][qi][pi]
                    doc_tokens = batch["doc_tokens"][qi][pi]
                    wp = batch["wp_tokens"][qi][pi]
                    if not wp or s < 0 or s >= len(t2o):
                        final = ""
                    else:
                        e = min(e, len(t2o) - 1)
                        tok_text = wordpieces_to_text(wp[s : e + 1])
                        orig_text = " ".join(doc_tokens[t2o[s] : t2o[e] + 1])
                        final = get_final_text(
                            tok_text, orig_text, do_lower_case=t.do_lower_case, verbose=False
                        )
                    preds.append(Prediction(
                        text=final,
                        rank_score=float(rank_score[qi, pi]),
                        span_score=float(span_score[qi, pi]),
                        passage=" ".join(doc_tokens),
                        question=batch["q"][qi],
                    ))
                yield qid, batch["q"][qi], batch["true_answers"][qi], preds

    def answer(self, sampler, alpha=0.8, topn=3) -> list[dict]:
        """One-shot open-domain QA inference (the serving path): retrieve
        eval_k paragraphs, read, extract the best span per question, rank
        candidates by alpha*span + (1-alpha)*rank. This is predict's decode
        without the sweep.

        alpha/topn may be scalars or per-question sequences aligned with the
        sampler's question order (the ranking mix is a host-side decode over
        already-computed scores, so such questions still share every device
        call).
        """
        results = []
        alphas = alpha if isinstance(alpha, (list, tuple)) else None
        topns = topn if isinstance(topn, (list, tuple)) else None
        for _qid, question, _ans, preds in self._iter_candidate_predictions(
            sampler, sampler.cfg.question_batch
        ):
            a = float(alphas[len(results)]) if alphas is not None else alpha
            n = int(topns[len(results)]) if topns is not None else topn
            ranked = sorted(
                preds,
                key=lambda x: a * x.span_score + (1 - a) * x.rank_score,
                reverse=True,
            )
            results.append({
                "question": question,
                "answer": ranked[0].text if ranked else "",
                "alpha": a,
                "candidates": [
                    {
                        "answer": p.text,
                        "score": round(a * p.span_score + (1 - a) * p.rank_score, 4),
                        "span_score": round(p.span_score, 4),
                        "rank_score": round(p.rank_score, 4),
                        "passage": p.passage,
                    }
                    for p in ranked[:n]
                ],
            })
        return results

    def predict(
        self,
        sampler,
        save_path: str | None = None,
        save_all_prefix: str | None = None,
    ) -> float:
        """Full EM eval with the rank/span linear-combination sweep.

        save_path: optional jsonl of the best-alpha top predictions
        (reference --save-pred, train_retrieve_qa.py:391-394 best alpha).
        save_all_prefix: reference --save-all/--save-pred dump set
        (train_retrieve_qa.py:359-364,391-394): `{prefix}_all.json` (every
        candidate prediction per question), `{prefix}_ground.json` (ground
        truths), and `{prefix}_{alpha}.json` per-alpha top-1 jsonl.

        Under data parallelism each rank reads its share of the questions
        (rank r the r-th of every W), rank 0 gathers them back in the
        one-process order, sweeps and writes, and every rank returns rank 0's EM.
        """
        t = self.tcfg
        qid2results: dict[str, list[Prediction]] = collections.defaultdict(list)
        qid2ground: dict[str, list] = {}
        B = sampler.cfg.question_batch

        items = [(qid, true_answers, preds) for qid, _q, true_answers, preds
                 in self._iter_candidate_predictions(sampler, B)]
        shares = self.dp.gather_objects(items)
        if shares is None:  # not the main rank
            return self.dp.broadcast(0.0)
        longest = max(len(share) for share in shares)
        for i in range(longest):  # round robin: the order the questions were dealt in
            for share in shares:
                if i < len(share):
                    qid, true_answers, preds = share[i]
                    qid2ground[qid] = true_answers
                    qid2results[qid].extend(preds)

        if save_all_prefix:
            with open(f"{save_all_prefix}_all.json", "w") as f:
                json.dump({q: [p._asdict() for p in ps] for q, ps in qid2results.items()}, f)
            with open(f"{save_all_prefix}_ground.json", "w") as f:
                json.dump(qid2ground, f)

        match_fn = regex_match_score if t.regex else exact_match_score
        # first alpha wins ties (reference `em > best_em`, :386-387)
        best_em, best_rows = -1.0, []
        for alpha in ALPHA_GRID:
            ems, rows = [], []
            for qid, preds in qid2results.items():
                top = max(preds, key=lambda x: alpha * x.span_score + (1 - alpha) * x.rank_score)
                # gold-less rows (serving-style inputs) are EXCLUDED from the
                # EM mean: averaging them in as 0 would deflate EM on mixed
                # datasets; the reference assumes gold always exists
                if qid2ground[qid]:
                    em_i = metric_max_over_ground_truths(
                        match_fn, top.text, qid2ground[qid]
                    )
                    ems.append(em_i)
                else:
                    em_i = None  # not scorable
                rows.append({
                    "question": top.question, "para": top.passage, "answer": top.text,
                    "rank_score": top.rank_score, "span_score": top.span_score,
                    "gold": qid2ground[qid], "alpha": alpha,
                    "em": None if em_i is None else float(em_i),
                })
            em = float(np.mean(ems)) if ems else 0.0
            if em > best_em:
                best_em, best_rows = em, rows
            if save_all_prefix:
                with open(f"{save_all_prefix}_{alpha}.json", "w") as f:
                    for row in rows:
                        f.write(json.dumps(row) + "\n")
        if save_path:
            with open(save_path, "w") as f:
                for row in best_rows:
                    f.write(json.dumps(row) + "\n")
        return self.dp.broadcast(max(best_em, 0.0))

    # -------------------- training --------------------

    def train(self, train_sampler, eval_sampler) -> float:
        """The outer loop (qa_trainer.py:610-701): a shuffle per epoch, padded
        batches with a question_mask, evals every eval_period steps and at
        each epoch end (both count towards wait_step), best-model and
        checkpoint_last saves, and the trainer_meta.json pairing. Returns the
        best EM."""
        t = self.tcfg
        if getattr(train_sampler, "index", None) is not None:
            self.set_corpus(train_sampler.index)
        best_em = float(self._resume_meta.get("best_em", 0.0))
        wait = int(self._resume_meta.get("wait", 0))
        start_epoch = int(self._resume_meta.get("epoch", 0))
        stop = False
        meter = AverageMeter()
        timer = StepTimer(device=self.device)
        tracer = TraceWindow(t.profile_dir if self.dp.main else "", steps=t.profile_steps,
                             logger=self.logger)
        for epoch in range(start_epoch, t.num_train_epochs):
            train_sampler.shuffle(seed=t.seed + epoch)
            batches = iter(self._prefetched(train_sampler.load(
                self.query_encoder(), t.train_k, t.questions_per_batch)))
            while True:
                batch = next(batches, None)
                alive = batch is not None
                if self.dp.grouped:
                    # ranks step together until every rank's sampler has run dry
                    alive = self.dp.sum([alive])[0] > 0
                if not alive:
                    break
                tracer.tick()
                net = None
                if batch is not None:
                    net, rows = batch_pad(batch["net_input"], t.questions_per_batch)
                    net["question_mask"] = (np.arange(t.questions_per_batch)
                                            < rows).astype(np.int32)
                with timer:
                    comp = self._train_step(net)
                    loss = float(comp["loss"])
                step = self.state.step
                meter.update(loss)
                self.metrics.scalar("train_loss", loss, step)

                if t.eval_period != -1 and step % t.eval_period == 0:
                    em = self.predict(eval_sampler)
                    self.metrics.scalar("dev_em", em * 100, step)
                    self.logger.info(f"Step {step} loss {meter.avg:.3f} EM {em*100:.2f} "
                                     f"epoch={epoch}")
                    if em > best_em:
                        self.save("best-model")
                        best_em, wait = em, 0
                    else:
                        wait += 1
                        # >= not ==: a resume can restore wait already at wait_step
                        if wait >= t.wait_step:
                            stop = True
                    self._write_meta(best_em, wait, epoch)
                    if stop:
                        break

            self.logger.info(
                f"Failed retrieval: {train_sampler.failed_retrieval}/{len(train_sampler)}")
            # an early-stop break still reaches the epoch-end eval, as the
            # reference does (train_retrieve_qa.py:243-255); the epoch
            # pointer is paired with the checkpoint before that eval
            self.save("checkpoint_last")
            self._write_meta(best_em, wait, epoch + 1)
            em = self.predict(eval_sampler)
            self.metrics.scalar("dev_em", em * 100, self.state.step)
            if em > best_em:
                self.save("best-model")
                best_em, wait = em, 0
            else:
                # epoch-end evals count towards wait_step too (the reference's
                # never do, so its early stopping is dead at eval_period -1)
                wait += 1
                if wait >= t.wait_step:
                    stop = True
            self._write_meta(best_em, wait, epoch + 1)
            if stop:
                break
        tracer.close()
        ts = timer.summary()
        if ts:
            self.metrics.scalar("step_p50_ms", ts["p50_s"] * 1e3, self.state.step)
            self.metrics.scalar("steps_per_s", ts["steps_per_s"], self.state.step)
        self.logger.info("Training finished!")
        return best_em
