"""Dense QA: retrieve, read and decode, and the α-sweep EM evaluation.

Counterpart of proqa_tpu/train/qa_trainer.py (upstream
qa/train_retrieve_qa.py:280-401), the inference half: the online sampler
feeds static-shape [B, k, L] batches, the reader's forward and the span
decode run on the device, and only the text projection and the rank/span
score sweep (reference :366-394) stay on the host. One device, no mesh.

Training (`train`, `resume`, `save`) is ROADMAP Queue 1 item 11 and raises
NotImplementedError until it is ported.
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import Callable

import numpy as np
import torch

from proqa_tpu_torch.data.collate import batch_pad, pad_bucket
from proqa_tpu_torch.data.loader import BatchLoader
from proqa_tpu_torch.models.bert import BertConfig
from proqa_tpu_torch.models.reader import QAConfig, QAModel, decode_spans
from proqa_tpu_torch.ops.dot import pin_f32_precision
from proqa_tpu_torch.text.metrics import (
    exact_match_score, metric_max_over_ground_truths, regex_match_score,
)
from proqa_tpu_torch.text.squad import get_final_text, wordpieces_to_text
from proqa_tpu_torch.utils.logging import setup_logger

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
    profile_dir: str = ""


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP Queue 1, item 11: QA training)")


class QATrainer:
    def __init__(self, bert_cfg: BertConfig, qa_cfg: QAConfig, tcfg: QATrainerConfig, *,
                 params: dict | None = None, device: str | torch.device = "cuda"):
        """params: a state dict of the whole QAModel (strict), or None for
        random weights from tcfg.seed. The model stays in eval mode."""
        pin_f32_precision()
        self.cfg, self.qcfg, self.tcfg = bert_cfg, qa_cfg, tcfg
        self.device = torch.device(device)
        self.logger = setup_logger("proqa_torch.qa", f"{tcfg.output_dir}/log.txt")
        self.model = QAModel(bert_cfg, qa_cfg)
        if params is None:
            self.model.reset_parameters(tcfg.seed)
        else:
            self.model.load_state_dict(params)
        self.model.to(self.device).eval()

    # -------------------- plumbing --------------------

    def query_encoder(self) -> Callable:
        """(ids [n, Tq], mask) numpy -> [n, D] f32 query embeddings on the
        device. Grad mode is thread-local, and the sampler calls this from the
        prefetch thread: the call enters inference mode itself."""
        retriever, device = self.model.retriever, self.device

        def encode(ids, mask):
            with torch.inference_mode():
                ids_t = torch.from_numpy(np.asarray(ids)).to(device, torch.int64)
                mask_t = torch.from_numpy(np.asarray(mask)).to(device, torch.int32)
                return retriever.encode_query(ids_t, mask_t)

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
            with torch.profiler.record_function("decode"):
                start, end, score = decode_spans(out["start_logits"], out["end_logits"],
                                                 self.tcfg.max_answer_len)
            rank = (out["select_logits"] if self.qcfg.add_select
                    else out["rank_logits"][:, : start.shape[1]])
            res = {"start": start, "end": end, "span_score": score, "rank_score": rank}
            return {k: v.cpu().numpy() for k, v in res.items()}

    def train(self, train_sampler, eval_sampler) -> float:
        _not_ported("QATrainer.train")

    def resume(self, path: str):
        _not_ported("QATrainer.resume")

    def save(self, name: str):
        _not_ported("QATrainer.save")

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
        """
        t = self.tcfg
        qid2results: dict[str, list[Prediction]] = collections.defaultdict(list)
        qid2ground: dict[str, list] = {}
        B = sampler.cfg.question_batch

        for qid, _q, true_answers, preds in self._iter_candidate_predictions(sampler, B):
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
        return max(best_em, 0.0)
