"""Batched online retrieval sampler for dense QA.

Copy of proqa_tpu/qa/sampler.py (the reference OnlineSampler, upstream
qa/online_sampler.py:49-412, restructured to batch the device work): the
port keeps its own host code and imports nothing of the JAX package.

1. questions are encoded in batches on the device (one call per group),
2. ONE exact MIPS search of the device-resident index serves the whole
   question group (kernel K1's pipeline, then K6's rescore, on the card),
3. candidate embeddings for the rank head are gathered from the index,
4. only the top-k paragraph *texts* are fetched from sqlite and span-matched
   on the host (the unavoidable host work), into static-shape arrays,
5. questions whose top-M contain no gold paragraph are dropped and counted
   (reference yields {} and skips — :263-264), and the valid ones are
   re-packed into full [B, k, L] batches.

All output arrays have static shapes: L (max_length), S (max span slots),
M (candidate count).

One departure: the JAX package lets the query encoder offer a fused
`encode_search` (one TPU dispatch for encode and search, to save a remote
dispatch's fixed latency) and falls back to encode, then search, with the
same results. The port has no remote dispatch to save, so it always encodes,
then searches (ROADMAP Queue 3).
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Callable, Iterator

import numpy as np

from proqa_tpu_torch.data.collate import pad_bucket, pad_to
from proqa_tpu_torch.data.docdb import DocDB
from proqa_tpu_torch.index.dense import DenseIndex
from proqa_tpu_torch.ops.mips import NEG_INF
from proqa_tpu_torch.qa.prepro import hash_question
from proqa_tpu_torch.text.matching import match_answer_span, normalize
from proqa_tpu_torch.text.simple import SimpleTokenizer
from proqa_tpu_torch.text.squad import char_spans_of, find_answer_spans, prepare_context

# scores at/below this are under-filled-search padding (index contract)
_PAD_SCORE = float(NEG_INF)


@dataclasses.dataclass
class OnlineSamplerConfig:
    max_query_length: int = 30
    max_length: int = 512
    candidates: int = 5000       # M: rank-head candidate pool (reference top-5000)
    max_spans: int = 30          # S: span target slots per paragraph
    regex: bool = False          # CuratedTrec answers are regexes
    question_batch: int = 8      # questions encoded/searched per device call
    exact_search: bool = False   # exact MIPS (eval) vs approx (train, M=5000)
    num_workers: int = 0         # host threads for span matching/tensorizing
                                 # (replaces the reference's fork pools)
    retrieval_batch: int = 0     # questions retrieved per device dispatch in
                                 # load(); 0 = questions_per_batch. Larger
                                 # values amortize the fixed per-dispatch
                                 # latency over several train batches at the
                                 # cost of candidates up to that many steps
                                 # stale (prefetch already implies ~2; the
                                 # params drift per step is tiny next to it)
    pad_buckets: bool = False    # eval_load pads each group to the smallest
                                 # power-of-two bucket <= question_batch
                                 # instead of always the full batch — the
                                 # SERVING setting (variable-size MicroBatcher
                                 # drains). Keep False for predict/eval files,
                                 # where only the tail group is ragged


class OnlineSampler:
    def __init__(
        self,
        raw_data: str | list,
        tokenizer,
        db: DocDB,
        index: DenseIndex,
        cfg: OnlineSamplerConfig,
        matched_para_path: str = "",
    ):
        if isinstance(raw_data, str):
            with open(raw_data) as f:
                self.qa_data = [json.loads(l) for l in f if l.strip()]
        else:
            self.qa_data = list(raw_data)
        self.tokenizer = tokenizer
        self.db = db
        self.index = index
        self.cfg = cfg
        self.simple = SimpleTokenizer()
        self.failed_retrieval = 0
        self._pool = None  # persistent worker pool, created on first use

        self.qid2goldparas: dict | None = None
        if matched_para_path:
            with open(matched_para_path) as f:
                annotated = [json.loads(l) for l in f if l.strip()]
            self.qid2goldparas = {
                hash_question(item["question"]): item["matched_paras"] for item in annotated
            }
        self._gold_rows_cache: dict[str, np.ndarray] = {}

    def _gold_rows(self, qid: str) -> np.ndarray:
        """Gold paragraph ids of a question as sorted index ROW numbers."""
        rows = self._gold_rows_cache.get(qid)
        if rows is None:
            gold = self.qid2goldparas.get(qid, {}) if self.qid2goldparas else {}
            rows = np.sort(np.asarray(
                self.index.id_map.ids_to_rows(gold.keys()), np.int64
            ))
            self._gold_rows_cache[qid] = rows
        return rows

    def __len__(self) -> int:
        return len(self.qa_data)

    def _workers(self):
        """Persistent thread pool (a per-question-group pool pays spin-up
        every batch — wrong shape for multi-core production hosts)."""
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                self.cfg.num_workers, thread_name_prefix="sampler"
            )
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def shuffle(self, seed: int | None = None):
        random.Random(seed).shuffle(self.qa_data)

    # ------------------------------------------------------------------
    # retrieval: encode + search a batch of questions at once
    # ------------------------------------------------------------------

    def _retrieve(
        self, questions: list[str], query_encoder: Callable,
        candidates: int | None = None, gather_embeds: bool = True,
        pad_rows: int | None = None,
    ):
        c = self.cfg
        k = candidates or c.candidates
        cfgq = c.max_query_length
        q_ids = [self.tokenizer.encode(q, max_length=cfgq) for q in questions]
        ids = pad_to(q_ids, cfgq)
        mask = (ids != 0).astype(np.int32)
        nq = ids.shape[0]
        # pad the ragged LAST group all the way to the standard group size
        # (pad_rows, uncapped), as the JAX package does: every group then
        # encodes and searches at one shape
        bpad = pad_rows or min(c.question_batch, 256)
        npad = (-nq) % bpad
        if npad:
            ids = np.concatenate([ids, np.zeros((npad, cfgq), ids.dtype)])
            mask = np.concatenate([mask, np.zeros((npad, cfgq), mask.dtype)])
            mask[nq:, 0] = 1  # pad rows attend [CLS] only (no all-masked rows)

        # [n, D] f32 on the index's device: no host round trip before the search
        embeds = query_encoder(ids, mask)[:nq]
        vals, rows = self.index.search(embeds, k, exact=c.exact_search, q_pad=bpad)
        # Under-filled searches pad with (row 0, -inf score) — the index
        # contract. Convert those slots to row -1 HERE so gold labeling
        # (isin over cand_rows) can never count a padding slot as a gold hit
        # when the real row 0 happens to be gold. Device-side gathers
        # (jnp.take, mode=clip) map -1 back to row 0; host id lookups clip
        # explicitly before indexing.
        rows = np.where(
            np.asarray(vals, np.float32) <= _PAD_SCORE, -1, np.asarray(rows)
        )
        if not gather_embeds:
            # train path: the reader gathers para_embed on the device from the
            # resident index (QAModel.forward para_rows), so [B, 5000, 128]
            # embeddings never cross to the host
            return q_ids, rows, None
        para_embeds = self.index.take(rows.reshape(-1)).reshape(
            rows.shape[0], rows.shape[1], -1
        )
        return q_ids, rows, para_embeds

    # ------------------------------------------------------------------
    # per-question example construction (host side)
    # ------------------------------------------------------------------

    def _build_train_example(self, qa: dict, q_token_ids: list[int], cand_rows, para_embed, k: int):
        """Returns dict of per-question tensors, or None if retrieval failed
        (no gold in top-M and no span-covered paragraph in top-k)."""
        c = self.cfg
        qid = hash_question(qa["question"])
        # gold labeling over the M=5000 candidates: row-set membership
        # (vectorized isin), not a per-candidate Python id lookup
        gold_rows = self._gold_rows(qid)
        top_labels = np.isin(
            np.asarray(cand_rows), gold_rows, assume_unique=False
        ).astype(np.int32)
        # -1 padding slots (see _retrieve) clip to row 0 like the device path
        cand_ids = self.index.id_map.rows_to_ids(np.maximum(cand_rows[:k], 0))
        per_para = []
        any_covered = False
        for pid in cand_ids[:k]:
            text = self.db.get_doc_text(pid)
            p = normalize(text) if text else ""
            matched = match_answer_span(
                p, qa["answer"], self.simple, match="regex" if c.regex else "string"
            ) if p else []
            ex = self._tensorize_paragraph(q_token_ids, p, matched)
            any_covered = any_covered or ex["covered"]
            per_para.append(ex)

        if top_labels.sum() == 0 and not any_covered:
            return None

        ex = {
            "qid": qid,
            "question": qa["question"],
            "answers": qa["answer"],
            "per_para": per_para,
            "top_labels": top_labels,
            "q_token_ids": q_token_ids,
        }
        if para_embed is None:
            ex["para_rows"] = np.asarray(cand_rows, np.int32)  # device gather
        else:
            ex["para_embed"] = para_embed  # full M candidates for the rank head
        return ex

    def _tensorize_paragraph(self, q_token_ids: list[int], p: str, matched: list[str]):
        """Build [CLS] q [SEP] p [SEP] tensors plus span targets for one
        paragraph (reference online_sampler.py:132-259 semantics: spans
        clipped to the truncated paragraph, covered recomputed after clip)."""
        c = self.cfg
        para_offset = len(q_token_ids)          # [CLS] q [SEP]
        max_p_toks = c.max_length - para_offset - 1

        doc_tokens, c2w, o2t, t2o, pieces = prepare_context(p, self.tokenizer)
        p_ids = self.tokenizer.convert_tokens_to_ids(pieces[:max_p_toks])
        plen = len(p_ids)

        input_ids = q_token_ids + p_ids + [self.tokenizer.sep_id]
        segment_ids = [0] * para_offset + [1] * (plen + 1)
        paragraph_mask = [0] * para_offset + [1] * plen + [0]

        starts, ends = [], []
        covered = 0
        for m in matched:
            for span in find_answer_spans(
                m, char_spans_of(p, m), c2w, doc_tokens, pieces, o2t, self.tokenizer
            ):
                s, e = span
                if s >= plen:
                    continue
                covered = 1
                starts.append(min(s, plen - 1) + para_offset)
                ends.append(min(e, plen - 1) + para_offset)
        starts, ends = starts[: c.max_spans], ends[: c.max_spans]
        if not starts:
            starts, ends = [-1], [-1]

        return {
            "input_ids": input_ids,
            "segment_ids": segment_ids,
            "paragraph_mask": paragraph_mask,
            "starts": starts,
            "ends": ends,
            "covered": covered,
            "doc_tokens": doc_tokens,
            "wp_tokens": pieces,
            "tok_to_orig_index": t2o,
            "para_offset": para_offset,
        }

    # ------------------------------------------------------------------
    # batching
    # ------------------------------------------------------------------

    def _collate_questions(self, examples: list[dict], with_targets: bool, k: int):
        c = self.cfg
        B, L = len(examples), c.max_length
        # every example holds exactly k paragraphs per question; the static
        # [B, k, L] batch shape depends on it
        assert all(len(ex["per_para"]) == k for ex in examples), \
            f"per_para lengths {[len(ex['per_para']) for ex in examples]} != k={k}"
        def stack_para(field, pad_val=0, length=L, dtype=np.int32):
            return np.stack([
                pad_to([pp[field] for pp in ex["per_para"]], length, pad_val, dtype)
                for ex in examples
            ])

        ids = stack_para("input_ids")
        net = {
            "input_ids": ids,
            "input_mask": (ids != 0).astype(np.int32),
            "segment_ids": stack_para("segment_ids"),
            "paragraph_mask": stack_para("paragraph_mask"),
            "input_ids_q": pad_to([ex["q_token_ids"] for ex in examples], c.max_query_length),
        }
        if "para_rows" in examples[0]:
            net["para_rows"] = np.stack([ex["para_rows"] for ex in examples])
        else:
            net["para_embed"] = np.stack([ex["para_embed"] for ex in examples])
        net["input_mask_q"] = (net["input_ids_q"] != 0).astype(np.int32)
        if with_targets:
            net["start_positions"] = stack_para("starts", -1, c.max_spans)
            net["end_positions"] = stack_para("ends", -1, c.max_spans)
            net["para_targets"] = np.stack(
                [[pp["covered"] for pp in ex["per_para"]] for ex in examples]
            ).astype(np.int32)
            net["top5000_labels"] = np.stack([ex["top_labels"] for ex in examples])
        meta = {
            "id": [ex["qid"] for ex in examples],
            "q": [ex["question"] for ex in examples],
            "true_answers": [ex["answers"] for ex in examples],
            "para_offset": [[pp["para_offset"] for pp in ex["per_para"]] for ex in examples],
            "doc_tokens": [[pp["doc_tokens"] for pp in ex["per_para"]] for ex in examples],
            "wp_tokens": [[pp["wp_tokens"] for pp in ex["per_para"]] for ex in examples],
            "tok_to_orig_index": [[pp["tok_to_orig_index"] for pp in ex["per_para"]] for ex in examples],
        }
        return {"net_input": net, **meta}

    def load(self, query_encoder: Callable, k: int = 5, questions_per_batch: int | None = None) -> Iterator[dict]:
        """Training batches: [B, k, L] reader inputs + rank targets.
        query_encoder(ids [n, Tq], mask) -> [n, D] f32 tensor (a closure over
        the CURRENT retriever weights, so retrieval follows training)."""
        B = questions_per_batch or self.cfg.question_batch
        R = max(self.cfg.retrieval_batch, B)  # retrieval group (>= one batch)
        self.failed_retrieval = 0
        buffer: list[dict] = []
        for group_start in range(0, len(self.qa_data), R):
            group = self.qa_data[group_start : group_start + R]
            questions = [qa["question"] for qa in group]
            q_ids, rows, _ = self._retrieve(
                questions, query_encoder, gather_embeds=False, pad_rows=R,
            )
            work = [(qa, qi, rr, None, k) for qa, qi, rr in zip(group, q_ids, rows)]
            if self.cfg.num_workers > 0:
                built = list(self._workers().map(
                    lambda w: self._build_train_example(*w), work
                ))
            else:
                built = [self._build_train_example(*w) for w in work]
            for ex in built:
                if ex is None:
                    self.failed_retrieval += 1
                    continue
                buffer.append(ex)
                if len(buffer) == B:
                    yield self._collate_questions(buffer, with_targets=True, k=k)
                    buffer = []
        if buffer:
            yield self._collate_questions(buffer, with_targets=True, k=k)

    def eval_load(self, query_encoder: Callable, k: int = 5, questions_per_batch: int | None = None) -> Iterator[dict]:
        """Eval batches: top-k paragraphs per question, no targets, plus the
        offset maps needed to project predictions back to text."""
        B = questions_per_batch or self.cfg.question_batch
        # k and candidates flow per-call (NOT via cfg/instance mutation):
        # eval_load is re-entrant with a concurrent train load over the same
        # sampler (the prefetch thread keeps pulling train batches during
        # predict), so no shared mutable state may leak between the two
        for group_start in range(0, len(self.qa_data), B):
            group = self.qa_data[group_start : group_start + B]
            questions = [qa["question"] for qa in group]
            # serving (pad_buckets): encode/search at the group's power-of-two
            # bucket, not the full B — QATrainer._iter_candidate_predictions
            # computes the SAME bucket for the reader forward
            pad = pad_bucket(len(group), B) if self.cfg.pad_buckets else B
            q_ids, rows, para_embeds = self._retrieve(
                questions, query_encoder, candidates=k, pad_rows=pad
            )
            examples = []
            for qa, qi, rr, pe in zip(group, q_ids, rows, para_embeds):
                # -1 padding slots (see _retrieve) clip to row 0
                cand_ids = self.index.id_map.rows_to_ids(np.maximum(rr, 0))
                per_para = []
                for pid in cand_ids[:k]:
                    text = self.db.get_doc_text(pid)
                    p = normalize(text) if text else ""
                    per_para.append(self._tensorize_paragraph(qi, p, matched=[]))
                examples.append({
                    "qid": hash_question(qa["question"]),
                    "question": qa["question"],
                    "answers": qa.get("answer", []),  # serving inputs have no gold
                    "per_para": per_para,
                    "top_labels": np.zeros((k,), np.int32),
                    "para_embed": pe,
                    "q_token_ids": qi,
                })
            yield self._collate_questions(examples, with_targets=False, k=k)
