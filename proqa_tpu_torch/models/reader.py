"""Joint retrieve-and-read QA model: BERT span reader + retriever rank head.

Counterpart of proqa_tpu/models/reader.py (upstream `BertRetrieveQA`,
qa/bert_retrieve_qa.py:12-176): a reader BERT over [CLS] q [SEP] p [SEP]
inputs with a span head (Dense(H, 2)), the bi-encoder retriever as a
submodule for the rank logits (q_embed · para_embed^T), an optional CLS
selection head (Dense(H, 1)), the loss zoo (`qa_loss`) and the
frozen-parameter masks (`qa_frozen_mask`).

Submodules carry the JAX parameter tree's names (`bert`, `retriever`,
`qa_outputs`, `select_outputs`), so models/convert.py:params_from_jax maps
`init_qa_params`' tree onto `QAModel` with strict loading. The reader BERT
runs fused attention (kernels K2 and K3) where the config asks for it and
the length allows it (models/bert.py); in training mode every dropout site
runs kernel K4 (ops/dropout.py), `qa_drop` on the reader's output included.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from proqa_tpu_torch.models.bert import (
    SEED_RANGE, BertConfig, BertEncoder, Dense, init_parameters,
)
from proqa_tpu_torch.models.retriever import EMBED_DIM, Retriever
from proqa_tpu_torch.ops.dot import dot_f32
from proqa_tpu_torch.ops.dropout import dropout

NEG = -1.0e10  # matches the reference's masked_fill(-1e10)


@dataclasses.dataclass(frozen=True)
class QAConfig:
    shared_norm: bool = False
    separate: bool = False
    add_select: bool = False
    drop_early: bool = False
    qa_drop: float = 0.0


class QAModel(nn.Module):
    def __init__(self, cfg: BertConfig, qcfg: QAConfig, embed_dim: int = EMBED_DIM):
        super().__init__()
        self.cfg, self.qcfg = cfg, qcfg
        self.bert = BertEncoder(cfg)
        self.retriever = Retriever(cfg, embed_dim)
        self.qa_outputs = Dense(cfg.hidden_size, 2)
        if qcfg.add_select:
            self.select_outputs = Dense(cfg.hidden_size, 1)

    def reset_parameters(self, seed: int) -> "QAModel":
        """Random weights drawn as the JAX package draws them (the numbers
        differ: torch.Generator is not jax.random)."""
        init_parameters(self, self.cfg.initializer_range, torch.Generator().manual_seed(seed))
        return self

    def forward(self, batch: dict, *, generator: torch.Generator | None = None) -> dict:
        """qa_forward (reader.py:90-164) over a [B, k, L] batch.

        batch: input_ids / input_mask / segment_ids / paragraph_mask [B, k, L],
        input_ids_q / input_mask_q [B, Tq], and the rank-head candidates as
        para_embed [B, M, D], or para_rows [B, M] with corpus_emb [N, D] (rows
        -1, an under-filled search's slots, gather row 0 as JAX's mode="clip";
        corpus_emb is a constant). Returns start/end logits [B, k, L] f32 (NEG
        outside the paragraph), rank_logits [B, M] f32, q_embed [B, D] f32,
        and select_logits [B, k] f32 with add_select.

        In training mode dropout draws its seeds from `generator` in the
        order of JAX's key split (reader.py:115-119): the reader BERT's, then
        the query tower's, then qa_drop's."""
        b, k, l = batch["input_ids"].shape

        def flat(x):
            return x.reshape(b * k, l)

        seq, pooled = self.bert(flat(batch["input_ids"]), flat(batch["input_mask"]),
                                flat(batch["segment_ids"]), generator=generator)
        q_embed = self.retriever.encode_query(batch["input_ids_q"], batch["input_mask_q"],
                                              generator=generator)
        if self.training and self.qcfg.qa_drop > 0.0:
            if generator is None:
                raise ValueError("training-mode QAModel with qa_drop needs a torch.Generator")
            seed = int(torch.randint(0, SEED_RANGE, (1,), generator=generator))
            seq = dropout(seq, self.qcfg.qa_drop, seed)
        logits = self.qa_outputs(seq, torch.float32)       # [B*k, L, 2]
        in_para = flat(batch["paragraph_mask"]) == 1
        start_logits = torch.where(in_para, logits[..., 0], NEG).reshape(b, k, l)
        end_logits = torch.where(in_para, logits[..., 1], NEG).reshape(b, k, l)

        if "para_embed" in batch:
            para_embed = batch["para_embed"]
        else:
            corpus = batch["corpus_emb"]
            rows = batch["para_rows"].long().clamp(0, corpus.shape[0] - 1)
            para_embed = corpus[rows]
        # f32 x f32 with TF32 off (ops/dot.py:pin_f32_precision), as JAX's
        # preferred_element_type=f32 product of the f32 embeddings
        rank_logits = dot_f32(q_embed[:, None, :], para_embed.float().transpose(1, 2))[:, 0]

        out = {"start_logits": start_logits, "end_logits": end_logits,
               "rank_logits": rank_logits, "q_embed": q_embed}
        if self.qcfg.add_select:
            out["select_logits"] = self.select_outputs(pooled, torch.float32).reshape(b, k)
        return out


def qa_frozen_mask(names, *, freeze_c_encoder: bool = False,
                   freeze_retriever: bool = False) -> dict[str, bool]:
    """{parameter name: frozen} over QAModel's dotted parameter names (the
    JAX package's qa_frozen_mask, reader.py:68-80): the whole retriever with
    freeze_retriever, else its context tower and projection with
    freeze_c_encoder (upstream bert_retrieve_qa.py:48-56)."""
    if freeze_retriever:
        frozen = ("retriever.",)
    elif freeze_c_encoder:
        frozen = ("retriever.bert_c.", "retriever.proj_c.")
    else:
        frozen = ()
    return {name: name.startswith(frozen) for name in names}


# --------------------------------------------------------------------------
# the loss zoo (reader.py:167-262)
# --------------------------------------------------------------------------


def _span_log_probs(start_logits, end_logits, start_pos, end_pos, shared_norm: bool):
    """Log prob of each annotated span: [B, k, L] logits, [B, k, S] positions
    (-1 = padding) -> [B, k, S] log probs, -inf at padded slots."""
    b, k, l = start_logits.shape
    valid = start_pos >= 0
    s_idx, e_idx = start_pos.clamp(min=0), end_pos.clamp(min=0)
    if shared_norm:
        ls = torch.log_softmax(start_logits.reshape(b, k * l), -1).reshape(b, k, l)
        le = torch.log_softmax(end_logits.reshape(b, k * l), -1).reshape(b, k, l)
    else:
        ls, le = torch.log_softmax(start_logits, -1), torch.log_softmax(end_logits, -1)
    sp = torch.gather(ls, -1, s_idx)
    ep = torch.gather(le, -1, e_idx)
    return torch.where(valid, sp + ep, -torch.inf)


def _gold_ce(logits: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    """-log of the softmax mass on the gold entries, 0 where a row has none."""
    gold_lse = torch.logsumexp(torch.where(gold, logits, -torch.inf), -1)
    return torch.where(gold.any(-1), torch.logsumexp(logits, -1) - gold_lse, 0.0)


def qa_loss_keys(qcfg: QAConfig) -> tuple[str, ...]:
    """The keys of qa_loss's result under this configuration, in order."""
    if qcfg.separate:
        return ("span_loss", "early_loss", *(("select_loss",) if qcfg.add_select else ()),
                "loss")
    return ("joint_loss", "early_loss", "loss")


def qa_loss(out: dict, batch: dict, qcfg: QAConfig) -> dict:
    """Total loss (mean over questions) and its components, as the JAX
    package's qa_loss.

    batch targets: start_positions / end_positions [B, k, S] (-1 pad),
    para_targets [B, k] (paragraph covered), top5000_labels [B, M], and an
    optional question_mask [B] that leaves padded questions out of the mean.
    The empty-gold guards give a question no gold a contribution of 0.

    torch.logsumexp's gradient over a row of only -inf is NaN (JAX's is 0),
    but every -inf here enters as the constant branch of a `where`, so that
    NaN lands on the constant and the logits' gradients stay finite."""
    start_logits, end_logits = out["start_logits"], out["end_logits"]
    rank_logits = out["rank_logits"]
    k = start_logits.shape[1]

    early = _gold_ce(rank_logits, batch["top5000_labels"] > 0)
    if qcfg.drop_early:
        early = torch.zeros_like(early)

    span_lp = _span_log_probs(start_logits, end_logits, batch["start_positions"].long(),
                              batch["end_positions"].long(), qcfg.shared_norm)
    marg_lp = torch.logsumexp(span_lp, -1)             # [B, k], -inf where no span
    has_span = torch.isfinite(span_lp).any(-1)         # [B, k]
    any_span = has_span.any(-1)                        # [B]

    if qcfg.separate:
        span_all = torch.logsumexp(torch.where(has_span, marg_lp, -torch.inf), -1)
        span_loss = torch.where(any_span, -span_all, 0.0)
        total = span_loss + early
        components = {"span_loss": span_loss, "early_loss": early}
        if qcfg.add_select:
            select_loss = _gold_ce(out["select_logits"], batch["para_targets"] > 0)
            total = total + select_loss
            components["select_loss"] = select_loss
    else:
        # joint: -log sum_paras P_rank(p) sum_spans P_span(s | p); the rank
        # softmax runs over all M candidates, restricted to the k read ones
        if qcfg.add_select:
            rank_lp_k = torch.log_softmax(out["select_logits"], -1)
        else:
            rank_lp_k = torch.log_softmax(rank_logits, -1)[:, :k]
        joint_lp = torch.where(has_span, marg_lp + rank_lp_k, -torch.inf)
        joint_loss = torch.where(any_span, -torch.logsumexp(joint_lp, -1), 0.0)
        total = joint_loss + early
        components = {"joint_loss": joint_loss, "early_loss": early}

    components["loss"] = total
    qmask = batch.get("question_mask")
    if qmask is None:
        return {key: value.mean() for key, value in components.items()}
    qmask = qmask.float()
    denom = qmask.sum().clamp(min=1.0)
    return {key: (value * qmask).sum() / denom for key, value in components.items()}


def decode_spans(start_logits: torch.Tensor, end_logits: torch.Tensor,
                 max_answer_len: int = 10):
    """Best span per paragraph under the band 0 <= end - start <=
    max_answer_len (reader.py:271-287). [B, k, L] logits -> (start [B, k],
    end [B, k], score [B, k]); ties go to the first index, as JAX's argmax."""
    l = start_logits.shape[-1]
    scores = start_logits[..., :, None] + end_logits[..., None, :]   # [B, k, L, L]
    i = torch.arange(l, device=scores.device)
    band = (i[None, :] >= i[:, None]) & (i[None, :] <= i[:, None] + max_answer_len)
    scores = torch.where(band, scores, NEG)
    best_end_per_start = scores.amax(dim=-1)                         # [B, k, L]
    start = torch.argmax(best_end_per_start, dim=-1)                 # [B, k]
    score = best_end_per_start.amax(dim=-1)
    end_idx = torch.argmax(scores, dim=-1)                           # [B, k, L]
    end = torch.gather(end_idx, -1, start[..., None])[..., 0]
    return start, end, score
