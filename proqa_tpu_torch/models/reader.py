"""Joint retrieve-and-read QA model: BERT span reader + retriever rank head.

Counterpart of proqa_tpu/models/reader.py (upstream `BertRetrieveQA`,
qa/bert_retrieve_qa.py:12-176), the inference half: a reader BERT over
[CLS] q [SEP] p [SEP] inputs with a span head (Dense(H, 2)), the bi-encoder
retriever as a submodule for the rank logits (q_embed · para_embed^T), and an
optional CLS selection head (Dense(H, 1)).

Submodules carry the JAX parameter tree's names (`bert`, `retriever`,
`qa_outputs`, `select_outputs`), so models/convert.py:params_from_jax maps
`init_qa_params`' tree onto `QAModel` with strict loading. The reader BERT
runs fused attention (kernel K2) where the config asks for it and the length
allows it (models/bert.py). The loss zoo and the frozen-parameter masks come
with QA training (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from proqa_tpu_torch.models.bert import BertConfig, BertEncoder, Dense, init_parameters
from proqa_tpu_torch.models.retriever import EMBED_DIM, Retriever
from proqa_tpu_torch.ops.dot import dot_f32

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

    def forward(self, batch: dict) -> dict:
        """qa_forward (reader.py:90-164) in eval mode over a [B, k, L] batch.

        batch: input_ids / input_mask / segment_ids / paragraph_mask [B, k, L],
        input_ids_q / input_mask_q [B, Tq], and the rank-head candidates as
        para_embed [B, M, D], or para_rows [B, M] with corpus_emb [N, D] (rows
        -1, an under-filled search's slots, gather row 0 as JAX's mode="clip").
        Returns start/end logits [B, k, L] f32 (NEG outside the paragraph),
        rank_logits [B, M] f32, q_embed [B, D] f32, and select_logits [B, k]
        f32 with add_select."""
        b, k, l = batch["input_ids"].shape

        def flat(x):
            return x.reshape(b * k, l)

        seq, pooled = self.bert(flat(batch["input_ids"]), flat(batch["input_mask"]),
                                flat(batch["segment_ids"]))
        logits = self.qa_outputs(seq, torch.float32)       # [B*k, L, 2]
        in_para = flat(batch["paragraph_mask"]) == 1
        start_logits = torch.where(in_para, logits[..., 0], NEG).reshape(b, k, l)
        end_logits = torch.where(in_para, logits[..., 1], NEG).reshape(b, k, l)

        q_embed = self.retriever.encode_query(batch["input_ids_q"], batch["input_mask_q"])
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
