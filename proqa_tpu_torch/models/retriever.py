"""Two-tower dense retriever (bi-encoder) with 128-d projections.

Counterpart of proqa_tpu/models/retriever.py: separate question and context
BERT towers, each followed by a Linear(hidden, 128) over the pooled CLS
output. The projection multiplies in the activation dtype and accumulates in
f32, and the f32 bias gives f32 embeddings.
"""
from __future__ import annotations

import torch
from torch import nn

from proqa_tpu_torch.models.bert import BertConfig, BertEncoder, Dense, init_parameters

EMBED_DIM = 128  # the reference hardcodes 128


class Retriever(nn.Module):
    def __init__(self, cfg: BertConfig, embed_dim: int = EMBED_DIM):
        super().__init__()
        self.cfg = cfg
        self.bert_q = BertEncoder(cfg)
        self.bert_c = BertEncoder(cfg)
        self.proj_q = Dense(cfg.hidden_size, embed_dim)
        self.proj_c = Dense(cfg.hidden_size, embed_dim)

    def reset_parameters(self, seed: int) -> "Retriever":
        """Random weights drawn as the JAX package draws them (the numbers
        differ: torch.Generator is not jax.random)."""
        init_parameters(self, self.cfg.initializer_range, torch.Generator().manual_seed(seed))
        return self

    def encode_query(self, input_ids, attention_mask, *, generator=None) -> torch.Tensor:
        """[B, T] -> [B, embed_dim] f32 query embeddings."""
        _, pooled = self.bert_q(input_ids, attention_mask, generator=generator)
        return self.proj_q(pooled, torch.float32)

    def encode_context(self, input_ids, attention_mask, *, generator=None) -> torch.Tensor:
        """[B, T] -> [B, embed_dim] f32 paragraph embeddings."""
        _, pooled = self.bert_c(input_ids, attention_mask, generator=generator)
        return self.proj_c(pooled, torch.float32)

    def forward(self, batch: dict, *, generator: torch.Generator | None = None) -> dict:
        """The JAX package's retriever_forward: both towers on a paired batch,
        {"q": [B, D], "c": [B, D]}. In training mode each tower draws its own
        dropout seeds from `generator`, the query tower first
        (retriever.py:80-101); eval is deterministic."""
        return {
            "q": self.encode_query(batch["input_ids_q"], batch["input_mask_q"],
                                   generator=generator),
            "c": self.encode_context(batch["input_ids_c"], batch["input_mask_c"],
                                     generator=generator),
        }
