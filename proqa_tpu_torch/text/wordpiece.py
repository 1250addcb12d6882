"""Standalone BERT wordpiece tokenizer (no HuggingFace / tensorflow deps).

Copy of proqa_tpu/text/wordpiece.py: the port keeps its own host code and imports
nothing of the JAX package.

Replaces the reference's use of transformers.BertTokenizer (imported all over,
e.g. upstream retrieval/train_retriever.py:107,
upstream qa/online_sampler.py:13) with an in-repo implementation so the
TPU data pipeline has no framework dependency. The greedy longest-match-first
wordpiece algorithm is the standard public one; outputs are id-for-id
compatible with BERT vocab files.

A C++ fast path (proqa_tpu_torch/native) is used transparently when built; the pure
Python implementation here is the reference and fallback.
"""
from __future__ import annotations

import os
from collections import OrderedDict

from proqa_tpu_torch.text.basic import BasicTokenizer

UNK = "[UNK]"
CLS = "[CLS]"
SEP = "[SEP]"
PAD = "[PAD]"
MASK = "[MASK]"


def load_vocab(vocab_file: str) -> "OrderedDict[str, int]":
    vocab: OrderedDict[str, int] = OrderedDict()
    with open(vocab_file, encoding="utf-8") as f:
        for idx, line in enumerate(f):
            token = line.rstrip("\n")
            if token:
                vocab[token] = idx
    return vocab


class WordpieceTokenizer:
    """Greedy longest-match-first subword splitting over a fixed vocab."""

    def __init__(self, vocab, unk_token: str = UNK, max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, word: str) -> list[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: list[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


class BertTokenizer:
    """Basic + wordpiece tokenization with BERT special-token conventions.

    API mirrors the subset of transformers.BertTokenizer the reference uses:
    tokenize / convert_tokens_to_ids / encode(text, max_length) (which adds
    [CLS]/[SEP] and truncates like transformers 2.x did), plus encode_pair for
    reader inputs ([CLS] q [SEP] p [SEP] with segment ids).
    """

    def __init__(self, vocab, do_lower_case: bool = True, use_native: bool = True):
        if isinstance(vocab, (str, os.PathLike)):
            vocab = load_vocab(vocab)
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.basic = BasicTokenizer(do_lower_case=do_lower_case)
        self.wordpiece = WordpieceTokenizer(vocab)
        self.do_lower_case = do_lower_case
        self.pad_id = vocab.get(PAD, 0)
        self.unk_id = vocab.get(UNK, 0)
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self._native = None
        if use_native:
            try:
                from proqa_tpu_torch.native import wordpiece as native_wp

                self._native = native_wp.NativeWordpiece(vocab, do_lower_case)
            except Exception:
                self._native = None

    @classmethod
    def from_vocab_file(cls, vocab_file: str, do_lower_case: bool = True) -> "BertTokenizer":
        return cls(load_vocab(vocab_file), do_lower_case=do_lower_case)

    def tokenize(self, text: str) -> list[str]:
        if self._native is not None:
            return self._native.tokenize(text)
        out: list[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(word))
        return out

    def convert_tokens_to_ids(self, tokens: list[str]) -> list[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    def convert_ids_to_tokens(self, ids) -> list[str]:
        return [self.ids_to_tokens.get(int(i), UNK) for i in ids]

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        """[CLS] tokens [SEP], truncated so total length <= max_length."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if max_length is not None and len(ids) > max_length - 2:
            ids = ids[: max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def encode_pair(
        self, text_a: str, text_b: str, max_length: int, max_a_length: int
    ) -> tuple[list[int], list[int]]:
        """[CLS] a [SEP] b [SEP] with segment ids (0s then 1s).

        Mirrors OnlineSampler._join_sents + truncation
        (upstream qa/online_sampler.py:211-214,344-353): the first
        segment is truncated to max_a_length total, the second to fit
        max_length.
        """
        a = self.encode(text_a, max_length=max_a_length)
        b = self.convert_tokens_to_ids(self.tokenize(text_b))
        max_b = max_length - len(a) - 1
        if len(b) > max_b:
            b = b[:max_b]
        ids = a + b + [self.sep_id]
        segments = [0] * len(a) + [1] * (len(b) + 1)
        return ids, segments
