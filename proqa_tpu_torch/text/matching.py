"""Weak-supervision answer matching in paragraphs (string and regex modes).

Copy of proqa_tpu/text/matching.py: the port keeps its own host code and imports
nothing of the JAX package.

Equivalent of upstream qa/prepro_dense.py:30-74 and
upstream retrieval/eval_retrieval.py:27-45: decide whether a paragraph
contains a gold answer (recall scoring) and recover the exact matched surface
strings (span supervision for the reader).
"""
from __future__ import annotations

import re
import unicodedata

from proqa_tpu_torch.text.simple import SimpleTokenizer


def _native_matcher(tokenizer):
    """C++ fast path (native/simple_match.cpp), valid only for the plain
    SimpleTokenizer (RegexpTokenizer has different token rules)."""
    if type(tokenizer) is not SimpleTokenizer:
        return None
    from proqa_tpu_torch.native.simple_match import get_matcher

    return get_matcher()


def normalize(text: str) -> str:
    """NFD-normalize unicode; applied to both paragraphs and answers so
    byte-level comparisons line up (reference qa/prepro_utils.py:16-18)."""
    return unicodedata.normalize("NFD", text)


def normalize_para(s: str) -> str:
    return " ".join(s.lower().split())


def regex_match(text: str, pattern: str) -> list[str]:
    """All distinct substrings of `text` matching `pattern`."""
    try:
        compiled = re.compile(pattern, flags=re.IGNORECASE | re.UNICODE | re.MULTILINE)
    except re.error:
        return []
    return list({m.group() for m in compiled.finditer(text)})


def para_has_answer(paragraph: str, answers, tokenizer: SimpleTokenizer) -> tuple[bool, str]:
    """Uncased token-subsequence containment of any gold answer.

    Returns (covered, first matched surface string). Both sides are NFD
    normalized and word-tokenized; comparison is on lowercased words.
    """
    nat = _native_matcher(tokenizer)
    if nat is not None:
        res = nat.match(
            normalize(paragraph), [normalize(a) for a in answers], first_only=True
        )
        if res is not None:
            return (True, res[0]) if res else (False, "")
    toks = tokenizer.tokenize(normalize(paragraph))
    words = toks.words(uncased=True)
    for ans in answers:
        ans_words = tokenizer.tokenize(normalize(ans)).words(uncased=True)
        # NB: an answer tokenizing to [] matches vacuously at i=0 — the
        # reference's exact behavior (eval_retrieval.py:36-39, found by the
        # reference-executed oracle tests), kept for parity
        for i in range(len(words) - len(ans_words) + 1):
            if words[i : i + len(ans_words)] == ans_words:
                return True, toks.slice(i, i + len(ans_words)).untokenize()
    return False, ""


def match_answer_span(paragraph: str, answers, tokenizer: SimpleTokenizer, match: str = "string") -> list[str]:
    """All distinct matched surface strings of the answers in the paragraph.

    `paragraph` is assumed already normalized (the caller NFD-normalizes once);
    `match="regex"` treats answers[0] as a regex (CuratedTrec convention).
    """
    if match == "regex":
        # drop empty-string matches (nullable patterns like '\d*' match ''
        # at every position): same deliberate train-path divergence as the
        # empty ans_words guard below — '' would enumerate len(p) char spans
        # and mark every paragraph covered with garbage span targets
        return [m for m in regex_match(paragraph, normalize(answers[0])) if m]
    nat = _native_matcher(tokenizer)
    if nat is not None:
        res = nat.match(paragraph, [normalize(a) for a in answers], first_only=False)
        if res is not None:
            return list(set(res))
    toks = tokenizer.tokenize(paragraph)
    words = toks.words(uncased=True)
    found: set[str] = set()
    for ans in answers:
        ans_words = tokenizer.tokenize(normalize(ans)).words(uncased=True)
        if not ans_words:
            # DELIBERATE divergence from the reference here (prepro_dense.py:
            # 61-69 vacuously matches "" at every position): a matched ""
            # would enumerate len(p) char spans per paragraph in the train
            # sampler and mark every paragraph covered with garbage span
            # targets. Recall scoring (para_has_answer above) keeps the
            # reference's vacuous-match semantics, pinned by the
            # reference-executed oracle test.
            continue
        for i in range(len(words) - len(ans_words) + 1):
            if words[i : i + len(ans_words)] == ans_words:
                found.add(toks.slice(i, i + len(ans_words)).untokenize())
    return list(found)
