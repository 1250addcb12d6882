"""Official open-QA answer metrics (SQuAD/MRQA-style EM, F1, regex match).

Copy of proqa_tpu/text/metrics.py: the port keeps its own host code and imports
nothing of the JAX package.

Equivalent of upstream qa/official_eval.py:20-112. Pure functions,
golden-tested in tests/test_text.py (TestMetrics) and executed against the
reference's own official_eval in tests/test_reference_exec.py.
"""
from __future__ import annotations

import re
import string
from collections import Counter

_ARTICLES = re.compile(r"\b(a|an|the)\b")
_PUNCT = set(string.punctuation)


def normalize_answer(s: str) -> str:
    """Lowercase, strip punctuation/articles, squash whitespace."""
    s = "".join(ch for ch in s.lower() if ch not in _PUNCT)
    s = _ARTICLES.sub(" ", s)
    return " ".join(s.split())


def exact_match_score(prediction: str, ground_truth: str) -> bool:
    return normalize_answer(prediction) == normalize_answer(ground_truth)


def f1_score(prediction: str, ground_truth: str) -> float:
    pred_toks = normalize_answer(prediction).split()
    gold_toks = normalize_answer(ground_truth).split()
    overlap = sum((Counter(pred_toks) & Counter(gold_toks)).values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(pred_toks)
    recall = overlap / len(gold_toks)
    return 2 * precision * recall / (precision + recall)


def regex_match_score(prediction: str, pattern: str) -> bool:
    """CuratedTrec answers are regexes; a prediction matching counts as EM."""
    try:
        compiled = re.compile(pattern, flags=re.IGNORECASE | re.UNICODE | re.MULTILINE)
    except re.error:
        return False
    return compiled.match(prediction) is not None


def metric_max_over_ground_truths(metric_fn, prediction: str, ground_truths) -> float:
    return max(metric_fn(prediction, gt) for gt in ground_truths)


def evaluate_predictions(answers: dict, predictions: dict, skip_no_answer: bool = False) -> dict:
    """answers: qid -> list of gold strings; predictions: qid -> string."""
    em = f1 = total = 0.0
    for qid, ground_truths in answers.items():
        if qid not in predictions:
            if not skip_no_answer:
                total += 1
            continue
        total += 1
        pred = predictions[qid]
        em += metric_max_over_ground_truths(exact_match_score, pred, ground_truths)
        f1 += metric_max_over_ground_truths(f1_score, pred, ground_truths)
    if total == 0:
        return {"exact_match": 0.0, "f1": 0.0}
    return {"exact_match": 100.0 * em / total, "f1": 100.0 * f1 / total}
