"""SQuAD-style offset machinery: char -> word -> wordpiece span mapping and
projection of wordpiece predictions back to original text.

Copy of proqa_tpu/text/squad.py: the port keeps its own host code and imports
nothing of the JAX package.

Equivalent of upstream qa/prepro_utils.py:62-175 (prepare,
find_ans_span_with_char_offsets, _improve_answer_span) and
upstream qa/eval_utils.py:15-82 (get_final_text). These are pure
host-side functions; the reader consumes/produces only the integer spans.
"""
from __future__ import annotations

from proqa_tpu_torch.text.basic import BasicTokenizer
from proqa_tpu_torch.text.chars import is_whitespace, whitespace_tokenize


def prepare_context(context: str, tokenizer):
    """Split context on whitespace into words, then wordpiece each word,
    keeping every offset map needed for span supervision and recovery.

    Returns (doc_tokens, char_to_word_offset, orig_to_tok_index,
    tok_to_orig_index, all_doc_tokens) where
      doc_tokens[i]            = i-th whitespace word,
      char_to_word_offset[c]   = word index containing char c,
      orig_to_tok_index[i]     = index of word i's first wordpiece,
      tok_to_orig_index[j]     = word index of wordpiece j,
      all_doc_tokens[j]        = j-th wordpiece.

    Uses the native C++ single-call path (wp_prepare) when the tokenizer has
    one — the pure-Python loop below was the QA sampler's largest host cost
    (~60% of per-paragraph time on a 1-core host).
    """
    native = getattr(tokenizer, "_native", None)
    if native is not None:
        r = native.prepare(context)
        if r is not None:
            return r
    doc_tokens: list[str] = []
    char_to_word_offset: list[int] = []
    in_word = False
    for ch in context:
        if is_whitespace(ch):
            in_word = False
        else:
            if in_word:
                doc_tokens[-1] += ch
            else:
                doc_tokens.append(ch)
                in_word = True
        char_to_word_offset.append(len(doc_tokens) - 1)

    orig_to_tok_index: list[int] = []
    tok_to_orig_index: list[int] = []
    all_doc_tokens: list[str] = []
    for i, word in enumerate(doc_tokens):
        orig_to_tok_index.append(len(all_doc_tokens))
        for piece in tokenizer.tokenize(word):
            tok_to_orig_index.append(i)
            all_doc_tokens.append(piece)
    return doc_tokens, char_to_word_offset, orig_to_tok_index, tok_to_orig_index, all_doc_tokens


def improve_answer_span(
    doc_tokens: list[str], input_start: int, input_end: int, tokenizer, orig_answer_text: str
) -> tuple[int, int]:
    """Shrink a word-aligned span to the tightest wordpiece span whose joined
    text equals the tokenized answer (drops stray punctuation wordpieces)."""
    target = " ".join(tokenizer.tokenize(orig_answer_text))
    for new_start in range(input_start, input_end + 1):
        for new_end in range(input_end, new_start - 1, -1):
            if " ".join(doc_tokens[new_start : new_end + 1]) == target:
                return new_start, new_end
    return input_start, input_end


def find_answer_spans(
    answer_text: str,
    char_spans,
    char_to_word_offset: list[int],
    doc_tokens: list[str],
    all_doc_tokens: list[str],
    orig_to_tok_index: list[int],
    tokenizer,
    verbose: bool = False,
) -> list[tuple[int, int]]:
    """Map [char_start, char_end] (inclusive) spans to wordpiece spans.

    char_end points at the answer's last character (reference convention,
    qa/prepro_utils.py:81).
    """
    spans: list[tuple[int, int]] = []
    for char_start, char_end in char_spans:
        word_start = char_to_word_offset[char_start]
        word_end = char_to_word_offset[char_end]
        sub_start = orig_to_tok_index[word_start]
        if word_end < len(doc_tokens) - 1:
            sub_end = orig_to_tok_index[word_end + 1] - 1
        else:
            sub_end = len(all_doc_tokens) - 1

        if verbose:
            actual = " ".join(doc_tokens[word_start : word_end + 1])
            cleaned = " ".join(whitespace_tokenize(answer_text))
            if actual.find(cleaned) == -1:
                print(f"Could not find answer: '{actual}' vs. '{cleaned}'")

        spans.append(improve_answer_span(all_doc_tokens, sub_start, sub_end, tokenizer, answer_text))
    return spans


def char_spans_of(text: str, needle: str) -> list[tuple[int, int]]:
    """All (possibly overlapping) [start, end] (inclusive) occurrences of
    needle in text. str.find loop, not per-position startswith: the naive
    scan was ~9% of the QA sampler's per-paragraph host time."""
    if not needle:
        return [(i, i - 1) for i in range(len(text))]
    starts = []
    i = text.find(needle)
    while i != -1:
        starts.append(i)
        i = text.find(needle, i + 1)
    return [(s, s + len(needle) - 1) for s in starts]


def get_final_text(
    pred_text: str, orig_text: str, do_lower_case: bool = False, verbose: bool = False
) -> str:
    """Project a detokenized wordpiece prediction back onto the original text.

    Aligns the basic-tokenized original with the prediction via their
    whitespace-stripped character sequences; falls back to orig_text whenever
    the heuristic alignment fails (same fallbacks as the SQuAD reference).
    """

    def strip_spaces(text: str):
        chars: list[str] = []
        ns_to_orig: dict[int, int] = {}
        for i, ch in enumerate(text):
            if ch == " ":
                continue
            ns_to_orig[len(chars)] = i
            chars.append(ch)
        return "".join(chars), ns_to_orig

    tok_text = " ".join(BasicTokenizer(do_lower_case=do_lower_case).tokenize(orig_text))
    start = tok_text.find(pred_text)
    if start == -1:
        if verbose:
            print(f"Unable to find text: '{pred_text}' in '{orig_text}'")
        return orig_text
    end = start + len(pred_text) - 1

    orig_ns, orig_ns_to_orig = strip_spaces(orig_text)
    tok_ns, tok_ns_to_tok = strip_spaces(tok_text)
    if len(orig_ns) != len(tok_ns):
        return orig_text

    tok_to_ns = {tok_i: ns_i for ns_i, tok_i in tok_ns_to_tok.items()}

    def project(tok_pos: int):
        ns_pos = tok_to_ns.get(tok_pos)
        if ns_pos is None:
            return None
        return orig_ns_to_orig.get(ns_pos)

    orig_start = project(start)
    orig_end = project(end)
    if orig_start is None or orig_end is None:
        return orig_text
    return orig_text[orig_start : orig_end + 1]


def wordpieces_to_text(pieces: list[str]) -> str:
    """Join wordpieces into plain text ('##' continuation stripped)."""
    text = " ".join(pieces).replace(" ##", "").replace("##", "").strip()
    return " ".join(text.split())
