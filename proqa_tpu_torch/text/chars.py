"""Character-class helpers shared by the tokenizers.

Copy of proqa_tpu/text/chars.py: the port keeps its own host code and imports
nothing of the JAX package.

Same classification rules as the BERT reference tokenization code the
reference vendors (see upstream qa/tokenizer.py:63-169), so that
wordpiece offsets line up exactly with checkpoints trained on BERT vocab.
"""
import unicodedata

_WS_CHARS = frozenset(" \t\n\r")


def is_whitespace(ch: str) -> bool:
    """Tab/newline/CR count as whitespace (they are rendered as such)."""
    if ch in _WS_CHARS:
        return True
    return unicodedata.category(ch) == "Zs"


def is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def is_punctuation(ch: str) -> bool:
    """All non-letter/number ASCII is treated as punctuation (incl. ^ $ `)."""
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def whitespace_tokenize(text: str) -> list[str]:
    text = text.strip()
    if not text:
        return []
    return text.split()


def clean_text(text: str) -> str:
    """Drop invalid/control chars, canonicalize whitespace to ' '."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or is_control(ch):
            continue
        out.append(" " if is_whitespace(ch) else ch)
    return "".join(out)


def strip_accents(text: str) -> str:
    return "".join(
        ch for ch in unicodedata.normalize("NFD", text)
        if unicodedata.category(ch) != "Mn"
    )
