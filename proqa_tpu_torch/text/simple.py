"""Span-preserving word tokenizer used for answer string matching.

Copy of proqa_tpu/text/simple.py: the port keeps its own host code and imports
nothing of the JAX package.

Equivalent of the DrQA SimpleTokenizer/Tokens machinery the reference vendors
(upstream qa/basic_tokenizer.py:12-271): tokens keep their [start, end)
character spans and trailing whitespace so matched token ranges can be
projected back to the original string (`untokenize`). Uses the `regex` module
for unicode property classes, with an `re`-based approximation as fallback.
"""
from __future__ import annotations

from dataclasses import dataclass

try:
    import regex as _re

    _ALPHA_NUM = r"[\p{L}\p{N}\p{M}]+"
    _NON_WS = r"[^\p{Z}\p{C}]"
    _PATTERN = _re.compile(
        f"({_ALPHA_NUM})|({_NON_WS})",
        flags=_re.IGNORECASE + _re.UNICODE + _re.MULTILINE,
    )
except ImportError:  # pragma: no cover - regex is present in the image
    import re as _re

    # Approximate \p{L}\p{N}\p{M} with stdlib re: [^\W_] is \w minus '_'
    # (the reference's class excludes underscore), plus the combining-mark
    # blocks so NFD-normalized text ('café' -> 'café', which the
    # matchers always produce) stays one token instead of splitting at every
    # accent. Same IGNORECASE+MULTILINE flags as the reference compile.
    _MARKS = "̀-ͯ҃-҉֑-ֽؐ-ؚ" \
             "ً-ٰٟۖ-ۜऀ-ः़" \
             "ัิ-ฺ็-๎᪰-᫿᷀-᷿" \
             "⃐-⃿︠-︯"
    _ALNUM_RE = rf"(?:[^\W_]|[{_MARKS}])+"
    _PATTERN = _re.compile(
        rf"({_ALNUM_RE})|([^\s])",
        flags=_re.IGNORECASE | _re.UNICODE | _re.MULTILINE,
    )


@dataclass(frozen=True)
class _Tok:
    text: str
    text_ws: str  # token text plus trailing whitespace up to the next token
    span: tuple[int, int]


class Tokens:
    """A tokenized string supporting slicing and lossless de-tokenization."""

    def __init__(self, toks: list[_Tok]):
        self._toks = toks

    def __len__(self) -> int:
        return len(self._toks)

    def words(self, uncased: bool = False) -> list[str]:
        if uncased:
            return [t.text.lower() for t in self._toks]
        return [t.text for t in self._toks]

    def offsets(self) -> list[tuple[int, int]]:
        return [t.span for t in self._toks]

    def slice(self, i: int | None = None, j: int | None = None) -> "Tokens":
        return Tokens(self._toks[i:j])

    def untokenize(self) -> str:
        return "".join(t.text_ws for t in self._toks).strip()


class SimpleTokenizer:
    def tokenize(self, text: str) -> Tokens:
        matches = list(_PATTERN.finditer(text))
        toks = []
        for i, m in enumerate(matches):
            start, end = m.span()
            ws_end = matches[i + 1].span()[0] if i + 1 < len(matches) else end
            toks.append(_Tok(m.group(), text[start:ws_end], (start, end)))
        return Tokens(toks)

    def shutdown(self):  # kept for pool-Finalize API compatibility
        pass


class RegexpTokenizer:
    """Rule-based tokenizer with token-type normalization (quotes/dashes/
    ellipses), the DrQA RegexpTokenizer equivalent (reference
    qa/basic_tokenizer.py:149-229). Requires the `regex` module."""

    _DIGIT = r"\p{Nd}+([:\.\,]\p{Nd}+)*"
    _TITLE = r"(dr|esq|hon|jr|mr|mrs|ms|prof|rev|sr|st|rt|messrs|mmes|msgr)\.(?=\p{Z})"
    _ABBRV = r"([\p{L}]\.){2,}(?=\p{Z}|$)"
    _ALPHA_NUM = r"[\p{L}\p{N}\p{M}]++"
    _HYPHEN = rf"{_ALPHA_NUM}([-֊‐‑]{_ALPHA_NUM})+"
    _NEGATION = r"((?!n't)[\p{L}\p{N}\p{M}])++(?=n't)|n't"
    _CONTR1 = r"can(?=not\b)"
    _CONTR2 = r"'([tsdm]|re|ll|ve)\b"
    _START_DQ = r'(?<=[\p{Z}\(\[{<]|^)(``|["“«])(?!\p{Z})'
    _START_SQ = r"(?<=[\p{Z}\(\[{<]|^)[\'‘‛‹](?!\p{Z})"
    _END_DQ = r'(?<!\p{Z})(\'\'|["”»])'
    _END_SQ = r"(?<!\p{Z})[\'’›]"
    _DASH = r"--|[–—―]"
    _ELLIPSES = r"\.\.\.|…"
    _PUNCT = r"\p{P}"
    _NON_WS = r"[^\p{Z}\p{C}]"

    _SUBS = {
        "sdquote": "``", "edquote": "''", "ssquote": "`", "esquote": "'",
        "dash": "--", "ellipses": "...",
    }

    def __init__(self, substitutions: bool = True):
        import regex as re_mod

        self._regexp = re_mod.compile(
            f"(?P<digit>{self._DIGIT})|(?P<title>{self._TITLE})|"
            f"(?P<abbr>{self._ABBRV})|(?P<neg>{self._NEGATION})|"
            f"(?P<hyph>{self._HYPHEN})|(?P<contr1>{self._CONTR1})|"
            f"(?P<alphanum>{self._ALPHA_NUM})|(?P<contr2>{self._CONTR2})|"
            f"(?P<sdquote>{self._START_DQ})|(?P<edquote>{self._END_DQ})|"
            f"(?P<ssquote>{self._START_SQ})|(?P<esquote>{self._END_SQ})|"
            f"(?P<dash>{self._DASH})|(?P<ellipses>{self._ELLIPSES})|"
            f"(?P<punct>{self._PUNCT})|(?P<nonws>{self._NON_WS})",
            flags=re_mod.IGNORECASE + re_mod.UNICODE + re_mod.MULTILINE,
        )
        self.substitutions = substitutions

    def tokenize(self, text: str) -> Tokens:
        matches = list(self._regexp.finditer(text))
        toks = []
        for i, m in enumerate(matches):
            token = m.group()
            if self.substitutions:
                for group, sub in self._SUBS.items():
                    if m.groupdict().get(group):
                        token = sub
                        break
            start, end = m.span()
            ws_end = matches[i + 1].span()[0] if i + 1 < len(matches) else end
            toks.append(_Tok(token, text[start:ws_end], (start, end)))
        return Tokens(toks)

    def shutdown(self):
        pass
