"""BERT basic tokenization: cleanup, lowercasing, accent stripping,

Copy of proqa_tpu/text/basic.py: the port keeps its own host code and imports
nothing of the JAX package.
punctuation splitting.

Behavior-compatible with the Google BERT BasicTokenizer the reference vendors
(upstream qa/tokenizer.py:86-153), used both as the first stage of
wordpiece encoding and by answer detokenization (eval_utils.get_final_text).
"""
from proqa_tpu_torch.text.chars import clean_text, is_punctuation, strip_accents, whitespace_tokenize


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> list[str]:
        text = clean_text(text)
        tokens: list[str] = []
        for word in whitespace_tokenize(text):
            if self.do_lower_case:
                word = strip_accents(word.lower())
            tokens.extend(self._split_on_punct(word))
        # Re-split to drop any empties produced by punct splitting.
        return whitespace_tokenize(" ".join(tokens))

    @staticmethod
    def _split_on_punct(word: str) -> list[str]:
        pieces: list[str] = []
        word_open = False
        for ch in word:
            if is_punctuation(ch):
                pieces.append(ch)
                word_open = False
            else:
                if not word_open:
                    pieces.append("")
                    word_open = True
                pieces[-1] += ch
        return pieces
