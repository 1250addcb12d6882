"""ctypes binding for the C++ wordpiece tokenizer (UTF-8, BMP-complete).

Copy of proqa_tpu/native/wordpiece.py: the port keeps its own host code and imports
nothing of the JAX package.

Builds libproqa_wp.so on first use (g++ -O2), caches it next to the source.
The binary is NOT version-controlled: a source hash stored beside it gates
reuse, so the loaded library always corresponds to the checked-in .cpp (an
unauditable stale/foreign binary can never shadow the source).

Per-codepoint unicode tables (classification flags + the composed
strip_accents(lower(ch)) map) are generated here from the SAME `unicodedata`
the pure-Python path uses, so the two paths cannot drift. Codepoints whose
tokenization is not per-character route to the Python fallback:

* U+03A3 GREEK CAPITAL SIGMA — str.lower() is context-sensitive (final sigma)
* multi-codepoint case foldings / NFD expansions (e.g. Hangul syllables)
* kept (non-Mn) combining marks, where NFD canonical reordering is non-local
* astral (> BMP) codepoints and malformed UTF-8

`NativeWordpiece.tokenize` returns wordpiece *strings* (converting back from
ids via the vocab) so it is a drop-in for the Python tokenizer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(__file__), "wordpiece.cpp")
_LIB = os.path.join(os.path.dirname(__file__), "libproqa_wp.so")
_HASH = _LIB + ".srchash"
_BUILD_LOCK = threading.Lock()

_BMP = 0x10000
_WS, _CTRL, _PUNCT, _FALLBACK, _LOWER_FALLBACK = 1, 2, 4, 8, 16
_WS_SPLIT = 32   # str.split() whitespace that is NOT BERT whitespace (Zl/Zp)
_MAP_DELETE = -2


def _src_digest() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build() -> str:
    with _BUILD_LOCK:
        digest = _src_digest()
        cached = os.path.exists(_LIB) and os.path.exists(_HASH) and \
            open(_HASH).read().strip() == digest
        if not cached:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _LIB + ".tmp"],
                check=True, capture_output=True,
            )
            os.replace(_LIB + ".tmp", _LIB)
            with open(_HASH, "w") as f:
                f.write(digest)
    return _LIB


_lib = None
_tables = None


def _build_tables():
    """(flags uint8[BMP], lowmap int32[BMP]) — mirrors text/chars.py exactly."""
    import unicodedata

    import numpy as np

    from proqa_tpu_torch.text.chars import (
        is_control, is_punctuation, is_whitespace, strip_accents,
    )

    flags = np.zeros(_BMP, np.uint8)
    lowmap = np.arange(_BMP, dtype=np.int32)
    for cp in range(_BMP):
        ch = chr(cp)
        f = 0
        if cp == 0 or cp == 0xFFFD or is_control(ch):
            f |= _CTRL
        elif is_whitespace(ch):
            f |= _WS
        elif ch.isspace():
            # Zl/Zp (U+2028/U+2029): not BERT whitespace (Zs-only), but
            # str.split() in whitespace_tokenize DOES split on them — a
            # separate bit because prepare_context's word splitting uses the
            # BERT set while tokenize's uses str.split()'s
            f |= _WS_SPLIT
        if is_punctuation(ch):
            f |= _PUNCT
        cat = unicodedata.category(ch)
        if cat == "Cs":  # lone surrogate — cannot appear in valid UTF-8
            f |= _FALLBACK
        # kept combining marks can reorder non-locally under NFD
        if cat in ("Mc", "Me") or (unicodedata.combining(ch) and cat != "Mn"):
            f |= _FALLBACK
        if not (f & (_CTRL | _WS)):
            if cp == 0x3A3:  # capital sigma: lower() is context-sensitive
                f |= _LOWER_FALLBACK
            else:
                out = strip_accents(ch.lower())
                if len(out) == 1 and ord(out) < _BMP:
                    o = ord(out)
                    # output with a kept nonzero combining class could
                    # reorder with neighbors under the word-level NFD
                    if unicodedata.combining(out) and \
                            unicodedata.category(out) != "Mn":
                        f |= _LOWER_FALLBACK
                    lowmap[cp] = o
                elif len(out) == 0:
                    lowmap[cp] = _MAP_DELETE
                else:  # multi-codepoint (ligatures, Hangul NFD, etc.)
                    f |= _LOWER_FALLBACK
        flags[cp] = f
    return flags, lowmap


def _get_tables():
    global _tables
    if _tables is None:
        _tables = _build_tables()
    return _tables


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build())
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.wp_destroy.argtypes = [ctypes.c_void_p]
        lib.wp_tokenize.restype = ctypes.c_int32
        lib.wp_tokenize.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.wp_prepare.restype = ctypes.c_int32
        lib.wp_prepare.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            i32p, ctypes.c_int32,                  # c2w
            i32p, i32p, i32p, ctypes.c_int32,      # word_starts/lens/o2t
            i32p, i32p, ctypes.c_int32,            # t2o/piece_ids
            i32p,                                  # counts[3]
        ]
        _lib = lib
    return _lib


class NativeWordpiece:
    def __init__(self, vocab: dict, do_lower_case: bool = True):
        lib = _load()
        flags, lowmap = _get_tables()
        blob = "\n".join(vocab.keys()).encode("utf-8")
        self._lib = lib
        self._handle = lib.wp_create(
            blob, int(do_lower_case),
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lowmap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        self._id_to_token = {i: t for t, i in vocab.items()}
        # per-THREAD output buffer: one tokenizer instance is shared across
        # the sampler's worker pool and the train/eval BatchLoader producer
        # threads — a single shared buffer would let concurrent tokenize
        # calls overwrite each other's ids mid-read
        self._tls = threading.local()
        # python fallback for the flagged codepoints
        from proqa_tpu_torch.text.basic import BasicTokenizer
        from proqa_tpu_torch.text.wordpiece import WordpieceTokenizer

        self._py_basic = BasicTokenizer(do_lower_case=do_lower_case)
        self._py_wp = WordpieceTokenizer(vocab)

    def __del__(self):
        try:
            self._lib.wp_destroy(self._handle)
        except Exception:
            pass

    def _py_tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for w in self._py_basic.tokenize(text):
            out.extend(self._py_wp.tokenize(w))
        return out

    def tokenize(self, text: str) -> list[str]:
        try:
            raw = text.encode("utf-8")
        except UnicodeEncodeError:  # lone surrogates in the str
            return self._py_tokenize(text)
        if b"\x00" in raw:
            return self._py_tokenize(text)
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = self._tls.buf = (ctypes.c_int32 * 8192)()
        n = self._lib.wp_tokenize(self._handle, raw, buf, len(buf))
        if n < 0:
            return self._py_tokenize(text)
        if n > len(buf):
            buf = self._tls.buf = (ctypes.c_int32 * (n + 1024))()
            n = self._lib.wp_tokenize(self._handle, raw, buf, len(buf))
        return [self._id_to_token[buf[i]] for i in range(n)]

    def prepare(self, text: str):
        """SQuAD prepare_context in one native call (per-call buffers: safe
        from sampler worker threads). Returns the text/squad.prepare_context
        5-tuple, or None when the text needs the Python path."""
        import numpy as np

        try:
            raw = text.encode("utf-8")
        except UnicodeEncodeError:
            return None
        if b"\x00" in raw:
            return None
        cap = len(text) + 1   # n_cp == len(text) for BMP; pieces <= chars
        bufs = [np.empty(cap, np.int32) for _ in range(6)]
        c2w, ws, wl, o2t, t2o, pid = bufs
        counts = (ctypes.c_int32 * 3)()

        def ptr(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        rc = self._lib.wp_prepare(
            self._handle, raw,
            ptr(c2w), cap, ptr(ws), ptr(wl), ptr(o2t), cap,
            ptr(t2o), ptr(pid), cap, counts,
        )
        if rc != 0:
            return None
        n_cp, n_words, n_pieces = counts[0], counts[1], counts[2]
        starts, lens = ws[:n_words].tolist(), wl[:n_words].tolist()
        doc_tokens = [text[s : s + l] for s, l in zip(starts, lens)]
        pieces = [self._id_to_token[i] for i in pid[:n_pieces].tolist()]
        return (
            doc_tokens,
            c2w[:n_cp].tolist(),
            o2t[:n_words].tolist(),
            t2o[:n_pieces].tolist(),
            pieces,
        )
