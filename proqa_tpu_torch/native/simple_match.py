"""ctypes binding for the C++ SimpleTokenizer span matcher.

Copy of proqa_tpu/native/simple_match.py: the port keeps its own host code and imports
nothing of the JAX package.

Builds libproqa_sm.so on first use (g++ -O2), cached next to the source and
gated by a source hash (same scheme as native/wordpiece.py: a stale or
foreign binary can never shadow the checked-in .cpp).

The per-codepoint classification tables are probed from the SAME
`regex`-module character classes the Python SimpleTokenizer compiles
(text/simple.py: ([\\p{L}\\p{N}\\p{M}]+)|([^\\p{Z}\\p{C}])), so the native and
Python tokenizations cannot drift even across regex-module Unicode versions.
Lowercasing uses str.lower per codepoint; codepoints where that is not a
1:1 BMP map (U+03A3 final sigma, U+0130, ligature expansions, astral) are
flagged and the whole call routes to the Python fallback.

The binding exposes `match`: the full tokenize + lowercased subsequence
search + surface recovery for one paragraph against its answer list — one
native call per (paragraph, answers) pair, replacing ~10 Python-level
tokenize/compare passes. Returns None when the inputs need the Python path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(__file__), "simple_match.cpp")
_LIB = os.path.join(os.path.dirname(__file__), "libproqa_sm.so")
_HASH = _LIB + ".srchash"
_BUILD_LOCK = threading.Lock()

_BMP = 0x10000
_ALNUM, _INVIS, _STRIPWS, _FALLBACK = 1, 2, 4, 8


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
    """Probe the regex-module classes the Python tokenizer actually uses."""
    import numpy as np
    import regex

    alnum = regex.compile(r"[\p{L}\p{N}\p{M}]", flags=regex.UNICODE)
    invis = regex.compile(r"[\p{Z}\p{C}]", flags=regex.UNICODE)

    flags = np.zeros(_BMP, np.uint8)
    lowmap = np.arange(_BMP, dtype=np.int32)
    for cp in range(_BMP):
        ch = chr(cp)
        f = 0
        if alnum.match(ch):
            f |= _ALNUM
        if invis.match(ch):
            f |= _INVIS
        if ch.isspace():
            f |= _STRIPWS
        low = ch.lower()
        if cp == 0x3A3:  # capital sigma: str.lower() is context-sensitive
            f |= _FALLBACK
        elif len(low) != 1 or ord(low) >= _BMP:
            f |= _FALLBACK
        else:
            lowmap[cp] = ord(low)
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
        lib.sm_create.restype = ctypes.c_void_p
        lib.sm_create.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sm_destroy.argtypes = [ctypes.c_void_p]
        lib.sm_match.restype = ctypes.c_int32
        lib.sm_match.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        _lib = lib
    return _lib


class NativeSimpleMatch:
    def __init__(self):
        lib = _load()
        flags, lowmap = _get_tables()
        self._lib = lib
        self._handle = lib.sm_create(
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lowmap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )

    def __del__(self):
        try:
            self._lib.sm_destroy(self._handle)
        except Exception:
            pass

    def match(self, para: str, answers: list[str], first_only: bool) -> list[str] | None:
        """Matched surface strings of `answers` in `para` (both already
        NFD-normalized). first_only=True is para_has_answer semantics (stop
        at first match, vacuous empty-answer match); False is
        match_answer_span semantics (all matches, duplicates included — the
        caller dedups). None -> caller must use the Python path."""
        try:
            raw = para.encode("utf-8")
            ans_raws = [a.encode("utf-8") for a in answers]
        except UnicodeEncodeError:  # lone surrogates
            return None
        if b"\x00" in raw or any(b"\x00" in a for a in ans_raws):
            return None
        blob = b"".join(ans_raws)
        off = [0]
        for a in ans_raws:
            off.append(off[-1] + len(a))
        offsets = (ctypes.c_int32 * len(off))(*off)
        cap = 64
        while True:
            buf = (ctypes.c_int32 * (2 * cap))()
            n = self._lib.sm_match(
                self._handle, raw, blob, offsets, len(ans_raws),
                int(first_only), buf, cap,
            )
            if n < 0:
                return None
            if n <= cap:
                return [
                    raw[buf[2 * i] : buf[2 * i + 1]].decode("utf-8")
                    for i in range(n)
                ]
            cap = n


_singleton = None
_singleton_failed = False


def get_matcher() -> NativeSimpleMatch | None:
    """Process-wide matcher, or None when the native build is unavailable."""
    global _singleton, _singleton_failed
    if _singleton is None and not _singleton_failed:
        try:
            _singleton = NativeSimpleMatch()
        except Exception:
            _singleton_failed = True
    return _singleton
