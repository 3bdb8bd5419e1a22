# Copied from khoice_tpu/mems/ms.py.
"""Matching statistics + MEM locate, backed by the native C++ engine.

Replaces SPUMONI (`spumoni build -M -n` / `run -M -n` producing per-base
matching statistics, reference exp_type_5.smk:115-133) and the r-index's
`ri-align -m 1 locate` one-best-hit queries (exp_type_7.smk:244-256).
The shared library is compiled from khoice_tpu_torch/native/ms_engine.cpp
with g++ at first use into the git-ignored khoice_tpu_torch/_build/
(pybind11 is not needed: the binding is ctypes over a C ABI).  A failed
build raises with the compiler's stderr: the Python suffix list below is
quadratic in memory on texts of hundreds of Mbp, so it runs only when a
caller asks for it (`native=False`; the tests hold the engine against it).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import List

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "native", "ms_engine.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LOCK = threading.Lock()
_LIB = None


class NativeEngineError(RuntimeError):
    """The native MS engine could not be compiled or loaded."""


def _compile(src: str, so: str) -> None:
    # a private temporary name: concurrent processes may build at once
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        try:
            proc = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
                capture_output=True,
                text=True,
            )
        except OSError as exc:
            raise NativeEngineError(f"cannot run g++ to build {src}: {exc}") from exc
        if proc.returncode != 0:
            raise NativeEngineError(
                f"g++ failed (exit {proc.returncode}) building {src}:\n{proc.stderr}"
            )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _build_lib() -> ctypes.CDLL:
    """The loaded engine, built first if it is missing or older than its
    source; raises NativeEngineError when it cannot be built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        os.makedirs(_BUILD_DIR, exist_ok=True)
        so = os.path.join(_BUILD_DIR, "libkhoice_ms.so")
        if (not os.path.exists(so)) or os.path.getmtime(so) < os.path.getmtime(_SOURCE):
            _compile(_SOURCE, so)
        try:
            lib = ctypes.CDLL(so)
        except OSError as exc:
            raise NativeEngineError(f"cannot load {so}: {exc}") from exc
        lib.ms_build.restype = ctypes.c_void_p
        lib.ms_build.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.ms_free.restype = None
        lib.ms_free.argtypes = [ctypes.c_void_p]
        lib.ms_query.restype = None
        lib.ms_query.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ms_locate.restype = ctypes.c_int64
        lib.ms_locate.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.ms_text_len.restype = ctypes.c_int64
        lib.ms_text_len.argtypes = [ctypes.c_void_p]
        lib.ms_batch.restype = None
        lib.ms_batch.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return _LIB


class MatchingStatisticsIndex:
    """Index over a reference text supporting per-base matching statistics
    and exact-pattern locate.  native=False selects the pure-Python
    suffix list (small inputs only: the tests' reference)."""

    def __init__(self, text: str, native: bool = True):
        self._text = text
        self._lib = _build_lib() if native else None
        self._handle = None
        if self._lib is not None:
            data = text.encode("ascii")
            self._handle = ctypes.c_void_p(self._lib.ms_build(data, len(data)))
        else:  # sorted suffix list (small inputs only)
            self._suffixes = sorted(range(len(text)), key=lambda i: text[i:])

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.ms_free(self._handle)
            self._handle = None

    def matching_statistics(self, query: str) -> np.ndarray:
        """MS[i] = length of the longest prefix of query[i:] in the text
        (the `.lengths` row SPUMONI emits per read)."""
        m = len(query)
        if self._handle is not None:
            out = np.zeros(m, np.int32)
            self._lib.ms_query(
                self._handle,
                query.encode("ascii"),
                m,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            return out
        return np.array(
            [self._py_longest_prefix(query[i:])[0] for i in range(m)], np.int32
        )

    def locate(self, pattern: str) -> int:
        """First text position of an exact full match, or -1 (-m 1 role)."""
        if self._handle is not None:
            return int(
                self._lib.ms_locate(
                    self._handle, pattern.encode("ascii"), len(pattern)
                )
            )
        l, pos = self._py_longest_prefix(pattern)
        return pos if l == len(pattern) else -1

    def contains(self, pattern: str) -> bool:
        return self.locate(pattern) >= 0

    def batch_matching_statistics(self, reads: List[str]) -> List[np.ndarray]:
        """Matching statistics for a whole read set in one pass.

        The native engine's generalized-suffix-array batch path: one SA
        over text++reads with unique boundary separators, a Kasai LCP pass
        and two linear sweeps, O((n+m) log(n+m)) in all instead of
        per-position restart queries (the SPUMONI `run -M -n` workload
        shape: GB-scale reference, 10k reads, exp_type_5.smk:115-133).
        The Python index answers read by read.
        """
        if not reads:
            return []
        if self._lib is None:
            return [self.matching_statistics(r) for r in reads]
        concat = "".join(reads).encode("ascii")
        offs = np.zeros(len(reads) + 1, np.int64)
        np.cumsum([len(r) for r in reads], out=offs[1:])
        out = np.zeros(int(offs[-1]), np.int32)
        text = self._text.encode("ascii")
        self._lib.ms_batch(
            text,
            len(text),
            concat,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(reads),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return [out[offs[i] : offs[i + 1]].copy() for i in range(len(reads))]

    def _py_longest_prefix(self, q: str):
        """(longest matched prefix length, a position matching it)."""
        text = self._text
        sufs = self._suffixes
        lo, hi, l = 0, len(sufs), 0
        while l < len(q):
            c = q[l]

            def char_at(s):
                p = s + l
                return text[p] if p < len(text) else "\0"

            a, b = lo, hi
            while a < b:  # lower bound: char_at >= c
                mid = (a + b) // 2
                if char_at(sufs[mid]) < c:
                    a = mid + 1
                else:
                    b = mid
            new_lo = a
            b = hi
            while a < b:  # upper bound: char_at > c
                mid = (a + b) // 2
                if char_at(sufs[mid]) <= c:
                    a = mid + 1
                else:
                    b = mid
            new_hi = a
            if new_lo >= new_hi:
                break
            lo, hi, l = new_lo, new_hi, l + 1
        return l, (sufs[lo] if lo < len(sufs) else -1)
