"""The bytes a kernel's algorithm needs, and its share of the card's
bandwidth roofline.

Bytes are counted at the width the algorithm needs, whatever the program
holds them in: 4 B per 32-bit key or payload word (the program holds
each in an int64), 1 B per base code, 8 B per histogram bin; each input
read once and each output written once.  The least time is those bytes
at the card's published bandwidth; these kernels do integer work that no
operation count binds.  A share is that least time over the kernels'
device time in the trace, in per cent.
"""

from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3), published: 3.35 TB/s at its 700 W limit
H100_BYTES_PER_S = 3.35e12

WORD_BYTES = 4
CODE_BYTES = 1
BIN_BYTES = 8


def _dim(arg, i):
    """Dimension i of a tensor summary ("tensor", shape, dtype)."""
    return arg[1][i]


def sort_bytes(key_words: int, n: int, payload: bool) -> int:
    """A sort of n elements of `key_words` 32-bit key words (and a 32-bit
    payload): every element read once and written once."""
    return 2 * n * WORD_BYTES * (key_words + (1 if payload else 0))


def scan_bytes(key_words: int, n: int, payload: bool, n_ks: int, bins: int) -> int:
    """The multi-k scan over n sorted elements: their key words (and
    payload) read once; the doubled and palindromic histograms of every
    k written once."""
    return n * WORD_BYTES * (key_words + (1 if payload else 0)) + 2 * n_ks * bins * BIN_BYTES


def sort_call_bytes(args) -> int:
    """Bytes of one recorded call of kernels/sort.py::_launch(words,
    payload): words int64 [W, n]."""
    words, payload = args[0], args[1]
    return sort_bytes(_dim(words, 0), _dim(words, 1), payload is not None)


def scan_call_bytes(args) -> int:
    """Bytes of one recorded call of kernels/ksweep_scan.py::_launch(words,
    payload, ks, mode, p0, p1, bins, packed)."""
    words, payload, ks, bins = args[0], args[1], args[2], args[6]
    return scan_bytes(_dim(words, 0), _dim(words, 1), payload is not None, len(ks), bins)


def share(total_bytes: int, device_s: float):
    """Per cent of the roofline, or None where no device time was traced."""
    if not device_s or not total_bytes:
        return None
    return 100.0 * total_bytes / H100_BYTES_PER_S / device_s
