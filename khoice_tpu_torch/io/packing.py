# Copied from khoice_tpu/io/packing.py.
"""Sequence -> code encoding for the device engine (host side, numpy).

Bases map A=0 C=1 G=2 T=3; every other symbol (N, IUPAC ambiguity codes)
maps to 4 = invalid, making any k-mer window containing it invalid — the
same behavior as KMC3 (its dumps contain only ACGT k-mers). Records are
joined with a single separator code 4 so k-mers never span FASTA records.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from ..utils import trace

SEP_CODE = np.uint8(4)

_LUT = np.full(256, 4, np.uint8)
for i, ch in enumerate("ACGT"):
    _LUT[ord(ch)] = i
    _LUT[ord(ch.lower())] = i


def encode_seq(seq: str | bytes) -> np.ndarray:
    """Encode one sequence string to uint8 codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _LUT[arr]


def encode_records(seqs: Iterable[str], pad_to: int | None = None) -> np.ndarray:
    """Encode multiple sequences into one code array with separators.

    Optionally right-pad with separator codes to a fixed length (static
    shapes keep XLA recompilation bounded; pad windows are invalid anyway).
    """
    with trace.span("io:encode"):
        parts = []
        first = True
        for s in seqs:
            if not first:
                parts.append(np.array([SEP_CODE]))
            parts.append(encode_seq(s))
            first = False
        if not parts:
            out = np.zeros(0, np.uint8)
        else:
            out = np.concatenate(parts)
    if pad_to is not None:
        if out.shape[0] > pad_to:
            raise ValueError(f"encoded length {out.shape[0]} exceeds pad_to {pad_to}")
        out = np.concatenate([out, np.full(pad_to - out.shape[0], SEP_CODE)])
    return out


def pad_pow2(codes: np.ndarray, min_size: int = 1024) -> np.ndarray:
    """Pad codes with separators to the next power of two (compile caching)."""
    n = max(int(codes.shape[0]), min_size)
    p = 1 << (n - 1).bit_length()
    return np.concatenate([codes, np.full(p - codes.shape[0], SEP_CODE)])
