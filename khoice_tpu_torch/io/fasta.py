# Copied from khoice_tpu/io/fasta.py.
"""FASTA / FASTA.gz reading and writing (host side).

The port's copy differs in one respect: the native scanner raises when it
cannot be built (see below).

Covers the file-format surface the reference gets from seqtk/samtools:
- multi-record FASTA (.fna/.fa), optionally gzip-compressed (the reference's
  inputs are `*.fna.gz`, reference: workflow/rules/exp_type_1.smk:158)
- `.fai`-style length accounting (reference: workflow/rules/exp_type_7.smk:177
  uses `samtools faidx` only for total reference length)
- reverse complement (seqtk seq -r role, exp_type_5.smk:101).
"""

from __future__ import annotations

import ctypes
import dataclasses
import gzip
import io
import os
import subprocess
import tempfile
import threading
from typing import Iterable, List

import numpy as np

from ..utils import trace

__all__ = [
    "FastaRecord",
    "read_fasta",
    "read_fasta_codes",
    "write_fasta",
    "fasta_lengths",
    "total_length",
    "revcomp",
]

# --- native scanner (khoice_tpu_torch/native/fasta_codec.cpp) ---------------
# The reference gets native-speed FASTA ingest from KMC3/seqtk; this binds
# the rebuild's C++ scanner over ctypes.  The port builds it with g++ into
# the git-ignored khoice_tpu_torch/_build/, beside the CUDA kernels, so it
# writes nothing outside its checkout.  A failed build or load raises
# NativeCodecError with g++'s message (the JAX package falls back to the
# pure-Python loop below instead); KHOICE_NO_NATIVE=1 is the one way to
# that loop, which gives the same records.

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_CODEC_LOCK = threading.Lock()
_CODEC_LIB = None


class NativeCodecError(RuntimeError):
    """The native FASTA scanner could not be compiled or loaded."""


def _compile(src: str, so: str) -> None:
    # a private temporary name: concurrent processes may build at once
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        try:
            proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
                                  capture_output=True, text=True)
        except OSError as exc:
            raise NativeCodecError(f"cannot run g++ to build {src}: {exc}") from exc
        if proc.returncode != 0:
            raise NativeCodecError(
                f"g++ failed (exit {proc.returncode}) building {src}:\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _codec_lib():
    """The loaded scanner, built first if it is missing or older than its
    source; None when KHOICE_NO_NATIVE is set.  Raises NativeCodecError
    when it cannot be built or loaded."""
    global _CODEC_LIB
    if os.environ.get("KHOICE_NO_NATIVE"):
        return None
    with _CODEC_LOCK:
        if _CODEC_LIB is not None:
            return _CODEC_LIB
        src = os.path.join(_NATIVE_DIR, "fasta_codec.cpp")
        os.makedirs(_BUILD_DIR, exist_ok=True)
        so = os.path.join(_BUILD_DIR, "libkhoice_fasta.so")
        if (not os.path.exists(so)) or os.path.getmtime(so) < os.path.getmtime(src):
            _compile(src, so)
        try:
            lib = ctypes.CDLL(so)
        except OSError as exc:
            raise NativeCodecError(f"cannot load {so}: {exc}") from exc
        lib.fasta_scan.restype = ctypes.c_int64
        lib.fasta_scan.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int,
        ]
        _CODEC_LIB = lib
        return _CODEC_LIB


def _scan_native(data: bytes, to_codes: bool):
    """Returns (names, [sequence slices of seq_buf]), or None under
    KHOICE_NO_NATIVE."""
    lib = _codec_lib()
    if lib is None:
        return None
    n = len(data)
    max_recs = data.count(b">") + 1
    seq_buf = np.empty(max(n, 1), np.uint8)
    rec = np.zeros(4 * max_recs, np.int64)
    nr = lib.fasta_scan(
        data,
        n,
        seq_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rec.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_recs,
        1 if to_codes else 0,
    )
    if nr < 0:  # more records than the '>' count allows: cannot happen
        raise RuntimeError(f"fasta_scan failed ({nr}) on {n} bytes")
    names, seqs = [], []
    for r in range(nr):
        ns, ne, ss, se = rec[4 * r : 4 * r + 4]
        names.append(data[ns:ne].decode("ascii", errors="replace"))
        seqs.append(seq_buf[ss:se])
    return names, seqs


@dataclasses.dataclass
class FastaRecord:
    name: str
    seq: str


def _open_maybe_gz(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fasta(path: str) -> List[FastaRecord]:
    with trace.span("io:read_fasta"):
        with _open_maybe_gz(path, "rb") as fd:
            data = fd.read()
        scanned = _scan_native(data, to_codes=False)
        if scanned is not None:
            names, seqs = scanned
            return [
                FastaRecord(nm, sq.tobytes().decode("ascii", errors="replace"))
                for nm, sq in zip(names, seqs)
            ]
        return _read_fasta_py(data)


def _read_fasta_py(data: bytes) -> List[FastaRecord]:
    """Pure-Python fallback parser (reference semantics baseline)."""
    records: List[FastaRecord] = []
    name = None
    chunks: List[str] = []
    for line in io.TextIOWrapper(io.BytesIO(data)):
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                records.append(FastaRecord(name, "".join(chunks)))
            name = line[1:].split()[0] if len(line) > 1 else ""
            chunks = []
        else:
            chunks.append(line.upper())
    if name is not None:
        records.append(FastaRecord(name, "".join(chunks)))
    return records


def read_fasta_codes(path: str):
    """Fast path straight to engine codes: [(name, uint8 codes array)].

    Skips string materialization entirely — the native scanner emits the
    engine's A=0 C=1 G=2 T=3 / 4=invalid encoding (io/packing.py) in one
    pass over the decompressed bytes.
    """
    with _open_maybe_gz(path, "rb") as fd:
        data = fd.read()
    scanned = _scan_native(data, to_codes=True)
    if scanned is not None:
        return list(zip(scanned[0], [s.copy() for s in scanned[1]]))
    from .packing import encode_seq

    return [(r.name, encode_seq(r.seq)) for r in _read_fasta_py(data)]


def write_fasta(path: str, records: Iterable[FastaRecord], width: int = 60, gz: bool | None = None):
    if gz is None:
        gz = str(path).endswith(".gz")
    # one write per record (a 5 Mbp genome is ~83k lines; per-line writes
    # through the gzip text wrapper dominated exp0's wall time at
    # reference scale), and zlib level 2 — levels 6/9 are 2-6x slower on
    # DNA for a few % size on intermediate artifacts
    fd = gzip.open(path, "wt", compresslevel=2) if gz else open(path, "w")
    with fd:
        for rec in records:
            seq, n = rec.seq, len(rec.seq)
            body = "\n".join(seq[i : i + width] for i in range(0, n, width))
            fd.write(f">{rec.name}\n{body}\n")


def fasta_lengths(path: str) -> List[tuple]:
    """[(name, length)] — the `.fai` columns the reference consumes."""
    return [(r.name, len(r.seq)) for r in read_fasta(path)]


def total_length(path: str) -> int:
    """Total reference length, feeding noise = log4(L)
    (reference: src/analyze_sam.py:41-46)."""
    return sum(l for _, l in fasta_lengths(path))


_COMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]
