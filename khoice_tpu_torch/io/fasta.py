# Copied from khoice_tpu/io/fasta.py.
"""FASTA / FASTA.gz reading and writing (host side).

The port's copy differs in two respects: the native scanner raises when it
cannot be built (see below), and `read_fasta_files` reads many files at
once on a pool of threads, as records or straight to engine codes.

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
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Sequence

import numpy as np

from ..utils import trace
from .packing import SEP_CODE, encode_seq, join_codes

__all__ = [
    "FastaRecord",
    "read_fasta",
    "read_fasta_codes",
    "read_fasta_files",
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
        lib.fasta_max_records.restype = ctypes.c_int64
        lib.fasta_max_records.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.fasta_scan.restype = ctypes.c_int64
        lib.fasta_scan.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
        ]
        _CODEC_LIB = lib
        return _CODEC_LIB


def _scan_native(lib, data: bytes, to_codes: bool, sep: int = -1):
    """(seq_buf, bounds): the records' sequences laid end to end in
    seq_buf, `sep` between two of them when it is >= 0, and an int64
    [records, 4] array of each record's name start and end in `data` and
    sequence start and end in seq_buf.  Both ctypes calls release the
    interpreter lock."""
    n = len(data)
    max_recs = lib.fasta_max_records(data, n)
    seq_buf = np.empty(max(n, 1), np.uint8)
    rec = np.empty((max_recs, 4), np.int64)
    nr = lib.fasta_scan(
        data,
        n,
        seq_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rec.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_recs,
        1 if to_codes else 0,
        sep,
    )
    if nr < 0:  # more records than the '>' count allows: cannot happen
        raise RuntimeError(f"fasta_scan failed ({nr}) on {n} bytes")
    return seq_buf, rec[:nr]


@dataclasses.dataclass
class FastaRecord:
    name: str
    seq: str


def _file_bytes(path: str) -> bytes:
    """The file's text, inflated when its name ends in .gz (every gzip
    member, as gzip.open reads them); zlib releases the interpreter lock
    while it inflates."""
    with open(path, "rb") as fd:
        data = fd.read()
    return gzip.decompress(data) if str(path).endswith(".gz") else data


def _read_file(path: str, codes: bool):
    """One file's records (FastaRecords), or with codes=True their
    sequences' engine codes joined with one SEP_CODE between records, as
    io/packing.encode_records joins them.  Opens no span: the pool's
    threads run it, and only the caller's thread opens spans."""
    data = _file_bytes(path)
    lib = _codec_lib()
    if lib is None:
        records = _read_fasta_py(data)
        return join_codes([r.seq for r in records]) if codes else records
    if codes:
        seq_buf, rec = _scan_native(lib, data, to_codes=True, sep=int(SEP_CODE))
        return seq_buf[: rec[-1, 3] if len(rec) else 0]
    seq_buf, rec = _scan_native(lib, data, to_codes=False)
    view = memoryview(seq_buf)
    return [
        FastaRecord(data[ns:ne].decode("ascii", errors="replace"),
                    str(view[ss:se], "ascii", "replace"))
        for ns, ne, ss, se in rec.tolist()
    ]


def read_fasta(path: str) -> List[FastaRecord]:
    with trace.span("io:read_fasta"):
        return _read_file(path, codes=False)


# files read through read_fasta_files since the last reset, by form
pooled_files = {"codes": 0, "str": 0}


def pool_width(n_files: int) -> int:
    """Threads to read n_files with: the CPUs this process may run on,
    shared by the ranks this host runs (LOCAL_WORLD_SIZE, else WORLD_SIZE,
    else 1, as the CLI reckons them), at least 1 and at most n_files."""
    world = os.environ.get("WORLD_SIZE", "1")
    ranks = max(1, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    return max(1, min(n_files, len(os.sched_getaffinity(0)) // ranks))


def read_fasta_files(paths: Sequence[str], codes: bool = False) -> list:
    """Every file of `paths` read at once, on pool_width(len(paths))
    threads, each file's reading, inflating and scanning without the
    interpreter lock.  One result a path, in order: its FastaRecords, as
    read_fasta gives them, or with codes=True one uint8 array, its records'
    codes joined as io/packing.encode_records joins them.  The calling
    thread holds one `io:read_fasta` span over the whole read."""
    with trace.span("io:read_fasta"):
        _codec_lib()  # built or loaded here, so that a failed build raises once, here
        with ThreadPoolExecutor(pool_width(len(paths))) as pool:
            out = list(pool.map(lambda p: _read_file(p, codes), paths))
    pooled_files["codes" if codes else "str"] += len(paths)
    return out


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
    data = _file_bytes(path)
    lib = _codec_lib()
    if lib is None:
        return [(r.name, encode_seq(r.seq)) for r in _read_fasta_py(data)]
    seq_buf, rec = _scan_native(lib, data, to_codes=True)
    return [(data[ns:ne].decode("ascii", errors="replace"), seq_buf[ss:se].copy())
            for ns, ne, ss, se in rec.tolist()]


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
