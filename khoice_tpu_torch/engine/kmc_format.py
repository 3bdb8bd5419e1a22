# Copied from khoice_tpu/engine/kmc_format.py.
"""KMC binary database (.kmc_pre/.kmc_suf) reader/writer.

The reference passes `.kmc_pre`/`.kmc_suf` databases between every rule
(e.g. workflow/rules/exp_type_1.smk:160-163). The engine's own interchange
is KmerTable/.npz + KMC-text dumps (engine/table_io.py — the byte-level
parity gate), but this module adds binary interop so existing KMC
databases can be imported/exported directly.

Layout follows KMC's kmc_api (kmc_file.cpp, KMC1 database variant, which
kmc_tools also consumes):

.kmc_pre:
  "KMCP" | uint64 lut[4^p + 1] | header | uint32 header_offset | "KMCP"
  lut[prefix] = index of the first suffix record whose k-mer has that
  2p-bit prefix; lut[4^p] = total_kmers. header fields (uint32 unless
  noted): kmer_length, mode (0 = occurrence counters), counter_size,
  lut_prefix_length (p), min_count, max_count, uint64 total_kmers,
  uint8 both_strands (1 = canonical counting). header_offset = bytes
  from the end of the header to the trailing marker.

.kmc_suf:
  "KMCS" | records | "KMCS"
  one record per k-mer in sorted order: (k-p) bases packed 2 bits each,
  first base in the HIGH bits of the first byte, padded to whole bytes,
  then a little-endian counter of counter_size bytes.

p is chosen so the suffix is a whole number of bytes ((k-p) % 4 == 0),
capped so the LUT stays small. Round-trip and sorted-dump equivalence are
pinned by tests/test_kmc_format.py; no real KMC binary exists in this
environment, so cross-tool byte interop is best-effort against the
documented layout while the TEXT formats remain the verified gate.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

_PRE_MARKER = b"KMCP"
_SUF_MARKER = b"KMCS"
_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
_BASE = "ACGT"


def default_lut_prefix(k: int, total_kmers: int = 0) -> int:
    """Largest p with (k - p) % 4 == 0, p >= 1, and a LUT sized to the
    database (4^p <= ~4*total_kmers, like KMC's own size heuristic; cap
    12 bounds the LUT at 32 MB for huge databases)."""
    cap = min(12, k - 1)
    if total_kmers > 0:
        while cap > 1 and (1 << (2 * cap)) > 4 * total_kmers:
            cap -= 1
    for p in range(cap, 0, -1):
        if (k - p) % 4 == 0:
            return p
    # no aligned p at or below the size cap (e.g. small k): take the
    # smallest aligned p above it — alignment is a format requirement,
    # the cap only an efficiency heuristic
    for p in range(cap + 1, k):
        if (k - p) % 4 == 0:
            return p
    raise ValueError(f"no valid lut prefix length for k={k}")


def _kmer_index(kmer: str) -> int:
    v = 0
    for ch in kmer:
        code = _CODE.get(ch)
        if code is None:
            raise ValueError(
                f"k-mer {kmer!r} contains non-ACGT character {ch!r}: KMC "
                "databases store 2-bit-packed bases only (dumps never "
                "contain N or IUPAC codes)"
            )
        v = (v << 2) | code
    return v


def _index_kmer(v: int, length: int) -> str:
    return "".join(_BASE[(v >> (2 * (length - 1 - i))) & 3] for i in range(length))


def write_kmc_database(
    path_prefix: str,
    counts: Dict[str, int],
    k: int,
    counter_size: int = 4,
    min_count: int = 1,
    max_count: int = 255,
    lut_prefix_length: int | None = None,
) -> Tuple[str, str]:
    """Write {kmer: count} as .kmc_pre/.kmc_suf; returns the two paths."""
    p = lut_prefix_length or default_lut_prefix(k, len(counts))
    if (k - p) % 4 != 0:
        raise ValueError(f"suffix length {k - p} not a whole number of bytes")
    suf_bases = k - p
    suf_bytes = suf_bases // 4
    items = sorted(counts.items())
    total = len(items)

    prefixes = np.empty(total, np.int64)
    records = bytearray()
    for i, (kmer, cnt) in enumerate(items):
        if len(kmer) != k:
            raise ValueError(f"k-mer {kmer!r} is not length {k}")
        v = _kmer_index(kmer)
        prefixes[i] = v >> (2 * suf_bases)
        suffix = v & ((1 << (2 * suf_bases)) - 1)
        records += int(suffix).to_bytes(suf_bytes, "big") if suf_bytes else b""
        records += int(cnt).to_bytes(counter_size, "little")
    # lut[q] = first record index with prefix >= q (vectorized)
    lut = np.searchsorted(prefixes, np.arange((1 << (2 * p)) + 1)).astype(np.uint64)

    pre_path = path_prefix + ".kmc_pre"
    suf_path = path_prefix + ".kmc_suf"
    os.makedirs(os.path.dirname(pre_path) or ".", exist_ok=True)
    header = struct.pack(
        "<IIIIIIQB",
        k, 0, counter_size, p, min_count, max_count, total, 1
    )
    with open(pre_path, "wb") as fd:
        fd.write(_PRE_MARKER)
        fd.write(lut.tobytes())
        fd.write(header)
        fd.write(struct.pack("<I", len(header)))
        fd.write(_PRE_MARKER)
    with open(suf_path, "wb") as fd:
        fd.write(_SUF_MARKER)
        fd.write(bytes(records))
        fd.write(_SUF_MARKER)
    return pre_path, suf_path


def read_kmc_database(path_prefix: str) -> Tuple[Dict[str, int], dict]:
    """Read .kmc_pre/.kmc_suf back into ({kmer: count}, params)."""
    pre_path = path_prefix + ".kmc_pre"
    suf_path = path_prefix + ".kmc_suf"
    raw = open(pre_path, "rb").read()
    if raw[:4] != _PRE_MARKER or raw[-4:] != _PRE_MARKER:
        raise ValueError(f"{pre_path}: missing KMCP markers")
    (header_offset,) = struct.unpack("<I", raw[-8:-4])
    header = raw[-8 - header_offset : -8]
    k, mode, counter_size, p, min_count, max_count, total, both = struct.unpack(
        "<IIIIIIQB", header[: 4 * 6 + 8 + 1]
    )
    lut_bytes = raw[4 : 4 + 8 * ((1 << (2 * p)) + 1)]
    lut = np.frombuffer(lut_bytes, np.uint64)

    suf_raw = open(suf_path, "rb").read()
    if suf_raw[:4] != _SUF_MARKER or suf_raw[-4:] != _SUF_MARKER:
        raise ValueError(f"{suf_path}: missing KMCS markers")
    body = suf_raw[4:-4]
    suf_bases = k - p
    suf_bytes = suf_bases // 4
    rec = suf_bytes + counter_size
    if len(body) != total * rec:
        raise ValueError(
            f"{suf_path}: body {len(body)}B != {total} records x {rec}B"
        )
    body_arr = np.frombuffer(body, np.uint8).reshape(total, rec) if total else np.zeros((0, rec), np.uint8)
    suf_arr = body_arr[:, :suf_bytes]
    cnt_arr = body_arr[:, suf_bytes:].astype(np.uint64)
    cnt_vals = (cnt_arr * (np.uint64(256) ** np.arange(counter_size, dtype=np.uint64))).sum(1)
    # vectorized decode (multi-million-record databases): byte -> 4-base
    # string table (first base in the high 2 bits), np.char.add across the
    # suffix byte columns, prefixes repeated per LUT bucket
    byte4 = np.array(
        [
            "".join(_BASE[(b >> (2 * (3 - j))) & 3] for j in range(4))
            for b in range(256)
        ],
        dtype="<U4",
    )
    starts, ends = lut[:-1].astype(np.int64), lut[1:].astype(np.int64)
    sizes = ends - starts
    live = np.nonzero(sizes > 0)[0]
    prefix_strs = np.array([_index_kmer(int(q), p) for q in live], dtype=f"<U{p}")
    kmer_strs = np.repeat(prefix_strs, sizes[live]).astype(f"<U{k}")
    for col in range(suf_bytes):
        kmer_strs = np.char.add(kmer_strs, byte4[suf_arr[:, col]])
    out: Dict[str, int] = dict(zip(kmer_strs.tolist(), cnt_vals.astype(int).tolist()))
    params = {
        "kmer_length": k,
        "mode": mode,
        "counter_size": counter_size,
        "lut_prefix_length": p,
        "min_count": min_count,
        "max_count": max_count,
        "total_kmers": total,
        "both_strands": bool(both),
    }
    return out, params
