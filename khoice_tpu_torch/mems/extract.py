# Copied from khoice_tpu/mems/extract.py.
"""MEM / half-MEM extraction from matching statistics.

Mirror of the reference's src/extract_mems.py:
- half-MEMs: every position whose MS >= threshold (extract_mems.py:16-34)
- MEMs: position 0 plus every position where MS does not drop relative to
  the previous position (peaks, extract_mems.py:36-72)
- written length capped at 1000 while the *name* keeps the true length
  (extract_mems.py:27,46,65) — the name's length field is what the
  downstream analysis weighs (src/analyze_sam.py:60).

Feature names follow `read_{n}_{mem|halfmem}_{id}_length_{L}` exactly; the
id counter runs across all reads like the reference's curr_id.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence

import numpy as np

CAP = 1000


@dataclasses.dataclass
class Feature:
    name: str          # read_{n}_{kind}_{id}_length_{L}
    seq: str           # capped at CAP characters
    length: int        # true (uncapped) MS length
    read_num: int
    kind: str          # "mem" | "halfmem"


def _emit(read_num, kind, fid, length, seq) -> Feature:
    write_len = min(length, CAP) if length >= CAP else length
    return Feature(
        name=f"read_{read_num}_{kind}_{fid}_length_{length}",
        seq=seq[:write_len],
        length=length,
        read_num=read_num,
        kind=kind,
    )


def extract_half_mems(
    seqs: Sequence[str], ms_arrays: Sequence[np.ndarray], threshold: int
) -> List[Feature]:
    out: List[Feature] = []
    fid = 0
    for read_num, (seq, ms) in enumerate(zip(seqs, ms_arrays)):
        assert len(seq) == len(ms), "sequence/MS length mismatch"
        for i in range(len(seq)):
            l = int(ms[i])
            if l >= threshold:
                out.append(_emit(read_num, "halfmem", fid, l, seq[i:]))
                fid += 1
    return out


def extract_mems(
    seqs: Sequence[str], ms_arrays: Sequence[np.ndarray], threshold: int
) -> List[Feature]:
    out: List[Feature] = []
    fid = 0
    for read_num, (seq, ms) in enumerate(zip(seqs, ms_arrays)):
        assert len(seq) == len(ms), "sequence/MS length mismatch"
        if len(seq) == 0:
            continue
        l0 = int(ms[0])
        if l0 >= threshold:
            out.append(_emit(read_num, "mem", fid, l0, seq))
            fid += 1
        for i in range(1, len(seq)):
            cur, prev = int(ms[i]), int(ms[i - 1])
            if cur >= threshold and cur >= prev:
                out.append(_emit(read_num, "mem", fid, cur, seq[i:]))
                fid += 1
    return out


def write_features_fastq(path: str, features: Iterable[Feature]) -> None:
    """FASTQ-with-'>'-headers format the reference writes
    (extract_mems.py:32,50,70: '>' headers inside a 4-line record)."""
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fd:
        for f in features:
            fd.write(f">{f.name}\n{f.seq}\n+\n{'#' * len(f.seq)}\n")
