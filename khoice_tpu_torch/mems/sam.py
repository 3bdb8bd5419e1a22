# Copied from khoice_tpu/mems/sam.py.
"""Minimal SAM writing/parsing for the MEM alignment layer.

The reference pipes `ri-align locate` SAM output into pysam
(src/analyze_sam.py:57-59); here the locate engine emits the same
information as minimal SAM records (mapped reads only, `-m 1` one hit per
query) and the analysis parses them with a plain-text reader — pysam is
not in the image.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List


@dataclasses.dataclass
class SamRecord:
    qname: str
    rname: str
    pos: int  # 1-based
    seq: str


def write_sam(path: str, records: Iterable[SamRecord], ref_names=None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fd:
        fd.write("@HD\tVN:1.6\tSO:unsorted\n")
        for rn in ref_names or []:
            fd.write(f"@SQ\tSN:{rn[0]}\tLN:{rn[1]}\n")
        for r in records:
            fd.write(
                f"{r.qname}\t0\t{r.rname}\t{r.pos}\t60\t{len(r.seq)}M\t*\t0\t0\t{r.seq}\t*\n"
            )


def read_sam(path: str) -> List[SamRecord]:
    out: List[SamRecord] = []
    with open(path) as fd:
        for line in fd:
            if line.startswith("@") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            flag = int(f[1])
            if flag & 4:  # unmapped
                continue
            out.append(SamRecord(qname=f[0], rname=f[2], pos=int(f[3]), seq=f[9]))
    return out
