# Copied from khoice_tpu/reports/csvio.py.
"""Histogram text files and CSV emitters (KMC text-format compatible).

Histogram text format: one line per multiplicity i, "i\t#kmers-with-count-i",
written for i = 1..cx like `kmc_tools transform ... histogram` (the reference
reads field [1] of every line and treats line 0 as count 1,
reference: workflow/rules/exp_type_1.smk:210-212).
"""

from __future__ import annotations

import os
from typing import List, Sequence

from ..utils import trace

__all__ = ["write_hist_txt", "read_hist_txt", "write_csv_rows"]


def write_hist_txt(path: str, hist: Sequence[int], cx: int = 10000) -> None:
    with trace.span("reports:write_hist"):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fd:
            for i in range(cx):
                v = int(hist[i]) if i < len(hist) else 0
                fd.write(f"{i + 1}\t{v}\n")


def read_hist_txt(path: str) -> List[int]:
    with trace.span("reports:read_hist"), open(path) as fd:
        return [int(line.split()[1]) for line in fd if line.strip()]


def write_csv_rows(path: str, header: str, rows: List[list]) -> None:
    """Write rows as str()-joined CSV exactly like the reference run: blocks."""
    with trace.span("reports:csv"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fd:
            fd.write(header)
            for row in rows:
                fd.write(",".join(str(x) for x in row) + "\n")
