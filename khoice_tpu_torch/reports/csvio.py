# Copied from khoice_tpu/reports/csvio.py.
"""Histogram text files and CSV emitters (KMC text-format compatible).

Histogram text format: one line per multiplicity i, "i\t#kmers-with-count-i",
written for i = 1..cx like `kmc_tools transform ... histogram` (the reference
reads field [1] of every line and treats line 0 as count 1,
reference: workflow/rules/exp_type_1.smk:210-212).
"""

from __future__ import annotations

import functools
import os
from typing import List, Sequence

from ..utils import trace
from .metrics import nonzero_extent

__all__ = ["write_hist_txt", "read_hist_txt", "write_csv_rows"]


@functools.lru_cache(maxsize=None)
def _zero_lines(cx: int):
    """The lines "i\t0\n" for i = 1..cx as one text, and `starts`, where
    starts[j] is the offset of line j + 1 (starts[cx] the text's length):
    text[starts[j]:] is the tail of every histogram file of this cx whose
    last nonzero bin is j."""
    lines = [f"{i}\t0\n" for i in range(1, cx + 1)]
    starts = [0]
    for line in lines:
        starts.append(starts[-1] + len(line))
    return "".join(lines), tuple(starts)


def write_hist_txt(path: str, hist: Sequence[int], cx: int = 10000) -> None:
    """Lines i = 1..cx of `hist`, truncated or zero-filled to cx: the lines
    up to its last nonzero bin formatted, the rest cut from the zero lines
    of this cx, written in one call."""
    with trace.span("reports:write_hist"):
        hist = hist[:cx]
        last = nonzero_extent(hist)
        head = "".join(f"{i}\t{int(v)}\n" for i, v in enumerate(hist[:last], 1))
        zeros, starts = _zero_lines(cx)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fd:
            fd.write(head + zeros[starts[last]:])


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
