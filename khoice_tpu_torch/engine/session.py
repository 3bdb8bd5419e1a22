"""KmerEngine: the front door the experiment drivers call (port of
khoice_tpu/engine/session.py).

The in-process replacement for the reference's per-rule `kmc`/`kmc_tools`
process invocations (reference workflow/rules/exp_type_1.smk:156-259):
one long-lived runtime on one device instead of a process boundary per
step.  The JAX package's engine memoises jitted callables per shape and
pads inputs and capacities to powers of two to bound XLA recompiles; eager
PyTorch compiles nothing and the port's tables are compact
(engine/table.py), so the engine keeps no memo, pads nothing, and has no
`compact` (it would be the identity).  Every count, occurrence table,
union, intersection, subtraction and annotation checks its device bytes,
beside what the run holds, against the budget first
(engine/streaming.py).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..classify.annotate import Annotation, build_annotation
from ..io.packing import encode_records
from . import members, ops
from .occurrence import occurrence_table
from .streaming import (
    annotation_bytes,
    check_device_budget,
    count_bytes,
    default_device_budget_bytes,
    occurrence_table_bytes,
    perk_bytes,
    table_merge_bytes,
)
from .table import KmerTable


class KmerEngine:
    def __init__(self, device, device_budget_bytes: int | None = None):
        self.device = torch.device(device)
        self.budget = device_budget_bytes or default_device_budget_bytes(self.device)

    def _check(self, need_bytes: int, label: str):
        check_device_budget(need_bytes, self.budget, label, self.device)

    def _check_merge(self, tables: List[KmerTable], label: str, estimate=table_merge_bytes):
        self._check(estimate(sum(len(t) for t in tables), tables[0].n_words),
                    f"{label} (k={tables[0].k})")

    # ---------- counting ----------

    def count_codes(self, codes: np.ndarray, k: int, cs: int = 255) -> KmerTable:
        codes = np.asarray(codes, np.uint8)
        self._check(count_bytes(codes.shape[0], k), f"count (k={k})")
        return ops.count_codes(torch.from_numpy(codes).to(self.device), k, cs)

    def count_seqs(self, seqs: Sequence[str], k: int, cs: int = 255) -> KmerTable:
        """count_codes of the records joined with separators.  The JAX
        package's takes `compact`, which shrinks a run-form table's
        capacity; the port's tables are compact already, so it has none."""
        return self.count_codes(encode_records(seqs), k, cs)

    def occurrence_table(self, member_codes: Sequence[np.ndarray], k: int,
                         cs: int = 5000) -> KmerTable:
        total = members.layout(member_codes)[2]
        self._check(max(perk_bytes(total, [k], len(member_codes)),
                        occurrence_table_bytes(total, k, len(member_codes))),
                    f"occurrence table (k={k})")
        return occurrence_table(member_codes, k, self.device, cs=cs)

    # ---------- table transforms ----------

    def set_counts(self, t: KmerTable, c: int) -> KmerTable:
        return ops.set_counts(t, c)

    def union(self, tables: List[KmerTable], cs: int = 5000) -> KmerTable:
        self._check_merge(tables, "union")
        return ops.union_many(tables, cs=cs)

    def intersect_sum(self, a: KmerTable, b: KmerTable, cs: int = 255) -> KmerTable:
        self._check_merge([a, b], "intersect")
        return ops.intersect_sum(a, b, cs=cs)

    def subtract(self, a: KmerTable, b: KmerTable) -> KmerTable:
        self._check_merge([a, b], "subtract")
        return ops.subtract(a, b)

    def annotate(self, pivot: KmerTable, groups: List[KmerTable]) -> Annotation:
        """classify/annotate.py::build_annotation, checked against the
        budget first."""
        self._check_merge([pivot] + list(groups), "annotation", annotation_bytes)
        return build_annotation(pivot, groups)

    def histogram(self, t: KmerTable, cx: int = 10000) -> List[int]:
        return ops.histogram(t, cx=cx).tolist()

    def n_present(self, t: KmerTable) -> int:
        return ops.n_present(t)
