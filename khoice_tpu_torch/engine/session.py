"""KmerEngine: the front door the experiment drivers call (port of
khoice_tpu/engine/session.py).

The in-process replacement for the reference's per-rule `kmc`/`kmc_tools`
process invocations (reference workflow/rules/exp_type_1.smk:156-259):
one long-lived runtime on one device instead of a process boundary per
step.  The JAX package's engine memoises jitted callables per shape and
pads inputs and capacities to powers of two to bound XLA recompiles; eager
PyTorch compiles nothing and the port's tables are compact
(engine/table.py), so the engine keeps no memo, pads nothing, and has no
`compact` (it would be the identity).  Every count and occurrence table
checks the per-k path's device bytes against the budget first
(engine/streaming.py).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import ops
from .occurrence import occurrence_table
from .streaming import check_device_budget, default_device_budget_bytes, perk_bytes
from .table import KmerTable


class KmerEngine:
    def __init__(self, device, device_budget_bytes: int | None = None):
        self.device = torch.device(device)
        self.budget = device_budget_bytes or default_device_budget_bytes(self.device)

    def _check(self, total_positions: int, k: int, n_members: int, label: str):
        check_device_budget(perk_bytes(total_positions, [k], n_members), self.budget,
                            f"{label} (k={k})")

    # ---------- counting ----------

    def count_codes(self, codes: np.ndarray, k: int, cs: int = 255) -> KmerTable:
        codes = np.asarray(codes, np.uint8)
        self._check(codes.shape[0], k, 1, "count")
        return ops.count_codes(torch.from_numpy(codes).to(self.device), k, cs)

    def occurrence_table(self, member_codes: Sequence[np.ndarray], k: int,
                         cs: int = 5000) -> KmerTable:
        total = sum(int(c.shape[0]) + 1 for c in member_codes)
        self._check(total, k, len(member_codes), "occurrence table")
        return occurrence_table(member_codes, k, self.device, cs=cs)

    # ---------- table transforms ----------

    def set_counts(self, t: KmerTable, c: int) -> KmerTable:
        return ops.set_counts(t, c)

    def union(self, tables: List[KmerTable], cs: int = 5000) -> KmerTable:
        return ops.union_many(tables, cs=cs)

    def intersect_sum(self, a: KmerTable, b: KmerTable, cs: int = 255) -> KmerTable:
        return ops.intersect_sum(a, b, cs=cs)

    def subtract(self, a: KmerTable, b: KmerTable) -> KmerTable:
        return ops.subtract(a, b)

    def histogram(self, t: KmerTable, cx: int = 10000) -> List[int]:
        return ops.histogram(t, cx=cx).tolist()

    def n_present(self, t: KmerTable) -> int:
        return ops.n_present(t)
