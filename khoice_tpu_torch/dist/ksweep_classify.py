"""Sharded classification sweeps: exp2/3/4's scans over the key-range
group (port of khoice_tpu/dist/ksweep_classify.py; the design is
documented there).

The four classification modes of engine/ksweep_classify.py take the same
path as exp1's sharded sweep (dist/ksweep.py): slabs, the local doubled
text, one exchange by 2*kmin-prefix-aligned sampled splits, so that no
k-run of any swept k is torn across ranks, a merge sort and the scan
kernel in the mode's raw form, the sum over the group, then (d+p)//2.
exp4's "buckets" mode skips the exchange dedupe, because it sums pivot
multiplicities.

Each driver returns the same ({k: stats}, leftover ks) contract as its
single-device counterpart, with the same values, on every rank.  The
mask limit is the scan kernel's 64 members for every mode, where the JAX
package takes 32 for these modes; the counts are the same.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .ksweep import run_sweep_plan_raw
from .mesh import KvGroup


def sharded_pivot_rest_counts_sweep(
    group: KvGroup, member_codes: Sequence[np.ndarray], ks: Sequence[int],
    cs: int = 5000, device_budget_bytes: int | None = None,
) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """Sharded twin of engine.ksweep_classify.pivot_rest_counts_sweep:
    {k: (n_rest+1,) counts} for member 0 = pivot vs the rest members."""
    n_rest = len(member_codes) - 1
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    return run_sweep_plan_raw(group, member_codes, ks, cs, mode="pivot_rest",
                              mode_params=n_rest, device_budget_bytes=device_budget_bytes)


def sharded_multi_pivot_counts_sweep(
    group: KvGroup, member_codes: Sequence[np.ndarray], D: int,
    ks: Sequence[int], cs: int = 5000, device_budget_bytes: int | None = None,
) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """Sharded twin of multi_pivot_counts_sweep: {k: (D, D) counts},
    members 0..D-1 pivots, D..2D-1 group sets."""
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    stats, remaining = run_sweep_plan_raw(group, member_codes, ks, cs, mode="multi_pivot",
                                          mode_params=D,
                                          device_budget_bytes=device_budget_bytes)
    return {k: v.reshape(D, D) for k, v in stats.items()}, remaining


def sharded_containment_counts_sweep(
    group: KvGroup, member_codes: Sequence[np.ndarray], nq: int, ng: int,
    ks: Sequence[int], cs: int = 5000, device_budget_bytes: int | None = None,
) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """Sharded twin of containment_counts_sweep: {k: (nq, ng+1) counts},
    members 0..nq-1 query sets, then ng groups."""
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    stats, remaining = run_sweep_plan_raw(group, member_codes, ks, cs, mode="containment",
                                          mode_params=(nq, ng),
                                          device_budget_bytes=device_budget_bytes)
    return {k: v.reshape(nq, ng + 1) for k, v in stats.items()}, remaining


def sharded_feature_buckets_sweep(
    group: KvGroup, member_codes: Sequence[np.ndarray], D: int,
    ks: Sequence[int], cap: int = 255, cs: int = 5000,
    device_budget_bytes: int | None = None,
) -> Tuple[Dict[int, tuple], List[int]]:
    """Sharded twin of feature_buckets_sweep: {k: (buckets (D, D) int64,
    unique int)}, member 0 pivot (count-weighted), 1..D group sets."""
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    stats, remaining = run_sweep_plan_raw(group, member_codes, ks, cs, mode="buckets",
                                          mode_params=(D, cap),
                                          device_budget_bytes=device_budget_bytes)
    return {k: (v[:D * D].reshape(D, D).astype(np.int64), int(v[D * D]))
            for k, v in stats.items()}, remaining
