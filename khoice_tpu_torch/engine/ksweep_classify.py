"""Shared-sort k-sweep for the classification experiments exp2/3/4 (port of
khoice_tpu/engine/ksweep_classify.py; the method is documented there).

In short: the pivot (genome, read sets) and the comparison sets are
packed as members of one doubled text, sorted ONCE per key-word class
(engine/ksweep.py), and one scan over the class's ks bins every run's
member mask by the experiment's mode (kernels/ksweep_scan.py
`scan_classify`): pivot-vs-rest intersection counts (exp2 within), pivot
vs other groups (exp2 across), query read sets vs groups (exp3), and
exp4's count-weighted feature buckets.  Every stat comes raw, for all runs
(d) and palindromic runs (p), and the canonical value is (d + p) // 2.

Left out, because they served only the TPU: the XLA scans' chunking to
SCAN_KS_PER_CALL ks, the Pallas gate (`_classify_pallas_ok`) and the
XLA memory envelope (`_xla_scan_too_big`) with their all-ks fallback to
the per-k path, and the Pallas buckets' cap <= 511.  Instead each sweep's
device bytes are checked before it runs (engine/streaming.py).  The mask
limit is the kernel's 64 members; the JAX package sends 33 to 64 members
to its per-k path, which gives the same counts.  The ks the plan leaves
over (a class of < 3 ks, every k of a set over 64 members) come back as
each sweep's second value, for the drivers' per-k table ops
(pipelines/exp2.py, exp3.py, exp4.py), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..kernels.ksweep_scan import scan_classify
from .ksweep import _sweep_doubled, plan_sweep
from .occurrence import pack_members
from .streaming import check_device_budget, default_device_budget_bytes, incore_sweep_bytes


def _run_classes(member_codes: Sequence[np.ndarray], ks: Sequence[int], mode: str,
                 mode_params, device,
                 device_budget_bytes: int | None = None
                 ) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """Shared driver: pack the members once, sort ONCE per planned class
    and run ONE scan over the class's ks.  Returns ({k: canonical stats,
    int64 [bins]} for the swept ks, the ks plan_sweep leaves to the per-k
    path).

    Raises DeviceBudgetExceeded when a class sort would not fit
    `device_budget_bytes` (default ~85% of the device,
    engine/streaming.py)."""
    device = torch.device(device)
    n_members = len(member_codes)
    classes, remaining = plan_sweep(ks, n_members)
    out: Dict[int, np.ndarray] = {}
    if not classes:
        return out, remaining
    total = sum(int(c.shape[0]) + 1 for c in member_codes)
    budget = device_budget_bytes or default_device_budget_bytes(device)
    check_device_budget(incore_sweep_bytes(total, ks, n_members), budget, f"{mode} sweep")
    codes, gids = pack_members(member_codes, device)
    for kmax, KW, cks, packed in classes:
        skeys, spay = _sweep_doubled(codes, gids, kmax, KW, packed)
        raw = scan_classify(skeys, spay, cks, mode, mode_params, packed)
        del skeys, spay
        canon = ((raw[0] + raw[1]) // 2).cpu().numpy()
        for i, k in enumerate(cks):
            out[k] = canon[i]
    return out, remaining


def pivot_rest_counts_sweep(
    member_codes: Sequence[np.ndarray], ks: Sequence[int], cs: int = 5000,
    device="cuda", device_budget_bytes: int | None = None,
) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """{k: (n_rest+1,) counts} for member 0 = pivot vs the rest members:
    [j] = canonical classes in the pivot and in exactly j rest members;
    and the ks left to the per-k path."""
    n_rest = len(member_codes) - 1
    # the sweep's counts are exact (uncapped): with <= 64 members every
    # count is <= n_members, so KMC's `-cs` union cap is unreachable as
    # long as cs >= n_members
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    return _run_classes(member_codes, ks, "pivot_rest", n_rest, device,
                        device_budget_bytes)


def multi_pivot_counts_sweep(
    member_codes: Sequence[np.ndarray], D: int, ks: Sequence[int], cs: int = 5000,
    device="cuda", device_budget_bytes: int | None = None,
) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """{k: (D, D) counts}: members 0..D-1 pivots, D..2D-1 group sets;
    [num, j] = classes in pivot num and in exactly j OTHER groups."""
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    out, remaining = _run_classes(member_codes, ks, "multi_pivot", D, device,
                                  device_budget_bytes)
    return {k: v.reshape(D, D) for k, v in out.items()}, remaining


def containment_counts_sweep(
    member_codes: Sequence[np.ndarray], nq: int, ng: int, ks: Sequence[int],
    cs: int = 5000, device="cuda", device_budget_bytes: int | None = None,
) -> Tuple[Dict[int, np.ndarray], List[int]]:
    """{k: (nq, ng+1) counts}: members 0..nq-1 query sets, then ng groups;
    [q, 0] = classes in query q, [q, 1+g] = classes in query q and group g."""
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    out, remaining = _run_classes(member_codes, ks, "containment", (nq, ng), device,
                                  device_budget_bytes)
    return {k: v.reshape(nq, ng + 1) for k, v in out.items()}, remaining


def feature_buckets_sweep(
    member_codes: Sequence[np.ndarray], D: int, ks: Sequence[int],
    cap: int = 255, cs: int = 5000, device="cuda",
    device_budget_bytes: int | None = None,
) -> Tuple[Dict[int, tuple], List[int]]:
    """{k: (buckets (D, D) int64, unique int)}: member 0 pivot, 1..D groups;
    buckets[d, m-1] = saturated pivot counts of classes in group d matching
    m groups, unique = those matching none."""
    assert cs >= len(member_codes), "sweep ignores cs below the member count"
    out, remaining = _run_classes(member_codes, ks, "buckets", (D, cap), device,
                                  device_budget_bytes)
    return {k: (v[:D * D].reshape(D, D).astype(np.int64), int(v[D * D]))
            for k, v in out.items()}, remaining
