"""Experiment 2: pivot-vs-group k-mer uniqueness (port of
khoice_tpu/pipelines/exp2.py, its shared-sort path).

Per (k, dataset) the out-pivot genome's k-mer set is intersected (-ocsum)
with and subtracted from the rest-of-group union, and the two histograms
feed summarize_histogram_type2 (reference workflow/rules/exp_type_2.smk).
The across-groups variant compares each pivot with the union of every
OTHER dataset's group set (exp_type_2.smk:263-283).

The whole k grid rides the shared doubled-text sort
(engine/ksweep_classify.py): ONE sort per dataset serves every k's
subtract/intersect histograms (within scope), and ONE sort over all
pivots + groups serves the across scope.  The ks the plan cannot serve
(a class of < 3 ks; every k of a dataset over the sweep's 64-member
mask) take the JAX package's per-k table ops over a KmerEngine
(engine/session.py).  With a key-range group (`group`, the JAX package's
`mesh`) both scopes' sweeps run sharded over its ranks
(dist/ksweep_classify.py).  Row order (dataset-major, k inner), headers and
file layout are the reference's, so the CSV bytes equal the JAX
package's.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from ..dist import ksweep_classify as dkc
from ..engine import ksweep_classify as kc
from ..engine.session import KmerEngine
from ..io.packing import encode_records
from ..reports.csvio import write_csv_rows, write_hist_txt
from ..reports.metrics import summarize_histogram_type2

WITHIN_HEADER = (
    "group_num,k,percent_1_occ,percent_25_or_less,percent_25_to_75,percent_75_or_more,"
    "unique_stat,unique_stat_norm,delta_frac,delta_frac_norm\n"
)
ACROSS_HEADER = (
    "group_num,k,percent_1_occ,percent_2_to_3,percent_4_to_8,percent_9_more,"
    "unique_stat,unique_stat_norm,delta_frac,delta_frac_norm\n"
)


def _normalize_and_write(path, header, all_metrics, group_ids):
    for gid in group_ids:
        values = [m[8] for m in all_metrics if m[0] == gid]
        mx = max(values)
        for m in all_metrics:
            if m[0] == gid:
                m.append(round(m[8] / mx, 4))
    write_csv_rows(path, header, all_metrics)


def _hists_from_counts(cnt: np.ndarray, cx: int):
    """(sub_hist, inter_hist) from sweep counts: cnt[0] classes are
    pivot-only (subtract output, all count 1); cnt[j] classes intersect j
    members, i.e. `-ocsum` count 1 + j (exp_type_2.smk:183-184)."""
    sub = [0] * cx
    sub[0] = int(cnt[0])
    inter = [0] * cx
    for j in range(1, cnt.shape[0]):
        if j < cx:
            inter[j] = int(cnt[j])
    return sub, inter


def _per_k_pair(eng, pivot_codes, rest_codes_list, k, union_cs, hist_cx):
    """The per-k path: (sub_hist, inter_hist) for one (pivot, rest)."""
    pivot_set = eng.set_counts(eng.count_codes(pivot_codes, k), 1)
    rest_union = eng.occurrence_table(rest_codes_list, k, cs=union_cs)
    inter = eng.intersect_sum(pivot_set, rest_union)
    sub = eng.subtract(pivot_set, rest_union)
    return eng.histogram(sub, cx=hist_cx), eng.histogram(inter, cx=hist_cx)


def run_exp2(
    pivots: Dict[int, List[str]],
    rest_of_set: Dict[int, List[List[str]]],
    k_values: Sequence[int],
    out_dir: str,
    device,
    union_cs: int = 5000,
    hist_cx: int = 10000,
    device_budget_bytes: int | None = None,
    group=None,
) -> Dict[str, str]:
    """pivots: {num: pivot record seqs}; rest_of_set excludes the pivot
    (exp2 is always out-pivot: input_type_2 copies exp0_nonpivot_genomes).
    Every sweep and per-k table op runs on `device`, within
    `device_budget_bytes` (default ~85% of the device).  With `group` (a
    dist/mesh.py KvGroup) every rank calls run_exp2 with the same
    arguments, the sweeps run over the ranks, and rank 0 alone runs the
    per-k table ops of the ks they leave over and writes the files.
    Returns {"within": csv, "across": csv}."""
    def sweep(single, sharded, *args):
        """A shared-sort sweep on `device`, or over the group's ranks."""
        if group is None:
            return single(*args, cs=union_cs, device=device,
                          device_budget_bytes=device_budget_bytes)
        return sharded(group, *args, cs=union_cs, device_budget_bytes=device_budget_bytes)

    eng = KmerEngine(device, device_budget_bytes)
    nums = sorted(rest_of_set)
    D = len(nums)

    pivot_codes = {num: encode_records(pivots[num]) for num in nums}
    rest_codes = {
        num: [encode_records(g) for g in rest_of_set[num]] for num in nums
    }
    group_codes = {
        num: encode_records([s for g in rest_of_set[num] for s in g])
        for num in nums
    }

    # (num, k) -> (sub_hist, inter_hist), for both scopes
    within: Dict[tuple, tuple] = {}
    across: Dict[tuple, tuple] = {}

    # WITHIN scope: per dataset, one shared sort serves the whole grid
    fallback_within = set()
    for num in nums:
        counts, rem = sweep(kc.pivot_rest_counts_sweep, dkc.sharded_pivot_rest_counts_sweep,
                            [pivot_codes[num]] + rest_codes[num], k_values)
        for k, cnt in counts.items():
            within[(num, k)] = _hists_from_counts(cnt, hist_cx)
        fallback_within.update(rem)

    # ACROSS scope: one combined sort over all pivots + all group texts
    # (pivot num bits 0..D-1, group bits D..2D-1; own group excluded in
    # the scan)
    members_across = [pivot_codes[num] for num in nums] + [
        group_codes[num] for num in nums
    ]
    counts_across, rem_across = sweep(kc.multi_pivot_counts_sweep,
                                      dkc.sharded_multi_pivot_counts_sweep,
                                      members_across, D, k_values)
    for k, cnt in counts_across.items():
        for i, num in enumerate(nums):
            across[(num, k)] = _hists_from_counts(cnt[i], hist_cx)

    within_csv = os.path.join(out_dir, "within_dataset_analysis_type_2/within_dataset_analysis.csv")
    across_csv = os.path.join(out_dir, "across_dataset_analysis_type_2/across_dataset_analysis.csv")
    if group is not None and group.rank != 0:  # rank 0 writes
        return {"within": within_csv, "across": across_csv}

    # the per-k path (small grids, datasets over the mask): table ops
    for k in sorted(fallback_within):
        for num in nums:
            within[(num, k)] = _per_k_pair(
                eng, pivot_codes[num], rest_codes[num], k, union_cs, hist_cx,
            )
    for k in sorted(rem_across):
        group_sets = {
            num: eng.set_counts(eng.count_codes(group_codes[num], k), 1)
            for num in nums
        }
        for num in nums:
            pivot_set = eng.set_counts(eng.count_codes(pivot_codes[num], k), 1)
            across_union = eng.union([group_sets[j] for j in nums if j != num], cs=union_cs)
            across[(num, k)] = (
                eng.histogram(eng.subtract(pivot_set, across_union), cx=hist_cx),
                eng.histogram(eng.intersect_sum(pivot_set, across_union), cx=hist_cx),
            )

    for k in k_values:
        for scope, data in (("within", within), ("across", across)):
            for num in nums:
                base = os.path.join(
                    out_dir,
                    f"{scope}_dataset_results_type_2/k_{k}/dataset_{num}",
                )
                write_hist_txt(
                    os.path.join(base, f"subtract/dataset_{num}_pivot_subtract_group.hist.txt"),
                    data[(num, k)][0],
                    cx=hist_cx,
                )
                write_hist_txt(
                    os.path.join(base, f"intersect/dataset_{num}_pivot_intersect_group.hist.txt"),
                    data[(num, k)][1],
                    cx=hist_cx,
                )

    num_members = {num: len(rest_of_set[num]) for num in nums}

    # within CSV (rows: dataset-major, k inner)
    rows = []
    for num in nums:
        for k in k_values:
            sub_h, int_h = within[(num, k)]
            rows.append(
                [f"group_{num}", str(k)]
                + summarize_histogram_type2(sub_h, int_h, num_members[num], False, int(k))
            )
    _normalize_and_write(within_csv, WITHIN_HEADER, rows, [f"group_{n}" for n in nums])

    # across CSV
    rows = []
    for num in nums:
        for k in k_values:
            sub_h, int_h = across[(num, k)]
            rows.append(
                [f"group_{num}", str(k)]
                + summarize_histogram_type2(sub_h, int_h, len(nums), True, int(k))
            )
    _normalize_and_write(across_csv, ACROSS_HEADER, rows, [f"group_{n}" for n in nums])

    return {"within": within_csv, "across": across_csv}
