# Copied from khoice_tpu/reports/metrics.py.
"""Discriminatory-power metric math — the bit-exact output contract.

These formulas must match the reference's in-workflow metric blocks
operation-for-operation, because the correctness gate is byte equality of
the step_5/step_9 CSVs (BASELINE.md). All math is pure-Python float64 with
Python round() (banker's rounding), matching:

- summarize_histogram_type1: reference workflow/rules/exp_type_1.smk:115-150
- summarize_histogram_type2: reference workflow/rules/exp_type_2.smk:171-216

hist_counts[i] = number of distinct k-mers occurring in exactly i+1
genomes/groups (line i of the KMC-format histogram text file; index 0 is
count 1, reference exp_type_1.smk:210-212).
"""

from __future__ import annotations

from typing import List, Sequence

from ..utils import trace

__all__ = ["summarize_histogram_type1", "summarize_histogram_type2", "nonzero_extent"]


def nonzero_extent(hist: Sequence[int]) -> int:
    """1 + the index of the last nonzero bin of `hist`, 0 if it has none.

    A bisection of the zero tail, each step one `any` over a slice, in C:
    an occurrence histogram over n members has at most n nonzero bins
    however far it is padded."""
    lo, hi = 0, len(hist)
    while lo < hi:  # hist[hi:] is all zero; the last nonzero bin is at lo - 1 or past it
        mid = (lo + hi) // 2
        if any(hist[mid:hi]):
            lo = mid + 1
        else:
            hi = mid
    return lo


def summarize_histogram_type1(
    hist_counts: Sequence[int],
    num_dataset_members: int,
    across_group_analysis: bool,
    k: int,
) -> List[float]:
    """Seven metrics of a within/across-group occurrence histogram.

    [%1_occ, %<=25%, %25-75, %>=75, unique_stat, unique_stat_norm,
    delta_frac]; band boundaries are max(int(p*n),1), overridden to [5,20]
    for the across-group analysis (reference exp_type_1.smk:129-134).

    Works over the bins up to the last nonzero one, and the floats are the
    padded list's bit for bit: the integer sums are exact, a band past the
    last nonzero bin is an empty slice and sums to 0, and each bin past it
    adds +0.0 to m[4] and m[5], which changes neither a float sum nor its
    running compensation.
    """
    with trace.span("reports:summarize"):
        h = hist_counts[:max(nonzero_extent(hist_counts), 1)]
        total = sum(h)

        b = [max(int(p * num_dataset_members), 1) for p in (0.25, 0.75)]
        if across_group_analysis:
            b = [5, 20]

        m = [0.0] * 7
        m[0] = round(h[0] / total, 3)
        m[1] = round(sum(h[1:b[0]]) / total, 3)
        m[2] = round(sum(h[b[0]:b[1]]) / total, 3)
        m[3] = round(sum(h[b[1]:]) / total, 3)

        assert abs(sum(m[0:4]) - 1) < 0.05, "histogram bands do not sum to ~1"

        m[4] = round(sum((i + 1) * (h[i] / total) for i in range(len(h))), 4)
        m[5] = round(
            sum(((i + 1) / num_dataset_members) * (h[i] / total) for i in range(len(h))),
            4,
        )
        m[6] = round(total / k, 4)
        return m


def summarize_histogram_type2(
    sub_counts: Sequence[int],
    inter_counts: Sequence[int],
    num_genomes_in_dataset: int,
    across_group_analysis: bool,
    k: int,
) -> List[float]:
    """Pivot-vs-group variant over (subtract histogram, intersect histogram).

    sub_counts holds pivot-only k-mers (all count 1); inter_counts holds the
    intersect -ocsum histogram (counts >= 2 by construction). Asserts mirror
    the reference's invariants (exp_type_2.smk:183-184).
    """
    assert inter_counts[0] == 0, "intersect -ocsum cannot produce count-1 k-mers"
    assert sum(sub_counts[1:]) == 0, "subtract output must be all count 1"

    total = sum(sub_counts) + sum(inter_counts)

    b = [max(int(p * num_genomes_in_dataset), 1) for p in (0.25, 0.75)]
    if across_group_analysis:
        b = [3, 8]

    m = [0.0] * 7
    m[0] = round(sub_counts[0] / total, 3)
    m[1] = round(sum(inter_counts[i] for i in range(1, b[0])) / total, 3)
    m[2] = round(sum(inter_counts[i] for i in range(b[0], b[1])) / total, 3)
    m[3] = round(sum(inter_counts[i] for i in range(b[1], len(inter_counts))) / total, 3)

    assert abs(sum(m[0:4]) - 1) < 0.05, "histogram bands do not sum to ~1"

    m4 = 1 * sub_counts[0] / total
    m4 += sum((i + 1) * (inter_counts[i] / total) for i in range(1, len(inter_counts)))
    m[4] = round(m4, 4)

    m5 = (1 / num_genomes_in_dataset) * sub_counts[0] / total
    m5 += sum(
        ((i + 1) / num_genomes_in_dataset) * (inter_counts[i] / total)
        for i in range(1, len(inter_counts))
    )
    m[5] = round(m5, 4)

    m[6] = round(total / k, 4)
    return m


def append_group_normalization(all_metrics: List[list], group_ids: Sequence[str]) -> None:
    """Append delta_frac_norm = round(delta_frac / per-group max, 4).

    delta_frac sits at row index 8 ([group, k, m0..m6]); the reference
    appends the normalized value as the last CSV column
    (exp_type_1.smk:218-226).
    """
    with trace.span("reports:summarize"):
        for gid in group_ids:
            values = [row[8] for row in all_metrics if row[0] == gid]
            max_ratio = max(values)
            for row in all_metrics:
                if row[0] == gid:
                    row.append(round(row[8] / max_ratio, 4))
