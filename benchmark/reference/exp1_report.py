"""The step_5 and step_9 CSV text of exp1 from occurrence histograms,
written from the reference workflow's definition (vshiv18/khoice
`workflow/rules/exp_type_1.smk`): the metrics of `summarize_histogram_type1`
(:115-150), the band boundaries max(int(p * n), 1) with the across-group
override [5, 20] (:129-134), Python's round() to 3 and 4 digits (:136-149),
the per-group max normalisation of delta_frac (:218-226), and the column
orders of step_5 (:200-201) and step_9 (:269-270).

The CSV bytes are defined by pure-Python float64 arithmetic, so every
value is computed with the operations the definition names, in its
order: a band is an integer sum over total; the uniqueness statistic
sums (i + 1) * share_i, its normalised form ((i + 1) / n) * share_i,
where share_i = h_i / total.  Rows: k outer, group inner in step_5, one
row per k in step_9, every value str()-joined by commas.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

STEP5_COLUMNS = ("group_num", "k", "percent_1_occ", "percent_25_or_less", "percent_25_to_75",
                 "percent_75_or_more", "unique_stat", "unique_stat_norm", "delta_frac",
                 "delta_frac_norm")
STEP9_COLUMNS = ("group_num", "k", "percent_1_occ", "percent_2_to_5", "percent_5_to_20",
                 "percent_20_more", "unique_stat", "unique_stat_norm", "delta_frac",
                 "delta_frac_norm")


def histogram_metrics(hist: Sequence[int], members: int, across: bool, k: int) -> List[float]:
    """[share of 1-occurrence k-mers, the three bands' shares, uniqueness
    statistic, its form over the members, distinct k-mers over k] of one
    occurrence histogram (hist[i]: k-mers held by i + 1 members)."""
    total = sum(hist)
    lo, hi = (5, 20) if across else (max(int(0.25 * members), 1), max(int(0.75 * members), 1))
    bands = [hist[0], sum(hist[1:lo]), sum(hist[lo:hi]), sum(hist[hi:])]
    out = [round(count / total, 3) for count in bands]
    shares = [count / total for count in hist]
    out.append(round(sum((i + 1) * s for i, s in enumerate(shares)), 4))
    out.append(round(sum(((i + 1) / members) * s for i, s in enumerate(shares)), 4))
    out.append(round(total / k, 4))
    return out


def _normalised(rows: List[list]) -> List[list]:
    """Each row with delta_frac over the largest delta_frac of its rows."""
    top = max(row[-1] for row in rows)
    return [row + [round(row[-1] / top, 4)] for row in rows]


def _text(columns: Sequence[str], rows: List[list]) -> str:
    lines = [",".join(columns)] + [",".join(str(v) for v in row) for row in rows]
    return "\n".join(lines) + "\n"


def step5_text(within: Dict[tuple, List[int]], group_sizes: Dict[int, int],
               ks: Sequence[int]) -> str:
    by_group = {num: _normalised([[f"group_{num}", str(k)]
                                  + histogram_metrics(within[(int(k), num)], size, False, int(k))
                                  for k in ks])
                for num, size in group_sizes.items()}
    rows = [by_group[num][i] for i in range(len(ks)) for num in sorted(group_sizes)]
    return _text(STEP5_COLUMNS, rows)


def step9_text(across: Dict[int, List[int]], n_groups: int, ks: Sequence[int]) -> str:
    rows = _normalised([["full_group", str(k)]
                        + histogram_metrics(across[int(k)], n_groups, True, int(k)) for k in ks])
    return _text(STEP9_COLUMNS, rows)
