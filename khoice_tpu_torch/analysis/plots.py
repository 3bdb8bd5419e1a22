# Copied from khoice_tpu/analysis/plots.py.
"""Plot suite — matplotlib equivalents of the reference's offline R scripts.

The reference's analysis/*.R are hand-edited-path ggplot2 scripts outside
the workflow DAG (SURVEY.md section 2.1 item 21). Equivalents here read the
same CSVs the pipelines emit:

- plot_type1: stacked occurrence-band bars + uniqueness-statistic curves
  with second derivative (analysis/kmer_plots_type_1.R:30-129,252-278)
- plot_type2: pivot-vs-group variant (kmer_plots_type_2.R)
- plot_type3: grouped bars of intersection percent (kmer_plots_type_3.R)
- plot_confusion_heatmap + plot_accuracy_curves: type4/5/6/7 outputs
- plot_species_comparison: F1 +/- sd ribbons across trials
  (species_overall_comparison.R:45-92)
- plot_database_percent: uniqueness vs database size
  (database_percent_comparison.R)
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

BAND_COLS_T1 = [
    "percent_1_occ",
    "percent_25_or_less",
    "percent_25_to_75",
    "percent_75_or_more",
]



def _group_key(g: str):
    """Numeric-aware ordering for group/dataset ids: 'group_10' sorts
    after 'group_2' (the reference R scripts iterate unique() in the
    CSV's numeric order; plain string sort breaks at 10+ groups)."""
    import re

    m = re.search(r"(\d+)$", g)
    return (int(m.group(1)), g) if m else (1 << 30, g)


def _read_csv(path: str) -> List[dict]:
    with open(path) as fd:
        return list(csv.DictReader(fd))


def _save(fig, out_path: str) -> str:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_type1(step5_csv: str, out_path: str, band_cols: Optional[List[str]] = None) -> str:
    """Stacked bars of occurrence bands per (group, k) + unique_stat curve."""
    rows = _read_csv(step5_csv)
    bands = band_cols or [c for c in rows[0] if c.startswith("percent_")]
    groups = sorted({r["group_num"] for r in rows}, key=_group_key)
    fig, axes = plt.subplots(
        2, len(groups), figsize=(4 * len(groups), 7), squeeze=False
    )
    for gi, group in enumerate(groups):
        sub = [r for r in rows if r["group_num"] == group]
        ks = [int(r["k"]) for r in sub]
        bottom = np.zeros(len(sub))
        ax = axes[0][gi]
        for band in bands:
            vals = np.array([float(r[band]) for r in sub])
            ax.bar(range(len(ks)), vals, bottom=bottom, label=band)
            bottom += vals
        ax.set_xticks(range(len(ks)))
        ax.set_xticklabels(ks, rotation=90, fontsize=6)
        ax.set_title(group)
        ax.set_xlabel("k")
        if gi == 0:
            ax.set_ylabel("fraction of distinct k-mers")
            ax.legend(fontsize=6)
        ax2 = axes[1][gi]
        stat = np.array([float(r["unique_stat_norm"]) for r in sub])
        ax2.plot(ks, stat, marker="o", ms=3, label="unique_stat_norm")
        if len(stat) >= 3:
            d2 = np.gradient(np.gradient(stat, ks), ks)
            ax2.plot(ks, d2, ls="--", label="2nd derivative")
        ax2.set_xlabel("k")
        if gi == 0:
            ax2.legend(fontsize=6)
    return _save(fig, out_path)


WITHIN_BANDS_T2 = [
    "percent_75_or_more",
    "percent_25_to_75",
    "percent_25_or_less",
    "percent_1_occ",
]
ACROSS_BANDS_T2 = ["percent_4_to_8", "percent_2_to_3", "percent_1_occ"]


def _stacked_fill_bars(ax, sub: List[dict], bands: List[str], x_key: str = "k"):
    """position='fill' stacked bars: each bar normalized to sum 1 over the
    melted bands (the R scripts' geom_bar(position='fill'))."""
    xs = [r[x_key] for r in sub]
    mat = np.array([[float(r[b]) for b in bands] for r in sub])  # [n, B]
    totals = mat.sum(1, keepdims=True)
    totals[totals == 0] = 1.0
    mat = mat / totals
    bottom = np.zeros(len(sub))
    for bi, band in enumerate(bands):
        ax.bar(range(len(xs)), mat[:, bi], bottom=bottom, label=band)
        bottom += mat[:, bi]
    ax.set_xticks(range(len(xs)))
    ax.set_xticklabels(xs, rotation=90, fontsize=6)


def _unique_stat_curves(ax, rows: List[dict], names: Optional[Sequence[str]]):
    groups = sorted({r["group_num"] for r in rows}, key=_group_key)
    for gi, group in enumerate(groups):
        sub = [r for r in rows if r["group_num"] == group]
        ks = [int(r["k"]) for r in sub]
        ys = [float(r["unique_stat"]) for r in sub]
        label = names[gi] if names and gi < len(names) else group
        ax.plot(ks, ys, marker="o", ms=3, label=label)
    ax.axhline(1.0, ls="--", color="red")  # R's geom_hline(yintercept=1)
    ax.set_xlabel("Kmer Length (k)")
    ax.set_ylabel("Uniqueness Statistic")
    ax.legend(fontsize=7)


def plot_type2(
    within_csv: str,
    across_csv: str,
    out_dir: str,
    dataset_names: Optional[Sequence[str]] = None,
) -> List[str]:
    """Per-script parity with analysis/kmer_plots_type_2.R: per-group
    within stacked fill-bars + within uniqueness curves (hline at 1), and
    per-pivot across stacked fill-bars + across uniqueness curves, with
    the reference's output file names."""
    out: List[str] = []
    within = _read_csv(within_csv)
    groups = sorted({r["group_num"] for r in within}, key=_group_key)
    for pos, group in enumerate(groups, start=1):
        sub = [r for r in within if r["group_num"] == group]
        name = (
            dataset_names[pos - 1]
            if dataset_names and pos <= len(dataset_names)
            else group
        )
        fig, ax = plt.subplots(figsize=(6, 4.5))
        _stacked_fill_bars(ax, sub, WITHIN_BANDS_T2)
        ax.set_xlabel("Kmer Length (k)")
        ax.set_ylabel("Ratio of Unique Kmers")
        ax.set_title(f"Uniqueness of Kmers Across {name} Genomes w.r.t a Pivot Genome",
                     fontsize=8)
        ax.legend(fontsize=6, loc="lower right")
        out.append(_save(fig, os.path.join(out_dir, f"within_dataset_{pos}_kmer_analysis.png")))

    fig, ax = plt.subplots(figsize=(6, 4))
    _unique_stat_curves(ax, within, dataset_names)
    ax.set_title("Uniqueness statistic as k increases for each dataset", fontsize=9)
    out.append(_save(fig, os.path.join(out_dir, "within_dataset_unique_stat.png")))

    across = _read_csv(across_csv)
    agroups = sorted({r["group_num"] for r in across}, key=_group_key)
    for pos, group in enumerate(agroups, start=1):
        sub = [r for r in across if r["group_num"] == group]
        name = (
            dataset_names[pos - 1]
            if dataset_names and pos <= len(dataset_names)
            else group
        )
        fig, ax = plt.subplots(figsize=(6, 4.5))
        _stacked_fill_bars(ax, sub, ACROSS_BANDS_T2)
        ax.set_xlabel("Kmer Length (k)")
        ax.set_ylabel("Ratio of Unique Kmers")
        ax.set_title(
            f"Uniqueness of Kmers Across All {len(agroups)} Groups w.r.t {name} Pivot",
            fontsize=8,
        )
        ax.legend(fontsize=6, loc="lower right")
        out.append(_save(fig, os.path.join(out_dir, f"across_datasets_{pos}_kmer_analysis.png")))

    fig, ax = plt.subplots(figsize=(6, 4))
    _unique_stat_curves(ax, across, dataset_names)
    ax.set_title(
        f"Uniqueness statistic across all {len(agroups)} datasets as k increases",
        fontsize=9,
    )
    out.append(_save(fig, os.path.join(out_dir, "across_dataset_unique_stat.png")))
    return out


def _normalized_confusion(matrix_csv: str) -> np.ndarray:
    """Row-normalize a header-less confusion matrix, round(2) like the R
    scripts (kmer_plots_type_4.R:99-105)."""
    with open(matrix_csv) as fd:
        mat = np.array(
            [[float(x) for x in line.strip().split(",")] for line in fd if line.strip()]
        )
    sums = mat.sum(1, keepdims=True)
    sums[sums == 0] = 1.0
    return np.round(mat / sums, 2)


def _heatmap(ax, norm: np.ndarray, row_names, col_names, title: str):
    im = ax.imshow(norm, cmap="RdYlGn")
    for i in range(norm.shape[0]):
        for j in range(norm.shape[1]):
            ax.text(j, i, f"{norm[i, j]:.2f}", ha="center", va="center",
                    color="white", fontsize=8)
    ax.set_xticks(range(len(col_names)))
    ax.set_xticklabels(col_names, rotation=30, ha="right", fontsize=7)
    ax.set_yticks(range(len(row_names)))
    ax.set_yticklabels(row_names, fontsize=7)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title(title, fontsize=9)
    return im


def plot_type4(
    accuracy_csv: str,
    confusion_matrix_csv: str,
    out_dir: str,
    k,
    dataset_names: Optional[Sequence[str]] = None,
) -> List[str]:
    """Per-script parity with analysis/kmer_plots_type_4.R: per-dataset
    accuracy-vs-k curves from the exp4/exp6 concatenated accuracy CSV
    ((TP+TN)/total), plus the row-normalized confusion heatmap for one k
    with the extra 'Unidentified' column."""
    per_ds: Dict[str, Dict[int, float]] = {}
    with open(accuracy_csv) as fd:
        for line in fd:
            f = line.strip().split(",")
            if len(f) < 6 or f[0] in ("k", ""):
                continue
            kk = int(float(f[0]))
            ds = f[1]
            tp, tn, fp, fn = (float(x) for x in f[2:6])
            tot = tp + tn + fp + fn
            per_ds.setdefault(ds, {})[kk] = (tp + tn) / tot if tot else 0.0
    fig, ax = plt.subplots(figsize=(5.5, 4))
    for i, ds in enumerate(sorted(per_ds, key=_group_key)):
        name = (
            dataset_names[i]
            if dataset_names and i < len(dataset_names)
            else f"Dataset: {ds}"
        )
        ks = sorted(per_ds[ds])
        ax.plot(ks, [per_ds[ds][kk] for kk in ks], marker="o", ms=3, label=name)
    ax.set_xlabel("Kmer Length (k)")
    ax.set_ylabel("Accuracy")
    ax.set_title("Kmer Classification Accuracy Using LCA Across Groups", fontsize=9)
    ax.legend(fontsize=7)
    out = [_save(fig, os.path.join(out_dir, "accuracy_plot.png"))]

    norm = _normalized_confusion(confusion_matrix_csv)
    d = norm.shape[0]
    rows = list(dataset_names[:d]) if dataset_names else [f"dataset_{i+1}" for i in range(d)]
    cols = rows + (["Unidentified"] if norm.shape[1] == d + 1 else [])
    fig, ax = plt.subplots(figsize=(5, 4.5))
    im = _heatmap(ax, norm, rows, cols, f"Confusion Matrix for k = {k}")
    fig.colorbar(im, ax=ax, label="% Kmers")
    out.append(
        _save(fig, os.path.join(out_dir, f"k_{k}_confusion_matrix_normalized.png"))
    )
    return out


def plot_type5(
    confusion_matrix_csv: str,
    out_dir: str,
    dataset_names: Optional[Sequence[str]] = None,
) -> str:
    """Per-script parity with analysis/kmer_plots_type_5.R: one
    row-normalized confusion heatmap (no Unidentified column label)."""
    norm = _normalized_confusion(confusion_matrix_csv)
    d = norm.shape[0]
    rows = list(dataset_names[:d]) if dataset_names else [f"dataset_{i+1}" for i in range(d)]
    cols = rows + (["Unidentified"] if norm.shape[1] > d else [])
    fig, ax = plt.subplots(figsize=(5, 4.5))
    im = _heatmap(ax, norm, rows, cols[: norm.shape[1]], "")
    fig.colorbar(im, ax=ax, label="% Kmers")
    return _save(fig, os.path.join(out_dir, "confusion_matrix_normalized.png"))


def plot_database_percent_bars(
    across_csv_by_percent: Dict[int, str],
    out_dir: str,
    dataset_names: Optional[Sequence[str]] = None,
) -> List[str]:
    """Per-script parity with analysis/database_percent_comparison.R: per
    pivot, stacked fill-bars of the across-group occurrence bands vs
    DATABASE SIZE percent, plus the percent-unique-to-pivot bar chart.
    across_csv_by_percent maps database-size % -> that run's exp2 across
    CSV (one k per run, the reference's subsetting experiment)."""
    by_group: Dict[str, List[tuple]] = {}
    for pct in sorted(across_csv_by_percent):
        for r in _read_csv(across_csv_by_percent[pct]):
            by_group.setdefault(r["group_num"], []).append((pct, r))
    out: List[str] = []
    for pos, group in enumerate(sorted(by_group, key=_group_key), start=1):
        entries = by_group[group]
        name = (
            dataset_names[pos - 1]
            if dataset_names and pos <= len(dataset_names)
            else group
        )
        sub = [dict(r, database_size=str(pct)) for pct, r in entries]
        fig, ax = plt.subplots(figsize=(5.5, 4))
        _stacked_fill_bars(ax, sub, ACROSS_BANDS_T2, x_key="database_size")
        ax.set_xlabel("Database Size (% RefSeq)")
        ax.set_ylabel("Ratio of Unique Kmers")
        ax.set_title(name, fontsize=9)
        ax.legend(fontsize=6, loc="lower right")
        out.append(_save(fig, os.path.join(out_dir, f"subset_across_{pos}.png")))

        fig, ax = plt.subplots(figsize=(5.5, 4))
        pcts = [pct for pct, _ in entries]
        uniq = [float(r["percent_1_occ"]) for _, r in entries]
        ax.bar([str(p) for p in pcts], uniq, color="steelblue")
        ax.set_xlabel("Database Size (% RefSeq)")
        ax.set_ylabel("% Kmers Unique to Pivot")
        ax.set_title(name, fontsize=9)
        out.append(_save(fig, os.path.join(out_dir, f"subset_unique_across_{pos}.png")))
    return out


def plot_type3(final_csv: str, out_path: str) -> str:
    """Grouped bars: intersection percent per (pivot, dataset) across k."""
    rows = _read_csv(final_csv)
    read_types = sorted({r["read_type"] for r in rows})
    pivots = sorted({r["pivot_num"] for r in rows})
    fig, axes = plt.subplots(
        len(read_types), len(pivots), figsize=(4 * len(pivots), 3 * len(read_types)),
        squeeze=False,
    )
    for ri, rt in enumerate(read_types):
        for pi, p in enumerate(pivots):
            ax = axes[ri][pi]
            sub = [r for r in rows if r["read_type"] == rt and r["pivot_num"] == p]
            datasets = sorted({r["dataset_num"] for r in sub})
            for ds in datasets:
                dsub = [r for r in sub if r["dataset_num"] == ds]
                ks = [int(r["k"]) for r in dsub]
                ax.plot(ks, [float(r["intersection_percent"]) for r in dsub],
                        marker="o", ms=3, label=f"dataset {ds}")
            ax.set_title(f"{rt} pivot {p}", fontsize=8)
            ax.set_xlabel("k")
            if pi == 0:
                ax.set_ylabel("intersection %")
                ax.legend(fontsize=6)
    return _save(fig, out_path)


def plot_confusion_heatmap(matrix_csv: str, out_path: str, labels: Optional[List[str]] = None) -> str:
    with open(matrix_csv) as fd:
        matrix = np.array(
            [[float(x) for x in line.strip().split(",")] for line in fd if line.strip()]
        )
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(matrix, cmap="viridis")
    for (i, j), v in np.ndenumerate(matrix):
        ax.text(j, i, f"{v:.0f}", ha="center", va="center", color="w", fontsize=7)
    fig.colorbar(im)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    if labels:
        ax.set_xticks(range(len(labels)), labels, rotation=45, fontsize=7)
        ax.set_yticks(range(len(matrix)), labels[: len(matrix)], fontsize=7)
    return _save(fig, out_path)


def _f1(tp, tn, fp, fn):
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def plot_accuracy_curves(acc_csv: str, out_path: str, num_cols: int = 10) -> str:
    """F1 per pivot across k from a [k,pivot,TP,TN,FP,FN,...] CSV."""
    series: Dict[str, List[tuple]] = {}
    with open(acc_csv) as fd:
        for line in fd:
            f = line.strip().split(",")
            if len(f) < 6 or f[0] == "k":  # skip trial-CSV header
                continue
            k, pivot = int(float(f[0])), f[1]
            tp, tn, fp, fn = (float(x) for x in f[2:6])
            series.setdefault(pivot, []).append((k, _f1(tp, tn, fp, fn)))
    fig, ax = plt.subplots(figsize=(6, 4))
    for pivot, pts in sorted(series.items()):
        pts.sort()
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", ms=3,
                label=f"pivot {pivot}")
    ax.set_xlabel("k")
    ax.set_ylabel("F1")
    ax.legend(fontsize=7)
    return _save(fig, out_path)


def plot_species_comparison(
    trial_csvs: Sequence[str], out_path: str
) -> str:
    """Mean F1 +/- sd ribbon across trials per k
    (species_overall_comparison.R:45-92 role)."""
    per_k: Dict[int, List[float]] = {}
    for path in trial_csvs:
        with open(path) as fd:
            for line in fd:
                f = line.strip().split(",")
                if len(f) < 6 or f[0] == "k":  # skip trial-CSV header
                    continue
                k = int(float(f[0]))
                tp, tn, fp, fn = (float(x) for x in f[2:6])
                per_k.setdefault(k, []).append(_f1(tp, tn, fp, fn))
    ks = sorted(per_k)
    mean = np.array([np.mean(per_k[k]) for k in ks])
    # sample sd (ddof=1) to match R's sd(); 0 for single-trial data
    sd = np.array(
        [np.std(per_k[k], ddof=1) if len(per_k[k]) > 1 else 0.0 for k in ks]
    )
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(ks, mean, marker="o", ms=3)
    ax.fill_between(ks, mean - sd, mean + sd, alpha=0.3)
    ax.set_xlabel("k")
    ax.set_ylabel("F1 (mean +/- sd across trials)")
    return _save(fig, out_path)


def plot_species_read_comparison(
    trial_csvs_by_read_type: Dict[str, Sequence[str]], out_path: str
) -> str:
    """Read-level F1 ribbons across k, one line pair per read type
    (species_read_comparison.R:32-68 role, over exp6 trial CSVs).

    Input CSVs follow exp6's trial schema
    `k,pivot,TP,TN,FP,FN,TP-U,TN-U,FP-U,FN-U` (exp_type_6.smk:357-361);
    for each read type ("short"/"long") the solid line is mean F1 of the
    base columns and the dashed line is mean F1 of the with-unidentified
    columns (the R script's f1_avg vs f12_avg), each with a +/- sd ribbon
    across trials.
    """
    fig, ax = plt.subplots(figsize=(6, 4))
    for read_type in sorted(trial_csvs_by_read_type):
        per_k: Dict[int, List[float]] = {}
        per_k_u: Dict[int, List[float]] = {}
        for path in trial_csvs_by_read_type[read_type]:
            with open(path) as fd:
                for line in fd:
                    f = line.strip().split(",")
                    if len(f) < 10 or f[0] == "k":  # skip trial-CSV header
                        continue
                    k = int(float(f[0]))
                    tp, tn, fp, fn = (float(x) for x in f[2:6])
                    tpu_, tnu, fpu, fnu = (float(x) for x in f[6:10])
                    per_k.setdefault(k, []).append(_f1(tp, tn, fp, fn))
                    per_k_u.setdefault(k, []).append(_f1(tpu_, tnu, fpu, fnu))
        for data, style, label in (
            (per_k, "-", f"{read_type} F1"),
            (per_k_u, "--", f"{read_type} F1 (with unidentified)"),
        ):
            ks = sorted(data)
            if not ks:
                continue
            mean = np.array([np.mean(data[k]) for k in ks])
            # sample sd (ddof=1) to match R's sd(); 0 for single-trial data
            sd = np.array(
                [np.std(data[k], ddof=1) if len(data[k]) > 1 else 0.0 for k in ks]
            )
            (line,) = ax.plot(ks, mean, style, marker="o", ms=3, label=label)
            ax.fill_between(ks, mean - sd, mean + sd, alpha=0.2,
                            color=line.get_color())
    ax.set_xlabel("Kmer length (k)")
    ax.set_ylabel("F1")
    ax.legend(fontsize=7)
    return _save(fig, out_path)


def plot_database_percent(
    csv_by_percent: Dict[int, str], out_path: str
) -> str:
    """unique_stat_norm vs database size percent
    (database_percent_comparison.R role). csv_by_percent maps the percent
    of the database used to that run's step_5 CSV."""
    fig, ax = plt.subplots(figsize=(6, 4))
    for pct in sorted(csv_by_percent):
        rows = _read_csv(csv_by_percent[pct])
        ks = [int(r["k"]) for r in rows]
        vals = [float(r["unique_stat_norm"]) for r in rows]
        ax.plot(ks, vals, marker="o", ms=3, label=f"{pct}% of database")
    ax.set_xlabel("k")
    ax.set_ylabel("unique_stat_norm")
    ax.legend(fontsize=7)
    return _save(fig, out_path)
