# Copied from khoice_tpu/classify/confusion.py.
"""Confusion matrices + one-vs-rest accuracy values (merge_lists semantics).

Feature-level rows (reference: src/merge_lists.py:134-149):
  row[d] = sum over pivot k-mers matched by dataset d of count/|matches|,
  plus (regular matrix only) unmatched counts smeared 1/D per column;
  the "with_unidentified" variant drops unmatched weight (last column 0).

Read-level rows (reference: src/merge_lists.py:151-183): one vote-argmax
per read with seeded random tie-breaking (the reference's tie-break uses
unseeded global random state — made reproducible here, per the contract's
"make seedable" note, SURVEY.md section 7.1).

Accuracy values (reference: src/merge_lists.py:35-51): one-vs-rest
[k, pivot, TP, TN, FP, FN] over the (D+1)-column matrix.

Divergence note: the reference accumulates 1/|M| floats in dict order;
here cell values are formed from exact integer buckets, then divided once
in float64 — equal up to accumulation-order rounding, and reproducible.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


def feature_confusion_rows(buckets: np.ndarray, unique_count: int):
    """(regular_row, ucol_row) of length D+1 from integer match buckets."""
    d = buckets.shape[0]
    matched = [
        float(sum(int(buckets[col, m - 1]) / m for m in range(1, d + 1)))
        for col in range(d)
    ]
    regular = [matched[col] + unique_count / d for col in range(d)] + [0]
    ucol = matched + [0]
    return regular, ucol


def read_level_confusion_row(
    votes: np.ndarray, num_datasets: int, rng: np.random.Generator
):
    """Row of read-class counts: argmax votes, uniform random tie-break.

    A read with zero votes ties across ALL classes — uniformly random, the
    same behavior the reference's np.where-max/random.choice produces.
    Fully vectorized with an IDENTICAL rng draw stream to the per-read
    loop it replaces (numpy's Generator.integers with an array bound
    consumes the same bits per element as sequential scalar calls; the
    loop was ~5 s per k at the reference's 830k-read scale): ties draw in
    read order, unique-argmax reads draw nothing.
    """
    votes = np.asarray(votes)
    mx = votes.max(axis=1)
    is_max = votes == mx[:, None]
    nmax = is_max.sum(axis=1)
    choice = np.argmax(is_max, axis=1)  # first max; final for unique rows
    ties = nmax > 1
    if ties.any():
        draw = rng.integers(0, nmax[ties])
        cum = np.cumsum(is_max[ties], axis=1)
        choice[ties] = np.argmax(
            is_max[ties] & (cum == (draw + 1)[:, None]), axis=1
        )
    row = np.bincount(choice, minlength=num_datasets + 1)
    return [int(x) for x in row]


def accuracy_values(confusion_matrix: Sequence[Sequence], num_datasets: int, k) -> List[list]:
    """One-vs-rest [k, pivot, TP, TN, FP, FN] rows over a D x (D+1) matrix."""
    out = []
    for pivot in range(num_datasets):
        tp = confusion_matrix[pivot][pivot]
        fp = fn = tn = 0
        for row in range(num_datasets):
            for col in range(num_datasets + 1):
                cur = confusion_matrix[row][col]
                if col == pivot and row != pivot:
                    fp += cur
                elif row == pivot and col != pivot:
                    fn += cur
                elif row != pivot:
                    tn += cur
        out.append([k, pivot, tp, tn, fp, fn])
    return out


def write_confusion_matrix(path: str, matrix: Sequence[Sequence]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fd:
        for row in matrix:
            fd.write(",".join(str(x) for x in row) + "\n")


def write_accuracy_csv(path: str, scores: List[list], scores_ucol: List[list]) -> None:
    """k_{k}_accuracy_values.csv: [k,pivot,TP,TN,FP,FN,TP-U,TN-U,FP-U,FN-U]
    (reference: src/merge_lists.py:204-210)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fd:
        for a, b in zip(scores, scores_ucol):
            fd.write(
                ",".join(str(x) for x in a) + "," + ",".join(str(x) for x in b[2:]) + "\n"
            )
