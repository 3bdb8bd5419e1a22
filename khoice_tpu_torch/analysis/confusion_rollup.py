# Copied from khoice_tpu/analysis/confusion_rollup.py.
"""Re-derive accuracy values from a directory of confusion matrices.

Equivalent of src/analyze_confusion.py in the reference: walks its OWN
k-grid (7..22 step 1, 23..36 step 2, 38..52 step 3 — deliberately
different from the workflow's grid, src/analyze_confusion.py:6), loads
k_{k}_confusion_matrix.csv files, and emits one-vs-rest
[k, pivot, TP, TN, FP, FN] rows to {short,long}_accuracy_values.csv.
"""

from __future__ import annotations

import csv
import os
from typing import List, Sequence

ROLLUP_K_VALUES = (
    [str(x) for x in range(7, 23, 1)]
    + [str(x) for x in range(23, 37, 2)]
    + [str(x) for x in range(38, 53, 3)]
)


def rollup_confusion_dir(
    matrix_dir: str,
    num_datasets: int,
    output_dir: str,
    read_length: str = "short",
    k_values: Sequence[str] | None = None,
) -> str:
    ks = list(k_values) if k_values is not None else ROLLUP_K_VALUES
    all_values: List[list] = []
    for k in ks:
        path = os.path.join(matrix_dir, f"k_{k}_confusion_matrix.csv")
        matrix = []
        with open(path) as fd:
            for line in fd:
                if line.strip():
                    matrix.append([float(x) for x in line.strip().split(",")])
        for pivot in range(num_datasets):
            tp = matrix[pivot][pivot]
            fp = fn = tn = 0
            for row in range(num_datasets):
                for col in range(num_datasets + 1):
                    cur = matrix[row][col]
                    if col == pivot and row != pivot:
                        fp += cur
                    elif row == pivot and col != pivot:
                        fn += cur
                    elif row != pivot:
                        tn += cur
            all_values.append([k, pivot, tp, tn, fp, fn])

    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir, f"{read_length}_accuracy_values.csv")
    with open(out, "w+") as fd:
        writer = csv.writer(fd)
        for row in all_values:
            writer.writerow(row)
    return out
