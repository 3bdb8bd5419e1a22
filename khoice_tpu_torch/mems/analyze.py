# Copied from khoice_tpu/mems/analyze.py.
"""MEM/half-MEM confusion matrix analysis (analyze_sam.py semantics).

Reference behavior (src/analyze_sam.py):
- noise = log4(total reference length) from the .fai (lines 41-46)
- MEM feature weight = name-length - noise, dropped if negative (64-69);
  half-MEM weight = 1 (77-81); threshold filter on name-length (63)
- feature-level: weight spread 1/|dataset set| across matched columns
  (93-109); read-level: features grouped by read number, weight
  (len(seq) - noise)/|matches| votes, argmax with random tie-break
  (110-147) — seeded here per the contract (SURVEY.md section 7.1)
- outputs confusion_matrix.csv / accuracy_values.csv via csv.writer
  (151-166), which uses CRLF line endings — kept for byte fidelity.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .sam import read_sam


def noise_from_length(total_length: int) -> float:
    return math.log(total_length, 4)


def _feature_length(qname: str) -> int:
    return int(qname.split("_")[5])


def _read_num(qname: str) -> int:
    return int(qname.split("_")[1])


def analyze_features(
    sam_dir: str,
    num_datasets: int,
    mems: bool = False,
    half_mems: bool = False,
    noise: float = 0.0,
    threshold: int = 0,
    read_seqs: Optional[Dict[int, List[tuple]]] = None,
    rng: Optional[np.random.Generator] = None,
):
    """Build the D x D confusion matrix from pivot_{i}_align_dataset_{j}.sam.

    read_seqs: {pivot_num(1-based): [(feature_name, feature_seq), ...]} for
    read-level analysis (the pivot_{i}.fastq role), else feature-level.
    """
    assert mems != half_mems, "choose exactly one of mems/half_mems"
    cm = [[0 for _ in range(num_datasets)] for _ in range(num_datasets)]
    rng = rng or np.random.default_rng(0)

    for i in range(num_datasets):
        read_mappings: Dict[str, list] = {}
        for j in range(num_datasets):
            sam_path = os.path.join(
                sam_dir, f"pivot_{i + 1}_align_dataset_{j + 1}.sam"
            )
            for rec in read_sam(sam_path):
                qlen = _feature_length(rec.qname)
                if qlen < threshold:
                    continue
                if mems:
                    if qlen - noise >= 0:
                        if rec.qname not in read_mappings:
                            read_mappings[rec.qname] = [qlen - noise]
                        read_mappings[rec.qname].append(j)
                else:
                    if rec.qname not in read_mappings:
                        read_mappings[rec.qname] = [qlen]
                    read_mappings[rec.qname].append(j)

        if read_seqs is None:  # feature-level
            for key, entry in read_mappings.items():
                mem_len = entry[0]
                cur = set(entry[1:])
                for dataset in cur:
                    if mems:
                        cm[i][dataset] += 1 / len(cur) * mem_len
                    else:
                        cm[i][dataset] += 1 / len(cur)
        else:  # read-level
            feats = read_seqs.get(i + 1, [])
            by_read: Dict[int, list] = {}
            for name, seq in feats:
                by_read.setdefault(_read_num(name), []).append((name, seq))
            for rnum in sorted(by_read):
                weights = np.zeros(num_datasets)
                for name, seq in by_read[rnum]:
                    weight = len(seq) - noise
                    if name in read_mappings:
                        matches = set(read_mappings[name][1:])
                        for m in matches:
                            weights[m] += 1 / len(matches) * weight
                mx = weights.max()
                idxs = np.nonzero(weights == mx)[0]
                choice = int(idxs[rng.integers(0, len(idxs))]) if len(idxs) > 1 else int(idxs[0])
                cm[i][choice] += 1
    return cm


def accuracy_values_dxd(cm: Sequence[Sequence], num_datasets: int) -> List[list]:
    """One-vs-rest over the D x D matrix (analyze_sam.py:18-34 — no extra
    unidentified column, unlike merge_lists)."""
    out = []
    for pivot in range(num_datasets):
        tp = cm[pivot][pivot]
        fp = fn = tn = 0
        for row in range(num_datasets):
            for col in range(num_datasets):
                cur = cm[row][col]
                if col == pivot and row != pivot:
                    fp += cur
                elif row == pivot and col != pivot:
                    fn += cur
                elif row != pivot:
                    tn += cur
        out.append([pivot, tp, tn, fp, fn])
    return out


def write_outputs(output_dir: str, cm, num_datasets: int) -> dict:
    os.makedirs(output_dir, exist_ok=True)
    matrix_path = os.path.join(output_dir, "confusion_matrix.csv")
    values_path = os.path.join(output_dir, "accuracy_values.csv")
    with open(matrix_path, "w+") as fd:
        writer = csv.writer(fd)
        for row in cm:
            writer.writerow(row)
    with open(values_path, "w+") as fd:
        writer = csv.writer(fd)
        for score in accuracy_values_dxd(cm, num_datasets):
            writer.writerow(score)
    return {"confusion_matrix": matrix_path, "accuracy_values": values_path}
