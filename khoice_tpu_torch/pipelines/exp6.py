"""Experiment 6: read-level k-mer confusion matrix (port of
khoice_tpu/pipelines/exp6.py, its single-device path).

Replaces workflow/rules/exp_type_6.smk + merge_lists.py -r: per
(k, read_type), each pivot's simulated reads are voted against the
per-dataset group texts; each read votes with weight 1/|matches| per
k-mer (exact LCM-scaled int64 integers here), argmax with seeded random
tie-break classifies it (src/merge_lists.py:151-183), and one-vs-rest
accuracy rows concatenate into trial_{t}_{short,long}_acc.csv with
U-columns (exp_type_6.smk:349-362).

Per k, ALL pivots' reads ride ONE merge-join sort with the group texts
(classify/annotate.py::read_votes_bulk_multi), on `device`, each k's
device bytes checked against the budget first.  The JAX package's mesh
path (dist/vote.py) is not ported.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from ..classify.annotate import (
    concat_flat_reads,
    flat_reads_device,
    pack_group_texts,
    read_votes_bulk_multi,
)
from ..classify.confusion import (
    accuracy_values,
    read_level_confusion_row,
    write_accuracy_csv,
    write_confusion_matrix,
)
from ..io.packing import encode_records, encode_seq
from .exp4 import glob_lexicographic

READ_TYPE_LABEL = {"illumina": "short", "ont": "long"}


def reads_matrix(reads: Sequence[str]) -> np.ndarray:
    """[R, Lmax] uint8 code matrix, short reads padded with separator 4s
    (one encode pass; boolean assignment fills row-major, which is the
    reads' concatenation order)."""
    n = len(reads)
    lens = np.fromiter((len(r) for r in reads), np.int64, n)
    lmax = int(lens.max())
    out = np.full((n, lmax), 4, np.uint8)
    out[np.arange(lmax)[None, :] < lens[:, None]] = encode_seq("".join(reads))
    return out


def run_exp6(
    pivot_reads: Dict[int, List[str]],
    rest_of_set: Dict[int, List[List[str]]],
    k_values: Sequence[int],
    out_dir: str,
    device,
    read_type: str = "illumina",
    trial: int = 1,
    seed: int = 0,
    device_budget_bytes: int | None = None,
) -> str:
    """pivot_reads: {num: [read strings]} (exp0 subset output);
    rest_of_set: {num: [genome,...]}.  Every k's votes run on `device`,
    within `device_budget_bytes` (default ~85% of the device).  Returns the
    trial accuracy CSV path."""
    nums = sorted(rest_of_set)
    d = len(nums)
    label = READ_TYPE_LABEL.get(read_type, read_type)
    acc_dir = os.path.join(out_dir, f"accuracies_type_6/{read_type}")

    group = pack_group_texts(
        [encode_records([s for g in rest_of_set[num] for s in g]) for num in nums], device)
    big_flat, spans = concat_flat_reads(
        [flat_reads_device(reads_matrix(pivot_reads[num]), device) for num in nums])
    for k in k_values:
        per_pivot = read_votes_bulk_multi(group, big_flat, spans, k, d, device_budget_bytes)
        cm = []
        for num, (votes, _unmatched, _nk) in zip(nums, per_pivot):
            rng = np.random.default_rng([seed, trial, k, num])
            cm.append(list(read_level_confusion_row(votes, d, rng)))
        # the regular and with-unidentified matrices take the SAME class
        # increments (reference merge_lists.py:182-183)
        _write_k_outputs(acc_dir, k, cm, [list(row) for row in cm], d)

    final = os.path.join(out_dir, f"trial_{trial}_{label}_acc.csv")
    with open(final, "w") as out_fd:
        # header printf'd before the cat in the reference (exp_type_6.smk:357)
        out_fd.write("k,pivotnum,TP,TN,FP,FN,TP-U,TN-U,FP-U,FN-U\n")
        for k in glob_lexicographic(k_values):
            with open(os.path.join(acc_dir, f"values/k_{k}_accuracy_values.csv")) as fd:
                out_fd.write(fd.read())
    return final


def _write_k_outputs(acc_dir: str, k: int, cm, cm_ucol, d: int) -> None:
    write_confusion_matrix(
        os.path.join(acc_dir, f"confusion_matrix/k_{k}_confusion_matrix.txt"), cm
    )
    write_confusion_matrix(
        os.path.join(
            acc_dir, f"confusion_matrix/k_{k}_confusion_matrix_with_unidentified.txt"
        ),
        cm_ucol,
    )
    write_accuracy_csv(
        os.path.join(acc_dir, f"values/k_{k}_accuracy_values.csv"),
        accuracy_values(cm, d, str(k)),
        accuracy_values(cm_ucol, d, str(k)),
    )
