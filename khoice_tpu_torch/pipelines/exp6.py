"""Experiment 6: read-level k-mer confusion matrix (port of
khoice_tpu/pipelines/exp6.py).

Replaces workflow/rules/exp_type_6.smk + merge_lists.py -r: per
(k, read_type), each pivot's simulated reads are voted against the
per-dataset group texts; each read votes with weight 1/|matches| per
k-mer (exact LCM-scaled int64 integers here), argmax with seeded random
tie-break classifies it (src/merge_lists.py:151-183), and one-vs-rest
accuracy rows concatenate into trial_{t}_{short,long}_acc.csv with
U-columns (exp_type_6.smk:349-362).

Per k, ALL pivots' reads ride ONE merge-join sort with the group texts
(classify/annotate.py::read_votes_bulk_multi), on `device`, each k's
device bytes checked against the budget first.  With a key-range group
(`group`, the JAX package's `mesh`) the votes ride the sharded merge-join
(dist/vote.py), equal to the single-device votes; every rank votes, and
rank 0 writes the files.
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
from ..utils import trace
from .exp4 import glob_lexicographic

READ_TYPE_LABEL = {"illumina": "short", "ont": "long"}


def reads_matrix(reads: Sequence[str]) -> np.ndarray:
    """[R, Lmax] uint8 code matrix, short reads padded with separator 4s
    (one encode pass; boolean assignment fills row-major, which is the
    reads' concatenation order)."""
    with trace.span("io:reads_matrix"):
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
    group=None,
) -> str:
    """pivot_reads: {num: [read strings]} (exp0 subset output);
    rest_of_set: {num: [genome,...]}.  Every k's votes run on `device`, or
    over `group`'s ranks (a dist/mesh.py KvGroup; every rank must hold the
    same texts and reads), within `device_budget_bytes` (default ~85% of
    the device).  Returns the trial accuracy CSV path."""
    with trace.span("pipeline:exp6"):  # the body's locals are freed inside the span
        return _run_exp6(pivot_reads, rest_of_set, k_values, out_dir, device, read_type, trial,
                         seed, device_budget_bytes, group)


def _run_exp6(pivot_reads, rest_of_set, k_values, out_dir, device, read_type, trial, seed,
              device_budget_bytes, group) -> str:
    nums = sorted(rest_of_set)
    d = len(nums)
    label = READ_TYPE_LABEL.get(read_type, read_type)
    acc_dir = os.path.join(out_dir, f"accuracies_type_6/{read_type}")
    final = os.path.join(out_dir, f"trial_{trial}_{label}_acc.csv")

    group_codes = [encode_records([s for g in rest_of_set[num] for s in g]) for num in nums]
    read_mats = [reads_matrix(pivot_reads[num]) for num in nums]
    if group is None:
        texts = pack_group_texts(group_codes, device)
        big_flat, spans = concat_flat_reads([flat_reads_device(m, device) for m in read_mats])

        def votes_of(k):
            return read_votes_bulk_multi(texts, big_flat, spans, k, d, device_budget_bytes)
    else:
        from ..dist.vote import sharded_read_votes_multi

        votes_of = sharded_read_votes_multi(group, group_codes, read_mats, k_values,
                                            device_budget_bytes=device_budget_bytes).get
        if group.rank != 0:  # rank 0 writes
            return final
    for k in k_values:
        votes = votes_of(k)
        with trace.span("reports:confusion"):
            cm = []
            for num, (v, _unmatched, _nk) in zip(nums, votes):
                rng = np.random.default_rng([seed, trial, k, num])
                cm.append(list(read_level_confusion_row(v, d, rng)))
            del votes
        # the regular and with-unidentified matrices take the SAME class
        # increments (reference merge_lists.py:182-183)
        _write_k_outputs(acc_dir, k, cm, [list(row) for row in cm], d)

    with trace.span("reports:exp6_outputs"), open(final, "w") as out_fd:
        # header printf'd before the cat in the reference (exp_type_6.smk:357)
        out_fd.write("k,pivotnum,TP,TN,FP,FN,TP-U,TN-U,FP-U,FN-U\n")
        for k in glob_lexicographic(k_values):
            with open(os.path.join(acc_dir, f"values/k_{k}_accuracy_values.csv")) as fd:
                out_fd.write(fd.read())
    return final


def _write_k_outputs(acc_dir: str, k: int, cm, cm_ucol, d: int) -> None:
    with trace.span("reports:exp6_outputs"):
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
