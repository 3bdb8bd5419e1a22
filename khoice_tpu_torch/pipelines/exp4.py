"""Experiment 4: genome-level k-mer confusion matrix (port of
khoice_tpu/pipelines/exp4.py, its shared-sort path).

For each k, each pivot genome's raw-count k-mers are annotated against
every dataset's rest-of-set union, and merge_lists.py's feature-level
weighting (src/merge_lists.py:134-149) gives a D x (D+1) confusion
matrix and one-vs-rest accuracy values.  In-pivot vs out-pivot follows
the OUT_PIVOT switch (exp_type_4.smk:50-52: in-pivot adds the pivot to
its own rest_of_set).

Per pivot, ONE doubled-text sort serves every k's feature buckets (the
pivot multiplicities ride the presence-mask scan as a segmented sum,
engine/ksweep_classify.py).  The ks the plan cannot serve (a class of
< 3 ks) take the JAX package's per-(pivot, k) annotation: the pivot's
count table annotated against every dataset's group set in one sort
(classify/annotate.py), over a KmerEngine.  With a key-range group
(`group`, the JAX package's `mesh`) each pivot's sweep runs sharded over
its ranks (dist/ksweep_classify.py).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

from ..classify.annotate import feature_buckets
from ..classify.confusion import (
    accuracy_values,
    feature_confusion_rows,
    write_accuracy_csv,
    write_confusion_matrix,
)
from ..dist.ksweep_classify import sharded_feature_buckets_sweep
from ..engine.ksweep_classify import feature_buckets_sweep
from ..engine.session import KmerEngine
from ..io.packing import encode_records


def glob_lexicographic(k_values: Sequence[int]) -> List[int]:
    """Order of `cat values/*.csv` (exp_type_4.smk:299-305): shell glob is
    lexicographic on 'k_{k}_accuracy_values.csv'."""
    return [k for _, k in sorted((f"k_{k}_accuracy_values.csv", k) for k in k_values)]


def run_exp4(
    pivots: Dict[int, List[str]],
    rest_of_set: Dict[int, List[List[str]]],
    k_values: Sequence[int],
    out_dir: str,
    device,
    count_cs: int = 255,
    union_cs: int = 5000,
    device_budget_bytes: int | None = None,
    group=None,
) -> str:
    """pivots: {num: pivot record seqs}; rest_of_set: {num: [genome,...]}
    (with the pivot already included per dataset when doing in-pivot).
    Every sweep runs on `device`, within `device_budget_bytes` (default
    ~85% of the device).  With `group` (a dist/mesh.py KvGroup) every rank
    calls run_exp4 with the same arguments, the sweeps run over the ranks,
    and rank 0 alone runs the per-k annotation of the ks they leave over
    and writes the files.

    Writes accuracies_type_4/{confusion_matrix,values}/ and the
    concatenated accuracy_values.csv; returns the concatenated path."""
    eng = KmerEngine(device, device_budget_bytes)
    nums = sorted(rest_of_set)
    d = len(nums)
    acc_dir = os.path.join(out_dir, "accuracies_type_4")

    pivot_codes = {num: encode_records(pivots[num]) for num in nums}
    group_codes = [
        encode_records([s for g in rest_of_set[num] for s in g]) for num in nums
    ]
    swept: Dict[int, dict] = {}
    for num in nums:
        if group is None:
            swept[num], _ = feature_buckets_sweep(
                [pivot_codes[num]] + group_codes, d, k_values, cap=count_cs,
                cs=union_cs, device=device, device_budget_bytes=device_budget_bytes,
            )
        else:
            swept[num], _ = sharded_feature_buckets_sweep(
                group, [pivot_codes[num]] + group_codes, d, k_values, cap=count_cs,
                cs=union_cs, device_budget_bytes=device_budget_bytes,
            )
    final = os.path.join(acc_dir, "accuracy_values.csv")
    if group is not None and group.rank != 0:  # rank 0 writes
        return final

    for k in k_values:
        if k not in swept[nums[0]]:  # the per-k path: every pivot's plan is the same
            # a group set (set_counts 1 of the member union) is the k-mer set
            # of the concatenated members (exp_type_4.smk:180-213 role)
            group_sets = [eng.set_counts(eng.count_codes(c, k, cs=count_cs), 1)
                          for c in group_codes]
            for num in nums:
                pivot_table = eng.count_codes(pivot_codes[num], k, cs=count_cs)
                swept[num][k] = feature_buckets(eng.annotate(pivot_table, group_sets))
        cm, cm_ucol = [], []
        for num in nums:
            buckets, unique = swept[num][k]
            regular, ucol = feature_confusion_rows(buckets, unique)
            cm.append(regular)
            cm_ucol.append(ucol)

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

    with open(final, "w") as out_fd:
        for k in glob_lexicographic(k_values):
            with open(os.path.join(acc_dir, f"values/k_{k}_accuracy_values.csv")) as fd:
                out_fd.write(fd.read())
    return final
