"""Experiment 3: read k-mer containment across species databases (port
of khoice_tpu/pipelines/exp3.py, its shared-sort path).

Reads are simulated from each out-pivot genome (Illumina 2x / ONT),
subset to the k-mer budget, and for every (read_type, pivot, k, dataset)
the fraction of the read set's distinct k-mers found in the dataset's
group union is reported:

    intersection_percent = |distinct(reads) ∩ group| / |distinct(reads)|

rounded to 4 (reference exp_type_3.smk:281-320).  The query read sets and
the group unions share ONE doubled-text sort for the whole k grid
(engine/ksweep_classify.py); the ks the plan cannot serve (a class of
< 3 ks) take the JAX package's per-k table ops over a KmerEngine.  With a
key-range group (`group`, the JAX package's `mesh`) the sweep runs sharded
over its ranks (dist/ksweep_classify.py).  Row order: read_type outer,
then pivot, k, dataset (exp_type_3.smk:103-113).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from ..dist.ksweep_classify import sharded_containment_counts_sweep
from ..engine.ksweep_classify import containment_counts_sweep
from ..engine.session import KmerEngine
from ..io.packing import encode_records
from ..reports.csvio import write_csv_rows
from ..sim.reads import sim_illumina, sim_ont, subset_reads_kmers

HEADER = "read_type,pivot_num,k,dataset_num,intersection_percent\n"


def simulate_exp3_reads(
    pivots: Dict[int, List[str]],
    num_kmers: int,
    seed: int = 0,
) -> Dict[tuple, List[str]]:
    """{(read_type, num): [reads]} — Illumina at 2x fold (exp_type_3.smk:129)."""
    out = {}
    for num in sorted(pivots):
        for ridx, read_type in enumerate(("illumina", "ont")):
            rng = np.random.default_rng([seed, 3, num, ridx])
            raw = (
                sim_illumina(pivots[num], rng, coverage=2.0)
                if read_type == "illumina"
                else sim_ont(pivots[num], rng)
            )
            out[(read_type, num)] = subset_reads_kmers(raw, rng, num_kmers, 31)
    return out


def run_exp3(
    reads: Dict[tuple, List[str]],
    rest_of_set: Dict[int, List[List[str]]],
    k_values: Sequence[int],
    out_dir: str,
    device,
    union_cs: int = 5000,
    device_budget_bytes: int | None = None,
    group=None,
) -> str:
    """reads: {(read_type, pivot_num): [read strings]} (see
    simulate_exp3_reads); rest_of_set excludes each pivot (out-pivot).
    The sweep and the per-k table ops run on `device`, within
    `device_budget_bytes` (default ~85% of the device).  With `group` (a
    dist/mesh.py KvGroup) every rank calls run_exp3 with the same
    arguments, the sweep runs over the ranks, and rank 0 alone runs the
    per-k table ops of the ks it leaves over and writes the CSV.  Returns
    the CSV path."""
    eng = KmerEngine(device, device_budget_bytes)
    nums = sorted(rest_of_set)
    read_types = sorted({rt for rt, _ in reads}, key=lambda r: ("illumina", "ont").index(r))

    # queries (read sets, bits 0..nq-1) and group unions (bits nq..nq+D-1)
    # share ONE doubled-text sort for the whole k grid: |distinct(reads)|
    # and |reads ∩ group| are run counts in the same scan
    qkeys = [(rt, num) for rt in read_types for num in nums]
    member_codes = [encode_records(reads[q]) for q in qkeys] + [
        encode_records([s for g in rest_of_set[num] for s in g]) for num in nums
    ]
    if group is None:
        counts, fallback_ks = containment_counts_sweep(
            member_codes, len(qkeys), len(nums), k_values, cs=union_cs, device=device,
            device_budget_bytes=device_budget_bytes,
        )
    else:
        counts, fallback_ks = sharded_containment_counts_sweep(
            group, member_codes, len(qkeys), len(nums), k_values, cs=union_cs,
            device_budget_bytes=device_budget_bytes,
        )
    csv = os.path.join(out_dir, "final_analysis_type3/final_analysis_type3.csv")
    if group is not None and group.rank != 0:  # rank 0 writes
        return csv

    results = {}
    for k, cnt in counts.items():
        for qi, (read_type, pivot_num) in enumerate(qkeys):
            n_pivot = int(cnt[qi, 0])
            assert n_pivot > 0, "empty pivot read k-mer set"
            for gi, num in enumerate(nums):
                results[(read_type, pivot_num, k, num)] = round(
                    int(cnt[qi, 1 + gi]) / n_pivot, 4
                )

    for k in sorted(fallback_ks):
        unions = {
            num: eng.union([eng.set_counts(eng.count_codes(encode_records(g), k), 1)
                            for g in rest_of_set[num]], cs=union_cs)
            for num in nums
        }
        for read_type, pivot_num in qkeys:
            pivot_set = eng.set_counts(
                eng.count_codes(encode_records(reads[(read_type, pivot_num)]), k), 1
            )
            n_pivot = eng.n_present(pivot_set)
            assert n_pivot > 0, "empty pivot read k-mer set"
            for num in nums:
                n_inter = eng.n_present(eng.intersect_sum(pivot_set, unions[num]))
                results[(read_type, pivot_num, k, num)] = round(n_inter / n_pivot, 4)

    rows = [
        [read_type, str(pivot_num), str(k), str(num), results[(read_type, pivot_num, k, num)]]
        for read_type in read_types
        for pivot_num in nums
        for k in k_values
        for num in nums
    ]

    write_csv_rows(csv, HEADER, rows)
    return csv
