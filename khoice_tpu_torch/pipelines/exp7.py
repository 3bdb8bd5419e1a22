# Copied from khoice_tpu/pipelines/exp7.py.
"""Experiment 7: read-level MEM/half-MEM confusion matrix.

Replaces workflow/rules/exp_type_7.smk: matching statistics of each
pivot's reads against the combined all-dataset reference, MEM extraction,
per-dataset locate with one best hit (-m 1, exp_type_7.smk:254), and the
read-level weight-vote analysis with noise = log4(total combined length)
(exp_type_7.smk:169-178, src/analyze_sam.py:110-147).

The reference fans exp7 over BOTH read types (illumina + ont,
exp_type_7.smk:36-47) and gathers four final CSVs per trial
(exp7_final_output/trial_{t}_{mem_type}_{read_type}.csv,
exp_type_7.smk:284-292); pass reads as {read_type: {num: [reads]}} to get
that layout.  The legacy {num: [reads]} form (no read_type axis) is kept
for single-type callers.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Sequence

from .mem_common import run_mem_experiment


def run_exp7(
    pivot_reads: Dict,
    datasets: Dict[int, List[List[str]]],
    out_dir: str,
    threshold: int = 15,
    mem_types: Sequence[str] = ("mems", "half_mems"),
    seed: int = 0,
    trial: int = 1,
) -> dict:
    """pivot_reads: {read_type: {num: [reads]}} (reference layout) or
    legacy {num: [reads]}.  Returns {(mem_type, read_type): outputs} in
    the former case, {mem_type: outputs} in the latter."""
    by_type = (
        pivot_reads
        if pivot_reads and all(isinstance(k, str) for k in pivot_reads)
        else {None: pivot_reads}
    )
    out = {}
    final_dir = os.path.join(out_dir, "final_output_type_7")
    for mem_type in mem_types:
        for rt, qreads in by_type.items():
            res = run_mem_experiment(
                queries=qreads,
                datasets=datasets,
                out_dir=out_dir,
                mem_type=mem_type,
                extract_threshold=threshold,
                read_level=True,
                seed=seed,
                tag="type_7",
                read_type=rt,
            )
            if rt is None:
                out[mem_type] = res[0]
            else:
                out[(mem_type, rt)] = res[0]
                # gather rule copies accuracy_values.csv to the trial CSV
                # (exp_type_7.smk:284-300)
                os.makedirs(final_dir, exist_ok=True)
                shutil.copy(
                    res[0]["accuracy_values"],
                    os.path.join(final_dir, f"trial_{trial}_{mem_type}_{rt}.csv"),
                )
    return out
