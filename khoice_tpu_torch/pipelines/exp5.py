# Copied from khoice_tpu/pipelines/exp5.py.
"""Experiment 5: genome-level MEM/half-MEM confusion matrix.

Replaces workflow/rules/exp_type_5.smk: matching statistics of each
out-pivot genome against the combined (fwd+revcomp) reference of all
datasets, MEM/half-MEM extraction at the configured threshold
(exp_type_5.smk:137-151), per-dataset locate, feature-level confusion
matrix weighted by (length - noise) for MEMs or 1 for half-MEMs.

Note: the reference's own exp5 analysis rule is bit-rotten (passes the
ref-lists dir as the read dir and omits the .fai argument,
exp_type_5.smk:200-213); this follows the working exp7 analysis pattern
at feature level, per the SURVEY.md section 7.1 contract.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .mem_common import run_mem_experiment


def run_exp5(
    pivots: Dict[int, List[str]],
    datasets: Dict[int, List[List[str]]],
    out_dir: str,
    threshold: int = 15,
    mem_types: Sequence[str] = ("mems", "half_mems"),
    seed: int = 0,
) -> dict:
    out = {}
    for mem_type in mem_types:
        res = run_mem_experiment(
            queries=pivots,
            datasets=datasets,
            out_dir=out_dir,
            mem_type=mem_type,
            extract_threshold=threshold,
            read_level=False,
            seed=seed,
            tag="type_5",
        )
        out[mem_type] = res[0]
    return out
