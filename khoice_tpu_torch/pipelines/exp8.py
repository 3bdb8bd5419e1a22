# Copied from khoice_tpu/pipelines/exp8.py.
"""Experiment 8: MEM threshold sweep over read queries.

Replaces workflow/rules/exp_type_8.smk: reads are simulated from each
pivot (Illumina at 2x fold, pbsim-style ONT at depth 30 / length-min 200,
exp_type_8.smk:85-109), subset to the FIRST num_reads_per_dataset reads
(the `head -n` rule, exp_type_8.smk:110-135); features are extracted at
the low threshold -t 2 (exp_type_8.smk:192-201), then the analysis
threshold t is swept over the t-grid (workflow/Snakefile:39) producing
one confusion matrix per (mem_type, t, read_type)
(output_type_8/{mem_type}/t_{t}/{read_type}/, exp_type_8.smk:247-261).

The reference's exp8 analysis stage is bit-rotten (SAMs written under
sam_type_8/ but read from sam/, and names only exp7 produces — SURVEY.md
section 2.1 item 11); this implements the evidently intended behavior via
the working exp7 pattern, as the survey contract prescribes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..config import default_t_values
from .mem_common import run_mem_experiment

EXTRACT_THRESHOLD = 2  # reference exp_type_8.smk:192-201


def simulate_exp8_reads(
    pivots: Dict[int, List[str]],
    num_reads: int,
    seed: int = 0,
) -> Dict[str, Dict[int, List[str]]]:
    """{read_type: {num: reads}} — exp8's own simulation + head-N subset.

    Illumina: art 2x fold coverage (exp_type_8.smk:92); ONT: pbsim depth
    30, accuracy 0.95, length-min 200 (exp_type_8.smk:100-103; length-max
    follows our simulator's 1100 default — pbsim's unbounded length tail
    is a documented divergence).  The subset takes the FIRST num_reads
    reads like the reference's `head -n {num_reads*4}`
    (exp_type_8.smk:118-121,130-133)."""
    from ..sim.reads import sim_illumina, sim_ont

    out: Dict[str, Dict[int, List[str]]] = {"illumina": {}, "ont": {}}
    for num in sorted(pivots):
        rng = np.random.default_rng([seed, 8, num, 0])
        out["illumina"][num] = sim_illumina(pivots[num], rng, coverage=2.0)[:num_reads]
        rng = np.random.default_rng([seed, 8, num, 1])
        out["ont"][num] = sim_ont(
            pivots[num], rng, depth=30.0, length_min=200
        )[:num_reads]
    return out


def run_exp8(
    pivot_reads: Dict,
    datasets: Dict[int, List[List[str]]],
    out_dir: str,
    t_values: Sequence[int] | None = None,
    mem_types: Sequence[str] = ("mems", "half_mems"),
    seed: int = 0,
) -> dict:
    """pivot_reads: {read_type: {num: [reads]}} (reference layout, see
    simulate_exp8_reads) or legacy {num: [reads]}.  Returns
    {(mem_type, read_type): {t: outputs}} / {mem_type: {t: outputs}}."""
    ts = [int(t) for t in (t_values or default_t_values())]
    by_type = (
        pivot_reads
        if pivot_reads and all(isinstance(k, str) for k in pivot_reads)
        else {None: pivot_reads}
    )
    out = {}
    for mem_type in mem_types:
        for rt, qreads in by_type.items():
            res = run_mem_experiment(
                queries=qreads,
                datasets=datasets,
                out_dir=out_dir,
                mem_type=mem_type,
                extract_threshold=EXTRACT_THRESHOLD,
                read_level=True,
                analysis_thresholds=ts,
                seed=seed,
                tag="type_8",
                read_type=rt,
            )
            out[mem_type if rt is None else (mem_type, rt)] = res
    return out
