# Copied from khoice_tpu/pipelines/exp0.py.
"""Experiment 0: data preparation — pivots, simulated reads, subsetting.

Replaces workflow/rules/prepare_data.smk: per dataset, a seeded random
pivot genome is chosen (the reference uses `shuf | head -n1`,
prepare_data.smk:55 — made seedable per SURVEY.md section 7.1), Illumina-
and ONT-like reads are simulated from it, and reads are subset to the
configured k-mer budget at k=31 (prepare_data.smk:116). Outputs keep the
reference's trial_{t}/ directory layout so downstream experiments and
resume logic carry over.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..config import KhoiceConfig
from ..io.fasta import FastaRecord, read_fasta_files, write_fasta
from ..sim.reads import sim_illumina, sim_ont, subset_reads_kmers
from ..utils import trace

READ_TYPES = ("illumina", "ont")


def run_exp0(
    database: Dict[int, Dict[str, List[str]]],
    cfg: KhoiceConfig,
    trial: int,
    out_dir: str,
) -> Dict:
    """database: {dataset_num: {genome_name: [record seqs]}}.

    Returns {"pivots": {num: name}, "reads": {(num, read_type): [read strs]},
    "nonpivots": {num: [names]}} and writes the trial_{t}/ layout.
    """
    troot = os.path.join(out_dir, f"trial_{trial}")
    pivots: Dict[int, str] = {}
    nonpivots: Dict[int, List[str]] = {}
    reads_out: Dict[tuple, List[str]] = {}

    for num in sorted(database):
        genomes = database[num]
        names = sorted(genomes)
        rng = np.random.default_rng([cfg.seed, trial, num])
        pivot_name = names[int(rng.integers(0, len(names)))]
        pivots[num] = pivot_name
        nonpivots[num] = [n for n in names if n != pivot_name]

        pdir = os.path.join(troot, f"exp0_pivot_genomes/dataset_{num}")
        ndir = os.path.join(troot, f"exp0_nonpivot_genomes/dataset_{num}")
        os.makedirs(pdir, exist_ok=True)
        os.makedirs(ndir, exist_ok=True)
        write_fasta(
            os.path.join(pdir, f"pivot_{num}.fna.gz"),
            [FastaRecord(f"{pivot_name}_{i}", s) for i, s in enumerate(genomes[pivot_name])],
        )
        with open(os.path.join(pdir, "pivot_name.txt"), "w") as fd:
            fd.write(pivot_name + "\n")
        with open(os.path.join(ndir, "nonpivot_names.txt"), "w") as fd:
            for n in nonpivots[num]:
                fd.write(n + "\n")
        for n in nonpivots[num]:
            write_fasta(
                os.path.join(ndir, f"{n}.fna.gz"),
                [FastaRecord(f"{n}_{i}", s) for i, s in enumerate(genomes[n])],
            )

        pivot_seqs = genomes[pivot_name]
        for read_type in READ_TYPES:
            rrng = np.random.default_rng([cfg.read_sim_seed, trial, num, READ_TYPES.index(read_type)])
            if read_type == "illumina":
                raw = sim_illumina(pivot_seqs, rrng)
            else:
                # PBSIM_MODEL (config/config.yaml:11) selects the quality
                # HMM; empty -> accuracy-calibrated default
                raw = sim_ont(
                    pivot_seqs, rrng,
                    model_file=cfg.pbsim_model or None,
                )
            subset = subset_reads_kmers(raw, rrng, cfg.kmers_per_dataset, 31)
            reads_out[(num, read_type)] = subset
            rdir = os.path.join(troot, f"exp0_pivot_reads/dataset_{num}/{read_type}")
            os.makedirs(rdir, exist_ok=True)
            write_fasta(
                os.path.join(rdir, f"pivot_{num}_subset.fa"),
                [FastaRecord(f"read_{i}", s) for i, s in enumerate(subset)],
                gz=False,
            )

    _write_trial_summary(out_dir, trial, sorted(database), pivots, nonpivots, reads_out)
    return {"pivots": pivots, "nonpivots": nonpivots, "reads": reads_out}


def _write_trial_summary(out_dir, trial, nums, pivots, nonpivots, reads_out):
    """Trial summary table (reference prepare_data.smk:122-182 layout)."""
    sdir = os.path.join(out_dir, "trial_summaries")
    os.makedirs(sdir, exist_ok=True)
    rows = [
        ["Dataset #:"] + [str(n) for n in nums],
        ["Pivot Genome:"] + [pivots[n] for n in nums],
        ["# of Illumina Reads:"] + [str(len(reads_out[(n, "illumina")])) for n in nums],
        ["# of ONT Reads:"] + [str(len(reads_out[(n, "ont")])) for n in nums],
        ["Non-Pivot genomes:"],
    ]
    max_np = max(len(nonpivots[n]) for n in nums)
    for i in range(max_np):
        rows.append(
            [""] + [nonpivots[n][i] if i < len(nonpivots[n]) else "" for n in nums]
        )
    widths = [
        max((len(r[c]) for r in rows if c < len(r)), default=0)
        for c in range(1 + len(nums))
    ]
    with open(os.path.join(sdir, f"trial_{trial}_summary.txt"), "w") as fd:
        for r in rows:
            fd.write(
                "  ".join(x.ljust(widths[c]) for c, x in enumerate(r)).rstrip() + "\n"
            )


def load_database_dir(database_root: str, codes: bool = False) -> Dict[int, Dict]:
    """Read a reference-layout database dir: dataset_{i}/*.fna.gz, every
    file at once (io/fasta.read_fasta_files).  {dataset_num: {genome_name:
    [record seqs]}}, genomes in file-name order; with codes=True each
    genome is its records' codes joined as io/packing.encode_records joins
    them."""
    files = []  # (dataset_num, genome_name, path)
    i = 1
    with trace.span("io:read_database"):
        while os.path.isdir(os.path.join(database_root, f"dataset_{i}")):
            ddir = os.path.join(database_root, f"dataset_{i}")
            for f in sorted(os.listdir(ddir)):
                if f.endswith(".fna.gz") or f.endswith(".fna") or f.endswith(".fa"):
                    name = f.split(".fna")[0].split(".fa")[0]
                    files.append((i, name, os.path.join(ddir, f)))
            i += 1
        read = read_fasta_files([path for _, _, path in files], codes=codes)
        out: Dict[int, Dict] = {num: {} for num in range(1, i)}
        for (num, name, _), genome in zip(files, read):
            out[num][name] = genome if codes else [r.seq for r in genome]
    return out
