# Copied from khoice_tpu/pipelines/mem_common.py.
"""Shared machinery for the MEM-based experiments (exp5/7/8).

Builds the combined forward+reverse-complement reference texts
(reference: exp_type_5.smk:95-110 via seqtk), runs matching statistics,
extracts features, locates them per dataset, and writes the
pivot_{i}_align_dataset_{j}.sam layout that the working exp7 analysis
consumes (exp_type_7.smk:229-256). exp5's and exp8's own analysis rules in
the reference are bit-rotten (wrong SAM names/args, SURVEY.md section 2.1
item 11); all three follow exp7's working pattern here, as the survey
contract prescribes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..io.fasta import revcomp
from ..mems.extract import Feature, extract_half_mems, extract_mems, write_features_fastq
from ..mems.ms import MatchingStatisticsIndex
from ..mems.sam import SamRecord, write_sam

SEP = "#"  # record separator: never matches an ACGT query symbol


def combined_text(dataset_genomes: Sequence[List[str]]) -> Tuple[str, int]:
    """Concatenate records + their reverse complements.

    Returns (text, total_base_length) where total_base_length counts both
    strands — matching the `samtools faidx` total over combined_ref_all
    (fwd + revcomp records) that feeds noise = log4(L)
    (reference exp_type_7.smk:169-178)."""
    parts = []
    total = 0
    for genome in dataset_genomes:
        for seq in genome:
            parts.append(seq)
            total += len(seq)
    fwd = parts
    rc = [revcomp(s) for s in parts]
    return SEP.join(fwd + rc) + SEP, total * 2


def matching_statistics_per_record(
    index: MatchingStatisticsIndex, records: Sequence[str]
) -> List[np.ndarray]:
    """One batch SA pass over the whole read set (spumoni `run -M -n`
    role at its real scale) instead of per-position restart queries."""
    return index.batch_matching_statistics(list(records))


def extract_features(
    records: Sequence[str],
    ms_arrays: Sequence[np.ndarray],
    mem_type: str,
    threshold: int,
) -> List[Feature]:
    if mem_type == "mems":
        return extract_mems(records, ms_arrays, threshold)
    assert mem_type == "half_mems"
    return extract_half_mems(records, ms_arrays, threshold)


def locate_and_write_sams(
    features: List[Feature],
    dataset_indexes: Dict[int, MatchingStatisticsIndex],
    sam_dir: str,
    pivot_num: int,
) -> None:
    """One SAM per (pivot, dataset) with one best hit per feature
    (ri-align -m 1 role, exp_type_7.smk:254)."""
    for num, idx in dataset_indexes.items():
        recs = []
        for f in features:
            pos = idx.locate(f.seq)
            if pos >= 0:
                recs.append(
                    SamRecord(qname=f.name, rname=f"dataset_{num}", pos=pos + 1, seq=f.seq)
                )
        write_sam(
            os.path.join(sam_dir, f"pivot_{pivot_num}_align_dataset_{num}.sam"),
            recs,
        )


def run_mem_experiment(
    queries: Dict[int, List[str]],
    datasets: Dict[int, List[List[str]]],
    out_dir: str,
    mem_type: str,
    extract_threshold: int,
    read_level: bool,
    analysis_thresholds: Sequence[int] = (0,),
    seed: int = 0,
    tag: str = "type_5",
    read_type: str | None = None,
) -> Dict[int, dict]:
    """Generic exp5/7/8 driver.

    queries: {pivot_num: [query records]} (genome records or reads);
    datasets: {num: [genome,...]} per-dataset reference sets.
    read_type: when set ("illumina"/"ont"), every output path carries a
    read_type segment so both read types of a trial coexist — the
    reference fans exp7/exp8 over both (exp_type_7.smk:284-292, SAMs at
    exp7_sam_files/{mem_type}/{read_type}/; exp8 at
    output_type_8/{mem_type}/t_{t}/{read_type}/, exp_type_8.smk:247-261).
    Returns {analysis_threshold: {"confusion_matrix": path, ...}}.
    """
    from ..mems.analyze import analyze_features, noise_from_length, write_outputs

    rt_seg = f"/{read_type}" if read_type else ""
    nums = sorted(datasets)

    all_text, total_len = combined_text(
        [g for num in nums for g in datasets[num]]
    )
    ms_index = MatchingStatisticsIndex(all_text)
    noise = noise_from_length(total_len)

    dataset_indexes = {
        num: MatchingStatisticsIndex(combined_text(datasets[num])[0])
        for num in nums
    }

    sam_dir = os.path.join(out_dir, f"sam_{tag}/{mem_type}{rt_seg}")
    read_seqs: Dict[int, list] = {}
    for pnum in sorted(queries):
        records = queries[pnum]
        ms_arrays = matching_statistics_per_record(ms_index, records)
        feats = extract_features(records, ms_arrays, mem_type, extract_threshold)
        write_features_fastq(
            os.path.join(out_dir, f"{mem_type}_{tag}{rt_seg}/pivot_{pnum}.fastq"),
            feats,
        )
        locate_and_write_sams(feats, dataset_indexes, sam_dir, pnum)
        read_seqs[pnum] = [(f.name, f.seq) for f in feats]

    out = {}
    for t in analysis_thresholds:
        # distinct tie-break streams per read_type (the reference runs
        # separate analyze_sam.py processes per read_type)
        rng = (
            np.random.default_rng([seed, t])
            if read_type is None
            else np.random.default_rng([seed, ("illumina", "ont").index(read_type), t])
        )
        cm = analyze_features(
            sam_dir,
            len(nums),
            mems=(mem_type == "mems"),
            half_mems=(mem_type == "half_mems"),
            noise=noise,
            threshold=t,
            read_seqs=read_seqs if read_level else None,
            rng=rng,
        )
        tdir = (
            os.path.join(out_dir, f"output_{tag}/{mem_type}/t_{t}{rt_seg}")
            if len(analysis_thresholds) > 1
            else os.path.join(out_dir, f"output_{tag}/{mem_type}{rt_seg}")
        )
        out[t] = write_outputs(tdir, cm, len(nums))
    return out
