"""Experiment 1: whole-group k-mer uniqueness (port of
khoice_tpu/pipelines/exp1.py).

The fused path (the default): per group, the whole k grid comes from the
shared-sort sweep (engine/ksweep.py): one doubled-text sort and one
multi-k scan per key-word class.  The ks it cannot serve (a class of
< 3 ks; every k of a group of more than 64 genomes) take the per-k fused
path, one sort per k (engine/occurrence.py).  The across-groups set is
the same sweep over one member per group (the group's genomes joined with
separators).  With a key-range group (`group`, the JAX package's `mesh`)
the same sweeps run sharded over its ranks (dist/ksweep.py), and the ks
they leave over take the sharded per-k path (dist/occurrence.py).

fused=False runs the kmc_tools-shaped table ops of the reference DAG
(workflow/rules/exp_type_1.smk:156-308) through KmerEngine: per (k,
group) a canonical count of every genome, set_counts 1, the within-group
union and its histogram; per k the across-groups union of the group sets
(set_counts 1 of each union) and its histogram.  Same histograms.

The step_4/step_5/step_8/step_9 file layout and row order are the
reference's, so the CSV bytes equal the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..dist.ksweep import sharded_occurrence_histograms_sweep
from ..engine import streaming
from ..engine.ksweep import occurrence_histograms_sweep
from ..engine.session import KmerEngine
from ..io.packing import encode_records
# exp1 does not call read_hist_txt; it stays bound here, as the four other
# report names do, for the benchmark's reports reader
# (benchmark/metrics/reports_s.py), which wraps them in this module
from ..reports.csvio import read_hist_txt, write_csv_rows, write_hist_txt  # noqa: F401
from ..reports.metrics import append_group_normalization, summarize_histogram_type1
from ..utils import trace
from ..utils.logging import get_logger

STEP5_HEADER = (
    "group_num,k,percent_1_occ,percent_25_or_less,percent_25_to_75,"
    "percent_75_or_more,unique_stat,unique_stat_norm,delta_frac,delta_frac_norm\n"
)
STEP9_HEADER = (
    "group_num,k,percent_1_occ,percent_2_to_5,percent_5_to_20,percent_20_more,"
    "unique_stat,unique_stat_norm,delta_frac,delta_frac_norm\n"
)

log = get_logger("khoice.exp1")


def run_exp1(
    groups: Dict[int, List[List[str]]],
    k_values: Sequence[int],
    out_dir: str,
    device,
    engine: KmerEngine | None = None,
    union_cs: int = 5000,
    count_cs: int = 255,
    hist_cx: int = 10000,
    write_hists: bool = True,
    fused: bool = True,
    device_budget_bytes: int | None = None,
    group=None,
) -> Dict[str, str]:
    """groups: {group_num: [genome as list-of-record-seqs, ...]}; every
    sweep and table op runs on `device`.

    fused=True takes the shared-sort sweep; a group whose in-core sweep
    would exceed `device_budget_bytes` (default
    engine/streaming.default_device_budget_bytes) takes the bounded-memory
    streaming sweep instead (equal results), as the JAX package's exp1
    does; a group whose per-k sorts would exceed it raises
    DeviceBudgetExceeded.  fused=False runs the table ops through `engine`
    (default a KmerEngine on `device` under that budget), which checks each
    count and union against the budget first.  The CSVs' histograms come
    from memory, each cut to `hist_cx` bins as its step_4/step_8 file holds
    it; write_hists=False writes no such file.

    group: a dist/mesh.py KvGroup (the JAX package's `mesh`): the fused
    sweeps run over its ranks, on `device` (each rank's own), within the
    budget and without streaming, as in the JAX package; every rank calls
    run_exp1 with the same arguments, and only rank 0 writes the files.

    Returns {"step_5": csv_path, "step_9": csv_path}."""
    with trace.span("pipeline:exp1"):  # the body's locals are freed inside the span
        return _run_exp1(groups, k_values, out_dir, device, engine, union_cs, count_cs, hist_cx,
                         write_hists, fused, device_budget_bytes, group)


def _run_exp1(groups, k_values, out_dir, device, engine, union_cs, count_cs, hist_cx,
              write_hists, fused, device_budget_bytes, group) -> Dict[str, str]:
    device = torch.device(device)
    group_nums = sorted(groups)
    ks_list = [int(k) for k in k_values]
    budget = device_budget_bytes or streaming.default_device_budget_bytes(device)

    # encode each genome once; every k reuses the codes
    codes = {
        num: [encode_records(seqs) for seqs in groups[num]] for num in group_nums
    }

    if group is not None and not fused:
        raise ValueError("the table ops (fused=False) have no sharded path")

    def sweep_members(member_codes, label):
        """In-core shared-sort sweep, or the bounded-memory streaming
        sweep when the group exceeds the device budget; over a key-range
        group, the sharded sweep."""
        if group is not None:
            return sharded_occurrence_histograms_sweep(
                group, member_codes, ks_list, cs=union_cs, cx=hist_cx,
                device_budget_bytes=budget,
            )
        total = sum(int(c.shape[0]) + 1 for c in member_codes)
        need = streaming.incore_sweep_bytes(total, ks_list, len(member_codes))
        if need > budget:
            log.info("%s: in-core sweep ~%.1f GiB exceeds device budget %.1f GiB — "
                     "streaming (bounded memory)", label, need / 2**30, budget / 2**30)
            return streaming.occurrence_histograms_sweep_streaming(
                member_codes, ks_list, device, cs=union_cs, cx=hist_cx,
                device_budget_bytes=budget,
            )
        streaming.check_incore_budget(total, ks_list, len(member_codes), budget, label, device)
        return occurrence_histograms_sweep(
            member_codes, ks_list, device, cs=union_cs, cx=hist_cx
        )

    if fused:
        within_all = {num: sweep_members(codes[num], f"group {num}") for num in group_nums}
        with trace.span("io:join_groups"):
            group_concat = [
                np.concatenate(
                    [np.concatenate([c, np.full(1, 4, np.uint8)]) for c in codes[num]]
                )
                for num in group_nums
            ]
        across_all = sweep_members(group_concat, "across-groups")
    else:
        eng = engine or KmerEngine(device, budget)

    step5 = os.path.join(out_dir, "step_5/within_datasets_analysis.csv")
    step9 = os.path.join(out_dir, "step_9/across_datasets_analysis.csv")
    if group is not None and group.rank != 0:  # rank 0 writes
        return {"step_5": step5, "step_9": step9}

    def step4_path(k, num):
        return os.path.join(out_dir, f"step_4/k_{k}/dataset_{num}/dataset_{num}_k{k}_hist.txt")

    def step8_path(k):
        return os.path.join(out_dir, f"step_8/k_{k}/all_datasets_k{k}_hist.txt")

    # the table ops drop each table as soon as no later step needs it (the
    # engine's budget checks count what the run holds on the device)
    within_hists: Dict[tuple, List[int]] = {}
    across_hists: Dict[int, List[int]] = {}
    for k in k_values:
        group_sets = []
        for num in group_nums:
            if fused:
                hist = within_all[num][int(k)]
            else:
                members = [eng.set_counts(eng.count_codes(c, k, cs=count_cs), 1)
                           for c in codes[num]]
                union = eng.union(members, cs=union_cs)
                del members
                hist = eng.histogram(union, cx=hist_cx)
                group_sets.append(eng.set_counts(union, 1))
                del union
            within_hists[(k, num)] = hist
            if write_hists:
                write_hist_txt(step4_path(k, num), hist, cx=hist_cx)
        if fused:
            hist = across_all[int(k)]
        else:
            across = eng.union(group_sets, cs=union_cs)
            hist = eng.histogram(across, cx=hist_cx)
            del across
        across_hists[k] = hist
        if write_hists:
            write_hist_txt(step8_path(k), hist, cx=hist_cx)

    # --- step_5 CSV (row order: k outer, group inner, like the reference's
    # expand(k_len=..., num=...) input ordering, exp_type_1.smk:195) ---
    all_metrics = []
    for k in k_values:
        for num in group_nums:
            row = [f"group_{num}", str(k)] + summarize_histogram_type1(
                within_hists[(k, num)][:hist_cx], len(groups[num]), False, int(k)
            )
            all_metrics.append(row)
    append_group_normalization(all_metrics, [f"group_{num}" for num in group_nums])
    write_csv_rows(step5, STEP5_HEADER, all_metrics)

    # --- step_9 CSV ---
    all_metrics = []
    for k in k_values:
        row = ["full_group", str(k)] + summarize_histogram_type1(
            across_hists[k][:hist_cx], len(group_nums), True, int(k)
        )
        all_metrics.append(row)
    max_ratio = max(row[8] for row in all_metrics)
    for row in all_metrics:
        row.append(round(row[8] / max_ratio, 4))
    write_csv_rows(step9, STEP9_HEADER, all_metrics)
    log.info("exp1 on %s (%s): %d groups x %d ks", device,
             "fused" if fused else "table ops", len(group_nums), len(ks_list))
    if group is not None:
        log.info("exp1 sharded over %d ranks", group.world_size)
    return {"step_5": step5, "step_9": step9}
