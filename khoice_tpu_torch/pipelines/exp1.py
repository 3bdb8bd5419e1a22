"""Experiment 1: whole-group k-mer uniqueness on one device (port of
khoice_tpu/pipelines/exp1.py, its fused single-device path).

Per group, the whole k grid comes from the shared-sort sweep
(engine/ksweep.py): one doubled-text sort and one multi-k scan per
key-word class.  The ks it cannot serve (a class of < 3 ks; every k of a
group of more than 64 genomes) take the per-k fused path, one sort per k
(engine/occurrence.py).  The across-groups set is the same sweep over one
member per group (the group's genomes joined with separators).  The step_4/
step_5/step_8/step_9 file layout and row order are the reference's, so
the CSV bytes equal the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..engine import streaming
from ..engine.ksweep import occurrence_histograms_sweep
from ..io.packing import encode_records
from ..reports.csvio import read_hist_txt, write_csv_rows, write_hist_txt
from ..reports.metrics import append_group_normalization, summarize_histogram_type1
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
    union_cs: int = 5000,
    hist_cx: int = 10000,
    device_budget_bytes: int | None = None,
) -> Dict[str, str]:
    """groups: {group_num: [genome as list-of-record-seqs, ...]}; every
    sweep runs on `device`.

    A group whose in-core sweep would exceed `device_budget_bytes`
    (default engine/streaming.default_device_budget_bytes) takes the
    bounded-memory streaming sweep instead (equal results), as the JAX
    package's exp1 does; a group whose per-k sorts would exceed it raises
    DeviceBudgetExceeded.

    Returns {"step_5": csv_path, "step_9": csv_path}."""
    device = torch.device(device)
    group_nums = sorted(groups)
    ks_list = [int(k) for k in k_values]
    budget = device_budget_bytes or streaming.default_device_budget_bytes(device)

    # encode each genome once; every k reuses the codes
    codes = {
        num: [encode_records(seqs) for seqs in groups[num]] for num in group_nums
    }

    def sweep_members(member_codes, label):
        """In-core shared-sort sweep, or the bounded-memory streaming
        sweep when the group exceeds the device budget."""
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

    within_all = {num: sweep_members(codes[num], f"group {num}") for num in group_nums}
    group_concat = [
        np.concatenate(
            [np.concatenate([c, np.full(1, 4, np.uint8)]) for c in codes[num]]
        )
        for num in group_nums
    ]
    across_all = sweep_members(group_concat, "across-groups")

    def step4_path(k, num):
        return os.path.join(out_dir, f"step_4/k_{k}/dataset_{num}/dataset_{num}_k{k}_hist.txt")

    def step8_path(k):
        return os.path.join(out_dir, f"step_8/k_{k}/all_datasets_k{k}_hist.txt")

    for k in k_values:
        for num in group_nums:
            write_hist_txt(step4_path(k, num), within_all[num][int(k)], cx=hist_cx)
        write_hist_txt(step8_path(k), across_all[int(k)], cx=hist_cx)

    # --- step_5 CSV (row order: k outer, group inner, like the reference's
    # expand(k_len=..., num=...) input ordering, exp_type_1.smk:195) ---
    all_metrics = []
    for k in k_values:
        for num in group_nums:
            row = [f"group_{num}", str(k)] + summarize_histogram_type1(
                read_hist_txt(step4_path(k, num)), len(groups[num]), False, int(k)
            )
            all_metrics.append(row)
    append_group_normalization(all_metrics, [f"group_{num}" for num in group_nums])
    step5 = os.path.join(out_dir, "step_5/within_datasets_analysis.csv")
    write_csv_rows(step5, STEP5_HEADER, all_metrics)

    # --- step_9 CSV ---
    all_metrics = []
    for k in k_values:
        row = ["full_group", str(k)] + summarize_histogram_type1(
            read_hist_txt(step8_path(k)), len(group_nums), True, int(k)
        )
        all_metrics.append(row)
    max_ratio = max(row[8] for row in all_metrics)
    for row in all_metrics:
        row.append(round(row[8] / max_ratio, 4))
    step9 = os.path.join(out_dir, "step_9/across_datasets_analysis.csv")
    write_csv_rows(step9, STEP9_HEADER, all_metrics)
    log.info("exp1 on %s: %d groups x %d ks", device, len(group_nums), len(ks_list))
    return {"step_5": step5, "step_9": step9}
