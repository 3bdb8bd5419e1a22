#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: canonical k-mers/s per card
over the reference's 30-point k grid (the counterpart of bench.py).

    python bench_torch.py [--device cuda]

The workload is bench.py's: 8 genomes x 2^21 uniform bases from
numpy's default_rng(0), k = 7..30 and 34..49 step 3 (workflow/Snakefile:36),
cs 5000, cx 16, the exp1 inner operation per k (canonical counting,
genome-occurrence reduction, occurrence histogram).  The codes are packed
(engine/occurrence.py::pack_members) and resident on the card; the rate
is the grid's k-mers over the best of REPS wall times of
engine/ksweep.py::occurrence_histograms_sweep_packed, after one untimed
call that builds the kernels.  vs_baseline is against 150M k-mers/s, the
KMC3 counting rate bench.py uses (its docstring gives the derivation).

Earlier lines, the protocol rows (written to no file):
  1. the card's name and power limit (nvidia-smi);
  2. the launches of each kernel in the timed calls;
  3. the stage split: extract, extract + sort and the full grid as nested
     prefixes of one pipeline, each the best of REPS synchronized wall
     times, differences clamped at >= 0;
  4. the multi-card row: dist/ksweep.py's sharded sweep on 4 x 2^19
     bases at ks 21, 31, 49 over world sizes 1, 2, 4 and 8 (those with
     two host cores a rank), the ranks sharing one card on gloo (the
     overhead of the sharded path at constant work, not a scaling
     measurement), with the analytic exchange volume; and, where the host
     has two cards or more, the same over NCCL on 1 to 8 of them, one
     card a rank.  Every rank's histograms must equal the single-device
     sweep's, or the row fails: its error goes to stderr
     ("[bench_torch] multi-card row failed: ...") and the headline is
     still printed.

The last line is ONE JSON object with bench.py's keys: metric, value
(Mkmer/s), unit, vs_baseline.  The exit code is 1 when the histograms'
checksum is 0 or the multi-card row failed (bench.py exits 0 there).
The device defaults to cuda and a missing card raises; `--device cpu`
runs the plain PyTorch versions for the tests (its rate is the CPU's, no
device metric).
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch
import torch.distributed as dist

from khoice_tpu_torch.cli import _device
from khoice_tpu_torch.dist.ksweep import sharded_occurrence_histograms_sweep
from khoice_tpu_torch.dist.launch import run_ranks
from khoice_tpu_torch.dist.mesh import KvGroup, all_sum, init_kv_group
from khoice_tpu_torch.engine.ksweep import (
    _sweep_doubled,
    occurrence_histograms_sweep,
    occurrence_histograms_sweep_packed,
    plan_sweep,
)
from khoice_tpu_torch.engine.occurrence import pack_members
from khoice_tpu_torch.kernels import extract, extract_sweep, ksweep_scan, occ_scan, sort

KMC3_BASELINE_KMERS_PER_S = 150e6
N_GENOMES = 8
GENOME_LEN = 1 << 21  # 8 x 2 Mbp = 16.8M k-mers per grid point
K_GRID = list(range(7, 31)) + [34, 37, 40, 43, 46, 49]  # Snakefile:36
REPS = 3
CS, CX = 5000, 16
SCALING_GENOMES = 4
SCALING_LEN = 1 << 19
SCALING_KS = [21, 31, 49]  # one packed master class
SCALING_WORLDS = (1, 2, 4, 8)
SCALING_REPS = 2
SCALING_MODE = ("ranks-share-one-card dryrun (overhead at constant work, not a scaling "
                "measurement)")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_s(fn, device: torch.device, reps: int) -> float:
    """The best of `reps` synchronized wall times of fn(), after one untimed call."""
    fn()
    sync(device)
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def bench_members(n_genomes: int, length: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, size=length, dtype=np.uint8) for _ in range(n_genomes)]


def grid_hists(packed, n_members: int):
    """{k: occurrence histogram} over the grid, from the resident codes."""
    return occurrence_histograms_sweep_packed(packed, n_members, K_GRID, cs=CS, cx=CX)


def launch_counts() -> dict:
    """Launches of each kernel so far (the wrappers' counters)."""
    return {"extract_sweep": sum(extract_sweep.launches.values()), "radix_sort": sort.launches,
            "ksweep_scan": ksweep_scan.launches["occ"],
            "ksweep_scan.classify": sum(ksweep_scan.launches[m]
                                        for m in ksweep_scan.CLASSIFY_MODES),
            "extract_canonical": sum(extract.launches.values()),
            "occ_scan": sum(occ_scan.launches.values())}


def stage_row(packed, device: torch.device) -> dict:
    """bench.py's stage breakdown of the grid's first class: extract,
    extract + sort and the full grid, nested prefixes of one pipeline."""
    codes, gids = packed
    classes, _rest = plan_sweep(K_GRID, N_GENOMES)
    kmax, KW, cks, pay_packed = classes[0]
    te = best_s(lambda: extract_sweep.doubled_elements(codes, gids, kmax, KW, pay_packed), device,
                REPS)
    tes = best_s(lambda: _sweep_doubled(codes, gids, kmax, KW, pay_packed), device, REPS)
    total_s = best_s(lambda: grid_hists(packed, N_GENOMES), device, REPS)
    return {
        "elements_doubled_text": 2 * int(codes.shape[0]),
        "sort_class": {"kmax": kmax, "key_words": KW, "payload_packed": bool(pay_packed),
                       "ks_served": len(cks)},
        "extract_ms": te * 1e3,
        "sort_ms": max(tes - te, 0.0) * 1e3,
        "scan_30ks_ms": max(total_s - tes, 0.0) * 1e3,
        "total_ms": total_s * 1e3,
    }


def exchange_bytes_per_device(n_positions: int, n_devices: int) -> int:
    """Analytic bytes each rank sends in the exchange of the grid's first
    class, before the (key, gid, nio) dedupe: its share of the doubled
    text's elements, as rows of int64 words (8 B per 32-bit word, and the
    payload row where the class is unpacked)."""
    _kmax, KW, _cks, pay_packed = plan_sweep(K_GRID, N_GENOMES)[0][0]
    return (2 * n_positions // n_devices) * (KW + (0 if pay_packed else 1)) * 8


def scaling_rank(members, ks, device_type: str, shared_card: bool, reps: int):
    """Rank program of the multi-card row (dist/launch.py::run_ranks): the
    sharded sweep once untimed, then the best of `reps` walls from a
    barrier (a sum over the group) to the end of the slowest rank.
    shared_card: every rank on cuda:0 over gloo; else each on its own
    device (cuda:rank on NCCL).  Returns (histograms, best wall in s)."""
    if shared_card:
        group = KvGroup(rank=dist.get_rank(), world_size=dist.get_world_size(),
                        device=torch.device("cuda", 0))
    else:
        group = init_kv_group(device_type)
        if group.device.type == "cuda":
            torch.cuda.set_device(group.device)
    hists = sharded_occurrence_histograms_sweep(group, members, ks, cs=CS, cx=8)
    best = math.inf
    for _ in range(reps):
        all_sum(torch.zeros(1, device=group.device))  # a barrier on gloo and NCCL alike
        t0 = time.perf_counter()
        sharded_occurrence_histograms_sweep(group, members, ks, cs=CS, cx=8)
        all_sum(torch.zeros(1, device=group.device))
        best = min(best, time.perf_counter() - t0)
    return hists, best


def scaling_series(members, ks, want, device: torch.device, worlds, backend: str,
                   shared_card: bool) -> tuple:
    """({world size: best wall}, {world size: the wall of run_ranks, the
    ranks' start included}), every rank's histograms held to `want`."""
    seconds, with_start = {}, {}
    for world in worlds:
        if device.type == "cuda":
            torch.cuda.empty_cache()  # the ranks need the card this process has cached
        t0 = time.perf_counter()
        ranks = run_ranks(world, scaling_rank, (members, ks, device.type, shared_card,
                                                SCALING_REPS),
                          backend=backend, timeout_s=600)
        for rank, (hists, _wall) in enumerate(ranks):
            for k in ks:
                if hists[k] != want[k]:
                    raise AssertionError(
                        f"multi-card row: rank {rank} of {world} ({backend}) differs from the "
                        f"single-device sweep at k={k}")
        seconds[world] = max(wall for _hists, wall in ranks)
        with_start[world] = time.perf_counter() - t0
    return seconds, with_start


def multichip_row(device: torch.device) -> dict:
    """The counterpart of bench.py's _virtual_mesh_scaling: the sharded
    sweep's overhead at constant work over ranks that share one device
    (gloo), and over NCCL where the host has two cards or more."""
    members = bench_members(SCALING_GENOMES, SCALING_LEN, 1)
    want = occurrence_histograms_sweep(members, SCALING_KS, device, cs=CS, cx=8)
    # a rank's start (torch's import, a CUDA context) takes seconds of a
    # core: more ranks than half the cores measure the host's contention
    cores = len(os.sched_getaffinity(0))
    worlds = [w for w in SCALING_WORLDS if w == 1 or 2 * w <= cores]
    seconds, with_start = scaling_series(members, SCALING_KS, want, device, worlds, "gloo",
                                         shared_card=device.type == "cuda")
    n_bench = N_GENOMES * (GENOME_LEN + 1)
    row = {
        "mode": SCALING_MODE,
        "backend": "gloo",
        "device": "cuda:0, shared by every rank" if device.type == "cuda" else "cpu",
        "input_positions": int(sum(m.shape[0] for m in members)),
        "ks": SCALING_KS,
        "validated": "every rank's histograms equal the single-device sweep's",
        "all_to_all_bytes_per_device_per_class": exchange_bytes_per_device(n_bench, 8),
        "host_cores": cores,
        "seconds_by_ranks": {str(w): t for w, t in seconds.items()},
        "sharding_overhead_vs_single": {str(w): t / seconds[1] for w, t in seconds.items()},
        "seconds_with_rank_start": {str(w): t for w, t in with_start.items()},
    }
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if cards >= 2:
        nccl_worlds = list(range(1, min(8, cards) + 1))
        nccl, nccl_start = scaling_series(members, SCALING_KS, want, device, nccl_worlds,
                                          "nccl", shared_card=False)
        row["nccl"] = {
            "mode": "measured: one card a rank over NCCL, the same work at every world size",
            "cards": cards,
            "seconds_by_ranks": {str(w): t for w, t in nccl.items()},
            "seconds_with_rank_start": {str(w): t for w, t in nccl_start.items()},
            "speedup_vs_one_rank": {str(w): nccl[1] / t for w, t in nccl.items()},
        }
    else:
        row["nccl"] = f"not measured: {cards} card(s) visible, NCCL needs one a rank"
    return row


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions, for the tests)")
    args = ap.parse_args(argv)
    device = _device(args.device)

    members = bench_members(N_GENOMES, GENOME_LEN, 0)
    packed = pack_members(members, device)
    hists = grid_hists(packed, N_GENOMES)  # builds the kernels
    chk = sum(hists[k][0] for k in K_GRID)

    before = launch_counts()
    total_s = best_s(lambda: grid_hists(packed, N_GENOMES), device, REPS)
    after = launch_counts()
    calls = REPS + 1
    n_kmers_total = len(K_GRID) * N_GENOMES * GENOME_LEN
    kmers_per_s = n_kmers_total / total_s
    headline = {
        "metric": "canonical_kmers_per_s_per_chip_kgrid_count_union_hist",
        "value": round(kmers_per_s / 1e6, 1),
        "unit": "Mkmer/s",
        "vs_baseline": round(kmers_per_s / KMC3_BASELINE_KMERS_PER_S, 2),
    }

    print(json.dumps({"device": smi_line() if device.type == "cuda" else "cpu",
                      "torch": torch.__version__}), flush=True)
    print(json.dumps({"launches": {"grids": calls, **{name: after[name] - before[name]
                                                        for name in after}}}), flush=True)
    print(json.dumps({"stage_breakdown": stage_row(packed, device)}), flush=True)
    del packed
    # bench.py's rule: the headline survives a failing protocol row; here a
    # failed row (a rank that differs, fails to start or times out) still
    # makes the exit code 1
    row_failed = False
    try:
        print(json.dumps({"multi_chip": multichip_row(device)}), flush=True)
    except Exception as exc:
        row_failed = True
        print(f"[bench_torch] multi-card row failed: {exc!r}", file=sys.stderr, flush=True)
    print(json.dumps(headline))
    return 0 if chk != 0 and not row_failed else 1


if __name__ == "__main__":
    sys.exit(main())
