#!/usr/bin/env python3
"""Where the port's time goes on a CUDA device.

    python tools/profile_torch_sweep.py [--db DATABASE_ROOT] [--exp-types 1,2,3,4]
                                        [--kmers-per-dataset N] [--out DIR] [--sharded]
                                        [--perk]

1. The shared-sort sweep at the bench shape (8 members x 2^21 random
   bases, the 30-point grid, one packed KW=4 class), stage by stage with
   CUDA events: pack + upload, doubled text + extraction, sort, the scan
   kernel, the (d+p)//2 combine and copy back; beside them one
   `torch.sort` of the first word pair's folded int64 keys, the library
   call the sort row of PERF.md is held against, and the radix sort's
   planned passes and its time by kernel (first pass, middle passes,
   last pass) under torch.profiler.
2. With --perk: the per-k fused step at the same shape and k = 31 (the
   counterpart of tools/profile_stages.py), stage by stage with CUDA
   events: kernel A in its gid-packed form, the radix sort of its words,
   kernel B's histogram and the copy back.
3. With --db: each of --exp-types through the CLI entry point under
   torch.profiler (exp 2/3/4/6 share one work root, and exp0 runs there
   first, unprofiled); prints the wall time, the top device ops and the
   device-busy share: the union of the trace's kernel, memcpy and memset
   intervals over the wall (overlaps counted once).  --out also keeps
   the chrome traces there, with the port's spans (utils/trace.py:
   `cli:run`, `io:read_fasta`, `engine:readback`, ...) on the host
   thread.
4. With --db and --sharded: `run_exp1` on the database's groups (read
   once, before the runs) on one device and over a key-range group of one
   rank on NCCL (dist/), in turns (single, sharded, sharded, single),
   each under torch.profiler as in 3; the group is made, and NCCL's
   first collective run, before the first turn.

Prints the card's name and power limit first and one JSON line last.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

K_GRID = list(range(7, 31)) + list(range(34, 50, 3))


def bench_stages(reps: int) -> dict:
    from khoice_tpu_torch.engine.ksweep import plan_sweep, sort_words
    from khoice_tpu_torch.engine.occurrence import pack_members
    from khoice_tpu_torch.kernels.extract_sweep import doubled_elements
    from khoice_tpu_torch.kernels.ksweep_scan import scan_multi_k

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    members = [rng.integers(0, 4, size=1 << 21, dtype=np.uint8) for _ in range(8)]
    (kmax, KW, cks, packed), = plan_sweep(K_GRID, 8)[0]

    def once():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        codes, gids = pack_members(members, dev)
        ev[1].record()
        fwd, pay = doubled_elements(codes, gids, kmax, KW, packed)
        ev[2].record()
        words, pay = sort_words(fwd, pay)
        ev[3].record()
        raw = scan_multi_k(words, pay, cks, 8, 5000, packed)
        ev[4].record()
        ((raw[0] + raw[1]) // 2).cpu().tolist()
        ev[5].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]

    once()  # warm-up: build, allocator, cuda context
    runs = [once() for _ in range(reps)]
    names = ["pack_upload", "doubled_extract", "sort", "scan_kernel", "combine_d2h"]
    out = {n: float(np.median([r[i] for r in runs])) for i, n in enumerate(names)}
    out["total"] = sum(out[n] for n in names)

    codes, gids = pack_members(members, dev)
    fwd, _ = doubled_elements(codes, gids, kmax, KW, packed)
    key = (fwd[0] - (1 << 31)) * (1 << 32) + fwd[1]
    times = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        torch.sort(key, stable=True)
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    out["library_torch_sort_one_pair"] = float(np.median(times[1:]))
    del fwd, key
    out["radix_sort"] = {
        label: sort_profile(sort_words, *doubled_elements(codes, gids, *cls), reps)
        for label, cls in (("bench class", (kmax, KW, packed)),
                           ("unpacked class kmax 30", (30, 2, False)))}
    return out


def perk_stages(reps: int, k: int = 31) -> dict:
    """The per-k fused step at the bench shape, stage by stage (medians
    of `reps` after a warm-up, CUDA events): kernel A (gid-packed words),
    the radix sort, kernel B, the histogram's copy back."""
    from khoice_tpu_torch.engine.occurrence import pack_members
    from khoice_tpu_torch.kernels.extract import extract_packed, occ_words_static
    from khoice_tpu_torch.kernels.occ_scan import occ_hist_packed
    from khoice_tpu_torch.kernels.sort import sort_words

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    members = [rng.integers(0, 4, size=1 << 21, dtype=np.uint8) for _ in range(8)]
    codes, gids = pack_members(members, dev)

    def once():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        words = extract_packed(codes, gids, k)
        ev[1].record()
        sp, _ = sort_words(words)
        ev[2].record()
        small = occ_hist_packed(sp, 8, 5000)
        ev[3].record()
        small.tolist()
        ev[4].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    once()
    runs = [once() for _ in range(reps)]
    names = ["extract_packed_A", "sort", "occ_hist_packed_B", "d2h"]
    out = {n: float(np.median([r[i] for r in runs])) for i, n in enumerate(names)}
    out["total"] = sum(out[n] for n in names)
    out.update(k=k, positions=int(codes.shape[0]), words=occ_words_static(k))
    return out


def sort_profile(sort_words, words, payload, reps: int) -> dict:
    """The radix sort's planned passes (digits after its first pass) and
    ms per sort of each of its kernels: the first pass, the middle passes
    (all of them) and the last pass, the profiler's device time over
    `reps` sorts."""
    from torch.profiler import ProfilerActivity, profile

    from khoice_tpu_torch.kernels import sort as ksort

    sort_words(words, payload)
    digits, ones = ksort.last_plan
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            sort_words(words, payload)
        torch.cuda.synchronize()
    out = {"passes": len(digits), "all_ones_bucket": ones}
    for ev in prof.key_averages():
        for name in ("first_pass", "middle_pass", "last_pass"):
            if f"{name}_kernel" in ev.key:
                us = (ev.device_time_total if hasattr(ev, "device_time_total")
                      else ev.cuda_time_total)
                out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


# chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_us(trace_events) -> dict:
    """Device time of a chrome trace's events: `busy_us` is the union of
    the kernel, memcpy and memset intervals (overlapping intervals, as
    from concurrent streams, count once); `sum_us` adds their durations
    as they are."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in trace_events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"busy_us": busy, "sum_us": sum(e - s for s, e in spans), "events": len(spans)}


def exp_profile(argv, label: str, out_dir: str | None) -> dict:
    """Profile one run: `cli.main(argv)`, or argv() when it is a callable."""
    from torch.profiler import ProfilerActivity, profile

    from khoice_tpu_torch import cli

    run = argv if callable(argv) else (lambda: cli.main(argv))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if run() != 0:
            raise SystemExit(f"{label} failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(out_dir or tmp, f"{label}_trace.json")
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(trace)
        with open(trace) as fd:
            dev = device_busy_us(json.load(fd)["traceEvents"])
    print(f"--- {label}")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    return {"wall_s": wall, "device_busy_s": dev["busy_us"] / 1e6,
            "device_busy_share": dev["busy_us"] / 1e6 / wall,
            "device_event_sum_s": dev["sum_us"] / 1e6, "device_events": dev["events"]}


def sharded_profiles(db: str, out_dir: str | None) -> dict:
    """exp1 on one device and over a one-rank NCCL group, in turns."""
    import torch.distributed as dist

    from khoice_tpu_torch.dist.mesh import init_kv_group
    from khoice_tpu_torch.pipelines.exp0 import load_database_dir
    from khoice_tpu_torch.pipelines.exp1 import run_exp1

    loaded = load_database_dir(db)
    groups = {num: [loaded[num][n] for n in sorted(loaded[num])] for num in loaded}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        group = init_kv_group("cuda", world_size=1)
        dist.all_reduce(torch.zeros(1, device=group.device))
        torch.cuda.synchronize()
        out["nccl_setup_s"] = time.perf_counter() - t0
        try:
            for turn, sharded in enumerate((False, True, True, False)):
                label = f"exp1_{'sharded' if sharded else 'single'}_{turn}"

                def run(sharded=sharded, label=label):
                    run_exp1(groups, K_GRID, os.path.join(tmp, label), "cuda",
                             group=group if sharded else None)
                    return 0

                out[label] = exp_profile(run, label, out_dir)
        finally:
            dist.destroy_process_group()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--db", default=None, help="database root for the experiment profiles")
    ap.add_argument("--exp-types", default="1", help="comma-separated experiments to profile")
    ap.add_argument("--kmers-per-dataset", default="2000000",
                    help="31-mer budget of exp0's and exp3's simulated read sets")
    ap.add_argument("--out", default=None, help="directory for the chrome traces")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--perk", action="store_true",
                    help="also the per-k fused step (A, sort, B) at the bench shape, k = 31")
    ap.add_argument("--sharded", action="store_true",
                    help="with --db: exp1 on one device and over a one-rank NCCL group")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    result = {"bench_stages_ms": bench_stages(args.reps)}
    print("bench stages (ms, median):", json.dumps(result["bench_stages_ms"]))
    if args.perk:
        result["perk_stages_ms"] = perk_stages(args.reps)
        print("per-k stages (ms, median):", json.dumps(result["perk_stages_ms"]))
    if args.db:
        with tempfile.TemporaryDirectory() as work:
            common = ["--database-root", args.db, "--work-root", work,
                      "--kmers-per-dataset", args.kmers_per_dataset]
            exp_types = [int(t) for t in args.exp_types.split(",")]
            if any(t in (2, 3, 4, 6) for t in exp_types):
                t0 = time.perf_counter()
                from khoice_tpu_torch import cli

                cli.main(["run", "--exp-type", "0", *common])
                result["exp0_wall_s"] = time.perf_counter() - t0
            for t in exp_types:
                result[f"exp{t}"] = exp_profile(["run", "--exp-type", str(t), *common],
                                                f"exp{t}", args.out)
        if args.sharded:
            result["sharded"] = sharded_profiles(args.db, args.out)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
