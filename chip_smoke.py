#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (khoice_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile khoice_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  3. kernel vs plain: the multi-k scan kernel and the plain PyTorch scan
     on the same sorted array on the card, exactly equal, at the
     main path's shapes (8 x 2^21-base members on the 30-point grid;
     64 members; an unpacked class), with both times.
  4. main path: `run --exp-type 1` through the port's CLI entry point on a
     generated 4 datasets x 8 genomes x 2 Mbp database; the scan kernel's
     launch count must rise.
  5. small world: the step_4/step_8 histograms that `run_exp1` writes
     on the card for 2 groups x 3 genomes equal a dict-based canonical
     k-mer counter written here (the CSV bytes are held against the JAX
     package and its oracle by tests/test_torch_exp1.py on the CPU).
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

import json
import os
import random
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
K_GRID = list(range(7, 31)) + list(range(34, 50, 3))  # the reference grid
DB_MBP = 2.0


def phase(name):
    print(f"== {name}", flush=True)


def device_check():
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)


def build():
    phase("2 build")
    from khoice_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"built {os.path.relpath(_build.library_path(), ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def random_members(rng, n_members, length):
    """Uniform random codes with a few N runs per member."""
    members = []
    for _ in range(n_members):
        c = rng.integers(0, 4, size=length, dtype=np.uint8)
        for _ in range(3):
            p = int(rng.integers(0, length - 600))
            c[p:p + int(rng.integers(20, 500))] = 4
        members.append(c)
    return members


def time_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(label, members, ks):
    from khoice_tpu_torch.engine.ksweep import _sweep_doubled, plan_sweep
    from khoice_tpu_torch.engine.occurrence import pack_members
    from khoice_tpu_torch.kernels.ksweep_scan import scan_multi_k, scan_multi_k_reference

    dev = torch.device("cuda")
    g = len(members)
    classes, rest = plan_sweep(ks, g)
    if rest or len(classes) != 1:
        raise AssertionError(f"{label}: expected one shared-sort class, got {classes} + {rest}")
    kmax, KW, cks, packed = classes[0]
    codes, gids = pack_members(members, dev)
    words, pay = _sweep_doubled(codes, gids, kmax, KW, packed)
    del codes, gids
    torch.cuda.synchronize()

    def kern():
        return scan_multi_k(words, pay, cks, g, 5000, packed)

    def plain():
        return scan_multi_k_reference(words, pay, cks, g, 5000, packed)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = int((got - want).abs().max().item())
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].tolist()
        raise AssertionError(f"{label}: kernel != plain scan at {bad}")
    # in turns: plain, kernel, kernel, plain
    p1 = time_ms(plain, 2)
    k1 = time_ms(kern, 10)
    k2 = time_ms(kern, 10)
    p2 = time_ms(plain, 2)
    print(f"{label}: n2={words.shape[1]} KW={KW} packed={packed} ks={len(cks)} "
          f"members={g}: equal (max_abs_err {err}); kernel {k1:.3f} / {k2:.3f} ms, "
          f"plain {p1:.3f} / {p2:.3f} ms", flush=True)
    return {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}


def kernels_vs_plain():
    phase("3 kernel vs plain")
    rng = np.random.default_rng(0)
    bench = random_members(rng, 8, 1 << 21)
    main = kernel_vs_plain("bench 8x2^21 grid30", bench, K_GRID)
    wide = kernel_vs_plain("64x2^16 grid30", random_members(rng, 64, 1 << 16), K_GRID)
    unpacked = kernel_vs_plain("bench 8x2^21 ks11..31", bench, list(range(11, 32)))
    return main, max(r["max_abs_err"] for r in (main, wide, unpacked))


def main_path(tmp):
    phase("4 main path: run --exp-type 1")
    from khoice_tpu_torch import cli
    from khoice_tpu_torch.kernels import ksweep_scan

    db = os.path.join(tmp, "db")
    work = os.path.join(tmp, "work")
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "gen_realistic_db.py"), db,
         "--datasets", "4", "--genomes", "8", "--mbp", str(DB_MBP), "--seed", "7"],
        check=True, capture_output=True,
    )
    print(f"database 4 x 8 x {DB_MBP} Mbp generated in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    ksweep_scan.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["run", "--exp-type", "1", "--database-root", db, "--work-root", work])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ksweep_scan.launches
    if rc != 0:
        raise AssertionError(f"run --exp-type 1 returned {rc}")
    if launches < 1:
        raise AssertionError("the main path launched no ksweep_scan kernel")
    with open(os.path.join(work, "step_5/within_datasets_analysis.csv")) as fd:
        n5 = len(fd.read().strip().splitlines())
    with open(os.path.join(work, "step_9/across_datasets_analysis.csv")) as fd:
        n9 = len(fd.read().strip().splitlines())
    if (n5, n9) != (1 + 4 * len(K_GRID), 1 + len(K_GRID)):
        raise AssertionError(f"step_5 has {n5} lines, step_9 {n9}")
    peak = torch.cuda.max_memory_allocated()
    print(f"exp1 on 4x8x{DB_MBP} Mbp, 30 ks: wall {wall:.2f} s, ksweep_scan launches "
          f"{launches}, peak device memory {peak / 2**30:.2f} GiB; "
          f"step_5 {n5} lines, step_9 {n9} lines", flush=True)
    with open(os.path.join(work, "step_9/across_datasets_analysis.csv")) as fd:
        print("step_9 head:", " | ".join(fd.read().splitlines()[:3]))
    return launches


_COMP = str.maketrans("ACGT", "TGCA")


def canonical_kmers(records, k):
    """Canonical k-mers (lexicographic min of a k-mer and its reverse
    complement) of a genome's records; windows holding an N are skipped."""
    out = set()
    for seq in records:
        for i in range(len(seq) - k + 1):
            kmer = seq[i:i + k]
            if "N" not in kmer:
                out.add(min(kmer, kmer.translate(_COMP)[::-1]))
    return out


def presence_histogram(sets, cx):
    """hist[b-1] = #k-mers found in exactly b of the sets."""
    counts = {}
    for s in sets:
        for kmer in s:
            counts[kmer] = counts.get(kmer, 0) + 1
    hist = [0] * cx
    for c in counts.values():
        hist[c - 1] += 1
    return hist


def read_hist(path):
    with open(path) as fd:
        return [int(line.split()[1]) for line in fd if line.strip()]


def small_world_check(tmp):
    phase("5 small world vs a dict-based counter")
    from khoice_tpu_torch.pipelines.exp1 import run_exp1

    rng = random.Random(1234)

    def dna(n):
        return "".join("ACGT"[rng.randrange(4)] for _ in range(n))

    base = dna(3000)
    groups = {}
    for num in (1, 2):
        genomes = []
        for i in range(3):
            seq = list(base)
            for _ in range(150 + 40 * num):
                seq[rng.randrange(len(seq))] = "ACGT"[rng.randrange(4)]
            p = rng.randrange(len(seq) - 100)
            seq[p:p + 30 + 10 * i] = "N" * (30 + 10 * i)
            genomes.append(["".join(seq), dna(300)])
        groups[num] = genomes
    ks = [5, 12, 21, 31, 33, 45, 49]
    out = os.path.join(tmp, "small")
    run_exp1(groups, ks, out, "cuda")
    cx = 10000
    for k in ks:
        group_sets = []
        for num in sorted(groups):
            sets = [canonical_kmers(genome, k) for genome in groups[num]]
            want = presence_histogram(sets, cx)
            got = read_hist(os.path.join(
                out, f"step_4/k_{k}/dataset_{num}/dataset_{num}_k{k}_hist.txt"))
            if got != want:
                raise AssertionError(f"step_4 k={k} group {num}: histogram differs")
            group_sets.append(set().union(*sets))
        got = read_hist(os.path.join(out, f"step_8/k_{k}/all_datasets_k{k}_hist.txt"))
        if got != presence_histogram(group_sets, cx):
            raise AssertionError(f"step_8 k={k}: histogram differs")
    print(f"step_4 and step_8 histograms equal the dict-based counter's "
          f"(2 groups x 3 genomes, ks {ks})")


def main():
    device_check()
    build()
    scan, max_err = kernels_vs_plain()
    with tempfile.TemporaryDirectory() as tmp:
        launches = main_path(tmp)
        small_world_check(tmp)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "ksweep_scan",
        "route": "cuda",
        "source": "khoice_tpu_torch/csrc/ksweep_scan.cu",
        "replaces": "khoice_tpu/kernels/ksweep_scan_pallas.py:299",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": scan["ms"],
        "plain_ms": scan["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
