#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (khoice_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile khoice_tpu_torch/csrc/*.cu with nvcc (sm_90a); print
     ptxas's registers and spills per kernel.
  3. kernels vs plain: the scan kernel in each mode and its plain PyTorch
     version on the same sorted array on the card, exactly equal, timed in
     turns (plain, kernel, kernel, plain): occ at exp1's shapes (8 x
     2^21-base members on the 30-point grid; 64 members; an unpacked
     class), and the classification modes at the same bench shape
     (pivot_rest 1 + 7 members, multi_pivot D = 4, containment 8 queries
     + 4 groups, buckets D = 4 with cap 255 and pivot counts above 511)
     plus a 63-member containment.
  4. main paths through the port's CLI entry point on a generated 4
     datasets x 8 genomes x 2 Mbp database: `run --exp-type 1`, then
     `--exp-type 2`, `3` and `4` in one work root (exp0 runs once).  Every
     launch counter is set to 0 just before each run and read just after;
     the kernel modes a run uses must have launched, and its CSVs must
     have the expected lines.  Every scan call of these runs is held
     against the plain version on the same arrays, exactly (after the
     call's timed span; the plain version launches nothing).  Wall, peak
     device memory and each scan call's time (CUDA events) are printed.
  5. small worlds: the step_4/step_8 histograms that `run_exp1` writes on
     the card, and the four classification sweeps run on the card, equal
     a dict-based canonical k-mer counter written here (the CSV bytes are
     held against the JAX package and its oracle by the CPU tests).
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
K_GRID = list(range(7, 31)) + list(range(34, 50, 3))  # the reference grid
DB_MBP = 2.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (data sheet)
REPLACES = "khoice_tpu/kernels/ksweep_scan_pallas.py"
SOURCE = "khoice_tpu_torch/csrc/ksweep_scan.cu"
MODES = ("pivot_rest", "multi_pivot", "containment", "buckets")


def phase(name):
    print(f"== {name}", flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def device_check():
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    print(smi_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)


def build():
    phase("2 build")
    from khoice_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"built {os.path.relpath(_build.library_path(), ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    # ptxas: "Compiling entry function '<mangled>'" ... "N bytes spill stores" ...
    # "Used R registers"; template arguments read from the mangled name
    name, spill = None, ""
    for line in _build.build_log().splitlines():
        m = re.search(r"entry function '.*?(tile_summaries|tile_carries|count_runs)I((?:L[ib]\d+E)+)E", line)
        if m:
            name = f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"  ptxas: {name}: {regs} registers; {spill}")
            name = None


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


def bound_ms(words, pay, out_numel):
    """Least time for the scan's bytes: each input read once, the output
    written once, at the card's memory rate."""
    nbytes = words.numel() * 8 + (0 if pay is None else pay.numel() * 8) + out_numel * 8
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_vs_plain(label, members, ks, mode="occ", mode_params=None, plain_reps=2):
    from khoice_tpu_torch.engine.ksweep import _sweep_doubled, plan_sweep
    from khoice_tpu_torch.engine.occurrence import pack_members
    from khoice_tpu_torch.kernels import ksweep_scan

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

    if mode == "occ":
        def kern():
            return ksweep_scan.scan_multi_k(words, pay, cks, g, 5000, packed)

        def plain():
            return ksweep_scan.scan_multi_k_reference(words, pay, cks, g, 5000, packed)
    else:
        def kern():
            return ksweep_scan.scan_classify(words, pay, cks, mode, mode_params, packed)

        def plain():
            return ksweep_scan.scan_classify_reference(words, pay, cks, mode, mode_params, packed)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = int((got - want).abs().max().item())
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].tolist()
        raise AssertionError(f"{label}: kernel != plain scan at {bad}")
    if want.sum() == 0:
        raise AssertionError(f"{label}: empty stats, nothing was compared")
    # in turns: plain, kernel, kernel, plain
    p1 = time_ms(plain, plain_reps)
    k1 = time_ms(kern, 10)
    k2 = time_ms(kern, 10)
    p2 = time_ms(plain, plain_reps)
    bound = bound_ms(words, pay, want.numel())
    print(f"{label}: mode {mode} n2={words.shape[1]} KW={KW} packed={packed} ks={len(cks)} "
          f"members={g} bins={want.shape[2]}: equal (max_abs_err {err}); kernel {k1:.3f} / "
          f"{k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms, bound {bound:.3f} ms (bytes)",
          flush=True)
    return {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": bound}


def kernels_vs_plain():
    phase("3 kernels vs plain")
    rng = np.random.default_rng(0)
    bench = random_members(rng, 8, 1 << 21)
    occ = kernel_vs_plain("bench 8x2^21 grid30", bench, K_GRID)
    wide = kernel_vs_plain("64x2^16 grid30", random_members(rng, 64, 1 << 16), K_GRID)
    unpacked = kernel_vs_plain("bench 8x2^21 ks11..31", bench, list(range(11, 32)))
    occ["max_abs_err"] = max(r["max_abs_err"] for r in (occ, wide, unpacked))
    results = {"occ": occ}
    results["pivot_rest"] = kernel_vs_plain("bench 1+7 members", bench, K_GRID,
                                            "pivot_rest", 7)
    results["multi_pivot"] = kernel_vs_plain("bench D=4", bench, K_GRID, "multi_pivot", 4)
    groups = random_members(rng, 4, 1 << 21)
    results["containment"] = kernel_vs_plain("bench 8 queries + 4 groups", bench + groups,
                                             K_GRID, "containment", (8, 4))
    # the pivot repeats a 60-base block 3000 times: pivot counts of ~6000
    # per run, far above 511 (the TPU kernel's limit) and the cap of 255
    pivot = np.concatenate([bench[0], np.tile(bench[0][1000:1060], 3000)])
    results["buckets"] = kernel_vs_plain("bench D=4 cap 255", [pivot] + bench[1:5], K_GRID,
                                         "buckets", (4, 255))
    wide_c = kernel_vs_plain("63x2^15 containment 42+21", random_members(rng, 63, 1 << 15),
                             K_GRID, "containment", (42, 21), plain_reps=1)
    results["containment"]["max_abs_err"] = max(results["containment"]["max_abs_err"],
                                                 wide_c["max_abs_err"])
    return results


class ScanTimer:
    """Wraps a scan wrapper the engine imported by name: times every call
    (CUDA events around the call, read after the run's last synchronize)
    and, after the timed span, holds the call's result against the plain
    version (`<name>_reference`) on the same inputs, exactly.  `errors`
    gets each mode's largest difference, `plain_s` the seconds the checks
    took; `peak()` is the run's peak device memory without the plain
    versions' own."""

    def __init__(self, module, name):
        from khoice_tpu_torch.kernels import ksweep_scan

        self.module, self.name = module, name
        self.plain = getattr(ksweep_scan, f"{name}_reference")
        self.calls = []
        self.errors = {}
        self.peak_before = 0
        self.plain_s = 0.0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def timed(words, payload, ks, *args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.orig(words, payload, ks, *args)
            end.record()
            mode = "occ" if self.name == "scan_multi_k" else args[0]
            self.peak_before = max(self.peak_before, torch.cuda.max_memory_allocated())
            t0 = time.perf_counter()
            want = self.plain(words, payload, ks, *args)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            self.plain_s += plain_s
            torch.cuda.reset_peak_memory_stats()
            err = int((out - want).abs().max().item())
            self.errors[mode] = max(self.errors.get(mode, 0), err)
            if not torch.equal(out, want) or want.sum() == 0:
                raise AssertionError(f"{mode} scan call at n2={words.shape[1]}: kernel != "
                                     f"plain (max_abs_err {err}) or empty stats")
            self.calls.append((mode, words.shape[1], len(ks), out.shape[2],
                               bound_ms(words, payload, out.numel()), start, end, plain_s))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def peak(self):
        return max(self.peak_before, torch.cuda.max_memory_allocated())

    def report(self):
        torch.cuda.synchronize()
        for what, n, nks, bins, bound, start, end, plain_s in self.calls:
            print(f"  scan call: {what} n2={n} ks={nks} bins={bins}: "
                  f"{start.elapsed_time(end):.3f} ms (bound {bound:.3f} ms); equal to "
                  f"the plain version ({plain_s:.2f} s)")


def reset_counts():
    from khoice_tpu_torch.kernels import ksweep_scan

    for mode in ksweep_scan.launches:
        ksweep_scan.launches[mode] = 0


def read_counts():
    from khoice_tpu_torch.kernels import ksweep_scan

    return dict(ksweep_scan.launches)


def count_lines(path):
    with open(path) as fd:
        lines = fd.read().strip().splitlines()
    for line in lines[1:]:
        for field in line.split(",")[1:]:
            if not np.isfinite(float(field)):
                raise AssertionError(f"{path}: non-finite value in {line!r}")
    return len(lines)


def run_path(label, argv, module, name, uses, expect_lines):
    """Drive one main path through the CLI with every count set to 0 just
    before it, each scan call held against its plain version; return the
    counts read just after and each mode's largest difference."""
    from khoice_tpu_torch import cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ScanTimer(module, name) as timer:
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    if rc != 0:
        raise AssertionError(f"{label} returned {rc}")
    for mode in uses:
        if counts[mode] < 1:
            raise AssertionError(f"{label}: the {mode} kernel was never launched")
    lines = {os.path.basename(p): count_lines(p) for p in expect_lines}
    for path, want in expect_lines.items():
        if lines[os.path.basename(path)] != want:
            raise AssertionError(f"{label}: {path} has {lines[os.path.basename(path)]} "
                                 f"lines, expected {want}")
    peak = timer.peak()
    print(f"{label} on 4x8x{DB_MBP} Mbp, 30 ks: wall {wall - timer.plain_s:.2f} s (and "
          f"{timer.plain_s:.2f} s of plain checks), peak device memory "
          f"{peak / 2**30:.2f} GiB, launches {counts}, lines {lines}", flush=True)
    timer.report()
    return counts, timer.errors


def main_paths(tmp):
    phase("4 main paths: run --exp-type 1, 2, 3, 4")
    from khoice_tpu_torch.engine import ksweep, ksweep_classify

    db = os.path.join(tmp, "db")
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "gen_realistic_db.py"), db,
         "--datasets", "4", "--genomes", "8", "--mbp", str(DB_MBP), "--seed", "7"],
        check=True, capture_output=True,
    )
    print(f"database 4 x 8 x {DB_MBP} Mbp generated in {time.perf_counter() - t0:.1f} s")
    g = len(K_GRID)
    work1 = os.path.join(tmp, "work1")
    launches, errors = {}, {}
    c, e = run_path("exp1", ["run", "--exp-type", "1", "--database-root", db, "--work-root", work1],
                 ksweep, "scan_multi_k", ["occ"], {
                     os.path.join(work1, "step_5/within_datasets_analysis.csv"): 1 + 4 * g,
                     os.path.join(work1, "step_9/across_datasets_analysis.csv"): 1 + g})
    launches["occ"] = c["occ"]
    errors.update(e)
    work = os.path.join(tmp, "work")
    common = ["--database-root", db, "--work-root", work, "--kmers-per-dataset", "2000000"]
    c, e = run_path("exp2 (with exp0)", ["run", "--exp-type", "2", *common],
                 ksweep_classify, "scan_classify", ["pivot_rest", "multi_pivot"], {
                     os.path.join(work, "within_dataset_analysis_type_2/"
                                  "within_dataset_analysis.csv"): 1 + 4 * g,
                     os.path.join(work, "across_dataset_analysis_type_2/"
                                  "across_dataset_analysis.csv"): 1 + 4 * g})
    launches["pivot_rest"], launches["multi_pivot"] = c["pivot_rest"], c["multi_pivot"]
    errors.update(e)
    c, e = run_path("exp3", ["run", "--exp-type", "3", *common],
                 ksweep_classify, "scan_classify", ["containment"], {
                     os.path.join(work, "final_analysis_type3/final_analysis_type3.csv"):
                         1 + 2 * 4 * g * 4})
    launches["containment"] = c["containment"]
    errors.update(e)
    c, e = run_path("exp4", ["run", "--exp-type", "4", *common],
                 ksweep_classify, "scan_classify", ["buckets"], {
                     os.path.join(work, "accuracies_type_4/accuracy_values.csv"): 4 * g})
    launches["buckets"] = c["buckets"]
    errors.update(e)
    return launches, errors


_COMP = str.maketrans("ACGT", "TGCA")


def canonical_counts(records, k):
    """Canonical k-mer counts (lexicographic min of a k-mer and its reverse
    complement) of a genome's records; windows holding an N are skipped."""
    out = {}
    for seq in records:
        for i in range(len(seq) - k + 1):
            kmer = seq[i:i + k]
            if "N" not in kmer:
                c = min(kmer, kmer.translate(_COMP)[::-1])
                out[c] = out.get(c, 0) + 1
    return out


def canonical_kmers(records, k):
    return set(canonical_counts(records, k))


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


def small_genomes(rng, n_groups, per_group):
    def dna(n):
        return "".join("ACGT"[rng.randrange(4)] for _ in range(n))

    base = dna(3000)
    groups = {}
    for num in range(1, n_groups + 1):
        genomes = []
        for i in range(per_group):
            seq = list(base)
            for _ in range(150 + 40 * num):
                seq[rng.randrange(len(seq))] = "ACGT"[rng.randrange(4)]
            p = rng.randrange(len(seq) - 100)
            seq[p:p + 30 + 10 * i] = "N" * (30 + 10 * i)
            genomes.append(["".join(seq), dna(300)])
        groups[num] = genomes
    return groups


def small_world_exp1(tmp):
    phase("5a small world: exp1 vs a dict-based counter")
    from khoice_tpu_torch.pipelines.exp1 import run_exp1

    groups = small_genomes(random.Random(1234), 2, 3)
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


def small_world_classify():
    phase("5b small world: the four classification sweeps vs a dict-based counter")
    from khoice_tpu_torch.engine import ksweep_classify as kc
    from khoice_tpu_torch.io.packing import encode_records as enc

    rng = random.Random(99)
    groups = small_genomes(rng, 3, 3)
    pal = "ACGT" * 12  # palindromic for every even k <= 48
    genomes = [g for num in sorted(groups) for g in groups[num]]
    pivot = [genomes[0][0][:1500] + pal + genomes[0][1], genomes[0][0][200:260] * 20, pal]
    rest = genomes[1:5]
    ks = [6, 8, 12, 21, 31, 33, 45, 49]
    cap = 7

    sets = {}

    def kset(genome, k):
        key = (id(genome), k)
        if key not in sets:
            sets[key] = canonical_kmers(genome, k)
        return sets[key]

    # pivot_rest: the pivot vs four rest genomes
    got, _ = kc.pivot_rest_counts_sweep([enc(pivot)] + [enc(g) for g in rest], ks)
    for k in ks:
        want = np.zeros(len(rest) + 1, np.int64)
        for x in kset(pivot, k):
            want[sum(x in kset(g, k) for g in rest)] += 1
        if not np.array_equal(got[k], want):
            raise AssertionError(f"pivot_rest k={k}: {got[k]} != {want}")
    # multi_pivot: D = 3 pivots vs the three groups (each group's union)
    D = 3
    pivots = [pivot, genomes[3], genomes[6]]
    group_recs = [[s for g in groups[num] for s in g] for num in sorted(groups)]
    got, _ = kc.multi_pivot_counts_sweep([enc(p) for p in pivots] + [enc(g) for g in group_recs],
                                         D, ks)
    for k in ks:
        want = np.zeros((D, D), np.int64)
        for num in range(D):
            for x in kset(pivots[num], k):
                want[num, sum(x in kset(group_recs[j], k) for j in range(D) if j != num)] += 1
        if not np.array_equal(got[k], want):
            raise AssertionError(f"multi_pivot k={k}: {got[k]} != {want}")
    # containment: three read sets vs the three groups
    queries = [[r[i:i + 150] for r in g for i in range(0, len(r) - 150, 97)]
               for g in (pivot, genomes[4], genomes[8])]
    got, _ = kc.containment_counts_sweep([enc(q) for q in queries] + [enc(g) for g in group_recs],
                                         3, 3, ks)
    for k in ks:
        want = np.zeros((3, 4), np.int64)
        for q in range(3):
            qs = kset(queries[q], k)
            want[q, 0] = len(qs)
            for g in range(3):
                want[q, 1 + g] = len(qs & kset(group_recs[g], k))
        if not np.array_equal(got[k], want):
            raise AssertionError(f"containment k={k}: {got[k]} != {want}")
    # buckets: the pivot's capped counts vs the three groups
    got, _ = kc.feature_buckets_sweep([enc(pivot)] + [enc(g) for g in group_recs], D, ks, cap=cap)
    saturated = 0
    for k in ks:
        buckets, unique = np.zeros((D, D), np.int64), 0
        for x, c in canonical_counts(pivot, k).items():
            c = min(c, cap)
            saturated += c == cap
            m = [d for d in range(D) if x in kset(group_recs[d], k)]
            if not m:
                unique += c
            for d in m:
                buckets[d, len(m) - 1] += c
        if not np.array_equal(got[k][0], buckets) or got[k][1] != unique:
            raise AssertionError(f"buckets k={k}: {got[k]} != {(buckets, unique)}")
    if not saturated:
        raise AssertionError("buckets: no pivot count reached the cap")
    print(f"pivot_rest, multi_pivot, containment and buckets (cap {cap}) equal the "
          f"dict-based counter's (ks {ks})")


def kernel_record(name, replaces, launches, r):
    return {
        "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
        "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    }


def main():
    t_all = time.perf_counter()
    walls = {}
    device_check()
    t0 = time.perf_counter()
    build()
    walls["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = kernels_vs_plain()
    walls["kernels vs plain"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launches, errors = main_paths(tmp)
        for mode, err in errors.items():
            results[mode]["max_abs_err"] = max(results[mode]["max_abs_err"], err)
        walls["main paths"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        small_world_exp1(tmp)
        small_world_classify()
        walls["small worlds"] = time.perf_counter() - t0
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    reference = sorted(m for m in sys.modules if m == "khoice_tpu" or m.startswith("khoice_tpu."))
    if reference:
        raise AssertionError(f"modules of the JAX package were imported: {reference}")
    walls["all"] = time.perf_counter() - t_all
    print("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    print(smi_line())
    kernels = [kernel_record("ksweep_scan", f"{REPLACES}:299", launches["occ"], results["occ"])]
    kernels += [kernel_record(f"ksweep_scan.{mode}", f"{REPLACES}:221", launches[mode],
                              results[mode]) for mode in MODES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
