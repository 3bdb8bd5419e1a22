#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (khoice_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: require CUDA and the port beside the script (alone in a
     directory the script exits 1 here); print the card's name and
     power limit.
  2. build: compile khoice_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
     process per source; print ptxas's registers and spills per kernel.
  3. kernels vs plain: each kernel and its plain PyTorch version on the
     same inputs on the card, exactly equal, timed in turns (plain,
     kernel, kernel, plain):
     - first the sweep's extraction (csrc/extract_sweep.cu), since every
       shared-sort input below comes from it: doubled texts of the bench
       class (8 x 2^21 bases, kmax 49, 4 packed words), the unpacked
       class (kmax 30, 2 words and the payload row) and 96 x 2^20 bases
       (~201M positions, kmax 30: a size test, groups over 64 members do
       not sweep), and a streamed chunk in direct mode (a slice of a
       doubled text at an unaligned offset, its positions past the slice
       invalid), each with the profiler's device time; and untimed edge
       cases (n 0, 1, below the halo, a tile +- 1, invalid codes at a tile
       boundary and at the doubled junction, unaligned slices, only
       invalid codes) at every class of the 30-point grid and kmax 63;
     - first the radix sort, since the later kernels' inputs are sorted by
       it: keys and payload bit-equal on the bench class (8 x 2^21 bases,
       33.6M doubled elements, 4 packed words), the unpacked 2-word class
       (kmax 30) with its payload, the per-k packed words of 96 x 2^20 at
       k = 31 and 49 (3 and 4 words), a table merge (2 words, 2^24 keys,
       most present twice, an arange payload: stability), and edge cases
       (n 0, 1, a tile +- 1, all keys equal, 1 and 5 words, half the keys
       SENTINEL, and all-ones elements interleaved with valid keys that
       are all ones in every varying digit but not in the constant ones,
       with only all-ones elements, and with one repeated valid key);
       each sort's planned passes (the wrapper's) must equal those that
       the plain statistics of its first pass predict, and the first
       pass's statistics are held against their plain version on the
       bench class and the per-k words; `torch.sort(stable=True)` of the
       folded key plus the gathers is timed beside it where one call
       computes the same function (1-2 words);
     - the scan kernel in each mode on a sorted doubled text: occ at
       exp1's shapes (8 x 2^21-base members on the 30-point grid; 64
       members; an unpacked class), the classification modes at the same
       bench shape (pivot_rest 1 + 7 members, multi_pivot D = 4,
       containment 8 queries + 4 groups, buckets D = 4 with cap 255 and
       pivot counts above 511) plus a 63-member containment; each mode's
       time over its bound at the bench shape is printed;
     - the extraction kernel (A) on 2^24 codes with N runs, k in
       {7, 15, 16, 31, 32, 49, 63}, keys and the gid-packed form, and at
       the size of a call of exp1's table ops (2.0M codes, k in {7, 15,
       21, 31, 49}), each with the profiler's device time beside the
       wrapper's span;
     - the occurrence-histogram kernel, packed (B), on the sorted words of
       96 members x 2^20 at k = 31 and 49 (one member with a poly-A
       tract, so runs cross tiles), and unpacked (C) on 300 members x
       2^16 at k = 31; each one's time over its bound is printed;
     - exp6's vote kernels: vote_mask on the merge-join of 4 related
       datasets x 2^24 text positions (one with a poly-A tract) and 2^23
       read positions at k = 7, 21, 33, 49 (W 1, 2, 4, 4) and on edge
       cases (no query, no text element, runs of queries only, a run
       over 3 tiles, queries at tile edges, the SENTINEL run; W 1 and
       4); read_votes on 2^14 ONT-like rows of 1001 and 2^16
       Illumina-like rows of 151 at D = 4 and 32; each one's time over
       its bound is printed.
  4. main paths through the port's CLI entry point:
     a. on a generated 4 datasets x 8 genomes x 2 Mbp database:
        `run --exp-type 1`, then 2, 3 and 4 in one work root (exp0 runs
        once), then exp 3 and 4 again with `--force --k-values 21,31`
        (the per-k table ops), then `run --exp-type 6` (both read
        types);
     b. on a generated 2 datasets x 96 genomes x 1 Mbp database (groups
        over the sweep's 64-member mask): `run --exp-type 1` on the full
        grid, and `run --exp-type 2` then 6 in their own work root (exp6
        joins ~192M group-text positions with the reads per k).
     c. the streaming sweep: `run --exp-type 1 --force` on 4b's database
        with `--device-budget-gb 12` (the 386.8M-element across set
        streams, the per-k within-group sorts fit) and on 4a's with 4
        (the 128.1M-element across set streams, the groups run in-core);
        the CSVs must equal 4a's and 4b's in-core bytes, the peak device
        memory must stay within the budget, and the stream's log lines
        (chunks, key-range groups, passes, retries) are printed.
     d. exp1's table ops and the MEM experiments: `run_exp1(...,
        fused=False)` on 4a's database over the 30-point grid (a count of
        every genome at every k, the within- and across-group unions:
        960 counts and 150 unions), its CSVs equal to 4a's fused run's,
        every kernel-A call and every sort held against its plain version
        and each checked step within its estimate; then `run --exp-type
        5`, 7 and 8 (with exp0) on a generated 2 x 4 x 0.05 Mbp database
        (host suffix arrays: exp8 takes MEM_READS reads per read type and
        dataset), which must launch no kernel, load the native MS engine
        and write every matrix and trial CSV with a finite row per
        dataset.
     Every launch counter is set to 0 just before each run and read just
     after; the kernels a run uses must have launched (the sort on every
     run), and its CSVs must have the expected lines.  In each 4a/4b run
     the largest device-memory estimate that the engine checked against
     its budget (with what the run held at the check) is printed beside
     the run's peak, with the checked step whose own peak comes nearest
     to (or furthest over) its estimate and the one whose estimate is
     loosest against its own peak; the run's peak must not exceed
     the largest estimate, nor any checked step's peak its own.  Each
     kernel call is
     timed (CUDA events) and held against its plain version on the same
     inputs, exactly, after its timed span: every scan call of 4a, every
     sweep extraction of 4a/4b and every phase-6 run, the
     first SORT_HOLDS sorts of each 4a/4b run, in 4b every extraction
     and histogram call at the ks where a word count changes (HOLD_KS),
     in each exp6 run every vote_mask and read_votes call at HOLD_KS,
     and in each 4c run the first STREAM_HOLDS chunk extractions and
     sorts, the first key-range group's sort and its raw scan; every run
     that sweeps must launch the sweep's extraction; 4b's scan calls (388M
     elements) are timed only.  Wall, peak device memory and each
     kernel's calls are printed, and each run's sort launches; the
     kernels line reports the sort's from one run, SORT_RUN.
  5. small worlds, against a dict-based canonical k-mer counter written
     here: the step_4/step_8 histograms that `run_exp1` writes on the card
     for 2 groups x 3 genomes, then for a group of 70 genomes and one of
     300 (per-k, packed and unpacked) on a 2-k and a 7-k grid (each
     kernel call timed, every C call held against its plain version); the four
     classification sweeps; exp6's votes, unmatched and n_kmers per read
     (D = 3, k in {7, 21, 33, 49}); and count_codes, union, intersect_sum,
     subtract and histogram at k in {11, 31, 45}.  (The CSV bytes are
     held against the JAX package and its oracle by the CPU tests.)
  6. the key-range SPMD path (khoice_tpu_torch/dist/) over a key-range
     group of one rank on NCCL (cuda:0, made in this process from a
     FileStore: the machine has one card and NCCL takes one rank per
     card), whose exchange, gathers and sums still run:
     a. `run_exp1(..., group=g)` on 4a's database over the 30-point
        grid, its step_5 and step_9 bytes equal to 4a's; every sort and
        scan call held against its plain version, the peak within the
        largest checked estimate and every checked step within its own;
     b. `run_exp2`, `run_exp3` and `run_exp4` with the group on 4a's
        exp0 (pivots, non-pivots; exp3's reads simulated as the CLI
        does), their CSV bytes equal to 4a's 30-k runs'; every scan call
        and the first SORT_HOLDS sorts of each run held;
     c. `sharded_count_codes` of 4a's group 1 at k 21 and 31, the union
        of the sets, intersect_sum, subtract, set_counts and the
        histogram, equal to the single-device KmerEngine's tables, and
        `sharded_occurrence_histogram` of 4b's first group (96 genomes,
        kernels A, sort, B) and phase 5a's 300 genomes (C) at k 31, equal
        to `occurrence_histogram`; every kernel call held;
     d. exp1's sharded sweep of 4a's group 1 over the 30 ks on two gloo
        ranks, both on cuda:0 (dist/launch.py::run_ranks; gloo takes CUDA
        tensors), every rank's histograms equal to 6a's step_4 files,
        every kernel call of each rank held;
     e. `run_exp6(..., group=g)` on 4a's exp0 over the 30 ks, both read
        types (dist/vote.py: per rank kernel A, one stable sort, vote_mask
        and read_votes per k), every trial and per-k file byte-equal to
        4a's single-device exp6; every A, sort, vote_mask and read_votes
        call at one k per key-word class (HOLD_6E) held;
     f. two processes, each started alone as on its own host (env://,
        MASTER_ADDR 127.0.0.1, gloo, both on cuda:0), run
        `multihost_read_votes_multi` (exp6's datasets with exp0's
        Illumina reads) and `multihost_occurrence_histograms_sweep` (4a's
        group 1) at k 11, 21, 33 and 49 (dist/multihost.py), every kernel
        call held; both must equal the single-device votes and histograms.
     Each run's launches are counted from 0 and added to the kernels
     line's.  Phase 2 also asserts that the native FASTA scanner loaded.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

import json
import math
import os
import random
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# The plain scans' checks take one piece of ~32 GiB beside the run's
# cached blocks; segments that grow keep the allocator's cache from
# splitting the card into pieces too small for it.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

ROOT = os.path.dirname(os.path.abspath(__file__))
K_GRID = list(range(7, 31)) + list(range(34, 50, 3))  # the reference grid
HOLD_KS = (12, 13, 15, 16, 28, 29, 30, 34, 43, 46)  # every change of a word count
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (data sheet)
SCAN_REPLACES = "khoice_tpu/kernels/ksweep_scan_pallas.py"
SCAN_SOURCE = "khoice_tpu_torch/csrc/ksweep_scan.cu"
VOTE_SOURCE = "khoice_tpu_torch/csrc/vote.cu"
SORT_HOLDS = 3  # sorts of each 4a/4b run held against the plain sort
STREAM_HOLDS = 2  # chunk sorts of each 4c run held against the plain sort
SORT_RUN = "exp1 streamed on 2 x 96 x 1 Mbp"  # the run whose sort launches are reported
HOLD_6E = (15, 31, 49)  # one k per key-word class: 6e's held calls
MULTIHOST_KS = (11, 21, 33, 49)  # 6f's ks
MODES = ("pivot_rest", "multi_pivot", "containment", "buckets")
CSVS = {  # each experiment's CSVs under its work root
    1: ("step_5/within_datasets_analysis.csv", "step_9/across_datasets_analysis.csv"),
    2: ("within_dataset_analysis_type_2/within_dataset_analysis.csv",
        "across_dataset_analysis_type_2/across_dataset_analysis.csv"),
    3: ("final_analysis_type3/final_analysis_type3.csv",),
    4: ("accuracies_type_4/accuracy_values.csv",),
}


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
    # the port is built and driven from the checkout this script lies in;
    # alone in a directory the script has nothing to run
    if not os.path.isdir(os.path.join(ROOT, "khoice_tpu_torch", "csrc")):
        raise SystemExit(f"chip_smoke: no khoice_tpu_torch/ beside {__file__}; run it from the "
                         "root of a checkout of the repository")
    print(smi_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)


def build():
    phase("2 build")
    from khoice_tpu_torch.kernels import _build

    # the FASTA scanner builds with g++ and raises if it cannot
    from khoice_tpu_torch.io import fasta

    if os.environ.get("KHOICE_NO_NATIVE") or fasta._codec_lib() is None:
        raise AssertionError("the native FASTA scanner did not load (KHOICE_NO_NATIVE set?)")
    print("native FASTA scanner loaded from "
          f"{os.path.relpath(fasta._BUILD_DIR, ROOT)}/libkhoice_fasta.so", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"built {os.path.relpath(_build.library_path(), ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    # ptxas: "Compiling entry function '<mangled>'" ... "N bytes spill stores" ...
    # "Used R registers"; one line per kernel: its instantiations' registers
    name, spill, kernels = None, 0, {}
    for line in _build.build_log().splitlines():
        m = re.search(r"entry function '.*?(occ_tiles|scan_tiles|extract_kernel|sweep_tiles"
                      r"|(?:first|middle|last)_pass_kernel|vote_mask_tiles|read_votes_rows)",
                      line)
        if m:
            name = m.group(1)
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            kernels.setdefault(name, []).append((regs, spill))
            name = None
    for name, inst in kernels.items():
        regs = [r for r, _ in inst]
        print(f"  ptxas: {name}: {len(inst)} instantiations, {min(regs)}-{max(regs)} "
              f"registers, {sum(s for _, s in inst)} bytes spilled")


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


def io_bound_ms(args, out):
    """Least time for a call's bytes: each input tensor read once, each
    output tensor written once (int64 words at 8 B, as the port holds
    them), at the card's memory rate."""
    def nbytes(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, (tuple, list)):
            return sum(nbytes(y) for y in x)
        return 0
    return (nbytes(args) + nbytes(out)) / HBM_BYTES_PER_S * 1e3


def max_err(got, want):
    """Largest absolute difference of two results (tensors, None or tuples)."""
    if got is None or want is None:
        if got is not None or want is not None:
            raise AssertionError("one result is None, the other is not")
        return 0
    if isinstance(got, tuple):
        return max(max_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        raise AssertionError(f"shapes differ: {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max().item())


def device_ms(fn, kernel, reps=10):
    """Mean device time of the CUDA kernel whose name holds `kernel` per
    launch, from torch.profiler's trace of `reps` calls of fn (one launch
    each; the wrapper's host time left out): the trace's total over the
    launches it recorded, which can be fewer than `reps` (the tracer drops
    records now and then); None where it recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel in e.key]
    us, count = sum(getattr(e, "device_time_total", 0) for e in rows), sum(e.count for e in rows)
    return us / count / 1e3 if us and count else None


def compare(label, kern, plain, args, plain_reps=2, kern_reps=10, profiled=None):
    """Kernel vs plain on the same inputs: exactly equal, timed in turns;
    `profiled` names the CUDA kernel whose device time the profiler adds."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max_err(got, want)
    if err:
        raise AssertionError(f"{label}: kernel != plain (max_abs_err {err})")
    first = want[0] if isinstance(want, tuple) else want
    if not first.any():
        raise AssertionError(f"{label}: empty result, nothing was compared")
    p1 = time_ms(plain, plain_reps)
    k1 = time_ms(kern, kern_reps)
    k2 = time_ms(kern, kern_reps)
    p2 = time_ms(plain, plain_reps)
    bound = io_bound_ms(args, got)
    dev = device_ms(kern, profiled, kern_reps) if profiled else None
    print(f"{label}: equal (max_abs_err {err}); kernel {k1:.3f} / {k2:.3f} ms"
          f"{' (device time %s)' % ('%.3f ms' % dev if dev else 'not in the trace') if profiled else ''}, "
          f"plain {p1:.3f} / {p2:.3f} ms, bound {bound:.3f} ms (bytes)", flush=True)
    return {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": bound}


def library_sort(words, payload):
    """One `torch.sort(stable=True)` of the folded int64 key plus the
    gathers: the radix sort's function for 1-2 words (timed only; the
    port never calls it)."""
    key = words[0] if words.shape[0] == 1 else (words[0] - (1 << 31)) * (1 << 32) + words[1]
    perm = torch.sort(key, stable=True).indices
    return words[:, perm], (None if payload is None else payload[perm])


def planned_passes(label, words):
    """The radix sort's plan for its last sort of `words` (the wrapper's)
    against the plan that the plain statistics of its first pass give:
    equal, or raise.  Returns "P passes (+ the all-ones bucket)"."""
    from khoice_tpu_torch.kernels import sort as ksort

    want = ksort.plan_passes(*ksort.sort_stats_reference(words))
    if ksort.last_plan != want:
        raise AssertionError(f"sort {label}: planned {ksort.last_plan}, the plain "
                             f"statistics give {want}")
    digits, ones = want
    return (f"{len(digits)} planned passes of {4 * words.shape[0]} (plain statistics: "
            f"{len(want[0])}){' + the all-ones bucket' if ones else ''}")


def stats_vs_plain(label, words):
    """The radix sort's first pass's statistics (digit histograms without
    the all-ones elements, their count, whether they sit at the tail)
    against their plain version, exactly."""
    from khoice_tpu_torch.kernels import sort as ksort

    hist, n_ones, at_tail = ksort.sort_stats(words)
    want = ksort.sort_stats_reference(words)
    if not (torch.equal(hist, want[0]) and (n_ones, at_tail) == want[1:]):
        raise AssertionError(f"sort {label}: first-pass statistics differ from the plain "
                             f"version ({n_ones}, {at_tail}) vs {want[1:]}")
    print(f"sort {label}: first-pass statistics equal the plain version's ({n_ones} all-ones "
          f"elements, at the tail: {at_tail})", flush=True)


def sort_vs_plain(label, words, payload, timed=True, plain_reps=2):
    """The radix sort vs the plain sort on the same inputs, keys and
    payload bit-equal, its plan equal to the plain statistics'; timed in
    turns, with the library call beside it where one computes the same
    function.  Bound: one read and one write of the int64 rows and
    payload."""
    from khoice_tpu_torch.kernels import sort as ksort

    W, n = words.shape
    got, want = ksort.sort_words(words, payload), ksort.sort_words_reference(words, payload)
    torch.cuda.synchronize()
    err = max_err(got, want)
    if err:
        raise AssertionError(f"sort {label}: kernel != plain (max_abs_err {err})")
    passes = planned_passes(label, words) if n else "no pass (n 0)"
    if not timed:
        print(f"sort {label} W={W} n={n}{' + payload' if payload is not None else ''}: "
              f"equal (max_abs_err {err}); {passes}", flush=True)
        return {"max_abs_err": err, "passes": passes}
    kern = lambda: ksort.sort_words(words, payload)  # noqa: E731
    plain = lambda: ksort.sort_words_reference(words, payload)  # noqa: E731
    p1 = time_ms(plain, plain_reps)
    k1 = time_ms(kern, 10)
    k2 = time_ms(kern, 10)
    p2 = time_ms(plain, plain_reps)
    lib = None
    if W <= 2:
        if max_err(library_sort(words, payload), want):
            raise AssertionError(f"sort {label}: the library call computes another function")
        lib = time_ms(lambda: library_sort(words, payload), 10)
    bound = io_bound_ms((words, payload), got)
    print(f"sort {label} W={W} n={n}{' + payload' if payload is not None else ''}: equal "
          f"(max_abs_err {err}); {passes}; "
          f"kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms, "
          f"library {'%.3f ms' % lib if lib is not None else 'none'}, bound {bound:.3f} ms "
          "(bytes)", flush=True)
    return {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": bound, "library_ms": lib, "passes": passes}


SWEEP_EDGE_CLASSES = ((30, 2, False), (46, 3, False), (49, 4, True), (49, 4, False),
                      (63, 4, False))  # the 30-point grid's classes, and kmax 63


def sweep_kernel_vs_plain(bench, members96):
    """The sweep's extraction (kernels/extract_sweep.py) against its plain
    version: the doubled texts of the bench class, the unpacked class and
    96 x 2^20 bases, and a streamed chunk in direct mode, each timed with
    the profiler's device time; then untimed edge cases at every class of
    the 30-point grid and kmax 63.  Returns the kernels line's record (the
    bench class) with the largest difference over every case."""
    from khoice_tpu_torch.engine.occurrence import pack_members
    from khoice_tpu_torch.kernels import _build
    from khoice_tpu_torch.kernels import extract_sweep as kxs

    dev = torch.device("cuda")
    errs = []

    def doubled(label, codes, gids, kmax, KW, packed, plain_reps=2):
        return compare(f"sweep extraction {label} (kmax {kmax}, KW {KW}, packed {packed}, "
                       f"doubled, n2={2 * codes.shape[0]})",
                       lambda: kxs.doubled_elements(codes, gids, kmax, KW, packed),
                       lambda: kxs.doubled_elements_reference(codes, gids, kmax, KW, packed),
                       (codes, gids), plain_reps, profiled="sweep_tiles")

    codes, gids = pack_members(bench, dev)
    record = doubled("bench class 8x2^21", codes, gids, 49, 4, True)
    errs.append(doubled("unpacked class 8x2^21", codes, gids, 30, 2, False)["max_abs_err"])
    # a chunk of the streaming sweep: a slice of the doubled text with its
    # halo, at an offset off any 16-B boundary
    d_codes = torch.cat([codes, torch.where(codes < 4, codes ^ 3, codes).flip(0)])
    start, C, H = 12345, 1 << 23, 48
    chunk = d_codes[start:start + C + H]
    chunk_gids = torch.arange(C + H, device=dev) % 8
    errs.append(compare(f"sweep extraction streamed chunk (direct, {C} + {H} positions at "
                        f"offset {start}, kmax 49, KW 4, packed)",
                        lambda: kxs.extract_fwd_sweep(chunk, chunk_gids, 49, 4, True),
                        lambda: kxs.extract_fwd_sweep_reference(chunk, chunk_gids, 49, 4, True),
                        (chunk, chunk_gids), profiled="sweep_tiles")["max_abs_err"])
    del codes, gids, d_codes, chunk, chunk_gids
    codes, gids = pack_members(members96, dev)
    errs.append(doubled("96x2^20 (a size test)", codes, gids, 30, 2, False,
                        plain_reps=1)["max_abs_err"])
    del codes, gids
    rng = np.random.default_rng(13)
    tile = _build.load().extract_sweep_tile_elems()
    buf = torch.from_numpy(rng.integers(0, 4, 6 * tile, dtype=np.uint8)).to(dev)
    gbuf = torch.from_numpy(rng.integers(0, 64, 6 * tile)).to(dev)
    cases = [(f"n {n}", buf[:n], gbuf[:n])
             for n in (0, 1, 63, (tile - 1) // 2, tile // 2, tile - 1, tile, tile + 1)]
    marked = buf[:3 * tile + 8].clone()
    marked[[tile - 1, tile, marked.shape[0] - 1]] = 4  # a tile boundary, the junction
    cases += [("invalid codes at a tile boundary and the doubled junction", marked,
               gbuf[:3 * tile + 8])]
    cases += [(f"unaligned slice at offset {off}", buf[off:off + 2 * tile + 45],
               gbuf[off:off + 2 * tile + 45]) for off in (1, 13)]
    cases += [("only invalid codes", torch.full((tile + 7,), 4, dtype=torch.uint8, device=dev),
               gbuf[:tile + 7])]
    for label, codes, gids in cases:
        for kmax, KW, packed in SWEEP_EDGE_CLASSES:
            for fn, plain in ((kxs.doubled_elements, kxs.doubled_elements_reference),
                              (kxs.extract_fwd_sweep, kxs.extract_fwd_sweep_reference)):
                err = max_err(fn(codes, gids, kmax, KW, packed), plain(codes, gids, kmax, KW, packed))
                errs.append(err)
                if err:
                    raise AssertionError(f"sweep extraction {label} kmax={kmax} KW={KW} "
                                         f"packed={packed} {fn.__name__}: kernel != plain ({err})")
        print(f"sweep extraction {label}: equal at kmax/KW {SWEEP_EDGE_CLASSES}, doubled and "
              "direct", flush=True)
    record["max_abs_err"] = max([record["max_abs_err"]] + errs)
    print(f"sweep extraction's time over its bound at the bench class: "
          f"{record['ms'] / record['bound_ms']:.1f}x", flush=True)
    return record


def sort_kernel_vs_plain(bench, members96):
    """The radix sort at the main paths' shapes and at the edge cases;
    returns the kernels line's record (the unpacked 2-word class, where
    the library call computes the same function) with the largest
    difference over every case."""
    from khoice_tpu_torch.engine.ksweep import _doubled_elements
    from khoice_tpu_torch.engine.occurrence import pack_members
    from khoice_tpu_torch.kernels import _build, extract

    dev = torch.device("cuda")
    errs = []
    codes, gids = pack_members(bench, dev)
    words, _ = _doubled_elements(codes, gids, 49, 4, True)
    stats_vs_plain("bench class", words)
    errs.append(sort_vs_plain("bench class 8x2^21 (kmax 49, packed)", words, None)["max_abs_err"])
    del words
    words, pay = _doubled_elements(codes, gids, 30, 2, False)
    record = sort_vs_plain("unpacked class 8x2^21 (kmax 30)", words, pay)
    del words, pay, codes, gids
    codes, gids = pack_members(members96, dev)
    for k in (31, 49):
        words = extract.extract_packed(codes, gids, k)
        stats_vs_plain(f"per-k packed 96x2^20 k={k}", words)
        errs.append(sort_vs_plain(f"per-k packed 96x2^20 k={k}", words, None,
                                  plain_reps=1)["max_abs_err"])
        del words
    del codes, gids
    rng = np.random.default_rng(3)

    def rand(W, n, high=2**32):
        return torch.from_numpy(rng.integers(0, high, (W, n), dtype=np.int64)).to(dev)

    # a table merge: two tables' unique keys, most of b's also in a, with
    # the arange payload that tells a's copy from b's (stability)
    a = rand(2, 1 << 23)
    b = a[:, torch.from_numpy(rng.permutation(1 << 23)).to(dev)]
    b[:, : 1 << 20] = rand(2, 1 << 20)
    errs.append(sort_vs_plain("table merge 2^24 keys", torch.cat([a, b], 1),
                              torch.arange(1 << 24, device=dev))["max_abs_err"])
    del a, b
    lib = _build.load()
    half = rand(4, 1 << 20)
    half[:, torch.from_numpy(rng.permutation(1 << 20)[: 1 << 19]).to(dev)] = 0xFFFFFFFF

    def sentinels(words):
        """A third of the elements all ones, interleaved."""
        words[:, torch.from_numpy(rng.random(words.shape[1]) < 1 / 3).to(dev)] = 0xFFFFFFFF
        return words

    # valid keys of the per-k k = 31 layout (the top word's upper three
    # bytes constant 0) that are all ones in every varying digit
    near = rand(3, 1 << 20)
    near[0] &= 0xFF
    close = torch.from_numpy(rng.random(1 << 20) < 0.3).to(dev)
    near[0, close] = 0xFF
    near[1:, close] = 0xFFFFFFFF
    for label, words in (("n 0", rand(4, 0)), ("n 1", rand(4, 1)),
                         ("tile - 1", rand(4, lib.radix_sort_tile_elems(4, 1) - 1)),
                         ("tile + 1", rand(3, lib.radix_sort_tile_elems(3, 1) + 1)),
                         ("all keys equal", rand(4, 1).expand(4, 1 << 20).contiguous()),
                         ("W 1, heavy ties", rand(1, 1 << 20, high=5000)),
                         ("W 5", rand(5, 1 << 20)), ("half SENTINEL", half),
                         ("near-SENTINEL keys among SENTINELs", sentinels(near)),
                         ("only SENTINELs", torch.full((3, 1 << 20), 0xFFFFFFFF, device=dev)),
                         ("one key among SENTINELs",
                          sentinels(rand(2, 1).expand(2, 1 << 20).contiguous()))):
        errs.append(sort_vs_plain(label, words, torch.arange(words.shape[1], device=dev),
                                  timed=False)["max_abs_err"])
    record["max_abs_err"] = max([record["max_abs_err"]] + errs)
    return record


def scan_vs_plain(label, members, ks, mode="occ", mode_params=None, plain_reps=2):
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
        args = (words, pay, cks, g, 5000, packed)
        kern, plain = ksweep_scan.scan_multi_k, ksweep_scan.scan_multi_k_reference
    else:
        args = (words, pay, cks, mode, mode_params, packed)
        kern, plain = ksweep_scan.scan_classify, ksweep_scan.scan_classify_reference
    return compare(f"{label}: mode {mode} n2={words.shape[1]} KW={KW} packed={packed} "
                   f"ks={len(cks)} members={g}", lambda: kern(*args), lambda: plain(*args),
                   args, plain_reps)


def perk_kernels_vs_plain(rng, members96):
    """Kernels A, B and C against their plain versions at phase 3's shapes."""
    from khoice_tpu_torch.engine.occurrence import _sorted_pairs, pack_members
    from khoice_tpu_torch.kernels import extract, occ_scan

    dev = torch.device("cuda")
    results = {}
    codes = torch.from_numpy(random_members(rng, 1, 1 << 24)[0]).to(dev)
    gids = torch.from_numpy(rng.integers(0, 256, 1 << 24)).to(dev)
    errs = []
    for k in (7, 15, 16, 31, 32, 49, 63):
        r = compare(f"A extract_canonical n=2^24 k={k}",
                    lambda: extract.extract_canonical(codes, k),
                    lambda: extract.extract_canonical_reference(codes, k), (codes,),
                    profiled="extract_kernel")
        errs.append(r["max_abs_err"])
        if k == 31:
            results["A"] = r
        if k <= 60:
            errs.append(compare(f"A extract_packed n=2^24 k={k}",
                                lambda: extract.extract_packed(codes, gids, k),
                                lambda: extract.extract_packed_reference(codes, gids, k),
                                (codes, gids), profiled="extract_kernel")["max_abs_err"])
    del codes, gids
    # exp1's table ops call A once per genome and k (<= 2.0M codes): the
    # wrapper's span beside the kernel's device time (the profiler's)
    small = torch.from_numpy(random_members(np.random.default_rng(12), 1, 2_000_000)[0]).to(dev)
    for k in (7, 15, 21, 31, 49):
        errs.append(compare(f"A extract_canonical n=2.0M (a table op's call) k={k}",
                            lambda: extract.extract_canonical(small, k),
                            lambda: extract.extract_canonical_reference(small, k), (small,),
                            profiled="extract_kernel")["max_abs_err"])
    results["A"]["max_abs_err"] = max(errs)
    del small

    codes, gids = pack_members(members96, dev)
    errs = []
    for k in (31, 49):
        words, _ = _sorted_pairs(codes, gids, k, True)
        r = compare(f"B occ_hist_packed 96x2^20 n={words.shape[1]} W={words.shape[0]} k={k}",
                    lambda: occ_scan.occ_hist_packed(words, 96, 5000),
                    lambda: occ_scan.occ_hist_packed_reference(words, 96, 5000), (words,))
        errs.append(r["max_abs_err"])
        results["B" if k == 31 else f"B k={k}"] = r
        del words
    results["B"]["max_abs_err"] = max(errs)
    del codes, gids

    codes, gids = pack_members(random_members(rng, 300, 1 << 16), dev)
    keys, gid = _sorted_pairs(codes, gids, 31, False)
    results["C"] = compare(f"C occ_hist 300x2^16 n={keys.shape[1]} W={keys.shape[0]} k=31",
                           lambda: occ_scan.occ_hist(keys, gid, 300, 5000),
                           lambda: occ_scan.occ_hist_reference(keys, gid, 300, 5000),
                           (keys, gid))
    print("occurrence histograms' time over their bound: " + ", ".join(
        f"{label} {results[key]['ms'] / results[key]['bound_ms']:.1f}x"
        for label, key in (("B k=31", "B"), ("B k=49", "B k=49"), ("C", "C"))), flush=True)
    return results


def vote_edge(rng, W, D, runs):
    """A sorted merge-join of synthetic runs: run i, a random key of W
    words (ascending), holds runs[i] = (texts, queries) elements, texts
    first with random gids < D, queries numbered in a random order; a
    run of key None is the SENTINEL run, last."""
    dev = torch.device("cuda")
    keys = np.unique(rng.integers(0, 2**31, (len(runs) + 8, W), dtype=np.int64), axis=0)
    keys = keys[:len(runs)].copy()
    keys[[i for i, r in enumerate(runs) if r[0] is None]] = 0xFFFFFFFF
    lens = [t + q for _, t, q in runs]
    nq = sum(q for _, _, q in runs)
    order, pay, qi = D + rng.permutation(nq), [], 0
    for _key, t, q in runs:
        pay += [np.sort(rng.integers(0, D, t)), order[qi:qi + q]]
        qi += q
    words = torch.from_numpy(np.repeat(keys, lens, axis=0).T.copy()).to(dev)
    return words, torch.from_numpy(np.concatenate(pay).astype(np.int64)).to(dev), nq


def vote_kernels_vs_plain(rng):
    """vote_mask on exp6's merge-join of 4 related datasets x 2^24 text
    positions (one with a poly-A tract: runs over many tiles) and 2^23
    read positions at k = 7, 21, 33, 49 (W 1, 2, 4, 4), its edge cases,
    and read_votes on ONT- and Illumina-like rows at D = 4 and 32."""
    from khoice_tpu_torch.classify import annotate
    from khoice_tpu_torch.kernels import _build
    from khoice_tpu_torch.kernels import vote as kvote

    dev = torch.device("cuda")
    base = rng.integers(0, 4, 1 << 24, dtype=np.uint8)
    groups = []
    for d in range(4):
        g = base.copy()
        pos = rng.integers(0, 1 << 24, (1 << 16) * (d + 1))
        g[pos] = rng.integers(0, 4, pos.shape[0], dtype=np.uint8)
        g[rng.integers(0, 1 << 24, 64)] = 4
        groups.append(g)
    groups[1][: 1 << 20] = 0  # a poly-A tract
    n_reads = (1 << 23) // 151
    starts = rng.integers(0, (1 << 24) - 150, n_reads)
    reads = np.stack([groups[i % 4][s:s + 150] for i, s in enumerate(starts)])
    err = rng.random(reads.shape) < 0.01
    reads[err] = rng.integers(0, 4, int(err.sum()), dtype=np.uint8)
    codes, gids = annotate.pack_group_texts(groups, dev)
    flat, _, _ = annotate.flat_reads_device(reads, dev)
    del groups, reads
    results, errs = {}, []
    for k in (7, 21, 33, 49):
        sw, sp, _ = annotate._merge_join(codes, gids, flat, k, 4)
        nq = flat.shape[0]
        r = compare(f"vote_mask 4 x 2^24 + {nq} queries W={sw.shape[0]} k={k} n={sw.shape[1]}",
                    lambda: kvote.vote_mask(sw, sp, 4, nq),
                    lambda: kvote.vote_mask_reference(sw, sp, 4, nq), (sw, sp),
                    profiled="vote_mask_tiles")
        errs.append(r["max_abs_err"])
        if k == 21:
            results["vote_mask"] = r
        del sw, sp
    del codes, gids, flat
    tile = _build.load().vote_mask_tile_elems()
    for label, runs in (
            ("no query", [(1, 5, 0)] * 200),
            ("no text element", [(1, 0, int(q)) for q in rng.integers(1, 30, 2000)]),
            ("runs of queries only", [(1, 0, 7), (1, 3, 0), (1, 2, 2)] * 1000),
            ("a run over 3 tiles", [(1, 5, 3)] * 10 + [(1, tile + 17, 2 * tile)] + [(1, 3, 4)] * 900),
            ("queries at tile edges", [(1, tile - 1, 1), (1, 1, 1), (1, tile - 3, 2), (1, 2, 2)] * 3),
            ("the SENTINEL run", [(1, 4, 4)] * 100 + [(None, 100, 3 * tile)])):
        for W in (1, 4):
            words, pay, nq = vote_edge(rng, W, 4, runs)
            got, want = kvote.vote_mask(words, pay, 4, nq), kvote.vote_mask_reference(words, pay, 4, nq)
            errs.append(max_err(got, want))
            if errs[-1]:
                raise AssertionError(f"vote_mask {label} W={W}: kernel != plain ({errs[-1]})")
        print(f"vote_mask {label} (W 1 and 4, n={words.shape[1]}, {nq} queries, "
              f"{int((want != 0).sum())} matched): equal", flush=True)
    results["vote_mask"]["max_abs_err"] = max(errs)
    errs = []
    for label, R, L in (("ONT-like", 1 << 14, 1001), ("Illumina-like", 1 << 16, 151)):
        for D in (4, 32):
            n = R * L
            qmask = torch.from_numpy(rng.integers(0, 2**D, n, dtype=np.int64)).to(dev)
            qmask[torch.from_numpy(rng.random(n) < 0.3).to(dev)] = 0
            valid = torch.from_numpy(rng.random(n) >= 0.05).to(dev)
            rows = torch.arange(R + 1, device=dev) * L
            lcm = math.lcm(*range(1, D + 1))
            r = compare(f"read_votes {label} {R} rows of {L} D={D}",
                        lambda: kvote.read_votes(qmask, valid, rows, D, lcm),
                        lambda: kvote.read_votes_reference(qmask, valid, rows, D, lcm),
                        (qmask, valid, rows), profiled="read_votes_rows")
            errs.append(r["max_abs_err"])
            if (label, D) == ("ONT-like", 4):
                results["read_votes"] = r
    results["read_votes"]["max_abs_err"] = max(errs)
    print("vote kernels' time over their bound: " + ", ".join(
        f"{key} {results[key]['ms'] / results[key]['bound_ms']:.1f}x"
        for key in ("vote_mask", "read_votes")), flush=True)
    return results


def kernels_vs_plain():
    phase("3 kernels vs plain")
    rng = np.random.default_rng(0)
    bench = random_members(rng, 8, 1 << 21)
    members96 = random_members(rng, 96, 1 << 20)
    members96[0] = np.concatenate([members96[0], np.zeros(100_000, np.uint8)])  # poly-A
    sweep = sweep_kernel_vs_plain(bench, members96)
    sort = sort_kernel_vs_plain(bench, members96)
    occ = scan_vs_plain("bench 8x2^21 grid30", bench, K_GRID)
    wide = scan_vs_plain("64x2^16 grid30", random_members(rng, 64, 1 << 16), K_GRID)
    unpacked = scan_vs_plain("bench 8x2^21 ks11..31", bench, list(range(11, 32)))
    occ["max_abs_err"] = max(r["max_abs_err"] for r in (occ, wide, unpacked))
    results = {"occ": occ, "sort": sort, "sweep": sweep}
    results["pivot_rest"] = scan_vs_plain("bench 1+7 members", bench, K_GRID, "pivot_rest", 7)
    results["multi_pivot"] = scan_vs_plain("bench D=4", bench, K_GRID, "multi_pivot", 4)
    groups = random_members(rng, 4, 1 << 21)
    results["containment"] = scan_vs_plain("bench 8 queries + 4 groups", bench + groups,
                                           K_GRID, "containment", (8, 4))
    # the pivot repeats a 60-base block 3000 times: pivot counts of ~6000
    # per run, far above 511 (the TPU kernel's limit) and the cap of 255
    pivot = np.concatenate([bench[0], np.tile(bench[0][1000:1060], 3000)])
    results["buckets"] = scan_vs_plain("bench D=4 cap 255", [pivot] + bench[1:5], K_GRID,
                                       "buckets", (4, 255))
    wide_c = scan_vs_plain("63x2^15 containment 42+21", random_members(rng, 63, 1 << 15),
                           K_GRID, "containment", (42, 21), plain_reps=1)
    results["containment"]["max_abs_err"] = max(results["containment"]["max_abs_err"],
                                                 wide_c["max_abs_err"])
    del bench, groups, pivot
    print("scan time over its bound at the bench shape: " + ", ".join(
        f"{mode} {results[mode]['ms'] / results[mode]['bound_ms']:.1f}x"
        for mode in ("occ",) + MODES), flush=True)
    results.update(perk_kernels_vs_plain(rng, members96))
    results.update(vote_kernels_vs_plain(rng))
    return results


class Held:
    """Wraps kernel wrappers that the engine imported by name: times every
    call (CUDA events around it, read after the run's last synchronize)
    and, after the call's timed span, holds the calls `hold(kernel, k,
    nth)` picks against the plain version on the same inputs, exactly.  A
    call's k is its extraction's, or the last extraction's for the
    histogram that follows it (a sweep extraction's, its kmax); nth
    counts the kernel's earlier calls in the run.  `errors` gets each kernel's largest
    difference, `plain_s` the seconds the checks took; `peak()` is the
    run's peak device memory without the plain versions' own."""

    def __init__(self, specs, hold):
        self.specs = specs  # (module, name, kernel label, plain or None)
        self.hold = hold
        self.calls = []
        self.n_calls = {}
        self.errors = {}
        self.k = None
        self.peak_before = 0
        self.step_before = 0
        self.plain_s = 0.0

    def _wrap(self, orig, label, plain):
        def timed(*args):
            kernel = args[3] if label == "scan_classify" else label
            if label.startswith("A"):
                self.k = int(args[-1])
            elif label == "sweep":
                self.k = int(args[2])  # kmax
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*args)
            end.record()
            nth = self.n_calls.get(kernel, 0)
            self.n_calls[kernel] = nth + 1
            held = plain is not None and self.hold(kernel, self.k, nth)
            plain_s = 0.0
            if held:
                self.peak_before = max(self.peak_before, torch.cuda.max_memory_allocated())
                self.step_before = max(self.step_before, torch.cuda.max_memory_allocated())
                t0 = time.perf_counter()
                want = plain(*args)
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
                self.plain_s += plain_s
                err = max_err(out, want)
                first = want[0] if isinstance(want, tuple) else want
                empty = not first.any()
                # the check's tensors go before the peak restarts, so the
                # run's peak counts only what the run itself holds
                del want, first
                torch.cuda.reset_peak_memory_stats()
                self.errors[kernel] = max(self.errors.get(kernel, 0), err)
                if err or empty:
                    raise AssertionError(f"{kernel} call (k={self.k}): kernel != plain "
                                         f"(max_abs_err {err}) or empty result")
            n = args[0].shape[-1]
            bound = io_bound_ms(args, out)
            self.calls.append((kernel, n, self.k, bound, start, end, held, plain_s))
            return out
        return timed

    def __enter__(self):
        self.origs = []
        for module, name, label, plain in self.specs:
            orig = getattr(module, name)
            self.origs.append((module, name, orig))
            setattr(module, name, self._wrap(orig, label, plain))
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self.origs):
            setattr(module, name, orig)

    def peak(self):
        return max(self.peak_before, torch.cuda.max_memory_allocated())

    def step_start(self):
        """Restart the peak at what is allocated now (a new step)."""
        torch.cuda.reset_peak_memory_stats()
        self.step_before = 0

    def step_peak(self):
        return max(self.step_before, torch.cuda.max_memory_allocated())

    def report(self, per_call):
        """Each call (per_call) or, per kernel, calls, time and checks."""
        torch.cuda.synchronize()
        per = {}
        for kernel, n, k, bound, start, end, held, plain_s in self.calls:
            ms = start.elapsed_time(end)
            if kernel in per_call:
                print(f"  {kernel} call n={n}: {ms:.3f} ms (bound {bound:.3f} ms); "
                      f"{'equal to the plain version (%.2f s)' % plain_s if held else 'not held'}")
            s = per.setdefault(kernel, {"calls": 0, "ms": 0.0, "bound_ms": 0.0, "held": 0,
                                        "plain_s": 0.0, "n_max": 0})
            s["calls"] += 1
            s["ms"] += ms
            s["bound_ms"] += bound
            s["held"] += held
            s["plain_s"] += plain_s
            s["n_max"] = max(s["n_max"], n)
        for kernel, s in per.items():
            if kernel not in per_call:
                print(f"  {kernel}: {s['calls']} calls, {s['ms']:.2f} ms in all "
                      f"({s['ms'] / s['calls']:.3f} ms per call, n up to {s['n_max']}), "
                      f"bound {s['bound_ms']:.2f} ms; {s['held']} held, equal "
                      f"({s['plain_s']:.2f} s of plain)")
        return per


def kernel_specs(scan_plain):
    """The wrappers the engine calls, each with its plain version (the scan
    wrappers' only when scan_plain)."""
    from khoice_tpu_torch.classify import annotate
    from khoice_tpu_torch.dist import ksweep as dksweep
    from khoice_tpu_torch.dist import occurrence as doccurrence
    from khoice_tpu_torch.dist import vote as dvote
    from khoice_tpu_torch.engine import ksweep, ksweep_classify, occurrence, ops, streaming
    from khoice_tpu_torch.kernels import extract, ksweep_scan, occ_scan
    from khoice_tpu_torch.kernels import extract_sweep as kxs
    from khoice_tpu_torch.kernels import sort as ksort
    from khoice_tpu_torch.kernels import vote as kvote

    scan_occ = ksweep_scan.scan_multi_k_reference if scan_plain else None
    scan_cls = ksweep_scan.scan_classify_reference if scan_plain else None
    return [
        (ksweep, "scan_multi_k", "occ", scan_occ),
        (streaming, "scan_multi_k", "occ", scan_occ),
        (dksweep, "scan_multi_k", "occ", scan_occ),
        (ksweep_classify, "scan_classify", "scan_classify", scan_cls),
        (dksweep, "scan_classify", "scan_classify", scan_cls),
        (ksweep, "doubled_elements", "sweep", kxs.doubled_elements_reference),
        (dksweep, "_doubled_elements", "sweep", kxs.doubled_elements_reference),
        (streaming, "_extract_fwd_sweep", "sweep", kxs.extract_fwd_sweep_reference),
        (occurrence, "extract_packed", "A packed", extract.extract_packed_reference),
        (doccurrence, "extract_packed", "A packed", extract.extract_packed_reference),
        (occurrence, "extract_canonical", "A keys", extract.extract_canonical_reference),
        (doccurrence, "extract_canonical", "A keys", extract.extract_canonical_reference),
        (ops, "extract_canonical", "A keys", extract.extract_canonical_reference),
        (annotate, "extract_canonical", "A keys", extract.extract_canonical_reference),
        (dvote, "extract_canonical", "A keys", extract.extract_canonical_reference),
        (occurrence, "occ_hist_packed", "B", occ_scan.occ_hist_packed_reference),
        (doccurrence, "occ_hist_packed", "B", occ_scan.occ_hist_packed_reference),
        (occurrence, "occ_hist", "C", occ_scan.occ_hist_reference),
        (doccurrence, "occ_hist", "C", occ_scan.occ_hist_reference),
        (kvote, "vote_mask", "vote_mask", kvote.vote_mask_reference),
        (kvote, "read_votes", "read_votes", kvote.read_votes_reference),
    ] + [(module, "sort_words", "sort", ksort.sort_words_reference)
         for module in (ksweep, streaming, occurrence, ops, annotate, dksweep, doccurrence,
                        dvote)]


def reset_counts():
    from khoice_tpu_torch.kernels import extract, ksweep_scan, occ_scan
    from khoice_tpu_torch.kernels import extract_sweep as kxs
    from khoice_tpu_torch.kernels import sort as ksort
    from khoice_tpu_torch.kernels import vote as kvote

    for counts in (ksweep_scan.launches, extract.launches, occ_scan.launches, kvote.launches,
                   kxs.launches):
        for key in counts:
            counts[key] = 0
    ksort.launches = 0


def read_counts():
    """Launches per kernel: the scan's modes, A (extraction, both forms),
    B (packed histogram), C (unpacked histogram), the sort, the vote
    kernels and the sweep's extraction (both modes)."""
    from khoice_tpu_torch.kernels import extract, ksweep_scan, occ_scan
    from khoice_tpu_torch.kernels import extract_sweep as kxs
    from khoice_tpu_torch.kernels import sort as ksort
    from khoice_tpu_torch.kernels import vote as kvote

    counts = dict(ksweep_scan.launches)
    counts.update(kvote.launches)
    counts["A"] = extract.launches["keys"] + extract.launches["packed"]
    counts["B"] = occ_scan.launches["packed"]
    counts["C"] = occ_scan.launches["unpacked"]
    counts["sort"] = ksort.launches
    counts["sweep"] = kxs.launches["direct"] + kxs.launches["doubled"]
    return counts


def count_lines(path):
    with open(path) as fd:
        lines = fd.read().strip().splitlines()
    for line in lines[1:]:
        for field in line.split(",")[1:]:
            if not np.isfinite(float(field)):
                raise AssertionError(f"{path}: non-finite value in {line!r}")
    return len(lines)


class Estimates:
    """Each device-memory estimate that the engine checks against its
    budget during a run (`check_device_budget`, imported by name in five
    modules), with what the run held on the card at that check, and the
    peak of the step it starts (until the next check; the plain checks'
    memory excluded, as Held excludes it)."""

    def __init__(self, held):
        from khoice_tpu_torch.classify import annotate
        from khoice_tpu_torch.dist import ksweep as dksweep
        from khoice_tpu_torch.engine import ksweep_classify, session, streaming

        self.modules = (streaming, ksweep_classify, session, annotate, dksweep)
        self.held = held
        self.steps = [["before the first check", 0, 0]]  # [label, estimate, peak]

    def _close_step(self):
        self.steps[-1][2] = max(self.steps[-1][2], self.held.step_peak())
        self.held.peak_before = self.held.peak()
        self.held.step_start()

    def __enter__(self):
        self.orig = self.modules[0].check_device_budget

        def check(need_bytes, budget_bytes, label, device=None):
            self._close_step()
            self.steps.append([label, need_bytes + torch.cuda.memory_allocated(), 0])
            return self.orig(need_bytes, budget_bytes, label, device)

        for module in self.modules:
            module.check_device_budget = check
        return self

    def __exit__(self, *exc):
        self._close_step()
        for module in self.modules:
            module.check_device_budget = self.orig

    def largest(self):
        return max(est for _, est, _ in self.steps)

    def worst(self):
        """The step whose peak is furthest above (or least below) its
        estimate (the run's largest estimate for the part before the
        first check)."""
        first = [(self.steps[0][0], self.largest(), self.steps[0][2])]
        return max(first + [tuple(x) for x in self.steps[1:]], key=lambda x: x[2] - x[1])


def run_path(label, argv, hold, uses, expect_lines, scan_plain=True, per_call=None,
             incore=True):
    """Drive one main path through the CLI (argv), or through the entry
    point that `argv` is when it is a callable returning 0, with every
    count set to 0 just before it, its kernel calls timed and held against
    their plain versions; return the counts read just after, each kernel's
    largest difference, the per-kernel call summary and the run's wall and
    peak (checks excluded).  Every run sorts with the radix sort.  The
    calls of the kernels in per_call are printed one by one (by default
    the scan's, when they are held).  An in-core run's peak must stay
    within the largest estimate the engine checked (engine/streaming.py)."""
    from khoice_tpu_torch import cli

    run = argv if callable(argv) else (lambda: cli.main(argv))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Held(kernel_specs(scan_plain), hold) as held, Estimates(held) as est:
        reset_counts()
        t0 = time.perf_counter()
        rc = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    if rc != 0:
        raise AssertionError(f"{label} returned {rc}")
    for kernel in ["sort"] + list(uses):
        if counts[kernel] < 1:
            raise AssertionError(f"{label}: the {kernel} kernel was never launched")
    lines = {os.path.basename(p): count_lines(p) for p in expect_lines}
    for path, want in expect_lines.items():
        if lines[os.path.basename(path)] != want:
            raise AssertionError(f"{label}: {path} has {lines[os.path.basename(path)]} "
                                 f"lines, expected {want}")
    print(f"{label}: wall {wall - held.plain_s:.2f} s (and {held.plain_s:.2f} s of plain "
          f"checks), peak device memory {held.peak() / 2**30:.2f} GiB, launches "
          f"{ {k: v for k, v in counts.items() if v} }, lines {lines}", flush=True)
    if incore:
        if len(est.steps) < 2:
            raise AssertionError(f"{label}: the engine checked no estimate against its budget")
        step, step_est, step_peak = est.worst()
        print(f"  estimated peak {est.largest() / 2**30:.3f} GiB, measured {held.peak() / 2**30:.3f} "
              f"GiB: the estimate is {est.largest() / held.peak():.3f}x the peak; "
              f"{len(est.steps) - 1} checked steps, the weakest {step!r}: estimate "
              f"{step_est / 2**30:.3f} GiB (with what the run held), peak "
              f"{step_peak / 2**30:.3f} GiB", flush=True)
        loose = max(est.steps[1:], key=lambda x: x[1] / max(x[2], 1))
        print(f"  the loosest checked step {loose[0]!r}: estimate {loose[1] / 2**30:.3f} GiB, "
              f"{loose[1] / max(loose[2], 1):.3f}x its peak {loose[2] / 2**30:.3f} GiB",
              flush=True)
        if held.peak() > est.largest():
            raise AssertionError(f"{label}: peak {held.peak()} B over the estimate "
                                 f"{est.largest()} B")
        over = [step for step in est.steps[1:] if step[2] > step[1]]
        if over:
            raise AssertionError(f"{label}: checked steps over their own estimates "
                                 f"(label, estimate B, peak B): {over}")
    if per_call is None:
        per_call = ("occ",) + MODES if scan_plain else ()
    per = held.report(per_call)
    return counts, held.errors, per, {"wall": wall - held.plain_s, "peak": held.peak()}


def gen_db(tmp, name, datasets, genomes, mbp):
    db = os.path.join(tmp, name)
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "gen_realistic_db.py"), db,
         "--datasets", str(datasets), "--genomes", str(genomes), "--mbp", str(mbp),
         "--seed", "7"],
        check=True, capture_output=True,
    )
    print(f"database {datasets} x {genomes} x {mbp} Mbp generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return db


def merge(errors, into):
    for kernel, err in errors.items():
        into[kernel] = max(into.get(kernel, 0), err)


def hold_sorts_and(hold):
    """hold(kernel, k, nth) that holds the first SORT_HOLDS sorts of a run
    and, for the other kernels, the calls `hold(kernel, k)` picks."""
    return lambda kernel, k, nth: nth < SORT_HOLDS if kernel == "sort" else hold(kernel, k)


def hold_votes(kernel, k, nth):
    """exp6's runs: the first SORT_HOLDS sorts and every vote_mask and
    read_votes call at HOLD_KS."""
    return nth < SORT_HOLDS if kernel == "sort" else (
        kernel in ("vote_mask", "read_votes") and k in HOLD_KS)


def exp6_run(label, db, work, n_datasets, extra=()):
    """`run --exp-type 6` (exp0 already in the work root): both read
    types' trial CSVs have a line per (k, dataset) under the header, and
    every per-k file one line per dataset.  Returns run_path's counts,
    errors and wall and peak."""
    from khoice_tpu_torch.pipelines.exp6 import READ_TYPE_LABEL

    g = len(K_GRID)
    c, e, _, stats = run_path(
        label, ["run", "--exp-type", "6", "--database-root", db, "--work-root", work,
                "--kmers-per-dataset", "2000000", *extra],
        hold_votes, ["A", "vote_mask", "read_votes"],
        {os.path.join(work, f"trial_1_{lab}_acc.csv"): 1 + g * n_datasets
         for lab in READ_TYPE_LABEL.values()})
    n_files = 0
    for rt in READ_TYPE_LABEL:
        acc = os.path.join(work, "accuracies_type_6", rt)
        for k in K_GRID:
            for rel in (f"confusion_matrix/k_{k}_confusion_matrix.txt",
                        f"confusion_matrix/k_{k}_confusion_matrix_with_unidentified.txt",
                        f"values/k_{k}_accuracy_values.csv"):
                with open(os.path.join(acc, rel)) as fd:
                    if len(fd.read().strip().splitlines()) != n_datasets:
                        raise AssertionError(f"{label}: {rt}/{rel} has no line per dataset")
                n_files += 1
    print(f"{label}: {n_files} per-k files of a line per dataset; held against their plain "
          f"versions: every vote_mask and read_votes call at k in {HOLD_KS}, the first "
          f"{SORT_HOLDS} sorts of the run, all equal", flush=True)
    return c, e, stats


def main_paths(tmp):
    phase("4a main paths on 4 x 8 x 2 Mbp: run --exp-type 1, 2, 3, 4; 3 and 4 per-k; 6")
    db = gen_db(tmp, "db", 4, 8, 2.0)
    g = len(K_GRID)
    every = hold_sorts_and(lambda kernel, k: True)
    launches, errors, sorts = {}, {}, {}
    work1 = os.path.join(tmp, "work1")
    c, e, _, _ = run_path("exp1, 30 ks", ["run", "--exp-type", "1", "--database-root", db,
                                          "--work-root", work1], every, ["occ", "sweep"], {
        os.path.join(work1, "step_5/within_datasets_analysis.csv"): 1 + 4 * g,
        os.path.join(work1, "step_9/across_datasets_analysis.csv"): 1 + g})
    launches["occ"], launches["sweep"] = c["occ"], c["sweep"]
    sorts["exp1 on 4 x 8 x 2 Mbp"] = c["sort"]
    merge(e, errors)
    work = os.path.join(tmp, "work")
    common = ["--database-root", db, "--work-root", work, "--kmers-per-dataset", "2000000"]
    c, e, _, _ = run_path("exp2 (with exp0), 30 ks", ["run", "--exp-type", "2", *common], every,
                          ["pivot_rest", "multi_pivot", "sweep"], {
        os.path.join(work, "within_dataset_analysis_type_2/within_dataset_analysis.csv"): 1 + 4 * g,
        os.path.join(work, "across_dataset_analysis_type_2/across_dataset_analysis.csv"): 1 + 4 * g})
    launches["pivot_rest"], launches["multi_pivot"] = c["pivot_rest"], c["multi_pivot"]
    launches["sweep"] += c["sweep"]
    sorts["exp2 on 4 x 8"] = c["sort"]
    merge(e, errors)
    # the 30-k CSVs, before the per-k runs below rewrite exp3's and exp4's
    csv30 = {}

    def keep_csvs(exp_type):
        for rel in CSVS[exp_type]:
            with open(os.path.join(work, rel), "rb") as fd:
                csv30[rel] = fd.read()

    keep_csvs(2)
    c, e, _, _ = run_path("exp3, 30 ks", ["run", "--exp-type", "3", *common], every,
                          ["containment", "sweep"], {
        os.path.join(work, "final_analysis_type3/final_analysis_type3.csv"): 1 + 2 * 4 * g * 4})
    launches["containment"] = c["containment"]
    launches["sweep"] += c["sweep"]
    sorts["exp3 on 4 x 8"] = c["sort"]
    merge(e, errors)
    keep_csvs(3)
    c, e, _, _ = run_path("exp4, 30 ks", ["run", "--exp-type", "4", *common], every, ["buckets", "sweep"], {
        os.path.join(work, "accuracies_type_4/accuracy_values.csv"): 4 * g})
    launches["buckets"] = c["buckets"]
    launches["sweep"] += c["sweep"]
    sorts["exp4 on 4 x 8"] = c["sort"]
    merge(e, errors)
    keep_csvs(4)
    # the per-k table ops: a 2-k grid leaves every k to them
    perk = ["--force", "--k-values", "21,31"]
    c, e, _, _ = run_path("exp3 per-k (ks 21,31)", ["run", "--exp-type", "3", *common, *perk],
                          every, ["A"], {
        os.path.join(work, "final_analysis_type3/final_analysis_type3.csv"): 1 + 2 * 4 * 2 * 4})
    sorts["exp3 per-k on 4 x 8"] = c["sort"]
    merge(e, errors)
    c, e, _, _ = run_path("exp4 per-k (ks 21,31)", ["run", "--exp-type", "4", *common, *perk],
                          every, ["A"], {
        os.path.join(work, "accuracies_type_4/accuracy_values.csv"): 4 * 2})
    sorts["exp4 per-k on 4 x 8"] = c["sort"]
    merge(e, errors)
    c, e, _ = exp6_run("exp6, 30 ks", db, work, 4)
    sorts["exp6 on 4 x 8"] = c["sort"]
    merge(e, errors)
    return launches, errors, sorts, db, work1, work, csv30


def large_group_paths(tmp):
    phase("4b main path on 2 x 96 x 1 Mbp (groups over the 64-member mask): "
          "run --exp-type 1, 2, 6")
    db = gen_db(tmp, "db96", 2, 96, 1.0)
    g = len(K_GRID)
    at_hold_ks = hold_sorts_and(lambda kernel, k: kernel == "sweep" or k in HOLD_KS)
    launches, errors, per, sorts = {}, {}, {}, {}
    work1 = os.path.join(tmp, "work96_1")
    c, e, per["exp1"], _ = run_path(
        "exp1 on 2 x 96 x 1 Mbp, 30 ks", ["run", "--exp-type", "1", "--database-root", db,
                                          "--work-root", work1],
        at_hold_ks, ["A", "B", "occ", "sweep"], {
            os.path.join(work1, "step_5/within_datasets_analysis.csv"): 1 + 2 * g,
            os.path.join(work1, "step_9/across_datasets_analysis.csv"): 1 + g},
        scan_plain=False)
    launches["A"], launches["B"], launches["sweep"] = c["A"], c["B"], c["sweep"]
    sorts["exp1 on 2 x 96 x 1 Mbp"] = c["sort"]
    merge(e, errors)
    work2 = os.path.join(tmp, "work96_2")
    c, e, per["exp2"], _ = run_path(
        "exp2 (with exp0) on 2 x 96 x 1 Mbp, 30 ks",
        ["run", "--exp-type", "2", "--database-root", db, "--work-root", work2,
         "--kmers-per-dataset", "2000000"],
        at_hold_ks, ["A", "multi_pivot", "sweep"], {
            os.path.join(work2, "within_dataset_analysis_type_2/within_dataset_analysis.csv"): 1 + 2 * g,
            os.path.join(work2, "across_dataset_analysis_type_2/across_dataset_analysis.csv"): 1 + 2 * g},
        scan_plain=False)
    sorts["exp2 on 2 x 96"] = c["sort"]
    launches["sweep"] += c["sweep"]
    merge(e, errors)
    # the group texts, ~192M positions per k, against the pivots' reads
    c, e, _ = exp6_run("exp6 on 2 x 96 x 1 Mbp, 30 ks", db, work2, 2)
    launches["vote_mask"], launches["read_votes"] = c["vote_mask"], c["read_votes"]
    sorts["exp6 on 2 x 96"] = c["sort"]
    merge(e, errors)
    held = {kernel: per["exp1"].get(kernel, {}).get("held", 0) + per["exp2"].get(kernel, {}).get("held", 0)
            for kernel in ("A packed", "A keys", "B", "sort", "sweep")}
    print(f"held against their plain versions (A and B at k in {HOLD_KS}, every sweep "
          f"extraction, the first {SORT_HOLDS} sorts of each run): {held} calls, all equal")
    return launches, errors, sorts, db, work1


def streaming_paths(tmp, runs):
    """exp1 under device budgets below its in-core need: `runs` is
    [(label, database, budget GiB, n_groups, in-core work root, kernels
    the run uses)].  Each run's first STREAM_HOLDS chunk sorts, its first
    key-range group's sort and that group's raw scan are held against
    their plain versions, and so are its first STREAM_HOLDS chunk
    extractions.  Returns each kernel's largest difference and each
    run's sort and sweep-extraction launches."""
    phase("4c the streaming sweep: run --exp-type 1 under a device budget below the "
          "in-core need")
    import logging

    from khoice_tpu_torch.engine import streaming
    from khoice_tpu_torch.utils.logging import get_logger

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(f"{record.name} {record.levelname} {record.getMessage()}")

    # which of the stream's steps a kernel call is in: its name and how
    # many calls of it the run has made
    site = {"chunk": 0, "group": 0, "in": None}

    def step(name, fn):
        def call(*args):
            site[name] += 1
            site["in"] = name
            try:
                return fn(*args)
            finally:
                site["in"] = None
        return call

    def hold(kernel, k, nth):
        if site["in"] == "chunk":
            return kernel in ("sort", "sweep") and site["chunk"] <= STREAM_HOLDS
        return site["in"] == "group" and site["group"] == 1

    keep = Keep()
    loggers = [get_logger("khoice.streaming"), get_logger("khoice.exp1")]
    for logger in loggers:
        logger.addHandler(keep)
    steps = [(name, getattr(streaming, name)) for name in ("_chunk_step", "_group_scan")]
    for name, fn in steps:
        setattr(streaming, name, step(name.split("_")[1], fn))
    g = len(K_GRID)
    errors, sorts, sweeps = {}, {}, {}
    csvs = ("step_5/within_datasets_analysis.csv", "step_9/across_datasets_analysis.csv")
    try:
        for label, db, gib, n_groups, incore, uses in runs:
            work = os.path.join(tmp, f"stream_{gib}gib")
            del lines[:]
            site.update(chunk=0, group=0)
            c, e, per, stats = run_path(
                f"exp1 streamed on {label}, --device-budget-gb {gib}",
                ["run", "--exp-type", "1", "--database-root", db, "--work-root", work,
                 "--device-budget-gb", str(gib), "--force"], hold, ["occ", "sweep"] + uses,
                {os.path.join(work, csvs[0]): 1 + n_groups * g, os.path.join(work, csvs[1]): 1 + g},
                per_call=(), incore=False)
            sorts[f"exp1 streamed on {label}"] = c["sort"]
            sweeps[label] = c["sweep"]
            merge(e, errors)
            held = (per["sort"]["held"], per["occ"]["held"], per["sweep"]["held"])
            if held != (STREAM_HOLDS + 1, 1, STREAM_HOLDS):
                raise AssertionError(f"{label}: held {held} sorts, scans and sweep "
                                     f"extractions, expected {STREAM_HOLDS + 1}, 1 and "
                                     f"{STREAM_HOLDS}")
            print(f"held against their plain versions: the first {STREAM_HOLDS} chunk "
                  "extractions and sorts, the first key-range group's sort and its raw scan, "
                  "all equal")
            streamed = [line for line in lines if "streaming" in line]
            if not any("streaming class" in line and "done" in line for line in streamed):
                raise AssertionError(f"{label}: exp1 did not stream under {gib} GiB")
            for line in streamed:
                print(f"  log: {line}")
            for rel in csvs:
                with open(os.path.join(work, rel), "rb") as fd, \
                        open(os.path.join(incore, rel), "rb") as ref:
                    if fd.read() != ref.read():
                        raise AssertionError(f"{label}: streamed {rel} differs from the in-core run's")
            if stats["peak"] > gib * 2**30:
                raise AssertionError(f"{label}: peak {stats['peak'] / 2**30:.2f} GiB over the "
                                     f"{gib} GiB budget")
            print(f"exp1 streamed on {label}: step_5 and step_9 bytes equal the in-core run's; "
                  f"wall {stats['wall']:.2f} s, peak device memory {stats['peak'] / 2**30:.2f} "
                  f"GiB within the {gib} GiB budget", flush=True)
    finally:
        for name, fn in steps:
            setattr(streaming, name, fn)
        for logger in loggers:
            logger.removeHandler(keep)
    return errors, sorts, sweeps


def table_op_path(tmp, db, work1):
    """4d-i: exp1's table ops (`run_exp1(..., fused=False)`) on 4a's
    database over the 30-point grid: a canonical count of every genome at
    every k and the within- and across-group unions.  Every sort and every
    kernel-A call is held against its plain version; the CSVs must equal
    4a's fused run's (work1).  Returns the counts and each kernel's
    largest difference."""
    phase("4d-i exp1's table ops on 4 x 8 x 2 Mbp: run_exp1(..., fused=False), 30 ks")
    from khoice_tpu_torch.pipelines.exp0 import load_database_dir
    from khoice_tpu_torch.pipelines.exp1 import run_exp1

    g = len(K_GRID)
    work = os.path.join(tmp, "work_ops")

    def drive():
        loaded = load_database_dir(db)
        groups = {num: [loaded[num][name] for name in sorted(loaded[num])] for num in loaded}
        run_exp1(groups, K_GRID, work, "cuda", fused=False)
        return 0

    csvs = ("step_5/within_datasets_analysis.csv", "step_9/across_datasets_analysis.csv")
    c, e, per, stats = run_path(
        "exp1 table ops (fused=False), 30 ks", drive, lambda kernel, k, nth: True, ["A"],
        {os.path.join(work, csvs[0]): 1 + 4 * g, os.path.join(work, csvs[1]): 1 + g},
        per_call=())
    counts, unions = 4 * 8 * g, 5 * g
    if c["A"] != counts or c["sort"] != counts + unions:
        raise AssertionError(f"table ops: {c['A']} A and {c['sort']} sort launches, expected "
                             f"{counts} and {counts + unions}")
    held = {kernel: per[kernel]["held"] for kernel in ("A keys", "sort")}
    if held != {"A keys": counts, "sort": counts + unions}:
        raise AssertionError(f"table ops: held {held}")
    for rel in csvs:
        with open(os.path.join(work, rel), "rb") as fd, open(os.path.join(work1, rel), "rb") as ref:
            if fd.read() != ref.read():
                raise AssertionError(f"table ops: {rel} differs from the fused run's")
    print(f"exp1 table ops: step_5 and step_9 bytes equal the fused run's; {counts} counts "
          f"and {unions} unions, every A call and every sort held against its plain "
          f"version ({held}), all equal; wall {stats['wall']:.2f} s, peak device memory "
          f"{stats['peak'] / 2**30:.2f} GiB, launches A {c['A']}, sort {c['sort']} "
          f"({smi_line()})", flush=True)
    return c, e


MEM_READS = 100  # exp8's reads per read type and dataset (NUM_READS_PER_DATASET)


def mem_paths(tmp):
    """4d-ii: `run --exp-type 5`, 7 and 8 through the CLI on a reduced
    database.  They run on the host, as the JAX package's do: no kernel
    may launch, and the native MS engine must have loaded.  Every output
    matrix has a line per dataset of finite values."""
    phase("4d-ii the MEM experiments on 2 x 4 x 0.05 Mbp: run --exp-type 5, 7, 8")
    from khoice_tpu_torch import cli
    from khoice_tpu_torch.config import default_t_values
    from khoice_tpu_torch.mems import ms

    db = gen_db(tmp, "db_mem", 2, 4, 0.05)
    work = os.path.join(tmp, "work_mem")
    config = os.path.join(tmp, "mem.yaml")
    with open(config, "w") as fd:
        fd.write(f"NUM_READS_PER_DATASET: {MEM_READS}\n")
    print(f"cuts: 2 datasets x 4 genomes x 0.05 Mbp (a host suffix array per pass), exp0 "
          f"with --kmers-per-dataset 20000 (exp7's reads), exp8 with {MEM_READS} reads per "
          "read type and dataset; the threshold grid and both mem types and read types in full")
    common = ["--database-root", db, "--work-root", work, "--kmers-per-dataset", "20000",
              "--config", config]
    mts, rts = ("mems", "half_mems"), ("illumina", "ont")
    outputs = {
        5: [f"output_type_5/{mt}/confusion_matrix.csv" for mt in mts],
        7: [f"final_output_type_7/trial_1_{mt}_{rt}.csv" for mt in mts for rt in rts]
        + [f"output_type_7/{mt}/{rt}/confusion_matrix.csv" for mt in mts for rt in rts],
        8: [f"output_type_8/{mt}/t_{t}/{rt}/confusion_matrix.csv"
            for mt in mts for t in default_t_values() for rt in rts],
    }
    walls = {}
    for et in (0, 5, 7, 8):
        reset_counts()
        t0 = time.perf_counter()
        if cli.main(["run", "--exp-type", str(et), *common]) != 0:
            raise AssertionError(f"exp{et} failed")
        walls[f"exp{et}"] = time.perf_counter() - t0
        launched = {k: v for k, v in read_counts().items() if v}
        if launched:
            raise AssertionError(f"exp{et} launched kernels on the host path: {launched}")
        for rel in outputs.get(et, []):
            with open(os.path.join(work, rel)) as fd:
                rows = [line.split(",") for line in fd.read().strip().splitlines()]
            if len(rows) != 2 or not all(np.isfinite(float(x)) for row in rows for x in row):
                raise AssertionError(f"exp{et}: {rel} is not 2 rows of finite values: {rows}")
    if ms._LIB is None:
        raise AssertionError("the native MS engine did not load")
    print(f"MEM experiments: {sum(len(v) for v in outputs.values())} matrices and trial CSVs "
          f"of 2 finite rows (exp5 {len(outputs[5])}, exp7 {len(outputs[7])}, exp8 "
          f"{len(outputs[8])}), no kernel launched, native MS engine {ms._LIB._name}; walls "
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()) + f" ({smi_line()})", flush=True)


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


def small_genomes(rng, n_groups, per_group, base_len=3000, extra=300):
    def dna(n):
        return "".join("ACGT"[rng.randrange(4)] for _ in range(n))

    base = dna(base_len)
    groups = {}
    for num in range(1, n_groups + 1):
        genomes = []
        for i in range(per_group):
            seq = list(base)
            for _ in range((150 + 40 * num) * base_len // 3000):
                seq[rng.randrange(len(seq))] = "ACGT"[rng.randrange(4)]
            p = rng.randrange(len(seq) - 100)
            n_run = (30 + 10 * i) % 90
            seq[p:p + n_run] = "N" * n_run
            genomes.append(["".join(seq), dna(extra)])
        groups[num] = genomes
    return groups


def check_exp1_hists(groups, ks, out, cx=10000):
    for k in ks:
        group_sets = []
        for num in sorted(groups):
            sets = [canonical_kmers(genome, k) for genome in groups[num]]
            got = read_hist(os.path.join(
                out, f"step_4/k_{k}/dataset_{num}/dataset_{num}_k{k}_hist.txt"))
            if got != presence_histogram(sets, cx):
                raise AssertionError(f"{out}: step_4 k={k} group {num}: histogram differs")
            group_sets.append(set().union(*sets))
        got = read_hist(os.path.join(out, f"step_8/k_{k}/all_datasets_k{k}_hist.txt"))
        if got != presence_histogram(group_sets, cx):
            raise AssertionError(f"{out}: step_8 k={k}: histogram differs")


def small_world_exp1(tmp):
    phase("5a small worlds: exp1 vs a dict-based counter")
    from khoice_tpu_torch.pipelines.exp1 import run_exp1

    groups = small_genomes(random.Random(1234), 2, 3)
    ks = [5, 12, 21, 31, 33, 45, 49]
    out = os.path.join(tmp, "small")
    run_exp1(groups, ks, out, "cuda")
    check_exp1_hists(groups, ks, out)
    print(f"step_4 and step_8 histograms equal the dict-based counter's "
          f"(2 groups x 3 genomes, ks {ks})")
    # groups of 70 and 300 genomes: the per-k path, packed and unpacked
    rng = random.Random(4321)
    big = small_genomes(rng, 2, 300, base_len=400, extra=40)
    big[1] = big[1][:70]
    for ks in ([21, 31], [5, 12, 21, 31, 33, 45, 61]):
        out = os.path.join(tmp, f"small_big_{len(ks)}")
        # every call timed, C's held against its plain version
        with Held(kernel_specs(False), lambda kernel, k, nth: kernel == "C") as held:
            reset_counts()
            run_exp1(big, ks, out, "cuda")
            torch.cuda.synchronize()
            counts = read_counts()
        c_calls = held.report(per_call=("C",))["C"]
        for kernel in ("A", "B", "C"):
            if counts[kernel] < 1:
                raise AssertionError(f"70 + 300 genomes, ks {ks}: the {kernel} kernel "
                                     "was never launched")
        check_exp1_hists(big, ks, out)
        print(f"step_4 and step_8 histograms equal the dict-based counter's (groups of 70 "
              f"and 300 genomes, ks {ks}); launches A {counts['A']}, B {counts['B']}, "
              f"C {counts['C']}, occ {counts['occ']}", flush=True)
    # C's record reports the last run alone, counted from 0 just before it
    print(f"kernel C's launches in the kernels line: run_exp1 on groups of 70 and 300 "
          f"genomes, ks {ks}: {counts['C']}; its calls {c_calls['ms']:.3f} ms in all, bound "
          f"{c_calls['bound_ms']:.3f} ms, {c_calls['held']} held, equal", flush=True)
    return counts["C"], held.errors.get("C", 0)


def small_world_classify():
    phase("5b small world: the four classification sweeps and exp6's votes vs a dict-based "
          "counter")
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
    small_world_votes(rng, group_recs, kset)


def small_world_votes(rng, group_recs, kset):
    """exp6's votes (classify/annotate.py::read_votes_bulk_multi on the
    card) for reads drawn from D = 3 groups, random reads and reads with
    an N, against a dict-based voter: votes, unmatched and n_kmers per
    read."""
    from khoice_tpu_torch.classify import annotate
    from khoice_tpu_torch.io.packing import encode_records as enc
    from khoice_tpu_torch.pipelines.exp6 import reads_matrix

    def dna(n):
        return "".join("ACGT"[rng.randrange(4)] for _ in range(n))

    reads = [rec[i:i + rng.randrange(60, 200)] for recs in group_recs for rec in recs[:2]
             for i in range(0, len(rec) - 200, 157)]
    reads += [dna(150) for _ in range(5)] + [reads[0][:70] + "N" + reads[0][71:]]
    D, lcm = 3, 6
    group = annotate.pack_group_texts([enc(g) for g in group_recs], "cuda")
    big, spans = annotate.concat_flat_reads(
        [annotate.flat_reads_device(reads_matrix(reads), "cuda")])
    for k in (7, 21, 33, 49):
        votes, unmatched, n_kmers = annotate.read_votes_bulk_multi(group, big, spans, k, D)[0]
        sets = [kset(g, k) for g in group_recs]
        for r, read in enumerate(reads):
            v, u, nk = [0] * D, 0, 0
            for i in range(len(read) - k + 1):
                x = read[i:i + k]
                if "N" in x:
                    continue
                x = min(x, x.translate(_COMP)[::-1])
                hits = [d for d in range(D) if x in sets[d]]
                for d in hits:
                    v[d] += lcm // len(hits)
                u += not hits
                nk += 1
            if votes[r].tolist() != v or unmatched[r] != u or n_kmers[r] != nk:
                raise AssertionError(f"exp6 votes k={k} read {r}: {votes[r].tolist()}, "
                                     f"{unmatched[r]}, {n_kmers[r]} != {v}, {u}, {nk}")
        if not (votes.any() and unmatched.any()):
            raise AssertionError(f"exp6 votes k={k}: nothing matched or nothing unmatched")
    print(f"exp6's votes, unmatched and n_kmers equal the dict-based voter's ({len(reads)} "
          f"reads, D = {D}, ks 7, 21, 33, 49)")


def small_world_tables():
    phase("5c small world: the table ops vs a dict-based counter")
    from khoice_tpu_torch.engine.session import KmerEngine
    from khoice_tpu_torch.io.packing import encode_records as enc

    groups = small_genomes(random.Random(7), 1, 4)
    genomes = groups[1]
    genomes[0] = genomes[0] + [genomes[0][0][500:560] * 8]  # counts above the cap
    eng = KmerEngine("cuda")
    cs, ucs = 5, 3
    for k in (11, 31, 45):
        raw = [canonical_counts(g, k) for g in genomes]

        def as_dict(t):
            return dict(t.dump())

        a = eng.count_codes(enc(genomes[0]), k, cs=cs)
        want_a = {x: min(c, cs) for x, c in raw[0].items()}
        if as_dict(a) != want_a:
            raise AssertionError(f"count_codes k={k} differs")
        sets = [eng.set_counts(eng.count_codes(enc(g), k), 1) for g in genomes[1:]]
        u = eng.union(sets + [a], cs=ucs)
        want_u = dict(want_a)
        for r in raw[1:]:
            for x in r:
                want_u[x] = want_u.get(x, 0) + 1
        want_u = {x: min(c, ucs) for x, c in want_u.items()}
        if as_dict(u) != want_u:
            raise AssertionError(f"union k={k} differs")
        inter = as_dict(eng.intersect_sum(a, sets[0]))
        if inter != {x: min(c + 1, 255) for x, c in want_a.items() if x in raw[1]}:
            raise AssertionError(f"intersect_sum k={k} differs")
        sub = as_dict(eng.subtract(a, sets[0]))
        if sub != {x: c for x, c in want_a.items() if x not in raw[1]}:
            raise AssertionError(f"subtract k={k} differs")
        hist = eng.histogram(u, cx=10)
        if hist != [sum(1 for c in want_u.values() if c == i) for i in range(1, 11)]:
            raise AssertionError(f"histogram k={k} differs")
        if not (inter and sub and max(want_a.values()) == cs):
            raise AssertionError(f"k={k}: an empty or unsaturated case, nothing compared")
    print("count_codes, union, intersect_sum, subtract and histogram equal the dict-based "
          "counter's (ks 11, 31, 45)")


def nccl_group(tmp):
    """A key-range group of one rank on NCCL, cuda:0, its default process
    group made in this process from a FileStore (the card is the
    machine's only one: NCCL takes one rank per card)."""
    import torch.distributed as dist

    from khoice_tpu_torch.dist.mesh import init_kv_group

    store = dist.FileStore(os.path.join(tmp, "nccl_store"), 1)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    group = init_kv_group("cuda", world_size=1)
    # NCCL makes its communicator at the first collective; 6a's wall is
    # to be the sweep's, so that one runs here
    dist.all_reduce(torch.zeros(1, device=group.device))
    torch.cuda.synchronize()
    print(f"NCCL group of one rank ready in {time.perf_counter() - t0:.2f} s (init and the "
          "first collective, outside 6a's wall)", flush=True)
    return group


def gloo_cuda_probe_rank():
    """Rank program of a two-rank gloo group with both ranks on cuda:0:
    the port's exchange (uneven shares, one of them empty), gather and sum
    on CUDA tensors.  Returns what this rank received."""
    import torch.distributed as dist

    from khoice_tpu_torch.dist.mesh import (KvGroup, all_sum, exchange_counts, exchange_rows,
                                            gather_rows)

    rank = dist.get_rank()
    g = KvGroup(rank=rank, world_size=2, device=torch.device("cuda", 0))
    shares = [3, 0] if rank == 0 else [2, 5]
    rows = torch.arange(sum(shares) * 3, dtype=torch.int64, device=g.device).view(-1, 3)
    rows += 100 * rank
    recv = exchange_rows(rows, shares, exchange_counts(shares, g))
    gathered = [t.cpu().tolist() for t in gather_rows(rows[:rank + 1], g)]
    total = all_sum(torch.tensor([rank + 1], dtype=torch.int64, device=g.device))
    return recv.cpu().tolist(), gathered, int(total.item())


def sharded_sweep_rank(db):
    """6d's rank program (one of two gloo ranks, both on cuda:0): exp1's
    sharded sweep of 4a's group 1 over the 30 ks, every kernel call held
    against its plain version.  Returns (histograms, launches, each
    kernel's largest difference, wall)."""
    import torch.distributed as dist

    from khoice_tpu_torch.dist.ksweep import sharded_occurrence_histograms_sweep
    from khoice_tpu_torch.dist.mesh import KvGroup
    from khoice_tpu_torch.io.packing import encode_records
    from khoice_tpu_torch.pipelines.exp0 import load_database_dir

    group = KvGroup(rank=dist.get_rank(), world_size=dist.get_world_size(),
                    device=torch.device("cuda", 0))
    loaded = load_database_dir(db)
    codes = [encode_records(loaded[1][n]) for n in sorted(loaded[1])]
    with Held(kernel_specs(True), lambda kernel, k, nth: True) as held:
        reset_counts()
        t0 = time.perf_counter()
        hists = sharded_occurrence_histograms_sweep(group, codes, K_GRID)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - held.plain_s
        counts = read_counts()
    return hists, counts, held.errors, wall


def two_ranks_one_card(db, out1):
    """6d: exp1's sharded sweep of 4a's group 1 over the 30 ks on two gloo
    ranks (dist/launch.py::run_ranks), both on cuda:0 (gloo takes CUDA
    tensors; NCCL takes one rank per card); every rank's histograms must
    equal 6a's step_4 files for that group.  Returns the launches summed
    over the ranks and each kernel's largest difference."""
    from khoice_tpu_torch.dist.launch import run_ranks

    torch.cuda.empty_cache()  # the ranks' processes need the card this one has cached
    t0 = time.perf_counter()
    ranks = run_ranks(2, sharded_sweep_rank, (db,), backend="gloo", timeout_s=300)
    launches, errors = {}, {}
    for rank, (hists, counts, errs, wall) in enumerate(ranks):
        for k in K_GRID:
            want = read_hist(os.path.join(out1, f"step_4/k_{k}/dataset_1/dataset_1_k{k}_hist.txt"))
            if hists[k] != want:
                raise AssertionError(f"6d rank {rank} k={k}: histogram differs from 6a's")
        for kernel, n in counts.items():
            launches[kernel] = launches.get(kernel, 0) + n
        merge(errs, errors)
        print(f"6d rank {rank}: sweep wall {wall:.2f} s (plain checks excluded), launches "
              f"{ {k: v for k, v in counts.items() if v} }, every kernel call held, equal",
              flush=True)
    for kernel in ("occ", "sort", "sweep"):
        if any(counts[kernel] < 1 for _, counts, _, _ in ranks):
            raise AssertionError(f"6d: a rank never launched the {kernel} kernel")
    print(f"6d: two gloo ranks on cuda:0, exp1's sharded sweep of group 1 (8 x 2 Mbp, 30 ks): "
          f"every rank's histograms equal 6a's; {time.perf_counter() - t0:.1f} s with the "
          f"ranks' start ({smi_line()})", flush=True)
    return launches, errors


def read_bytes(path):
    with open(path, "rb") as fd:
        return fd.read()


def same_bytes(label, pairs):
    """Raise unless every (path, bytes) pair is equal."""
    for path, want in pairs:
        if read_bytes(path) != want:
            raise AssertionError(f"{label}: {path} differs from the single-device run's")


def sharded_paths(tmp, db, work1, work, csv30, db96):
    """6: the key-range SPMD path (khoice_tpu_torch/dist/) over a one-rank
    NCCL group, whose exchange, gathers and sums still run: exp1 (6a) and
    exp2/3/4 (6b) on 4a's database through the pipeline entries with the
    group, their CSVs byte-equal to 4a's; the sharded tables and per-k
    occurrence histograms (6c) equal to the single-device engine's.
    Every kernel call of 6a and 6c and every scan call of 6b is held
    against its plain version (6b: the first SORT_HOLDS sorts of a run).
    Then 6d: the sharded sweep on two gloo ranks on the one card.
    Returns each kernel's launches summed over the runs, each kernel's
    largest difference and each run's wall and peak."""
    phase("6 the key-range SPMD path: a one-rank NCCL group on cuda:0")
    import torch.distributed as dist

    from khoice_tpu_torch import cli
    from khoice_tpu_torch.config import KhoiceConfig
    from khoice_tpu_torch.pipelines.exp0 import load_database_dir
    from khoice_tpu_torch.pipelines.exp1 import run_exp1
    from khoice_tpu_torch.pipelines.exp2 import run_exp2
    from khoice_tpu_torch.pipelines.exp3 import run_exp3, simulate_exp3_reads
    from khoice_tpu_torch.pipelines.exp4 import run_exp4

    g = len(K_GRID)
    group = nccl_group(tmp)
    launches, errors, stats = {}, {}, {}

    def add(label, c, e, st):
        for kernel, n in c.items():
            launches[kernel] = launches.get(kernel, 0) + n
        merge(e, errors)
        stats[label] = st
        print(f"  ({smi_line()})", flush=True)

    try:
        # 6a: exp1 at full width, every kernel call held
        out1 = os.path.join(tmp, "sharded_exp1")

        def exp1():
            loaded = load_database_dir(db)
            groups = {num: [loaded[num][n] for n in sorted(loaded[num])] for num in loaded}
            run_exp1(groups, K_GRID, out1, "cuda", group=group)
            return 0

        c, e, _, st = run_path(
            "6a exp1 sharded (1 rank, NCCL), 30 ks", exp1, lambda kernel, k, nth: True,
            ["occ", "sweep"],
            {os.path.join(out1, CSVS[1][0]): 1 + 4 * g, os.path.join(out1, CSVS[1][1]): 1 + g})
        add("6a exp1", c, e, st)
        same_bytes("6a exp1", [(os.path.join(out1, rel), read_bytes(os.path.join(work1, rel)))
                               for rel in CSVS[1]])
        print("6a: step_5 and step_9 bytes equal 4a's single-device run's", flush=True)

        # 6b: exp2, exp3 and exp4 on 4a's exp0 (pivots, non-pivots), as the CLI
        # builds their inputs
        cfg = KhoiceConfig(kmers_per_dataset=2000000)
        loaded = load_database_dir(db)
        exp0 = cli._load_exp0(cfg, loaded, work)
        pivots = {num: loaded[num][exp0["pivots"][num]] for num in loaded}
        nonpivot = {num: [loaded[num][n] for n in exp0["nonpivots"][num]] for num in loaded}
        rest = {num: nonpivot[num] + ([] if cfg.out_pivot else [pivots[num]]) for num in loaded}
        reads = simulate_exp3_reads(pivots, cfg.kmers_per_dataset, seed=cfg.read_sim_seed)
        out = os.path.join(tmp, "sharded_exp234")
        runs = [
            (2, ["pivot_rest", "multi_pivot"], lambda: run_exp2(
                pivots, nonpivot, K_GRID, out, "cuda", union_cs=cfg.union_cs,
                hist_cx=cfg.hist_cx, group=group)),
            (3, ["containment"], lambda: run_exp3(
                reads, nonpivot, K_GRID, out, "cuda", union_cs=cfg.union_cs, group=group)),
            (4, ["buckets"], lambda: run_exp4(
                pivots, rest, K_GRID, out, "cuda", count_cs=cfg.count_cs,
                union_cs=cfg.union_cs, group=group)),
        ]
        lines = {2: 1 + 4 * g, 3: 1 + 2 * 4 * g * 4, 4: 4 * g}
        for exp_type, uses, fn in runs:
            def drive(fn=fn):
                fn()
                return 0

            c, e, _, st = run_path(
                f"6b exp{exp_type} sharded (1 rank, NCCL), 30 ks", drive,
                hold_sorts_and(lambda kernel, k: True), uses + ["sweep"],
                {os.path.join(out, rel): lines[exp_type] for rel in CSVS[exp_type][:1]})
            add(f"6b exp{exp_type}", c, e, st)
            same_bytes(f"6b exp{exp_type}", [(os.path.join(out, rel), csv30[rel])
                                             for rel in CSVS[exp_type]])
        print("6b: exp2, exp3 and exp4's CSV bytes equal 4a's single-device runs'; every "
              "scan call held against its plain version, equal", flush=True)

        c, e, st = sharded_tables(group, db, db96)
        add("6c tables and occurrence", c, e, st)

        c, e, st = sharded_exp6(tmp, group, db, work)
        add("6e exp6", c, e, st)
    finally:
        dist.destroy_process_group()
    c, e = two_ranks_one_card(db, out1)
    add("6d two ranks on one card", c, e, None)
    c, e = multihost_paths(tmp, db, work)
    add("6f two processes, env://", c, e, None)
    return launches, errors, stats


def sharded_exp6(tmp, group, db, work):
    """6e: `run_exp6(..., group=group)` over the 30 ks, both read types, on
    the exp0 in `work` (pivots, rest of set and reads, as the CLI builds
    them); every file byte-equal to the single-device exp6 in `work`, and
    every A, sort, vote_mask and read_votes call at HOLD_6E held against
    its plain version.  Returns run_path's counts, errors and stats."""
    from khoice_tpu_torch import cli
    from khoice_tpu_torch.config import KhoiceConfig
    from khoice_tpu_torch.pipelines.exp0 import load_database_dir
    from khoice_tpu_torch.pipelines.exp6 import READ_TYPE_LABEL, run_exp6

    cfg = KhoiceConfig(kmers_per_dataset=2000000)
    loaded = load_database_dir(db)
    exp0 = cli._load_exp0(cfg, loaded, work)
    pivots = {num: loaded[num][exp0["pivots"][num]] for num in loaded}
    rest = {num: [loaded[num][n] for n in exp0["nonpivots"][num]]
            + ([] if cfg.out_pivot else [pivots[num]]) for num in loaded}
    out6 = os.path.join(tmp, "sharded_exp6")

    def exp6():
        for rt in READ_TYPE_LABEL:
            reads_rt = {num: exp0["reads"][(num, rt)] for num in loaded}
            run_exp6(reads_rt, rest, K_GRID, out6, "cuda", read_type=rt, trial=cfg.curr_trial,
                     seed=cfg.seed, group=group)
        return 0

    c, e, _, st = run_path(
        "6e exp6 sharded (1 rank, NCCL), 30 ks, both read types", exp6,
        lambda kernel, k, nth: k in HOLD_6E and kernel in ("A keys", "sort", "vote_mask",
                                                           "read_votes"),
        ["A", "vote_mask", "read_votes"],
        {os.path.join(out6, f"trial_1_{lab}_acc.csv"): 1 + len(K_GRID) * len(loaded)
         for lab in READ_TYPE_LABEL.values()}, per_call=())
    same_bytes("6e exp6", [(os.path.join(out6, rel), read_bytes(os.path.join(work, rel)))
                           for rel in exp6_files()])
    print(f"6e: {len(exp6_files())} files (both trial CSVs, every per-k matrix and accuracy "
          f"file) byte-equal to the single-device exp6's; every A, sort, vote_mask and "
          f"read_votes call at k in {HOLD_6E} held against its plain version, equal",
          flush=True)
    return c, e, st


def exp6_files():
    """exp6's files under a work root: both trial CSVs, and each read
    type's matrices and accuracy values at every k."""
    from khoice_tpu_torch.pipelines.exp6 import READ_TYPE_LABEL

    rels = [f"trial_1_{lab}_acc.csv" for lab in READ_TYPE_LABEL.values()]
    for rt in READ_TYPE_LABEL:
        for k in K_GRID:
            rels += [f"accuracies_type_6/{rt}/confusion_matrix/k_{k}_confusion_matrix.txt",
                     f"accuracies_type_6/{rt}/confusion_matrix/"
                     f"k_{k}_confusion_matrix_with_unidentified.txt",
                     f"accuracies_type_6/{rt}/values/k_{k}_accuracy_values.csv"]
    return rels


def multihost_inputs(db, work):
    """6f's inputs, as every process builds them from the files: 4a's group 1
    (8 genomes) for the sweep, and exp6's datasets (each one's rest of set)
    with exp0's Illumina reads (4a's work root) for the votes."""
    from khoice_tpu_torch import cli
    from khoice_tpu_torch.config import KhoiceConfig
    from khoice_tpu_torch.io.packing import encode_records
    from khoice_tpu_torch.pipelines.exp0 import load_database_dir
    from khoice_tpu_torch.pipelines.exp6 import reads_matrix

    cfg = KhoiceConfig(kmers_per_dataset=2000000)
    loaded = load_database_dir(db)
    exp0 = cli._load_exp0(cfg, loaded, work)
    nums = sorted(loaded)
    members = [encode_records(loaded[1][n]) for n in sorted(loaded[1])]
    texts = [encode_records([s for name in exp0["nonpivots"][num] + [exp0["pivots"][num]]
                             for s in loaded[num][name]]) for num in nums]
    mats = [reads_matrix(exp0["reads"][(num, "illumina")]) for num in nums]
    return members, texts, mats


def multihost_rank(rank, port, db, work, out):
    """6f's rank program: one of two processes started alone, as on two
    hosts (env://: MASTER_ADDR 127.0.0.1, RANK, WORLD_SIZE 2, LOCAL_RANK 0),
    in a gloo group on cuda:0; it runs multihost_read_votes_multi and
    multihost_occurrence_histograms_sweep at MULTIHOST_KS, every kernel call
    held against its plain version, and pickles (votes, histograms,
    launches, each kernel's largest difference, wall) to `out`."""
    import pickle

    import torch.distributed as dist

    from khoice_tpu_torch.dist import multihost as mh
    from khoice_tpu_torch.dist.mesh import init_kv_group

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank, WORLD_SIZE="2",
                      LOCAL_RANK="0")
    dist.init_process_group("gloo", init_method="env://")
    group = init_kv_group("cuda", world_size=2)
    members, texts, mats = multihost_inputs(db, work)
    with Held(kernel_specs(True), lambda kernel, k, nth: True) as held:
        reset_counts()
        t0 = time.perf_counter()
        votes = mh.multihost_read_votes_multi(group, texts, mats, MULTIHOST_KS)
        hists = mh.multihost_occurrence_histograms_sweep(group, members, MULTIHOST_KS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - held.plain_s
        counts = read_counts()
    dist.destroy_process_group()
    with open(out, "wb") as fd:
        pickle.dump((votes, hists, counts, held.errors, wall), fd)


def multihost_paths(tmp, db, work):
    """6f: two processes, each started alone with env:// on gloo and on
    cuda:0 (multihost_rank), run multihost_read_votes_multi and
    multihost_occurrence_histograms_sweep on 4a's inputs at MULTIHOST_KS;
    both must equal the single-device votes (read_votes_bulk_multi) and
    histograms (occurrence_histograms_sweep) on the card.  Returns the
    launches summed over the processes and each kernel's largest
    difference."""
    import pickle
    import socket

    from khoice_tpu_torch.classify import annotate
    from khoice_tpu_torch.engine.ksweep import occurrence_histograms_sweep

    torch.cuda.empty_cache()  # the processes need the card this one has cached
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = str(sock.getsockname()[1])
    sock.close()
    outs = [os.path.join(tmp, f"multihost_{r}.pkl") for r in range(2)]
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--multihost-rank",
                               str(r), port, db, work, outs[r]], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"6f process {r} exited with {p.returncode}:\n{log[-4000:]}")
    members, texts, mats = multihost_inputs(db, work)
    want_h = occurrence_histograms_sweep(members, list(MULTIHOST_KS), "cuda")
    group = annotate.pack_group_texts(texts, "cuda")
    big, spans = annotate.concat_flat_reads([annotate.flat_reads_device(m, "cuda") for m in mats])
    want_v = {k: annotate.read_votes_bulk_multi(group, big, spans, k, len(texts))
              for k in MULTIHOST_KS}
    del group, big
    launches, errors = {}, {}
    for r, out in enumerate(outs):
        with open(out, "rb") as fd:
            votes, hists, counts, errs, wall = pickle.load(fd)
        for k in MULTIHOST_KS:
            if hists[k] != want_h[k] or not any(want_h[k]):
                raise AssertionError(f"6f process {r} k={k}: histogram differs")
            for got, want in zip(votes[k], want_v[k]):
                if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"6f process {r} k={k}: votes differ")
        for kernel in ("sort", "A", "vote_mask", "read_votes", "sweep"):
            if counts[kernel] < 1:
                raise AssertionError(f"6f process {r} never launched the {kernel} kernel")
        for kernel, n in counts.items():
            launches[kernel] = launches.get(kernel, 0) + n
        merge(errs, errors)
        print(f"6f process {r}: wall {wall:.2f} s (plain checks excluded), launches "
              f"{ {k: v for k, v in counts.items() if v} }, every kernel call held, equal",
              flush=True)
    print(f"6f: two processes (env://, gloo, both on cuda:0): multihost_read_votes_multi and "
          f"multihost_occurrence_histograms_sweep at k {MULTIHOST_KS} equal the single-device "
          f"votes and histograms in both; {time.perf_counter() - t0:.1f} s with the processes' "
          f"start ({smi_line()})", flush=True)
    return launches, errors


def sharded_tables(group, db, db96):
    """6c: sharded_count_codes of 4a's group 1 (8 genomes of 2 Mbp) at k 21
    and 31, then the union of their sets, intersect_sum, subtract, set_counts
    and the histogram, each table equal to the single-device KmerEngine's;
    sharded_occurrence_histogram of 4b's first group (96 genomes of 1 Mbp)
    at k 31 (kernels A, the sort and B) and of phase 5a's 300-genome group
    at k 31 (C), equal to occurrence_histogram's.  Every kernel call of the
    sharded run is held against its plain version."""
    from khoice_tpu_torch.dist import sharded as dsh
    from khoice_tpu_torch.dist.occurrence import sharded_occurrence_histogram
    from khoice_tpu_torch.engine.occurrence import occurrence_histogram
    from khoice_tpu_torch.engine.session import KmerEngine
    from khoice_tpu_torch.io.packing import encode_records as enc
    from khoice_tpu_torch.pipelines.exp0 import load_database_dir

    def group_codes(path, num):
        loaded = load_database_dir(path)
        return [enc(loaded[num][n]) for n in sorted(loaded[num])]

    genomes = group_codes(db, 1)
    members96 = group_codes(db96, 1)
    members300 = [enc(gen) for gen in small_genomes(random.Random(4321), 2, 300, base_len=400,
                                                    extra=40)[2]]
    got = {}

    def host(t):
        """The one shard's (keys [n, w], counts [n]) uint32, as
        KmerTable.to_host gives them."""
        words, counts, _ = dsh.sharded_table_to_host(t)
        return words[:, 0].T, counts[0]

    def drive():
        dsh.reset_session_splits()
        for k in (21, 31):
            raw = [dsh.sharded_count_codes(group, c, k) for c in genomes]
            union = dsh.sharded_union_many([dsh.sharded_set_counts(t, 1) for t in raw], cs=5000)
            got[k] = {
                "count": host(raw[0]),
                "union": host(union),
                "intersect": host(dsh.sharded_intersect_sum(raw[0], raw[1])),
                "subtract": host(dsh.sharded_subtract(raw[0], raw[1])),
                "set_counts": host(dsh.sharded_set_counts(raw[2], 3)),
                "hist": dsh.sharded_histogram(union, cx=16).tolist(),
            }
        got["occ96"] = sharded_occurrence_histogram(group, members96, 31, cx=128)
        got["occ300"] = sharded_occurrence_histogram(group, members300, 31, cx=512)
        return 0

    c, e, _, st = run_path("6c sharded tables (k 21, 31) and per-k occurrence (96 and 300 "
                           "genomes, k 31)", drive, lambda kernel, k, nth: True,
                           ["A", "B", "C"], {}, per_call=(), incore=False)
    eng = KmerEngine("cuda")
    for k in (21, 31):
        raw = [eng.count_codes(c, k) for c in genomes]
        union = eng.union([eng.set_counts(t, 1) for t in raw], cs=5000)
        want = {
            "count": raw[0].to_host(), "union": union.to_host(),
            "intersect": eng.intersect_sum(raw[0], raw[1]).to_host(),
            "subtract": eng.subtract(raw[0], raw[1]).to_host(),
            "set_counts": eng.set_counts(raw[2], 3).to_host(),
            "hist": eng.histogram(union, cx=16),
        }
        for name, w in want.items():
            g = got[k][name]
            equal = g == w if name == "hist" else all(np.array_equal(a, b) for a, b in zip(g, w))
            if not equal:
                raise AssertionError(f"6c k={k}: sharded {name} differs from the single-device one")
        if not (len(want["intersect"][1]) and len(want["subtract"][1]) and max(want["hist"][1:])):
            raise AssertionError(f"6c k={k}: an empty table, nothing compared")
    for name, members, cx in (("occ96", members96, 128), ("occ300", members300, 512)):
        if got[name] != occurrence_histogram(members, 31, "cuda", cx=cx) or not any(got[name]):
            raise AssertionError(f"6c: sharded {name} differs from the single-device histogram")
    print("6c: the sharded tables (count, union, intersect_sum, subtract, set_counts, "
          "histogram at k 21 and 31) and per-k occurrence histograms (96 genomes, kernel B; "
          "300 genomes, kernel C) equal the single-device engine's; every kernel call held",
          flush=True)
    return c, e, st


def kernel_record(name, source, replaces, launches, r, library_ms=None):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
        "library_ms": library_ms,
    }


def main():
    if sys.argv[1:2] == ["--multihost-rank"]:  # a process of 6f (multihost_paths)
        multihost_rank(*sys.argv[2:7])
        return
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
        launches, errors, sorts, db, work1, work, csv30 = main_paths(tmp)
        walls["main paths 4 x 8"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        big_launches, big_errors, big_sorts, db96, work96 = large_group_paths(tmp)
        walls["main paths 2 x 96"] = time.perf_counter() - t0
        for kernel, n in big_launches.items():  # the sweep's adds to 4a's
            launches[kernel] = launches.get(kernel, 0) + n
        sorts.update(big_sorts)
        merge(big_errors, errors)
        t0 = time.perf_counter()
        stream_errors, stream_sorts, stream_sweeps = streaming_paths(tmp, [
            ("2 x 96 x 1 Mbp", db96, 12, 2, work96, ["A", "B"]),
            ("4 x 8 x 2 Mbp", db, 4, 4, work1, []),
        ])
        walls["streaming 4c"] = time.perf_counter() - t0
        sorts.update(stream_sorts)
        launches["sweep"] += sum(stream_sweeps.values())
        merge(stream_errors, errors)
        t0 = time.perf_counter()
        ops_counts, ops_errors = table_op_path(tmp, db, work1)
        sorts["exp1 table ops on 4 x 8"] = ops_counts["sort"]
        merge(ops_errors, errors)
        mem_paths(tmp)
        walls["table ops and MEM 4d"] = time.perf_counter() - t0
        # the sort's record reports one run, counted from 0 just before it
        launches["sort"] = sorts[SORT_RUN]
        print(f"radix_sort launches per run (each counted from 0): {sorts}; the kernels "
              f"line reports {SORT_RUN!r}: {launches['sort']}", flush=True)
        t0 = time.perf_counter()
        launches["C"], c_err = small_world_exp1(tmp)
        merge({"C": c_err}, errors)
        small_world_classify()
        small_world_tables()
        walls["small worlds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sharded_launches, sharded_errors, _ = sharded_paths(tmp, db, work1, work, csv30, db96)
        walls["sharded 6"] = time.perf_counter() - t0
        merge(sharded_errors, errors)
        # each kernel's record adds phase 6's runs, each counted from 0
        for kernel in launches:
            launches[kernel] += sharded_launches.get(kernel, 0)
        print(f"phase 6's launches (6a + 6b + 6c + 6d's two ranks + 6e + 6f's two processes): "
              f"{ {k: v for k, v in sharded_launches.items() if v} }; the kernels line adds "
              f"them to phase 4/5's", flush=True)
    for kernel, err in errors.items():
        key = kernel.split()[0]  # "A keys", "A packed" -> "A"
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    reference = sorted(m for m in sys.modules if m == "khoice_tpu" or m.startswith("khoice_tpu."))
    if reference:
        raise AssertionError(f"modules of the JAX package were imported: {reference}")
    walls["all"] = time.perf_counter() - t_all
    print("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    print(smi_line())
    kernels = [kernel_record("radix_sort", "khoice_tpu_torch/csrc/radix_sort.cu",
                             "khoice_tpu/kernels/merge_pallas.py:340", launches["sort"],
                             results["sort"], results["sort"]["library_ms"])]
    kernels += [kernel_record("ksweep_scan", SCAN_SOURCE, f"{SCAN_REPLACES}:299",
                              launches["occ"], results["occ"])]
    kernels += [kernel_record(f"ksweep_scan.{mode}", SCAN_SOURCE, f"{SCAN_REPLACES}:221",
                              launches[mode], results[mode]) for mode in MODES]
    kernels += [
        kernel_record("extract_sweep", "khoice_tpu_torch/csrc/extract_sweep.cu",
                      "khoice_tpu/engine/ksweep.py:142", launches["sweep"], results["sweep"]),
        kernel_record("extract_canonical", "khoice_tpu_torch/csrc/extract_canonical.cu",
                      "khoice_tpu/kernels/extract_pallas.py:86", launches["A"], results["A"]),
        kernel_record("occ_scan.packed", "khoice_tpu_torch/csrc/occ_scan.cu",
                      "khoice_tpu/kernels/occ_scan_pallas.py:205", launches["B"], results["B"]),
        kernel_record("occ_scan.unpacked", "khoice_tpu_torch/csrc/occ_scan.cu",
                      "khoice_tpu/kernels/occ_scan_pallas.py:238", launches["C"], results["C"]),
        kernel_record("vote_mask", VOTE_SOURCE, "khoice_tpu/classify/annotate.py:250",
                      launches["vote_mask"], results["vote_mask"]),
        kernel_record("read_votes", VOTE_SOURCE, "khoice_tpu/classify/annotate.py:497",
                      launches["read_votes"], results["read_votes"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
