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
       {7, 15, 16, 31, 32, 49, 63}, keys and the gid-packed form;
     - the occurrence-histogram kernel, packed (B), on the sorted words of
       96 members x 2^20 at k = 31 and 49 (one member with a poly-A
       tract, so runs cross tiles), and unpacked (C) on 300 members x
       2^16 at k = 31; each one's time over its bound is printed.
  4. main paths through the port's CLI entry point:
     a. on a generated 4 datasets x 8 genomes x 2 Mbp database:
        `run --exp-type 1`, then 2, 3 and 4 in one work root (exp0 runs
        once), then exp 3 and 4 again with `--force --k-values 21,31`
        (the per-k table ops);
     b. on a generated 2 datasets x 96 genomes x 1 Mbp database (groups
        over the sweep's 64-member mask): `run --exp-type 1` on the full
        grid and `run --exp-type 2` in its own work root.
     c. the streaming sweep: `run --exp-type 1 --force` on 4b's database
        with `--device-budget-gb 12` (the 386.8M-element across set
        streams, the per-k within-group sorts fit) and on 4a's with 4
        (the 128.1M-element across set streams, the groups run in-core);
        the CSVs must equal 4a's and 4b's in-core bytes, the peak device
        memory must stay within the budget, and the stream's log lines
        (chunks, key-range groups, passes, retries) are printed.
     Every launch counter is set to 0 just before each run and read just
     after; the kernels a run uses must have launched (the sort on every
     run), and its CSVs must have the expected lines.  In each 4a/4b run
     the largest device-memory estimate that the engine checked against
     its budget (with what the run held at the check) is printed beside
     the run's peak, with the checked step whose own peak comes nearest
     to (or furthest over) its estimate; the run's peak must not exceed
     the largest estimate, nor any checked step's peak its own.  Each
     kernel call is
     timed (CUDA events) and held against its plain version on the same
     inputs, exactly, after its timed span: every scan call of 4a, the
     first SORT_HOLDS sorts of each 4a/4b run, in 4b every extraction
     and histogram call at the ks where a word count changes (HOLD_KS),
     and in each 4c run the first STREAM_HOLDS chunk sorts, the first
     key-range group's sort and its raw scan; 4b's scan calls (388M
     elements) are timed only.  Wall, peak device memory and each
     kernel's calls are printed, and each run's sort launches; the
     kernels line reports the sort's from one run, SORT_RUN.
  5. small worlds, against a dict-based canonical k-mer counter written
     here: the step_4/step_8 histograms that `run_exp1` writes on the card
     for 2 groups x 3 genomes, then for a group of 70 genomes and one of
     300 (per-k, packed and unpacked) on a 2-k and a 7-k grid (each
     kernel call timed, every C call held against its plain version); the four
     classification sweeps; and count_codes, union, intersect_sum,
     subtract and histogram at k in {11, 31, 45}.  (The CSV bytes are
     held against the JAX package and its oracle by the CPU tests.)
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
SORT_HOLDS = 3  # sorts of each 4a/4b run held against the plain sort
STREAM_HOLDS = 2  # chunk sorts of each 4c run held against the plain sort
SORT_RUN = "exp1 streamed on 2 x 96 x 1 Mbp"  # the run whose sort launches are reported
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

    t0 = time.perf_counter()
    _build.load()
    print(f"built {os.path.relpath(_build.library_path(), ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    # ptxas: "Compiling entry function '<mangled>'" ... "N bytes spill stores" ...
    # "Used R registers"; one line per kernel: its instantiations' registers
    name, spill, kernels = None, 0, {}
    for line in _build.build_log().splitlines():
        m = re.search(r"entry function '.*?(occ_tiles|scan_tiles|extract_kernel"
                      r"|(?:first|middle|last)_pass_kernel)", line)
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


def compare(label, kern, plain, args, plain_reps=2, kern_reps=10):
    """Kernel vs plain on the same inputs: exactly equal, timed in turns."""
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
    print(f"{label}: equal (max_abs_err {err}); kernel {k1:.3f} / {k2:.3f} ms, "
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
                    lambda: extract.extract_canonical_reference(codes, k), (codes,))
        errs.append(r["max_abs_err"])
        if k == 31:
            results["A"] = r
        if k <= 60:
            errs.append(compare(f"A extract_packed n=2^24 k={k}",
                                lambda: extract.extract_packed(codes, gids, k),
                                lambda: extract.extract_packed_reference(codes, gids, k),
                                (codes, gids))["max_abs_err"])
    results["A"]["max_abs_err"] = max(errs)
    del codes, gids

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


def kernels_vs_plain():
    phase("3 kernels vs plain")
    rng = np.random.default_rng(0)
    bench = random_members(rng, 8, 1 << 21)
    members96 = random_members(rng, 96, 1 << 20)
    members96[0] = np.concatenate([members96[0], np.zeros(100_000, np.uint8)])  # poly-A
    sort = sort_kernel_vs_plain(bench, members96)
    occ = scan_vs_plain("bench 8x2^21 grid30", bench, K_GRID)
    wide = scan_vs_plain("64x2^16 grid30", random_members(rng, 64, 1 << 16), K_GRID)
    unpacked = scan_vs_plain("bench 8x2^21 ks11..31", bench, list(range(11, 32)))
    occ["max_abs_err"] = max(r["max_abs_err"] for r in (occ, wide, unpacked))
    results = {"occ": occ, "sort": sort}
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
    return results


class Held:
    """Wraps kernel wrappers that the engine imported by name: times every
    call (CUDA events around it, read after the run's last synchronize)
    and, after the call's timed span, holds the calls `hold(kernel, k,
    nth)` picks against the plain version on the same inputs, exactly.  A
    call's k is its extraction's, or the last extraction's for the
    histogram that follows it; nth counts the kernel's earlier calls in
    the run.  `errors` gets each kernel's largest
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
    from khoice_tpu_torch.engine import ksweep, ksweep_classify, occurrence, ops, streaming
    from khoice_tpu_torch.kernels import extract, ksweep_scan, occ_scan
    from khoice_tpu_torch.kernels import sort as ksort

    return [
        (ksweep, "scan_multi_k", "occ",
         ksweep_scan.scan_multi_k_reference if scan_plain else None),
        (streaming, "scan_multi_k", "occ",
         ksweep_scan.scan_multi_k_reference if scan_plain else None),
        (ksweep_classify, "scan_classify", "scan_classify",
         ksweep_scan.scan_classify_reference if scan_plain else None),
        (occurrence, "extract_packed", "A packed", extract.extract_packed_reference),
        (occurrence, "extract_canonical", "A keys", extract.extract_canonical_reference),
        (ops, "extract_canonical", "A keys", extract.extract_canonical_reference),
        (occurrence, "occ_hist_packed", "B", occ_scan.occ_hist_packed_reference),
        (occurrence, "occ_hist", "C", occ_scan.occ_hist_reference),
    ] + [(module, "sort_words", "sort", ksort.sort_words_reference)
         for module in (ksweep, streaming, occurrence, ops, annotate)]


def reset_counts():
    from khoice_tpu_torch.kernels import extract, ksweep_scan, occ_scan
    from khoice_tpu_torch.kernels import sort as ksort

    for counts in (ksweep_scan.launches, extract.launches, occ_scan.launches):
        for key in counts:
            counts[key] = 0
    ksort.launches = 0


def read_counts():
    """Launches per kernel: the scan's modes, A (extraction, both forms),
    B (packed histogram), C (unpacked histogram) and the sort."""
    from khoice_tpu_torch.kernels import extract, ksweep_scan, occ_scan
    from khoice_tpu_torch.kernels import sort as ksort

    counts = dict(ksweep_scan.launches)
    counts["A"] = extract.launches["keys"] + extract.launches["packed"]
    counts["B"] = occ_scan.launches["packed"]
    counts["C"] = occ_scan.launches["unpacked"]
    counts["sort"] = ksort.launches
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
    budget during a run (`check_device_budget`, imported by name in three
    modules), with what the run held on the card at that check, and the
    peak of the step it starts (until the next check; the plain checks'
    memory excluded, as Held excludes it)."""

    def __init__(self, held):
        from khoice_tpu_torch.engine import ksweep_classify, session, streaming

        self.modules = (streaming, ksweep_classify, session)
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
    """Drive one main path through the CLI with every count set to 0 just
    before it, its kernel calls timed and held against their plain
    versions; return the counts read just after, each kernel's largest
    difference, the per-kernel call summary and the run's wall and peak
    (checks excluded).  Every run sorts with the radix sort.  The calls
    of the kernels in per_call are printed one by one (by default the
    scan's, when they are held).  An in-core run's peak must stay within
    the largest estimate the engine checked (engine/streaming.py)."""
    from khoice_tpu_torch import cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Held(kernel_specs(scan_plain), hold) as held, Estimates(held) as est:
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv)
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


def main_paths(tmp):
    phase("4a main paths on 4 x 8 x 2 Mbp: run --exp-type 1, 2, 3, 4; 3 and 4 per-k")
    db = gen_db(tmp, "db", 4, 8, 2.0)
    g = len(K_GRID)
    every = hold_sorts_and(lambda kernel, k: True)
    launches, errors, sorts = {}, {}, {}
    work1 = os.path.join(tmp, "work1")
    c, e, _, _ = run_path("exp1, 30 ks", ["run", "--exp-type", "1", "--database-root", db,
                                          "--work-root", work1], every, ["occ"], {
        os.path.join(work1, "step_5/within_datasets_analysis.csv"): 1 + 4 * g,
        os.path.join(work1, "step_9/across_datasets_analysis.csv"): 1 + g})
    launches["occ"] = c["occ"]
    sorts["exp1 on 4 x 8 x 2 Mbp"] = c["sort"]
    merge(e, errors)
    work = os.path.join(tmp, "work")
    common = ["--database-root", db, "--work-root", work, "--kmers-per-dataset", "2000000"]
    c, e, _, _ = run_path("exp2 (with exp0), 30 ks", ["run", "--exp-type", "2", *common], every,
                          ["pivot_rest", "multi_pivot"], {
        os.path.join(work, "within_dataset_analysis_type_2/within_dataset_analysis.csv"): 1 + 4 * g,
        os.path.join(work, "across_dataset_analysis_type_2/across_dataset_analysis.csv"): 1 + 4 * g})
    launches["pivot_rest"], launches["multi_pivot"] = c["pivot_rest"], c["multi_pivot"]
    sorts["exp2 on 4 x 8"] = c["sort"]
    merge(e, errors)
    c, e, _, _ = run_path("exp3, 30 ks", ["run", "--exp-type", "3", *common], every,
                          ["containment"], {
        os.path.join(work, "final_analysis_type3/final_analysis_type3.csv"): 1 + 2 * 4 * g * 4})
    launches["containment"] = c["containment"]
    sorts["exp3 on 4 x 8"] = c["sort"]
    merge(e, errors)
    c, e, _, _ = run_path("exp4, 30 ks", ["run", "--exp-type", "4", *common], every, ["buckets"], {
        os.path.join(work, "accuracies_type_4/accuracy_values.csv"): 4 * g})
    launches["buckets"] = c["buckets"]
    sorts["exp4 on 4 x 8"] = c["sort"]
    merge(e, errors)
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
    return launches, errors, sorts, db, work1


def large_group_paths(tmp):
    phase("4b main path on 2 x 96 x 1 Mbp (groups over the 64-member mask): "
          "run --exp-type 1, 2")
    db = gen_db(tmp, "db96", 2, 96, 1.0)
    g = len(K_GRID)
    at_hold_ks = hold_sorts_and(lambda kernel, k: k in HOLD_KS)
    launches, errors, per, sorts = {}, {}, {}, {}
    work1 = os.path.join(tmp, "work96_1")
    c, e, per["exp1"], _ = run_path(
        "exp1 on 2 x 96 x 1 Mbp, 30 ks", ["run", "--exp-type", "1", "--database-root", db,
                                          "--work-root", work1],
        at_hold_ks, ["A", "B", "occ"], {
            os.path.join(work1, "step_5/within_datasets_analysis.csv"): 1 + 2 * g,
            os.path.join(work1, "step_9/across_datasets_analysis.csv"): 1 + g},
        scan_plain=False)
    launches["A"], launches["B"] = c["A"], c["B"]
    sorts["exp1 on 2 x 96 x 1 Mbp"] = c["sort"]
    merge(e, errors)
    work2 = os.path.join(tmp, "work96_2")
    c, e, per["exp2"], _ = run_path(
        "exp2 (with exp0) on 2 x 96 x 1 Mbp, 30 ks",
        ["run", "--exp-type", "2", "--database-root", db, "--work-root", work2,
         "--kmers-per-dataset", "2000000"],
        at_hold_ks, ["A", "multi_pivot"], {
            os.path.join(work2, "within_dataset_analysis_type_2/within_dataset_analysis.csv"): 1 + 2 * g,
            os.path.join(work2, "across_dataset_analysis_type_2/across_dataset_analysis.csv"): 1 + 2 * g},
        scan_plain=False)
    sorts["exp2 on 2 x 96"] = c["sort"]
    merge(e, errors)
    held = {kernel: per["exp1"].get(kernel, {}).get("held", 0) + per["exp2"].get(kernel, {}).get("held", 0)
            for kernel in ("A packed", "A keys", "B", "sort")}
    print(f"held against their plain versions (A and B at k in {HOLD_KS}, the first "
          f"{SORT_HOLDS} sorts of each run): {held} calls, all equal")
    return launches, errors, sorts, db, work1


def streaming_paths(tmp, runs):
    """exp1 under device budgets below its in-core need: `runs` is
    [(label, database, budget GiB, n_groups, in-core work root, kernels
    the run uses)].  Each run's first STREAM_HOLDS chunk sorts, its first
    key-range group's sort and that group's raw scan are held against
    their plain versions.  Returns each kernel's largest difference and
    each run's sort launches."""
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
            return kernel == "sort" and site["chunk"] <= STREAM_HOLDS
        return site["in"] == "group" and site["group"] == 1

    keep = Keep()
    loggers = [get_logger("khoice.streaming"), get_logger("khoice.exp1")]
    for logger in loggers:
        logger.addHandler(keep)
    steps = [(name, getattr(streaming, name)) for name in ("_chunk_step", "_group_scan")]
    for name, fn in steps:
        setattr(streaming, name, step(name.split("_")[1], fn))
    g = len(K_GRID)
    errors, sorts = {}, {}
    csvs = ("step_5/within_datasets_analysis.csv", "step_9/across_datasets_analysis.csv")
    try:
        for label, db, gib, n_groups, incore, uses in runs:
            work = os.path.join(tmp, f"stream_{gib}gib")
            del lines[:]
            site.update(chunk=0, group=0)
            c, e, per, stats = run_path(
                f"exp1 streamed on {label}, --device-budget-gb {gib}",
                ["run", "--exp-type", "1", "--database-root", db, "--work-root", work,
                 "--device-budget-gb", str(gib), "--force"], hold, ["occ"] + uses,
                {os.path.join(work, csvs[0]): 1 + n_groups * g, os.path.join(work, csvs[1]): 1 + g},
                per_call=(), incore=False)
            sorts[f"exp1 streamed on {label}"] = c["sort"]
            merge(e, errors)
            if per["sort"]["held"] != STREAM_HOLDS + 1 or per["occ"]["held"] != 1:
                raise AssertionError(f"{label}: held {per['sort']['held']} sorts and "
                                     f"{per['occ']['held']} scans, expected "
                                     f"{STREAM_HOLDS + 1} and 1")
            print(f"held against their plain versions: the first {STREAM_HOLDS} chunk sorts, "
                  "the first key-range group's sort and its raw scan, all equal")
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
    return errors, sorts


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


def kernel_record(name, source, replaces, launches, r, library_ms=None):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
        "library_ms": library_ms,
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
        launches, errors, sorts, db, work1 = main_paths(tmp)
        walls["main paths 4 x 8"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        big_launches, big_errors, big_sorts, db96, work96 = large_group_paths(tmp)
        walls["main paths 2 x 96"] = time.perf_counter() - t0
        launches.update(big_launches)
        sorts.update(big_sorts)
        merge(big_errors, errors)
        t0 = time.perf_counter()
        stream_errors, stream_sorts = streaming_paths(tmp, [
            ("2 x 96 x 1 Mbp", db96, 12, 2, work96, ["A", "B"]),
            ("4 x 8 x 2 Mbp", db, 4, 4, work1, []),
        ])
        walls["streaming 4c"] = time.perf_counter() - t0
        sorts.update(stream_sorts)
        merge(stream_errors, errors)
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
        kernel_record("extract_canonical", "khoice_tpu_torch/csrc/extract_canonical.cu",
                      "khoice_tpu/kernels/extract_pallas.py:86", launches["A"], results["A"]),
        kernel_record("occ_scan.packed", "khoice_tpu_torch/csrc/occ_scan.cu",
                      "khoice_tpu/kernels/occ_scan_pallas.py:205", launches["B"], results["B"]),
        kernel_record("occ_scan.unpacked", "khoice_tpu_torch/csrc/occ_scan.cu",
                      "khoice_tpu/kernels/occ_scan_pallas.py:238", launches["C"], results["C"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
