#!/usr/bin/env python3
"""Variants of the radix sort's CUDA source timed in turns against it.

    python tools/sort_variants.py [--reps 10]

Each variant is `khoice_tpu_torch/csrc/radix_sort.cu` with a few lines
replaced (VARIANTS), compiled alone with nvcc into a temporary directory
and loaded in place of the port's library for the sort wrapper
(`kernels/sort.py`), all in one process on one card.  The shapes are
those of `chip_smoke.py` phase 3 (the bench class, the unpacked class,
the per-k packed words at k = 31 and 49, a 2^24-key table merge).  Each
shape times every variant twice, in the order committed, variants,
variants reversed, committed (CUDA events over `--reps` sorts); a variant
that keeps the function must give the committed kernel's result bit for
bit.  The ablations (x_*) drop a phase of each digit pass to show what it
costs: their results are wrong and they run only where that cannot write
out of bounds (no all-ones elements).  Also prints the committed
kernel's ms per sort by kernel (torch.profiler) and the card's name and
power limit.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "khoice_tpu_torch", "csrc", "radix_sort.cu")
ITEMS = "static constexpr int ITEMS = R <= 2 ? 32 : (R <= 4 ? 16 : 8);"
BALLOTS = """    rank_bucket[r] = d;
    peer_of[r] = peers;
  }
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const unsigned d = rank_bucket[r], peers = peer_of[r];
"""
PEERS = """    unsigned peers = FULL;
#pragma unroll
    for (int b = 0; b < BUCKET_BITS; ++b) {
      const unsigned bit = __ballot_sync(FULL, (d >> b) & 1u);
      peers &= ((d >> b) & 1u) ? bit : ~bit;
    }
"""
LOOKBACK = """    for (unsigned tt = t - 1;; --tt) {
      u64 s;
      do {
        s = load_status(status + (u64)tt * RADIX + b);
      } while (((s >> COUNT_BITS) & EPOCH_MASK) != epoch);
      before += s & COUNT_MASK;
      if (s & FLAG_INC) break;
    }"""
LOAD = """      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(sbase + 16u * v),
                   "l"(s + 4 * v));"""
STORE = "        if (from < live) dst[(u64)gs * R + j] = buf[es * R + j];"
KEEP_LOADS = "        if (from < live && buf[es * R + j] == 0x12345u) dst[0] = 1u;"
NO_ONES = ("bench W4", "unpacked W2+pay")
# name: (replacements, keeps the function, shapes (None: all))
VARIANTS = {
    "tiles_half": ([(ITEMS, "static constexpr int ITEMS = R <= 2 ? 16 : 8;")], True, None),
    "tiles_1.5x": ([(ITEMS, "static constexpr int ITEMS = R <= 2 ? 32 : (R <= 4 ? 24 : 12);")],
                   True, None),
    "rounds_in_turn": ([(BALLOTS, "")], True, None),
    "match_any": ([(PEERS, "    const unsigned peers = __match_any_sync(FULL, d);\n")], True, None),
    "x_no_lookback": ([(LOOKBACK, "")], False, NO_ONES),
    "x_no_store": ([(STORE, KEEP_LOADS)], False, ("bench W4",)),
    "x_no_load_no_store": ([(LOAD, ""), (STORE, KEEP_LOADS)], False, ("bench W4",)),
}


def build(tmp: str) -> dict:
    """{name: ctypes library} for the committed source and each variant,
    compiled in parallel."""
    from khoice_tpu_torch.kernels import _build

    with open(SRC) as fd:
        committed = fd.read()
    sources = {"committed": committed}
    for name, (subs, _, _) in VARIANTS.items():
        src = committed
        for old, new in subs:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: the text it replaces is not in {SRC} once")
            src = src.replace(old, new)
        sources[name] = src
    procs = {}
    for name, src in sources.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as fd:
            fd.write(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out[-4000:]}")
        lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        for fn in ("radix_sort_tile_elems", "radix_sort_first_pass", "radix_sort_passes"):
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        libs[name] = lib
    return libs


def shapes(dev) -> dict:
    import chip_smoke
    from khoice_tpu_torch.engine.ksweep import _doubled_elements
    from khoice_tpu_torch.engine.occurrence import pack_members
    from khoice_tpu_torch.kernels import extract

    rng = np.random.default_rng(0)
    out = {}
    codes, gids = pack_members(chip_smoke.random_members(rng, 8, 1 << 21), dev)
    out["bench W4"] = (_doubled_elements(codes, gids, 49, 4, True)[0], None)
    out["unpacked W2+pay"] = _doubled_elements(codes, gids, 30, 2, False)
    codes, gids = pack_members(chip_smoke.random_members(rng, 96, 1 << 20), dev)
    out["perk31 W3"] = (extract.extract_packed(codes, gids, 31), None)
    out["perk49 W4"] = (extract.extract_packed(codes, gids, 49), None)
    a = torch.from_numpy(rng.integers(0, 2**32, (2, 1 << 23), dtype=np.int64)).to(dev)
    out["merge W2+pay"] = (torch.cat([a, a[:, torch.randperm(1 << 23, device=dev)]], 1),
                           torch.arange(1 << 24, device=dev))
    return out


def split_ms(sort_words, words, payload, reps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            sort_words(words, payload)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for name in ("first_pass", "middle_pass", "last_pass"):
            if f"{name}_kernel" in ev.key:
                out[name] = out.get(name, 0.0) + ev.device_time_total / 1e3 / reps
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke
    from khoice_tpu_torch.kernels import _build
    from khoice_tpu_torch.kernels import sort as ksort

    print(chip_smoke.smi_line(), flush=True)
    dev = torch.device("cuda")
    load = _build.load
    load()  # the port's library: the shapes' extraction kernel
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        try:
            for label, (words, payload) in shapes(dev).items():
                run = ["committed"] + [n for n, (_, _, only) in VARIANTS.items()
                                       if only is None or label in only]
                times = {name: [] for name in run}
                want = None
                for order in (run, run[::-1]):
                    for name in order:
                        _build.load = lambda name=name: libs[name]
                        got = ksort.sort_words(words, payload)
                        torch.cuda.synchronize()
                        if want is None:
                            want = got
                        elif name != "committed" and VARIANTS[name][1] and not all(
                                g is None or torch.equal(g, w) for g, w in zip(got, want)):
                            raise AssertionError(f"variant {name} differs on {label}")
                        del got
                        times[name].append(chip_smoke.time_ms(
                            lambda: ksort.sort_words(words, payload), args.reps))
                _build.load = lambda: libs["committed"]
                ksort.sort_words(words, payload)
                passes = len(ksort.last_plan[0])
                split = split_ms(ksort.sort_words, words, payload, args.reps)
                print(f"{label} ({passes} passes): " + ", ".join(
                    f"{name} {np.mean(t):.3f} ms ({t[0]:.3f} / {t[1]:.3f})"
                    for name, t in times.items()), flush=True)
                print(f"  committed, ms per sort by kernel: "
                      + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
                del want
        finally:
            _build.load = load


if __name__ == "__main__":
    main()
