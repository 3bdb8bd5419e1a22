#!/usr/bin/env python3
"""Variants of a CUDA source of the port timed in turns against it.

    python tools/sort_variants.py [--kernel sort|scan|occ|extract|sweep]
                                  [--reps 10] [--parent DIR]

--kernel sort (the default): `khoice_tpu_torch/csrc/radix_sort.cu`;
--kernel scan: `khoice_tpu_torch/csrc/ksweep_scan.cu`; --kernel occ:
`khoice_tpu_torch/csrc/occ_scan.cu` (kernels B and C); --kernel extract:
`khoice_tpu_torch/csrc/extract_canonical.cu` (kernel A); --kernel sweep:
`khoice_tpu_torch/csrc/extract_sweep.cu`.  Each variant is
the source with a few lines replaced (SORT_VARIANTS, SCAN_VARIANTS,
OCC_VARIANTS, EXTRACT_VARIANTS, SWEEP_VARIANTS), compiled alone with
nvcc into a temporary directory and
loaded in place of the port's library for the kernel's wrapper
(`kernels/sort.py`, `kernels/ksweep_scan.py`, `kernels/occ_scan.py`,
`kernels/extract.py`, `kernels/extract_sweep.py`),
all in one process on one card.  The shapes are those of
`chip_smoke.py` phase 3: for the sort the bench class, the unpacked
class, the per-k packed words at k = 31 and 49 and a 2^24-key table
merge; for the scan its five modes at the bench shape, the 64-member
and unpacked occ shapes and the 63-member containment, and occ and
buckets over 8 related members (1% SNPs, as the generated databases'
groups); for occ, B on the sorted packed words of 96 x 2^20 at k = 31
and 49 and of 96 related members (exp1's groups on 2 x 96) at k = 31,
and C on 300 x 2^16 at k = 31; for extract, A on 2^24 codes at k = 7,
15, 16, 31, 32, 49 and 63 (keys, and gid-packed to k = 49) and on 2.0M
codes (a table op's call) at k = 7, 15, 21, 31 and 49; for sweep, the
doubled bench class, the doubled unpacked class, a streamed chunk
(direct, at an unaligned offset) and the doubled 96 x 2^20 text.
`--parent DIR` adds the variant "parent": with --kernel occ
DIR/khoice_tpu_torch/csrc/occ_scan.cu of the three-pass
kernel's tree (commit 54bd19a, unpacked with `git archive`; a source
with another C signature is refused), called through that signature
(its tile arrays), and "parent_3blocks", the same with at most 3
blocks an SM (PARENT_VARIANTS); with --kernel extract
DIR/khoice_tpu_torch/csrc/extract_canonical.cu of any tree whose
extract_canonical_launch has the committed signature (kernel A before
its redesign: commit bbbc043), called through the same wrapper.  Each
shape times every variant twice, in the order committed, variants,
variants reversed, committed (CUDA events over `--reps` calls); a
variant that keeps the function must give the committed kernel's result
bit for bit.  The ablations (x_*) drop a part of the kernel to show what
it costs: their results are wrong, and a sort ablation runs only where
that cannot write out of bounds (no all-ones elements).  Also prints,
for the sort, the committed kernel's ms per sort by kernel
(torch.profiler), for extract and sweep each variant's device time per
launch (torch.profiler, after its turns), and the card's name and power
limit.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "khoice_tpu_torch", "csrc")
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
SORT_VARIANTS = {
    "tiles_half": ([(ITEMS, "static constexpr int ITEMS = R <= 2 ? 16 : 8;")], True, None),
    "tiles_1.5x": ([(ITEMS, "static constexpr int ITEMS = R <= 2 ? 32 : (R <= 4 ? 24 : 12);")],
                   True, None),
    "rounds_in_turn": ([(BALLOTS, "")], True, None),
    "match_any": ([(PEERS, "    const unsigned peers = __match_any_sync(FULL, d);\n")], True, None),
    "x_no_lookback": ([(LOOKBACK, "")], False, NO_ONES),
    "x_no_store": ([(STORE, KEEP_LOADS)], False, ("bench W4",)),
    "x_no_load_no_store": ([(LOAD, ""), (STORE, KEEP_LOADS)], False, ("bench W4",)),
}


# the scan's lines that the variants replace
MIN_BLOCKS = "constexpr int MIN_BLOCKS = 4;"
EPT = "constexpr int EPT = 8; "
ANY_HEAD = "      const bool any_head = __any_sync(FULL, head);"
BLOCK_K = "      if (2 * ks.k[q] <= bmax) block_ks |= 1u << q;"
BIN_RUNS = "template <int MODE>\n__device__ __forceinline__ bool bin_runs("
CARRIED = "      carried &= !start;"
DEFER_AT = "        if (carried) {"
DEFER_CALL = """      const bool deferred = bin_runs<MODE>(gn, lcp, pm, base, n, q, k, acc, sacc, carried, mp,
                                           hd, hp, &s_defer[q][warp]);
      if (block) {
        const bool any_deferred = __any_sync(FULL, deferred);
        if (lane == 0 && !any_deferred) s_defer[q][warp].f = 0;
      }"""
SPLIT_LOOPS = """      if (block && __shfl_sync(FULL, head, 0)) {
        const bool deferred = bin_runs<MODE, true>(gn, lcp, pm, base, n, q, k, acc, sacc,
                                                   carried, mp, hd, hp, &s_defer[q][warp]);
        const bool any_deferred = __any_sync(FULL, deferred);
        if (lane == 0 && !any_deferred) s_defer[q][warp].f = 0;
      } else {
        bin_runs<MODE, false>(gn, lcp, pm, base, n, q, k, acc, sacc, false, mp, hd, hp,
                              nullptr);
        if (block && lane == 0) s_defer[q][warp].f = 0;
      }"""
HIT = """  atomicAdd(&hd[b], w);
  if (pal) atomicAdd(&hp[b], w);"""
# the lanes that hit one bin add once: their weights summed by the leader
WARP_HITS = """  const unsigned act = __activemask();
  __syncwarp(act);
  const unsigned peers = __match_any_sync(act, (unsigned long long)(hd + b));
  const unsigned wd = __reduce_add_sync(peers, w);
  const unsigned wp = __reduce_add_sync(peers, pal ? w : 0u);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(&hd[b], wd);
    if (wp) atomicAdd(&hp[b], wp);
  }"""
PAL = "      pm[e] = i < n ? pal_mask(h, l, ks) : 0u;"
PAL_FILTER = "  for (int i = 0; i < 4; ++i) {\n    const u64 c = "
CLASSIFY = ("pivot_rest", "multi_pivot", "containment", "buckets", "containment 63",
            "buckets related")
SCAN_VARIANTS = {
    "blocks_2": ([(MIN_BLOCKS, "constexpr int MIN_BLOCKS = 2;")], True, None),
    "blocks_3": ([(MIN_BLOCKS, "constexpr int MIN_BLOCKS = 3;")], True, None),
    "ept_4": ([(EPT, "constexpr int EPT = 4; ")], True, None),
    "ept_16_2blocks": ([(EPT, "constexpr int EPT = 16; "),
                        (MIN_BLOCKS, "constexpr int MIN_BLOCKS = 2;")], True, None),
    "warp_hits": ([(HIT, WARP_HITS)], True, CLASSIFY),
    # the binning loop without the carried-run tracking where the warp
    # carries no run (two instantiations instead of one)
    "split_loops": ([(BIN_RUNS, "template <int MODE, bool DEFER>\n"
                                "__device__ __forceinline__ bool bin_runs("),
                     (CARRIED, "      if (DEFER) carried &= !start;"),
                     (DEFER_AT, "        if (DEFER && carried) {"),
                     (DEFER_CALL, SPLIT_LOOPS)], True, None),
    # every k takes the cross-warp and cross-thread work, as if every run
    # crossed: what the skip saves
    "no_skip": ([(ANY_HEAD, "      const bool any_head = true;"),
                 (BLOCK_K, "      block_ks |= 1u << q;")], True, None),
    # every even k checked in full, as without the compares
    "no_pal_filter": ([(PAL_FILTER, "  for (int i = 0; i < 0; ++i) {\n    const u64 c = ")],
                      True, None),
    "x_no_pal": ([(PAL, "      pm[e] = 0u;")], False, ("occ bench",)),
}
# the histogram's lines that the variants replace
OCC_MIN_BLOCKS = "constexpr int MIN_BLOCKS = 4; "
OCC_WINDOWS = "constexpr int WINDOWS = 8; "
OCC_LOAD_AT = "  const long long ia = base + lane;\n  const long long ib = ia + 32;"
OCC_VARIANTS = {
    "blocks_2": ([(OCC_MIN_BLOCKS, "constexpr int MIN_BLOCKS = 2; ")], True, None),
    "blocks_8": ([(OCC_MIN_BLOCKS, "constexpr int MIN_BLOCKS = 8; ")], True, None),
    "ept_8": ([(OCC_WINDOWS, "constexpr int WINDOWS = 4; ")], True, None),
    "ept_32": ([(OCC_WINDOWS, "constexpr int WINDOWS = 16; ")], True, None),
    # each lane reads its own 16 consecutive elements of the span, two
    # neighbours a window, as the parent's threads did: what coalescing
    # buys (the masks then mix positions, so the results are wrong)
    "x_thread_contiguous": ([(OCC_LOAD_AT, "  const long long ia = base - (base % SPAN) + "
                                           "lane * 2 * WINDOWS + 2 * ((base % SPAN) / 64);\n"
                                           "  const long long ib = ia + 1;")],
                            False, None),
}
# the parent's passes 1 and 3 with 72 KB of shared memory reserved, so at
# most 3 blocks (768 threads) an SM instead of up to 8: whether its
# per-thread loads thrash L1 (--parent only)
PARENT_PASS1 = "  occ_tile_summaries<W, PACKED><<<n_tiles, NT, 0, st>>>(words, gid, n, tile_f, tile_c);"
PARENT_VARIANTS = {
    "parent_3blocks": [
        (PARENT_PASS1, "  cudaFuncSetAttribute(occ_tile_summaries<W, PACKED>, "
                       "cudaFuncAttributeMaxDynamicSharedMemorySize, 72 * 1024);\n"
                       "  occ_tile_summaries<W, PACKED><<<n_tiles, NT, 72 * 1024, st>>>"
                       "(words, gid, n, tile_f, tile_c);"),
        ("  const int smem = n_bins * (int)sizeof(unsigned);",
         "  const int smem = n_bins * (int)sizeof(unsigned) + 72 * 1024;")],
}
# the extraction kernels' lines that the variants replace (both sources)
EX_NT = "constexpr int NT = 256; "
EX_BATCH = "constexpr int BATCH = 4; "
EX_VARIANTS = {
    # blocks of 128 or 512 threads: tiles of 2048 - 64 or 8192 - 64 windows
    "nt_128": ([(EX_NT, "constexpr int NT = 128; ")], True, None),
    "nt_512": ([(EX_NT, "constexpr int NT = 512; ")], True, None),
    # one gid load in flight per thread: what the batches buy
    "batch_1": ([(EX_BATCH, "constexpr int BATCH = 1; ")], True, None),
}
EXTRACT_VARIANTS = EX_VARIANTS
SWEEP_VARIANTS = EX_VARIANTS
# source, variants, C entry points, the kernel's name in a profiler trace
KERNELS = {
    "sort": ("radix_sort.cu", SORT_VARIANTS,
             ("radix_sort_tile_elems", "radix_sort_first_pass", "radix_sort_passes"), None),
    "scan": ("ksweep_scan.cu", SCAN_VARIANTS,
             ("ksweep_scan_tile_elems", "ksweep_scan_max_ks", "ksweep_scan_hist_bytes_max",
              "ksweep_scan_launch"), None),
    "occ": ("occ_scan.cu", OCC_VARIANTS,
            ("occ_scan_tile_elems", "occ_scan_bins_max", "occ_scan_launch"), None),
    "extract": ("extract_canonical.cu", EXTRACT_VARIANTS, ("extract_canonical_launch",),
                "extract_kernel"),
    "sweep": ("extract_sweep.cu", SWEEP_VARIANTS, ("extract_sweep_launch",), "sweep_tiles"),
}
# the declaration a parent's source must hold: occ's three-pass kernel
# (its own signature), or kernel A's committed one
PARENT_DECL = {
    "extract": 'extern "C" int extract_canonical_launch(const void* codes, long long n, int k,',
}
# the parent's occ_scan_launch: (words, gid, n, W, packed, cs, n_bins,
# tile_f, tile_c, carry, hist, stream), and the text that declares it
PARENT_OCC_DECL = "int packed, int cs, int n_bins, void* tile_f, void* tile_c,"
PARENT_OCC_SIGNATURE = (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
])


def build(tmp: str, kernel: str, parent: str | None = None) -> dict:
    """{name: ctypes library} for the committed source and each variant
    (and the parent's source, from `parent`), compiled in parallel."""
    from khoice_tpu_torch.kernels import _build

    source, variants, symbols, _ = KERNELS[kernel]
    src_path = os.path.join(CSRC, source)
    with open(src_path) as fd:
        committed = fd.read()
    sources = {"committed": committed}
    for name, (subs, _, _) in variants.items():
        src = committed
        for old, new in subs:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: the text it replaces is not in {src_path} once")
            src = src.replace(old, new)
        sources[name] = src
    include = {name: CSRC for name in sources}
    if parent:
        parent_csrc = os.path.join(parent, "khoice_tpu_torch", "csrc")
        with open(os.path.join(parent_csrc, source)) as fd:
            sources["parent"] = fd.read()
        decl = PARENT_DECL.get(kernel, PARENT_OCC_DECL)
        if sources["parent"].count(decl) != 1:
            raise SystemExit(f"--parent: {parent_csrc}/{source} does not declare the C "
                             f"signature this option calls ({decl!r})")
        include["parent"] = parent_csrc
        for name, subs in (PARENT_VARIANTS if kernel == "occ" else {}).items():
            src = sources["parent"]
            for old, new in subs:
                if src.count(old) != 1:
                    raise SystemExit(f"variant {name}: the text it replaces is not in the parent once")
                src = src.replace(old, new)
            sources[name] = src
            include[name] = parent_csrc
    procs = {}
    for name, src in sources.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as fd:
            fd.write(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", include[name], "-shared", "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out[-4000:]}")
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", out)})
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", out))
        print(f"{name}: ptxas {regs[0]}-{regs[-1]} registers, {spills} bytes spilled",
              flush=True)
        lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        for fn in symbols:
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        if name.startswith("parent") and kernel == "occ":
            lib.occ_scan_launch.restype, lib.occ_scan_launch.argtypes = PARENT_OCC_SIGNATURE
        libs[name] = lib
    return libs


def sort_shapes(dev) -> dict:
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


def scan_shapes(dev) -> dict:
    """{label: (the wrapper, its arguments)} at phase 3's scan shapes."""
    import chip_smoke
    from khoice_tpu_torch.engine.ksweep import _sweep_doubled, plan_sweep
    from khoice_tpu_torch.engine.occurrence import pack_members
    from khoice_tpu_torch.kernels import ksweep_scan

    rng = np.random.default_rng(0)
    bench = chip_smoke.random_members(rng, 8, 1 << 21)
    chip_smoke.random_members(rng, 96, 1 << 20)  # phase 3's next draw
    wide = chip_smoke.random_members(rng, 64, 1 << 16)
    groups = chip_smoke.random_members(rng, 4, 1 << 21)
    wide_c = chip_smoke.random_members(rng, 63, 1 << 15)
    pivot = np.concatenate([bench[0], np.tile(bench[0][1000:1060], 3000)])
    # 8 members sharing one ancestor, 1% SNPs each, as the generated
    # databases' groups (tools/gen_realistic_db.py): runs cross threads,
    # warps and tiles at every k
    ancestor = chip_smoke.random_members(rng, 1, 1 << 21)[0]
    related = []
    for _ in range(8):
        m = ancestor.copy()
        pos = rng.integers(0, m.shape[0], m.shape[0] // 100)
        m[pos] = rng.integers(0, 4, pos.shape[0], dtype=np.uint8)
        related.append(m)
    grid = chip_smoke.K_GRID
    out = {}
    for label, members, ks, mode, mp in (
            ("occ bench", bench, grid, "occ", None),
            ("occ 64 members", wide, grid, "occ", None),
            ("occ unpacked KW 2", bench, list(range(11, 32)), "occ", None),
            ("pivot_rest", bench, grid, "pivot_rest", 7),
            ("multi_pivot", bench, grid, "multi_pivot", 4),
            ("containment", bench + groups, grid, "containment", (8, 4)),
            ("buckets", [pivot] + bench[1:5], grid, "buckets", (4, 255)),
            ("containment 63", wide_c, grid, "containment", (42, 21)),
            ("occ related", related, grid, "occ", None),
            ("buckets related", related[:5], grid, "buckets", (4, 255))):
        classes, _rest = plan_sweep(ks, len(members))
        kmax, KW, cks, packed = classes[0]
        codes, gids = pack_members(members, dev)
        words, pay = _sweep_doubled(codes, gids, kmax, KW, packed)
        if mode == "occ":
            out[label] = (ksweep_scan.scan_multi_k, (words, pay, cks, len(members), 5000, packed))
        else:
            out[label] = (ksweep_scan.scan_classify, (words, pay, cks, mode, mp, packed))
    return out


def occ_shapes(dev) -> dict:
    """{label: (the wrapper, its arguments)} at phase 3's histogram shapes
    (the same draws of the same generator) and over 96 related members."""
    import chip_smoke
    from khoice_tpu_torch.engine.occurrence import _sorted_pairs, pack_members
    from khoice_tpu_torch.kernels import occ_scan

    rng = np.random.default_rng(0)
    chip_smoke.random_members(rng, 8, 1 << 21)
    members96 = chip_smoke.random_members(rng, 96, 1 << 20)
    members96[0] = np.concatenate([members96[0], np.zeros(100_000, np.uint8)])
    for count, length in ((64, 1 << 16), (4, 1 << 21), (63, 1 << 15), (1, 1 << 24)):
        chip_smoke.random_members(rng, count, length)
    rng.integers(0, 256, 1 << 24)
    members300 = chip_smoke.random_members(rng, 300, 1 << 16)
    ancestor = chip_smoke.random_members(rng, 1, 1 << 20)[0]
    related = []
    for _ in range(96):
        m = ancestor.copy()
        pos = rng.integers(0, m.shape[0], m.shape[0] // 100)
        m[pos] = rng.integers(0, 4, pos.shape[0], dtype=np.uint8)
        related.append(m)
    out = {}
    for label, members, k in (("B 96x2^20 k=31", members96, 31), ("B 96x2^20 k=49", members96, 49),
                              ("B related 96x2^20 k=31", related, 31)):
        codes, gids = pack_members(members, dev)
        out[label] = (occ_scan.occ_hist_packed, (_sorted_pairs(codes, gids, k, True)[0], 96, 5000))
    codes, gids = pack_members(members300, dev)
    keys, gid = _sorted_pairs(codes, gids, 31, False)
    out["C 300x2^16 k=31"] = (occ_scan.occ_hist, (keys, gid, 300, 5000))
    return out


def extract_shapes(dev) -> dict:
    """{label: (the wrapper, its arguments)} at phase 3's kernel-A shapes
    (the same draws of the same generators)."""
    import chip_smoke
    import khoice_tpu_torch.engine  # noqa: F401  (before kernels.extract, which it imports)
    from khoice_tpu_torch.kernels import extract

    rng = np.random.default_rng(0)
    chip_smoke.random_members(rng, 8, 1 << 21)
    chip_smoke.random_members(rng, 96, 1 << 20)
    for count, length in ((64, 1 << 16), (4, 1 << 21), (63, 1 << 15)):
        chip_smoke.random_members(rng, count, length)
    codes = torch.from_numpy(chip_smoke.random_members(rng, 1, 1 << 24)[0]).to(dev)
    gids = torch.from_numpy(rng.integers(0, 256, 1 << 24)).to(dev)
    out = {}
    for k in (7, 15, 16, 31, 32, 49, 63):
        out[f"A keys 2^24 k={k}"] = (extract.extract_canonical, (codes, k))
        if k <= 49:
            out[f"A packed 2^24 k={k}"] = (extract.extract_packed, (codes, gids, k))
    small = torch.from_numpy(chip_smoke.random_members(np.random.default_rng(12), 1,
                                                       2_000_000)[0]).to(dev)
    for k in (7, 15, 21, 31, 49):
        out[f"A keys 2.0M k={k}"] = (extract.extract_canonical, (small, k))
    return out


def sweep_shapes(dev) -> dict:
    """{label: (the wrapper, its arguments)} at phase 3's shapes of the
    sweep's extraction (the same draws of the same generator)."""
    import chip_smoke
    from khoice_tpu_torch.engine.occurrence import pack_members
    from khoice_tpu_torch.kernels import extract_sweep as kxs

    rng = np.random.default_rng(0)
    bench = chip_smoke.random_members(rng, 8, 1 << 21)
    members96 = chip_smoke.random_members(rng, 96, 1 << 20)
    members96[0] = np.concatenate([members96[0], np.zeros(100_000, np.uint8)])
    codes, gids = pack_members(bench, dev)
    d_codes = torch.cat([codes, torch.where(codes < 4, codes ^ 3, codes).flip(0)])
    chunk = d_codes[12345:12345 + (1 << 23) + 48]
    out = {
        "bench class (kmax 49, KW 4, packed)": (kxs.doubled_elements, (codes, gids, 49, 4, True)),
        "unpacked class (kmax 30, KW 2)": (kxs.doubled_elements, (codes, gids, 30, 2, False)),
        "streamed chunk (direct)": (kxs.extract_fwd_sweep, (
            chunk, torch.arange(chunk.shape[0], device=dev) % 8, 49, 4, True)),
    }
    codes, gids = pack_members(members96, dev)
    out["96x2^20 (kmax 30, KW 2)"] = (kxs.doubled_elements, (codes, gids, 30, 2, False))
    return out


def parent_occ(lib, words, *rest):
    """The parent's kernel B or C through its own C signature (its tile
    summaries, carries and hist), as its wrapper called it."""
    gid, n_bins, cs = (None, *rest) if len(rest) == 2 else rest
    W, n = words.shape
    dev = words.device
    hist = torch.zeros(n_bins, dtype=torch.int64, device=dev)
    n_tiles = (n + lib.occ_scan_tile_elems() - 1) // lib.occ_scan_tile_elems()
    tiles = [torch.empty(n_tiles, dtype=torch.int32, device=dev) for _ in range(3)]
    err = lib.occ_scan_launch(words.data_ptr(), None if gid is None else gid.data_ptr(), n, W,
                              int(gid is None), cs, n_bins, *(t.data_ptr() for t in tiles),
                              hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"parent occ_scan launch failed: CUDA error {err}")
    return hist


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="sort")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", help="a tree whose occ_scan.cu (--kernel occ) or "
                    "extract_canonical.cu (--kernel extract) is timed as 'parent'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke
    from khoice_tpu_torch.kernels import _build
    from khoice_tpu_torch.kernels import sort as ksort

    print(chip_smoke.smi_line(), flush=True)
    dev = torch.device("cuda")
    variants, profiled = KERNELS[args.kernel][1], KERNELS[args.kernel][3]
    load = _build.load
    load()  # the port's library: the shapes' extraction and sort kernels
    if args.kernel == "sort":
        cases = {label: (ksort.sort_words, inputs) for label, inputs in sort_shapes(dev).items()}
    elif args.kernel == "scan":
        cases = scan_shapes(dev)
    elif args.kernel == "occ":
        cases = occ_shapes(dev)
    elif args.kernel == "extract":
        cases = extract_shapes(dev)
    else:
        cases = sweep_shapes(dev)
    parent = args.parent if args.kernel in ("occ", "extract") else None
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, args.kernel, parent)
        if parent:
            variants = dict(variants, parent=([], True, None),
                            **{name: ([], True, None) for name in PARENT_VARIANTS
                               if args.kernel == "occ"})
        try:
            for label, (wrapper, inputs) in cases.items():
                run = ["committed"] + [n for n, (_, _, only) in variants.items()
                                       if only is None or label in only]
                times = {name: [] for name in run}
                want = None
                for order in (run, run[::-1]):
                    for name in order:
                        _build.load = lambda name=name: libs[name]
                        fn = (lambda *a, lib=libs[name]: parent_occ(lib, *a)) \
                            if name.startswith("parent") and args.kernel == "occ" else wrapper
                        got = fn(*inputs)
                        got = got if isinstance(got, tuple) else (got,)
                        torch.cuda.synchronize()
                        if want is None:
                            want = got
                        elif name != "committed" and variants[name][1] and not all(
                                g is None or torch.equal(g, w) for g, w in zip(got, want)):
                            raise AssertionError(f"variant {name} differs on {label}")
                        del got
                        times[name].append(chip_smoke.time_ms(lambda: fn(*inputs), args.reps))
                _build.load = lambda: libs["committed"]
                head = label
                if args.kernel == "sort":
                    wrapper(*inputs)
                    head = f"{label} ({len(ksort.last_plan[0])} passes)"
                device = {}
                if profiled:
                    for name in run:
                        _build.load = lambda name=name: libs[name]
                        device[name] = chip_smoke.device_ms(lambda: wrapper(*inputs), profiled,
                                                            args.reps)
                    _build.load = lambda: libs["committed"]
                print(f"{head}: " + ", ".join(
                    f"{name} {np.mean(t):.3f} ms ({t[0]:.3f} / {t[1]:.3f}"
                    + (f"; device {device[name]:.4f}" if device.get(name) else "") + ")"
                    for name, t in times.items()), flush=True)
                if args.kernel == "sort":
                    split = split_ms(wrapper, *inputs, args.reps)
                    print(f"  committed, ms per sort by kernel: "
                          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
                del want
        finally:
            _build.load = load


if __name__ == "__main__":
    main()
