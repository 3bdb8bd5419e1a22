#!/usr/bin/env python3
"""On-card exactness gate of the PyTorch/CUDA port (the counterpart of
tools/hw_check.py).

    python tools/hw_check_torch.py

On the adversarial data of tools/hw_check.py (8 members sharing a mutated
core, an N run, a poly-A block; numpy's default_rng(3)) it holds, on the
card:
  1. every k of the reference's 30-point grid: the shared-sort sweep
     (engine/ksweep.py: the sweep's extraction, the radix sort and the
     multi-k scan kernel) bit-identical to the independent per-k fused
     path (engine/occurrence.py: kernel A, the radix sort, kernel B);
  2. the four classification modes of the scan kernel (pivot_rest,
     multi_pivot, containment, buckets) on one sorted doubled text,
     bit-identical to the plain scan (kernels/ksweep_scan.py), raw
     (doubled and palindromic) stats at every k.
Each kernel's launch counter must move, so a path that never reached a
kernel fails.  Exit 0 when all agree, 1 on any mismatch, 2 without a
CUDA device: the CPU runs only the plain versions, which the CPU tests
already hold to the JAX package.  `check(device)` runs the comparisons on
any device.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from bench_torch import launch_counts
from khoice_tpu_torch.engine.ksweep import (
    _sweep_doubled,
    occurrence_histograms_sweep_packed,
    plan_sweep,
)
from khoice_tpu_torch.engine.occurrence import occurrence_histogram_packed, pack_members
from khoice_tpu_torch.kernels.ksweep_scan import scan_classify, scan_classify_reference

N_GENOMES = 8
K_GRID = list(range(7, 31)) + [34, 37, 40, 43, 46, 49]
CLASSIFY_KS = (8, 11, 16, 22, 31, 34, 49)  # one master class across word widths


def gate_members(rng, n_genomes=N_GENOMES, core_len=200_000, tail_len=50_000,
                 polya_len=5000, mutations=3000, n_run=(1000, 1400)):
    """tools/hw_check.py's members: a shared core with member-specific
    mutations, an N run, a poly-A block and an own tail."""
    core = rng.integers(0, 4, size=core_len, dtype=np.uint8)
    members = []
    for m in range(n_genomes):
        g = core.copy()
        idx = rng.integers(0, g.shape[0], size=mutations * (m + 1))
        g[idx] = rng.integers(0, 4, size=idx.shape[0])
        g[n_run[0]:n_run[1]] = 4  # N run
        tail = rng.integers(0, 4, size=tail_len, dtype=np.uint8)
        members.append(np.concatenate([g, np.zeros(polya_len, np.uint8), tail]))
    return members


def classify_members(rng, core_len=60_000, own_len=20_000, mutations=800):
    """tools/hw_check.py's classification members: 4 mutants of one core,
    each with its own tail; member 0 doubles as pivot and query."""
    core = rng.integers(0, 4, size=core_len, dtype=np.uint8)
    members = []
    for m in range(4):
        g = core.copy()
        idx = rng.integers(0, g.shape[0], size=mutations * (m + 1))
        g[idx] = rng.integers(0, 4, size=idx.shape[0])
        members.append(np.concatenate([g, rng.integers(0, 4, size=own_len, dtype=np.uint8)]))
    return members


def sweep_vs_perk(members, k_grid, device):
    """({k: sweep histogram}, {k: per-k histogram}) over the packed members."""
    packed = pack_members(members, device)
    n = len(members)
    sweep = occurrence_histograms_sweep_packed(packed, n, k_grid, cs=5000, cx=16)
    perk = {k: occurrence_histogram_packed(packed, n, k, cs=5000, cx=16) for k in k_grid}
    return sweep, perk


def hist_mismatches(sweep, perk):
    """The ks whose two histograms differ, each printed."""
    bad = [k for k in perk if sweep[k] != perk[k]]
    for k in bad:
        print(f"MISMATCH k={k}: {sweep[k][:10]} vs {perk[k][:10]}")
    return bad


def classify_kernel_vs_plain(members, device):
    """{mode: (kernel's raw stats, plain scan's)} of the four
    classification modes on ONE sorted doubled text of the members."""
    classes, rest = plan_sweep(CLASSIFY_KS, len(members))
    if rest or len(classes) != 1:
        raise ValueError(f"{CLASSIFY_KS} must plan as one class, got {classes} + {rest}")
    kmax, KW, cks, packed = classes[0]
    codes, gids = pack_members(members, device)
    skeys, spay = _sweep_doubled(codes, gids, kmax, KW, packed)
    modes = {"pivot_rest": 3, "multi_pivot": 2, "containment": (2, 2), "buckets": (3, 7)}
    return {mode: (scan_classify(skeys, spay, cks, mode, p, packed),
                   scan_classify_reference(skeys, spay, cks, mode, p, packed))
            for mode, p in modes.items()}


def classify_mismatches(results):
    """The modes whose kernel and plain stats differ, each printed."""
    bad = [mode for mode, (got, want) in results.items() if not torch.equal(got, want)]
    for mode in bad:
        print(f"MISMATCH classify mode {mode} (kernel vs plain scan on the device)")
    return bad


def check(device, members=None, cls_members=None) -> int:
    """The number of mismatches of both comparisons on `device` (the
    gate's data unless members are given)."""
    device = torch.device(device)
    rng = np.random.default_rng(3)
    members = gate_members(rng) if members is None else members
    before = launch_counts()
    bad = hist_mismatches(*sweep_vs_perk(members, K_GRID, device))
    print(f"OK all {len(K_GRID)} ks bit-identical" if not bad else f"{len(bad)} mismatches")
    cls_members = classify_members(rng) if cls_members is None else cls_members
    bad_cls = classify_mismatches(classify_kernel_vs_plain(cls_members, device))
    print("OK classify modes device-identical" if not bad_cls
          else f"{len(bad_cls)} classify-mode mismatches")
    after = launch_counts()
    if device.type == "cuda":
        idle = [name for name in after if after[name] == before[name]]
        if idle:
            raise RuntimeError(f"no launch of {idle}: the gate did not reach those kernels")
        print("launches: " + ", ".join(f"{n} {after[n] - before[n]}" for n in after))
    return len(bad) + len(bad_cls)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: the kernels this gate exists to exercise are not in "
              "play (the CPU tests already hold the plain versions)")
        return 2
    return 1 if check("cuda") else 0


if __name__ == "__main__":
    sys.exit(main())
