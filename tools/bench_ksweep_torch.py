#!/usr/bin/env python3
"""The shared-sort k-sweep against the per-k fused path on the card:
exactness and time over the reference's 30-point k grid at the bench
shape (8 x 2^21 bases; the counterpart of tools/bench_ksweep.py).

    python tools/bench_ksweep_torch.py [--device cuda]

Each class of the sweep's plan runs alone (engine/ksweep.py::
sweep_class_hists: the sweep's extraction, one radix sort, one scan for
its ks), and the per-k path (engine/occurrence.py: kernel A, the radix
sort, kernel B) at every k of the grid; the two histograms must be equal
at every k.  Times are the best of REPS synchronized walls of each class
and of the whole per-k grid.  The last line is one JSON object.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from bench_torch import best_s
from khoice_tpu_torch.cli import _device
from khoice_tpu_torch.engine.ksweep import plan_sweep, sweep_class_hists
from khoice_tpu_torch.engine.occurrence import occurrence_histogram_packed, pack_members

N_GENOMES = 8
GENOME_LEN = 1 << 21
K_GRID = list(range(7, 31)) + [34, 37, 40, 43, 46, 49]
REPS = 3


def run(device) -> dict:
    """Times of each sweep class and of the per-k grid; raises unless the
    two give equal histograms at every k."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    members = [rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8) for _ in range(N_GENOMES)]
    codes, gids = pack_members(members, device)
    classes, rest = plan_sweep(K_GRID, N_GENOMES)
    if rest:
        raise ValueError(f"ks {rest} leave the sweep's plan")
    n_kmers = N_GENOMES * GENOME_LEN
    sweep, rows = {}, []
    for kmax, KW, cks, packed in classes:
        def sweep_class():
            return sweep_class_hists(codes, gids, N_GENOMES, kmax, KW, cks, packed, cx=16)

        sweep.update(sweep_class())
        t = best_s(sweep_class, device, REPS)
        rows.append({"kmax": kmax, "key_words": KW, "ks": len(cks), "packed": bool(packed),
                     "ms": t * 1e3, "mkmer_per_s": len(cks) * n_kmers / t / 1e6})
        print(f"class kmax={kmax} KW={KW} ks={len(cks)} packed={packed}: {t * 1e3:.3f} ms "
              f"({rows[-1]['mkmer_per_s']:.0f} Mkmer/s)", flush=True)
    def perk_grid():
        return {k: occurrence_histogram_packed((codes, gids), N_GENOMES, k, cx=16)
                for k in K_GRID}

    perk = perk_grid()
    t_perk = best_s(perk_grid, device, REPS)
    bad = [k for k in K_GRID if sweep[k] != perk[k]]
    if bad:
        raise AssertionError(f"sweep and per-k histograms differ at ks {bad}")
    t_sweep = sum(r["ms"] for r in rows) / 1e3
    out = {"n_positions": int(codes.shape[0]), "classes": rows,
           "sweep_ms": t_sweep * 1e3, "sweep_mkmer_per_s": len(K_GRID) * n_kmers / t_sweep / 1e6,
           "perk_ms": t_perk * 1e3, "perk_mkmer_per_s": len(K_GRID) * n_kmers / t_perk / 1e6,
           "exact": True}
    print(f"TOTAL grid: sweep {out['sweep_ms']:.3f} ms ({out['sweep_mkmer_per_s']:.0f} "
          f"Mkmer/s), per-k {out['perk_ms']:.3f} ms ({out['perk_mkmer_per_s']:.0f} Mkmer/s); "
          f"equal at all {len(K_GRID)} ks", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    print(json.dumps(run(_device(ap.parse_args(argv).device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
