"""A tiny cell for the benchmark's CPU tests: 2 species x 3 genomes of
60 kbp, four ks (a sweep class and a k left to the per-k path), drawn
from the real configuration's file with only the sizes changed."""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import core  # noqa: E402

TINY = dict(num_datasets=2, genomes_per_dataset=3, genome_mbp=0.06, k_values=[11, 21, 31, 35],
            kmers_per_dataset=2000)
CELLS = {"exp1.4x8x5mbp": "exp1_loop", "ksweep.4x8x5mbp": "sweep_loop",
         "exp6.4x8x5mbp": "exp6_loop"}


def parts(cell: str, **sizes):
    wl = core.workload(cell)
    cfg = core.load_json(os.path.join(core.BENCH_DIR, "configs", f"{wl['config']}.json"))
    cfg.update(TINY, **sizes)
    mix = core.load_json(os.path.join(core.BENCH_DIR, "traffic", f"{wl['traffic']}.json"))
    kind = core.load_module(os.path.join(core.BENCH_DIR, "traffic", f"{mix['kind']}.py"),
                            f"tiny_{mix['kind']}")
    return cfg, mix, kind


def run_tiny(cell: str, seed: int = 2**31 + 11, seconds: float = 0.5, traced: bool = False,
             out=None, err=None, **sizes):
    torch.set_num_threads(1)
    return core.run(cell, seed, seconds, traced, torch.device("cpu"), time.perf_counter(),
                    parts=parts(cell, **sizes), out=out, err=err)
