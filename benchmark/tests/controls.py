"""The controls' readings: each cell's control (its traffic kind's
`Control`: the reference with canonical keys narrowed to 32-bit
fingerprints, reference/kmers.py `fold32`) put in the program's place and
run through the harness's own run and check (harness/core.run), so that
its `correct` and its compared numbers come out of the same code as a
real run's.  Each cell's control has to come out as not correct.

    python3 benchmark/tests/controls.py --cell exp1.4x8x5mbp --seeds 1,2,3

runs them at the cell's own size on the card and prints one JSON line per
seed; the CPU tests run them at a size a test run holds.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import core  # noqa: E402


def control_run(cell: str, seed: int, device, parts=None) -> dict:
    """The result line of one run of the cell's control: one pass, then
    the cell's check (`parts`: the cell's (configuration, mix, kind),
    where a test gives its own)."""
    cfg, mix, kind = parts or core.cell_parts(core.workload(cell))
    control = types.SimpleNamespace(Traffic=kind.Control)
    return core.run(cell, seed, 0.0, False, device, time.perf_counter(),
                    parts=(cfg, mix, control), out=io.StringIO(), err=io.StringIO())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result = control_run(args.cell, seed, torch.device(args.device))
        print(json.dumps({"cell": args.cell, "seed": seed, "control": "fold32",
                          "correct": result["correct"], "compared": result["compared"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
