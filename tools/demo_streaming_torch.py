#!/usr/bin/env python3
"""Bounded-memory streaming on the card: an exp1 group larger than a
device budget (the counterpart of tools/demo_streaming.py).

    python tools/demo_streaming_torch.py [--mbp-per-member 50] [--members 6]
        [--budget-gb 6] [--ks 7,13,21,31,49] [--try-incore] [--device cuda]

KMC's defining capability is counting inputs of any size in fixed memory
(`kmc -m64`, reference exp_type_1.smk:163).  The group (numpy's
default_rng(11): members sharing half their bases, with divergence
sprinkled into the shared half) goes through
engine/streaming.py::occurrence_histograms_sweep_streaming twice: under
the budget and under half of it.  The budget must be below the in-core
sweep's estimate (engine/streaming.py::incore_sweep_bytes), so both runs
stream, in two different decompositions (chunks, key-range groups), and
their histograms must be identical: exactness across partitions (the CPU
tests hold the streaming sweep to the JAX package's in-core sweep).  It
prints each run's wall, its plan and its peak device memory beside the
budget (a peak over it fails), the in-core estimate and the card's
memory.  --try-incore also runs the in-core sweep after the budget check of the default budget
(~85% of the card): on an 80 GB card the default group fits, which is
printed as such; otherwise DeviceBudgetExceeded is printed.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from khoice_tpu_torch.cli import _device
from khoice_tpu_torch.engine.ksweep import occurrence_histograms_sweep, plan_sweep
from khoice_tpu_torch.engine.streaming import (
    DeviceBudgetExceeded,
    _stream_plan,
    check_incore_budget,
    default_device_budget_bytes,
    incore_sweep_bytes,
    occurrence_histograms_sweep_streaming,
)


def demo_members(n_members: int, n_per: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 4, size=n_per // 2, dtype=np.uint8)
    members = []
    for _ in range(n_members):
        own = rng.integers(0, 4, size=n_per - core.shape[0], dtype=np.uint8)
        m = np.concatenate([core, own])
        # sprinkle divergence into the shared core region
        pos = rng.integers(0, core.shape[0], size=n_per // 200)
        m[pos] = rng.integers(0, 4, size=pos.shape[0], dtype=np.uint8)
        members.append(m)
    return members


def stream_plan(members, ks, budget: int):
    """(chunk elements, chunks, key-range groups, cap, groups per pass) of
    the group's first packed class under `budget` (the streaming sweep's
    own plan)."""
    kmax, KW, cks, _packed = plan_sweep(ks, len(members))[0][0]
    total = 2 * sum(int(m.shape[0]) + 1 for m in members)
    return _stream_plan(total, KW, kmax - 1, min(cks), budget)


def _peak(device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def demo(members, ks, budget: int, device, try_incore: bool = False) -> dict:
    """Stream the group under `budget` and under half of it; raises unless
    both stream (the budget under the in-core estimate, two different
    plans) and their histograms are identical."""
    device = torch.device(device)
    positions = sum(int(m.shape[0]) + 1 for m in members)
    incore = incore_sweep_bytes(positions, ks, len(members))
    if budget >= incore:
        raise ValueError(f"budget {budget} B is not below the in-core estimate {incore} B: "
                         "the group would not need to stream")
    plans = [stream_plan(members, ks, b) for b in (budget, budget // 2)]
    if plans[0] == plans[1]:
        raise ValueError(f"the budget and its half give one plan {plans[0]}")
    out = {"positions": positions, "budget_bytes": budget, "incore_estimate_bytes": incore,
           "device_total_bytes": (torch.cuda.get_device_properties(device).total_memory
                                  if device.type == "cuda" else None)}
    print(f"group: {len(members)} x {members[0].shape[0] / 1e6:g} Mbp = {positions / 1e6:g}M "
          f"positions; in-core sweep estimate {incore / 2**30:.2f} GiB; budget "
          f"{budget / 2**30:.3f} GiB; device {out['device_total_bytes']} B", flush=True)

    if try_incore:
        _reset_peak(device)
        try:
            check_incore_budget(positions, ks, len(members), default_device_budget_bytes(device),
                                "in-core sweep", device)
            t0 = time.perf_counter()
            occurrence_histograms_sweep(members, ks, device, cx=8)
            out["incore"] = {"wall_s": time.perf_counter() - t0, "peak_bytes": _peak(device)}
            print(f"in-core sweep fits this device's default budget and SUCCEEDED: "
                  f"{json.dumps(out['incore'])}", flush=True)
        except DeviceBudgetExceeded as exc:
            out["incore"] = f"DeviceBudgetExceeded: {exc}"
            print(f"in-core sweep refused: {out['incore'][:300]}", flush=True)

    hists, runs = [], []
    for b, plan in zip((budget, budget // 2), plans):
        _reset_peak(device)
        t0 = time.perf_counter()
        hists.append(occurrence_histograms_sweep_streaming(members, ks, device, cx=8,
                                                           device_budget_bytes=b))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        runs.append({"budget_bytes": b, "wall_s": time.perf_counter() - t0,
                     "peak_bytes": _peak(device),
                     "plan": dict(zip(("chunk_elems", "chunks", "groups", "cap",
                                       "groups_per_pass"), plan))})
        print(f"streaming run under {b / 2**30:.3f} GiB: {json.dumps(runs[-1])}", flush=True)
        if device.type == "cuda" and runs[-1]["peak_bytes"] > b:
            raise AssertionError(f"the streamed run's peak {runs[-1]['peak_bytes']} B is over "
                                 f"its budget {b} B")
    bad = [k for k in ks if hists[0][k] != hists[1][k]]
    if bad:
        raise AssertionError(f"partition self-consistency: MISMATCH at ks {bad}")
    print("partition self-consistency: OK", flush=True)
    out.update(runs=runs, hists=hists[0])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mbp-per-member", type=float, default=50.0)
    ap.add_argument("--members", type=int, default=6)
    ap.add_argument("--budget-gb", type=float, default=6.0)
    ap.add_argument("--ks", default="7,13,21,31,49")
    ap.add_argument("--try-incore", action="store_true",
                    help="also run the in-core sweep after the default budget's check")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = _device(args.device)
    ks = [int(x) for x in args.ks.split(",")]
    members = demo_members(args.members, int(args.mbp_per_member * 1e6))
    out = demo(members, ks, int(args.budget_gb * 2**30), device, args.try_incore)
    hists = out.pop("hists")
    out["hist_head"] = {k: hists[k][:args.members] for k in ks}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
