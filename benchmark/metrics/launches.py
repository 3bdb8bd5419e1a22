"""Kernel launches per pass, summed from the kernel wrappers' `launches`
counters (one per launch of a hand-written kernel; the plain versions
on the CPU count none)."""

import sys

COUNTERS = [
    ("khoice_tpu_torch.kernels.sort", "launches"),
    ("khoice_tpu_torch.kernels.ksweep_scan", "launches"),
    ("khoice_tpu_torch.kernels.extract", "launches"),
    ("khoice_tpu_torch.kernels.extract_sweep", "launches"),
    ("khoice_tpu_torch.kernels.occ_scan", "launches"),
    ("khoice_tpu_torch.kernels.vote", "launches"),
]


def read(rec):
    lost = [f"{m}.{a}" for m, a in COUNTERS if f"{m}.{a}" in rec.missing]
    if lost:
        print(f"[bench] launches: not found: {', '.join(lost)}", file=sys.stderr)
        return None
    return rec.per_pass(sum(rec.recorder.counter_deltas.values()))
