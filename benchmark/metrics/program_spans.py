"""The program's own spans in the traced run's chrome trace.

While a profiler records, khoice_tpu_torch opens a `record_function`
span at each layer boundary (khoice_tpu_torch/utils/trace.py), named
`<layer>:<what>` after PERF.md's layers; the trace holds them as
`user_annotation` events beside the benchmark's own (dotted) labels, on
the device's clock.  A program that opens none gives None here, and the
readers built on it read nothing.
"""

LAYERS = ("cli", "pipeline", "io", "reports", "engine", "kernel")
# where the host waits on the device's stream: uploads from pageable
# memory, reads back, the radix sort's first pass and plan
SYNCS = ("engine:upload", "engine:readback", "kernel:sort_plan")


def is_program(name: str) -> bool:
    layer, colon, _what = name.partition(":")
    return bool(colon) and layer in LAYERS


def spans(rec):
    """The trace's program spans, or None where it has none."""
    if rec.trace is None:
        return None
    found = [e for e in rec.trace.spans if is_program(e.get("name", ""))]
    return found or None


def outermost_seconds(events, names) -> float:
    """Seconds covered by the events named in `names` (the union of their
    intervals: a span inside another of them counts once)."""
    ivs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("name") in names)
    total, end = 0.0, float("-inf")
    for s, e in ivs:
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e6
