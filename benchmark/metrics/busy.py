# Copied from tools/profile_torch_sweep.py::device_busy_us (with its DEVICE_CATS).
"""Device busy time from a chrome trace of torch.profiler."""

# chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_us(trace_events) -> dict:
    """Device time of a chrome trace's events: `busy_us` is the union of
    the kernel, memcpy and memset intervals (overlapping intervals, as
    from concurrent streams, count once); `sum_us` adds their durations
    as they are."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in trace_events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"busy_us": busy, "sum_us": sum(e - s for s, e in spans), "events": len(spans)}
