"""The traced run's profiler and what is read from its chrome trace.

torch.profiler records the host (with the benchmark's spans as
`record_function` annotations, on the same clock as the device) and the
device (kernels, copies, sets) over the window.  From the trace: device
seconds by kernel name, the device's busy seconds (the union of its
intervals, metrics/busy.py), and the breakdown: the device operations
that took most time and the idle gaps by the innermost span open on the
host at the time.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict

from benchmark.metrics.busy import DEVICE_CATS, device_busy_us

PASS = "pass"  # the annotation around every pass of the window
NO_SPAN = "no span"


def short_name(name: str) -> str:
    """A kernel's function name without its return type, template and
    parameters."""
    name = re.sub(r"^void ", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0][:100] or name[:100]


class Profile:
    """torch.profiler over the window; `events` once stopped."""

    def __init__(self, device, tmp: str):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.path = os.path.join(tmp, "window_trace.json")
        self.prof = profile(activities=acts)
        self.events = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.prof.export_chrome_trace(self.path)
            with open(self.path) as fd:
                self.events = [e for e in json.load(fd)["traceEvents"] if e.get("ph") == "X"]
            os.remove(self.path)
        return False


class Trace:
    """What the readers and the result line take from the events."""

    def __init__(self, events):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.spans = [e for e in events if e.get("cat") == "user_annotation"]
        self.busy_s = device_busy_us(self.device)["busy_us"] / 1e6

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name holds one of `names`."""
        return sum(float(e["dur"]) for e in self.device
                   if e.get("cat") == "kernel" and any(n in e.get("name", "") for n in names)) / 1e6

    def device_ops(self, top: int = 10):
        by = defaultdict(float)
        for e in self.device:
            by[short_name(e.get("name", "?"))] += float(e["dur"]) / 1e6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10):
        """[[span, idle seconds]]: the window's time with nothing on the
        device, by the innermost benchmark span open on the host then."""
        passes = [e for e in self.spans if e.get("name") == PASS]
        if not passes:
            return []
        t0 = min(float(e["ts"]) for e in passes)
        t1 = max(float(e["ts"]) + float(e["dur"]) for e in passes)
        segs = innermost_segments(
            [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in self.spans],
            t0, t1)
        by = defaultdict(float)
        j = 0
        for a, b in idle_intervals(self.device, t0, t1):
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            i = j
            while i < len(segs) and segs[i][0] < b:
                s, e, label = segs[i]
                by[label] += (min(b, e) - max(a, s)) / 1e6
                i += 1
        return sorted(([n, s] for n, s in by.items() if s > 0), key=lambda x: -x[1])[:top]


def idle_intervals(device_events, t0: float, t1: float):
    """The sub-intervals of [t0, t1] (trace microseconds) in which no
    device event runs, in order."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device_events)
    out, cur = [], t0
    for s, e in spans:
        if e <= cur:
            continue
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def innermost_segments(spans, t0: float, t1: float):
    """[(start, end, label)] covering [t0, t1] in order, each piece labelled
    by the innermost of the nested spans (start, end, label) open then,
    NO_SPAN where none is."""
    segs, cur = [], t0
    stack = [(t1, NO_SPAN)]

    def emit(end, label):
        nonlocal cur
        end = min(end, t1)
        if end > cur:
            segs.append((cur, end, label))
            cur = end

    for s, e, label in sorted(spans, key=lambda x: (x[0], -x[1])):
        if e <= t0 or s >= t1:
            continue
        while stack[-1][0] <= s:
            emit(*stack.pop())
        emit(max(s, t0), stack[-1][1])
        stack.append((min(e, stack[-1][0]), label))
    while stack:
        emit(*stack.pop())
    return segs
