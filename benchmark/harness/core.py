"""One run of one cell: set-up, the measured window, the check, the result.

Everything specific to a cell is found by name: the cell is its entry in
BENCHMARK.json's `workloads`; its configuration is
`benchmark/configs/<config>.json`; its traffic mix is
`benchmark/traffic/<traffic>.json`, whose `kind` names the generator
`benchmark/traffic/<kind>.py`; each metric is read by
`benchmark/metrics/<metric>.py`.  The metrics a run reports are
BENCHMARK.json's: with trace off the cell's end-to-end metrics, with
trace on its per-layer metrics (a metric with a `workloads` key is
the cell's when the key names it).

The window is a closed loop: passes run back to back until `seconds`
are spent; the pass under way at the deadline finishes and counts, and
the window is timed to its end.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

from benchmark.harness import spans as spans_mod
from benchmark.harness import trace as trace_mod

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "khoice_tpu")


def load_json(path: str) -> dict:
    with open(path) as fd:
        return json.load(fd)


def spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str, bench: dict | None = None) -> dict:
    for wl in (bench or spec())["workloads"]:
        if wl["name"] == name:
            return wl
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_module(path: str, name: str):
    if not os.path.isfile(path):
        raise SystemExit(f"{path} not found")
    module_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(mod)
    return mod


def cell_parts(wl: dict):
    """(configuration, traffic mix, traffic kind module) of a workload."""
    cfg = load_json(os.path.join(BENCH_DIR, "configs", f"{wl['config']}.json"))
    mix = load_json(os.path.join(BENCH_DIR, "traffic", f"{wl['traffic']}.json"))
    kind = load_module(os.path.join(BENCH_DIR, "traffic", f"{mix['kind']}.py"),
                       f"benchmark_traffic_{mix['kind']}")
    return cfg, mix, kind


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str):
    """The reader of metric `name`: metrics/<name>.py, or for a name
    `<base>.<suffix>` without a file of its own, metrics/<base>.py."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.isfile(path) and "." in name:
        path = os.path.join(BENCH_DIR, "metrics", f"{name.rsplit('.', 1)[0]}.py")
    return load_module(path, "benchmark_metric_" + name.replace(".", "_"))


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX package's,
    compared as whole names (khoice_tpu_torch is not khoice_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else "not read"


class Record:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def per_pass(self, value):
        return None if value is None or not self.passes else value / self.passes

    def span_seconds(self, label: str, reader_spans: dict):
        """Seconds in the span `label`, or None (with a line saying why)
        where a name it wraps was not found."""
        lost = [f"{m}.{a}" for m, a in reader_spans[label] if f"{m}.{a}" in self.missing]
        if lost:
            print(f"[bench] span {label}: not found: {', '.join(lost)}", file=sys.stderr)
            return None
        return self.recorder.seconds.get(label, 0.0)


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _install(recorder, readers: dict, kind) -> None:
    for r in readers.values():
        for label, names in getattr(r, "SPANS", {}).items():
            for module, attr in names:
                recorder.wrap(label, module, attr)
        for label, names in getattr(r, "CALLS", {}).items():
            for module, attr in names:
                recorder.wrap(label, module, attr, capture=True)
        for module, attr in getattr(r, "COUNTERS", []):
            recorder.watch(module, attr)
    for label, names in getattr(kind, "LABELS", {}).items():
        for module, attr in names:
            recorder.wrap(label, module, attr)


def run(cell: str, seed: int, seconds: float, traced: bool, device, t_start: float,
        bench: dict | None = None, parts=None, out=None, err=None) -> dict:
    """Run one cell once (`parts`: its (configuration, mix, kind), where a
    test gives its own).  Prints the per-pass line and the result line to
    `out` (stdout), the compared numbers with their limits last to `err`
    (stderr), and returns the result line's object; None (nothing
    printed) where a module of JAX or of the JAX package was loaded."""
    import torch

    out = out or sys.stdout
    err = err or sys.stderr
    bench = bench or spec()
    wl = workload(cell, bench)
    cfg, mix, kind = parts or cell_parts(wl)
    entries = cell_metrics(bench, cell, traced)
    readers = {m["name"]: load_reader(m["name"]) for m in entries}
    cuda = device.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="khoice_bench_")
    try:
        ctx = types.SimpleNamespace(config=cfg, mix=mix, seed=seed, device=device, tmp=tmp)
        traffic = kind.Traffic(ctx)
        _sync(device)
        peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)

        recorder = spans_mod.Recorder(annotate=traced)
        profile = None
        if traced:
            _install(recorder, readers, kind)
            profile = trace_mod.Profile(device, tmp).__enter__()
        walls = []
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        try:
            while True:
                a = time.perf_counter()
                with recorder.annotation(trace_mod.PASS):
                    traffic.run_pass(len(walls))
                    _sync(device)
                b = time.perf_counter()
                walls.append(b - a)
                if b - t0 >= seconds:
                    break
            window_s = b - t0
            peak_window = torch.cuda.max_memory_allocated(device) if cuda else None
        finally:
            if profile is not None:
                profile.__exit__(*sys.exc_info())
            recorder.restore()
        recorder.read_counters()
        trace = trace_mod.Trace(profile.events) if traced else None
        work = traffic.work()
        failed = traffic.failed()
        traffic.release()
        if cuda:
            torch.cuda.empty_cache()
        compared = traffic.check()
        del traffic
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rec = Record(setup_s=setup_s, window_s=window_s, passes=len(walls), walls=walls, work=work,
                 peak_bytes=peak_window, recorder=recorder, missing=recorder.missing,
                 trace=trace, device=device)
    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(rec)
        if value is None:
            print(f"[bench] {m['name']}: nothing to read in this run", file=err)
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"[bench] modules of JAX or the JAX package were loaded: {', '.join(bad)}",
              file=err)
        return None

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": int(wl.get("chips", 1)),
           "memory_peak_bytes": int(max(peak_setup or 0, peak_window or 0))}
    limit = power_limit() if cuda else "not read"
    result = {"correct": all(v <= lim for v, lim in compared.values()),
              "attempted": len(walls), "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    result["compared"] = {name: {"value": v, "limit": lim} for name, (v, lim) in compared.items()}
    print(json.dumps({"cell": cell, "seed": seed, "card": limit, "setup_s": setup_s,
                      "window_s": window_s, "pass_walls_s": walls, "work": work,
                      "spans_s": dict(recorder.seconds), "counters": recorder.counter_deltas}),
          file=out)
    for name, (v, lim) in compared.items():
        print(f"compared {name} {v} limit {lim}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return result
