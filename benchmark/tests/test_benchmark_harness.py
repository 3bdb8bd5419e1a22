"""The harness's own arithmetic on the CPU: parts found by name, the
roofline byte counts, the busy union, the window's closed loop, the
whole-name check for JAX and the JAX package."""

import io
import json
import sys
import time
import types

import pytest
import torch

from bench_tiny import core  # noqa: F401  (puts the checkout on sys.path)
from benchmark.harness import spans, trace
from benchmark.metrics import busy, roofline


def test_every_part_is_found_by_name():
    bench = core.spec()
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert len(names) == len(bench["end_to_end"]) + len(bench["per_layer"])
    for wl in bench["workloads"]:
        cfg, mix, kind = core.cell_parts(wl)
        assert cfg["name"] == wl["config"]
        assert hasattr(kind, "Traffic")
        for traced in (False, True):
            entries = core.cell_metrics(bench, wl["name"], traced)
            assert entries, (wl["name"], traced)
            for m in entries:
                assert callable(core.load_reader(m["name"]).read)
        e2e = {m["name"] for m in core.cell_metrics(bench, wl["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
    for c in bench["configs"]:
        assert core.load_json(core.os.path.join(core.ROOT, c["file"]))["name"] == c["name"]


@pytest.mark.parametrize("W,n,payload,want", [
    (4, 1000, False, 2 * 1000 * 16),      # the sweep's packed 4-word class
    (2, 1000, True, 2 * 1000 * 12),       # 2 words and a 32-bit payload
    (3, 7, False, 2 * 7 * 12),
])
def test_sort_bytes(W, n, payload, want):
    assert roofline.sort_bytes(W, n, payload) == want
    words = torch.zeros(W, n, dtype=torch.int64)
    pay = torch.zeros(n, dtype=torch.int64) if payload else None
    assert roofline.sort_call_bytes(spans.summarize((words, pay))) == want


def test_scan_bytes():
    # 100 elements of 4 words, packed: 1600 B read; 30 ks x 8 bins x 2 histograms x 8 B written
    assert roofline.scan_bytes(4, 100, False, 30, 8) == 1600 + 3840
    words = torch.zeros(2, 100, dtype=torch.int64)
    args = spans.summarize((words, torch.zeros(100, dtype=torch.int64), [7, 8, 9], "occ",
                            8, 5000, 8, False))
    assert roofline.scan_call_bytes(args) == 100 * 12 + 2 * 3 * 8 * 8


def test_roofline_share():
    assert roofline.share(int(3.35e12), 1.0) == pytest.approx(100.0)
    assert roofline.share(int(3.35e12), 4.0) == pytest.approx(25.0)
    assert roofline.share(100, 0.0) is None


def _ev(ts, dur, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


def test_busy_union():
    events = [_ev(0, 10), _ev(5, 10), _ev(30, 5, "gpu_memcpy"), _ev(32, 1, "gpu_memset"),
              _ev(0, 100, "cpu_op")]
    got = busy.device_busy_us(events)
    assert got["busy_us"] == 20.0  # [0, 15] and [30, 35]
    assert got["sum_us"] == 26.0 and got["events"] == 4


def test_idle_gaps_by_innermost_span():
    events = [_ev(0, 100, "user_annotation", trace.PASS),
              _ev(10, 40, "user_annotation", "io"),
              _ev(20, 10, "user_annotation", "io.inner"),
              _ev(0, 10), _ev(50, 30)]
    t = trace.Trace(events)
    gaps = dict(t.idle_gaps())
    # idle: [10, 50] (io 10-20 and 30-50, io.inner 20-30) and [80, 100] (the pass)
    assert gaps == pytest.approx({"io": 30e-6, "io.inner": 10e-6, trace.PASS: 20e-6})
    assert t.busy_s == pytest.approx(40e-6)
    assert t.device_ops() == [["k", pytest.approx(40e-6)]]


def test_short_kernel_names():
    assert trace.short_name("void first_pass_kernel<4, true>(long const*, int)") == \
        "first_pass_kernel"


class _SleepTraffic:
    """A pass of 0.3 s: the window of 0.8 s ends inside the third."""

    def __init__(self, ctx):
        self.n = 0

    def run_pass(self, i):
        time.sleep(0.3)
        self.n += 1

    def work(self):
        return {"kmers": 10**6 * self.n}

    def failed(self):
        return 0

    def release(self):
        pass

    def check(self):
        return {"answers_off": (0, 0)}


def test_window_closes_after_the_pass_under_way():
    bench = {"workloads": [{"name": "sleepy", "config": "c", "traffic": "t", "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"}, {"name": "exp_s", "unit": "s"},
                            {"name": "sweep_kmers_per_s", "unit": "Mkmer/s"}],
             "per_layer": []}
    kind = types.SimpleNamespace(Traffic=_SleepTraffic)
    out, err = io.StringIO(), io.StringIO()
    t_start = time.perf_counter() - 1.5
    r = core.run("sleepy", 1, 0.8, False, torch.device("cpu"), t_start, bench=bench,
                 parts=({}, {}, kind), out=out, err=err)
    walls = json.loads(out.getvalue().splitlines()[0])
    assert r["attempted"] == 3 and len(walls["pass_walls_s"]) == 3
    window = walls["window_s"]
    assert 0.9 <= window < 1.2  # the third pass, under way at 0.8 s, finishes and counts
    assert r["metrics"]["exp_s"]["value"] == pytest.approx(window / 3)
    assert r["metrics"]["sweep_kmers_per_s"]["value"] == pytest.approx(3 / window)
    assert r["metrics"]["setup_s"]["value"] >= 1.5
    assert r["correct"] is True
    assert list(r)[-1] == "compared"
    assert err.getvalue().splitlines()[-1] == "compared answers_off 0 limit 0"


@pytest.mark.parametrize("name,flagged", [
    ("khoice_tpu_torch.engine.ksweep", False), ("khoice_tpu_torch", False),
    ("khoice_tpu", True), ("khoice_tpu.engine.ksweep", True), ("jax.numpy", True),
    ("jaxlib", True), ("flax.linen", True), ("jaxtyping", False), ("jax_fake_x", False),
])
def test_forbidden_modules_compares_whole_names(monkeypatch, name, flagged):
    for m in [m for m in sys.modules if m.split(".")[0] in core.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bool(core.forbidden_modules()) is flagged


def test_span_wrapper_counts_outermost_calls_and_restores():
    mod = types.ModuleType("bench_fake_mod")

    def f(n):
        return mod.f(n - 1) + 1 if n else 0

    mod.f = f
    sys.modules["bench_fake_mod"] = mod
    try:
        rec = spans.Recorder(annotate=False)
        rec.wrap("f", "bench_fake_mod", "f", capture=True)
        rec.wrap("g", "bench_fake_mod", "missing_name")
        assert mod.f(3) == 3
        assert len(rec.args["f"]) == 4 and rec.seconds["f"] > 0
        assert rec.missing == {"bench_fake_mod.missing_name"}
        rec.restore()
        assert mod.f is f
    finally:
        del sys.modules["bench_fake_mod"]


def test_settings_without_a_flag_are_the_programs():
    from benchmark.traffic import exp_pass

    for c in core.spec()["configs"]:
        cfg = core.load_json(core.os.path.join(core.ROOT, c["file"]))
        assert exp_pass.settings_off(cfg) == [], c["name"]
        assert exp_pass.settings_off(dict(cfg, union_cs=4999, trial=2))[0].startswith("union_cs")
        assert len(exp_pass.settings_off(dict(cfg, union_cs=4999, trial=2))) == 2
