"""The readers of the program's own spans (metrics/program_spans.py and
the metrics built on it) on synthetic chrome-trace events, and a tiny
traced run of each cell on the CPU reporting them."""

import io

import pytest

from bench_tiny import CELLS, core, run_tiny
from benchmark.harness import trace
from benchmark.metrics import confusion_s, engine_idle_s, fasta_s, host_syncs, program_spans

NEW = ("host_syncs", "engine_idle_s", "fasta_s", "confusion_s")


def _ev(ts, dur, name, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


def _rec(events, passes=2):
    return core.Record(trace=trace.Trace(events), passes=passes, window_s=1.0)


# two passes; the device busy over [0, 10], [40, 45] and [70, 100]
EVENTS = [
    _ev(0, 50, trace.PASS), _ev(50, 50, trace.PASS),
    _ev(0, 100, "cli.run"),  # a benchmark label
    _ev(2, 96, "cli:run"),
    _ev(5, 30, "engine:sweep"),
    _ev(10, 20, "kernel:sort"), _ev(12, 6, "kernel:sort_plan"),
    _ev(30, 4, "engine:readback"),
    _ev(40, 20, "io:read_database"), _ev(41, 5, "io:read_fasta"), _ev(50, 5, "io:read_fasta"),
    _ev(60, 5, "engine:upload"), _ev(66, 3, "reports:confusion"), _ev(69, 1, "reports:confusion"),
    _ev(0, 10, "k", "kernel"), _ev(40, 5, "m", "gpu_memcpy"), _ev(70, 30, "k", "kernel"),
]


def test_is_program_takes_layer_colon_names_only():
    assert program_spans.is_program("kernel:sort_plan")
    assert program_spans.is_program("io:read_fasta")
    for name in ("cli.run", "pass", "io", "torch:cat", "engine", "aten::sort"):
        assert not program_spans.is_program(name), name


def test_host_syncs_counts_the_sync_spans():
    # kernel:sort_plan, engine:readback, engine:upload over 2 passes
    assert host_syncs.read(_rec(EVENTS)) == pytest.approx(1.5)
    assert host_syncs.read(_rec(EVENTS, passes=1)) == 3


def test_engine_idle_takes_engine_and_kernel_innermost_gaps():
    # idle [10, 40]: kernel:sort 10-12 and 18-30, kernel:sort_plan 12-18, engine:readback
    # 30-34, engine:sweep 34-35, cli:run 35-40; idle [45, 70]: io 45-60, engine:upload
    # 60-65, cli:run 65-66, reports:confusion 66-70
    gaps = dict(trace.Trace(EVENTS).idle_gaps(top=None))
    assert gaps["kernel:sort"] == pytest.approx(14e-6)
    assert gaps["kernel:sort_plan"] == pytest.approx(6e-6)
    assert gaps["engine:readback"] == pytest.approx(4e-6)
    assert gaps["engine:sweep"] == pytest.approx(1e-6)
    assert gaps["engine:upload"] == pytest.approx(5e-6)
    # 14 + 6 + 4 + 1 + 5 = 30 us over 2 passes; cli:run, io:, reports: gaps left out
    assert engine_idle_s.read(_rec(EVENTS)) == pytest.approx(15e-6)


def test_span_seconds_are_outermost_per_pass():
    events = EVENTS + [_ev(42, 2, "io:read_fasta")]  # nested in one already counted
    assert fasta_s.read(_rec(events)) == pytest.approx(5e-6)
    assert confusion_s.read(_rec(events)) == pytest.approx(2e-6)
    assert program_spans.outermost_seconds(events, ("io:read_fasta",)) == pytest.approx(10e-6)


@pytest.mark.parametrize("reader", [host_syncs, engine_idle_s, fasta_s, confusion_s])
def test_without_program_spans_the_readers_read_nothing(reader):
    labels_only = [e for e in EVENTS if not program_spans.is_program(e["name"])]
    assert reader.read(_rec(labels_only)) is None
    assert reader.read(core.Record(trace=None, passes=2, window_s=1.0)) is None


def test_tiny_traced_runs_report_the_new_entries():
    bench = core.spec()
    got = set()
    for cell in sorted(CELLS):
        r = run_tiny(cell, traced=True, out=io.StringIO(), err=io.StringIO())
        assert r["correct"] is True
        want = {m["name"] for m in core.cell_metrics(bench, cell, True)
                if m["name"].split(".")[0] in NEW}
        assert want and want <= set(r["metrics"]), (cell, want - set(r["metrics"]))
        for name in want:
            assert r["metrics"][name]["value"] >= 0
        syncs = [v["value"] for n, v in r["metrics"].items() if n.startswith("host_syncs")]
        assert syncs and syncs[0] > 0
        got |= want
    assert got == {m["name"] for m in bench["per_layer"] if m["name"].split(".")[0] in NEW}
    assert len(got) == 6
