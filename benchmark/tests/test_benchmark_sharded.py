"""The four-card cell's parts on the CPU: its traffic kind
(`sharded_exp_pass`) over 2 gloo ranks at the tiny cell's sizes, correct
as it is and not correct with one bin off in a step_4 file of a pass;
its control failing; the readers of the `dist` layer's metrics on
synthetic records; the exchange's NVLink bytes of a hand-made call."""

import io
import json
import os
import time

import pytest
import torch

import controls
from bench_tiny import core, parts
from benchmark.harness import spans, trace
from benchmark.metrics import (dist_idle_s, exchange_roofline, exchange_s, nvlink,
                               rank_peak_gib, rows_exchanged)

CELL = "exp1.sharded4.2x96x5mbp"
NEW = ("exchange_s.exp", "dist_idle_s.exp", "exchange_roofline.exp", "rows_exchanged.exp",
       "rank_peak_gib.exp")


def _run(traced=False, seed=2**31 + 13, out=None):
    torch.set_num_threads(1)
    cfg, mix, kind = parts(CELL)
    return core.run(CELL, seed, 0.5, traced, torch.device("cpu"), time.perf_counter(),
                    parts=(cfg, dict(mix, ranks=2), kind), out=out or io.StringIO(),
                    err=io.StringIO())


def test_tiny_run_over_two_ranks_is_correct_and_reports_the_dist_metrics():
    out = io.StringIO()
    r = _run(traced=True, out=out)
    assert r["correct"] is True and r["failed"] == 0, r["compared"]
    assert r["attempted"] >= 1
    assert {c: v["value"] for c, v in r["compared"].items()} == {"csv_lines_off": 0,
                                                                  "hist_bins_off": 0}
    walls = json.loads(out.getvalue().splitlines()[0])
    ranks = walls["work"]["ranks"]
    assert [x["rank"] for x in ranks] == [0, 1]
    assert sum(x["rows_sent"] for x in ranks) == sum(x["rows_received"] for x in ranks) > 0
    m = r["metrics"]
    # the CPU has no NCCL kernel: the roofline reads nothing there
    for name in ("exchange_s.exp", "dist_idle_s.exp", "rows_exchanged.exp",
                 "rank_peak_gib.exp"):
        assert m[name]["value"] >= 0, name
    assert m["exchange_s.exp"]["value"] > 0
    assert m["rows_exchanged.exp"]["value"] == pytest.approx(
        sum(x["rows_sent"] for x in ranks) / r["attempted"] / 1e6)
    assert "exchange_roofline.exp" not in m
    assert {"RANK", "WORLD_SIZE", "MASTER_PORT"}.isdisjoint(os.environ)
    assert not torch.distributed.is_initialized()


def test_one_bin_off_in_a_step4_file_makes_it_not_correct(monkeypatch):
    from khoice_tpu_torch.pipelines import exp1

    write = exp1.write_hist_txt

    def one_off(path, hist, *a, **k):
        if "step_4" in path:
            hist = [hist[0] + 1] + list(hist[1:])
        return write(path, hist, *a, **k)

    monkeypatch.setattr(exp1, "write_hist_txt", one_off)
    r = _run()
    assert r["correct"] is False
    assert r["compared"]["hist_bins_off"]["value"] > 0


def test_control_is_not_correct():
    torch.set_num_threads(2)
    sizes = dict(num_datasets=2, genomes_per_dataset=2, genome_mbp=2.0, k_values=[21, 31])
    result = controls.control_run(CELL, 2**32 + 7, torch.device("cpu"),
                                  parts=parts(CELL, **sizes))
    assert result["correct"] is False, result["compared"]
    assert any(v["value"] > v["limit"] for v in result["compared"].values())


def _ev(ts, dur, name, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


# two passes; the device busy over [0, 10] (an NCCL kernel of 6 us in it)
# and [60, 100]
EVENTS = [
    _ev(0, 50, trace.PASS), _ev(50, 50, trace.PASS),
    _ev(0, 100, "cli:run"),
    _ev(5, 30, "dist:exchange"), _ev(8, 2, "dist:exchange"),  # nested: counted once
    _ev(40, 10, "dist:barrier"), _ev(55, 5, "dist:splits"), _ev(70, 10, "dist:exchange"),
    _ev(0, 4, "k"), _ev(4, 6, "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
                        "kernel"),
    _ev(60, 40, "k", "kernel"),
]


def _rec(events=EVENTS, **kw):
    return core.Record(trace=trace.Trace(events), passes=2, window_s=1.0, **kw)


def test_exchange_seconds_are_the_outermost_dist_exchange_spans():
    # [5, 35] and [70, 80]: 40 us over 2 passes
    assert exchange_s.read(_rec()) == pytest.approx(20e-6)


def test_dist_idle_takes_the_gaps_under_dist_spans():
    # idle [10, 60]: dist:exchange 10-35, cli:run 35-40, dist:barrier 40-50, pass/cli 50-55,
    # dist:splits 55-60: 25 + 10 + 5 = 40 us over 2 passes
    assert dist_idle_s.read(_rec()) == pytest.approx(20e-6)


@pytest.mark.parametrize("reader", [exchange_s, dist_idle_s])
def test_without_dist_spans_the_span_readers_read_nothing(reader):
    assert reader.read(_rec([e for e in EVENTS if not e["name"].startswith("dist:")])) is None
    assert reader.read(core.Record(trace=None, passes=2, window_s=1.0)) is None


def test_exchange_bytes_of_a_hand_made_call():
    rows = torch.zeros(8, 5, dtype=torch.int64)
    # rank 0 keeps 3 rows and sends 1 + 4 to ranks 1 and 2; receives 2 + 1 from them
    args = spans.summarize((rows, [3, 1, 4], [2, 2, 1]))
    assert nvlink.exchange_call_bytes(args, 0) == 5 * 5 * 8
    # receiving more than it sends: the larger direction counts
    assert nvlink.exchange_call_bytes(spans.summarize((rows, [3, 1, 4], [2, 9, 6])), 0) == \
        15 * 5 * 8
    # rank 1's view of the same shares: its own share is the second
    assert nvlink.exchange_call_bytes(args, 1) == 7 * 5 * 8


def test_exchange_roofline_over_the_nccl_kernels():
    rec_calls = spans.Recorder(annotate=False)
    rows = torch.zeros(1000, 4, dtype=torch.int64)
    rec_calls.args["exchange.calls"].append(spans.summarize((rows, [250, 250, 500], [0, 0, 0])))
    rec = _rec(recorder=rec_calls, missing=set())
    want = 100.0 * 750 * 4 * 8 / nvlink.NVLINK_BYTES_PER_S / 6e-6
    assert exchange_roofline.read(rec) == pytest.approx(want)
    rec.missing = {"khoice_tpu_torch.dist.sharded.exchange_rows"}
    assert exchange_roofline.read(rec) is None


def test_rows_and_rank_peaks_come_from_work():
    work = {"ranks": [
        {"rank": 0, "rows_sent": 3_000_000, "rows_received": 1, "peak_bytes": 2**30},
        {"rank": 1, "rows_sent": 1_000_000, "rows_received": 2, "peak_bytes": 3 * 2**30}]}
    rec = core.Record(passes=2, window_s=1.0, work=work)
    assert rows_exchanged.read(rec) == pytest.approx(2.0)
    assert rank_peak_gib.read(rec) == pytest.approx(3.0)
    empty = core.Record(passes=2, window_s=1.0, work={})
    assert rows_exchanged.read(empty) is None and rank_peak_gib.read(empty) is None


def test_the_cell_is_as_declared():
    bench = core.spec()
    wl = core.workload(CELL, bench)
    cfg, mix, kind = core.cell_parts(wl)
    assert (wl["chips"], mix["ranks"], mix["kind"]) == (4, 4, "sharded_exp_pass")
    assert (cfg["num_datasets"], cfg["genomes_per_dataset"], cfg["genome_mbp"]) == (2, 96, 5.0)
    assert {m["name"] for m in core.cell_metrics(bench, CELL, True)} >= set(NEW) | {
        "device_idle.exp", "sort_roofline.exp", "fasta_s.exp"}
    assert {m["name"] for m in core.cell_metrics(bench, CELL, False)} == {
        "setup_s", "exp_s", "peak_gib"}


# a tiny run of the cell over 2 CPU ranks with a long window, in a process of its own
_HARNESS = """
import io, sys, time, torch
sys.path.insert(0, {tests!r})
from bench_tiny import core, parts
torch.set_num_threads(1)
cfg, mix, kind = parts({cell!r})
core.run({cell!r}, 5, 120.0, False, torch.device("cpu"), time.perf_counter(),
         parts=(cfg, dict(mix, ranks=2), kind), out=io.StringIO(), err=io.StringIO())
"""


def _children(pid):
    """The live (not zombie) processes whose parent is `pid`."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fd:
                fields = fd.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(entry))
    return out


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as fd:
            return fd.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _start_harness(tmp):
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp))  # a killed run leaves its files
    proc = subprocess.Popen([sys.executable, "-c", _HARNESS.format(tests=tests, cell=CELL)],
                            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        workers = [p for p in _children(proc.pid)
                   if "sharded_exp_pass.py" in open(f"/proc/{p}/cmdline").read()]
        if workers:
            time.sleep(8)  # into the warm pass or the window
            return proc, workers
        time.sleep(0.2)
    proc.kill()
    raise AssertionError("no worker started")


def test_a_dead_worker_ends_the_run(tmp_path):
    import signal

    proc, workers = _start_harness(tmp_path)
    try:
        os.kill(workers[0], signal.SIGKILL)
        t0 = time.monotonic()
        # gloo fails rank 0's collective at once, and the pass raises; where
        # it would wait (NCCL), the watch thread ends the run with code 3
        rc = proc.wait(timeout=60)
        assert rc != 0
        assert time.monotonic() - t0 < 30
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_workers_exit_when_the_harness_dies(tmp_path):
    import signal

    proc, workers = _start_harness(tmp_path)
    try:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        deadline = time.monotonic() + 20
        while any(_alive(p) for p in workers) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert not any(_alive(p) for p in workers)
    finally:
        for p in workers:
            if _alive(p):
                os.kill(p, signal.SIGKILL)


@pytest.mark.parametrize("fold32,blocks,devices", [
    (False, 1, 1), (True, 3, 1), (False, 4, 2), (True, 16, 2)])
def test_blocked_reference_equals_the_whole(fold32, blocks, devices):
    import numpy as np

    from benchmark import gen_realistic_db
    from benchmark.reference import exp1_blocked, kmers

    torch.set_num_threads(2)
    records = gen_realistic_db.generate(None, 2, 3, 0.02, 2**31 + 3)
    groups = {d: [kmers.genome_codes(records[d][g]) for g in sorted(records[d])]
              for d in sorted(records)}
    groups[2].append(np.full(40, 4, np.uint8))  # a member with no valid window
    ks = [7, 15, 31, 33, 49]
    want = kmers.exp1_histograms(groups, ks, torch.device("cpu"), cs=3, cx=8, fold32=fold32)
    # with 2 devices the ks are dealt out to this process and another, as to two cards
    got = exp1_blocked.exp1_histograms(groups, ks, [torch.device("cpu")] * devices, cs=3,
                                       cx=8, fold32=fold32, blocks=blocks)
    assert got == want
    assert all(sum(h) > 0 for h in want[1].values())
