"""The port's sync spans on the card: with
`torch.cuda.set_sync_debug_mode("error")` outside the spans of
`utils/trace.py` SYNC_SPANS (and off inside them), tiny exp1 runs (a
sweep class, then the per-k path), a tiny exp6 and a resident sweep run
to the end, so every synchronising call on their paths sits in a sync
span; the sync spans counted equal each run's plan.  Under torch.profiler
every `first_pass_kernel` runs inside the `kernel:sort_plan` span that
waited on it, each `kernel:sort_plan` inside a `kernel:sort`, and every
span inside `cli:run`.

Needs a CUDA device and skips without one.  The file imports no jax, so
it runs where the JAX package is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_trace_cuda.py
"""

import collections
import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from khoice_tpu_torch import cli
from khoice_tpu_torch.engine.ksweep import occurrence_histograms_sweep_packed
from khoice_tpu_torch.engine.occurrence import pack_members
from khoice_tpu_torch.utils import trace
from test_torch_trace import CASES, _parent, _write_db

torch.set_num_threads(1)

# the sync spans of each tiny run (2 datasets of 3 genomes): exp1 packs and
# uploads 2 groups and the across set; the sweep sorts once a set (11, 21
# and 31 in the master class at 35), the per-k path once a k; exp6 uploads
# the group texts, each dataset's reads and each k's row starts, and sorts
# and reads back once a k, for each of its 2 read types
PLANS = {
    "exp1_sweep": {"engine:upload": 3, "kernel:sort_plan": 3, "engine:readback": 3},
    "exp1_perk": {"engine:upload": 3, "kernel:sort_plan": 6, "engine:readback": 6},
    "exp6": {"engine:upload": 2 * (1 + 2 + 2), "kernel:sort_plan": 2 * 2,
             "engine:readback": 2 * 2},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class SyncAudit:
    """trace.span in the program's place: a sync span turns the sync debug
    mode off while it is open and counts itself; outside every sync span
    a synchronising call raises."""

    def __init__(self, span):
        self._span = span
        self.depth = 0
        self.counts = collections.Counter()

    def span(self, name):
        ctx = self._span(name)
        return self._sync(name, ctx) if name in trace.SYNC_SPANS else ctx

    @contextlib.contextmanager
    def _sync(self, name, ctx):
        self.counts[name] += 1
        self.depth += 1
        torch.cuda.set_sync_debug_mode(0)
        try:
            with ctx:
                yield
        finally:
            self.depth -= 1
            if not self.depth:
                torch.cuda.set_sync_debug_mode("error")

    @contextlib.contextmanager
    def raising(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.fixture
def audit(monkeypatch):
    a = SyncAudit(trace.span)
    monkeypatch.setattr(trace, "span", a.span)
    return a


def _argv(tmp_path, case):
    db, work = tmp_path / "db", tmp_path / "work"
    _write_db(str(db))
    common = ["--database-root", str(db), "--work-root", str(work)]
    argv = CASES[case][0]
    if argv[1] == "6":  # exp0 on the host, before the audit
        assert cli.main(["run", "--exp-type", "0", *common, "--kmers-per-dataset", "400"]) == 0
    return ["run", *argv, *common, "--device", "cuda"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PLANS))
def test_every_sync_sits_in_a_sync_span(cuda, audit, tmp_path, case):
    argv = _argv(tmp_path, case)
    with audit.raising():
        assert cli.main(argv) == 0
    assert dict(audit.counts) == PLANS[case]
    audit.counts.clear()
    with audit.raising():  # a second run, as a pass of a closed loop: the same syncs
        assert cli.main(argv + ["--force"]) == 0
    assert dict(audit.counts) == PLANS[case]


@pytest.mark.cuda
def test_resident_sweep_syncs(cuda, audit):
    rng = np.random.default_rng(5)
    members = [rng.integers(0, 5, 30000).astype(np.uint8) for _ in range(3)]
    packed = pack_members(members, cuda)
    assert dict(audit.counts) == {"engine:upload": 1}
    audit.counts.clear()
    with audit.raising():
        occurrence_histograms_sweep_packed(packed, 3, [11, 21, 31, 35], cx=50)
    assert dict(audit.counts) == {"kernel:sort_plan": 1, "engine:readback": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PLANS))
def test_spans_share_the_devices_clock(cuda, tmp_path, case):
    argv = _argv(tmp_path, case)
    assert cli.main(argv) == 0  # the kernels built, the allocator warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        assert cli.main(argv + ["--force"]) == 0
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as fd:
        events = [e for e in json.load(fd)["traceEvents"] if e.get("ph") == "X"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
             for e in events if e.get("cat") == "user_annotation"]
    counts = collections.Counter(s[0] for s in spans if s[0] in trace.SYNC_SPANS)
    assert dict(counts) == PLANS[case]  # the benchmark's host_syncs, a pass
    plans = [s for s in spans if s[0] == "kernel:sort_plan"]
    for plan in plans:
        assert _parent(plan, spans)[0] == "kernel:sort"
    run = next(s for s in spans if s[0] == "cli:run")
    for s in spans:
        if ":" in s[0] and s is not run:
            assert run[1] <= s[1] and s[2] <= run[2], s
    firsts = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("cat") == "kernel" and "first_pass_kernel" in e.get("name", "")]
    assert len(firsts) == len(plans)
    for a, b in firsts:
        assert any(p[1] <= a and b <= p[2] for p in plans), (a, b)
