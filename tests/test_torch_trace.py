"""The port's spans (khoice_tpu_torch/utils/trace.py) on the CPU: the
shared null context while no profiler records, and under torch.profiler
every span a tiny `run` reaches on the CPU path, each nested in its
`cli:run`, in the chrome trace the profiler exports.  The `kernel:`
spans are on the CUDA path only (tests/test_torch_trace_cuda.py)."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from khoice_tpu_torch import cli
from khoice_tpu_torch.engine.ksweep import occurrence_histograms_sweep_packed
from khoice_tpu_torch.engine.occurrence import pack_members
from khoice_tpu_torch.utils import trace

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

READS = ["cli:run", "io:read_database", "io:read_fasta"]
EXP1 = READS + ["pipeline:exp1", "io:encode", "io:join_groups", "engine:upload",
                "reports:write_hist", "reports:summarize", "reports:csv"]
# the span each of these has as its innermost enclosing one
PARENTS = {"io:read_database": {"cli:run"}, "pipeline:exp1": {"cli:run"},
           "pipeline:exp6": {"cli:run"}, "io:load_exp0": {"cli:run"},
           "io:read_fasta": {"io:read_database", "io:load_exp0"},
           "engine:sweep_class": {"engine:sweep"},
           "engine:readback": {"engine:sweep_class", "engine:perk", "engine:vote"},
           "reports:confusion": {"pipeline:exp6"}}
CASES = {
    # a sweep class (11, 21, 31 in one master sort at 35) over both groups and the across set
    "exp1_sweep": (["--exp-type", "1", "--k-values", "11,21,31,35"],
                   EXP1 + ["engine:sweep", "engine:sweep_class", "engine:readback"]),
    # two ks: every set takes the per-k path
    "exp1_perk": (["--exp-type", "1", "--k-values", "15,21"],
                  EXP1 + ["engine:sweep", "engine:perk", "engine:readback"]),
    "exp6": (["--exp-type", "6", "--k-values", "11,21", "--kmers-per-dataset", "400"],
             READS + ["io:load_exp0", "pipeline:exp6", "io:encode", "io:reads_matrix",
                      "engine:upload", "engine:concat_reads", "engine:vote", "engine:readback",
                      "reports:confusion", "reports:exp6_outputs"]),
}


def _write_db(root, seed=3, n_datasets=2, n_genomes=3, glen=1500):
    """Related genomes (a shared core with substitutions, an N run, a
    second record), one FASTA file each, in the reference layout."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 4, glen)
    for d in range(1, n_datasets + 1):
        os.makedirs(os.path.join(root, f"dataset_{d}"))
        for g in range(1, n_genomes + 1):
            seq = core.copy()
            at = rng.integers(0, glen, glen // 15)
            seq[at] = rng.integers(0, 4, at.size)
            text = "".join("ACGT"[b] for b in seq)
            with open(os.path.join(root, f"dataset_{d}", f"genome_{g}.fna"), "w") as fd:
                fd.write(f">d{d}g{g}\n{text[:700]}NNNN{text[700:]}\n"
                         f">d{d}g{g}_p\n{text[:200]}\n")


def _spans(prof, path):
    """The chrome trace's span events: [(name, start, end, thread)]."""
    prof.export_chrome_trace(str(path))
    with open(path) as fd:
        events = json.load(fd)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _parent(span, spans):
    """The innermost span that encloses `span` on its thread, or None."""
    name, s, e, tid = span
    outer = [x for x in spans if x is not span and x[3] == tid and x[1] <= s and e <= x[2]
             and (x[1], -x[2]) < (s, -e)]
    return max(outer, key=lambda x: (x[1], -x[2]), default=None)


def test_span_without_a_profiler_is_the_shared_null_context():
    a, b = trace.span("io:read_fasta"), trace.span("engine:sweep")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert not isinstance(trace.span("io:read_fasta"), contextlib.nullcontext)
    assert trace.span("io:read_fasta") is a


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_spans_nest_in_cli_run(tmp_path, case):
    argv, want = CASES[case]
    db, work = tmp_path / "db", tmp_path / "work"
    _write_db(str(db))
    common = ["--database-root", str(db), "--work-root", str(work), "--device", "cpu"]
    if "6" in argv[1]:
        assert cli.main(["run", "--exp-type", "0", *common, "--kmers-per-dataset", "400"]) == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert cli.main(["run", *argv, *common]) == 0
    spans = _spans(prof, tmp_path / "trace.json")
    names = {s[0] for s in spans}
    assert set(want) <= names, sorted(set(want) - names)
    if argv[1] == "1":  # exp1 reports from the histograms in memory
        assert "reports:read_hist" not in names
    assert not any(n.startswith("kernel:") for n in names)  # the CUDA path's
    runs = [s for s in spans if s[0] == "cli:run"]
    assert len(runs) == 1
    run = runs[0]
    for span in spans:
        if span is run or ":" not in span[0]:
            continue
        assert run[1] <= span[1] and span[2] <= run[2] and span[3] == run[3], span
        if span[0] in PARENTS:
            assert _parent(span, spans)[0] in PARENTS[span[0]], span


def test_resident_sweep_spans():
    rng = np.random.default_rng(5)
    members = [rng.integers(0, 5, 3000).astype(np.uint8) for _ in range(3)]
    packed = pack_members(members, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        occurrence_histograms_sweep_packed(packed, 3, [11, 21, 31, 35], cx=50)
    events = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
              if ":" in e.name]
    names = [e[0] for e in events]
    assert names.count("engine:sweep") == 1 and names.count("engine:sweep_class") == 1
    assert names.count("engine:readback") == 1 and "engine:upload" not in names
    readback = next(e for e in events if e[0] == "engine:readback")
    assert _parent(readback, events)[0] == "engine:sweep_class"
    cls = next(e for e in events if e[0] == "engine:sweep_class")
    assert _parent(cls, events)[0] == "engine:sweep"
