"""Sharded `run --exp-type 1 --mesh-shards 2` again and again in one
process per rank, on a group the caller initialised (the CLI does not own
it: a long-lived caller such as the benchmark's four-card cell keeps it
between runs), on gloo ranks on the CPU.

The ranks run through dist/launch.py::run_ranks (the rank program is
tests/torch_dist_ranks.py::cli_repeat).  Each run must write the
single-device CLI's CSV bytes; dist/mesh.py's `exchanged` must count the
rows each run moved (watched around all_to_all_single) and only rise;
under a profiler rank 0's trace must hold the `dist` layer's spans, with
every all_to_all_single call inside a `dist:exchange` and one `dist:slab`
for each slab the run built: one a shared-sort class and one for the ks
each member set leaves to the per-k path.  Every value
compared is a byte string or a row count, so the tolerance is equality.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks
from khoice_tpu_torch import cli
from khoice_tpu_torch.dist.launch import run_ranks
from khoice_tpu_torch.engine.ksweep import plan_sweep
from khoice_tpu_torch.io.fasta import FastaRecord, write_fasta

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

KS = "7,11,21,35"  # one shared-sort class a member set (the planner's master plan at kmax 35)
GENOMES = 3  # a dataset's; the across set has one member a dataset
CSVS = ("step_5/within_datasets_analysis.csv", "step_9/across_datasets_analysis.csv")
RUNS = 3
TRACED = 1  # the second run goes under the profiler
RANK_TIMEOUT_S = 240


def _read(path):
    with open(path, "rb") as fd:
        return fd.read()


@pytest.fixture(scope="module")
def repeated(tmp_path_factory):
    """(the single-device CSVs, each sharded run's CSVs, the ranks'
    outputs) on 2 datasets x 3 related genomes of 3 kb made from a seed."""
    rng = np.random.default_rng(33)
    root = tmp_path_factory.mktemp("repeatdb")
    base = rng.integers(0, 4, 3000)
    for num in (1, 2):
        d = root / f"dataset_{num}"
        d.mkdir()
        for g in range(GENOMES):
            seq = base.copy()
            idx = rng.choice(3000, 80 * num + 40 * g, replace=False)
            seq[idx] = rng.integers(0, 4, idx.shape[0])
            text = "".join("ACGT"[c] for c in seq)
            write_fasta(str(d / f"genome_{g}.fna.gz"),
                        [FastaRecord(f"g{num}{g}", text[:900] + "NN" + text[902:])])
    work = tmp_path_factory.mktemp("repeatwork")
    args = ["run", "--exp-type", "1", "--database-root", str(root), "--k-values", KS,
            "--device", "cpu"]
    assert cli.main(args + ["--work-root", str(work / "one")]) == 0
    argvs = [args + ["--work-root", str(work / f"run_{i}"), "--mesh-shards", "2"]
             for i in range(RUNS)]
    ranks = run_ranks(2, torch_dist_ranks.cli_repeat, (argvs, TRACED),
                      timeout_s=RANK_TIMEOUT_S)
    one = {rel: _read(work / "one" / rel) for rel in CSVS}
    runs = [{rel: _read(work / f"run_{i}" / rel) for rel in CSVS} for i in range(RUNS)]
    return one, runs, ranks


def test_every_run_writes_the_single_device_csvs(repeated):
    one, runs, ranks = repeated
    assert all(len(text.splitlines()) > 2 for text in one.values())
    for i, csvs in enumerate(runs):
        assert csvs == one, i
    assert [[run["rc"] for run in out["runs"]] for out in ranks] == [[0] * RUNS] * 2


def test_exchanged_counts_each_runs_rows_and_only_rises(repeated):
    _one, _runs, ranks = repeated
    for out in ranks:
        last = None
        for run in out["runs"]:
            assert run["counted"] == run["watched"], out["rank"]
            if last is not None:
                assert all(run["after"][key] >= last[key] for key in last)
                assert run["after"] == {key: last[key] + run["counted"][key] for key in last}
            last = run["after"]
    for i in range(RUNS):
        sent = sum(out["runs"][i]["counted"]["sent"] for out in ranks)
        received = sum(out["runs"][i]["counted"]["received"] for out in ranks)
        assert sent == received > 0, i
        # the same database gives the same exchange in every run
        assert [out["runs"][i]["counted"] for out in ranks] == \
            [out["runs"][0]["counted"] for out in ranks]


def test_rank0_trace_holds_the_dist_spans(repeated):
    _one, _runs, ranks = repeated
    events = ranks[0]["events"]
    names = {e["name"] for e in events}
    assert {"dist:exchange", "dist:splits", "dist:barrier", "dist:reduce", "dist:slab"} <= names
    # the slab build opens its span once a build
    assert [e["name"] for e in events].count("dist:slab") == \
        ranks[0]["runs"][TRACED]["slab_builds"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "dist:exchange"]
    calls = [e for e in events if e["name"].startswith("test:all_to_all")]
    assert any(e["name"] == "test:all_to_all_rows" for e in calls)
    for e in calls:
        assert any(s <= e["ts"] and e["ts"] + e["dur"] <= t for s, t in spans), e


def test_every_run_builds_one_slab_a_class_and_one_a_per_k_batch(repeated):
    _one, _runs, ranks = repeated
    ks = [int(k) for k in KS.split(",")]
    # two datasets of GENOMES members, then the across set of two
    slabs = 0
    for n_members in (GENOMES, GENOMES, 2):
        classes, remaining = plan_sweep(ks, n_members)
        slabs += len(classes) + bool(remaining)
    assert slabs >= 3  # a slab at least for each member set
    for out in ranks:
        assert [run["slab_builds"] for run in out["runs"]] == [slabs] * RUNS, out["rank"]
