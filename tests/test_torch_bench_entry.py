"""bench_torch.py, the port's headline benchmark, on the CPU at a small size
(GENOME_LEN 2^12 and the multi-card row's 4 x 2^11 bases over 1-2 gloo
ranks): its 30-k histograms against the JAX package's
occurrence_histograms_sweep_packed on the same seeded members, its last
line and stage row against bench.py's keys, its multi-card row against
the single-device sweep, and its device and file rules.  Every compared
value is an integer count, so the tolerance is exact equality."""

import ast
import contextlib
import io
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from khoice_tpu.engine.ksweep import occurrence_histograms_sweep_packed as jax_sweep  # noqa: E402
from khoice_tpu.engine.occurrence import pack_members as jax_pack_members  # noqa: E402
from khoice_tpu_torch.engine.ksweep import occurrence_histograms_sweep  # noqa: E402
from khoice_tpu_torch.engine.occurrence import pack_members  # noqa: E402

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

SMALL = {"GENOME_LEN": 1 << 12, "SCALING_LEN": 1 << 11, "SCALING_WORLDS": (1, 2)}


def _bench_py_dict(name):
    """The keys (and string values) of the dict literal bench.py assigns
    to `name`."""
    with open(os.path.join(ROOT, "bench.py")) as fd:
        tree = ast.parse(fd.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == name for t in node.targets)):
            return {k.value: (v.value if isinstance(v, ast.Constant) else None)
                    for k, v in zip(node.value.keys, node.value.values)}
    raise LookupError(name)


def _root_state():
    """The repo root's entry names, and BENCH_PROTOCOL.json's bytes and
    mtime (other files there may change while the suite runs)."""
    names = set(os.listdir(ROOT)) - {"__pycache__", ".pytest_cache"}
    path = os.path.join(ROOT, "BENCH_PROTOCOL.json")
    protocol = None
    if os.path.exists(path):
        with open(path, "rb") as fd:
            protocol = (fd.read(), os.stat(path).st_mtime_ns)
    return names, protocol


@pytest.fixture(scope="module")
def small_run():
    """bench_torch.main(["--device", "cpu"]) at the small size: (exit code,
    its JSON lines, the root's state before and after)."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL.items():
            mp.setattr(bench_torch, name, value)
        before = _root_state()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = bench_torch.main(["--device", "cpu"])
        after = _root_state()
    return rc, [json.loads(line) for line in out.getvalue().splitlines()], before, after


def test_grid_hists_equal_jax():
    """The 30-k histograms of bench_torch's workload (8 members of 2^12
    bases from default_rng(0)) equal the JAX package's sweep on the same
    members."""
    members = bench_torch.bench_members(bench_torch.N_GENOMES, 1 << 12, 0)
    got = bench_torch.grid_hists(pack_members(members, "cpu"), bench_torch.N_GENOMES)
    codes, gids = jax_pack_members(members)
    want = jax_sweep((jnp.asarray(codes), jnp.asarray(gids)), bench_torch.N_GENOMES,
                     bench_torch.K_GRID, cs=5000, cx=16)
    assert sorted(got) == sorted(want) == sorted(bench_torch.K_GRID)
    for k in bench_torch.K_GRID:
        assert got[k] == [int(x) for x in want[k]], k
    assert sum(got[k][0] for k in bench_torch.K_GRID) > 0


def test_last_line_has_bench_py_keys(small_run):
    rc, lines, _before, _after = small_run
    assert rc == 0
    want = _bench_py_dict("headline")
    assert set(lines[-1]) == set(want) == {"metric", "value", "unit", "vs_baseline"}
    assert lines[-1]["metric"] == want["metric"]
    assert lines[-1]["unit"] == "Mkmer/s"
    # a rate of the CPU's plain versions, rounded as bench.py rounds: it
    # may round to 0.0 on a loaded host (the card's is held > 0 on the chip)
    assert isinstance(lines[-1]["value"], float) and lines[-1]["value"] >= 0
    assert isinstance(lines[-1]["vs_baseline"], float) and lines[-1]["vs_baseline"] >= 0


def test_stage_row_has_bench_py_keys(small_run):
    _rc, lines, _before, _after = small_run
    rows = [line["stage_breakdown"] for line in lines if "stage_breakdown" in line]
    assert len(rows) == 1
    row = rows[0]
    assert set(row) == set(_bench_py_dict("stages"))
    assert row["sort_class"] == {"kmax": 49, "key_words": 4, "payload_packed": True,
                                 "ks_served": 30}
    assert row["elements_doubled_text"] == 2 * bench_torch.N_GENOMES * ((1 << 12) + 1)
    assert all(row[k] >= 0 for k in ("extract_ms", "sort_ms", "scan_30ks_ms", "total_ms"))


def test_multichip_row_equals_single_device(small_run):
    """The row ran on 1 and 2 gloo ranks (every rank's histograms held to
    the single-device sweep's inside bench_torch; 2 where the host has
    the cores) and says what it is."""
    _rc, lines, _before, _after = small_run
    rows = [line["multi_chip"] for line in lines if "multi_chip" in line]
    assert len(rows) == 1
    row = rows[0]
    assert row["mode"] == bench_torch.SCALING_MODE
    assert "not a scaling measurement" in row["mode"]
    # two host cores a rank: 2 ranks on a host of 4 cores or more
    assert set(row["seconds_by_ranks"]) == ({"1", "2"} if row["host_cores"] >= 4 else {"1"})
    assert set(row["seconds_with_rank_start"]) == set(row["seconds_by_ranks"])
    assert row["sharding_overhead_vs_single"]["1"] == 1.0
    assert row["input_positions"] == 4 * (1 << 11)
    assert row["all_to_all_bytes_per_device_per_class"] > 0
    assert row["nccl"].startswith("not measured")


def test_multichip_row_fails_on_a_differing_rank():
    """A rank whose histograms differ from the single-device ones fails the
    row: here the reference is corrupted at one k."""
    members = bench_torch.bench_members(2, 1 << 10, 1)
    ks = bench_torch.SCALING_KS
    want = occurrence_histograms_sweep(members, ks, "cpu", cx=8)
    want[31] = [want[31][0] + 1] + want[31][1:]
    with pytest.raises(AssertionError, match="k=31"):
        bench_torch.scaling_series(members, ks, want, torch.device("cpu"), [1], "gloo",
                                   shared_card=False)


def test_headline_survives_a_failing_multichip_row(monkeypatch, capsys):
    """bench.py's rule: a protocol row that raises does not cost the
    headline.  With multichip_row raising, main still prints the four-key
    last line, says why on stderr and returns 1 (a rank that disagrees is
    a fault)."""
    for name, value in SMALL.items():
        monkeypatch.setattr(bench_torch, name, value)

    def fail(device):
        raise AssertionError("multi-card row: rank 1 of 2 (gloo) differs at k=31")

    monkeypatch.setattr(bench_torch, "multichip_row", fail)
    rc = bench_torch.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    last = json.loads(out.splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == _bench_py_dict("headline")["metric"]
    assert not any("multi_chip" in line for line in out.splitlines())
    assert "[bench_torch] multi-card row failed: AssertionError" in err
    assert rc == 1


def test_main_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_torch.main([])


def test_run_writes_no_file_into_the_repo(small_run):
    """bench.py writes BENCH_PROTOCOL.json into the root; bench_torch.py
    prints its protocol rows and writes nothing there."""
    _rc, _lines, (names0, protocol0), (names1, protocol1) = small_run
    assert names1 == names0
    assert protocol1 == protocol0
