"""The port's on-card tools on the CPU at small sizes:
tools/hw_check_torch.py's comparisons (and that a corrupted result is
reported), its exit code without a card; tools/demo_streaming_torch.py's
two streamed runs under a budget below the in-core estimate, against the
JAX package's in-core sweep; tools/bench_ksweep_torch.py's exactness
check; and, in a fresh process, that no new entry point imports jax or
the JAX package.  Every compared value is an integer count, so the
tolerance is exact equality."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import bench_ksweep_torch  # noqa: E402
import demo_streaming_torch  # noqa: E402
import hw_check_torch as hw  # noqa: E402
from khoice_tpu.engine.ksweep import occurrence_histograms_sweep as jax_sweep  # noqa: E402

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

DEMO_KS = [7, 13, 21, 31, 49]


def _gate_data():
    """hw_check's data, cut to a few kb per member."""
    rng = np.random.default_rng(3)
    members = hw.gate_members(rng, core_len=3000, tail_len=800, polya_len=300, mutations=50,
                              n_run=(100, 140))
    return members, hw.classify_members(rng, core_len=2000, own_len=500, mutations=30)


def test_hw_check_finds_no_mismatch_on_cpu():
    members, cls_members = _gate_data()
    assert hw.check("cpu", members, cls_members) == 0


def test_hw_check_reports_a_corrupted_result(capsys):
    members, cls_members = _gate_data()
    sweep, perk = hw.sweep_vs_perk(members, [21, 31, 49], "cpu")
    assert hw.hist_mismatches(sweep, perk) == []
    sweep[31] = [sweep[31][0] + 1] + sweep[31][1:]
    assert hw.hist_mismatches(sweep, perk) == [31]
    results = hw.classify_kernel_vs_plain(cls_members, "cpu")
    assert hw.classify_mismatches(results) == []
    got, want = results["buckets"]
    got = got.clone()
    got[1, -1, 0] += 1  # one palindromic stat of the last k
    results["buckets"] = (got, want)
    assert hw.classify_mismatches(results) == ["buckets"]
    out = capsys.readouterr().out
    assert "MISMATCH k=31" in out and "MISMATCH classify mode buckets" in out


def test_hw_check_main_exits_2_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert hw.main() == 2


def test_demo_streaming_two_decompositions_equal_jax():
    """Three 3 kb members under 2 MiB and 1 MiB, both below the in-core
    estimate: two different plans, identical histograms, equal to the JAX
    package's in-core sweep."""
    members = demo_streaming_torch.demo_members(3, 3000)
    out = demo_streaming_torch.demo(members, DEMO_KS, 2 << 20, "cpu")
    assert out["budget_bytes"] < out["incore_estimate_bytes"]
    plans = [run["plan"] for run in out["runs"]]
    assert plans[0] != plans[1] and all(p["chunks"] > 1 for p in plans)
    want = jax_sweep(members, DEMO_KS, cx=8)
    for k in DEMO_KS:
        assert out["hists"][k] == [int(x) for x in want[k]], k


def test_demo_streaming_refuses_a_budget_that_holds_the_group():
    members = demo_streaming_torch.demo_members(3, 3000)
    with pytest.raises(ValueError, match="not below the in-core estimate"):
        demo_streaming_torch.demo(members, DEMO_KS, 1 << 30, "cpu")


def test_bench_ksweep_exact_at_a_small_size(monkeypatch):
    monkeypatch.setattr(bench_ksweep_torch, "GENOME_LEN", 1 << 11)
    monkeypatch.setattr(bench_ksweep_torch, "REPS", 1)
    out = bench_ksweep_torch.run("cpu")
    assert out["exact"] and out["n_positions"] == 8 * ((1 << 11) + 1)
    assert [c["ks"] for c in out["classes"]] == [30]


def test_new_entry_points_import_neither_jax_nor_the_jax_package():
    """Each new root script and tool module, imported in a fresh process
    (and entry() run on the CPU), pulls in neither jax nor khoice_tpu."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'tools')!r}]\n"
        "import bench_torch, __graft_entry_torch__\n"
        "import hw_check_torch, bench_ksweep_torch, demo_streaming_torch, profile_torch_sweep\n"
        "fn, args = __graft_entry_torch__.entry('cpu')\n"
        "assert int(fn(*args)[0].sum()) > 0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules if m == 'khoice_tpu' or m.startswith('khoice_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("clean")
