"""The port's bounded-memory streaming sweep (khoice_tpu_torch/engine/
streaming.py) on the CPU, mirroring tests/test_streaming.py: at forced
chunk sizes, group counts and groups per pass, and from a small budget
alone, its histograms equal the port's in-core sweep and the JAX
package's on adversarial members (shared cores, N runs, poly-A skew,
palindromes, short records); exp1 and its CLI stream under a tiny
budget with the CSV bytes of the in-core run and of the JAX package."""

import os

import pytest
import torch

from conftest import random_dna
from khoice_tpu.engine.ksweep import occurrence_histograms_sweep as jax_sweep
from khoice_tpu.io.packing import encode_records
from khoice_tpu.pipelines.exp1 import run_exp1 as jax_run_exp1
from khoice_tpu_torch.engine import streaming as st
from khoice_tpu_torch.engine.ksweep import occurrence_histograms_sweep
from khoice_tpu_torch.pipelines.exp1 import run_exp1
from test_exp1 import make_groups
from test_torch_exp1 import _cli, _read, _write_db

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

KS = [7, 11, 16, 21, 27, 31, 34]


def _members(rng):
    core = random_dna(rng, 2500)
    pal = "ACGT" * 40
    out = []
    for i in range(5):
        seq = list(core)
        for _ in range(60 * (i + 1)):
            seq[rng.randrange(len(core))] = "ACGT"[rng.randrange(4)]
        recs = [
            "".join(seq),
            pal + random_dna(rng, 200),
            "A" * 300 + random_dna(rng, 150) + "N" * 40 + random_dna(rng, 100),
        ]
        out.append(encode_records(recs))
    return out


def _skewed(rng):
    return [
        encode_records(["A" * 4000 + random_dna(rng, 800)]),
        encode_records(["A" * 3500 + random_dna(rng, 900)]),
        encode_records([random_dna(rng, 4000)]),
    ]


@pytest.mark.parametrize("n_members,knobs", [
    (5, dict(chunk_elems=16384, n_groups=5, pass_groups=2)),
    (2, dict(chunk_elems=16384, n_groups=1)),
    (3, dict(chunk_elems=5000, n_groups=7, pass_groups=3)),
])
def test_streaming_equals_incore_and_jax(rng, n_members, knobs):
    members = _members(rng)[:n_members]
    want = occurrence_histograms_sweep(members, KS, "cpu", cx=8)
    got = st.occurrence_histograms_sweep_streaming(members, KS, "cpu", cx=8, **knobs)
    assert got == want
    assert got == jax_sweep(members, KS, cx=8)


def test_streaming_overflow_retry_is_contained(rng, monkeypatch):
    """Poly-A skew concentrates keys in the first and last key ranges: the
    cap-doubling retry converges, stays exact, re-runs only the groups
    that overflowed, and scans each key-range group exactly once."""
    members = _skewed(rng)
    ks = [9, 13, 21]
    G = 4
    batch_sizes, scans = [], []
    real_chunk, real_scan = st._chunk_step, st._group_scan

    def chunk_spy(*args):
        batch_sizes.append(len(args[-1]))  # groups of the pass (hi)
        return real_chunk(*args)

    def scan_spy(*args):
        scans.append(1)
        return real_scan(*args)

    monkeypatch.setattr(st, "_chunk_step", chunk_spy)
    monkeypatch.setattr(st, "_group_scan", scan_spy)
    got = st.occurrence_histograms_sweep_streaming(
        members, ks, "cpu", cx=8, chunk_elems=16384, n_groups=G, pass_groups=G)
    assert got == occurrence_histograms_sweep(members, ks, "cpu", cx=8)
    assert got == jax_sweep(members, ks, cx=8)
    assert len(set(batch_sizes)) > 1, "expected an overflow retry round"
    assert all(b < G for b in batch_sizes if b != G)
    assert len(scans) == G


def test_streaming_sized_from_a_small_budget(rng):
    """The knobs derived from a 2 MiB budget alone (several chunks, several
    groups: 41 B per element of a 2-word sort) still give the exact
    histograms."""
    members = _members(rng)[:3]
    total = 2 * sum(len(m) + 1 for m in members)
    C, n_chunks, G, cap, R = st._stream_plan(total, 2, 33, 7, 2 << 20)
    assert n_chunks > 1 and G > 1
    got = st.occurrence_histograms_sweep_streaming(members, KS, "cpu", cx=8,
                                                   device_budget_bytes=2 << 20)
    assert got == occurrence_histograms_sweep(members, KS, "cpu", cx=8)


@pytest.mark.parametrize("total,budget_gib", [(386_800_000, 12), (128_100_000, 4),
                                              (1_000_000_000, 40), (60_000_000, 1)])
def test_stream_plan_stays_within_the_budget(total, budget_gib):
    """The sizing's estimated peak (resident codes, one pass's group
    buffers, the larger of a chunk's and a group's sort) fits the budget
    at the packed master class (KW 4, kmax 49, kmin 7), also after one
    retry round doubles the cap."""
    budget = budget_gib << 30
    C, n_chunks, G, cap, R = st._stream_plan(total, 4, 48, 7, budget)
    assert n_chunks * C >= total and cap * G >= C
    assert st._stream_peak_bytes(total, 4, 48, C, n_chunks, cap, R) <= budget
    R2 = st._pass_groups(G, n_chunks * 2 * cap, 4, st._free_quarter(budget, total, 48))
    assert st._stream_peak_bytes(total, 4, 48, C, n_chunks, 2 * cap, R2) <= budget


def test_exp1_streams_under_a_tiny_budget(rng, tmp_path, monkeypatch):
    """run_exp1 sends groups over the budget to the streaming sweep (and
    not under a large one), with the in-core run's CSV bytes and the JAX
    package's under the same budget."""
    calls = []
    real = st.occurrence_histograms_sweep_streaming

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(st, "occurrence_histograms_sweep_streaming", spy)
    groups = make_groups(rng, n_groups=2, genomes_per_group=2, glen=300)
    ks = [5, 9, 12, 21]
    big = run_exp1(groups, ks, str(tmp_path / "incore"), "cpu", device_budget_bytes=1 << 40)
    assert not calls, "an in-core budget must not stream"
    small = run_exp1(groups, ks, str(tmp_path / "stream"), "cpu", device_budget_bytes=1 << 14)
    assert len(calls) == 3, "every group and the across set stream"
    ref = jax_run_exp1(groups, ks, str(tmp_path / "jax"), fused=True,
                       device_budget_bytes=1 << 14)
    for key in ("step_5", "step_9"):
        assert _read(small[key]) == _read(big[key]) == _read(ref[key])


def test_cli_streams_under_a_tiny_budget(rng, tmp_path):
    db = tmp_path / "db"
    _write_db(str(db), rng)
    outs = {}
    for name, extra in (("incore", []), ("stream", ["--device-budget-gb", "1e-5"])):
        work = tmp_path / name
        proc = _cli("--exp-type", "1", "--device", "cpu", "--database-root", str(db),
                    "--work-root", str(work), "--k-values", "11,21,31,35", *extra)
        assert proc.returncode == 0, proc.stderr
        assert ("streaming class kmax=35" in proc.stderr) == (name == "stream")
        outs[name] = [_read(os.path.join(work, p)) for p in (
            "step_5/within_datasets_analysis.csv", "step_9/across_datasets_analysis.csv")]
    assert outs["stream"] == outs["incore"]
