"""The port's classification experiments (khoice_tpu_torch: the plain
classification scans, engine/ksweep_classify.py, pipelines/exp0/2/3/4 and
the CLI) vs the JAX package's, on the CPU.  Every compared value is an
integer count or the bytes of a file, so the tolerance is exact equality
throughout (FASTA outputs compared decompressed: gzip headers carry a
timestamp)."""

import gzip
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna
from khoice_tpu import oracle
from khoice_tpu.cli import main as jax_main
from khoice_tpu.config import KhoiceConfig as JaxConfig
from khoice_tpu.engine import ksweep_classify as jkc
from khoice_tpu.engine.ksweep import plan_sweep as jax_plan_sweep
from khoice_tpu.engine.occurrence import pack_members as jax_pack_members
from khoice_tpu.io.fasta import FastaRecord, write_fasta
from khoice_tpu.io.packing import encode_records
from khoice_tpu.pipelines.exp0 import run_exp0 as jax_run_exp0
from khoice_tpu.pipelines.exp2 import run_exp2 as jax_run_exp2
from khoice_tpu.pipelines.exp3 import run_exp3 as jax_run_exp3
from khoice_tpu.pipelines.exp3 import simulate_exp3_reads as jax_simulate_exp3_reads
from khoice_tpu.pipelines.exp4 import run_exp4 as jax_run_exp4
from khoice_tpu_torch import cli as tcli
from khoice_tpu_torch.config import KhoiceConfig
from khoice_tpu_torch.engine import interop
from khoice_tpu_torch.engine import ksweep_classify as tkc
from khoice_tpu_torch.engine.streaming import DeviceBudgetExceeded
from khoice_tpu_torch.kernels import ksweep_scan
from khoice_tpu_torch.pipelines.exp0 import run_exp0
from khoice_tpu_torch.pipelines.exp2 import run_exp2
from khoice_tpu_torch.pipelines.exp3 import run_exp3, simulate_exp3_reads
from khoice_tpu_torch.pipelines.exp4 import run_exp4
from test_exp023 import make_world, oracle_exp2_csvs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = (4, 6, 8, 11, 16)  # even-heavy: palindromic classes exist


def _read(path):
    with open(path, "rb") as fd:
        data = fd.read()
    return gzip.decompress(data) if str(path).endswith(".gz") else data


def _world(rng):
    """Pivot with a palindromic block, an N run, a short record and a
    60-base block repeated 5x (multiplicities above 2*cap+1 at cap 5);
    four rest members sharing the pivot's core."""
    core = random_dna(rng, 300)
    pal = "ACGT" * 12  # reverse-complement palindromic block
    pivot = [core[:150] + pal + random_dna(rng, 80), "ACGTNNACGTACGT" + core[40:120],
             core[:60] * 5]
    rest = []
    for i in range(4):
        seq = list(core)
        for _ in range(10 * (i + 1)):
            seq[rng.randrange(len(core))] = "ACGT"[rng.randrange(4)]
        rest.append(["".join(seq), pal + random_dna(rng, 30)])
    return pivot, rest


def _jax_raw(mode, sk, sp, cks, kmax, KW, packed, mp):
    if mode == "pivot_rest":
        return jkc._sweep_class_pivot_rest(sk, sp, cks, kmax, KW, mp, 5000, packed, False, True)
    if mode == "multi_pivot":
        return jkc._sweep_class_multi_pivot(sk, sp, cks, kmax, KW, mp, 5000, packed, False, True)
    if mode == "containment":
        return jkc._sweep_class_containment(sk, sp, cks, kmax, KW, *mp, 5000, packed, False, True)
    return jkc._sweep_class_feature_buckets(sk, sp, cks, kmax, KW, mp[0], 5000, mp[1],
                                            packed, False, True)


@pytest.mark.parametrize("mode,mp", [("pivot_rest", 4), ("multi_pivot", 2),
                                     ("containment", (2, 3)), ("buckets", (4, 5))])
@pytest.mark.parametrize("ks,packed", [(KS, False), ((6, 8, 21, 31, 33), True)])
def test_raw_scan_equals_jax(rng, mode, mp, ks, packed):
    """JAX's sorted array, carried across, through the port's scan (the
    CPU path of the kernel wrapper) equals _sweep_class_*(raw=True)."""
    pivot, rest = _world(rng)
    members = [encode_records(pivot)] + [encode_records(g) for g in rest]
    classes, rem = jax_plan_sweep(ks, len(members))
    assert len(classes) == 1 and not rem
    kmax, KW, cks, cls_packed = classes[0]
    assert cls_packed == packed
    codes, gids = jax_pack_members(members)
    sk, sp = jkc._sorted_doubled_fn(jnp.asarray(codes), jnp.asarray(gids), kmax, KW, packed)
    want = np.asarray(_jax_raw(mode, sk, sp, cks, kmax, KW, packed, mp))
    words = interop.words_from_numpy([np.asarray(w) for w in sk], "cpu")
    pay = interop.payload_from_numpy(None if sp is None else np.asarray(sp), "cpu")
    before = dict(ksweep_scan.launches)
    got = ksweep_scan.scan_classify(words, pay, cks, mode, mp, packed)
    assert ksweep_scan.launches == before  # the CPU path launches nothing
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if 6 in cks:
        assert want[1].sum() > 0  # palindromic runs were really counted
    if mode == "buckets":
        assert (want == 5).any()  # saturated at the cap


def test_sweeps_equal_jax(rng):
    pivot, rest = _world(rng)
    ks = (6, 8, 11)
    members = [encode_records(pivot)] + [encode_records(g) for g in rest]

    def same(got, want):
        assert got[1] == want[1] == []
        assert sorted(got[0]) == sorted(want[0]) == list(ks)
        for k in ks:
            g, w = got[0][k], want[0][k]
            if isinstance(w, tuple):  # feature buckets: (buckets, unique)
                np.testing.assert_array_equal(g[0], w[0], err_msg=f"k={k}")
                assert g[1] == w[1], f"k={k}"
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"k={k}")

    same(tkc.pivot_rest_counts_sweep(members, ks, device="cpu"),
         jkc.pivot_rest_counts_sweep(members, ks))
    same(tkc.multi_pivot_counts_sweep(members[1:], 2, ks, device="cpu"),
         jkc.multi_pivot_counts_sweep(members[1:], 2, ks))
    same(tkc.containment_counts_sweep(members, 2, 3, ks, device="cpu"),
         jkc.containment_counts_sweep(members, 2, 3, ks))
    same(tkc.feature_buckets_sweep(members, 4, ks, cap=5, device="cpu"),
         jkc.feature_buckets_sweep(members, 4, ks, cap=5))


def test_wide_containment_sweep_vs_oracle(rng):
    """63 members: beyond the JAX package's 32-member classification
    sweep (it takes the per-k path there), within the port's 64-bit mask."""
    queries = [[random_dna(rng, 40)] for _ in range(42)]
    groups = [[q[0] + random_dna(rng, 10)] for q in queries[:21]]
    members = [encode_records(m) for m in queries + groups]
    counts, rem = tkc.containment_counts_sweep(members, 42, 21, (7, 8, 9), device="cpu")
    assert rem == []
    for k in (7, 8, 9):
        gsets = [oracle.set_counts(oracle.count_kmers(g, k), 1) for g in groups]
        for qi, q in enumerate(queries):
            qset = oracle.set_counts(oracle.count_kmers(q, k), 1)
            assert counts[k][qi, 0] == len(qset)
            for gi in range(21):
                assert counts[k][qi, 1 + gi] == sum(1 for km in qset if km in gsets[gi])


def test_sweep_per_k_path_budget_and_bad_modes_raise(rng, monkeypatch):
    """The ks a sweep leaves to the per-k path come back as its second
    value, as the JAX package's do; budgets and bad modes raise."""
    members = [encode_records([random_dna(rng, 80)]) for _ in range(3)]
    assert tkc.pivot_rest_counts_sweep(members, (11, 21), device="cpu") == ({}, [11, 21])
    assert (tkc.containment_counts_sweep(members * 22, 33, 33, (7, 8, 9), cs=5000,
                                         device="cpu") == ({}, [7, 8, 9]))
    got, rem = tkc.multi_pivot_counts_sweep(members[:2] * 2, 2, (7, 8, 9, 40), device="cpu")
    assert rem == [40] and sorted(got) == [7, 8, 9]
    monkeypatch.setattr(tkc, "default_device_budget_bytes", lambda device: 1000)
    with pytest.raises(DeviceBudgetExceeded):
        tkc.multi_pivot_counts_sweep(members[:2], 1, (7, 8, 9), device="cpu")
    words = torch.zeros(2, 10, dtype=torch.int64)
    for mode, mp in (("pivot_rest", 64), ("multi_pivot", 33), ("containment", (40, 25)),
                     ("buckets", (64, 255)), ("buckets", (4, -1)), ("occ", 3)):
        with pytest.raises(ValueError):
            ksweep_scan.scan_classify(words, None, [7], mode, mp, True)


def test_exp2_csvs_equal_jax_and_oracle(rng, tmp_path):
    db = make_world(rng)
    pivots = {num: db[num]["genome_%d_0" % num] for num in db}
    rest = {num: [db[num][f"genome_{num}_{g}"] for g in (1, 2)] for num in db}
    ks = [7, 11, 21, 33]
    port = run_exp2(pivots, rest, ks, str(tmp_path / "port"), "cpu")
    ref = jax_run_exp2(pivots, rest, ks, str(tmp_path / "jax"))
    (tmp_path / "oracle").mkdir()
    o_within, o_across = oracle_exp2_csvs(pivots, rest, ks, str(tmp_path / "oracle"))
    assert _read(port["within"]) == _read(ref["within"]) == _read(o_within)
    assert _read(port["across"]) == _read(ref["across"]) == _read(o_across)
    rel = "across_dataset_results_type_2/k_21/dataset_2/intersect/dataset_2_pivot_intersect_group.hist.txt"
    assert _read(tmp_path / "port" / rel) == _read(tmp_path / "jax" / rel)


def test_exp3_csv_equal_jax(rng, tmp_path):
    db = make_world(rng, glen=3000)
    pivots = {num: db[num]["genome_%d_0" % num] for num in db}
    rest = {num: [db[num][f"genome_{num}_{g}"] for g in (1, 2)] for num in db}
    reads = simulate_exp3_reads(pivots, 2000, seed=5)
    assert reads == jax_simulate_exp3_reads(pivots, 2000, seed=5)
    ks = [9, 12, 13, 21]
    got = run_exp3(reads, rest, ks, str(tmp_path / "port"), "cpu")
    want = jax_run_exp3(reads, rest, ks, str(tmp_path / "jax"))
    assert _read(got) == _read(want)
    assert len(_read(got).decode().strip().split("\n")) == 1 + 2 * 3 * len(ks) * 3


def test_exp4_csv_equal_jax(rng, tmp_path):
    db = make_world(rng)
    pivots = {num: db[num]["genome_%d_0" % num] for num in db}
    rest = {num: [db[num][f"genome_{num}_{g}"] for g in (1, 2)] + [pivots[num]] for num in db}
    ks = [7, 8, 11, 21]  # lexicographic order: 11, 21, 7, 8
    got = run_exp4(pivots, rest, ks, str(tmp_path / "port"), "cpu", count_cs=3)
    want = jax_run_exp4(pivots, rest, ks, str(tmp_path / "jax"), count_cs=3)
    assert _read(got) == _read(want)
    for k in ks:
        rel = f"accuracies_type_4/confusion_matrix/k_{k}_confusion_matrix_with_unidentified.txt"
        assert _read(tmp_path / "port" / rel) == _read(tmp_path / "jax" / rel)


def _tree(root):
    """{relative path: bytes (gz decompressed)} of every output file but the
    driver's run manifest (it holds timings)."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f != "run_manifest.json":
                path = os.path.join(d, f)
                out[os.path.relpath(path, root)] = _read(path)
    return out


def test_exp0_equals_jax(rng, tmp_path):
    db = make_world(rng, glen=3000)
    port = run_exp0(db, KhoiceConfig(kmers_per_dataset=2000, seed=3), 2, str(tmp_path / "port"))
    ref = jax_run_exp0(db, JaxConfig(kmers_per_dataset=2000, seed=3), 2, str(tmp_path / "jax"))
    assert port == ref
    port_files, jax_files = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port_files == jax_files
    assert "trial_summaries/trial_2_summary.txt" in port_files
    assert "trial_2/exp0_pivot_genomes/dataset_1/pivot_1.fna.gz" in port_files


@pytest.fixture
def database(rng, tmp_path):
    root = tmp_path / "db"
    base = random_dna(rng, 2000)
    for num in (1, 2, 3):
        d = root / f"dataset_{num}"
        d.mkdir(parents=True)
        for g in range(3):
            seq = list(base)
            for _ in range(100 * num + 31 * g):
                seq[rng.randrange(len(base))] = "ACGT"[rng.randrange(4)]
            write_fasta(str(d / f"genome_{num}_{g}.fna.gz"),
                        [FastaRecord(f"g{num}{g}", "".join(seq))])
    return str(root)


@pytest.mark.parametrize("exp_type", [2, 3, 4, 5, 6, 7, 8])
def test_cli_outputs_equal_jax_cli(database, tmp_path, exp_type):
    args = ["run", "--exp-type", str(exp_type), "--database-root", database,
            "--k-values", "7,8,12,21", "--kmers-per-dataset", "3000"]
    if exp_type == 8:  # exp8 simulates its own reads: 4 per read type and dataset
        (tmp_path / "config.yaml").write_text("NUM_READS_PER_DATASET: 4\n")
        args += ["--config", str(tmp_path / "config.yaml")]
    proc = subprocess.run(
        [sys.executable, "-m", "khoice_tpu_torch", *args, "--device", "cpu",
         "--work-root", str(tmp_path / "port")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert jax_main(args + ["--work-root", str(tmp_path / "jax")]) == 0
    port_files, jax_files = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port_files == jax_files
    assert "trial_summaries/trial_1_summary.txt" in port_files  # exp0 ran first
    assert len(port_files) > 10


def test_cli_device_budget_reaches_classification_sweeps(database, tmp_path):
    common = ["--database-root", database, "--work-root", str(tmp_path), "--device", "cpu",
              "--k-values", "7,8,12", "--kmers-per-dataset", "3000"]
    assert tcli.main(["run", "--exp-type", "0", *common]) == 0
    for exp_type in (2, 3, 4, 6):
        with pytest.raises(DeviceBudgetExceeded):
            tcli.main(["run", "--exp-type", str(exp_type), *common,
                       "--device-budget-gb", "1e-6"])


@pytest.mark.parametrize("exp_type", [0, 2, 5, 6, 7, 8])
def test_trials_use_the_jax_clis_work_roots(database, tmp_path, monkeypatch, exp_type):
    """`--trials 2` runs each trial in the work root the JAX CLI gives it:
    exp0's and exp6's trial-keyed outputs in the root, the others in
    trial_{t}_results/."""
    import khoice_tpu.cli as jcli

    roots = {"port": [], "jax": []}
    monkeypatch.setattr(tcli, "_run_one", lambda cfg, args, db, device, exp0_root, group: roots[
        "port"].append((cfg.curr_trial, cfg.work_root, exp0_root)) or 0)
    monkeypatch.setattr(jcli, "_run_one", lambda cfg, args, db, exp0_root: roots[
        "jax"].append((cfg.curr_trial, cfg.work_root, exp0_root)) or 0)
    args = ["run", "--exp-type", str(exp_type), "--database-root", database,
            "--work-root", str(tmp_path), "--trials", "2"]
    assert tcli.main(args + ["--device", "cpu"]) == 0 and jax_main(args) == 0
    assert roots["port"] == roots["jax"]
    assert [root == str(tmp_path) for _, root, _ in roots["port"]] == [exp_type in (0, 6)] * 2
