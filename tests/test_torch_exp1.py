"""The port's exp1 (khoice_tpu_torch/pipelines/exp1.py and its CLI) vs the
JAX package's run_exp1 and the dict-based oracle, on the CPU: the step_5
and step_9 CSV bytes must be equal."""

import os
import subprocess
import sys

import pytest

from conftest import random_dna
from khoice_tpu.engine.session import KmerEngine as JaxEngine
from khoice_tpu.pipelines.exp1 import run_exp1 as jax_run_exp1
from khoice_tpu_torch.engine.session import KmerEngine
from khoice_tpu_torch.engine.streaming import DeviceBudgetExceeded
from khoice_tpu_torch.pipelines.exp1 import run_exp1
from test_exp1 import make_groups, oracle_exp1_csvs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(path):
    with open(path, "rb") as fd:
        return fd.read()


@pytest.mark.parametrize("ks", [[11, 21, 31, 35], [5, 12, 21, 31, 33, 45, 49]])
def test_exp1_csvs_equal_jax_and_oracle(rng, tmp_path, ks):
    groups = make_groups(rng, n_groups=2, genomes_per_group=3, glen=300)
    port = run_exp1(groups, ks, str(tmp_path / "port"), "cpu")
    ref = jax_run_exp1(groups, ks, str(tmp_path / "jax"), fused=True)
    o5, o9 = oracle_exp1_csvs(groups, ks, str(tmp_path / "oracle"))
    assert _read(port["step_5"]) == _read(ref["step_5"]) == _read(o5)
    assert _read(port["step_9"]) == _read(ref["step_9"]) == _read(o9)
    assert len(_read(port["step_5"]).decode().strip().split("\n")) == 1 + 2 * len(ks)
    # the step_4/step_8 histogram files are the JAX package's too
    for k in ks:
        rel = f"step_8/k_{k}/all_datasets_k{k}_hist.txt"
        assert _read(tmp_path / "port" / rel) == _read(tmp_path / "jax" / rel)


def test_exp1_table_ops_equal_jax_and_fused(rng, tmp_path):
    """fused=False (the kmc_tools-shaped table ops) at ks of every word
    class: the JAX package's fused=False CSVs and step_4/step_8 files, and
    the port's fused CSVs; write_hists=False gives the same CSVs from
    memory and writes no histogram file."""
    ks = [11, 21, 31, 35]
    groups = make_groups(rng, n_groups=2, genomes_per_group=3, glen=300)
    ref = jax_run_exp1(groups, ks, str(tmp_path / "jax"), fused=False)
    fused = run_exp1(groups, ks, str(tmp_path / "fused"), "cpu")
    ops = run_exp1(groups, ks, str(tmp_path / "ops"), "cpu", engine=KmerEngine("cpu"),
                   fused=False)
    mem = run_exp1(groups, ks, str(tmp_path / "mem"), "cpu", fused=False, write_hists=False)
    for step in ("step_5", "step_9"):
        assert _read(ops[step]) == _read(ref[step]) == _read(fused[step]) == _read(mem[step])
    for k in ks:
        for rel in [f"step_4/k_{k}/dataset_{num}/dataset_{num}_k{k}_hist.txt" for num in groups] + [
                f"step_8/k_{k}/all_datasets_k{k}_hist.txt"]:
            assert _read(tmp_path / "ops" / rel) == _read(tmp_path / "jax" / rel)
    assert sorted(os.listdir(tmp_path / "mem")) == ["step_5", "step_9"]


def test_exp1_table_ops_check_the_budget(rng, tmp_path):
    groups = make_groups(rng, n_groups=2, genomes_per_group=2, glen=200)
    with pytest.raises(DeviceBudgetExceeded, match="count"):
        run_exp1(groups, [11], str(tmp_path), "cpu", fused=False, device_budget_bytes=1000)


@pytest.mark.parametrize("k", [11, 21, 31, 35])
def test_count_seqs_dump_equals_jax(rng, k):
    seqs = [random_dna(rng, 300, n_prob=0.02), random_dna(rng, 120), "ACGT" * 10 + "A" * 40]
    got = KmerEngine("cpu").count_seqs(seqs, k, cs=3)
    want = JaxEngine().count_seqs(seqs, k, cs=3)
    assert got.dump() == want.dump()
    assert max(c for _, c in got.dump()) == 3  # the poly-A run saturates at cs


def _write_db(root, rng, n_datasets=2, n_genomes=2, glen=400):
    for d in range(1, n_datasets + 1):
        os.makedirs(os.path.join(root, f"dataset_{d}"))
        for g in range(1, n_genomes + 1):
            with open(os.path.join(root, f"dataset_{d}", f"genome_{g}.fna"), "w") as fd:
                fd.write(f">d{d}g{g}\n{random_dna(rng, glen, n_prob=0.01)}\n"
                         f">d{d}g{g}_p\n{random_dna(rng, 90)}\n")


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "khoice_tpu_torch", "run", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )


def test_cli_exp1_on_cpu_and_unported_exp_types(rng, tmp_path):
    db = tmp_path / "db"
    _write_db(str(db), rng)
    work = tmp_path / "work"
    proc = _cli("--exp-type", "1", "--device", "cpu", "--database-root", str(db),
                "--work-root", str(work), "--k-values", "11,21,31,35")
    assert proc.returncode == 0, proc.stderr
    step5 = _read(work / "step_5/within_datasets_analysis.csv").decode()
    step9 = _read(work / "step_9/across_datasets_analysis.csv").decode()
    assert len(step5.strip().split("\n")) == 1 + 2 * 4
    assert len(step9.strip().split("\n")) == 1 + 4

    # a sharded run outside torchrun (no process per rank) and what does
    # not exist exit non-zero before any work
    proc = _cli("--exp-type", "1", "--device", "cpu", "--database-root", str(db),
                "--work-root", str(tmp_path / "w2"), "--mesh-shards", "2")
    assert proc.returncode != 0
    assert "torchrun --nproc-per-node 2" in proc.stderr
    proc = _cli("--exp-type", "9", "--device", "cpu", "--database-root", str(db),
                "--work-root", str(tmp_path / "w9"))
    assert proc.returncode != 0 and "unknown exp type 9" in proc.stderr
    assert not (tmp_path / "w2").exists() and not (tmp_path / "w9").exists()


def test_cli_without_cuda_fails_loudly(rng, tmp_path):
    """The default device is cuda; with no card and no --device cpu the
    run refuses instead of falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    db = tmp_path / "db"
    _write_db(str(db), rng, n_datasets=1)
    proc = _cli("--exp-type", "1", "--database-root", str(db),
                "--work-root", str(tmp_path / "work"))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "work/step_5").exists()


def test_port_never_imports_jax(rng, tmp_path):
    """Walking every module of the port and running exp 0-8 on the CPU
    (exp 5, 7 and 8 with the native MS engine; exp8 on 4 reads per read
    type and dataset), exp1 again with the table ops, and exp 1/2 again
    on a 2-k grid (the per-k path), imports neither jax nor anything of
    the JAX package."""
    db = tmp_path / "db"
    _write_db(str(db), rng, glen=3000)  # long enough for exp0's ONT reads
    config = tmp_path / "config.yaml"
    config.write_text("NUM_READS_PER_DATASET: 4\n")
    code = (
        "import sys, importlib, pkgutil\n"
        "import khoice_tpu_torch, khoice_tpu_torch.cli\n"
        "for m in pkgutil.walk_packages(khoice_tpu_torch.__path__, 'khoice_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from khoice_tpu_torch.cli import main\n"
        "for t in ('0', '1', '2', '3', '4', '5', '6', '7', '8'):\n"
        f"    assert main(['run', '--exp-type', t, '--device', 'cpu', '--database-root', {str(db)!r},\n"
        f"                 '--work-root', {str(tmp_path / 'work')!r}, '--k-values', '7,9,12',\n"
        f"                 '--kmers-per-dataset', '1000', '--config', {str(config)!r}]) == 0\n"
        "import khoice_tpu_torch.mems.ms as ms\n"
        "assert ms._LIB is not None\n"
        "from khoice_tpu_torch.pipelines.exp0 import load_database_dir\n"
        "from khoice_tpu_torch.pipelines.exp1 import run_exp1\n"
        f"db = load_database_dir({str(db)!r})\n"
        "groups = {n: [db[n][g] for g in sorted(db[n])] for n in db}\n"
        f"run_exp1(groups, [7, 9, 12], {str(tmp_path / 'ops')!r}, 'cpu', fused=False)\n"
        "for t in ('1', '2'):\n"
        f"    assert main(['run', '--exp-type', t, '--device', 'cpu', '--database-root', {str(db)!r},\n"
        f"                 '--work-root', {str(tmp_path / 'perk')!r}, '--k-values', '11,31',\n"
        "                 '--kmers-per-dataset', '1000']) == 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'khoice_tpu' or m.startswith('khoice_tpu.'))\n"
        "assert not bad, bad\n"
        "print('no jax')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout
    work = tmp_path / "work"
    assert (work / "step_9/across_datasets_analysis.csv").exists()
    assert (work / "trial_summaries/trial_1_summary.txt").exists()
    assert (work / "across_dataset_analysis_type_2/across_dataset_analysis.csv").exists()
    assert (work / "final_analysis_type3/final_analysis_type3.csv").exists()
    assert (work / "accuracies_type_4/accuracy_values.csv").exists()
    assert (work / "trial_1_short_acc.csv").exists() and (work / "trial_1_long_acc.csv").exists()
    assert (work / "output_type_5/half_mems/confusion_matrix.csv").exists()
    assert (work / "final_output_type_7/trial_1_mems_ont.csv").exists()
    assert (work / "output_type_8/half_mems/t_30/illumina/confusion_matrix.csv").exists()
    assert (_read(tmp_path / "ops/step_9/across_datasets_analysis.csv")
            == _read(work / "step_9/across_datasets_analysis.csv"))
    perk = tmp_path / "perk"
    assert (perk / "step_9/across_datasets_analysis.csv").exists()
    assert (perk / "within_dataset_analysis_type_2/within_dataset_analysis.csv").exists()
