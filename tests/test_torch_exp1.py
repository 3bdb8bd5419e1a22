"""The port's exp1 (khoice_tpu_torch/pipelines/exp1.py and its CLI) vs the
JAX package's run_exp1 and the dict-based oracle, on the CPU: the step_5
and step_9 CSV bytes must be equal."""

import os
import subprocess
import sys

import pytest

from conftest import random_dna
from khoice_tpu.pipelines.exp1 import run_exp1 as jax_run_exp1
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

    proc = _cli("--exp-type", "5", "--device", "cpu", "--database-root", str(db),
                "--work-root", str(tmp_path / "w5"))
    assert proc.returncode != 0
    assert "python -m khoice_tpu" in proc.stderr and "not ported" in proc.stderr


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
    """Walking every module of the port and running exp 0/1/2/3/4/6 on
    the CPU, and exp 1/2 again on a 2-k grid (the per-k path), imports
    neither jax nor anything of the JAX package."""
    db = tmp_path / "db"
    _write_db(str(db), rng, glen=3000)  # long enough for exp0's ONT reads
    code = (
        "import sys, importlib, pkgutil\n"
        "import khoice_tpu_torch, khoice_tpu_torch.cli\n"
        "for m in pkgutil.walk_packages(khoice_tpu_torch.__path__, 'khoice_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from khoice_tpu_torch.cli import main\n"
        "for t in ('0', '1', '2', '3', '4', '6'):\n"
        f"    assert main(['run', '--exp-type', t, '--device', 'cpu', '--database-root', {str(db)!r},\n"
        f"                 '--work-root', {str(tmp_path / 'work')!r}, '--k-values', '7,9,12',\n"
        "                 '--kmers-per-dataset', '1000']) == 0\n"
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
    perk = tmp_path / "perk"
    assert (perk / "step_9/across_datasets_analysis.csv").exists()
    assert (perk / "within_dataset_analysis_type_2/within_dataset_analysis.csv").exists()
