"""`run --exp-type 1-4 and 6 --mesh-shards N` of the port
(khoice_tpu_torch/cli.py over dist/) vs the JAX CLI's `--mesh-shards N`, on
the CPU.

The port's ranks are two processes of a gloo group started by
dist/launch.py::run_ranks, each calling `cli.main` (the rank program is
tests/torch_dist_ranks.py::run_cli), as `torchrun --nproc-per-node 2 -m
khoice_tpu_torch run ... --mesh-shards 2` would; the JAX CLI runs in this
process on two of the conftest's virtual CPU devices.  The CSVs must be
equal byte for byte (mirrors tests/test_sharded_occurrence.py::
test_cli_exp1_mesh_shards and tests/test_dist_classify.py's exp2/3/4 and
exp6 cases).  A config's `mesh_shards` takes the same path; a sharded run
without one process per rank exits non-zero before any work.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_ranks
from khoice_tpu.cli import main as jax_main
from khoice_tpu.io.fasta import FastaRecord, write_fasta
from khoice_tpu_torch import cli as tcli
from khoice_tpu_torch.dist.launch import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

KS = "7,11,21"  # one shared-sort class of three ks
CSVS = {
    1: ("step_5/within_datasets_analysis.csv", "step_9/across_datasets_analysis.csv"),
    2: ("within_dataset_analysis_type_2/within_dataset_analysis.csv",
        "across_dataset_analysis_type_2/across_dataset_analysis.csv"),
    3: ("final_analysis_type3/final_analysis_type3.csv",),
    4: ("accuracies_type_4/accuracy_values.csv",),
}


@pytest.fixture(scope="module")
def database(tmp_path_factory):
    """2 datasets x 3 related genomes of 3 kb (exp0's ONT reads need a few
    kb), made from a seed."""
    rng = np.random.default_rng(21)
    root = tmp_path_factory.mktemp("distdb")
    base = rng.integers(0, 4, 3000)
    for num in (1, 2):
        d = root / f"dataset_{num}"
        d.mkdir()
        for g in range(3):
            seq = base.copy()
            idx = rng.choice(3000, 90 * num + 30 * g, replace=False)
            seq[idx] = rng.integers(0, 4, idx.shape[0])
            write_fasta(str(d / f"genome_{num}_{g}.fna.gz"),
                        [FastaRecord(f"g{num}{g}", "".join("ACGT"[c] for c in seq))])
    return str(root)


def _read(path):
    with open(path, "rb") as fd:
        return fd.read()


def _args(exp_type, database, work):
    return ["run", "--exp-type", str(exp_type), "--database-root", database,
            "--work-root", str(work), "--k-values", KS, "--kmers-per-dataset", "2000"]


def test_cli_mesh_shards_equals_jax_cli(database, tmp_path):
    """exp 1, 2, 3 and 4 on 2 ranks (exp0 first, on rank 0), then exp1 again
    from a config's mesh_shards: 2, against the JAX CLI's --mesh-shards 2;
    then exp1 under a device budget too small for its sweep, which fails
    every rank (none is left waiting in a collective)."""
    config = tmp_path / "config.yaml"
    config.write_text("mesh_shards: 2\n")
    argvs = [_args(t, database, tmp_path / "port") + ["--device", "cpu", "--mesh-shards", "2"]
             for t in (1, 2, 3, 4)]
    argvs.append(_args(1, database, tmp_path / "yaml")
                 + ["--device", "cpu", "--config", str(config)])
    argvs.append(_args(1, database, tmp_path / "budget")
                 + ["--device", "cpu", "--mesh-shards", "2", "--device-budget-gb", "1e-6"])
    ranks = run_ranks(2, torch_dist_ranks.run_cli, (argvs,), timeout_s=300)
    # every run returned 0 but the last, which raised on both ranks; no
    # rank imported jax
    assert ranks == [([0] * 5 + ["DeviceBudgetExceeded"], False)] * 2
    for t in (1, 2, 3, 4):
        assert jax_main(_args(t, database, tmp_path / "jax") + ["--mesh-shards", "2"]) == 0
        for rel in CSVS[t]:
            port = _read(tmp_path / "port" / rel)
            assert port == _read(tmp_path / "jax" / rel), rel
            assert len(port.splitlines()) > 2
    for rel in CSVS[1]:
        assert _read(tmp_path / "yaml" / rel) == _read(tmp_path / "jax" / rel)
    # exp0 ran first, in the port's work root
    assert (tmp_path / "port" / "trial_summaries/trial_1_summary.txt").exists()


def _exp6_files(ks):
    """exp6's files under its work root: both read types' trial CSVs and
    every per-k matrix and accuracy file."""
    files = ["trial_1_short_acc.csv", "trial_1_long_acc.csv"]
    for rt in ("illumina", "ont"):
        for k in ks:
            files += [f"accuracies_type_6/{rt}/confusion_matrix/k_{k}_confusion_matrix.txt",
                      f"accuracies_type_6/{rt}/confusion_matrix/"
                      f"k_{k}_confusion_matrix_with_unidentified.txt",
                      f"accuracies_type_6/{rt}/values/k_{k}_accuracy_values.csv"]
    return files


def test_cli_exp6_mesh_shards_equals_jax_cli(database, tmp_path):
    """exp 6 on 2 ranks (exp0 first, on rank 0), then again from a config's
    mesh_shards: 2: every trial CSV and per-k file equals the JAX CLI's
    --mesh-shards 2 run's and its single-device run's, byte for byte."""
    config = tmp_path / "config.yaml"
    config.write_text("mesh_shards: 2\n")
    argvs = [_args(6, database, tmp_path / "port") + ["--device", "cpu", "--mesh-shards", "2"],
             _args(6, database, tmp_path / "yaml") + ["--device", "cpu", "--config", str(config)]]
    ranks = run_ranks(2, torch_dist_ranks.run_cli, (argvs,), timeout_s=300)
    assert ranks == [([0, 0], False)] * 2
    assert jax_main(_args(6, database, tmp_path / "jax") + ["--mesh-shards", "2"]) == 0
    assert jax_main(_args(6, database, tmp_path / "jax1")) == 0
    for rel in _exp6_files(KS.split(",")):
        want = _read(tmp_path / "jax" / rel)
        assert want == _read(tmp_path / "jax1" / rel), rel
        assert _read(tmp_path / "port" / rel) == want, rel
        assert _read(tmp_path / "yaml" / rel) == want, rel
    assert len(_read(tmp_path / "port" / "trial_1_long_acc.csv").splitlines()) == 1 + 3 * 2


@pytest.mark.parametrize("how", ["flag", "config", "world size 3", "exp 6"])
def test_cli_sharded_run_refused_before_any_work(database, tmp_path, monkeypatch, how):
    """mesh_shards 2 (the flag or a config's; exp 1, and exp 6, whose
    sharded votes take the same launch) needs WORLD_SIZE 2 from torchrun.
    Each exits non-zero with a message saying why, before reading the
    database or making the work root."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    work = tmp_path / "work"
    argv = _args(6 if how == "exp 6" else 1, database, work) + ["--device", "cpu"]
    if how == "config":
        config = tmp_path / "config.yaml"
        config.write_text("MESH_SHARDS: 2\n")
        argv += ["--config", str(config)]
    else:
        argv += ["--mesh-shards", "2"]
    if how == "world size 3":
        monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit) as exc:
        tcli.main(argv)
    assert "torchrun --nproc-per-node 2" in str(exc.value.code)
    assert not os.path.exists(work)


def test_torchrun_exp1_mesh_shards_equals_single_device(database, tmp_path):
    """The real launcher: `python -m torch.distributed.run --standalone
    --nproc-per-node 2 -m khoice_tpu_torch run --exp-type 1 --mesh-shards 2
    --device cpu` (gloo; RANK, LOCAL_RANK and WORLD_SIZE come from
    torchrun, as on N cards) writes the single-device CLI's CSV bytes, and
    rank 0 logs each rank's rows exchanged: as many sent as received over
    the group."""
    assert tcli.main(_args(1, database, tmp_path / "one") + ["--device", "cpu"]) == 0
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        ["timeout", "-k", "10", "240", sys.executable, "-m", "torch.distributed.run",
         "--standalone", "--nproc-per-node", "2", "-m", "khoice_tpu_torch",
         *_args(1, database, tmp_path / "torchrun"), "--mesh-shards", "2", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=270)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for rel in CSVS[1]:
        port = _read(tmp_path / "torchrun" / rel)
        assert port == _read(tmp_path / "one" / rel), rel
        assert len(port.splitlines()) > 2
    found = re.findall(r"exchange by rank: (\[.*\])", proc.stderr)
    assert len(found) == 1, proc.stderr[-4000:]
    ranks = json.loads(found[0])
    assert [r["rank"] for r in ranks] == [0, 1]
    assert sum(r["rows_sent"] for r in ranks) == sum(r["rows_received"] for r in ranks) > 0
    assert all(r["peak_device_bytes"] == 0 for r in ranks)  # the CPU has no device peak
