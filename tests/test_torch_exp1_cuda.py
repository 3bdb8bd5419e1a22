"""exp1's table-op path (khoice_tpu_torch/pipelines/exp1.py, fused=False)
and the table I/O on the card: the same CSV bytes as the fused path on the
card and as the table ops on the CPU, with the extraction kernel (A) and
the radix sort launched.

Needs a CUDA device and skips without one.  The file imports no jax, so
it runs where the JAX package is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_exp1_cuda.py
"""

import numpy as np
import pytest
import torch

from khoice_tpu_torch.engine import table_io
from khoice_tpu_torch.engine.session import KmerEngine
from khoice_tpu_torch.kernels import extract
from khoice_tpu_torch.kernels import sort as ksort
from khoice_tpu_torch.pipelines.exp1 import run_exp1

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

KS = [11, 21, 31, 35]  # every key-word class of the sweep and the per-k path


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _groups(seed=5, n_groups=2, members=3, length=5000):
    """Groups of related genomes (a shared core with mutations, an N run)."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 4, length)
    groups = {}
    for num in range(1, n_groups + 1):
        genomes = []
        for _ in range(members):
            g = core.copy()
            at = rng.integers(0, length, length // 20 * num)
            g[at] = rng.integers(0, 4, at.size)
            seq = "".join("ACGT"[b] for b in g)
            genomes.append([seq[:2000] + "NNNN" + seq[2000:], seq[:300]])
        groups[num] = genomes
    return groups


def _read(path):
    with open(path, "rb") as fd:
        return fd.read()


@pytest.mark.cuda
def test_table_ops_on_the_card_equal_fused_and_cpu(cuda, tmp_path):
    groups = _groups()
    fused = run_exp1(groups, KS, str(tmp_path / "fused"), cuda)
    before_a, before_sort = extract.launches["keys"], ksort.launches
    ops = run_exp1(groups, KS, str(tmp_path / "ops"), cuda, fused=False)
    torch.cuda.synchronize()
    counts = sum(len(g) for g in groups.values()) * len(KS)
    assert extract.launches["keys"] - before_a == counts
    assert ksort.launches - before_sort == counts + (len(groups) + 1) * len(KS)
    cpu = run_exp1(groups, KS, str(tmp_path / "cpu"), "cpu", fused=False, write_hists=False)
    for step in ("step_5", "step_9"):
        assert _read(ops[step]) == _read(fused[step]) == _read(cpu[step])


@pytest.mark.cuda
def test_count_seqs_and_table_io_on_the_card(cuda, tmp_path):
    seqs = [s for genome in _groups(seed=9, n_groups=1, members=2)[1] for s in genome]
    for k in (13, 31, 49):
        t = KmerEngine(cuda).count_seqs(seqs, k)
        assert t.device.type == "cuda"
        assert t.dump() == KmerEngine("cpu").count_seqs(seqs, k).dump()
        table_io.save_table(str(tmp_path / f"t{k}.npz"), t)
        back = table_io.load_table(str(tmp_path / f"t{k}.npz"))
        assert back.device.type == "cuda" and torch.equal(back.keys, t.keys)
        assert torch.equal(back.counts, t.counts)
        table_io.write_kmc_binary(str(tmp_path / f"db{k}"), t)
        assert table_io.read_kmc_binary(str(tmp_path / f"db{k}")).dump() == t.dump()
