"""The key-range SPMD path (khoice_tpu_torch/dist/) on the card: a group of
one rank on NCCL, whose exchange, gathers and sums still run, gives the
single-device results on the card, through the same kernels.

Needs a CUDA device and skips without one.  The file imports no jax, so
it runs where the JAX package is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_dist_cuda.py
"""


import numpy as np
import pytest
import torch
import torch.distributed as dist

from khoice_tpu_torch.dist import ksweep_classify as dkc
from khoice_tpu_torch.dist import sharded as sh
from khoice_tpu_torch.dist.ksweep import sharded_occurrence_histograms_sweep
from khoice_tpu_torch.dist.mesh import init_kv_group
from khoice_tpu_torch.dist.occurrence import sharded_occurrence_histogram
from khoice_tpu_torch.engine import ksweep_classify as kc
from khoice_tpu_torch.engine.ksweep import occurrence_histograms_sweep
from khoice_tpu_torch.engine.occurrence import occurrence_histogram
from khoice_tpu_torch.engine.session import KmerEngine
from khoice_tpu_torch.kernels import ksweep_scan, occ_scan
from khoice_tpu_torch.kernels import sort as ksort

KS = [9, 12, 15, 21, 31, 35, 49]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank NCCL group on cuda:0, from a FileStore."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield init_kv_group("cuda")
    finally:
        dist.destroy_process_group()


def _members(seed=3, n=4, length=20000):
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 4, length).astype(np.uint8)
    out = []
    for i in range(n):
        g = core.copy()
        idx = rng.choice(length, 300 * (i + 1), replace=False)
        g[idx] = rng.integers(0, 4, idx.shape[0])
        g[1000 * i:1000 * i + 40] = 4  # an N run
        out.append(np.concatenate([g, np.zeros(500, np.uint8)]))  # a poly-A tract
    return out


def _plain(stats):
    """A sweep's ({k: stats}, leftover ks) as lists, comparable."""
    got, rest = stats
    return {k: ([np.asarray(v[0]).tolist(), v[1]] if isinstance(v, tuple)
                else np.asarray(v).tolist()) for k, v in got.items()}, list(rest)


@pytest.mark.cuda
def test_sharded_sweep_on_the_card_equals_single_device(group):
    members = _members()
    before = dict(ksweep_scan.launches)
    got = sharded_occurrence_histograms_sweep(group, members, KS, cx=16)
    assert ksweep_scan.launches["occ"] > before["occ"]
    assert got == occurrence_histograms_sweep(members, KS, "cuda", cx=16)
    assert got == occurrence_histograms_sweep(members, KS, "cpu", cx=16)
    D = len(members) - 1
    assert (_plain(dkc.sharded_pivot_rest_counts_sweep(group, members, KS))
            == _plain(kc.pivot_rest_counts_sweep(members, KS, device="cuda")))
    assert (_plain(dkc.sharded_feature_buckets_sweep(group, members, D, KS))
            == _plain(kc.feature_buckets_sweep(members, D, KS, device="cuda")))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 31])
def test_sharded_tables_and_occurrence_on_the_card(group, k):
    members = _members(n=3, length=5000)
    sorts = ksort.launches
    tables = [sh.sharded_set_counts(sh.sharded_count_codes(group, c, k), 1) for c in members]
    union = sh.sharded_union_many(tables, cs=5000)
    eng = KmerEngine("cuda")
    want = eng.union([eng.set_counts(eng.count_codes(c, k), 1) for c in members], cs=5000)
    assert union.dump() == want.dump()
    assert sh.sharded_histogram(union, cx=8).tolist() == eng.histogram(want, cx=8)
    assert ksort.launches > sorts
    packed = occ_scan.launches["packed"]
    got = sharded_occurrence_histogram(group, members, k, cx=8)
    assert occ_scan.launches["packed"] == packed + 1
    assert got == occurrence_histogram(members, k, "cuda", cx=8)
