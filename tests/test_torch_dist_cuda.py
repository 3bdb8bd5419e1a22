"""The key-range SPMD path (khoice_tpu_torch/dist/) on the card: a group of
one rank on NCCL, whose exchange, gathers and sums still run, gives the
single-device results on the card, through the same kernels; so do exp6's
sharded votes on two gloo ranks sharing the card.

Needs a CUDA device and skips without one.  The file imports no jax, so
it runs where the JAX package is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_dist_cuda.py
"""


import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_ranks
from khoice_tpu_torch.classify import annotate as ann
from khoice_tpu_torch.dist import ksweep_classify as dkc
from khoice_tpu_torch.dist import sharded as sh
from khoice_tpu_torch.dist.ksweep import sharded_occurrence_histograms_sweep
from khoice_tpu_torch.dist.launch import run_ranks
from khoice_tpu_torch.dist.mesh import init_kv_group
from khoice_tpu_torch.dist.occurrence import (
    sharded_occurrence_histogram,
    sharded_occurrence_histograms,
)
from khoice_tpu_torch.dist.vote import sharded_read_votes_multi
from khoice_tpu_torch.engine import ksweep_classify as kc
from khoice_tpu_torch.engine.ksweep import occurrence_histograms_sweep
from khoice_tpu_torch.engine.occurrence import occurrence_histogram
from khoice_tpu_torch.engine.session import KmerEngine
from khoice_tpu_torch.kernels import ksweep_scan, occ_scan
from khoice_tpu_torch.kernels import vote as kvote
from khoice_tpu_torch.kernels import sort as ksort

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

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



@pytest.mark.cuda
@pytest.mark.parametrize("n_members,length,launch", [(70, 3000, "packed"), (300, 400, "unpacked")])
def test_many_k_occurrence_on_one_slab_on_the_card(group, n_members, length, launch):
    """Every k of the batch reads a prefix of the one slab: kernel B past
    the sweep's mask, kernel C past 256 members, at halos of every length."""
    rng = np.random.default_rng(7)
    core = rng.integers(0, 4, length).astype(np.uint8)
    members = []
    for _ in range(n_members):
        g = core.copy()
        idx = rng.choice(length, length // 20, replace=False)
        g[idx] = rng.integers(0, 5, idx.shape[0])  # SNPs and Ns
        members.append(g)
    ks = [7, 16, 31, 49]
    before = occ_scan.launches[launch]
    got = sharded_occurrence_histograms(group, members, ks, cx=512)
    assert occ_scan.launches[launch] == before + len(ks)
    assert got == {k: occurrence_histogram(members, k, "cuda", cx=512) for k in ks}
    assert got == {k: sharded_occurrence_histogram(group, members, k, cx=512) for k in ks}


VOTE_KS = [11, 21, 33]


def _vote_world(seed=5):
    """(groups, read matrices): 4 related datasets of 2 members with N runs
    and poly-A tracts (_members), and per pivot reads from its own genome,
    random reads, an all-A read and a read with Ns, padded with 4s."""
    rng = np.random.default_rng(seed)
    members = _members(seed, n=8, length=6000)
    groups = [np.concatenate([members[2 * d], [4], members[2 * d + 1]]).astype(np.uint8)
              for d in range(4)]
    mats = []
    for d in range(4):
        rows = [members[2 * d][i:i + 150] for i in range(0, 3000, 97)]
        rows += [rng.integers(0, 4, 120).astype(np.uint8), np.zeros(80, np.uint8),
                 np.concatenate([rng.integers(0, 4, 60), [4, 4], rng.integers(0, 4, 60)])]
        mat = np.full((len(rows), 150), 4, np.uint8)
        for r, row in enumerate(rows):
            mat[r, :len(row)] = row
        mats.append(mat)
    return groups, mats


def _single_votes(groups, mats, k, device):
    texts = ann.pack_group_texts(groups, device)
    big, spans = ann.concat_flat_reads([ann.flat_reads_device(m, device) for m in mats])
    return [[a.tolist() for a in t]
            for t in ann.read_votes_bulk_multi(texts, big, spans, k, len(groups))]


@pytest.mark.cuda
def test_sharded_votes_on_the_card_equal_single_device(group):
    """exp6's sharded votes over the one-rank NCCL group launch A, the sort,
    vote_mask and read_votes, and equal the single-device votes on the card
    and on the CPU."""
    groups, mats = _vote_world()
    before = dict(kvote.launches)
    got = sharded_read_votes_multi(group, groups, mats, VOTE_KS)
    assert all(kvote.launches[n] == before[n] + len(VOTE_KS) for n in before)
    for k in VOTE_KS:
        want = _single_votes(groups, mats, k, "cuda")
        assert want == _single_votes(groups, mats, k, "cpu")
        assert [[a.tolist() for a in t] for t in got[k]] == want, f"k={k}"


@pytest.mark.cuda
def test_sharded_votes_two_gloo_ranks_on_one_card(group):
    """Two gloo ranks, both on cuda:0 (dist/launch.py::run_ranks): every
    rank's votes equal the single-device votes on the card, and the query
    windows the ranks received sum to its n_kmers."""
    groups, mats = _vote_world(seed=6)
    cases = {"card": {"groups": groups, "mats": mats, "ks": VOTE_KS, "bucket_cap": None}}
    ranks = run_ranks(2, torch_dist_ranks.votes, (cases, "cuda"), timeout_s=300)
    for i, k in enumerate(VOTE_KS):
        want = _single_votes(groups, mats, k, "cuda")
        for r in ranks:
            assert r["card"]["votes"][k] == want, f"k={k}"
        assert sum(r["card"]["received"][i] for r in ranks) == sum(sum(t[2]) for t in want)
