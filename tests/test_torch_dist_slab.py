"""The sharded per-k path on one slab, on the CPU: a rank's slab
(dist/occurrence.py::_make_slab_pair) holds the bytes of
dist/sharded.py::make_slab over the joined group, and every smaller k's
slab is its prefix; the many-k entry (`sharded_occurrence_histograms`)
and exp1's sweep past the 64-member mask (dist/ksweep.py::run_sweep_plan)
build one slab a call and never join the group whole, and give the
histograms of the one-k calls and of the single-device engine.

The ranks run on gloo through dist/launch.py::run_ranks at world sizes 1,
2 and 4 (the rank program is tests/torch_dist_ranks.py::slab_batches).
Every value is an integer count, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks
from khoice_tpu_torch.dist.launch import run_ranks
from khoice_tpu_torch.dist.occurrence import _make_slab_pair
from khoice_tpu_torch.dist.sharded import make_slab
from khoice_tpu_torch.engine.ksweep import plan_sweep
from khoice_tpu_torch.engine.occurrence import _member_layout, occurrence_histogram

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

WORLD_SIZES = (1, 2, 4)
RANK_TIMEOUT_S = 240
KS = [7, 16, 31, 49]  # halos of 6, 15, 30 and 48 positions: prefixes of every length
SWEEP_KS = [7, 9, 11, 16, 21, 31, 49]
CX = 400


def _related(rng, n_members, length, mutations):
    """Members mutated from one random base, with runs of the invalid
    code 4 and a poly-A block, as uint8 codes."""
    base = rng.integers(0, 4, length).astype(np.uint8)
    base[length // 3:length // 3 + length // 8] = 0
    out = []
    for _ in range(n_members):
        m = base.copy()
        idx = rng.choice(length, mutations, replace=False)
        m[idx] = rng.integers(0, 5, mutations)
        out.append(m[:length - int(rng.integers(0, length // 10))])
    return out


def _case():
    rng = np.random.default_rng(22)
    return {
        "sets": {
            "packed": _related(rng, 3, 1500, 60),  # kernel B at every k
            "apart": _related(rng, 300, 90, 4),  # > 256 members: the gid apart, kernel C
        },
        "sweep": _related(rng, 70, 400, 12),  # past the mask: every k on the per-k path
        "ks": KS,
        "sweep_ks": SWEEP_KS,
        "cx": CX,
    }


CASE = _case()


def _old_slab(member_codes, n_shards, k, rank):
    """The slab as the group's join gives it: make_slab over
    _member_layout's codes, and each position's member index (the
    separator after a member is the member's; 0 past the codes)."""
    codes, _starts = _member_layout(member_codes)
    slab = make_slab(codes, n_shards, k, rank)
    chunk = max(1, -(-codes.shape[0] // n_shards))
    layout_gids = np.repeat(np.arange(len(member_codes)), [m.shape[0] + 1 for m in member_codes])
    gids = np.zeros(slab.shape[0], np.int64)
    part = layout_gids[rank * chunk:rank * chunk + slab.shape[0]]
    gids[:part.shape[0]] = part
    return slab, gids


@pytest.mark.parametrize("members", [
    [np.zeros(0, np.uint8), np.array([0, 1, 2], np.uint8), np.array([4], np.uint8)],
    [np.arange(5, dtype=np.uint8) % 5, np.zeros(0, np.uint8), np.zeros(0, np.uint8)],
    CASE["sets"]["packed"],
], ids=["tiny", "empty_tail", "packed"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5, 7])
def test_slab_is_make_slab_over_the_joined_group(members, n_shards):
    for rank in range(n_shards):
        big_codes, big_gids = _make_slab_pair(members, n_shards, 49, rank, "cpu")
        for k in (1, 2, 7, 31, 49):
            codes, gids = _make_slab_pair(members, n_shards, k, rank, "cpu")
            want_codes, want_gids = _old_slab(members, n_shards, k, rank)
            assert codes.dtype == torch.uint8 and gids.dtype == torch.int64
            np.testing.assert_array_equal(codes.numpy(), want_codes)
            np.testing.assert_array_equal(gids.numpy(), want_gids)
            # every k's slab is the prefix of the largest k's
            assert torch.equal(big_codes[:codes.shape[0]], codes)
            assert torch.equal(big_gids[:gids.shape[0]], gids)


@pytest.fixture(scope="module")
def ranks():
    """{world size: every rank's outputs}, each world size's ranks started
    once, on first use."""
    cache = {}

    def get(world_size):
        if world_size not in cache:
            cache[world_size] = run_ranks(world_size, torch_dist_ranks.slab_batches, (CASE,),
                                          timeout_s=RANK_TIMEOUT_S)
        return cache[world_size]

    return get


@pytest.fixture(scope="module")
def single():
    """The single-device engine's histogram of every set at every k."""
    sets = dict(CASE["sets"], sweep=CASE["sweep"])
    return {name: {k: occurrence_histogram(members, k, "cpu", cx=CX)
                   for k in sorted(set(KS) | set(SWEEP_KS))}
            for name, members in sets.items()}


@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_many_k_entry_equals_one_k_calls(ranks, single, world_size):
    outs = ranks(world_size)
    assert [out["world_size"] for out in outs] == [world_size] * world_size
    for name in CASE["sets"]:
        want = {k: single[name][k] for k in KS}
        assert any(sum(h[1:]) for h in want.values()), name
        for out in outs:
            assert out[name]["many"]["got"] == out[name]["one"]["got"] == want, name


@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_many_k_entry_builds_one_slab_a_call(ranks, world_size):
    for out in ranks(world_size):
        for name in CASE["sets"]:
            assert out[name]["many"]["builds"] == [max(KS)], name  # however many ks
            assert out[name]["one"]["builds"] == KS, name  # one a call
            assert out[name]["many"]["joins"] == out[name]["one"]["joins"] == [], name


@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_sweep_past_the_mask_equals_per_k_on_one_device(ranks, single, world_size):
    classes, remaining = plan_sweep(SWEEP_KS, len(CASE["sweep"]))
    assert (classes, remaining) == ([], SWEEP_KS)
    for out in ranks(world_size):
        assert out["sweep"]["got"] == single["sweep"]
        # the per-k batch's one slab, and no join of the group
        assert out["sweep"]["builds"] == [max(SWEEP_KS)]
        assert out["sweep"]["joins"] == []
