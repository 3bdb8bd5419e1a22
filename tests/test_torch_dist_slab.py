"""The packed text's slabs and the sharded per-k path on one slab, on the
CPU.  A rank's slab of a text given as parts (engine/members.py::slab:
exp1's members with separators, one genome, exp6's texts and read rows)
holds the bytes of the JAX package's make_slabs over the parts' join, and
its member indices, in both forms, those of searchsorted over the
members' starts; a rank's slab on the device
(dist/occurrence.py::_make_slab_pair) is that slab with those indices,
and every smaller k's slab is its prefix.  The many-k entry
(`sharded_occurrence_histograms`) and exp1's sweep past the 64-member
mask (dist/ksweep.py::run_sweep_plan) build one slab a call and never
join the group whole, and give the histograms of the one-k calls and of
the single-device engine.

The ranks run on gloo through dist/launch.py::run_ranks at world sizes 1,
2 and 4 (the rank program is tests/torch_dist_ranks.py::slab_batches).
Every value is an integer count, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks
from khoice_tpu.dist.sharded import make_slabs
from khoice_tpu_torch.dist.launch import run_ranks
from khoice_tpu_torch.dist.occurrence import _make_slab_pair
from khoice_tpu_torch.dist.vote import _vote_layout
from khoice_tpu_torch.engine import members
from khoice_tpu_torch.engine.ksweep import plan_sweep
from khoice_tpu_torch.engine.occurrence import occurrence_histogram

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
SHARDS = [1, 2, 3, 4, 5, 7]


def _joined(member_codes):
    """The group's text joined (a separator code 4 after each member) and
    each member's first position."""
    codes = np.concatenate([np.append(m, np.uint8(4)) for m in member_codes]).astype(np.uint8)
    return codes, np.cumsum([0] + [m.shape[0] + 1 for m in member_codes[:-1]])


def _ids(starts, n, lo, hi):
    """Each position's member index in [lo, hi): the last member starting
    at or before it (the separator after a member is the member's), 0 past
    the text's n positions."""
    pos = np.arange(lo, hi)
    return np.where(pos < n, np.searchsorted(starts, pos, side="right") - 1, 0)


def _old_slab(member_codes, n_shards, k, rank):
    """The slab as the group's join gives it: the JAX package's make_slabs
    over the joined text, and each position's member index."""
    codes, starts = _joined(member_codes)
    slab = make_slabs(codes, n_shards, k)[rank]
    lo = rank * max(1, -(-codes.shape[0] // n_shards))
    return slab, _ids(starts, codes.shape[0], lo, lo + slab.shape[0])


def _texts(rng):
    return [rng.integers(0, 5, n).astype(np.uint8) for n in (40, 0, 23)]


def _reads(rng):
    return [rng.integers(0, 5, (3, 9)).astype(np.uint8), np.zeros((0, 5), np.uint8),
            rng.integers(0, 4, (2, 17)).astype(np.uint8)]


def _text(kind):
    """(members.py's parts, the same text joined independently, the
    members' first positions) of a text of `kind`."""
    rng = np.random.default_rng(23)
    if kind == "members":
        group = CASE["sets"]["packed"] + [np.zeros(0, np.uint8), np.array([4], np.uint8)]
        codes, starts = _joined(group)
        return members.layout(group)[0], codes, starts
    if kind == "genome":
        genome = rng.integers(0, 5, 997).astype(np.uint8)
        return [genome], genome, np.zeros(1, np.int64)
    texts, mats = _texts(rng), _reads(rng)
    codes, starts = _joined(texts)
    rows = [np.concatenate([m, np.full((m.shape[0], 1), 4, np.uint8)], 1).reshape(-1)
            for m in mats]
    parts = _vote_layout(texts, mats)[0]
    return parts, np.concatenate([codes] + rows), starts


@pytest.mark.parametrize("kind", ["members", "genome", "reads"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_members_slab_is_make_slabs_over_the_join(kind, n_shards):
    """engine/members.py::slab over a text's parts equals the JAX
    package's make_slabs over their join, at every rank and k, and the
    slab's member indices, over its range and at its positions, those of
    searchsorted over the members' starts."""
    parts, codes, starts = _text(kind)
    n = codes.shape[0]
    assert members.offsets(parts)[1] == n
    np.testing.assert_array_equal(members.join(parts), codes)
    for k in (1, 2, 7, 31, 49):
        want = make_slabs(codes, n_shards, k)
        for rank in range(n_shards):
            slab, lo = members.slab(parts, n_shards, k, rank)
            np.testing.assert_array_equal(slab, want[rank])
            assert lo == rank * members.chunk_len(n, n_shards)
            hi = lo + slab.shape[0]
            ids = members.member_ids(starts, n, lo, hi, "cpu")
            assert ids.dtype == torch.int64
            np.testing.assert_array_equal(ids.numpy(), _ids(starts, n, lo, hi))
            pos = torch.arange(lo, min(hi, n))
            np.testing.assert_array_equal(
                members.member_index(torch.from_numpy(starts), pos).numpy(),
                _ids(starts, n, lo, min(hi, n)))


RANGES = {  # (lo, hi) of a text of n positions
    "whole": lambda n: (0, n),
    "straddling": lambda n: (3, 20),  # the empty member's separator, a member, the next
    "across_the_end": lambda n: (n - 30, n + 25),
    "past_the_end": lambda n: (n + 5, n + 45),
    "empty": lambda n: (9, 9),
}


@pytest.mark.parametrize("where", RANGES)
def test_member_ids_range_and_positional_forms_agree(where):
    """The range form (pack_members' whole text, a slab's range) and the
    positional form agree on the text, and the range form is 0 past it."""
    group = [np.arange(7, dtype=np.uint8) % 5, np.zeros(0, np.uint8), np.zeros(3, np.uint8),
             CASE["sets"]["packed"][0]]
    _codes, starts = _joined(group)
    _parts, mstarts, n = members.layout(group)
    np.testing.assert_array_equal(mstarts, starts)
    lo, hi = RANGES[where](n)
    got = members.member_ids(mstarts, n, lo, hi, "cpu")
    np.testing.assert_array_equal(got.numpy(), _ids(starts, n, lo, hi))
    inside = torch.arange(lo, max(lo, min(hi, n)))
    assert torch.equal(got[:inside.shape[0]],
                       members.member_index(torch.from_numpy(mstarts), inside))
    assert not got[inside.shape[0]:].any()


@pytest.mark.parametrize("group", [
    [np.zeros(0, np.uint8), np.array([0, 1, 2], np.uint8), np.array([4], np.uint8)],
    [np.arange(5, dtype=np.uint8) % 5, np.zeros(0, np.uint8), np.zeros(0, np.uint8)],
    CASE["sets"]["packed"],
], ids=["tiny", "empty_tail", "packed"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_slab_is_make_slab_over_the_joined_group(group, n_shards):
    for rank in range(n_shards):
        big_codes, big_gids = _make_slab_pair(group, n_shards, 49, rank, "cpu")
        for k in (1, 2, 7, 31, 49):
            codes, gids = _make_slab_pair(group, n_shards, k, rank, "cpu")
            want_codes, want_gids = _old_slab(group, n_shards, k, rank)
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
