"""The per-k path's kernels (khoice_tpu_torch/csrc/extract_canonical.cu and
csrc/occ_scan.cu) vs their plain PyTorch versions on the card, exact
equality.

Needs a CUDA device and skips without one.  The file imports no jax, so
it runs where the JAX package is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_perk_cuda.py
"""

import numpy as np
import pytest
import torch

from khoice_tpu_torch.engine import occurrence as occ
from khoice_tpu_torch.kernels import extract, occ_scan
from khoice_tpu_torch.kernels.sort import sort_words

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

SENT = 0xFFFFFFFF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codes(rng, n, n_prob=0.01):
    c = rng.integers(0, 4, size=n, dtype=np.uint8)
    c[rng.random(n) < n_prob] = 4
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 63, 2047, 2048, 2049, 65537])
@pytest.mark.parametrize("k", [2, 7, 15, 16, 31, 32, 49, 60, 63])
def test_extract_kernel_equals_plain(cuda, n, k):
    rng = np.random.default_rng(n * 100 + k)
    codes = torch.from_numpy(_codes(rng, n)).to(cuda)
    before = dict(extract.launches)
    keys, valid = extract.extract_canonical(codes, k)
    torch.cuda.synchronize()
    assert extract.launches["keys"] == before["keys"] + 1
    want_keys, want_valid = extract.extract_canonical_reference(codes, k)
    assert torch.equal(valid, want_valid) and torch.equal(keys, want_keys)
    if k <= 60:
        gids = torch.from_numpy(rng.integers(0, 256, n)).to(cuda)
        got = extract.extract_packed(codes, gids, k)
        assert extract.launches["packed"] == before["packed"] + 1
        assert torch.equal(got, extract.extract_packed_reference(codes, gids, k))


@pytest.mark.cuda
def test_extract_kernel_all_invalid_and_rejects(cuda):
    codes = torch.full((5000,), 4, dtype=torch.uint8, device=cuda)
    keys, valid = extract.extract_canonical(codes, 21)
    assert not valid.any() and bool((keys == SENT).all())
    with pytest.raises(ValueError):
        extract.extract_canonical(codes.to(torch.int64), 21)
    with pytest.raises(ValueError):
        extract.extract_packed(codes, torch.zeros(5000, dtype=torch.int64, device=cuda), 61)


def _group(rng, g, n, poly_a=0):
    base = _codes(rng, n)
    out = []
    for i in range(g):
        c = base.copy()
        pos = rng.integers(0, n, max(n // 40, 1))
        c[pos] = rng.integers(0, 4, pos.shape[0], dtype=np.uint8)
        out.append(c[: n - i % 7])
    if poly_a:  # one key run across many blocks
        out[0] = np.concatenate([out[0], np.zeros(poly_a, np.uint8)])
    return out


def _sorted(members, k, packed, device):
    codes, gids = occ.pack_members(members, device)
    return occ._sorted_pairs(codes, gids, k, packed)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "g,n,poly_a,k",
    [
        (1, 300, 0, 11),         # less than one block
        (8, 20000, 9000, 21),    # poly-A run across blocks
        (96, 2000, 0, 31),       # exp1's large-group shape, small
        (256, 300, 0, 13),       # the most members the packed layout takes
        (5, 20000, 0, 49),       # four packed words
        (3, 5000, 0, 60),        # the largest packed k
    ],
)
def test_occ_hist_packed_kernel_equals_plain(cuda, g, n, poly_a, k):
    rng = np.random.default_rng(g * 1000 + n)
    words, _ = _sorted(_group(rng, g, n, poly_a), k, True, cuda)
    for cs, n_bins in ((5000, g), (3, g), (5000, max(g // 2, 1))):
        before = occ_scan.launches["packed"]
        got = occ_scan.occ_hist_packed(words, n_bins, cs)
        torch.cuda.synchronize()
        assert occ_scan.launches["packed"] == before + 1
        want = occ_scan.occ_hist_packed_reference(words, n_bins, cs)
        assert want.sum() > 0 and torch.equal(got, want), (cs, n_bins)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "g,n,poly_a,k",
    [
        (257, 300, 0, 13),       # one member past the packed layout
        (300, 1000, 5000, 31),   # poly-A run across blocks
        (4, 20000, 0, 61),       # k past the packed layout
        (2, 3000, 0, 5),         # one key word
    ],
)
def test_occ_hist_kernel_equals_plain(cuda, g, n, poly_a, k):
    rng = np.random.default_rng(g * 1000 + n + 1)
    keys, gid = _sorted(_group(rng, g, n, poly_a), k, False, cuda)
    for cs, n_bins in ((5000, g), (7, g), (5000, 10000)):
        before = occ_scan.launches["unpacked"]
        got = occ_scan.occ_hist(keys, gid, n_bins, cs)
        torch.cuda.synchronize()
        assert occ_scan.launches["unpacked"] == before + 1
        want = occ_scan.occ_hist_reference(keys, gid, n_bins, cs)
        assert want.sum() > 0 and torch.equal(got, want), (cs, n_bins)


@pytest.mark.cuda
def test_occ_hist_ragged_and_all_sentinel(cuda):
    rng = np.random.default_rng(5)
    for n in (1, 2, 2047, 2048, 2049, 65537):
        # W = 2 packed: sorted run keys, (key << 8) | gid
        key = np.sort(rng.integers(0, n // 3 + 1, n)).astype(np.int64)
        w1 = ((key & 0xFFFFFF) << 8) | rng.integers(0, 40, n)
        words = torch.from_numpy(np.stack([key >> 24, w1])).to(cuda)
        words, _ = sort_words(words)
        got = occ_scan.occ_hist_packed(words, 40, 5000)
        assert torch.equal(got, occ_scan.occ_hist_packed_reference(words, 40, 5000)), n
        gid = torch.from_numpy(rng.integers(0, 300, n)).to(cuda)
        pairs, _ = sort_words(torch.stack([words[0], gid]))  # sorted by (key, gid)
        got = occ_scan.occ_hist(pairs[:1], pairs[1], 300, 5000)
        assert torch.equal(got, occ_scan.occ_hist_reference(pairs[:1], pairs[1], 300, 5000)), n
    sent = torch.full((3, 70000), SENT, dtype=torch.int64, device=cuda)
    assert occ_scan.occ_hist_packed(sent, 10, 5000).sum() == 0
    assert occ_scan.occ_hist(sent[:2], sent[2], 10, 5000).sum() == 0


def _pairs(key, gid, W, packed, device, sentinels=0):
    """Sorted (key, gid) pairs in a layout: packed, int64 [W, n] words of
    (key << 8) | gid (gid < 256, key < 2^(32 W - 8)); else (int64 [W, n]
    key words, int64 [n] gid).  The last `sentinels` elements are the
    SENTINEL (and gid 0xFFFFFFFF apart)."""
    order = np.lexsort((gid, key))
    key, gid = key[order].astype(np.int64), gid[order].astype(np.int64)
    value = (key << 8) | gid if packed else key
    rows = np.zeros((W, key.shape[0]), np.int64)
    rows[W - 1] = value & 0xFFFFFFFF
    if W > 1:
        rows[W - 2] = value >> 32
    if sentinels:
        rows[:, -sentinels:] = SENT
        gid[-sentinels:] = SENT
    words = torch.from_numpy(rows).to(device)
    return words if packed else (words, torch.from_numpy(gid).to(device))


def _tile():
    return occ_scan._build.load().occ_scan_tile_elems()


def _case(name, rng, T):
    """(sorted keys, gids) of a named edge case for a tile of T elements."""
    if name == "one key":  # the look-back's chain crosses every tile
        n = 5 * T + 3
        return np.zeros(n, np.int64), rng.integers(0, 200, n)
    if name == "distinct":
        n = 3 * T + 1
        return np.arange(n, dtype=np.int64) * 7, rng.integers(0, 200, n)
    if name.startswith("run to a tile edge"):  # runs of T (+ 1) from each tile's start
        extra = int(name[-2:])
        key = np.repeat(np.arange(4), [T + extra, T, 7, 3 * T])
        return key.astype(np.int64), np.arange(key.shape[0]) % 37
    if name.startswith("n = T"):
        n = T + int(name[5:])
        return np.sort(rng.integers(0, n // 3 + 1, n)), rng.integers(0, 200, n)
    if name == "more tiles than blocks":
        n = 1200 * T + 1
        return np.sort(rng.integers(0, n // 3, n)), rng.integers(0, 200, n)
    raise ValueError(name)


CASES = ["one key", "distinct", "run to a tile edge +0", "run to a tile edge +1",
         "n = T-1", "n = T+0", "n = T+1", "more tiles than blocks"]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("name", CASES)
def test_occ_hist_kernel_edges(cuda, name, W, packed):
    """Each layout against its plain version on the look-back's and the
    loads' edge cases, with cs and n_bins below the member count too;
    one launch per call."""
    rng = np.random.default_rng(len(name) * 10 + W)
    key, gid = _case(name, rng, _tile())
    if W == 1 and packed:
        key = key % (1 << 24)
        key.sort()
    layout = "packed" if packed else "unpacked"
    args = _pairs(key, gid, W, packed, cuda, sentinels=5)
    counted = 0
    for cs, n_bins in ((5000, 200), (3, 200), (5000, 60)):
        before = occ_scan.launches[layout]
        if packed:
            got = occ_scan.occ_hist_packed(args, n_bins, cs)
            want = occ_scan.occ_hist_packed_reference(args, n_bins, cs)
        else:
            got = occ_scan.occ_hist(*args, n_bins, cs)
            want = occ_scan.occ_hist_reference(*args, n_bins, cs)
        torch.cuda.synchronize()
        assert occ_scan.launches[layout] == before + 1
        assert torch.equal(got, want), (cs, n_bins)
        counted += int(want.sum())
    assert counted > 0


@pytest.mark.cuda
def test_occ_hist_kernel_most_bins_and_an_unaligned_gid(cuda):
    """n_bins at occ_scan_bins_max() with runs of as many distinct gids;
    a gid row at an 8-byte offset gives the same (the loads need 8-B
    alignment only)."""
    bins = occ_scan._build.load().occ_scan_bins_max()
    sizes = [bins, bins - 1, 4, bins // 2, bins + 5]
    key = np.repeat(np.arange(len(sizes), dtype=np.int64), sizes)
    gid = np.concatenate([np.arange(s) for s in sizes])
    keys, g = _pairs(key, gid, 2, False, cuda)
    want = occ_scan.occ_hist_reference(keys, g, bins, 1 << 30)
    assert want[bins - 1] == 1 and want[bins - 2] == 1
    assert torch.equal(occ_scan.occ_hist(keys, g, bins, 1 << 30), want)
    shifted = torch.cat([g.new_zeros(1), g])[1:]
    assert shifted.data_ptr() % 16 == 8
    assert torch.equal(occ_scan.occ_hist(keys, shifted, bins, 1 << 30), want)
