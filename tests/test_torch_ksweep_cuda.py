"""The multi-k scan kernel (khoice_tpu_torch/csrc/ksweep_scan.cu) vs its
plain PyTorch version on the card, exact equality: on sorted doubled
texts, and on synthetic sorted keys whose runs cross a thread (8
elements), a warp (256), a tile (2048) and more than two tiles at every
k, and whose clusters share prefixes of chosen depths, so that only some
ks cross in a block (`synthetic_sorted`, also used by
test_torch_classify_cuda.py).

Needs a CUDA device and skips without one.  The file imports no jax, so
it runs where the JAX package is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_ksweep_cuda.py
"""

import numpy as np
import pytest
import torch

from khoice_tpu_torch.engine.ksweep import (
    MASK_MEMBERS,
    _sweep_doubled,
    plan_sweep,
    scan_multi_k_reference,
)
from khoice_tpu_torch.engine.occurrence import pack_members
from khoice_tpu_torch.kernels import ksweep_scan

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

K_GRID = list(range(7, 31)) + list(range(34, 50, 3))
TILE = 2048  # elements per tile of the kernel (ksweep_scan_tile_elems)

# (elements, shared key bits or None for all) of the clusters every
# synthetic array holds: one run over three tiles, one over two, one over
# a warp, and a 40-bit prefix shared by half a tile's keys
FIXED_CLUSTERS = ((2 * TILE + 300, None), (TILE + 17, None), (300, None), (TILE // 2, 40))


def synthetic_sorted(rng, KW, packed, n, n_members, kmax):
    """(int64 [KW, n] sorted key words, int64 [n] payload or None) of
    clusters of keys sharing their top D bits: the fixed clusters, then
    random ones (1 to 300 elements, D from 6 bits to all, some of them
    palindromic prefixes); gid uniform, nio kmax for 3 elements in 4."""
    spare = 12 if packed else 0
    bits = KW * 32 - spare
    keys = []

    def cluster(m, depth, pal=0):
        base = int(rng.integers(0, 2**62)) << 66 | int(rng.integers(0, 2**62)) << 4
        base >>= 128 - bits
        if pal:  # the top pal bases read the same on the reverse strand
            half = [int(b) for b in rng.integers(0, 4, pal // 2)]
            top = half + [3 - b for b in reversed(half)]
            v = 0
            for b in top:
                v = v << 2 | b
            base = v << (bits - 2 * pal) | (base & ((1 << (bits - 2 * pal)) - 1))
        depth = bits if depth is None else min(depth, bits)
        low = bits - depth
        for _ in range(m):
            r = int(rng.integers(0, 2**63)) << 64 | int(rng.integers(0, 2**63))
            keys.append((base >> low << low) | (r & ((1 << low) - 1)))

    for m, depth in FIXED_CLUSTERS:
        if len(keys) + m <= n:
            cluster(m, depth)
    while len(keys) < n:
        m = min(max(1, (n - len(keys)) // 4), int(rng.choice([1, 1, 1, 2, 3, 9, 17, 40, 300])))
        depth = rng.choice([None, None, 6, 14, 24, 40, 61, 80, 97])
        pal = int(rng.choice([0, 0, 0, 4, 8, 12, 20, 30]))
        cluster(m, None if depth is None else int(depth), pal if 2 * pal <= bits else 0)
    keys = sorted(keys)
    gid = rng.integers(0, n_members, n)
    nio = np.where(rng.random(n) < 0.75, kmax, rng.integers(0, kmax + 1, n))
    words = np.zeros((KW, n), np.int64)
    for i, key in enumerate(keys):
        key <<= spare
        if packed:
            key |= int(gid[i]) << 6 | int(nio[i])
        for w in range(KW):
            words[w, i] = (key >> (32 * (KW - 1 - w))) & 0xFFFFFFFF
    pay = None if packed else (gid << 8 | nio).astype(np.int64)
    return words, pay


def synthetic_ks(KW, packed):
    """The reference grid's ks that fit the layout, and the small ks of a
    one-word layout."""
    top = (KW * 32 - (12 if packed else 0)) // 2
    ks = [k for k in K_GRID if k <= top]
    return ks if len(ks) >= 4 else list(range(2, top + 1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _members(rng, g, n, poly_a=0):
    base = rng.integers(0, 4, size=n, dtype=np.uint8)
    out = []
    for i in range(g):
        c = base.copy()
        pos = rng.integers(0, n, n // 30)
        c[pos] = rng.integers(0, 4, pos.shape[0], dtype=np.uint8)
        c[int(rng.integers(0, n - 50)):][:int(rng.integers(1, 50))] = 4
        if poly_a:  # one run spanning many tiles
            c = np.concatenate([c, np.zeros(poly_a, np.uint8)])
        if i % 3 == 1:  # palindromic repeat for the even ks
            pal = np.array([0, 1, 2, 1, 2, 3] * 40, np.uint8)
            c = np.concatenate([pal, c])
        out.append(c)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize(
    "g,n,poly_a,ks",
    [
        (1, 300, 0, (7, 8, 12, 21, 33)),          # less than one tile
        (8, 20000, 5000, K_GRID),                 # packed KW=4, 30 ks
        (33, 3000, 0, K_GRID),                    # 33 members, one 64-bit mask
        (64, 3000, 9000, K_GRID),                 # 64 members
        (5, 20000, 0, tuple(range(11, 32))),      # unpacked KW=2
        (4, 9000, 3000, (6, 8, 10, 14, 22, 34, 40, 48)),  # unpacked KW=3
        (3, 5000, 0, (4, 6, 8, 10, 12, 14)),      # unpacked KW=1
        (6, 8000, 0, tuple(range(2, 42))),        # 40 ks: two launches
    ],
)
def test_kernel_equals_plain_scan(cuda, g, n, poly_a, ks):
    rng = np.random.default_rng(g * 1000 + n)
    classes, rest = plan_sweep(ks, g, MASK_MEMBERS)
    assert classes and not rest
    codes, gids = pack_members(_members(rng, g, n, poly_a), cuda)
    for kmax, KW, cks, packed in classes:
        words, pay = _sweep_doubled(codes, gids, kmax, KW, packed)
        before = ksweep_scan.launches["occ"]
        got = ksweep_scan.scan_multi_k(words, pay, cks, g, 5000, packed)
        torch.cuda.synchronize()
        assert ksweep_scan.launches["occ"] > before
        want = scan_multi_k_reference(words, pay, cks, g, 5000, packed)
        assert torch.equal(got, want)
        # cs below the member count caps every bin at cs
        got = ksweep_scan.scan_multi_k(words, pay, cks, g, 3, packed)
        assert torch.equal(got, scan_multi_k_reference(words, pay, cks, g, 3, packed))


@pytest.mark.cuda
@pytest.mark.parametrize("KW,packed", [(1, True), (1, False), (2, True), (2, False),
                                       (3, True), (3, False), (4, True), (4, False)])
def test_kernel_equals_plain_scan_on_crossing_runs(cuda, KW, packed):
    """Runs across threads, warps and tiles at every k, blocks where only
    some ks cross, at n = 5 tiles + 1; and a ragged n one above and one
    below a tile."""
    rng = np.random.default_rng(KW * 2 + packed)
    ks = synthetic_ks(KW, packed)
    for n, g in ((5 * TILE + 1, 12), (TILE + 1, 64 if packed else 40), (TILE - 1, 7)):
        words, pay = synthetic_sorted(rng, KW, packed, n, g, max(ks))
        words = torch.from_numpy(words).to(cuda)
        pay = None if pay is None else torch.from_numpy(pay).to(cuda)
        for cs in (5000, 3):
            got = ksweep_scan.scan_multi_k(words, pay, ks, g, cs, packed)
            want = scan_multi_k_reference(words, pay, ks, g, cs, packed)
            assert want.sum() > 0
            assert torch.equal(got, want), (KW, packed, n, cs)


@pytest.mark.cuda
def test_kernel_ragged_sizes(cuda):
    """Arbitrary n, including one element and a tile edge +-1."""
    rng = np.random.default_rng(7)
    for n in (1, 2047, 2048, 2049, 4097):
        # KW=2 packed: sorted run keys in word 0, (gid << 6 | nio) in word 1
        w0 = np.sort(rng.integers(0, n // 3 + 1, n)).astype(np.int64) << 20
        w1 = ((rng.integers(0, 1 << 20, n) << 12) | (rng.integers(0, 64, n) << 6)
              | rng.integers(0, 64, n)).astype(np.int64)
        words = torch.from_numpy(np.stack([w0, w1])).to(cuda)
        ks = (5, 6, 7, 8, 9, 10)
        got = ksweep_scan.scan_multi_k(words, None, ks, 64, 5000, True)
        want = scan_multi_k_reference(words, None, ks, 64, 5000, True)
        assert want.sum() > 0
        assert torch.equal(got, want), n
