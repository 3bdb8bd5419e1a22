"""The scan kernel's classification modes (khoice_tpu_torch/csrc/ksweep_scan.cu:
pivot_rest, multi_pivot, containment, buckets) vs their plain PyTorch
version on the card, exact equality: on sorted doubled texts, and on the
synthetic sorted keys of test_torch_ksweep_cuda.py (runs across threads,
warps and tiles at every k, blocks where only some ks cross).

Needs a CUDA device and skips without one.  The file imports no jax, so
it runs where the JAX package is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_classify_cuda.py
"""

import numpy as np
import pytest
import torch

from khoice_tpu_torch.engine.ksweep import _sweep_doubled, plan_sweep
from khoice_tpu_torch.engine.occurrence import pack_members
from khoice_tpu_torch.kernels import ksweep_scan
from test_torch_ksweep_cuda import TILE, synthetic_ks, synthetic_sorted

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

K_GRID = list(range(7, 31)) + list(range(34, 50, 3))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _members(rng, g, n, poly_a=0, repeat=0):
    """g members sharing a base sequence, each with its own SNPs and an N
    run; member 0 (the pivot) may carry a poly-A tract (one run over many
    tiles) and a 60-base block repeated `repeat` times (pivot counts far
    above any cap); every third member a palindromic repeat."""
    base = rng.integers(0, 4, size=n, dtype=np.uint8)
    out = []
    for i in range(g):
        c = base.copy()
        pos = rng.integers(0, n, n // 30)
        c[pos] = rng.integers(0, 4, pos.shape[0], dtype=np.uint8)
        c[int(rng.integers(0, n - 50)):][:int(rng.integers(1, 50))] = 4
        if i == 0:
            c = np.concatenate([c, np.zeros(poly_a, np.uint8), np.tile(c[:60], repeat)])
        if i % 3 == 1:
            c = np.concatenate([np.array([0, 1, 2, 1, 2, 3] * 40, np.uint8), c])
        out.append(c)
    return out


def _check_mode(dev, members, ks, mode, mp):
    classes, rest = plan_sweep(ks, len(members))
    assert classes and not rest
    codes, gids = pack_members(members, dev)
    for kmax, KW, cks, packed in classes:
        words, pay = _sweep_doubled(codes, gids, kmax, KW, packed)
        before = ksweep_scan.launches[mode]
        got = ksweep_scan.scan_classify(words, pay, cks, mode, mp, packed)
        torch.cuda.synchronize()
        assert ksweep_scan.launches[mode] > before
        want = ksweep_scan.scan_classify_reference(words, pay, cks, mode, mp, packed)
        assert want.sum() > 0
        assert torch.equal(got, want), (mode, mp, kmax, KW, packed)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mode,mp,g,n,poly_a,repeat,ks",
    [
        ("pivot_rest", 7, 8, 20000, 5000, 0, K_GRID),             # packed KW=4, a run over 3 tiles
        ("pivot_rest", 2, 3, 5000, 0, 0, (4, 6, 8, 10, 12, 14)),  # unpacked KW=1
        ("multi_pivot", 4, 8, 20000, 5000, 0, tuple(range(11, 32))),  # unpacked KW=2
        ("multi_pivot", 32, 64, 2000, 0, 0, K_GRID),              # 1024 bins
        ("containment", (8, 4), 12, 9000, 3000, 0, K_GRID),
        ("containment", (42, 21), 63, 2000, 0, 0, (7, 8, 12, 16, 21)),  # 63 members, 924 bins
        ("buckets", (4, 5), 5, 20000, 5000, 40, K_GRID),          # cap 5
        ("buckets", (4, 255), 5, 20000, 5000, 40, (6, 8, 10, 14, 22, 34, 40, 48)),  # cap 255, KW=3
        ("buckets", (63, 255), 64, 1500, 3000, 20, K_GRID),       # 3970 bins: several launches
    ],
)
def test_kernel_equals_plain_scan(cuda, mode, mp, g, n, poly_a, repeat, ks):
    rng = np.random.default_rng(g * 1000 + n)
    _check_mode(cuda, _members(rng, g, n, poly_a, repeat), ks, mode, mp)


# 12 members in every mode
SYNTHETIC_MODES = (("pivot_rest", 11), ("multi_pivot", 6), ("containment", (8, 4)),
                   ("buckets", (11, 5)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,mp", SYNTHETIC_MODES)
@pytest.mark.parametrize("KW,packed", [(1, True), (1, False), (2, True), (2, False),
                                       (3, True), (3, False), (4, True), (4, False)])
def test_kernel_equals_plain_scan_on_crossing_runs(cuda, mode, mp, KW, packed):
    """Runs across threads, warps and tiles at every k, blocks where only
    some ks cross; n = 5 tiles + 1 and a tile + 1."""
    rng = np.random.default_rng(KW * 2 + packed + 100 * len(mode))
    ks = synthetic_ks(KW, packed)
    for n in (5 * TILE + 1, TILE + 1):
        words, pay = synthetic_sorted(rng, KW, packed, n, 12, max(ks))
        words = torch.from_numpy(words).to(cuda)
        pay = None if pay is None else torch.from_numpy(pay).to(cuda)
        got = ksweep_scan.scan_classify(words, pay, ks, mode, mp, packed)
        want = ksweep_scan.scan_classify_reference(words, pay, ks, mode, mp, packed)
        assert want.sum() > 0
        assert torch.equal(got, want), (mode, KW, packed, n)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,mp", SYNTHETIC_MODES)
def test_kernel_forty_ks_in_two_launches(cuda, mode, mp):
    """40 ks (two launches of at most 32) over crossing runs, unpacked KW 3."""
    rng = np.random.default_rng(40)
    ks = list(range(2, 42))
    words, pay = synthetic_sorted(rng, 3, False, 3 * TILE + 5, 12, max(ks))
    words, pay = torch.from_numpy(words).to(cuda), torch.from_numpy(pay).to(cuda)
    before = ksweep_scan.launches[mode]
    got = ksweep_scan.scan_classify(words, pay, ks, mode, mp, False)
    assert ksweep_scan.launches[mode] - before == 2
    assert torch.equal(got, ksweep_scan.scan_classify_reference(words, pay, ks, mode, mp, False))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,mp", [("pivot_rest", 63), ("multi_pivot", 32),
                                     ("containment", (40, 24)), ("buckets", (63, 7))])
def test_kernel_ragged_sizes(cuda, mode, mp):
    """Arbitrary n, including one element and a tile edge +-1; runs that
    close at a tile's last element and at the array's last element."""
    rng = np.random.default_rng(11)
    for n in (1, 2047, 2048, 2049, 4097):
        # KW=2 packed: sorted run keys in word 0, (gid << 6 | nio) in word 1
        w0 = np.sort(rng.integers(0, n // 3 + 1, n)).astype(np.int64) << 20
        gid = np.where(rng.random(n) < 0.3, 0, rng.integers(0, 64, n))
        w1 = ((rng.integers(0, 1 << 20, n) << 12) | (gid << 6)
              | rng.integers(0, 64, n)).astype(np.int64)
        words = torch.from_numpy(np.stack([w0, w1])).to(cuda)
        ks = (5, 6, 7, 8, 9, 10)
        got = ksweep_scan.scan_classify(words, None, ks, mode, mp, True)
        want = ksweep_scan.scan_classify_reference(words, None, ks, mode, mp, True)
        assert torch.equal(got, want), (mode, n)
