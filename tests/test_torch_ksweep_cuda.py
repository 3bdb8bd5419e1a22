"""The multi-k scan kernel (khoice_tpu_torch/csrc/ksweep_scan.cu) vs its
plain PyTorch version on the card, exact equality.

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

K_GRID = list(range(7, 31)) + list(range(34, 50, 3))


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
