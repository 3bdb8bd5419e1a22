"""The radix sort kernel (khoice_tpu_torch/csrc/radix_sort.cu) vs its
plain PyTorch version on the card, bit-equal keys and payload (both are
stable sorts, so the payload order is fully determined); its first
pass's statistics and the plan it ran vs their plain versions.

Needs a CUDA device and skips without one.  The file imports no jax, so
it runs where the JAX package is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_sort_cuda.py
"""

import numpy as np
import pytest
import torch

from khoice_tpu_torch.kernels import sort as ksort
from torch_sort_cases import SENTINEL_CASES, sentinel_case

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

SENT = 0xFFFFFFFF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(words, payload):
    before = ksort.launches
    got, got_pay = ksort.sort_words(words, payload)
    torch.cuda.synchronize()
    if words.shape[1]:
        assert ksort.launches == before + 1, "a CUDA tensor must launch the kernel"
    want, want_pay = ksort.sort_words_reference(words, payload)
    assert torch.equal(got, want)
    if words.shape[1]:
        stats = ksort.sort_stats_reference(words)
        assert ksort.last_plan == ksort.plan_passes(*stats)
        hist, n_ones, at_tail = ksort.sort_stats(words)
        assert torch.equal(hist, stats[0]) and (n_ones, at_tail) == stats[1:]
    if payload is None:
        assert got_pay is None
    else:
        assert torch.equal(got_pay, want_pay)


@pytest.mark.cuda
@pytest.mark.parametrize("with_payload", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4095, 4096, 4097, 100_003, 1 << 20])
@pytest.mark.parametrize("W", [1, 2, 3, 4, 5])
def test_radix_sort_random(cuda, W, n, with_payload):
    rng = np.random.default_rng(W * 1000 + n % 997)
    words = torch.from_numpy(rng.integers(0, 2**32, (W, n), dtype=np.int64)).to(cuda)
    payload = (torch.from_numpy(rng.integers(-(2**62), 2**62, n, dtype=np.int64)).to(cuda)
               if with_payload else None)
    _check(words, payload)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["heavy_ties", "all_equal", "half_sentinel", "n0",
                                  "packed_spare_bits", "table_merge"])
@pytest.mark.parametrize("W", [1, 2, 4, 5])
def test_radix_sort_ties_and_edges(cuda, W, case):
    rng = np.random.default_rng(7 * W + len(case))
    n = 0 if case == "n0" else 300_001
    words = rng.integers(0, 2**32, (W, n), dtype=np.int64)
    if case == "heavy_ties":
        words = rng.integers(0, 3, (W, n), dtype=np.int64)
    elif case == "all_equal":
        words[:] = words[:, :1]
    elif case == "half_sentinel":
        words[:, rng.permutation(n)[: n // 2]] = SENT
    elif case == "packed_spare_bits":  # constant middle bytes: skipped digits
        words[-1] &= 0xC0000FFF
    elif case == "table_merge":  # two tables' keys, most present in both
        half = rng.integers(0, 2**32, (W, n // 2 + 1), dtype=np.int64)
        words = np.concatenate([half, half[:, rng.permutation(half.shape[1])]], 1)[:, :n]
    payload = torch.arange(n, dtype=torch.int64, device=cuda)
    words = torch.from_numpy(np.ascontiguousarray(words)).to(cuda)
    _check(words, payload)
    _check(words, None)


@pytest.mark.cuda
def test_radix_sort_rejects_bad_inputs(cuda):
    words = torch.zeros(2, 10, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        ksort.sort_words(torch.zeros(6, 10, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        ksort.sort_words(words, torch.zeros(10, dtype=torch.int64))  # payload on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("case", SENTINEL_CASES)
@pytest.mark.parametrize("W", [1, 2, 3, 4, 5])
def test_radix_sort_sentinels(cuda, W, case):
    rng = np.random.default_rng(31 * W + len(case))
    n = 300_001
    words = torch.from_numpy(sentinel_case(case, rng, W, n)).to(cuda)
    _check(words, torch.arange(n, dtype=torch.int64, device=cuda))
    _check(words, None)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "perk_packed", "occurrence_unpacked"])
def test_radix_sort_many_tiles(cuda, case):
    """Look-back across thousands of tiles: 2^24 + 3 elements of 3 words,
    with a payload."""
    rng = np.random.default_rng(24)
    n = (1 << 24) + 3
    if case == "random":
        words = rng.integers(0, 2**32, (3, n), dtype=np.int64)
    else:
        words = sentinel_case(case, rng, 3, n)
    words = torch.from_numpy(words).to(cuda)
    _check(words, torch.from_numpy(rng.integers(-(2**62), 2**62, n, dtype=np.int64)).to(cuda))
