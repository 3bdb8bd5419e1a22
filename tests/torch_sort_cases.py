"""Inputs of the port's radix sort (khoice_tpu_torch/kernels/sort.py) that
put all-ones (SENTINEL) elements where its first pass and its digit plan
must handle them; shared by tests/test_torch_sort.py (CPU) and
tests/test_torch_sort_cuda.py (the kernel).  Imports no jax."""

import numpy as np

ONES = 0xFFFFFFFF

# bits of the top word that vary in a packed per-k layout of W words:
# (key << 8) | gid of a canonical k-mer, k = 31 at W 3 and k = 49 at W 4
# (engine/occurrence.py::_sorted_pairs, kernels/extract.py::extract_packed)
PACKED_TOP_BITS = {1: 20, 2: 12, 3: 6, 4: 10, 5: 14}

SENTINEL_CASES = (
    "near_sentinel",         # valid keys all ones in every varying digit, not in the constant ones
    "only_sentinels",
    "equal_with_sentinels",  # one pass: no digit varies, the sentinels are not at the tail
    "sentinels_at_tail",
    "sorted_with_tail",      # no pass: one valid key, the sentinels at the tail
    "perk_packed",           # (key << 8) | gid, SENTINEL windows all ones
    "occurrence_unpacked",   # key words + gid row, all ones where the window is invalid
)


def sentinel_case(case: str, rng: np.random.Generator, W: int, n: int) -> np.ndarray:
    """int64 [W, n] words (32-bit values) of one of SENTINEL_CASES; about
    a third of the elements are all ones, interleaved unless the case puts
    them at the tail."""
    words = rng.integers(0, 2**32, (W, n), dtype=np.int64)
    sent = rng.random(n) < 0.3
    tail = np.arange(n) >= n - n // 3
    if case == "near_sentinel":
        # the top word's upper three bytes are 0 in every valid key
        words[0] &= 0xFF
        near = rng.random(n) < 0.3
        words[0, near] = 0xFF
        words[1:, near] = ONES
    elif case == "only_sentinels":
        sent[:] = True
    elif case in ("equal_with_sentinels", "sorted_with_tail"):
        words[:] = words[:, :1]
        if case == "sorted_with_tail":
            sent = tail
    elif case == "sentinels_at_tail":
        sent = tail
    elif case == "perk_packed":
        words[0] &= (1 << PACKED_TOP_BITS[W]) - 1
        words[-1] = (words[-1] & ~0xFF) | rng.integers(0, 96, n)
    elif case == "occurrence_unpacked":
        if W > 1:
            words[0] &= (1 << 30) - 1
        words[-1] = rng.integers(0, 300, n)
    else:
        raise ValueError(case)
    words[:, sent] = ONES
    return words


def packed_varying_digits(W: int) -> int:
    """The digits the plan keeps for the packed per-k layout of W words:
    the top word's varying bytes and every byte below it."""
    return -(-PACKED_TOP_BITS[W] // 8) + 4 * (W - 1)
