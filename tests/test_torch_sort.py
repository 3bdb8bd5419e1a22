"""The port's multi-word sort (khoice_tpu_torch/kernels/sort.py) on the
CPU: its plain version against the JAX package's sorts on the same
numpy-seeded uint32 words, exact equality.

- jax.lax.sort(num_keys=W), as the JAX package's sweeps sort: keys
  bit-equal; the payload equal within each run of equal keys (XLA's sort
  is unstable);
- np.lexsort, which is stable: the payload order is exact too;
- merge_pallas.merge_sort, the TPU kernel the radix sort replaces, in
  interpret mode (one case; it takes seconds on a CPU).
The kernel's digit plan (`plan_passes` of the first pass's statistics,
`sort_stats_reference`) is checked by an LSD emulation: stable torch.sorts
over exactly the planned digits, all-ones elements in a 257th bucket,
must equal the plain sort and np.lexsort, keys and payload.
The CUDA kernel is held against the plain version on the card by
tests/test_torch_sort_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khoice_tpu.kernels.merge_pallas import T_TILE, merge_sort
from khoice_tpu_torch.kernels import sort as ksort
from torch_sort_cases import SENTINEL_CASES, packed_varying_digits, sentinel_case

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

SENT = 0xFFFFFFFF


def _words(rng, W, n, high=2**32):
    return rng.integers(0, high, (W, n), dtype=np.uint64).astype(np.uint32)


def _port(words, payload=None):
    got, pay = ksort.sort_words(torch.from_numpy(words.astype(np.int64)),
                                None if payload is None else torch.from_numpy(payload))
    return got.numpy(), (None if pay is None else pay.numpy())


def _runs_sorted(words, payload):
    """The payload sorted within each run of equal keys (order-free)."""
    order = np.lexsort(np.concatenate([payload[None], words])[::-1])
    return payload[order]


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5])
def test_plain_sort_equals_lax_sort(W):
    rng = np.random.default_rng(W)
    n = 3000
    words = _words(rng, W, n, high=2**32 if W > 1 else 700)  # W 1: ties
    words[:, rng.random(n) < 0.1] = SENT
    payload = np.arange(n, dtype=np.int64) * 7 % n
    got, got_pay = _port(words, payload)
    want = jax.lax.sort([jnp.asarray(w) for w in words] + [jnp.asarray(payload.astype(np.uint32))],
                        num_keys=W, is_stable=False)
    want_words = np.stack([np.asarray(w) for w in want[:W]]).astype(np.int64)
    np.testing.assert_array_equal(got, want_words)
    np.testing.assert_array_equal(_runs_sorted(got, got_pay),
                                  _runs_sorted(want_words, np.asarray(want[W]).astype(np.int64)))


@pytest.mark.parametrize("case", ["random", "heavy_ties", "all_equal", "half_sentinel",
                                  "sentinel_blocks", "n0", "n1"])
@pytest.mark.parametrize("W", [1, 2, 4, 5])
def test_plain_sort_is_stable_like_lexsort(W, case):
    rng = np.random.default_rng(10 * W + len(case))
    n = {"n0": 0, "n1": 1}.get(case, 4097)
    words = _words(rng, W, n)
    if case == "heavy_ties":
        words = _words(rng, W, n, high=3)
    elif case == "all_equal":
        words[:] = words[:, :1]
    elif case == "half_sentinel":
        words[:, rng.permutation(n)[: n // 2]] = SENT
    elif case == "sentinel_blocks":
        words[:, 1000:1600] = SENT
        words[:, 3000:3100] = SENT
    payload = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    got, got_pay = _port(words, payload)
    order = np.lexsort(words[::-1])  # stable; row 0 most significant
    np.testing.assert_array_equal(got, words[:, order].astype(np.int64))
    np.testing.assert_array_equal(got_pay, payload[order])
    got_nopay, none = _port(words)
    assert none is None
    np.testing.assert_array_equal(got_nopay, got)


def test_plain_sort_equals_merge_sort_interpret():
    """The TPU kernel (merge-path, interpret mode) on 5 tiles of 4-word
    keys with a payload operand, as tests/test_merge_sort.py runs it."""
    rng = np.random.default_rng(2)
    n = 5 * T_TILE
    words = _words(rng, 4, n)
    words[0, : n // 8] = 17  # ties in the top word
    payload = np.arange(n, dtype=np.uint32)
    want = merge_sort(tuple(jnp.asarray(w) for w in words) + (jnp.asarray(payload),), 4,
                      row_len=T_TILE, interpret=True)
    want_words = np.stack([np.asarray(w) for w in want[:4]]).astype(np.int64)
    got, got_pay = _port(words, payload.astype(np.int64))
    np.testing.assert_array_equal(got, want_words)
    np.testing.assert_array_equal(_runs_sorted(got, got_pay),
                                  _runs_sorted(want_words, np.asarray(want[4]).astype(np.int64)))


def test_sort_wrapper_checks_and_cpu_dispatch():
    words = torch.zeros(2, 10, dtype=torch.int64)
    before = ksort.launches
    ksort.sort_words(words)  # the plain version: no kernel launch on the CPU
    hist, n_ones, at_tail = ksort.sort_stats(words)  # the plain statistics
    assert ksort.launches == before
    assert int(hist[0, 0]) == 10 and (n_ones, at_tail) == (0, True)
    for bad in (words.to(torch.int32), torch.zeros(6, 10, dtype=torch.int64),
                torch.zeros(10, dtype=torch.int64), torch.zeros(10, 2, dtype=torch.int64).t()):
        with pytest.raises(ValueError):
            ksort.sort_words(bad)
    for bad_pay in (torch.zeros(9, dtype=torch.int64), torch.zeros(10, dtype=torch.int32)):
        with pytest.raises(ValueError):
            ksort.sort_words(words, bad_pay)
    with pytest.raises(ValueError, match="no radix_sort kernel"):
        ksort._launch(words, None)


def _stats_numpy(words):
    """The first pass's statistics, from numpy alone."""
    W, n = words.shape
    ones = (words == SENT).all(0)
    hist = np.stack([np.bincount((words[w, ~ones] >> (8 * b)) & 255, minlength=256)
                     for w in range(W) for b in range(4)])
    return hist, int(ones.sum()), bool(ones[n - int(ones.sum()):].all())


def _emulate_plan(words, payload, digits, ones_bucket):
    """LSD radix sort over exactly `digits` (stable torch.sorts), all-ones
    elements in bucket 256 when ones_bucket, as the kernel's passes run."""
    ones = (words == SENT).all(0)
    perm = torch.arange(words.shape[1])
    for digit in digits:
        w, b = divmod(digit, 4)
        d = (words[w][perm] >> (8 * b)) & 255
        if ones_bucket:
            d = torch.where(ones[perm], 256, d)
        perm = perm[torch.sort(d, stable=True).indices]
    return words[:, perm], payload[perm]


@pytest.mark.parametrize("case", SENTINEL_CASES + ("random", "packed_spare_bits", "n0", "n1"))
@pytest.mark.parametrize("W", [1, 2, 3, 4, 5])
def test_planned_passes_sort_like_lexsort(W, case):
    rng = np.random.default_rng(100 * W + len(case))
    n = {"n0": 0, "n1": 1}.get(case, 5000)
    if case in SENTINEL_CASES:
        words = sentinel_case(case, rng, W, n)
    else:
        words = _words(rng, W, n).astype(np.int64)
        if case == "packed_spare_bits":  # constant bits that are not byte-aligned
            words[-1] &= 0xC0000FFF
    payload = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    tw, tp = torch.from_numpy(words), torch.from_numpy(payload)
    hist, n_ones, at_tail = ksort.sort_stats_reference(tw)
    want_hist, want_ones, want_tail = _stats_numpy(words)
    np.testing.assert_array_equal(hist.numpy(), want_hist)
    assert (n_ones, at_tail) == (want_ones, want_tail)
    digits, ones_bucket = ksort.plan_passes(hist, n_ones, at_tail)
    assert digits == sorted(digits, key=lambda d: (-(d // 4), d % 4))  # least significant first
    assert ones_bucket == bool(n_ones and digits)
    got, got_pay = _emulate_plan(tw, tp, digits, ones_bucket)
    ref, ref_pay = ksort.sort_words_reference(tw, tp)
    order = np.lexsort(words[::-1])
    np.testing.assert_array_equal(ref.numpy(), words[:, order])
    np.testing.assert_array_equal(ref_pay.numpy(), payload[order])
    assert torch.equal(got, ref) and torch.equal(got_pay, ref_pay)
    if case == "sorted_with_tail" or n < 2:
        assert digits == []
    if case == "equal_with_sentinels":
        assert digits == [(W - 1) * 4] and ones_bucket
    if case == "only_sentinels":
        assert (digits, ones_bucket) == ([], False)


@pytest.mark.parametrize("W, k", [(3, 31), (4, 49)])
def test_plan_skips_sentinel_digits_of_perk_words(W, k):
    """The per-k packed words: 9 passes at k = 31 and 14 at k = 49 (12 and
    16 if the SENTINEL windows counted), the sentinel bucket on."""
    rng = np.random.default_rng(k)
    words = torch.from_numpy(sentinel_case("perk_packed", rng, W, 20000))
    digits, ones_bucket = ksort.plan_passes(*ksort.sort_stats_reference(words))
    assert len(digits) == packed_varying_digits(W) == {31: 9, 49: 14}[k]
    assert ones_bucket
    hist = ksort.sort_stats_reference(words)[0]
    assert len(ksort.plan_passes(hist, 0, True)[0]) == len(digits)
    with_ones = torch.stack([torch.bincount((words[w] >> (8 * b)) & 255, minlength=256)
                             for w in range(W) for b in range(4)])
    assert len(ksort.plan_passes(with_ones, 0, True)[0]) == 4 * W
