"""The port's device-memory estimates (khoice_tpu_torch/engine/streaming.py)
against what the radix sort's wrapper (khoice_tpu_torch/kernels/sort.py)
allocates.

The wrapper's own code runs on the CPU with the kernel library replaced
by one that launches nothing: every tensor it allocates is tracked from
its allocation to its release, so the peak of the live bytes is the
wrapper's, at every word count, with and without a payload."""

import contextlib
import types
import weakref

import numpy as np
import pytest
import torch

from khoice_tpu_torch.engine import streaming as st
from khoice_tpu_torch.kernels import sort as ksort

SMALLEST_TILE = 2048  # radix_sort.cu: 256 threads x 8 items, the most status per element


class _Live:
    def __init__(self):
        self.live = self.peak = 0

    def add(self, t):
        b = t.numel() * t.element_size()
        self.live += b
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self.release, b)
        return t

    def release(self, b):
        self.live -= b


class _NoKernels:
    """The library's entry points, launching nothing."""

    @staticmethod
    def radix_sort_tile_elems(W, pay):
        return SMALLEST_TILE

    @staticmethod
    def radix_sort_first_pass(*args):
        return 0

    @staticmethod
    def radix_sort_passes(*args):
        return 0


def _wrapper_peak(monkeypatch, key_words, payload, n):
    """Peak live bytes of kernels/sort.py::_launch over a sort of n
    elements that runs every digit pass, the input included."""
    live = _Live()
    fake = types.SimpleNamespace(**{
        name: getattr(torch, name) for name in ("int32", "int64")})
    fake.empty = lambda *a, **kw: live.add(torch.empty(*a, **kw))
    fake.zeros = lambda *a, **kw: live.add(torch.zeros(*a, **kw))
    fake.empty_like = lambda *a, **kw: live.add(torch.empty_like(*a, **kw))
    fake.cuda = types.SimpleNamespace(
        device=lambda d: contextlib.nullcontext(),
        current_stream=lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ksort, "torch", fake)
    monkeypatch.setattr(ksort, "_device_check", lambda words: None)
    monkeypatch.setattr(ksort._build, "load", lambda: _NoKernels)
    monkeypatch.setattr(ksort, "plan_passes",
                        lambda hist, n_ones, at_tail: (list(range(4 * key_words)), False))
    words = live.add(torch.zeros(key_words, n, dtype=torch.int64))
    pay = live.add(torch.zeros(n, dtype=torch.int64)) if payload else None
    out, pout = ksort._launch(words, pay)
    assert out.shape == (key_words, n) and (pout is None) == (not payload)
    return live.peak


@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("key_words", [1, 2, 3, 4, 5])
def test_sort_bytes_bound_the_wrappers_allocations(monkeypatch, key_words, payload):
    """_sort_bytes is at or above the sort wrapper's peak, and no further
    above it than the status's bound and the fixed bytes."""
    n = 3 * SMALLEST_TILE + 5
    peak = _wrapper_peak(monkeypatch, key_words, payload, n)
    est = st._sort_bytes(n, key_words, payload)
    assert peak <= est
    assert est - peak <= st._SORT_FIXED_BYTES


def test_incore_budget_accepts_what_the_flat_constant_refused():
    """A group whose 4-word packed class sort the flat 2 W + 6 words per
    element (112 B) put over the budget now runs in-core: its estimate is
    the sort's 81 B per element beside the resident codes and gids."""
    positions = 100_000_000
    ks = list(range(7, 31)) + list(range(34, 50, 3))
    classes, rest = st.plan_sweep(ks, 8)
    assert [(KW, packed) for _, KW, _, packed in classes] == [(4, True)] and not rest
    flat = 2 * positions * 8 * (2 * 4 + 6)
    need = st.incore_sweep_bytes(positions, ks, 8)
    assert need == (2 * positions * 81 + st._SORT_FIXED_BYTES
                    + positions * st._RESIDENT_BYTES + st._ALLOCATOR_SLACK)
    budget = (need + flat) // 2
    assert flat > budget
    st.check_incore_budget(positions, ks, 8, budget, "g")
    with pytest.raises(st.DeviceBudgetExceeded):
        st.check_incore_budget(positions, ks, 8, need - 1, "g")


@pytest.mark.parametrize("k,n_members,layout_bytes", [
    (31, 8, 16 * 3 + 4 * 3 + 1),                    # (key << 8) | gid in 3 words
    (31, 300, 16 * 3 + 4 * 3 + 1 + 8 * 2 + 9),      # 2 key words + the gid row, keys beside
    (61, 8, 16 * 5 + 4 * 5 + 1 + 8 * 4 + 9),        # k > 60: the gid apart
])
def test_perk_bytes_per_layout(k, n_members, layout_bytes):
    positions = 1000
    assert st.perk_bytes(positions, [k], n_members) == (
        positions * (layout_bytes + st._RESIDENT_BYTES) + st._SORT_FIXED_BYTES
        + st._ALLOCATOR_SLACK)
    assert st.perk_bytes(positions, [], n_members) == 0


def test_count_bytes_cover_the_keys_beside_the_sort():
    """Counting keeps the codes, the canonical keys and their validity
    beside the sort of the valid keys, which takes key_words(k) words (4
    at k = 45, where the packed per-k layout also takes 4)."""
    n = 1000
    assert st.count_bytes(n, 45) == (st._sort_bytes(n, 4) + n * (8 * 4 + 2)
                                     + st._ALLOCATOR_SLACK)
    assert st.count_bytes(n, 45) > st.perk_bytes(n, [45], 1)


def test_budget_counts_what_the_run_holds(monkeypatch):
    """A step fits when its estimate and what the run already holds on
    the card fit the budget together; the CPU holds nothing."""
    assert st.resident_bytes("cpu") == 0
    monkeypatch.setattr(st, "resident_bytes", lambda device: 600)
    st.check_device_budget(400, 1000, "g", "cuda")
    with pytest.raises(st.DeviceBudgetExceeded, match="beside"):
        st.check_device_budget(401, 1000, "g", "cuda")


def test_engine_checks_its_table_ops():
    """union, intersect_sum and subtract check the sort of their tables'
    keys (the counts or indices its payload) against the budget."""
    from khoice_tpu_torch.engine.session import KmerEngine

    rng = np.random.default_rng(5)
    eng = KmerEngine("cpu", device_budget_bytes=1 << 40)
    a, b = (eng.count_codes(rng.integers(0, 4, 3000).astype(np.uint8), 21) for _ in range(2))
    need = st.table_merge_bytes(len(a) + len(b), a.n_words)
    assert need == (len(a) + len(b)) * (16 * 3 + 4 * 4 + 1) + st._SORT_FIXED_BYTES \
        + st._ALLOCATOR_SLACK
    eng.budget = need
    for op in (eng.union, lambda ts: eng.intersect_sum(*ts), lambda ts: eng.subtract(*ts)):
        op([a, b])
    eng.budget = need - 1
    for op in (eng.union, lambda ts: eng.intersect_sum(*ts), lambda ts: eng.subtract(*ts)):
        with pytest.raises(st.DeviceBudgetExceeded):
            op([a, b])


def test_engine_checks_its_annotation():
    """The annotation (exp4's per-k path) checks its sort, or what follows
    the sort, against the budget."""
    from khoice_tpu_torch.engine.session import KmerEngine

    rng = np.random.default_rng(6)
    eng = KmerEngine("cpu", device_budget_bytes=1 << 40)
    pivot, group = (eng.count_codes(rng.integers(0, 4, 2000).astype(np.uint8), 31)
                    for _ in range(2))
    n = len(pivot) + len(group)
    eng.budget = st.annotation_bytes(n, pivot.n_words)
    assert eng.budget == (16 * 2 + 66) * n + st._ALLOCATOR_SLACK  # 2 key words at k = 31
    assert eng.annotate(pivot, [group]).num_datasets == 1
    eng.budget -= 1
    with pytest.raises(st.DeviceBudgetExceeded, match="annotation"):
        eng.annotate(pivot, [group])
