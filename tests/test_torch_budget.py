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
from torch.utils._python_dispatch import TorchDispatchMode

from khoice_tpu_torch.engine import streaming as st
from khoice_tpu_torch.kernels import sort as ksort

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

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
    """Counting keeps the codes beside the larger of the compaction of the
    valid keys, their sort (key_words(k) words: 4 at k = 45) and what
    follows it (the sorted keys beside the run starts, lengths and the
    gathered keys); the extracted keys are freed before the sort."""
    n = 1_000_000
    assert st.count_bytes(n, 45) == n + st._sort_bytes(n, 4) + st._ALLOCATOR_SLACK
    # at 1-2 words what follows the sort holds more than the sort
    assert st.count_bytes(n, 21) == n + n * (16 * 2 + 16) + st._ALLOCATOR_SLACK
    assert st.count_bytes(n, 11) == n + n * (16 + 16) + st._ALLOCATOR_SLACK


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


class _LiveOps(TorchDispatchMode):
    """Live bytes of every storage that an aten op allocates under it,
    from the op to the storage's release, and their peak; `paused` stops
    the count (a sort whose own allocations _sort_bytes bounds)."""

    def __init__(self, held=()):
        super().__init__()
        self.live = self.peak = 0
        self.seen = {t.untyped_storage().data_ptr() for t in held}
        self.paused = False

    def _release(self, key, b):
        self.live -= b
        self.seen.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if not isinstance(t, torch.Tensor):
                continue
            st_ = t.untyped_storage()
            key = st_.data_ptr()
            if key in self.seen or st_.nbytes() == 0:
                continue
            self.seen.add(key)
            self.live += st_.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st_, self._release, key, st_.nbytes())
        return out


def _members(rng, n_members, length, related):
    """Members of uniform bases with a few N, all copies of one when
    related (runs of up to n_members elements), else unrelated (about one
    run per element)."""
    base = rng.integers(0, 4, length).astype(np.uint8)
    out = []
    for _ in range(n_members):
        m = base.copy() if related else rng.integers(0, 4, length).astype(np.uint8)
        m[rng.integers(0, length, 3)] = 4
        out.append(m)
    return out


@pytest.mark.parametrize("related", [False, True])
@pytest.mark.parametrize("k,n_members", [(11, 8), (31, 8), (40, 8), (49, 8), (60, 8), (31, 300), (61, 8)])
def test_occurrence_table_bytes_bound_the_steps_peak(monkeypatch, k, n_members, related):
    """occurrence_table after its sort: from the sorted words (handed
    over, as the sort hands them) to the table, the peak of the live
    bytes stays within occurrence_table_bytes, whether the runs are as
    many as the elements (unrelated members) or fewer."""
    from khoice_tpu_torch.engine import occurrence as occ

    rng = np.random.default_rng(k * 1000 + n_members)
    members = _members(rng, n_members, max(3000 // n_members * 8, 600), related)
    codes, gids = occ.pack_members(members, "cpu")
    packed = occ.gid_packable(n_members, k)
    words, gid = occ._sorted_pairs(codes, gids, k, packed)
    whole = words if gid is None else torch.cat([words, gid[None]])
    want = occ.occurrence_table(members, k, "cpu")
    mode = _LiveOps()

    def sorted_pairs(codes, gids, k, packed):
        s = whole.clone()  # the sort's output, counted from here
        return (s, None) if packed else (s[:-1], s[-1])

    monkeypatch.setattr(occ, "pack_members", lambda member_codes, device: (None, None))
    monkeypatch.setattr(occ, "_sorted_pairs", sorted_pairs)
    with mode:
        got = occ.occurrence_table(members, k, "cpu")
    assert torch.equal(got.keys, want.keys) and torch.equal(got.counts, want.counts)
    assert mode.peak >= whole.numel() * 8
    est = st.occurrence_table_bytes(codes.shape[0], k, n_members) - st._ALLOCATOR_SLACK
    assert mode.peak <= est
    if not related:  # as many runs as elements: the bound's own case, within ~1.3x
        assert est <= 1.3 * mode.peak


@pytest.mark.parametrize("k", [11, 21, 31, 45])
def test_count_bytes_bound_the_steps_peak(monkeypatch, k):
    """count_codes on one genome: the codes, the extraction's keys and
    validity, the compaction, the sort's input and output and what
    follows the sort stay within count_bytes.  The extraction and the
    sort run uncounted and hand over their outputs (the kernels allocate
    nothing else; the sort's own allocations are _sort_bytes', checked
    above; on the CPU both run their plain versions)."""
    from khoice_tpu_torch.engine import ops

    rng = np.random.default_rng(k)
    codes = torch.from_numpy(_members(rng, 1, 20000, False)[0])
    want = ops.count_codes(codes, k)
    mode = _LiveOps(held=(codes,))

    def handed_over(fn):
        def call(*args):
            mode.paused = True
            try:
                out = fn(*args)
            finally:
                mode.paused = False
            return tuple(None if t is None else t.clone() for t in out)
        return call

    monkeypatch.setattr(ops, "extract_canonical", handed_over(ops.extract_canonical))
    monkeypatch.setattr(ops, "sort_words", handed_over(ops.sort_words))
    with mode:
        got = ops.count_codes(codes, k)
    assert torch.equal(got.keys, want.keys) and torch.equal(got.counts, want.counts)
    assert codes.numel() + mode.peak <= st.count_bytes(codes.numel(), k) - st._ALLOCATOR_SLACK


@pytest.mark.parametrize("op", ["union", "intersect", "subtract"])
@pytest.mark.parametrize("k,overlap", [(11, 0.5), (21, 0.9), (45, 0.0)])
def test_table_merge_bytes_bound_the_steps_peak(monkeypatch, op, k, overlap):
    """A table op beside its input tables: the concatenation, the sort's
    input and output (its own allocations are _sort_bytes', checked
    above) and what follows the sort stay within table_merge_bytes, with
    few or many keys in both tables."""
    from khoice_tpu_torch.engine import ops

    rng = np.random.default_rng(k)
    codes = _members(rng, 2, 20000, False)
    codes[1][: int(20000 * overlap)] = codes[0][: int(20000 * overlap)]
    a, b = (ops.count_codes(torch.from_numpy(c), k) for c in codes)
    fn = {"union": lambda: ops.union_many([a, b]), "intersect": lambda: ops.intersect_sum(a, b),
          "subtract": lambda: ops.subtract(a, b)}[op]
    want = fn()
    mode = _LiveOps(held=(a.keys, a.counts, b.keys, b.counts))
    sort_words = ops.sort_words

    def sort_outside(*args):
        mode.paused = True
        try:
            out = sort_words(*args)
        finally:
            mode.paused = False
        return tuple(t.clone() for t in out)  # the sort's output, counted from here

    monkeypatch.setattr(ops, "sort_words", sort_outside)
    with mode:
        got = fn()
    assert torch.equal(got.keys, want.keys) and torch.equal(got.counts, want.counts)
    assert mode.peak <= st.table_merge_bytes(len(a) + len(b), a.n_words) - st._ALLOCATOR_SLACK


@pytest.mark.parametrize("k,n_reads", [(11, 400), (21, 40), (49, 40)])
def test_vote_bytes_bound_the_steps_peak(monkeypatch, k, n_reads):
    """One k's merge-join vote beside the resident group texts and reads:
    the concatenation, both extractions, the sort's input and output
    (its own allocations are _sort_bytes', checked above), the masks and
    the per-read outputs stay within vote_bytes, whether the reads are
    few beside the texts or many.  The kernels run uncounted and hand
    over their outputs (on the card they allocate nothing else but
    vote_mask's statuses and bucket lists, kvote.mask_scratch_bytes,
    which the estimate counts)."""
    from khoice_tpu_torch.classify import annotate as ann
    from khoice_tpu_torch.kernels import vote as kvote

    rng = np.random.default_rng(k + n_reads)
    group = ann.pack_group_texts(_members(rng, 4, 5000, False), "cpu")
    reads = rng.integers(0, 4, (n_reads, 150)).astype(np.uint8)
    flat, spans = ann.concat_flat_reads([ann.flat_reads_device(reads, "cpu")])
    want = ann.read_votes_bulk_multi(group, flat, spans, k, 4)
    mode = _LiveOps(held=(*group, flat))

    def handed_over(fn):
        def call(*args):
            mode.paused = True
            try:
                out = fn(*args)
            finally:
                mode.paused = False
            return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()
        return call

    for module, name in ((ann, "extract_canonical"), (ann, "sort_words"),
                         (kvote, "vote_mask"), (kvote, "read_votes")):
        monkeypatch.setattr(module, name, handed_over(getattr(module, name)))
    with mode:
        got = ann.read_votes_bulk_multi(group, flat, spans, k, 4, 1 << 40)
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(g, w)
    n_text, n_query = group[0].shape[0], flat.shape[0]
    assert mode.peak >= 8 * st.key_words(k) * (n_text + n_query)
    est = st.vote_bytes(n_text, n_query, st.key_words(k)) - st._ALLOCATOR_SLACK
    assert mode.peak <= est
