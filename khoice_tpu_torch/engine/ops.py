"""KMC3 / kmc_tools operations on KmerTables (port of
khoice_tpu/engine/ops.py).

Semantics, as the reference pipeline relies on them:

- ``count_codes``: canonical counting with saturating counters, default
  cap 255 (KMC's -cs; the reference passes -ci1 so singletons are kept,
  workflow/rules/exp_type_1.smk:163).
- ``set_counts``: `kmc_tools transform ... set_counts c`
  (exp_type_1.smk:173).
- ``union_many``: n-way `kmc_tools complex` union with counter sum,
  saturating at cs (the reference passes -cs5000, exp_type_1.smk:61,84).
- ``intersect_sum``: `kmc_tools simple A B intersect -ocsum`
  (exp_type_2.smk:362-366): keys in both, count min(cA + cB, cs), cs 255
  by default as in the JAX package (exp2 relies on it).
- ``subtract``: `kmc_tools simple A B kmers_subtract`
  (exp_type_2.smk:368-380): keys of A absent from B, counts from A.
- ``histogram``: `kmc_tools transform ... histogram` (exp_type_1.smk:191):
  hist[i-1] = number of present keys with count == i, i in 1..cx.

Tables are compact (engine/table.py).  Sorts are the port's multi-word
radix sort (kernels/sort.py); run sums come from running sums at the
run ends (union) or run lengths (counting), not from the JAX package's
reverse cummin, which cost 750 ms over an exp1 run on an H100.
"""

from __future__ import annotations

import torch

from ..kernels.extract import extract_canonical
from ..kernels.sort import sort_words
from .bits import words_starts
from .table import KmerTable

__all__ = [
    "count_codes",
    "set_counts",
    "union_many",
    "intersect_sum",
    "subtract",
    "histogram",
    "n_present",
    "total_count",
]


def _run_sums(values: torch.Tensor, is_new: torch.Tensor) -> torch.Tensor:
    """int64 [runs]: each run's sum of `values`."""
    run_id = torch.cumsum(is_new, 0) - 1
    sums = torch.zeros(int(is_new.sum()), dtype=torch.int64, device=values.device)
    return sums.index_add_(0, run_id, values.to(torch.int64))


def _count_sorted(skeys: torch.Tensor, k: int, cs: int) -> KmerTable:
    """A count table from sorted valid keys: each run's length, capped at
    cs (no key is the SENTINEL)."""
    starts = torch.nonzero(words_starts(skeys)).squeeze(1)
    counts = torch.diff(starts, append=starts.new_full((1,), skeys.shape[1])).clamp_(max=cs)
    return KmerTable(keys=skeys[:, starts], counts=counts, k=k)


def count_codes(codes: torch.Tensor, k: int, cs: int = 255) -> KmerTable:
    """Canonical k-mer counting over uint8 codes (KMC `kmc -ci1` role).
    Each step frees what the next does not need
    (engine/streaming.py::count_bytes)."""
    keys, valid = extract_canonical(codes, k)
    keys = keys[:, valid]
    del valid
    keys = sort_words(keys)[0]
    return _count_sorted(keys, k, cs)


def set_counts(t: KmerTable, c: int) -> KmerTable:
    if c <= 0:  # no key stays present
        return KmerTable(keys=t.keys[:, :0], counts=t.counts[:0], k=t.k)
    return KmerTable(keys=t.keys, counts=torch.full_like(t.counts, c), k=t.k)


def union_many(tables: list, cs: int = 5000) -> KmerTable:
    """n-way union with counter sum (kmc_tools complex '+', -cs{cs}).
    Table keys are unique, never the SENTINEL, and their counts > 0, so
    every run of the sorted keys is kept; its sum is the running count at
    its end minus the one at the previous run's end.  Each step frees what
    the next does not need (engine/streaming.py::table_merge_bytes)."""
    k = tables[0].k
    for t in tables:
        assert t.k == k and t.n_words == tables[0].n_words
    skeys, scounts = sort_words(torch.cat([t.keys for t in tables], 1),
                                torch.cat([t.counts for t in tables]))
    n = skeys.shape[1]
    starts = torch.nonzero(words_starts(skeys)).squeeze(1)
    cum = torch.cumsum(scounts, 0)
    del scounts
    ends = torch.empty_like(starts)
    ends[:-1] = starts[1:] - 1
    ends[-1:] = n - 1
    at_end = cum[ends]
    del cum, ends
    sums = torch.diff(at_end, prepend=at_end.new_zeros(1)).clamp_(max=cs)
    del at_end
    return KmerTable(keys=skeys[:, starts], counts=sums, k=k)


def _merge_two(a: KmerTable, b: KmerTable):
    """(sorted keys of a and b, the sort's order as indices into a's rows
    then b's, the positions i whose key repeats at i + 1).  Keys are
    unique within each table, so a key of both is a pair of neighbours,
    a's first (the sort is stable)."""
    assert a.k == b.k and a.n_words == b.n_words
    skeys, order = sort_words(torch.cat([a.keys, b.keys], 1),
                              torch.arange(len(a) + len(b), device=a.device))
    dup = words_starts(skeys)[1:].logical_not_()  # element i + 1 repeats i
    return skeys, order, torch.nonzero(dup).squeeze(1)


# intersect_sum and subtract free the sorted keys and order as soon as
# they have what they need, so what follows the sort holds less than the
# sort (engine/streaming.py::table_merge_bytes)
def intersect_sum(a: KmerTable, b: KmerTable, cs: int = 255) -> KmerTable:
    """`kmc_tools simple a b intersect -ocsum` (keys in both, counts summed)."""
    skeys, order, both = _merge_two(a, b)
    ia, ib = order[both], order[both + 1]
    del order
    keys = skeys[:, both]
    del skeys, both
    counts = a.counts[ia] + b.counts[ib - len(a)]
    return KmerTable(keys=keys, counts=counts.clamp_(max=cs), k=a.k)


def subtract(a: KmerTable, b: KmerTable) -> KmerTable:
    """`kmc_tools simple a b kmers_subtract` (keys of a not in b)."""
    skeys, order, both = _merge_two(a, b)
    only_a = order < len(a)
    only_a[both] = False
    del both
    sel = torch.nonzero(only_a).squeeze(1)
    del only_a
    idx = order[sel]
    del order
    keys = skeys[:, sel]
    del skeys, sel
    return KmerTable(keys=keys, counts=a.counts[idx], k=a.k)


def histogram(t: KmerTable, cx: int = 10000) -> torch.Tensor:
    """Occurrence histogram, int64 [cx]: out[i-1] = #keys with count i."""
    return torch.bincount(t.counts.clamp(max=cx + 1), minlength=cx + 2)[1:cx + 1]


def n_present(t: KmerTable) -> int:
    return len(t)


def total_count(t: KmerTable) -> int:
    return int(t.counts.sum())
