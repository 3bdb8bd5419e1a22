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
radix sort (kernels/sort.py); run sums come from run ids
(cumsum of the run starts) and a segment sum, not from the JAX package's
reverse cummin, which cost 750 ms over an exp1 run on an H100.
"""

from __future__ import annotations

import torch

from ..kernels.extract import extract_canonical
from ..kernels.sort import sort_words
from .bits import words_eq, words_is_sentinel
from .table import KmerTable

__all__ = [
    "count_codes",
    "count_keys",
    "dedupe_sorted",
    "set_counts",
    "union_many",
    "intersect_sum",
    "subtract",
    "histogram",
    "n_present",
    "total_count",
]


def _run_starts(keys: torch.Tensor) -> torch.Tensor:
    """is_new[i] = keys[i] != keys[i-1] (run boundaries of sorted keys)."""
    is_new = ~words_eq(keys, torch.roll(keys, 1, dims=1))
    if is_new.shape[0]:
        is_new[0] = True
    return is_new


def _run_sums(values: torch.Tensor, is_new: torch.Tensor) -> torch.Tensor:
    """int64 [runs]: each run's sum of `values`."""
    run_id = torch.cumsum(is_new, 0) - 1
    sums = torch.zeros(int(is_new.sum()), dtype=torch.int64, device=values.device)
    return sums.index_add_(0, run_id, values.to(torch.int64))


def dedupe_sorted(keys: torch.Tensor, counts: torch.Tensor, cs: int) -> tuple:
    """Collapse the runs of equal keys of a sorted array, summing counts
    (saturating at cs); SENTINEL keys and zero sums are dropped.  Returns
    (unique keys int64 [W, m], counts int64 [m])."""
    is_new = _run_starts(keys)
    sums = _run_sums(counts, is_new).clamp(max=cs)
    ukeys = keys[:, is_new]
    keep = (sums > 0) & ~words_is_sentinel(ukeys)
    return ukeys[:, keep].contiguous(), sums[keep]


def count_keys(keys: torch.Tensor, valid: torch.Tensor, k: int, cs: int = 255) -> KmerTable:
    """A count table from extracted canonical keys and their validity."""
    skeys, _ = sort_words(keys[:, valid].contiguous())
    ukeys, ucounts = dedupe_sorted(skeys, torch.ones_like(skeys[0]), cs)
    return KmerTable(keys=ukeys, counts=ucounts, k=k)


def count_codes(codes: torch.Tensor, k: int, cs: int = 255) -> KmerTable:
    """Canonical k-mer counting over uint8 codes (KMC `kmc -ci1` role)."""
    keys, valid = extract_canonical(codes, k)
    return count_keys(keys, valid, k, cs)


def set_counts(t: KmerTable, c: int) -> KmerTable:
    if c <= 0:  # no key stays present
        return KmerTable(keys=t.keys[:, :0], counts=t.counts[:0], k=t.k)
    return KmerTable(keys=t.keys, counts=torch.full_like(t.counts, c), k=t.k)


def union_many(tables: list, cs: int = 5000) -> KmerTable:
    """n-way union with counter sum (kmc_tools complex '+', -cs{cs})."""
    k = tables[0].k
    for t in tables:
        assert t.k == k and t.n_words == tables[0].n_words
    skeys, scounts = sort_words(torch.cat([t.keys for t in tables], 1),
                                torch.cat([t.counts for t in tables]))
    ukeys, ucounts = dedupe_sorted(skeys, scounts, cs)
    return KmerTable(keys=ukeys, counts=ucounts, k=k)


def _merge_two(a: KmerTable, b: KmerTable):
    """(keys in both, a's counts, b's counts there; keys of a only, a's
    counts there).  Keys are unique within each table, so after one sort
    a key of both is a pair of neighbours, a's first (the sort is stable)."""
    assert a.k == b.k and a.n_words == b.n_words
    na = len(a)
    idx = torch.arange(na + len(b), device=a.device)
    skeys, sidx = sort_words(torch.cat([a.keys, b.keys], 1), idx)
    counts = torch.cat([a.counts, b.counts])[sidx]
    from_a = sidx < na
    pair = words_eq(skeys[:, 1:], skeys[:, :-1])  # element i+1 repeats element i
    both = torch.nonzero(pair).squeeze(1)
    paired = torch.zeros_like(from_a)
    paired[both] = True
    only_a = from_a & ~paired
    return (skeys[:, both], counts[both], counts[both + 1],
            skeys[:, only_a], counts[only_a])


def intersect_sum(a: KmerTable, b: KmerTable, cs: int = 255) -> KmerTable:
    """`kmc_tools simple a b intersect -ocsum` (keys in both, counts summed)."""
    keys, ca, cb, _, _ = _merge_two(a, b)
    return KmerTable(keys=keys.contiguous(), counts=(ca + cb).clamp(max=cs), k=a.k)


def subtract(a: KmerTable, b: KmerTable) -> KmerTable:
    """`kmc_tools simple a b kmers_subtract` (keys of a not in b)."""
    _, _, _, keys, counts = _merge_two(a, b)
    return KmerTable(keys=keys.contiguous(), counts=counts, k=a.k)


def histogram(t: KmerTable, cx: int = 10000) -> torch.Tensor:
    """Occurrence histogram, int64 [cx]: out[i-1] = #keys with count i."""
    return torch.bincount(t.counts.clamp(max=cx + 1), minlength=cx + 2)[1:cx + 1]


def n_present(t: KmerTable) -> int:
    return len(t)


def total_count(t: KmerTable) -> int:
    return int(t.counts.sum())
