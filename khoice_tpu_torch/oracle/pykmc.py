# Copied from khoice_tpu/oracle/pykmc.py.
"""Trusted slow reference: dict-based KMC3-semantics k-mer algebra.

KMC3 cannot be installed in this environment, so golden tests compare the
TPU engine against this independent pure-Python implementation of the same
contract (canonical = lexicographic min(kmer, revcomp) under A<C<G<T,
N-containing k-mers skipped, saturating counters — the semantics the
reference pipeline depends on, see src/merge_lists.py:60-73 and
workflow/rules/exp_type_1.smk:163 in the reference repo).

This module is intentionally simple and dictionary-based; it is used by
tests and by the golden end-to-end pipeline checks, never by the engine.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

_COMP = str.maketrans("ACGT", "TGCA")
_VALID = frozenset("ACGT")


def revcomp(kmer: str) -> str:
    return kmer.translate(_COMP)[::-1]


def canonical(kmer: str) -> str:
    rc = revcomp(kmer)
    return kmer if kmer <= rc else rc


def count_kmers(seqs: Iterable[str], k: int, cs: int = 255) -> Dict[str, int]:
    """Canonical k-mer counts over sequences (KMC `kmc -ci1 -cs{cs}` role)."""
    counts: Dict[str, int] = {}
    for seq in seqs:
        seq = seq.upper()
        n = len(seq)
        for i in range(n - k + 1):
            kmer = seq[i : i + k]
            if not _VALID.issuperset(kmer):
                continue
            c = canonical(kmer)
            counts[c] = counts.get(c, 0) + 1
    return {km: min(v, cs) for km, v in counts.items()}


def set_counts(d: Dict[str, int], c: int) -> Dict[str, int]:
    return {km: c for km in d}


def union_sum(dicts: List[Dict[str, int]], cs: int = 5000) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for d in dicts:
        for km, v in d.items():
            out[km] = out.get(km, 0) + v
    return {km: min(v, cs) for km, v in out.items()}


def intersect_sum(a: Dict[str, int], b: Dict[str, int], cs: int = 255) -> Dict[str, int]:
    return {km: min(a[km] + b[km], cs) for km in a if km in b}


def subtract(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {km: v for km, v in a.items() if km not in b}


def histogram(d: Dict[str, int], cx: int = 10000) -> List[int]:
    """hist[i-1] = #kmers with count i, for i = 1..cx."""
    out = [0] * cx
    for v in d.values():
        if 1 <= v <= cx:
            out[v - 1] += 1
    return out


def sorted_dump(d: Dict[str, int]) -> List[tuple]:
    return sorted(d.items())
