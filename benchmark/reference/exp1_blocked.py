"""exp1's occurrence histograms by the plain reference (reference/kmers.py),
computed in blocks of the key space so that a database one card cannot
hold whole still fits: the reference of the four-card cell, whose check
deals the ks out to the cell's cards, a process each, once the program
has let them go.

The histograms count distinct canonical k-mers by the number of members
holding them, and the distinct k-mers of disjoint parts of the key space
are disjoint, so the histogram of every part, summed, is the histogram of
the whole (exact integer sums).  Each member's distinct canonical k-mers
are worked out once a k (kmers.member_sets); then, for each of `blocks`
parts (a key's part is its lo half's low bits, the same for equal keys),
each group's members' keys of that part are counted (kmers.occurrence),
and the groups' unions of that part are counted across groups.  Only one
part's keys are sorted at a time: about 1/blocks of what kmers.
exp1_histograms sorts at once.  Nothing of the program is imported.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Sequence

import numpy as np

from benchmark.reference import kmers

BLOCKS = 4


def _add(total, hist):
    return hist if total is None else [a + b for a, b in zip(total, hist)]


def _histograms(groups, ks, device, cs, cx, fold32, blocks):
    within, across = {}, {}
    for k in ks:
        k = int(k)
        sets = {num: kmers.member_sets(groups[num], k, device, fold32) for num in sorted(groups)}
        for b in range(blocks):
            unions = []
            for num, members in sets.items():
                part = []
                for hi, lo in members:
                    keep = (lo % blocks) == b
                    part.append((hi[keep], lo[keep]))
                union, occ = kmers.occurrence(part)
                del part
                within[(k, num)] = _add(within.get((k, num)), kmers.histogram(occ, cs, cx))
                unions.append(union)
            _union, occ = kmers.occurrence(unions)
            del unions
            across[k] = _add(across.get(k), kmers.histogram(occ, cs, cx))
        del sets
    return within, across


def exp1_histograms(groups: Dict[int, List[np.ndarray]], ks: Sequence[int], devices,
                    cs: int = 5000, cx: int = 10000, fold32: bool = False,
                    blocks: int = BLOCKS):
    """kmers.exp1_histograms(groups, ks, device, cs, cx, fold32), the
    same ({(k, group): within-group histogram}, {k: across-groups
    histogram}), computed one part of the key space at a time.  The ks are
    dealt out to `devices` (a list): the first share runs here, each other
    in a process of its own (the reference is bound by the host's Python
    work, so threads would share one interpreter lock)."""
    shares = [list(ks)[i::len(devices)] for i in range(len(devices))]
    args = (cs, cx, fold32, blocks)
    pool = None
    try:
        if len(devices) > 1:
            pool = ProcessPoolExecutor(len(devices) - 1,
                                       mp_context=multiprocessing.get_context("spawn"))
            others = [pool.submit(_histograms, groups, share, device, *args)
                      for share, device in zip(shares[1:], devices[1:])]
        results = [_histograms(groups, shares[0], devices[0], *args)]
        if pool is not None:
            results += [done.result() for done in others]
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    within, across = {}, {}
    for w, a in results:
        within.update(w)
        across.update(a)
    return within, across
