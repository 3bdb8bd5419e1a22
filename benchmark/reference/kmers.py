"""Plain PyTorch canonical k-mer sets and occurrence histograms: the
benchmark's reference for what exp1 and the resident sweep compute.

Written from the definition, not from the program: a k-mer is a window
of k bases A, C, G, T (codes 0-3) with no other symbol in it; its
canonical form is the smaller of its 2-bit value and the value of its
reverse complement; a member "contains" a canonical k-mer when any of
its windows has it.  The occurrence histogram of a set of members holds,
for i = 1..cx, the number of distinct canonical k-mers contained in
exactly i members (occurrences capped at cs).  It uses only torch's own
operations (slices, shifts, cumsum, a stable sort) on whatever device
its inputs are on, and nothing of the program.

A key of up to 49 bases is held as two int64 halves: `lo`, the value of
the last min(k, 31) bases, and `hi`, the value of the bases before them
(0 for k <= 31).  Ordering (hi, lo) pairs is ordering the k-mers' values.

`fold32=True` is the control: each canonical key is replaced by a 32-bit
fingerprint of it (an odd multiplier on the two halves, the low 32 bits
kept), the step a later change that narrows the keys to 32-bit words
would take.  Distinct k-mers that share a fingerprint count as one, so
it breaks the configuration's guarantee of exact counts.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

_LUT = np.full(256, 4, np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    _LUT[_ch] = _i
    _LUT[_ch + 32] = _i  # lower case

_MASK32 = 0xFFFFFFFF


def encode(ascii_bases: np.ndarray) -> np.ndarray:
    """uint8 codes of ASCII bases: A C G T (either case) 0-3, else 4."""
    return _LUT[ascii_bases]


def genome_codes(records) -> np.ndarray:
    """One genome's codes: its records' codes with a 4 between records
    (no window may span two records)."""
    parts = []
    for i, (_name, seq) in enumerate(records):
        if i:
            parts.append(np.full(1, 4, np.uint8))
        parts.append(encode(seq))
    return np.concatenate(parts)


def canonical_keys(codes: torch.Tensor, k: int, fold32: bool = False):
    """(hi, lo) int64 of the canonical k-mer of every valid window of
    uint8 `codes`, in window order."""
    hi, lo, _pos = canonical_windows(codes, k, fold32)
    return hi, lo


def canonical_windows(codes: torch.Tensor, k: int, fold32: bool = False):
    """(hi, lo, start position) of every valid window of uint8 `codes`,
    in window order."""
    n = int(codes.shape[0])
    m = n - k + 1
    if m <= 0:
        empty = torch.zeros(0, dtype=torch.int64, device=codes.device)
        return empty, empty, empty
    bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=codes.device),
                     torch.cumsum((codes > 3).to(torch.int64), 0)])
    valid = (bad[k:] - bad[:m]) == 0
    base = (codes & 3).to(torch.int64)
    comp = 3 - base
    L = min(k, 31)
    f_lo = torch.zeros(m, dtype=torch.int64, device=codes.device)
    f_hi = torch.zeros_like(f_lo)
    r_lo = torch.zeros_like(f_lo)
    r_hi = torch.zeros_like(f_lo)
    for j in range(k - L):  # forward: first k - L bases high
        f_hi = (f_hi << 2) | base[j:j + m]
    for j in range(k - L, k):
        f_lo = (f_lo << 2) | base[j:j + m]
    # reverse complement: base i + t of the window is its digit t
    for t in range(k - 1, L - 1, -1):
        r_hi = (r_hi << 2) | comp[t:t + m]
    for t in range(L - 1, -1, -1):
        r_lo = (r_lo << 2) | comp[t:t + m]
    take_r = (r_hi < f_hi) | ((r_hi == f_hi) & (r_lo < f_lo))
    hi = torch.where(take_r, r_hi, f_hi)[valid]
    lo = torch.where(take_r, r_lo, f_lo)[valid]
    if fold32:
        lo = ((lo * 0x9E3779B1) ^ (hi * 0x85EBCA77) ^ (lo >> 32)) & _MASK32
        hi = torch.zeros_like(lo)
    return hi, lo, torch.nonzero(valid).flatten()


def pair_order(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The stable ascending order of the (hi, lo) pairs: a stable sort by
    lo, then by hi."""
    order = torch.sort(lo, stable=True).indices
    if hi.numel() and bool((hi != 0).any()):
        order = order[torch.sort(hi[order], stable=True).indices]
    return order


def sort_pairs(hi: torch.Tensor, lo: torch.Tensor):
    """(hi, lo) in ascending order of the pair."""
    order = pair_order(hi, lo)
    return hi[order], lo[order]


def run_starts(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """True at the first element of every run of equal sorted pairs."""
    new = torch.ones(hi.shape[0], dtype=torch.bool, device=hi.device)
    if hi.shape[0] > 1:
        new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    return new


def distinct(hi: torch.Tensor, lo: torch.Tensor):
    """The distinct pairs, ascending."""
    hi, lo = sort_pairs(hi, lo)
    new = run_starts(hi, lo)
    return hi[new], lo[new]


def occurrence(member_sets: Sequence[tuple]):
    """(distinct keys (hi, lo) of the union, members containing each) of
    members given as their distinct (hi, lo) sets."""
    hi = torch.cat([s[0] for s in member_sets])
    lo = torch.cat([s[1] for s in member_sets])
    hi, lo = sort_pairs(hi, lo)
    new = run_starts(hi, lo)
    starts = torch.nonzero(new).flatten()
    ends = torch.cat([starts[1:], torch.tensor([hi.shape[0]], device=hi.device)])
    return (hi[starts], lo[starts]), ends - starts


def histogram(occ: torch.Tensor, cs: int, cx: int) -> List[int]:
    """hist[i - 1] = keys with min(occ, cs) == i, for i = 1..cx."""
    counts = torch.bincount(occ.clamp(max=cs), minlength=cx + 1)[1:cx + 1]
    return [int(x) for x in counts.cpu().tolist()]


def member_sets(members: Sequence[np.ndarray], k: int, device, fold32: bool = False) -> list:
    """Each member's (uint8 code array's) distinct canonical k-mers, (hi,
    lo) ascending."""
    sets = []
    for codes in members:
        t = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
        sets.append(distinct(*canonical_keys(t, int(k), fold32)))
        del t
    return sets


def union_keys(members: Sequence[np.ndarray], k: int, device, fold32: bool = False):
    """The distinct canonical k-mers, (hi, lo) ascending, of the union of
    members."""
    sets = member_sets(members, k, device, fold32)
    return distinct(torch.cat([s[0] for s in sets]), torch.cat([s[1] for s in sets]))


def exp1_histograms(groups: Dict[int, List[np.ndarray]], ks: Sequence[int], device,
                    cs: int = 5000, cx: int = 10000, fold32: bool = False):
    """({(k, group): within-group histogram}, {k: across-groups histogram}):
    within a group the members are its genomes; across groups a member is
    a group, which contains a k-mer when any of its genomes does."""
    within, across = {}, {}
    for k in ks:
        k = int(k)
        group_sets = []
        for num in sorted(groups):
            union, occ = occurrence(member_sets(groups[num], k, device, fold32))
            within[(k, num)] = histogram(occ, cs, cx)
            group_sets.append(union)
        _union, occ = occurrence(group_sets)
        del group_sets
        across[k] = histogram(occ, cs, cx)
    return within, across
