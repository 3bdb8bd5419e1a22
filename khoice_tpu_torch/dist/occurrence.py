"""The sharded per-k occurrence histogram (port of
khoice_tpu/dist/occurrence.py; the design is documented there).

Distributes engine/occurrence.py over the key-range group: the packed
members are cut into one slab per rank (with a k-1 halo); each rank
extracts its canonical keys with their member ids (kernel A), sorts the
(key, gid) pairs (the radix sort), drops the pairs it holds twice, and
ONE exchange sends them to the rank owning their key range; there they
are merged by one more sort, the occurrence histogram kernel (B for
gid-packed words, C with the gid apart) counts min(occurrences, cs) into
the bins 1..min(members, cx), and the histograms are summed over the
group.  The ks of one group share one slab, built and uploaded once with
the halo of the largest (`sharded_occurrence_histograms`): each k reads
its prefix.

Also here, shared with dist/sharded.py and dist/ksweep.py: a rank's slab
of the group's text on the device (`_make_slab_pair`), the packed split
keys, and the data-sampled split keys (`_sampled_splits`).

Left out: the JAX package's dynamic-k path (`_local_occurrence_dyn_packed`,
a traced k so that one XLA compile serves a word class, with sampled
splits), as the port leaves dynamic-k tracing out everywhere; its
histograms equal the static path's, so `dynamic_k` is accepted and
ignored.  The static path keeps the uniform-CDF split keys.  There are no
bucket caps: the shares are uneven (dist/mesh.py::exchange_counts, exchange_rows), and a share
past the balanced estimate times `slack` is logged.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..engine import members
from ..engine.bits import SENTINEL, words_is_sentinel, words_starts
from ..engine.occurrence import gid_packable, pad_hist
from ..kernels.extract import GID_BITS, extract_canonical, extract_packed, occ_words_static
from ..kernels.occ_scan import occ_hist, occ_hist_packed
from ..kernels.sort import sort_words
from ..utils import trace
from .mesh import KvGroup, _fraction_to_key, all_sum, gather_rows, split_keys_for
from .sharded import exchange_ranges, range_counts

SPLIT_SAMPLE = 128  # per-rank quantile-sample size for data-driven splits


def _make_slab_pair(member_codes: Sequence[np.ndarray], n_shards: int, k: int, rank: int,
                    device):
    """Rank `rank`'s row of the JAX package's _make_slab_pair on `device`
    (engine/members.py: cut without joining the group).  The slab for any
    k' <= k is the first chunk + k' - 1 positions of this one."""
    with trace.span("dist:slab"):
        parts, starts, n = members.layout(member_codes)
        slab, lo = members.slab(parts, n_shards, k, rank)
        gids = members.member_ids(starts, n, lo, lo + slab.shape[0], device)
        return torch.from_numpy(slab).to(device), gids


def split_keys_packed(k: int, n_shards: int) -> np.ndarray:
    """Packed-form split points: (split_key << GID_BITS) over the packed
    word count, so range partitioning by packed value equals partitioning
    by key (gid bits below the shift never affect the range)."""
    ow = occ_words_static(k)
    out = np.zeros((max(n_shards - 1, 0), ow), np.uint32)
    for i in range(1, n_shards):
        frac = 1.0 - math.sqrt(1.0 - i / n_shards)
        kw = _fraction_to_key(frac, k)
        v = 0
        for word in kw:
            v = (v << 32) | int(word)
        v <<= GID_BITS
        for wi in range(ow):
            out[i - 1, wi] = (v >> (32 * (ow - 1 - wi))) & 0xFFFFFFFF
    return out


def _sampled_splits(sp: torch.Tensor, n_valid: int, n_shards: int, group: KvGroup,
                    gid_bits: int = GID_BITS) -> np.ndarray:
    """Data-driven split keys [n_shards-1, w] uint32 from a global WEIGHTED
    quantile sample (skew-robust), the JAX package's method.

    Each rank contributes SPLIT_SAMPLE elements strided over the first
    n_valid columns of its sorted int64 [w, n] words, each weighing
    n_valid / SPLIT_SAMPLE, so ranks with unequal loads are represented in
    proportion.  The sample is all-gathered, sorted with its weights (on
    the host, in rank order, so every rank computes the same bits), and
    the (i / n_shards)-quantiles of the cumulative weight are the split
    keys.  With gid_bits > 0 (packed words) each split is aligned down to
    a key boundary, so that no key's (key, gid) run is torn across
    ranks."""
    with trace.span("dist:splits"):
        w = sp.shape[0]
        S = SPLIT_SAMPLE
        j = torch.arange(S, dtype=torch.int64, device=sp.device)
        idx = torch.clamp(j * (n_valid // S) + (j * (n_valid % S)) // S,
                          max=max(n_valid - 1, 0))
        rows = torch.full((S, w + 1), SENTINEL, dtype=torch.int64, device=sp.device)
        if n_valid:
            rows[:, :w] = sp[:, idx].T
        rows[:, w] = n_valid
        sample = torch.cat(gather_rows(rows, group)).cpu().numpy()
        keys = sample[:, :w].astype(np.uint32)
        weight = sample[:, w].astype(np.float64) / S
        order = np.lexsort(keys.T[::-1])
        cum = np.cumsum(weight[order])
        targets = np.arange(1, n_shards, dtype=np.float64) * cum[-1] / n_shards
        pos = np.minimum(np.searchsorted(cum, targets), cum.shape[0] - 1)
        picked = keys[order][pos]
        if gid_bits:
            picked[:, -1] &= np.uint32((0xFFFFFFFF << gid_bits) & 0xFFFFFFFF)
        return picked


def _balanced(n: int, n_shards: int) -> int:
    """The JAX package's balanced share per (sender, receiver) of n codes."""
    return math.ceil(n / n_shards / n_shards)


def _local_occurrence(group: KvGroup, codes: torch.Tensor, gids: torch.Tensor, k: int,
                      cs: int, n_bins: int, splits: np.ndarray, balanced: int,
                      slack: float) -> torch.Tensor:
    """This rank's histogram, the gid apart: (key, gid) pairs sorted and
    deduped, exchanged, merged, then kernel C."""
    keys, valid = extract_canonical(codes, k)
    gid = torch.where(valid, gids, 0xFFFFFFFF)
    s, _ = sort_words(torch.cat([keys, gid[None]]))
    del keys, gid
    s = s[:, :int(valid.sum())]  # the invalid windows' SENTINEL keys sort last
    s = s[:, words_starts(s)]  # each (key, gid) pair once
    shares = range_counts(s[:-1], splits)
    recv = exchange_ranges(s.T.contiguous(), shares, group, balanced, slack, f"occurrence (k={k})")
    del s
    m, _ = sort_words(recv.T.contiguous())
    del recv
    return occ_hist(m[:-1], m[-1], n_bins, cs)


def _local_occurrence_packed(group: KvGroup, codes: torch.Tensor, gids: torch.Tensor, k: int,
                             cs: int, n_bins: int, splits: np.ndarray, balanced: int,
                             slack: float) -> torch.Tensor:
    """This rank's histogram, gid-packed: (key << 8) | gid words sorted and
    deduped, exchanged, merged, then kernel B."""
    sp, _ = sort_words(extract_packed(codes, gids, k))
    sp = sp[:, :int((~words_is_sentinel(sp)).sum())]  # invalid windows (all ones) sort last
    sp = sp[:, words_starts(sp)]
    shares = range_counts(sp, splits)
    recv = exchange_ranges(sp.T.contiguous(), shares, group, balanced, slack,
                           f"occurrence (k={k})")
    del sp
    m, _ = sort_words(recv.T.contiguous())
    del recv
    return occ_hist_packed(m, n_bins, cs)


def sharded_occurrence_histograms(
    group: KvGroup,
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    cs: int = 5000,
    cx: int = 10000,
    slack: float = 1.5,
) -> Dict[int, List[int]]:
    """{k: sharded_occurrence_histogram(group, member_codes, k, ...)} for
    every k of `ks`, equal on every rank.  The rank's slab is built and
    uploaded once, at the largest k, and each k runs on its first
    chunk + k - 1 positions; it is freed before the call returns."""
    if not ks:
        return {}
    D = group.world_size
    n = members.layout(member_codes)[2]
    chunk = members.chunk_len(n, D)
    n_bins = min(len(member_codes), cx)
    slab_codes, slab_gids = _make_slab_pair(member_codes, D, max(ks), group.rank, group.device)
    out: Dict[int, List[int]] = {}
    for k in ks:
        packed = gid_packable(len(member_codes), k)
        local = _local_occurrence_packed if packed else _local_occurrence
        splits = split_keys_packed(k, D) if packed else split_keys_for(k, D)
        L = chunk + k - 1
        hist = local(group, slab_codes[:L], slab_gids[:L], k, cs, n_bins, splits,
                     _balanced(n, D), slack)
        out[k] = pad_hist(all_sum(hist), len(member_codes), cx)
    del slab_codes, slab_gids
    return out


def sharded_occurrence_histogram(
    group: KvGroup,
    member_codes: Sequence[np.ndarray],
    k: int,
    cs: int = 5000,
    cx: int = 10000,
    slack: float = 1.5,
    dynamic_k: bool = True,
) -> List[int]:
    """Multi-rank equivalent of engine.occurrence.occurrence_histogram: a
    list of cx ints, equal on every rank, at any world size.  Gid-packed
    (kernel B) up to 256 members and k <= 60, else the gid apart (kernel
    C), as on one device.  `dynamic_k` is the JAX package's traced-k
    switch; the port has no dynamic-k path, and the static path gives
    the same histogram, so it is ignored."""
    del dynamic_k
    return sharded_occurrence_histograms(group, member_codes, [k], cs, cx, slack)[k]
