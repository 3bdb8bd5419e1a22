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
group.

Also here, shared with dist/sharded.py and dist/ksweep.py: the slabs of
the packed members (`_make_slab_pair`), the packed split keys, and the
data-sampled split keys (`_sampled_splits`).

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
from typing import List, Sequence

import numpy as np
import torch

from ..engine.bits import SENTINEL, words_is_sentinel, words_starts
from ..engine.occurrence import _member_layout, gid_packable
from ..kernels.extract import GID_BITS, extract_canonical, extract_packed, occ_words_static
from ..kernels.occ_scan import occ_hist, occ_hist_packed
from ..kernels.sort import sort_words
from .mesh import KvGroup, _fraction_to_key, all_sum, gather_rows, split_keys_for
from .sharded import exchange_ranges, make_slab, range_counts

SPLIT_SAMPLE = 128  # per-rank quantile-sample size for data-driven splits


def _make_slab_pair(codes: np.ndarray, starts: np.ndarray, n_shards: int, k: int, rank: int,
                    device):
    """Rank `rank`'s row of the JAX package's _make_slab_pair, on `device`:
    its chunk of the packed codes (engine/occurrence.py::_member_layout:
    members joined with one separator each, member m from starts[m]) with
    a k-1 halo, padded to chunk + k - 1 with code 4, and each position's
    member index (0 in the padding).  Only the codes (1 B per position)
    cross to the device; the member indices are found there from the
    starts, as engine/occurrence.py::pack_members expands them."""
    n = codes.shape[0]
    slab = make_slab(codes, n_shards, k, rank)
    lo = rank * max(1, math.ceil(n / n_shards))
    pos = torch.arange(lo, lo + slab.shape[0], dtype=torch.int64, device=device)
    gids = torch.searchsorted(torch.from_numpy(starts).to(device), pos, right=True) - 1
    gids.masked_fill_(pos >= n, 0)
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
    w = sp.shape[0]
    S = SPLIT_SAMPLE
    j = torch.arange(S, dtype=torch.int64, device=sp.device)
    idx = torch.clamp(j * (n_valid // S) + (j * (n_valid % S)) // S, max=max(n_valid - 1, 0))
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
    D = group.world_size
    codes, starts = _member_layout(member_codes)
    packed = gid_packable(len(member_codes), k)
    slab_codes, slab_gids = _make_slab_pair(codes, starts, D, k, group.rank, group.device)
    n_bins = min(len(member_codes), cx)
    local = _local_occurrence_packed if packed else _local_occurrence
    splits = split_keys_packed(k, D) if packed else split_keys_for(k, D)
    hist = local(group, slab_codes, slab_gids, k, cs, n_bins, splits,
                 _balanced(codes.shape[0], D), slack)
    return all_sum(hist).tolist() + [0] * (cx - n_bins)
