"""Device-side k-mer match annotation and read voting (port of
khoice_tpu/classify/annotate.py): the merge_lists.py core of exp4's
per-k path and of exp6.

The reference tags every pivot k-mer with the datasets whose group union
contains it, by streaming KMC text dumps through Python dicts (reference
src/merge_lists.py:14-33).  Here the pivot table and all D group sets are
concatenated and sorted once; per-run segment sums give the pivot's count
and a presence bitmask over the datasets, aligned on the same keys.
Buckets are exact integers.

exp6 votes per read (src/merge_lists.py:151-183) from ONE merge-join per
k: the canonical keys of every dataset's group text and of every pivot's
reads ride one stable sort (kernels/sort.py), the run masks come back in
read order (kernels/vote.py::vote_mask) and each read sums its windows'
weights LCM / |matches| (kernels/vote.py::read_votes), in int64.  Left
out, since they only served the TPU and change no output: the traced-k
variants (`_read_votes_merge_dyn`, `_merge_votes_dyn`), the 2-bit packed
read upload and the padding to a multiple of 8.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch

from ..engine import members
from ..engine.bits import key_words, words_starts
from ..engine.occurrence import pack_members
from ..engine.ops import _run_sums
from ..engine.streaming import check_device_budget, default_device_budget_bytes, vote_bytes
from ..engine.table import KmerTable
from ..kernels import vote as kvote
from ..kernels.extract import extract_canonical
from ..kernels.sort import sort_words
from ..utils import trace


@dataclasses.dataclass
class Annotation:
    """Merged, sorted keys of a pivot table and D group sets.

    keys: int64 [W, C] unique ascending keys of the pivot and the groups
    pivot_count: int64 [C], the pivot's count (0 where it lacks the key)
    mask: int64 [C], bit d set iff dataset d's group holds the key
    """

    keys: torch.Tensor
    pivot_count: torch.Tensor
    mask: torch.Tensor
    num_datasets: int
    k: int


def build_annotation(pivot: KmerTable, groups: List[KmerTable]) -> Annotation:
    """pivot: a raw-count table; groups: per-dataset set tables (counts 1).
    Each table's keys are unique, so a run holds each source at most once
    and the sum of its sources' bits is their OR."""
    d = len(groups)
    assert 1 <= d <= 62, "the dataset mask is an int64 bitmask"
    tables = [pivot] + list(groups)
    src = torch.cat([torch.full((len(t),), i, dtype=torch.int64, device=pivot.device)
                     for i, t in enumerate(tables)])
    counts = torch.cat([t.counts for t in tables])
    skeys, perm = sort_words(torch.cat([t.keys for t in tables], 1),
                             torch.arange(src.shape[0], device=pivot.device))
    src, counts = src[perm], counts[perm]
    is_new = words_starts(skeys)
    pivot_count = _run_sums(torch.where(src == 0, counts, 0), is_new)
    bit = torch.bitwise_left_shift(torch.ones_like(src), (src - 1).clamp(min=0))
    mask = _run_sums(torch.where(src > 0, bit, 0), is_new)
    return Annotation(skeys[:, is_new], pivot_count, mask, d, pivot.k)


def feature_buckets(ann: Annotation):
    """(buckets [D, D] int64, unique int) on the host: bucket[d, m-1] =
    total pivot count of keys in dataset d matched by m datasets; unique =
    total pivot count of keys matching no dataset."""
    D = ann.num_datasets
    bits = torch.stack([(ann.mask >> d) & 1 for d in range(D)])
    nmatch = bits.sum(0)
    present = ann.pivot_count > 0
    unique = int(ann.pivot_count[present & (nmatch == 0)].sum())
    buckets = torch.zeros(D, D, dtype=torch.int64, device=ann.mask.device)
    for d in range(D):
        sel = present & (bits[d] == 1)
        buckets[d].index_add_(0, nmatch[sel] - 1, ann.pivot_count[sel])
    return buckets.cpu().numpy().astype(np.int64), unique


def vote_lcm(num_datasets: int) -> int:
    """LCM of 1..D: a k-mer matched by |M| datasets votes LCM / |M|."""
    return math.lcm(*range(1, num_datasets + 1))


def build_group_mask_annotation(group_codes: List[np.ndarray], k: int,
                                device="cuda") -> Annotation:
    """Annotation over ALL datasets' texts in ONE sort: each unique valid
    key with the mask of the datasets whose text holds it (pivot_count 0).
    Read voting against it gives the masks of read_votes_bulk: a k-mer in
    no group has mask 0, whether or not the key is in the table."""
    d = len(group_codes)
    kvote.check_datasets(d)
    codes, gids = pack_members(group_codes, device)
    keys, valid = extract_canonical(codes, k)
    skeys, sgid = sort_words(keys[:, valid].contiguous(), gids[valid].contiguous())
    starts = words_starts(skeys)
    mask = kvote.runs_mask(torch.cumsum(starts, 0) - 1, int(starts.sum()), sgid, d)
    return Annotation(skeys[:, starts], torch.zeros_like(mask), mask, d, k)


def read_votes(ann: Annotation, reads_codes: np.ndarray):
    """Integer votes per read against an annotation: (votes [R, D] int64,
    unmatched [R], n_kmers [R]) on the host.  reads_codes: [R, L] uint8
    code matrix (short reads padded with 4s).  The reads' keys are looked
    up by a stable sort after the annotation's unique keys: a query's run
    starts with the annotation's key where it has one.  The reference's
    per-read voting loop is src/merge_lists.py:151-183."""
    dev = ann.mask.device
    flat, r, l = flat_reads_device(reads_codes, dev)
    qkeys, valid = extract_canonical(flat, ann.k)
    n_a, nq = ann.keys.shape[1], qkeys.shape[1]
    skeys, spay = sort_words(torch.cat([ann.keys, qkeys], 1),
                             torch.arange(n_a + nq, device=dev))
    starts = words_starts(skeys)
    # each run's first element: the annotation's key, where it has one
    # (index n_a: the 0 appended for the runs of queries only)
    run_mask = torch.cat([ann.mask, ann.mask.new_zeros(1)])[spay[starts].clamp(max=n_a)]
    query = spay >= n_a
    qmask = torch.empty(nq, dtype=torch.int64, device=dev)
    qmask[spay[query] - n_a] = run_mask[(torch.cumsum(starts, 0) - 1)[query]]
    row_starts = torch.arange(r + 1, device=dev) * (l + 1)
    return _to_host(kvote.read_votes(qmask, valid, row_starts, ann.num_datasets,
                                     vote_lcm(ann.num_datasets)))


def _to_host(out):
    with trace.span("engine:readback"):
        return tuple(t.cpu().numpy() for t in out)


def pack_group_texts(group_codes: List[np.ndarray], device="cuda"):
    """(codes uint8 [n], gids int64 [n]) of the per-dataset group texts on
    `device`, packed once for every k (engine/occurrence.py::pack_members)."""
    return pack_members(group_codes, device)


def flat_reads_device(reads_codes: np.ndarray, device="cuda"):
    """(flat uint8 codes on `device`, r, l): an [r, l] read matrix with a
    separator (4) after each row, flattened, uploaded once."""
    with trace.span("engine:upload"):
        r, l = reads_codes.shape
        return torch.from_numpy(members.read_rows(reads_codes)).to(device), r, l


def concat_flat_reads(flats: Sequence[tuple]):
    """(one flat query array, spans) from flat_reads_device outputs: each
    read row ends with a separator, so no window spans two pivots;
    spans[i] = (offset, r, l) locates pivot i's rows."""
    with trace.span("engine:concat_reads"):
        big = torch.cat([f for f, _, _ in flats])
        spans, off = [], 0
        for f, r, l in flats:
            spans.append((off, r, l))
            off += int(f.shape[0])
        return big, spans


def _merge_join(codes: torch.Tensor, gids: torch.Tensor, flat: torch.Tensor, k: int, D: int):
    """One k's merge-join, sorted: (words int64 [W, n], payload int64 [n],
    qvalid bool [len(flat)]).  The text elements (payload: gid, 0 where
    invalid: their SENTINEL keys meet no valid query) come before the read
    windows (payload: D + flat position), and the sort is stable, as
    vote_mask needs.  Each side's keys go straight into the concatenation
    (engine/streaming.py::vote_bytes)."""
    nt, nq = codes.shape[0], flat.shape[0]
    dev = codes.device
    words = torch.empty(key_words(k), nt + nq, dtype=torch.int64, device=dev)
    pay = torch.empty(nt + nq, dtype=torch.int64, device=dev)
    tkeys, tvalid = extract_canonical(codes, k)
    words[:, :nt] = tkeys
    del tkeys
    pay[:nt] = gids
    pay[:nt].masked_fill_(~tvalid, 0)
    del tvalid
    qkeys, qvalid = extract_canonical(flat, k)
    words[:, nt:] = qkeys
    del qkeys
    pay[nt:] = torch.arange(D, D + nq, device=dev)
    return (*sort_words(words, pay), qvalid)


def _row_starts(spans, n: int, device) -> torch.Tensor:
    """int64 [R + 1]: the first flat position of every read row of the
    spans (rows of l + 1 positions), then n, the end of the last."""
    with trace.span("engine:upload"):
        parts = [off + torch.arange(r, device=device) * (l + 1) for off, r, l in spans]
        return torch.cat(parts + [torch.tensor([n], device=device)])


def read_votes_bulk_multi(group, big_flat: torch.Tensor, spans, k: int, num_datasets: int,
                          device_budget_bytes: int | None = None):
    """ALL pivots' reads voted from ONE merge-join sort per k (exp6).

    group: pack_group_texts output; big_flat/spans: concat_flat_reads
    output.  The step's device bytes are checked against the budget
    (default ~85% of the device) first.  Returns a host (votes [r, D]
    int64, unmatched [r], n_kmers [r]) triple per span."""
    with trace.span("engine:vote"):
        kvote.check_datasets(num_datasets)
        codes, gids = group
        dev = codes.device
        budget = device_budget_bytes or default_device_budget_bytes(dev)
        check_device_budget(vote_bytes(codes.shape[0], big_flat.shape[0], key_words(k)), budget,
                            f"vote (k={k})", dev)
        skeys, spay, qvalid = _merge_join(codes, gids, big_flat, k, num_datasets)
        qmask = kvote.vote_mask(skeys, spay, num_datasets, big_flat.shape[0])
        del skeys, spay
        votes, unmatched, n_kmers = _to_host(kvote.read_votes(
            qmask, qvalid, _row_starts(spans, big_flat.shape[0], dev), num_datasets,
            vote_lcm(num_datasets)))
        out, r0 = [], 0
        for _off, r, _l in spans:
            out.append((votes[r0:r0 + r], unmatched[r0:r0 + r], n_kmers[r0:r0 + r]))
            r0 += r
        return out


def read_votes_bulk(group, reads_codes, k: int, num_datasets: int, device="cuda"):
    """read_votes_bulk_multi for one read matrix: group is a list of
    per-dataset code arrays or a pack_group_texts pair (whose device is
    used); reads_codes an [R, L] uint8 matrix or a flat_reads_device
    triple.  Returns (votes [R, D] int64, unmatched [R], n_kmers [R])."""
    if not isinstance(group, tuple):
        group = pack_group_texts(group, device)
    dev = group[0].device
    if not isinstance(reads_codes, tuple):
        reads_codes = flat_reads_device(reads_codes, dev)
    flat, r, l = reads_codes
    return read_votes_bulk_multi(group, flat, [(0, r, l)], k, num_datasets)[0]
