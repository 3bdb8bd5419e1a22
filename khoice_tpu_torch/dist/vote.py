"""exp6's sharded read voting over the key-range group (port of
khoice_tpu/dist/vote.py; the design is documented there).

The merge-join of classify/annotate.py::read_votes_bulk_multi, over the
ranks.  The world is one text (engine/members.py): the group texts, then
every pivot's read rows.  Per k, each rank:

- takes its slab of the stream (its chunk of window starts and a kmax-1
  halo; engine/members.py::slab) and extracts the canonical keys of its
  windows with kernel A; each valid window it owns becomes an element with
  an int64 payload: its dataset for a text window, D + its flat position
  in the reads for a query window (the single-device path's payload);
- gives each element the rank of its key range (split keys sampled from
  every rank's elements, dist/occurrence.py::_sampled_splits, used as
  lower bounds: equal keys share a range, so no key's run is torn across
  ranks) and partitions its elements stably by that rank; there is no
  local sort, as nothing is deduped on this path (the JAX package sorts
  locally only to find its split positions);
- sends counts, then the rows, in one all_to_all_single
  (dist/mesh.py::exchange_counts, exchange_rows);
- lays what arrived out as every text element, then every query element,
  and sorts it once, stably (kernels/sort.py): within every key run the
  texts then precede the queries, which `vote_mask` rests on.  The rows
  arrive grouped by the rank that sent them, so without this a run's
  queries from one rank could precede its texts from another;
- takes the run masks (kernels/vote.py::vote_mask) and the per-read sums
  (`read_votes`) over the query windows it received: the validity that
  `read_votes` gets is "received here", since every valid query window
  reaches exactly one rank (the masks of the others are 0 here, not their
  runs');
- sums the int64 votes, unmatched and n_kmers over the group
  (dist/mesh.py::all_sum): integer sums make the result independent of
  the order, equal to the single-device votes at every world size.

Differences from the JAX package, none of which changes a result: the
shares are uneven (no bucket cap, no overflow flag, no retry: `bucket_cap`
is accepted and ignored, and a share past the balanced estimate times
`slack` is logged); invalid windows are dropped before the exchange, not
padded; one slab with the largest k's halo serves every k; the votes are
int64, where the JAX package's uint32 sums wrap past 2^32 (ROADMAP.md
section 3).  Each rank checks its local step and its merge against the
device budget (dist/ksweep.py::_check_budget); a rank over it fails
every rank.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..classify.annotate import vote_lcm
from ..engine import members
from ..engine.bits import key_words, words_lt
from ..engine.streaming import _ALLOCATOR_SLACK, _sort_bytes, default_device_budget_bytes
from ..kernels import vote as kvote
from ..kernels.extract import extract_canonical
from ..kernels.sort import sort_words
from ..utils.logging import get_logger
from .ksweep import _check_budget
from .mesh import KvGroup, all_sum
from .occurrence import _sampled_splits
from .sharded import exchange_ranges

log = get_logger("khoice.dist.vote")


def _vote_layout(group_codes: Sequence[np.ndarray], read_mats: Sequence[np.ndarray]):
    """The world on the host: (parts: the group texts as members, then
    each pivot's read rows (engine/members.py); the datasets' starts; the
    texts' length; row_starts int64 [R + 1]: each read row's first position
    in the reads' flat stream, then its length; spans [(first read, reads)]
    per pivot)."""
    parts, starts, n_text = members.layout(group_codes)
    rows, spans = [], []
    off = rid0 = 0
    for mat in read_mats:
        mat = np.asarray(mat, np.uint8)
        r, l = mat.shape
        parts.append(members.read_rows(mat))
        rows.append(off + np.arange(r, dtype=np.int64) * (l + 1))
        spans.append((rid0, r))
        off += r * (l + 1)
        rid0 += r
    row_starts = np.concatenate(rows + [np.array([off], np.int64)])
    return parts, starts, n_text, row_starts, spans


def _payload(pos: torch.Tensor, starts: torch.Tensor, n_text: int, D: int) -> torch.Tensor:
    """The payload of world positions `pos` (int64): a text position's
    dataset (< D), a read position's D + its flat position in the reads."""
    return torch.where(pos < n_text, members.member_index(starts, pos), pos + (D - n_text))


def build_vote_world(group_codes: Sequence[np.ndarray], read_mats: Sequence[np.ndarray]):
    """The JAX package's host-side world: (codes uint8 [n], pays int64 [n],
    spans) with spans[i] = (first read id, reads) of pivot i.  A query
    position's payload is D + its flat position in the reads (the port's
    single-device payload), where the JAX package's is D + its read id;
    the driver makes the payloads of its own slab on the device instead."""
    parts, starts, n_text, _rows, spans = _vote_layout(group_codes, read_mats)
    codes = members.join(parts)
    pays = _payload(torch.arange(codes.shape[0]), torch.from_numpy(starts), n_text,
                    len(group_codes))
    return codes, pays.numpy(), spans


def local_vote_bytes(slab_len: int, chunk: int, W: int) -> int:
    """Estimated peak device bytes of a rank's steps of one k up to the
    exchange of its rows, beside the slab it holds: over L = slab_len
    windows, m <= chunk of them kept, W key words.  The largest of, in
    turn:
      kernel A's keys and validity, the kept positions  (8 W + 1) L + 8 m
      the kept keys copied out beside the keys           8 W L + 8 (W + 1) m
      the payload (the positions, the datasets, the
      comparison and the choice) beside the kept keys    8 W m + 33 m
      the rows beside the kept keys and payload, then the
      ranks' partition (the range ranks, their compare
      rows, the positions of each rank's share and their
      concatenation) and the rows in that order          16 (W + 1) m + 24 m"""
    m = chunk
    return (max((8 * W + 1) * slab_len + 8 * m, 8 * W * slab_len + 8 * (W + 1) * m,
                (16 * W + 40) * m) + _ALLOCATOR_SLACK)


def merge_vote_bytes(n_recv: int, n_query: int, n_reads: int, W: int, D: int,
                     sent_bytes: int) -> int:
    """Estimated device bytes of a rank's steps from the exchange of its
    rows to its per-read sums over the n_recv elements it receives, beyond
    what it holds when the counts are in (its slab and the `sent_bytes` of
    rows it sends, freed after the exchange): the received rows, 8 (W + 1)
    each, beside the sent ones; then, in turn:
      the texts-first layout (the text flags, each side's positions and
      their concatenation), the rows copied out in that order and the
      received queries' flags (1 B per read position)
                                           16 (W + 1) n_recv + 18 n_recv + n_query
      the sort, its input and output included, beside the flags
                                           _sort_bytes(n_recv, W, True) + n_query
      the masks and the sums: the sorted words and payload, vote_mask's
      scratch (kvote.mask_scratch_bytes: its statuses and the buckets'
      lists, ~8 n_query), the flags, the masks, the row starts, the
      per-read outputs and their concatenation
                   8 (W + 1) n_recv + mask_scratch_bytes(n_recv, n_query) + 9 n_query
                   + 8 (R + 1) + 16 (D + 2) R"""
    after = max(16 * (W + 1) * n_recv + 18 * n_recv + n_query,
                _sort_bytes(n_recv, W, True) + n_query,
                8 * (W + 1) * n_recv + kvote.mask_scratch_bytes(n_recv, n_query) + 9 * n_query
                + 8 * (n_reads + 1) + 16 * (D + 2) * n_reads)
    return max(8 * (W + 1) * n_recv, after - sent_bytes) + _ALLOCATOR_SLACK


def _partition(rows: torch.Tensor, splits: np.ndarray, W: int, world: int):
    """(rows in the order of their key ranges, each range's share): a
    stable partition of element-major rows [m, W + 1] by the rank that
    owns each row's key (the number of split keys <= it)."""
    if world == 1:
        return rows, [rows.shape[0]]
    keys = rows[:, :W].T
    owner = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    for s in torch.from_numpy(np.asarray(splits, np.int64)).to(rows.device):
        owner += ~words_lt(keys, s[:, None])
    parts = [torch.nonzero(owner == r).squeeze(1) for r in range(world)]
    del owner
    shares = [p.shape[0] for p in parts]
    order = torch.cat(parts)
    del parts
    return rows.index_select(0, order), shares


def _texts_first(recv: torch.Tensor, W: int, D: int, n_query: int):
    """(words int64 [W, n], payload int64 [n], here bool [n_query]) of
    received rows [n, W + 1]: laid out as every text element (payload <
    D), then every query element, each side in its order of arrival, and
    the flags of the query windows among them (by flat read position)."""
    text = recv[:, W] < D
    n_text = int(text.sum())
    order = torch.cat([torch.nonzero(text).squeeze(1), torch.nonzero(~text).squeeze(1)])
    del text
    cols = torch.index_select(recv.T, 1, order)  # [W + 1, n], contiguous
    del order
    here = torch.zeros(n_query, dtype=torch.bool, device=recv.device)
    here[cols[W, n_text:] - D] = True
    return cols[:W], cols[W], here


def _join_votes(sw: torch.Tensor, spay: torch.Tensor, here: torch.Tensor,
                row_starts: torch.Tensor, D: int, lcm: int) -> torch.Tensor:
    """int64 [R, D + 2] (votes, unmatched, n_kmers) of the query windows
    flagged in `here`, from their join with the texts, sorted stably with
    the texts first in every key run: the run masks, then the sums."""
    qmask = kvote.vote_mask(sw, spay, D, here.shape[0])
    votes, unmatched, n_kmers = kvote.read_votes(qmask, here, row_starts, D, lcm)
    return torch.cat([votes, unmatched[:, None], n_kmers[:, None]], 1)


def _local_vote(group: KvGroup, slab: torch.Tensor, starts: torch.Tensor, row_starts: torch.Tensor,
                *, k: int, D: int, lcm: int, n_text: int, n_query: int, chunk: int,
                balanced: int, slack: float, budget: int) -> torch.Tensor:
    """One k on this rank: int64 [R, D + 2] (votes, unmatched, n_kmers) of
    every read, summed over the group."""
    W = key_words(k)
    keys, valid = extract_canonical(slab, k)
    pos = torch.nonzero(valid[:chunk]).squeeze(1)  # the valid windows this rank owns
    del valid
    kept = keys.T.index_select(0, pos)  # [m, W]
    del keys
    pos += group.rank * chunk
    pay = _payload(pos, starts, n_text, D)
    del pos
    m = kept.shape[0]
    # a strided sample of the elements in stream order (not sorted: there
    # is no local sort), balanced in expectation; any splits give the
    # same votes
    splits = _sampled_splits(kept.T, m, group.world_size, group, gid_bits=0)
    rows = torch.cat([kept, pay[:, None]], 1)
    del kept, pay
    rows, shares = _partition(rows, splits, W, group.world_size)
    n_reads = row_starts.shape[0] - 1
    recv = exchange_ranges(
        rows, shares, group, balanced, slack, f"vote (k={k})", log,
        before_rows=lambda n_recv: _check_budget(
            merge_vote_bytes(n_recv, n_query, n_reads, W, D, 8 * rows.numel()), budget,
            f"vote (k={k}): merge", group))
    del rows
    # each step's inputs go as soon as it is done: the caller of a helper
    # would keep them alive through the sort
    words, pay, here = _texts_first(recv, W, D, n_query)
    del recv
    sw, spay = sort_words(words, pay)
    del words, pay
    return all_sum(_join_votes(sw, spay, here, row_starts, D, lcm))


def sharded_read_votes_multi(
    group: KvGroup,
    group_codes: Sequence[np.ndarray],
    read_mats: Sequence[np.ndarray],
    ks: Sequence[int],
    bucket_cap: int | None = None,
    slack: float = 1.7,
    device_budget_bytes: int | None = None,
) -> Dict[int, List[tuple]]:
    """{k: [per-pivot (votes [R_i, D] int64, unmatched [R_i], n_kmers
    [R_i])]} on every rank: the sharded twin of
    classify/annotate.py::read_votes_bulk_multi over the k grid, equal to
    it at every world size.  group_codes: one code array per dataset;
    read_mats: each pivot's [R_i, L_i] uint8 read matrix (exp6's
    reads_matrix).  `bucket_cap` is the JAX package's, accepted and
    ignored (the shares are uneven)."""
    del bucket_cap
    D = len(group_codes)
    kvote.check_datasets(D)
    lcm = vote_lcm(D)
    parts, starts, n_text, row_starts, spans = _vote_layout(group_codes, read_mats)
    n, world, dev = n_text + int(row_starts[-1]), group.world_size, group.device
    budget = device_budget_bytes or default_device_budget_bytes(dev)
    chunk = members.chunk_len(n, world)
    # one slab with the largest k's halo serves every k
    slab = torch.from_numpy(members.slab(parts, world, max(ks), group.rank)[0]).to(dev)
    starts_d = torch.from_numpy(starts).to(dev)
    rows_d = torch.from_numpy(row_starts).to(dev)
    out: Dict[int, List[tuple]] = {}
    for k in ks:
        _check_budget(local_vote_bytes(slab.shape[0], chunk, key_words(k)), budget,
                      f"vote (k={k}): local", group)
        sums = _local_vote(group, slab, starts_d, rows_d, k=k, D=D, lcm=lcm, n_text=n_text,
                           n_query=n - n_text, chunk=chunk, balanced=math.ceil(n / world / world),
                           slack=slack, budget=budget).cpu().numpy()
        out[k] = [(sums[r0:r0 + r, :D], sums[r0:r0 + r, D], sums[r0:r0 + r, D + 1])
                  for r0, r in spans]
    return out
