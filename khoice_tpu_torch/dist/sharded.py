"""Sharded k-mer tables over the key-range group (port of
khoice_tpu/dist/sharded.py; the design is documented there).

In short: a genome's codes are cut into one slab per rank (with a k-1
halo, so a k-mer across a slab boundary is counted once); each rank
extracts and counts its slab (kernel A and the radix sort through
engine/ops.py), and ONE exchange sends every (key, count) run to the rank
owning its key range, where the runs are merged (a sort and run sums,
capped at cs).  Afterwards every set operation is shard-local, and a
histogram is a local histogram plus one all-reduce.

Differences from the JAX package, none of which changes a result:
- a rank holds only its own shard, compact (engine/table.py): no
  [n_shards] axis, no SENTINEL padding, no capacity;
- the exchange sends uneven shares (dist/mesh.py::exchange_counts, exchange_rows), so there is
  no bucket cap, no overflow flag and no retry with a doubled cap (those
  served XLA's static shapes); a share past the balanced estimate times
  `slack` is logged instead;
- `rank_positions` compacts the live elements (the shapes are dynamic),
  where the JAX package bucketed in rank space;
- split points are computed on the host from the all-gathered sample
  (dist/occurrence.py::_sampled_splits), so every rank holds the same
  bits.

Split-point discipline (the JAX package's round-2 rule): every table that
will be combined must share one key-range partition.  The first table
built for a (group, k, world size) samples its splits from its own data
and pins them in the session cache; every later table reuses them.  The
algebra checks that its operands share their splits and re-partitions a
foreign table (`resplit`, e.g. one carried over from the JAX package)
onto the first operand's.

Every function here is collective: all ranks of the group call it with
the same arguments, in the same order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine import ops
from ..engine.bits import SENTINEL, words_lt
from ..engine.table import KmerTable, decode_key, table_from_host
from ..utils.logging import get_logger
from .mesh import KvGroup, all_sum, exchange_counts, exchange_rows, gather_rows

NO_SAT = (1 << 31) - 1  # "no saturation yet": the cap cs applies after the merge

log = get_logger("khoice.dist.sharded")


@dataclasses.dataclass
class ShardedKmerTable:
    """One rank's shard of a k-mer table: the keys in [split_{r-1},
    split_r), sorted, with their counts.  Shard ranges ascend with the
    rank, so rank-order concatenation is globally sorted.  ``splits`` is
    the host [world-1, n_words] uint32 split-key table of the partition;
    the algebra requires its operands to share it."""

    table: KmerTable
    group: KvGroup
    splits: Optional[np.ndarray] = None

    @property
    def k(self) -> int:
        return self.table.k

    @property
    def n_shards(self) -> int:
        return self.group.world_size

    def dump(self):
        """Globally sorted (kmer, count) records of every shard, on every
        rank: multi-shard `dump -s`."""
        keys, counts = _host_flatten(self)
        return [(decode_key(keys[i], self.k), int(counts[i])) for i in range(keys.shape[0])]


# ---------------------------------------------------------------------------
# Session split-point registry: one partition per (group, k, world size)
# ---------------------------------------------------------------------------

_SESSION_SPLITS: Dict[tuple, np.ndarray] = {}


def session_splits(group: KvGroup, k: int, n_shards: int) -> Optional[np.ndarray]:
    return _SESSION_SPLITS.get((group, k, n_shards))


def reset_session_splits() -> None:
    """Drop pinned split points (tests / fresh datasets with new skew)."""
    _SESSION_SPLITS.clear()


def make_slab(codes: np.ndarray, n_shards: int, k: int, rank: int) -> np.ndarray:
    """Rank `rank`'s row of the JAX package's make_slabs: the codes of window
    starts [rank * chunk, (rank + 1) * chunk) and a k-1 halo, padded with
    the invalid code 4 to chunk + k - 1, so that a k-mer across a slab
    boundary is counted once."""
    n = codes.shape[0]
    chunk = max(1, math.ceil(n / n_shards))
    out = np.full(chunk + k - 1, 4, np.uint8)
    lo = rank * chunk
    if lo < n:
        part = codes[lo:lo + chunk + k - 1]
        out[:part.shape[0]] = part
    return out


def rank_positions(live: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(positions of the live elements of a sorted array, ascending; their
    number).  The JAX package bucketed its exchange in the rank space of
    the live elements (rank, position, total) so that a massively repeated
    key could not overflow a static bucket; with dynamic shapes the port
    compacts the live elements, and an element's rank is its index in the
    compacted array."""
    pos = torch.nonzero(live).squeeze(1)
    return pos, pos.shape[0]


def range_counts(words: torch.Tensor, splits: np.ndarray) -> List[int]:
    """The share of each rank's key range in sorted int64 [W, n] words: the
    elements below split 0, between splits 0 and 1, ..., from the last
    split on (a split compares with the leading words of each element)."""
    n = words.shape[1]
    below = [torch.zeros((), dtype=torch.int64, device=words.device)]
    for s in torch.from_numpy(np.asarray(splits, np.int64)).to(words.device):
        below.append(words_lt(words[:s.shape[0]], s[:, None]).sum())
    bounds = torch.stack(below).tolist() + [n]
    return [hi - lo for lo, hi in zip(bounds[:-1], bounds[1:])]


def exchange_ranges(rows: torch.Tensor, shares: List[int], group: KvGroup, balanced: int,
                    slack: float, what: str, logger=log, before_rows=None) -> torch.Tensor:
    """dist/mesh.py's exchange of element-major rows whose shares for ranks
    0, 1, ... are `shares`: the counts, then `before_rows(number of rows
    coming here)` if given (the sweep's budget check), then the rows.  A
    share received here past the balanced estimate times `slack` (at
    least 64) is logged: the JAX package doubled its bucket cap there, the
    port's shares have none."""
    recv_shares = exchange_counts(shares, group)
    limit = max(64, int(slack * balanced))
    if group.world_size > 1 and max(recv_shares) > limit:
        logger.warning(
            "%s: rank %d receives a share of %d elements from one rank, past the balanced "
            "estimate %d x slack %.1f (a skewed key distribution); shard balance is degraded",
            what, group.rank, max(recv_shares), balanced, slack,
        )
    if before_rows is not None:
        before_rows(sum(recv_shares))
    return exchange_rows(rows, shares, recv_shares)


def _merge_counts(rows: torch.Tensor, k: int, cs: int) -> KmerTable:
    """The table of received (key words..., count) rows: each key's counts
    summed and capped at cs (ops.union_many over the one table they form,
    whose keys repeat across the ranks that sent them)."""
    w = rows.shape[1] - 1
    received = KmerTable(keys=rows[:, :w].T.contiguous(), counts=rows[:, w].contiguous(), k=k)
    return ops.union_many([received], cs=cs)


def sharded_count_codes(group: KvGroup, codes: np.ndarray, k: int, cs: int = 255,
                        slack: float = 1.5) -> ShardedKmerTable:
    """Count canonical k-mers of one code array across the group.

    Exact and independent of the world size.  The first call for a
    (group, k, world size) samples skew-robust split points from its own
    deduped keys and pins them for the session, so every table of that
    configuration shares one key-range partition (the `kmc_tools complex`
    union contract, reference workflow/rules/exp_type_1.smk:175-182)."""
    from .occurrence import _sampled_splits

    D = group.world_size
    codes = np.asarray(codes, np.uint8)
    slab = torch.from_numpy(make_slab(codes, D, k, group.rank)).to(group.device)
    local = ops.count_codes(slab, k, NO_SAT)  # kernel A, the sort, run lengths
    del slab
    skey = (group, k, D)
    splits = _SESSION_SPLITS.get(skey)
    if splits is None:
        # sampled over the distinct keys: repeats carry no extra weight,
        # so skewed data still yields balanced shards
        splits = _sampled_splits(local.keys, len(local), D, group, gid_bits=0)
    rows = torch.cat([local.keys, local.counts[None]]).T.contiguous()
    shares = range_counts(local.keys, splits)
    del local
    recv = exchange_ranges(rows, shares, group, math.ceil(codes.shape[0] / D / D), slack,
                           f"count (k={k})")
    del rows
    table = _merge_counts(recv, k, cs)
    _SESSION_SPLITS.setdefault(skey, splits)
    return ShardedKmerTable(table=table, group=group, splits=splits)


# ---------------------------------------------------------------------------
# State carried across: a table's host arrays, in the JAX package's layout
# ---------------------------------------------------------------------------


def _host_flatten(t: ShardedKmerTable) -> Tuple[np.ndarray, np.ndarray]:
    """Every shard's (key, count) rows in global sorted order, on every
    rank, as host arrays: (keys [n, w] uint32, counts [n] uint32)."""
    rows = torch.cat([t.table.keys, t.table.counts[None]]).T.contiguous()
    allr = torch.cat(gather_rows(rows, t.group)).cpu().numpy()
    w = t.table.n_words
    return allr[:, :w].astype(np.uint32), allr[:, w].astype(np.uint32)


def sharded_table_to_host(t: ShardedKmerTable):
    """(words [w, D, C] uint32, counts [D, C] uint32, splits [D-1, w]
    uint32): the host arrays of a JAX package ShardedKmerTable
    (`np.asarray` of its key words and counts), on every rank; row d is
    shard d, padded to C with SENTINEL keys and count 0."""
    rows = torch.cat([t.table.keys, t.table.counts[None]]).T.contiguous()
    parts = [p.cpu().numpy() for p in gather_rows(rows, t.group)]
    w, D = t.table.n_words, t.n_shards
    C = max(p.shape[0] for p in parts)
    words = np.full((w, D, C), SENTINEL, np.uint32)
    counts = np.zeros((D, C), np.uint32)
    for d, p in enumerate(parts):
        words[:, d, :p.shape[0]] = p[:, :w].T
        counts[d, :p.shape[0]] = p[:, w]
    return words, counts, t.splits


def sharded_table_from_host(words, counts, splits, k: int, group: KvGroup) -> ShardedKmerTable:
    """The inverse of sharded_table_to_host, and the way in for a JAX
    package ShardedKmerTable's host arrays (words [w, D, C] as `np.asarray`
    of its key tuple gives them, counts [D, C], splits [D-1, w]): rank r
    keeps row r, without the run form's zero-count slots and SENTINEL
    padding.  D must be the group's world size."""
    words = np.asarray(words, np.uint32)
    counts = np.asarray(counts)
    if words.ndim != 3 or words.shape[1] != group.world_size:
        raise ValueError(f"words of shape {words.shape} are not [w, {group.world_size}, C]")
    r = group.rank
    table = table_from_host(k, words[:, r, :].T, counts[r], group.device)
    return ShardedKmerTable(table=table, group=group, splits=np.asarray(splits, np.uint32))


# ---------------------------------------------------------------------------
# Foreign-partition fallback: re-shard onto given split points
# ---------------------------------------------------------------------------


def resplit(t: ShardedKmerTable, splits: np.ndarray) -> ShardedKmerTable:
    """Re-partition a table onto a different split-key table: every rank
    gathers the whole table and keeps its new range.  Only tables built
    under different sessions (or carried over from the JAX package) take
    this path; tables built in-session share pinned splits."""
    rows = torch.cat(gather_rows(torch.cat([t.table.keys, t.table.counts[None]]).T.contiguous(),
                                 t.group))
    w = t.table.n_words
    keys = rows[:, :w].T.contiguous()
    shares = range_counts(keys, splits)
    lo = sum(shares[:t.group.rank])
    hi = lo + shares[t.group.rank]
    table = KmerTable(keys=keys[:, lo:hi].contiguous(), counts=rows[lo:hi, w].contiguous(), k=t.k)
    return ShardedKmerTable(table=table, group=t.group, splits=np.asarray(splits, np.uint32))


def _common_partition(tables: Sequence[ShardedKmerTable]) -> List[ShardedKmerTable]:
    """Ensure all operands share one split table (the shard-local algebra's
    precondition); re-shard foreigners onto the first table's partition."""
    ref = tables[0].splits
    out = [tables[0]]
    for t in tables[1:]:
        if ref is None and t.splits is None:
            out.append(t)
        elif ref is not None and t.splits is not None:
            out.append(t if np.array_equal(ref, t.splits) else resplit(t, ref))
        else:
            raise ValueError(
                "cannot combine ShardedKmerTables with unknown split points; "
                "rebuild them via sharded_count_codes in this session"
            )
    return out


def _shardwise(op, tables: Sequence[ShardedKmerTable]) -> ShardedKmerTable:
    """Run a table op of engine/ops.py on every rank's shards."""
    tables = _common_partition(tables)
    out = op(*[t.table for t in tables])
    return ShardedKmerTable(table=out, group=tables[0].group, splits=tables[0].splits)


def sharded_union_many(tables: List[ShardedKmerTable], cs: int = 5000) -> ShardedKmerTable:
    """n-way union with counter sum, shard-local (no collectives)."""
    return _shardwise(lambda *ts: ops.union_many(list(ts), cs=cs), tables)


def sharded_intersect_sum(a: ShardedKmerTable, b: ShardedKmerTable,
                          cs: int = 255) -> ShardedKmerTable:
    return _shardwise(lambda x, y: ops.intersect_sum(x, y, cs=cs), [a, b])


def sharded_subtract(a: ShardedKmerTable, b: ShardedKmerTable) -> ShardedKmerTable:
    return _shardwise(ops.subtract, [a, b])


def sharded_set_counts(t: ShardedKmerTable, c: int) -> ShardedKmerTable:
    return ShardedKmerTable(table=ops.set_counts(t.table, c), group=t.group, splits=t.splits)


def sharded_histogram(t: ShardedKmerTable, cx: int = 10000) -> np.ndarray:
    """Occurrence histogram: the shard-local histogram summed over the group."""
    return all_sum(ops.histogram(t.table, cx=cx)).cpu().numpy()
