"""The sharded shared-sort k-sweep: exp1-4's sweeps over the key-range
group (port of khoice_tpu/dist/ksweep.py; the design is documented there).

Distributes engine/ksweep.py (every k's stats from one doubled-text
sort) over the ranks:

- the packed members are cut into one slab per rank with a kmax-1 halo;
  each rank builds its LOCAL doubled text (slab ++ revcomp(slab)) and
  extracts the forward kmax-mer elements of its own windows on both
  strands (kernels/extract_sweep.py::doubled_elements, the extraction
  kernel as on one device); rank 0 owns its whole reverse-complement
  half, which holds the first kmax-k rc k-mers of the text for each k;
- elements no k of the class can use (nio < kmin) are dropped, the rest
  sorted (the radix sort) and (key, gid, nio)-deduped, except in exp4's
  "buckets" mode, which sums pivot multiplicities;
- ONE exchange sends them by data-sampled split points ALIGNED DOWN to
  2*kmin-bit prefix boundaries: a k-run (k >= kmin) is a set of keys
  sharing their top 2k bits, so every k-run of every k in the class lands
  wholly on one rank;
- each rank sorts what it received and runs the multi-k scan kernel in
  RAW form (kernels/ksweep_scan.py: `scan_multi_k`, or `scan_classify`
  for the classification modes); the raw (doubled, palindromic) stats
  are summed over the group BEFORE the canonical (d+p)//2 combine,
  because a class's two strand runs generally land on different ranks.

The JAX package scans with `_scan_multi_k_xla`; the port's kernel
computes the same function.  Dropped elements are compacted away, where
the JAX package padded them with its `_PACK_PAD_LAST` encoding for
static shapes; the shares are uneven (dist/mesh.py::exchange_counts, exchange_rows), with no
bucket cap and no retry, and a share past the balanced estimate times
`slack` is logged as the JAX package's doubled cap was.  Each rank checks
the class's device bytes against the budget before its local steps and
again before the merge (engine/streaming.py::check_device_budget); a
rank over it fails every rank.  There is no streaming under a group, as
in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..engine.bits import words_starts
from ..engine.ksweep import _doubled_elements, plan_sweep
from ..engine.streaming import (
    _ALLOCATOR_SLACK,
    DeviceBudgetExceeded,
    _sort_bytes,
    check_device_budget,
    default_device_budget_bytes,
)
from ..kernels.ksweep_scan import NIO_BITS, PACK_NIO_BITS, scan_classify, scan_multi_k
from ..kernels.sort import sort_words
from ..utils.logging import get_logger
from .mesh import KvGroup, all_sum
from ..engine.occurrence import _member_layout
from .occurrence import _make_slab_pair, _sampled_splits
from .sharded import exchange_ranges, range_counts, rank_positions

log = get_logger("khoice.dist.ksweep")


def _align_splits_to_prefix(splits: np.ndarray, kmin: int, KW: int) -> np.ndarray:
    """Zero every bit below the top 2*kmin of [D-1, KW] uint32 split keys:
    the splits then sit on kmin-prefix boundaries, so no k-run (k >= kmin)
    is ever torn across ranks.  The words are held in int64, and no shift
    leaves 32 bits."""
    cut = KW * 32 - 2 * kmin  # number of low bits to clear
    out = np.asarray(splits, np.int64).copy()
    for i in range(KW):
        lo_bit = (KW - 1 - i) * 32
        if lo_bit + 32 <= cut:
            out[:, i] = 0
        elif lo_bit < cut:
            s = cut - lo_bit
            out[:, i] = (out[:, i] >> s) << s
    return out.astype(np.uint32)


def local_sweep_bytes(slab_len: int, KW: int, packed: bool) -> int:
    """Estimated peak device bytes of a rank's local steps of one class
    (`_local_sweep` up to the exchange of the elements), the slab codes and
    gids (9 B per position) included, over n2 = 2 * slab_len doubled-text
    elements of n_ops = KW (+1 unpacked) int64 rows, for any number of
    kept and deduped elements (<= n2).  The largest of, in turn:
      the slab, the words and payload, the keep mask, the kept
      positions and the compacted rows         9 L + (8 n_ops + 8 n_ops + 9) n2
      the sort of the compacted rows, input included  9 L + _sort_bytes(n2, n_ops)
      the dedupe (the sorted rows, their starts and two compare rows, the
      deduped copy) and the element-major copy for the exchange
                                                      9 L + (16 n_ops + 3) n2
    The sort bounds the other two (20 n_ops + 1 > 16 n_ops + 9 for
    n_ops >= 2).  The extraction (kernels/extract_sweep.py::doubled_elements)
    allocates only its words and payload, which the keep step's line
    holds."""
    n2 = 2 * slab_len
    n_ops = KW + (0 if packed else 1)
    return 9 * slab_len + _sort_bytes(n2, n_ops) + _ALLOCATOR_SLACK


def merge_sweep_bytes(n_recv: int, KW: int, packed: bool, sent_bytes: int) -> int:
    """Estimated device bytes of a rank's steps from the exchange of the
    elements to the scan over the n_recv elements it receives, beyond what
    it holds when the counts are in (its slab and the `sent_bytes` of rows
    it sends, freed after the exchange): the received rows (8 n_ops B
    each) beside the sent ones, then their key words and payload copied
    out beside them (16 n_ops), then the merge sort, its input included
    (_sort_bytes); the scan's tile statuses are within the sort's fixed
    bytes and the slack."""
    n_ops = KW + (0 if packed else 1)
    return (max(8 * n_ops * n_recv,
                max(16 * n_ops * n_recv, _sort_bytes(n_recv, KW, not packed)) - sent_bytes)
            + _ALLOCATOR_SLACK)


def _check_budget(need_bytes: int, budget: int, label: str, group: KvGroup) -> None:
    """check_device_budget on every rank; a rank over the budget fails
    every rank (a rank that raised alone would leave the others in their
    next collective)."""
    err = None
    try:
        check_device_budget(need_bytes, budget, label, group.device)
    except DeviceBudgetExceeded as exc:
        err = exc
    over = all_sum(torch.tensor([int(err is not None)], device=group.device))
    if int(over.item()):
        raise err or DeviceBudgetExceeded(
            f"{label}: over the device budget on {int(over.item())} other rank(s)")


def _local_sweep(group: KvGroup, codes: torch.Tensor, gids: torch.Tensor, *, ks,
                 kmax: int, KW: int, n_members: int, cs: int, chunk: int, packed: bool,
                 mode: str, mode_params, balanced: int, slack: float, budget: int,
                 label: str) -> torch.Tensor:
    """One class on this rank, from its slab's codes and member indices on
    the device (dist/occurrence.py::_make_slab_pair): the raw (doubled,
    palindromic) stats of its key ranges, int64 [2, len(ks), bins], summed
    over the group."""
    L = codes.shape[0]
    kmin = min(ks)
    fwd, payload = _doubled_elements(codes, gids, kmax, KW, packed)
    # own: windows [0, chunk) of each half; rank 0 owns its whole rc half
    # (the rc windows whose kmax-window would start before the text)
    own = torch.zeros(2 * L, dtype=torch.bool, device=group.device)
    own[:chunk] = True
    rc_end = 2 * L if group.rank == 0 else L + chunk
    own[L:rc_end] = True
    if packed:
        own &= (fwd[-1] & ((1 << PACK_NIO_BITS) - 1)) >= kmin  # useless for every k otherwise
    else:
        own &= (payload & ((1 << NIO_BITS) - 1)) >= kmin
    pos, n_keep = rank_positions(own)
    del own
    elems = torch.empty(KW + int(not packed), n_keep, dtype=torch.int64, device=group.device)
    torch.index_select(fwd, 1, pos, out=elems[:KW])
    if not packed:
        torch.index_select(payload, 0, pos, out=elems[KW])
    del fwd, payload, pos
    sp, _ = sort_words(elems)
    del elems
    # (key, gid, nio)-dedupe: the presence masks of occ, pivot_rest,
    # multi_pivot and containment ignore repeats; "buckets" sums the
    # pivot's multiplicities and keeps every element
    if mode != "buckets":
        sp = sp[:, words_starts(sp)]
    splits = _sampled_splits(sp[:KW], sp.shape[1], group.world_size, group, gid_bits=0)
    splits = _align_splits_to_prefix(splits, kmin, KW)
    shares = range_counts(sp[:KW], splits)
    rows = sp.T.contiguous()
    del sp
    recv = exchange_ranges(
        rows, shares, group, balanced, slack, f"{label} class kmax={kmax} (kmin={kmin})", log,
        before_rows=lambda m: _check_budget(merge_sweep_bytes(m, KW, packed, 8 * rows.numel()),
                                            budget, f"{label}: merge", group))
    del rows
    if packed:
        keys, pay = recv.T.contiguous(), None
    else:
        keys, pay = recv[:, :KW].T.contiguous(), recv[:, KW].contiguous()
    del recv
    sm, spay = sort_words(keys, pay)
    del keys, pay
    if mode == "occ":
        raw = scan_multi_k(sm, spay, ks, n_members, cs, packed)
    else:
        raw = scan_classify(sm, spay, ks, mode, mode_params, packed)
    del sm, spay
    return all_sum(raw)


def run_sweep_plan_raw(
    group: KvGroup,
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    cs: int,
    slack: float = 1.7,
    mode: str = "occ",
    mode_params=None,
    device_budget_bytes: int | None = None,
):
    """The sweep driver: plan the classes (engine/ksweep.py::plan_sweep,
    the 64-member mask for every mode), run each over the group and combine
    the summed raw stats (d + p) // 2 per k.  mode selects the scan: "occ"
    (exp1's occurrence histograms) or a classification mode ("pivot_rest",
    "multi_pivot", "containment", "buckets"; kernels/ksweep_scan.py).
    Returns ({k: canonical stats, int64 np.ndarray}, the ks left to the
    caller's per-k path), equal on every rank."""
    D = group.world_size
    codes, starts = _member_layout(member_codes)
    n = codes.shape[0]
    budget = device_budget_bytes or default_device_budget_bytes(group.device)
    classes, remaining = plan_sweep(ks, len(member_codes))
    chunk = max(1, math.ceil(n / D))
    out: Dict[int, np.ndarray] = {}
    for kmax, KW, cks, packed in classes:
        L = chunk + kmax - 1
        _check_budget(local_sweep_bytes(L, KW, packed), budget, f"{mode} sweep: local sweep",
                      group)
        slab_codes, slab_gids = _make_slab_pair(codes, starts, D, kmax, group.rank, group.device)
        raw = _local_sweep(
            group, slab_codes, slab_gids, ks=list(cks), kmax=kmax, KW=KW,
            n_members=len(member_codes), cs=cs, chunk=chunk, packed=packed, mode=mode,
            mode_params=mode_params, balanced=math.ceil(2 * chunk / D), slack=slack,
            budget=budget, label=f"{mode} sweep")
        canon = ((raw[0] + raw[1]) // 2).cpu().numpy()
        for i, k in enumerate(cks):
            out[k] = canon[i]
    return out, remaining


def run_sweep_plan(
    group: KvGroup,
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    cs: int,
    cx: int,
    slack: float,
    per_k_fallback,
    device_budget_bytes: int | None = None,
) -> Dict[int, List[int]]:
    """exp1's wrapper over run_sweep_plan_raw: canonical stats become
    occurrence histogram lists padded to cx; leftover ks go to
    `per_k_fallback(k)`."""
    n_members = len(member_codes)
    stats, remaining = run_sweep_plan_raw(group, member_codes, ks, cs, slack, "occ",
                                          device_budget_bytes=device_budget_bytes)
    out: Dict[int, List[int]] = {}
    m = min(n_members, cx)
    for k, cnt in stats.items():
        out[k] = cnt[:m].tolist() + [0] * (cx - m)
    for k in remaining:
        out[k] = per_k_fallback(k)
    return out


def sharded_occurrence_histograms_sweep(
    group: KvGroup,
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    cs: int = 5000,
    cx: int = 10000,
    slack: float = 1.7,
    device_budget_bytes: int | None = None,
) -> Dict[int, List[int]]:
    """Multi-rank {k: occurrence histogram} over the whole k grid, equal to
    engine.ksweep.occurrence_histograms_sweep on every rank.  Leftover ks
    (a class of < 3 ks, groups over 64 members) take the sharded per-k path
    (dist/occurrence.py)."""
    from .occurrence import sharded_occurrence_histogram

    return run_sweep_plan(
        group, member_codes, ks, cs, cx, slack,
        per_k_fallback=lambda k: sharded_occurrence_histogram(group, member_codes, k,
                                                              cs=cs, cx=cx),
        device_budget_bytes=device_budget_bytes,
    )
