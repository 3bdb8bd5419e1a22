"""Device memory budget of the sweeps and the per-k path, and exp1's
bounded-memory streaming sweep (port of khoice_tpu/engine/streaming.py).

KMC counts any input on a fixed memory budget (`kmc -fm -m64`, reference
workflow/rules/exp_type_1.smk:163).  exp1 sends a group whose in-core
sweep would not fit the device budget (`incore_sweep_bytes`) to
`occurrence_histograms_sweep_streaming`, which runs the SAME sweep chunk
by chunk:

- the doubled text's codes (1 B per position) stay resident on the
  device; only the sort structures are big, and those are built per chunk;
- k-mer space is split into G top-word key ranges ALIGNED to 2*kmin-bit
  prefixes, so no k-run of any swept k tears across two groups;
- per pass, for each text chunk: extract its elements plus a kmax-1 halo,
  sentinel-encode the invalid and halo ones, sort them with the radix
  sort kernel, and copy each in-range group's elements (a contiguous
  slice of the sorted chunk, found with searchsorted) into that group's
  buffer at the chunk's slot;
- per group: sort the buffer and run the multi-k scan in RAW (doubled,
  palindromic) form; the raw histograms add over the groups and are
  halved at the end (a canonical class's two strand runs can land in
  different key ranges);
- a group whose buffer overflows its cap (key-space skew beyond `_SLACK`)
  is re-queued alone with a doubled cap; groups that finished keep their
  scans and are never extracted or sorted again.

Peak device memory ~= resident codes + one pass's group buffers + the
larger of one chunk's sort and one group's sort (`_stream_plan`),
whatever the input size.  Results equal the in-core sweep's.  The
classification sweeps have no streaming path (nor in the JAX package):
there a group over budget raises DeviceBudgetExceeded.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..kernels.extract import occ_words_static
from ..kernels.sort import sort_words
from ..utils.logging import get_logger
from .bits import SENTINEL, key_words
from .ksweep import (
    PACK_GID_BITS,
    PACK_NIO_BITS,
    _extract_fwd_sweep,
    plan_sweep,
    scan_multi_k,
)
from .occurrence import gid_packable, occurrence_histogram_packed, pack_members

log = get_logger("khoice.streaming")

# Peak device bytes of one radix sort (kernels/sort.py::_launch) of n
# elements with W = key words (+1 for a payload) int64 rows in and out
# and records of R = key words (+2 for a payload) uint32 words:
#   the input rows, alive through the sort          8 W per element
#   the first pass's records `rec`                  4 R
#   the middle passes' second copy                  4 R  (both live)
#   the status, 256 x 8 B per tile of >= 2048       <= 1
#   the last pass's output (the copy it does not    8 W  (one copy left)
#   read is freed before it is allocated)
# The middle passes hold 8 W + 8 R + 1 and the last 8 W + 4 R + 8 W + 1,
# at least as much (R <= 2 W), so the peak is n * (16 W + 4 R + 1) bytes plus
# _SORT_FIXED_BYTES (the statistics, <= 41 KB at W = 5, a partial tile's
# status, the pass counters): 20 B per key word, 24 B for a payload, +1.
# A packed 4-word class sort takes 81 B per element.  What lives beside
# the sort is the caller's: `_RESIDENT_BYTES`, the per-k layouts' keys.
_SORT_FIXED_BYTES = 1 << 16

# pack_members' codes (uint8) and gids (int64) of the group, resident on
# the device through its sorts: bytes per text position
_RESIDENT_BYTES = 9

# The caching allocator counts a cached block whole when the rest would
# be under 1 MiB; a few such blocks ride every peak.
_ALLOCATOR_SLACK = 8 << 20

# the smallest chunk the streaming sweep cuts, whatever the budget
_MIN_CHUNK = 1 << 12

# a group buffer's slot per chunk holds this many times the chunk's
# elements over the groups (room for key-space skew before a retry)
_SLACK = 1.7


class DeviceBudgetExceeded(RuntimeError):
    """A group's sweep needs more device memory than the budget."""


def default_device_budget_bytes(device) -> int:
    """~85% of the CUDA device's memory (the rest covers the resident
    codes, the allocator's slack and the outputs); 64 GB, KMC's own
    `-m64`, for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total * 0.85)
    return 64 << 30


def _sort_bytes(n_elems: int, key_words: int, payload: bool = False) -> int:
    """Peak device bytes of one radix sort of n_elems elements of
    `key_words` int64 key rows (and an int64 payload), its input and
    output included (the derivation above)."""
    W = key_words + int(payload)
    R = key_words + 2 * int(payload)
    return n_elems * (16 * W + 4 * R + 1) + _SORT_FIXED_BYTES


def incore_sweep_bytes(total_positions: int, ks: Sequence[int], n_members: int) -> int:
    """Estimated peak device bytes of the port's in-core sweep over a
    group whose packed text (members + separators) spans `total_positions`:
    the largest class sort over n2 = 2 * total_positions elements beside
    the group's resident codes and gids (the doubled text's extraction
    allocates only its words and payload, the sort's input)."""
    classes, _rest = plan_sweep(ks, n_members)
    n2 = 2 * total_positions
    worst = 0
    for _kmax, KW, _cks, packed in classes:
        worst = max(worst, _sort_bytes(n2, KW, not packed))
    if not worst:
        return 0
    return worst + _RESIDENT_BYTES * total_positions + _ALLOCATOR_SLACK


def perk_bytes(total_positions: int, ks: Sequence[int], n_members: int) -> int:
    """Estimated peak device bytes of the per-k fused path over a group
    whose packed text spans `total_positions`: its largest per-k sort
    (engine/occurrence.py::_sorted_pairs) beside the resident codes and
    gids, 0 for no ks.  Packed, the extraction's words are the sort's
    input; with the gid apart, the canonical keys, their validity and the
    gid row stay beside the sort of their concatenation."""
    worst = 0
    for k in ks:
        if gid_packable(n_members, k):
            need = _sort_bytes(total_positions, occ_words_static(k))
        else:
            wk = key_words(k)
            need = _sort_bytes(total_positions, wk + 1) + total_positions * (8 * wk + 9)
        worst = max(worst, need)
    if not worst:
        return 0
    return worst + _RESIDENT_BYTES * total_positions + _ALLOCATOR_SLACK


def occurrence_table_bytes(total_positions: int, k: int, n_members: int) -> int:
    """Estimated peak device bytes of occurrence_table after its sort
    (engine/occurrence.py, kernels/occ_scan.py::run_occurrences) over
    n = total_positions elements sorted into S bytes (the W gathered rows,
    and the gid row when the gid is apart), for any number R <= n of key
    runs; the codes and gids are freed after the sort.  Beside S, in turn:
      the key and pair starts (2 n) and the compares' temporaries: a
      bool row, or packed the last rows' XOR and its compare (9 n)   11 n
      the pair starts, the run starts and the running count C        n + 8 R + c n
      C, the starts, occ and C at each start with its difference    c n + 24 R
      the starts, occ and the gathered rows                          16 R + 8 W R
    with c = 4 (int32 C) below 2^31 elements.  After the gather S is
    freed; the packed rows are unpacked in place (a row's temporary) and
    then, at k 32-44, copied into the keys' four words:
      occ, the gathered rows and a row, or the keys        8 R + 8 W R + 8 max(1, wk) R
    R = n bounds them, and c + 24 is the largest of the first three."""
    n = total_positions
    wk = key_words(k)
    if gid_packable(n_members, k):
        W, S = occ_words_static(k), 8 * occ_words_static(k) * n
    else:
        W, S = wk, 8 * (wk + 1) * n
    c = 4 if n < 2**31 else 8
    return max(S + n * max(c + 24, 16 + 8 * W), 8 * n * (1 + W + wk)) + _ALLOCATOR_SLACK


def count_bytes(n_codes: int, k: int) -> int:
    """Estimated peak device bytes of counting the k-mers of `n_codes`
    codes (engine/ops.py::count_codes), the codes (1 B each) resident
    throughout, for any number of valid keys nv <= n and runs R <= nv:
      the canonical keys and validity, the mask's index (8 B) and the
      compacted keys                                   (8 wk + 1) n + (8 + 8 wk) nv
      the sort of the compacted keys (the rest freed)   _sort_bytes(nv, wk)
      the sorted keys, a run-start flag and a compare
      (2 nv), or the run starts, the lengths with their
      temporary, and the gathered keys               8 wk nv + 16 R + 8 wk R
    nv = R = n bounds them, and the last line bounds the first."""
    wk = key_words(k)
    n = n_codes
    return n + max(_sort_bytes(n, wk), n * (16 * wk + 16)) + _ALLOCATOR_SLACK


def table_merge_bytes(n_keys: int, n_words: int) -> int:
    """Estimated device bytes of a table op (engine/ops.py: union_many,
    _merge_two) over `n_keys` keys of `n_words` words beside its input
    tables: the sort of their concatenation with the counts or indices
    as its payload; what follows the sort (the run sums, the gathers)
    holds less."""
    return _sort_bytes(n_keys, n_words, True) + _ALLOCATOR_SLACK


def annotation_bytes(n_keys: int, n_words: int) -> int:
    """Estimated device bytes of classify/annotate.py::build_annotation
    over `n_keys` keys beside its input tables: a table op's sort (an
    index payload) with each key's source and count beside it, or what
    follows it, whichever holds more: the sorted keys and the
    concatenation the sort read, alive as it returns (16 B per word), the
    order, sources and counts gathered (and their old copies), the run
    ids and the member bits (66 B per key)."""
    return max(table_merge_bytes(n_keys, n_words) + 16 * n_keys,
               (16 * n_words + 66) * n_keys + _ALLOCATOR_SLACK)


def vote_bytes(n_text: int, n_query: int, n_words: int) -> int:
    """Estimated device bytes of one k's merge-join vote
    (classify/annotate.py::read_votes_bulk_multi) over n = n_text +
    n_query elements of W = `n_words` key words, beside the resident group
    texts and reads.  In turn, with the concatenated words and payload
    (8 (W + 1) n) alive until the sort:
      a side's extraction: its keys and validity, and the payload step's
      negated validity (the texts: 8 W + 2 per element)     8 (W + 1) n + (8 W + 2) n_text
      the sort, its input and output included, beside the
      queries' validity                                     _sort_bytes(n, W, True) + n_query
      the masks: the sorted words and payload, the masks, the
      tile statuses (<= n / 256) and the validity            8 (W + 1) n + n / 256 + 9 n_query
      the votes: the masks, the validity, the row starts and
      the per-read outputs (R <= n_query rows, D <= 32)      9 n_query + 8 (R + 1) + 8 (D + 2) R
    The sort's line bounds the first three (16 (W + 1) + 4 (W + 2) + 1 >
    8 (W + 1) + 8 W + 2); the last is at most 8 + 289 n_query."""
    n = n_text + n_query
    return max(_sort_bytes(n, n_words, True) + n_query, 8 + 289 * n_query) + _ALLOCATOR_SLACK


def resident_bytes(device) -> int:
    """Device bytes the run holds now (tensors allocated on a CUDA
    device); 0 for the CPU."""
    if device is None or torch.device(device).type != "cuda":
        return 0
    return torch.cuda.memory_allocated(device)


def check_device_budget(need_bytes: int, budget_bytes: int, label: str, device=None) -> None:
    """Raise DeviceBudgetExceeded when `need_bytes` would not fit beside
    what the run already holds on `device`."""
    held = resident_bytes(device)
    if need_bytes + held > budget_bytes:
        raise DeviceBudgetExceeded(
            f"{label}: needs ~{need_bytes / 2**30:.1f} GiB of device memory beside "
            f"{held / 2**30:.1f} GiB held, over the device budget of "
            f"{budget_bytes / 2**30:.1f} GiB; only exp1's shared-sort "
            "classes stream under a budget (the per-k sorts and the classification "
            "sweeps run in-core)"
        )


def check_incore_budget(total_positions: int, ks: Sequence[int], n_members: int,
                        budget_bytes: int, label: str, device=None) -> None:
    """Raise DeviceBudgetExceeded when the group's plan (its class sorts
    and the per-k sorts of the ks it leaves over) would not fit."""
    _classes, remaining = plan_sweep(ks, n_members)
    need = max(incore_sweep_bytes(total_positions, ks, n_members),
               perk_bytes(total_positions, remaining, n_members))
    check_device_budget(need, budget_bytes, label, device)


def sentinel_encode_packed(fwd: torch.Tensor, KW: int, nio_bits: int, gid_bits: int):
    """Copied from khoice_tpu/engine/fastsort.py::sentinel_encode_packed,
    on the port's int64 [KW, n] words.

    Re-encode invalid packed elements (nio == 0) to the dominant
    sentinel: all-ones key words, ZERO payload bits in the last word.
    The sentinel sorts strictly after EVERY real element: the last word's
    spare-above-payload bits (>= 2 of them, since packing requires spare
    >= PACK_MIN_SPARE = 14 > the 12 payload bits) are ones in the sentinel
    but zero in every real element.  The occurrence scans are unaffected
    (the sentinel's nio bits stay 0).  Returns (encoded, invalid_mask)."""
    invalid = (fwd[-1] & ((1 << nio_bits) - 1)) == 0
    sent = _sentinel_column(KW, fwd.device, nio_bits, gid_bits)
    return torch.where(invalid, sent, fwd), invalid


def _sentinel_column(KW: int, device, nio_bits: int = PACK_NIO_BITS,
                     gid_bits: int = PACK_GID_BITS) -> torch.Tensor:
    """int64 [KW, 1]: the packed sentinel, all ones but the last word's
    nio_bits + gid_bits payload bits."""
    col = torch.full((KW, 1), SENTINEL, dtype=torch.int64, device=device)
    col[KW - 1] = SENTINEL & ~((1 << (nio_bits + gid_bits)) - 1)
    return col


def _group_splits(G: int, kmin: int) -> np.ndarray:
    """G+1 ascending top-word split values aligned to 2*kmin-bit prefixes
    (alignment caps the usable granularity at 4^kmin prefixes)."""
    bits = min(2 * kmin, 32)
    keep = np.uint64(0xFFFFFFFF) << np.uint64(32 - bits)
    raw = (np.arange(G + 1, dtype=np.uint64) << np.uint64(32)) // np.uint64(G)
    lo = np.minimum(raw, 0xFFFFFFFF).astype(np.uint64) & keep
    lo[-1] = 0xFFFFFFFF  # last group closes at the top (inclusive w0)
    return lo.astype(np.int64)


def _stream_plan(total: int, KW: int, H: int, kmin: int, budget: int,
                 chunk_elems: int | None = None, n_groups: int | None = None,
                 pass_groups: int | None = None):
    """(C chunk elements, n_chunks, G groups, cap per chunk slot, R groups
    per pass) of a packed class over `total` doubled elements.

    The JAX package sizes these in 4-byte words; the port's words are 8
    bytes and its sorts need `_sort_bytes`.  Of the budget left over by
    the resident codes, a quarter bounds one chunk's sort, a quarter one
    group's sort beside its buffer, and a half one pass's group buffers,
    so `_stream_peak_bytes` stays within the budget.  Overrides (the
    tests force them) are taken as given."""
    quarter = _free_quarter(budget, total, H)
    per_elem = _sort_bytes(1, KW) - _SORT_FIXED_BYTES
    C = chunk_elems or max(1, min(total, max(_MIN_CHUNK, quarter // per_elem - H)))
    n_chunks = math.ceil(total / C)
    G = n_groups or max(1, math.ceil(_SLACK * n_chunks * C * per_elem / max(quarter, 1)))
    G = min(G, 1 << min(2 * kmin, 32))
    cap = max(1, int(_SLACK * C / G))
    R = pass_groups or _pass_groups(G, n_chunks * cap, KW, quarter)
    return C, n_chunks, G, cap, R


def _free_quarter(budget: int, total: int, H: int) -> int:
    """A quarter of the budget left over by the resident doubled codes."""
    return max(budget - (total + H), 4) // 4


def _pass_groups(G: int, group_elems: int, KW: int, quarter: int) -> int:
    """Groups per pass whose buffers fit half the free budget."""
    return max(1, min(G, (2 * quarter) // (group_elems * 8 * KW)))


def _stream_peak_bytes(total: int, KW: int, H: int, C: int, n_chunks: int, cap: int,
                       R: int) -> int:
    """Estimated peak device bytes of a streamed class: resident codes,
    R group buffers, and the larger of a chunk's sort and a group's sort
    (whose input is one of the buffers)."""
    group = n_chunks * cap
    return (n_chunks * C + H + R * group * 8 * KW
            + max(_sort_bytes(C + H, KW), _sort_bytes(group, KW) - group * 8 * KW))


def _doubled_codes(member_codes: Sequence[np.ndarray], C: int, H: int):
    """Host-side doubled text (codes ++ revcomp) padded to a multiple of
    the chunk size plus the halo, plus member start offsets for gid
    rebuild: (codes uint8, starts int64, n, n_chunks)."""
    parts, starts = [], [0]
    for codes in member_codes:
        parts.append(np.asarray(codes, np.uint8))
        parts.append(np.full(1, 4, np.uint8))
        starts.append(starts[-1] + parts[-2].shape[0] + 1)
    codes = np.concatenate(parts)
    n = codes.shape[0]
    rc = np.where(codes < 4, codes ^ 3, codes)[::-1]
    n_chunks = math.ceil(2 * n / C)
    pad = n_chunks * C - 2 * n + H
    d = np.concatenate([codes, rc, np.full(pad, 4, np.uint8)])
    return d, np.asarray(starts[:-1], np.int64), n, n_chunks


def _chunk_step(d_codes: torch.Tensor, member_starts: torch.Tensor, bufs: list, n: int,
                c: int, C: int, H: int, kmax: int, KW: int, cap: int,
                lo: torch.Tensor, hi: torch.Tensor) -> List[int]:
    """Extract + sort chunk c of the doubled text and copy each group's
    in-range elements into its buffer at the chunk's slot.

    bufs: R int64 [KW, n_chunks * cap] buffers (None for a group that has
    already overflowed), updated in place (the JAX package returns new
    buffers; its note on donation does not apply to torch); lo/hi: int64
    [R] inclusive top-word ranges.  Returns each group's in-range count
    (a count above cap means the group overflowed; nothing is copied)."""
    dev = d_codes.device
    start = c * C
    pos = start + torch.arange(C + H, dtype=torch.int64, device=dev)
    # n = true text length (the doubled region is [0, 2n); anything past
    # it is chunk-alignment padding, code 4 -> invalid -> dropped)
    orig = torch.where(pos < n, pos, 2 * n - 1 - pos).clamp(0, n - 1)
    gids = torch.searchsorted(member_starts, orig, right=True) - 1
    del pos, orig
    fwd, _ = _extract_fwd_sweep(d_codes[start:start + C + H], gids, kmax, KW, True)
    del gids
    # the halo's elements belong to the next chunk: a zero nio makes them
    # sentinels, as the invalid ones
    fwd[KW - 1, C:] &= ~((1 << PACK_NIO_BITS) - 1)
    elems, _ = sentinel_encode_packed(fwd, KW, PACK_NIO_BITS, PACK_GID_BITS)
    del fwd
    s, _ = sort_words(elems)
    del elems

    i0 = torch.searchsorted(s[0], lo)
    i1 = torch.searchsorted(s[0], hi, right=True)
    # sentinels share w0 = 0xFFFFFFFF with the last group's hi: exclude
    # them by their last word (payload bits zero, > any real element)
    sent_like = (s[KW - 1] & ((1 << PACK_NIO_BITS) - 1)) == 0
    n_sent_like = torch.stack([(sent_like & (s[0] >= lo[r]) & (s[0] <= hi[r])).sum()
                               for r in range(lo.shape[0])])
    firsts = i0.tolist()
    counts = (i1 - i0 - n_sent_like).tolist()
    for buf, first, cnt in zip(bufs, firsts, counts):
        if buf is not None and cnt <= cap:
            buf[:, c * cap:c * cap + cnt] = s[:, first:first + cnt]
    return counts


def _group_scan(buf: torch.Tensor, ks: Sequence[int], n_members: int, cs: int) -> torch.Tensor:
    """Sort one group buffer and return its RAW (2, n_ks, n_members)."""
    s, _ = sort_words(buf)
    return scan_multi_k(s, None, ks, n_members, cs, True)


def occurrence_histograms_sweep_streaming(
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    device,
    cs: int = 5000,
    cx: int = 10000,
    device_budget_bytes: int = 8 << 30,
    chunk_elems: int | None = None,
    n_groups: int | None = None,
    pass_groups: int | None = None,
) -> Dict[int, List[int]]:
    """{k: exp1 occurrence histogram} under a device memory budget, on
    `device`.

    Equal to engine/ksweep.occurrence_histograms_sweep; use when the group
    is too large for the in-core doubled-text sort.  Only packed classes
    stream (any grid with >= 3 ks packs); the ks left over take the per-k
    fused path, whose sorts must fit the budget (`perk_bytes`)."""
    device = torch.device(device)
    n_members = len(member_codes)
    if n_members > (1 << PACK_GID_BITS):
        raise ValueError(f"packed gid field is {PACK_GID_BITS} bits")
    classes, remaining = plan_sweep(ks, n_members)
    positions = sum(int(np.asarray(m).shape[0]) + 1 for m in member_codes)
    total = 2 * positions
    out: Dict[int, List[int]] = {}

    for kmax, KW, cks, packed in classes:
        if not packed:
            remaining = sorted(set(remaining) | set(cks))
            continue
        H = kmax - 1
        kmin = min(cks)
        C, n_chunks, G, cap, R = _stream_plan(total, KW, H, kmin, device_budget_bytes,
                                              chunk_elems, n_groups, pass_groups)
        splits = _group_splits(G, kmin)
        d, starts, n, n_chunks = _doubled_codes(member_codes, C, H)
        log.info(
            "streaming class kmax=%d: %d chunks x %d elems, %d key-range groups "
            "(cap %d per chunk, %d per pass), resident codes %.1f MB, estimated peak "
            "%.2f GiB of a %.2f GiB budget",
            kmax, n_chunks, C, G, cap, R, d.nbytes / 1e6,
            _stream_peak_bytes(total, KW, H, C, n_chunks, cap, R) / 2**30,
            device_budget_bytes / 2**30,
        )
        d_codes = torch.from_numpy(d).to(device)
        member_starts = torch.from_numpy(starts).to(device)
        sent = _sentinel_column(KW, device)

        # Overflow recovery is CONTAINED: a key-range group whose buffer
        # cap overflows (key-space skew, e.g. long poly-A) is re-queued
        # alone with a doubled cap; groups that finished keep their
        # accumulated raw scans and are never re-extracted or re-sorted.
        dp = torch.zeros((2, len(cks), n_members), dtype=torch.int64, device=device)
        todo = list(range(G))
        round_cap, r_round = cap, R
        passes = chunk_sorts = retries = 0
        while todo:
            overflowed: List[int] = []
            for b0 in range(0, len(todo), r_round):
                batch = todo[b0:b0 + r_round]
                lo = torch.tensor([int(splits[g]) for g in batch], dtype=torch.int64,
                                  device=device)
                hi = torch.tensor([0xFFFFFFFF if g == G - 1 else int(splits[g + 1]) - 1
                                   for g in batch], dtype=torch.int64, device=device)
                bufs = [sent.expand(KW, n_chunks * round_cap).clone() for _ in batch]
                passes += 1
                for c in range(n_chunks):
                    counts = _chunk_step(d_codes, member_starts, bufs, n, c, C, H, kmax, KW,
                                         round_cap, lo, hi)
                    chunk_sorts += 1
                    for r, cnt in enumerate(counts):
                        if cnt > round_cap:
                            bufs[r] = None
                    if all(buf is None for buf in bufs):
                        break  # every group in the batch must retry anyway
                for r, g in enumerate(batch):
                    if bufs[r] is None:
                        overflowed.append(g)
                        continue
                    dp += _group_scan(bufs[r], cks, n_members, cs)
                    bufs[r] = None
            todo = overflowed
            if todo:
                retries += 1
                round_cap *= 2
                r_round = pass_groups or _pass_groups(
                    G, n_chunks * round_cap, KW, _free_quarter(device_budget_bytes, total, H))
                log.warning(
                    "streaming class kmax=%d: %d/%d key-range groups overflowed their "
                    "cap (skewed key space at kmin=%d granularity); retrying ONLY those "
                    "with cap %d, %d per pass",
                    kmax, len(todo), G, kmin, round_cap, r_round,
                )
        log.info("streaming class kmax=%d done: %d passes, %d chunk sorts, %d group "
                 "scans, %d retry rounds", kmax, passes, chunk_sorts, G, retries)

        hists = ((dp[0] + dp[1]) // 2).cpu().tolist()
        m = min(n_members, cx)
        for i, k in enumerate(cks):
            out[k] = hists[i][:m] + [0] * (cx - m)

    if remaining:
        # Leftover ks (classes with < 3 ks never pack; empty for any real
        # grid) ride the per-k fused path, over the undoubled text.
        check_device_budget(perk_bytes(positions, remaining, n_members), device_budget_bytes,
                            "the per-k sorts of a streamed group's leftover ks", device)
        packed_arrs = pack_members(member_codes, device)
        for k in remaining:
            out[k] = occurrence_histogram_packed(packed_arrs, n_members, k, cs=cs, cx=cx)
    return out
