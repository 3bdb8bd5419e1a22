"""Shared-sort k-sweep: every k's occurrence histogram from ONE sort
(port of khoice_tpu/engine/ksweep.py; the trick is documented there).

In short: sort the forward kmax-mers of the DOUBLED text (each member
followed by its reverse complement) once; every k <= kmax then groups
into contiguous runs of equal top-2k bits.  A segmented OR-scan of
one-hot member masks over each k-run gives the run's distinct-member
count, and since every non-palindromic canonical class appears as two
runs and a palindromic one (even k only) as one,

    hist_canonical = (hist_doubled + hist_palindromic) // 2     (exact)

Key layout.  torch has no shifts or comparisons on uint32/uint64 on the
CPU, so a sorted array is ONE contiguous int64 tensor [KW, n]: row w is
key word w (MSB-first, the kmax-mer left-aligned in KW*32 bits), each
entry a 32-bit value in [0, 2^32).  Every left shift is masked back to
32 bits and no negative value is ever right-shifted.  The payload (gid,
nio) rides in the spare low bits of the last word when they fit
(`packed`), else in a separate int64 [n] tensor.  The layout's constants,
its bit helpers and the plain multi-k scan live beside the scan kernel's
wrapper (kernels/ksweep_scan.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..kernels.ksweep_scan import (  # noqa: F401  (PACK_NIO_BITS, scan_multi_k_reference re-exported)
    MASK_MEMBERS,
    PACK_GID_BITS,
    PACK_MIN_SPARE,
    PACK_NIO_BITS,
    scan_multi_k,
    scan_multi_k_reference,
)
from ..kernels.extract import occ_words_static
from ..kernels.extract_sweep import doubled_elements, extract_fwd_sweep
from ..kernels.sort import sort_words
from ..utils import trace
from ..utils.logging import get_logger
from .occurrence import occurrence_histogram_packed, pack_members

log = get_logger("khoice.ksweep")


def _pack_spare(kmax: int, KW: int) -> int:
    return KW * 32 - 2 * kmax


def can_pack_payload(kmax: int, KW: int) -> bool:
    return _pack_spare(kmax, KW) >= PACK_MIN_SPARE


def sweep_classes(ks: Sequence[int]) -> List[tuple]:
    """Partition a k grid into shared-sort classes [(kmax, KW, ks), ...].

    One class per key-word count KW = ceil(2*kmax/32); ks needing one word
    are merged into the two-word class when one exists.
    """
    ks = sorted(set(int(k) for k in ks))
    if not ks:
        return []
    buckets: Dict[int, List[int]] = {}
    for k in ks:
        if k < 2 or k > 63:
            raise ValueError(f"k={k} outside supported sweep range [2, 63]")
        buckets.setdefault((2 * k + 31) // 32, []).append(k)
    if 1 in buckets and 2 in buckets:
        buckets[2] = buckets.pop(1) + buckets[2]
    return [
        (max(bks), (2 * max(bks) + 31) // 32, tuple(sorted(bks)))
        for _, bks in sorted(buckets.items())
    ]


def plan_sweep(ks: Sequence[int], n_members: int,
               mask_limit: int = MASK_MEMBERS):
    """Choose the sort plan: ([(kmax, KW, cks, packed)], per_k_fallback_ks).

    Costed in sorted words per text position (doubled text counts x2):
    SPLIT sorts once per key-word class with >= 3 ks (smaller classes go
    to the per-k path, which sorts occ_words_static(k) words over the
    undoubled text); MASTER sorts once at kmax = max(ks) for every k.
    The cheaper plan wins; n_members above the mask limit disables the
    sweep (every k goes to the per-k path).  Equal to
    khoice_tpu.engine.ksweep.plan_sweep at the same mask_limit; the
    default is exp1's 64 (the JAX default of 32 serves its classification
    scans).
    """
    ks = sorted(set(int(k) for k in ks))
    if n_members > mask_limit or n_members > (1 << PACK_GID_BITS):
        return [], ks
    if len(ks) < 3:
        return [], ks

    split_classes = []
    split_rest: List[int] = []
    split_cost = 0.0
    for kmax, KW, cks in sweep_classes(ks):
        if len(cks) < 3:
            split_rest.extend(cks)
            split_cost += sum(occ_words_static(k) for k in cks)
        else:
            packed = can_pack_payload(kmax, KW)
            split_classes.append((kmax, KW, cks, packed))
            split_cost += 2 * (KW if packed else KW + 1)

    kmax_m = max(ks)
    KW_m = (2 * kmax_m + 31) // 32
    packed_m = can_pack_payload(kmax_m, KW_m)
    master_cost = 2 * (KW_m if packed_m else KW_m + 1)

    if master_cost < split_cost:
        return [(kmax_m, KW_m, tuple(ks), packed_m)], []
    return split_classes, split_rest


# The sweep's extraction (kernels/extract_sweep.py: the CUDA kernel on the
# card, its plain version on the CPU) under this module's names, which
# the streaming sweep, the sharded sweep and the tools call.
_extract_fwd_sweep = extract_fwd_sweep
_doubled_elements = doubled_elements


def _sweep_doubled(codes: torch.Tensor, gids: torch.Tensor, kmax: int,
                   KW: int, packed: bool):
    """The doubled text's elements as ONE sorted array: (int64 [KW, n2]
    words, payload or None)."""
    return sort_words(*doubled_elements(codes, gids, kmax, KW, packed))


def sweep_class_hists(codes: torch.Tensor, gids: torch.Tensor, n_members: int, kmax: int,
                      KW: int, cks: Sequence[int], packed: bool, cs: int = 5000,
                      cx: int = 10000) -> Dict[int, List[int]]:
    """{k: occurrence histogram} of one class of plan_sweep's plan: ONE sort
    of the doubled text and ONE scan serve all of its ks (the JAX package's
    `_sweep_class_fn`)."""
    with trace.span("engine:sweep_class"):
        skeys, spay = _sweep_doubled(codes, gids, kmax, KW, packed)
        raw = scan_multi_k(skeys, spay, cks, n_members, cs, packed)
        del skeys, spay
        with trace.span("engine:readback"):
            hists = ((raw[0] + raw[1]) // 2).cpu().tolist()
            top = min(n_members, cx)
            return {k: hists[i][:top] + [0] * (cx - top) for i, k in enumerate(cks)}


def occurrence_histograms_sweep_packed(
    packed,
    n_members: int,
    ks: Sequence[int],
    cs: int = 5000,
    cx: int = 10000,
) -> Dict[int, List[int]]:
    """{k: exp1 occurrence histogram (list of cx ints)} for every k in `ks`
    over packed (codes, gids) tensors (see occurrence.pack_members); runs
    on their device.

    Runs the plan of plan_sweep; the ks it leaves over (a class with < 3
    ks, or every k of a group over the 64-member mask) take the per-k
    fused path, one sort per k (occurrence.occurrence_histogram_packed),
    as the JAX package's sweep does."""
    with trace.span("engine:sweep"):
        codes, gids = packed
        classes, remaining = plan_sweep(ks, n_members)
        if n_members > MASK_MEMBERS and len(remaining) >= 3:
            log.warning(
                "shared-sort sweep disabled: %d members > %d (scan mask width); "
                "falling back to %d per-k fused sorts — expect ~%dx the sweep's "
                "sort volume for this group",
                n_members, MASK_MEMBERS, len(remaining), len(remaining),
            )
        out: Dict[int, List[int]] = {}
        for kmax, KW, cks, pay_packed in classes:
            out.update(sweep_class_hists(codes, gids, n_members, kmax, KW, cks, pay_packed, cs,
                                         cx))
        for k in remaining:
            out[k] = occurrence_histogram_packed(packed, n_members, k, cs=cs, cx=cx)
        return out


def occurrence_histograms_sweep(
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    device,
    cs: int = 5000,
    cx: int = 10000,
) -> Dict[int, List[int]]:
    """Sweep API over raw member code arrays (packs and uploads once)."""
    return occurrence_histograms_sweep_packed(
        pack_members(member_codes, device), len(member_codes), ks, cs=cs, cx=cx
    )
