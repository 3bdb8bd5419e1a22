"""The multi-k scan: the wrappers of its CUDA kernel (csrc/ksweep_scan.cu)
and its plain PyTorch versions.

Port of khoice_tpu/kernels/ksweep_scan_pallas.py in all its modes.
`scan_multi_k` is exp1's "occ" mode and returns the raw int64
[2, len(ks), n_members] (doubled, palindromic) histograms;
`scan_classify` is the classification modes of exp2/3/4 (pivot_rest,
multi_pivot, containment, buckets) and returns their raw int64
[2, len(ks), bins] stats.  For a CUDA tensor each launches the
hand-written kernel on the current stream, or raises; for a CPU tensor
it runs its plain version (`scan_multi_k_reference`,
`scan_classify_reference`).  Kernel launches are counted per mode in
`launches`.

Key layout (shared with engine/ksweep.py, which builds the sorted
arrays): one contiguous int64 tensor [KW, n] of 32-bit key words, MSB
first, the kmax-mer left-aligned in KW*32 bits.  The payload (gid, nio)
rides in the spare low bits of the last word when they fit (`packed`),
else in a separate int64 [n] tensor.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

GID_BITS = 8  # unpacked payload: (gid << NIO_BITS) | nio
NIO_BITS = 8

# Packed payload: (gid << PACK_NIO_BITS) | nio in the last key word's
# spare low bits.  spare >= PACK_MIN_SPARE keeps the 12 payload bits and
# two guard bits clear of every per-k comparison (see the JAX package's
# engine/ksweep.py).
PACK_GID_BITS = 6
PACK_NIO_BITS = 6
PACK_MIN_SPARE = 14

# Members of one scan: one 64-bit mask per k in the kernel, the JAX
# package's own limit for exp1's occurrence scans (MASK_MEMBERS_XLA).
MASK_MEMBERS = 64

_U32 = 0xFFFFFFFF

CLASSIFY_MODES = ("pivot_rest", "multi_pivot", "containment", "buckets")
MODES = ("occ",) + CLASSIFY_MODES  # in the order of the kernel's Mode ids

# kernel launches per mode since the last reset (one per launch of the
# CUDA entry point; CPU calls of the plain version do not count)
launches = {mode: 0 for mode in MODES}


def _rev2comp_words(words: torch.Tensor) -> torch.Tensor:
    """Reverse the 2-bit groups of the complemented KW*32-bit value.

    With the key left-aligned, the LOW 2k bits of the result read
    MSB-first are the reverse complement of the k-prefix, for every k at
    once.  words: int64 [KW, n]; returns int64 [KW, n]."""
    x = (~words.flip(0)) & _U32
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x & 0xFFFF) << 16) | (x >> 16)


def _key_new_mask(skeys: torch.Tensor, prev: torch.Tensor, k: int, KW: int):
    """True where the top 2k bits differ from the previous element."""
    shift = KW * 32 - 2 * k  # key bits for k live at positions >= shift
    neq = torch.zeros(skeys.shape[1], dtype=torch.bool, device=skeys.device)
    for i in range(KW):
        lo_bit = (KW - 1 - i) * 32  # bit position of word i's LSB
        if lo_bit >= shift:
            neq |= skeys[i] != prev[i]
        elif lo_bit + 32 > shift:
            s = shift - lo_bit
            neq |= (skeys[i] >> s) != (prev[i] >> s)
    return neq


def _pal_mask(skeys: torch.Tensor, rev: torch.Tensor, k: int, KW: int):
    """True where the k-prefix equals its own reverse complement."""
    shift = KW * 32 - 2 * k
    wshift, bshift = divmod(shift, 32)
    eq = torch.ones(skeys.shape[1], dtype=torch.bool, device=skeys.device)
    for i in range(KW):
        # word i of (key >> shift), taken from the words above
        src = i - wshift
        lhs = torch.zeros_like(skeys[0])
        if src >= 0:
            lhs = skeys[src] >> bshift
            if bshift > 0 and src - 1 >= 0:
                lhs = lhs | ((skeys[src - 1] << (32 - bshift)) & _U32)
        # word i of rev masked to its low 2k bits, lhs masked alike
        lo_bit = (KW - 1 - i) * 32
        if lo_bit >= 2 * k:
            rhs = torch.zeros_like(rev[i])
            lhs = torch.zeros_like(lhs)
        elif lo_bit + 32 <= 2 * k:
            rhs = rev[i]
        else:
            low = (1 << (2 * k - lo_bit)) - 1
            rhs = rev[i] & low
            lhs = lhs & low
        eq &= lhs == rhs
    return eq


def _gid_nio(words: torch.Tensor, payload: torch.Tensor | None, packed: bool):
    if packed:
        last = words[-1]
        return (last >> PACK_NIO_BITS) & ((1 << PACK_GID_BITS) - 1), last & ((1 << PACK_NIO_BITS) - 1)
    return (payload >> NIO_BITS) & ((1 << GID_BITS) - 1), payload & ((1 << NIO_BITS) - 1)


def _runs(words: torch.Tensor, prev: torch.Tensor, k: int):
    """(run id of every element, number of runs, run_end mask) of the
    k-runs (equal top-2k key bits) of a sorted array."""
    key_new = _key_new_mask(words, prev, k, words.shape[0])
    key_new[0] = True
    run_id = torch.cumsum(key_new, 0) - 1
    run_end = torch.ones_like(key_new)
    run_end[:-1] = key_new[1:]
    return run_id, int(run_id[-1]) + 1, run_end


def _presence(run_id, n_runs, gid, nio, k) -> torch.Tensor:
    """Dense bool [runs, 64] table: member g has an element with nio >= k
    in the run."""
    sel = (nio >= k) & (gid < MASK_MEMBERS)
    present = torch.zeros(n_runs * MASK_MEMBERS, dtype=torch.bool, device=run_id.device)
    present[run_id[sel] * MASK_MEMBERS + gid[sel]] = True
    return present.view(n_runs, MASK_MEMBERS)


def scan_multi_k_reference(words: torch.Tensor, payload: torch.Tensor | None,
                           ks: Sequence[int], n_members: int, cs: int,
                           packed: bool) -> torch.Tensor:
    """Plain-torch multi-k occurrence scan over one sorted array.

    Returns int64 [2, len(ks), n_members]: the doubled and palindromic
    histograms (bin b-1 = #runs with min(distinct members, cs) == b), the
    semantics of khoice_tpu's `_scan_multi_k_xla(..., raw=True)`.

    Written independently of the kernel: each k-run gets an id
    (cumsum of run starts), the (run, gid) pairs of elements with
    nio >= k mark a dense [runs, 64] presence table, and its row sums are
    the distinct-member counts."""
    if not 1 <= n_members <= MASK_MEMBERS:
        raise ValueError(f"n_members={n_members} outside [1, {MASK_MEMBERS}]")
    KW, n = words.shape
    dev = words.device
    out = torch.zeros(2, len(ks), n_members, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    gid, nio = _gid_nio(words, payload, packed)
    prev = torch.roll(words, 1, dims=1)
    rev = _rev2comp_words(words)
    for i, k in enumerate(ks):
        run_id, n_runs, run_end = _runs(words, prev, k)
        b = _presence(run_id, n_runs, gid, nio, k).sum(1).clamp(max=cs)
        out[0, i] = torch.bincount(b, minlength=n_members + 1)[1:n_members + 1]
        if k % 2 == 0:
            pal = _pal_mask(words, rev, k, KW)[run_end]  # one flag per run
            out[1, i] = torch.bincount(b[pal], minlength=n_members + 1)[1:n_members + 1]
    return out


def classify_mode_layout(mode: str, mode_params) -> tuple:
    """(members the mode's mask reads, bins per k) of a classification mode.

    pivot_rest: mode_params = n_rest (pivot bit 0, rest bits 1..n_rest);
    multi_pivot: D (pivot bits 0..D-1, group bits D..2D-1);
    containment: (nq, ng) (query bits 0..nq-1, group bits nq..nq+ng-1);
    buckets: (D, cap) (pivot bit 0, group bits 1..D; cap the per-run
    pivot-count saturation).  The bins equal the JAX package's
    engine/ksweep_classify.py::classify_mode_bins."""
    if mode == "pivot_rest":
        n_rest = int(mode_params)
        members, bins, ok = n_rest + 1, n_rest + 1, n_rest >= 0
    elif mode == "multi_pivot":
        D = int(mode_params)
        members, bins, ok = 2 * D, D * D, D >= 1
    elif mode == "containment":
        nq, ng = (int(x) for x in mode_params)
        members, bins, ok = nq + ng, nq * (ng + 1), nq >= 1 and ng >= 0
    elif mode == "buckets":
        D, cap = (int(x) for x in mode_params)
        members, bins, ok = D + 1, D * D + 1, D >= 1 and cap >= 0
    else:
        raise ValueError(f"unknown classify mode {mode!r}")
    if not ok or members > MASK_MEMBERS:
        raise ValueError(f"{mode} parameters {mode_params!r} need {members} mask "
                         f"members, outside [1, {MASK_MEMBERS}]")
    return members, bins


def scan_classify_reference(words: torch.Tensor, payload: torch.Tensor | None,
                            ks: Sequence[int], mode: str, mode_params,
                            packed: bool) -> torch.Tensor:
    """Plain-torch classification scan over one sorted array.

    Returns int64 [2, len(ks), bins]: the doubled and palindromic stats
    of `mode` (see classify_mode_layout), the semantics of khoice_tpu's
    `_sweep_class_{pivot_rest,multi_pivot,containment,feature_buckets}
    (..., raw=True)`; the caller combines (d + p) // 2.

    Written independently of the kernel: each k-run gets an id (cumsum of
    run starts), the dense [runs, 64] presence table gives every run's
    member bits as columns, each mode's bins follow from column sums and
    index_add, and the buckets weight is a scatter-add of the pivot's
    elements into their run ids, halved for palindromic runs, then
    capped."""
    _members, bins = classify_mode_layout(mode, mode_params)
    KW, n = words.shape
    dev = words.device
    out = torch.zeros(2, len(ks), bins, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    gid, nio = _gid_nio(words, payload, packed)
    prev = torch.roll(words, 1, dims=1)
    rev = _rev2comp_words(words)
    for i, k in enumerate(ks):
        run_id, n_runs, run_end = _runs(words, prev, k)
        bits = _presence(run_id, n_runs, gid, nio, k)
        if k % 2 == 0:
            pal = _pal_mask(words, rev, k, KW)[run_end]  # one flag per run
        else:
            pal = torch.zeros(n_runs, dtype=torch.bool, device=dev)
        weight = torch.ones(n_runs, dtype=torch.int64, device=dev)
        if mode == "buckets":
            piv = (nio >= k) & (gid == 0)
            s = torch.zeros(n_runs, dtype=torch.int64, device=dev)
            s.scatter_add_(0, run_id[piv], torch.ones_like(run_id[piv]))
            weight = torch.where(pal, s >> 1, s).clamp(max=int(mode_params[1]))

        def add(b, sel):
            """Add the runs of `sel` to bin b (an int, or one per run)."""
            for row, m in ((0, sel), (1, sel & pal)):
                if isinstance(b, int):
                    out[row, i, b] += weight[m].sum()
                else:
                    out[row, i].index_add_(0, b[m], weight[m])

        if mode == "pivot_rest":
            add(bits[:, 1:1 + int(mode_params)].sum(1), bits[:, 0])
        elif mode == "multi_pivot":
            D = int(mode_params)
            groups = bits[:, D:2 * D].sum(1)
            for num in range(D):
                add(num * D + groups - bits[:, D + num].long(), bits[:, num])
        elif mode == "containment":
            nq, ng = (int(x) for x in mode_params)
            for q in range(nq):
                row = q * (ng + 1)
                add(row, bits[:, q])
                for g in range(ng):
                    add(row + 1 + g, bits[:, q] & bits[:, nq + g])
        else:
            D = int(mode_params[0])
            matches = bits[:, 1:1 + D].sum(1)
            for d in range(D):
                add(d * D + matches - 1, bits[:, 0] & bits[:, 1 + d])
            add(D * D, bits[:, 0] & (matches == 0))
    return out


def _check(words, payload, ks, n_members, cs, packed):
    if words.dtype != torch.int64 or words.dim() != 2 or not 1 <= words.shape[0] <= 4:
        raise ValueError(f"words must be int64 [KW<=4, n], got {words.dtype} {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    KW, n = words.shape
    if packed:
        if payload is not None:
            raise ValueError("packed mode takes no payload tensor")
    elif (payload is None or payload.dtype != torch.int64 or payload.shape != (n,)
          or not payload.is_contiguous() or payload.device != words.device):
        raise ValueError("unpacked mode needs a contiguous int64 [n] payload on the words' device")
    if not 1 <= n_members <= MASK_MEMBERS:
        raise ValueError(f"n_members={n_members} outside [1, {MASK_MEMBERS}]")
    if cs < 1:
        raise ValueError(f"cs={cs} must be >= 1")
    spare = PACK_GID_BITS + PACK_NIO_BITS if packed else 0
    for k in ks:
        if not 2 <= k <= 63 or 2 * k > KW * 32 - spare:
            raise ValueError(f"k={k} does not fit {KW} key words (packed={packed})")


def _launch(words: torch.Tensor, payload: torch.Tensor | None, ks: list,
            mode: str, p0: int, p1: int, bins: int, packed: bool) -> torch.Tensor:
    """Launch the kernel in `mode` over CUDA tensors, as many ks per launch
    as a block's shared histogram holds; int64 [2, len(ks), bins]."""
    lib = _build.load()
    KW, n = words.shape
    dev = words.device
    out = torch.zeros(2, len(ks), bins, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    n_tiles = (n + lib.ksweep_scan_tile_elems() - 1) // lib.ksweep_scan_tile_elems()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        per_launch = min(lib.ksweep_scan_max_ks(),
                         lib.ksweep_scan_hist_bytes_max() // (2 * bins * 4))
        if per_launch < 1:
            raise ValueError(f"{mode}: {bins} bins per k do not fit a block's shared memory")
        for c0 in range(0, len(ks), per_launch):
            cks = ks[c0:c0 + per_launch]
            hist = torch.zeros(2, len(cks), bins, dtype=torch.int64, device=dev)
            tile_f = torch.empty(len(cks), n_tiles, dtype=torch.int32, device=dev)
            tile_v = torch.empty(len(cks), n_tiles, dtype=torch.int64, device=dev)
            carry = torch.empty(len(cks), n_tiles, dtype=torch.int64, device=dev)
            sums = None
            if mode == "buckets":
                sums = torch.empty(2, len(cks), n_tiles, dtype=torch.int32, device=dev)
            err = lib.ksweep_scan_launch(
                words.data_ptr(), None if packed else payload.data_ptr(), n, KW,
                int(packed), (ctypes.c_int * len(cks))(*cks), len(cks),
                MODES.index(mode), p0, p1, bins, tile_f.data_ptr(), tile_v.data_ptr(),
                None if sums is None else sums[0].data_ptr(), carry.data_ptr(),
                None if sums is None else sums[1].data_ptr(), hist.data_ptr(), stream,
            )
            if err != 0:
                raise RuntimeError(f"ksweep_scan launch ({mode}) failed: CUDA error {err}")
            launches[mode] += 1
            out[:, c0:c0 + len(cks)] = hist
    return out


def scan_multi_k(words: torch.Tensor, payload: torch.Tensor | None,
                 ks: Sequence[int], n_members: int, cs: int,
                 packed: bool) -> torch.Tensor:
    """Raw (doubled, palindromic) histograms, int64 [2, len(ks), n_members],
    over sorted int64 [KW, n] key words (the layout above)."""
    ks = [int(k) for k in ks]
    _check(words, payload, ks, n_members, cs, packed)
    if words.device.type == "cpu":
        return scan_multi_k_reference(words, payload, ks, n_members, cs, packed)
    if words.device.type != "cuda":
        raise ValueError(f"no ksweep_scan kernel for device {words.device}")
    return _launch(words, payload, ks, "occ", n_members, min(int(cs), 1 << 30),
                   n_members, packed)


def scan_classify(words: torch.Tensor, payload: torch.Tensor | None,
                  ks: Sequence[int], mode: str, mode_params,
                  packed: bool) -> torch.Tensor:
    """Raw (doubled, palindromic) stats of a classification mode, int64
    [2, len(ks), bins], over sorted int64 [KW, n] key words (the layout
    above); see classify_mode_layout for the modes."""
    ks = [int(k) for k in ks]
    members, bins = classify_mode_layout(mode, mode_params)
    _check(words, payload, ks, members, 1, packed)
    if words.device.type == "cpu":
        return scan_classify_reference(words, payload, ks, mode, mode_params, packed)
    if words.device.type != "cuda":
        raise ValueError(f"no ksweep_scan kernel for device {words.device}")
    if mode == "buckets":
        # a run's pivot count never exceeds n, so a larger cap caps nothing
        p0, p1 = int(mode_params[0]), min(int(mode_params[1]), 2**31 - 1)
    elif mode == "containment":
        p0, p1 = (int(x) for x in mode_params)
    else:
        p0, p1 = int(mode_params), 0
    return _launch(words, payload, ks, mode, p0, p1, bins, packed)
