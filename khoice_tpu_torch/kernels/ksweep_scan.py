"""The multi-k occurrence scan: the wrapper of its CUDA kernel
(csrc/ksweep_scan.cu) and its plain PyTorch version.

Port of khoice_tpu/kernels/ksweep_scan_pallas.py's "occ" mode.  For a
CUDA tensor `scan_multi_k` launches the hand-written kernel on the
current stream, or raises; for a CPU tensor it runs the plain version
`scan_multi_k_reference`.  Both return the raw int64
[2, len(ks), n_members] (doubled, palindromic) histograms.

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

# kernel launches since the last reset (one per launch of the CUDA
# entry point; CPU calls of the plain version do not count)
launches = 0


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
        key_new = _key_new_mask(words, prev, k, KW)
        key_new[0] = True
        run_id = torch.cumsum(key_new, 0) - 1
        n_runs = int(run_id[-1]) + 1
        sel = (nio >= k) & (gid < 64)
        present = torch.zeros(n_runs * 64, dtype=torch.bool, device=dev)
        present[run_id[sel] * 64 + gid[sel]] = True
        b = present.view(n_runs, 64).sum(1).clamp(max=cs)
        del present
        out[0, i] = torch.bincount(b, minlength=n_members + 1)[1:n_members + 1]
        if k % 2 == 0:
            run_end = torch.ones_like(key_new)
            run_end[:-1] = key_new[1:]
            pal = _pal_mask(words, rev, k, KW)[run_end]  # one flag per run
            out[1, i] = torch.bincount(b[pal], minlength=n_members + 1)[1:n_members + 1]
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


def scan_multi_k(words: torch.Tensor, payload: torch.Tensor | None,
                 ks: Sequence[int], n_members: int, cs: int,
                 packed: bool) -> torch.Tensor:
    """Raw (doubled, palindromic) histograms, int64 [2, len(ks), n_members],
    over sorted int64 [KW, n] key words (the layout above)."""
    global launches
    ks = [int(k) for k in ks]
    _check(words, payload, ks, n_members, cs, packed)
    if words.device.type == "cpu":
        return scan_multi_k_reference(words, payload, ks, n_members, cs, packed)
    if words.device.type != "cuda":
        raise ValueError(f"no ksweep_scan kernel for device {words.device}")
    lib = _build.load()
    KW, n = words.shape
    dev = words.device
    out = torch.zeros(2, len(ks), n_members, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    tile = lib.ksweep_scan_tile_elems()
    max_ks = lib.ksweep_scan_max_ks()
    n_tiles = (n + tile - 1) // tile
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for c0 in range(0, len(ks), max_ks):
            cks = ks[c0:c0 + max_ks]
            hist = torch.zeros(2, len(cks), n_members, dtype=torch.int64, device=dev)
            tile_f = torch.empty(len(cks), n_tiles, dtype=torch.int32, device=dev)
            tile_v = torch.empty(len(cks), n_tiles, dtype=torch.int64, device=dev)
            carry = torch.empty(len(cks), n_tiles, dtype=torch.int64, device=dev)
            err = lib.ksweep_scan_launch(
                words.data_ptr(), None if packed else payload.data_ptr(), n, KW,
                int(packed), (ctypes.c_int * len(cks))(*cks), len(cks), n_members,
                min(int(cs), 1 << 30), tile_f.data_ptr(), tile_v.data_ptr(),
                carry.data_ptr(), hist.data_ptr(), stream,
            )
            if err != 0:
                raise RuntimeError(f"ksweep_scan launch failed: CUDA error {err}")
            launches += 1
            out[:, c0:c0 + len(cks)] = hist
    return out
