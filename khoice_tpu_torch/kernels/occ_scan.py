"""The per-k occurrence histogram: the wrappers of its CUDA kernel
(csrc/occ_scan.cu) and their plain PyTorch versions.

Port of khoice_tpu/kernels/occ_scan_pallas.py: `occ_hist_packed` replaces
occ_hist_packed_pallas (words sorted by value = (key << 8) | gid) and
`occ_hist` replaces occ_hist_pallas (key words sorted by (key, gid) with a
separate gid).  Both return int64 [n_bins]: hist[b-1] = #distinct keys
whose number of distinct gids, capped at cs, is b; the SENTINEL run
counts 0 (the JAX package's plain per-k path, engine/occurrence.py).
For a CUDA tensor each launches the kernel on the current stream, or
raises; for a CPU tensor it runs its plain version.  Launches are
counted per layout in `launches`.

Layout: int64 [W, n] of 32-bit words, most significant first (the port's
key layout, engine/bits.py); the separate gid is int64 [n].
"""

from __future__ import annotations

import torch

from ..engine.bits import words_is_sentinel, words_starts
from . import _build
from .extract import GID_BITS

# kernel launches per layout since the last reset (CPU calls of the plain
# versions do not count)
launches = {"packed": 0, "unpacked": 0}


def key_pair_starts(words: torch.Tensor, gid: torch.Tensor | None):
    """(key_new, pair_new) bool [n] of a sorted array: the element starts a
    key run / a (key, gid) pair.  gid None: the packed layout, the gid in
    the last word's low GID_BITS.  Rows are compared through views
    (engine/bits.py::words_starts)."""
    key_new = words_starts(words if gid is not None else words[:-1])
    pair_new = key_new.clone()
    if words.shape[1] > 1:
        if gid is None:
            cur, prev = words[-1, 1:], words[-1, :-1]
            pair_new[1:] |= cur != prev
            key_new[1:] |= (cur ^ prev) >= (1 << GID_BITS)
        else:
            pair_new[1:] |= gid[1:] != gid[:-1]
    return key_new, pair_new


def run_occurrences(words: torch.Tensor, gid: torch.Tensor | None, cs: int):
    """(index of each key run's first element, int64 occ per run) of a
    sorted array: occ = distinct gids in the run, capped at cs, 0 for the
    SENTINEL run (the last run, where there is one).  With C the running
    count of pair starts, a run's occ is C before the next run's first
    element minus C before its own; each step frees what the next does
    not need (engine/streaming.py::occurrence_table_bytes)."""
    n = words.shape[1]
    key_new, pair_new = key_pair_starts(words, gid)
    starts = torch.nonzero(key_new).squeeze(1)
    del key_new
    cum = torch.cumsum(pair_new, 0, dtype=torch.int32 if n < 2**31 else torch.int64)
    del pair_new
    occ = torch.empty(starts.shape[0], dtype=torch.int64, device=words.device)
    if n:
        at = cum[starts]  # C up to each run's first element, a pair start
        occ[:-1] = at[1:] - at[:-1]
        occ[-1:] = cum[-1:] - at[-1:] + 1
        del at
    del cum
    occ.clamp_(max=cs)
    occ[-1:].masked_fill_(words_is_sentinel(words[:, starts[-1:]]), 0)
    return starts, occ


def _hist(occ: torch.Tensor, n_bins: int) -> torch.Tensor:
    return torch.bincount(occ, minlength=n_bins + 1)[1:n_bins + 1]


def occ_hist_packed_reference(words: torch.Tensor, n_bins: int, cs: int) -> torch.Tensor:
    """Plain version of the packed layout's histogram."""
    return _hist(run_occurrences(words, None, cs)[1], n_bins)


def occ_hist_reference(keys: torch.Tensor, gid: torch.Tensor, n_bins: int,
                       cs: int) -> torch.Tensor:
    """Plain version of the separate-gid layout's histogram."""
    return _hist(run_occurrences(keys, gid, cs)[1], n_bins)


def _check(words: torch.Tensor, gid: torch.Tensor | None, n_bins: int, cs: int):
    if (words.dtype != torch.int64 or words.dim() != 2 or not 1 <= words.shape[0] <= 4
            or not words.is_contiguous()):
        raise ValueError(f"words must be contiguous int64 [W<=4, n], got {words.dtype} "
                         f"{tuple(words.shape)}")
    if gid is not None and (gid.dtype != torch.int64 or gid.shape != words.shape[1:]
                            or not gid.is_contiguous() or gid.device != words.device):
        raise ValueError("gid must be a contiguous int64 [n] on the words' device")
    if n_bins < 1 or cs < 1:
        raise ValueError(f"n_bins={n_bins} and cs={cs} must be >= 1")


def _launch(words: torch.Tensor, gid: torch.Tensor | None, n_bins: int, cs: int):
    if words.device.type != "cuda":
        raise ValueError(f"no occ_scan kernel for device {words.device}")
    lib = _build.load()
    W, n = words.shape
    dev = words.device
    hist = torch.zeros(n_bins, dtype=torch.int64, device=dev)
    if n == 0:
        return hist
    with torch.cuda.device(dev):
        if n_bins > lib.occ_scan_bins_max():
            raise ValueError(f"{n_bins} bins do not fit a block's shared memory")
        # the look-back's status words, one per tile (element n, which
        # closes the last run, lies in the last), then the tile counter
        n_tiles = n // lib.occ_scan_tile_elems() + 1
        status = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
        err = lib.occ_scan_launch(
            words.data_ptr(), None if gid is None else gid.data_ptr(), n, W,
            int(gid is None), min(int(cs), 2**31 - 1), n_bins, status.data_ptr(),
            hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"occ_scan launch failed: CUDA error {err}")
    launches["packed" if gid is None else "unpacked"] += 1
    return hist


def occ_hist_packed(words: torch.Tensor, n_bins: int, cs: int) -> torch.Tensor:
    """int64 [n_bins] occurrence histogram of int64 [W, n] words sorted by
    value, each (key << 8) | gid, SENTINEL (all ones) where invalid."""
    _check(words, None, n_bins, cs)
    if words.device.type == "cpu":
        return occ_hist_packed_reference(words, n_bins, cs)
    return _launch(words, None, n_bins, cs)


def occ_hist(keys: torch.Tensor, gid: torch.Tensor, n_bins: int, cs: int) -> torch.Tensor:
    """int64 [n_bins] occurrence histogram of int64 [W, n] key words and an
    int64 [n] gid, sorted by (key, gid), SENTINEL keys where invalid."""
    _check(keys, gid, n_bins, cs)
    if keys.device.type == "cpu":
        return occ_hist_reference(keys, gid, n_bins, cs)
    return _launch(keys, gid, n_bins, cs)
