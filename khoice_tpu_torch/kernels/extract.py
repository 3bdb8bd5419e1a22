"""Canonical k-mer extraction: the wrappers of its CUDA kernel
(csrc/extract_canonical.cu) and its plain PyTorch versions.

Port of khoice_tpu/kernels/extract_pallas.py::extract_canonical_pallas,
which computes khoice_tpu/engine/extract.py::extract_canonical; the
engine imports the extraction from here (the JAX package's shared-sort
extraction, extract_canonical_sweep, has its port in engine/ksweep.py).
`extract_canonical(codes, k)` returns the canonical keys (int64
[key_words(k), n] of 32-bit words, SENTINEL where the window is invalid)
and the bool [n] validity; `extract_packed(codes, gids, k)` returns the
same keys with each window's gid folded in, (key << 8) | gid over
occ_words_static(k) words (the JAX package's pack_gid_static), from the
same pass of the kernel.  For a CUDA tensor each launches the kernel on
the current stream, or raises; for a CPU tensor it runs its plain version.
Kernel launches are counted per output form in `launches`.
"""

from __future__ import annotations

import torch

from ..engine.bits import SENTINEL, key_words, words_lt, words_select
from . import _build

GID_BITS = 8  # gid bits of the packed form: (key << GID_BITS) | gid
PACK_KMAX = 60  # 2k + GID_BITS must fit four words

_U32 = 0xFFFFFFFF

# kernel launches per output form since the last reset (CPU calls of the
# plain versions do not count)
launches = {"keys": 0, "packed": 0}


def occ_words_static(k: int) -> int:
    """32-bit words of (key << GID_BITS) | gid at k."""
    return (2 * k + GID_BITS + 31) // 32


def _shl_or(words: torch.Tensor, bits: int, low: torch.Tensor) -> torch.Tensor:
    """(value << bits) | low across the rows of int64 [W, n] 32-bit words."""
    out = (words << bits) & _U32
    out[:-1] |= words[1:] >> (32 - bits)
    out[-1] |= low
    return out


def extract_canonical_reference(codes: torch.Tensor, k: int):
    """Plain-torch canonical extraction, the JAX package's
    engine/extract.py::extract_canonical on int64 words: a forward and a
    reverse-complement register each take k 2-bit pushes, the canonical
    key is their lexicographic min, and windows holding a code >= 4 (or
    crossing the end) get the SENTINEL."""
    n = codes.shape[0]
    W = key_words(k)
    cp = torch.cat([codes, torch.full((k,), 4, dtype=codes.dtype, device=codes.device)])
    cbad = torch.cumsum((cp >= 4).to(torch.int64), 0)
    cbad0 = torch.cat([cbad.new_zeros(1), cbad])
    valid = (cbad0[k:n + k] - cbad0[:n]) == 0
    digits = cp.to(torch.int64) & 3
    fwd = torch.zeros(W, n, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        fwd = _shl_or(fwd, 2, digits[j:j + n])
        rc = _shl_or(rc, 2, digits[k - 1 - j:k - 1 - j + n] ^ 3)
    canon = words_select(words_lt(fwd, rc), fwd, rc)
    return words_select(valid, canon, SENTINEL), valid


def pack_gid_words(keys: torch.Tensor, valid: torch.Tensor, gids: torch.Tensor,
                   k: int) -> torch.Tensor:
    """(key << GID_BITS) | gid re-laid over occ_words_static(k) words, all
    ones where invalid: the JAX package's engine/occurrence.py::
    pack_gid_static on [W, n] tensors.  keys arrive right-aligned in
    key_words(k) words, which can be fewer (k = 31: 2 -> 3) or more
    (k = 35: 4 -> 3) than the packed width; the leading words dropped are
    zero."""
    ow = occ_words_static(k)
    if ow > keys.shape[0]:
        keys = torch.cat([keys.new_zeros(ow - keys.shape[0], keys.shape[1]), keys])
    packed = _shl_or(keys, GID_BITS, gids)[keys.shape[0] - ow:]
    return words_select(valid, packed, SENTINEL)


def extract_packed_reference(codes: torch.Tensor, gids: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the kernel's packed form."""
    keys, valid = extract_canonical_reference(codes, k)
    return pack_gid_words(keys, valid, gids, k)


def _check(codes: torch.Tensor, k: int, gids: torch.Tensor | None):
    if codes.dtype != torch.uint8 or codes.dim() != 1 or not codes.is_contiguous():
        raise ValueError(f"codes must be contiguous uint8 [n], got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    if not 2 <= k <= 63:
        raise ValueError(f"k={k} outside [2, 63]")
    if gids is not None:
        if k > PACK_KMAX:
            raise ValueError(f"k={k}: (key << {GID_BITS}) | gid needs k <= {PACK_KMAX}")
        if (gids.dtype != torch.int64 or gids.shape != codes.shape
                or not gids.is_contiguous() or gids.device != codes.device):
            raise ValueError("gids must be a contiguous int64 [n] on the codes' device")


def _launch(codes: torch.Tensor, k: int, gids: torch.Tensor | None):
    if codes.device.type != "cuda":
        raise ValueError(f"no extract_canonical kernel for device {codes.device}")
    lib = _build.load()
    n = codes.shape[0]
    nw = key_words(k) if gids is None else occ_words_static(k)
    out = torch.empty(nw, n, dtype=torch.int64, device=codes.device)
    valid = torch.empty(n, dtype=torch.bool, device=codes.device) if gids is None else None
    if n == 0:
        return out, valid
    with torch.cuda.device(codes.device):
        err = lib.extract_canonical_launch(
            codes.data_ptr(), n, k, None if gids is None else gids.data_ptr(),
            out.data_ptr(), nw, None if valid is None else valid.data_ptr(),
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"extract_canonical launch failed: CUDA error {err}")
    launches["keys" if gids is None else "packed"] += 1
    return out, valid


def extract_canonical(codes: torch.Tensor, k: int):
    """(int64 [key_words(k), n] canonical keys, bool [n] valid) of every
    window of the uint8 codes (A=0 C=1 G=2 T=3, >= 4 invalid)."""
    k = int(k)
    _check(codes, k, None)
    if codes.device.type == "cpu":
        return extract_canonical_reference(codes, k)
    return _launch(codes, k, None)


def extract_packed(codes: torch.Tensor, gids: torch.Tensor, k: int) -> torch.Tensor:
    """int64 [occ_words_static(k), n]: each window's (canonical key << 8) |
    gid, all ones where invalid; gids int64 [n], each < 256; k <= 60."""
    k = int(k)
    _check(codes, k, gids)
    if codes.device.type == "cpu":
        return extract_packed_reference(codes, gids, k)
    return _launch(codes, k, gids)[0]
