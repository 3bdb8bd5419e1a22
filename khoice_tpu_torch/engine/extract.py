"""Canonical k-mer extraction from encoded sequence codes (port of
khoice_tpu/engine/extract.py; the design is documented there).

Codes are uint8, A=0 C=1 G=2 T=3, anything >= 4 invalid (N bases and
separators); a k-mer's key is its 2-bit big-endian packing, canonical as
min(forward, reverse complement), SENTINEL (all ones) where the window is
invalid.  Keys are int64 [key_words(k), n] tensors of 32-bit words, most
significant first.

- `extract_canonical(codes, k)` is kernel A's wrapper
  (kernels/extract.py): the CUDA kernel for a CUDA tensor, its plain
  version for a CPU tensor.
- `extract_canonical_sweep(codes, ks)` gives every k of a grid from ONE
  pass at K = max(ks): the forward j-mer at i is the top of the forward
  K-mer's low 2j bits, and the reverse complement grows by one
  complemented base at its high end per step (fwd_j(i) = fwd_K(i) >>
  2(K-j), rc_j(i) = rc_K(i) mod 4^j).  In the JAX package it is XLA (no
  Pallas kernel), so here it is plain PyTorch on the codes' device.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..kernels.extract import _shl_or, extract_canonical
from .bits import SENTINEL, key_words, words_lt, words_select

__all__ = ["extract_canonical", "extract_canonical_sweep"]

_U32 = 0xFFFFFFFF


def _low_bits(words: torch.Tensor, bits: int) -> torch.Tensor:
    """The low `bits` bits of int64 [w, n] 32-bit words, the rest zeroed."""
    w = words.shape[0]
    out = words.clone()
    for i in range(w):
        keep = max(0, min(32, bits - 32 * (w - 1 - i)))
        out[i] &= _U32 >> (32 - keep) if keep else 0
    return out


def extract_canonical_sweep(codes: torch.Tensor, ks: Sequence[int]) -> Dict[int, tuple]:
    """{k: (keys int64 [key_words(k), n], valid bool [n])} for every k in
    `ks`, from one pass over the uint8 codes [n]; each equal to
    extract_canonical(codes, k)."""
    ks = sorted(set(int(k) for k in ks))
    kmax = ks[-1]
    wmax = key_words(kmax)
    n = codes.shape[0]
    dev = codes.device
    cp = torch.cat([codes, torch.full((kmax,), 4, dtype=codes.dtype, device=dev)])
    cbad = torch.cumsum((cp >= 4).to(torch.int64), 0)
    cbad0 = torch.cat([cbad.new_zeros(1), cbad])
    digits = cp.to(torch.int64) & 3
    fwd = torch.zeros(wmax, n, dtype=torch.int64, device=dev)
    rc = torch.zeros_like(fwd)
    out = {}
    for j in range(kmax):
        d = digits[j:j + n]
        fwd = _shl_or(fwd, 2, d)
        # rc_{j+1} = rc_j | comp(d) << 2j: rc_j holds the low 2j bits
        rc[wmax - 1 - (2 * j) // 32] |= (d ^ 3) << ((2 * j) % 32)
        kk = j + 1
        if kk in ks:
            w = key_words(kk)
            valid = (cbad0[kk:n + kk] - cbad0[:n]) == 0
            f = _low_bits(fwd[wmax - w:], 2 * kk)
            r = _low_bits(rc[wmax - w:], 2 * kk)
            canon = words_select(words_lt(f, r), f, r)
            out[kk] = (words_select(valid, canon, SENTINEL), valid)
    return out
