"""Multi-word k-mer keys on int64 [W, n] tensors (port of
khoice_tpu/engine/bits.py).

A k-mer's key is the 2k-bit base-4 number (A=0, C=1, G=2, T=3),
right-aligned in W = key_words(k) 32-bit words, most significant word
first; numeric order equals lexicographic order of the k-mer string.  The
JAX package keeps a tuple of W uint32 arrays; the port keeps one int64
[W, n] tensor whose entries are 32-bit values (torch has no comparisons
on uint32 on the CPU, see engine/ksweep.py).  The word-count rule leaves
at least one spare bit, so the all-ones SENTINEL never equals a valid key:
    k <= 15 -> 1 word, k <= 31 -> 2 words, k <= 63 -> 4 words.
"""

from __future__ import annotations

import torch

SENTINEL = 0xFFFFFFFF


def key_words(k: int) -> int:
    """Number of 32-bit words of a k-mer key."""
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if k <= 15:
        return 1
    if k <= 31:
        return 2
    if k <= 63:
        return 4
    raise ValueError(f"k={k} not supported (max 63)")


def words_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the word rows of [W, n] tensors."""
    lt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(lt)
    for aw, bw in zip(a, b):
        lt |= eq & (aw < bw)
        eq &= aw == bw
    return lt


def words_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(0)


def words_select(pred: torch.Tensor, a, b) -> torch.Tensor:
    """where(pred, a, b) for every word row (a or b may be a scalar word)."""
    return torch.where(pred, a, b)


def words_is_sentinel(a: torch.Tensor) -> torch.Tensor:
    return (a == SENTINEL).all(0)


def words_starts(a: torch.Tensor) -> torch.Tensor:
    """bool [n]: column i of sorted [W, n] words differs from column i - 1
    (True at 0), the starts of its runs.  Each row is compared with itself
    one element on, through views (no shifted copy of the rows)."""
    is_new = torch.ones(a.shape[1], dtype=torch.bool, device=a.device)
    same = is_new[1:]  # "equal" until inverted
    for row in a:
        same &= row[1:] == row[:-1]
    same.logical_not_()
    return is_new
