"""The port's multi-word sort (the plain stand-in for the hand-written
radix sort still to come, ROADMAP.md queue 2 row 2).

Keys are int64 [KW, n] tensors of 32-bit words, most significant first
(engine/bits.py, engine/ksweep.py).
"""

from __future__ import annotations

import torch


def sort_words(words: torch.Tensor, payload: torch.Tensor | None = None):
    """Sort int64 [KW, n] key words as unsigned KW*32-bit keys; the
    payload (if any) follows its element.

    Word pairs fold into signed int64 keys with the sign bit flipped
    ((w0 - 2^31) * 2^32 + w1), and stable sorts run from the least
    significant pair up (LSD).  Ties are identical elements in packed
    mode; in unpacked mode the order within equal keys differs from
    XLA's unstable sort, which no histogram depends on."""
    KW = words.shape[0]
    cols = list(words) + [torch.zeros_like(words[0])] * (KW % 2)
    perm = None
    for j in reversed(range(0, len(cols), 2)):
        key = (cols[j] - (1 << 31)) * (1 << 32) + cols[j + 1]
        if perm is not None:
            key = key[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return words[:, perm], (None if payload is None else payload[perm])
