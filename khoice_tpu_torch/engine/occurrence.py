"""Member packing for the occurrence sweeps (port of the packing part of
khoice_tpu/engine/occurrence.py).

A group's members are concatenated with one separator code (4) after
each member, and every position carries its member's gid.  The JAX
package pads the result to a geometric shape bucket (`_padded_len`) to
bound XLA recompiles; eager PyTorch has no recompiles, and the padding
positions are invalid (code 4) so they change no histogram — the port
leaves it out.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

GID_BITS = 8  # gid bits of the per-k fused path's (key << GID_BITS | gid)


def occ_words_static(k: int) -> int:
    """uint32 words for (key << GID_BITS | gid) at a static k."""
    return (2 * k + GID_BITS + 31) // 32


def _member_layout(member_codes: Sequence[np.ndarray]):
    """(concatenated codes incl. one separator after each member, member
    start offsets)."""
    parts = []
    starts = [0]
    for codes in member_codes:
        parts.append(np.asarray(codes, np.uint8))
        parts.append(np.full(1, 4, np.uint8))
        starts.append(starts[-1] + codes.shape[0] + 1)
    return np.concatenate(parts), np.asarray(starts[:-1], np.int64)


def pack_members(member_codes: Sequence[np.ndarray], device):
    """(codes uint8 [n], gids int64 [n]) on `device`: members joined with
    separators, each position labelled with its member index.  Only the
    codes (1 B per position) cross to the device; the gids are expanded
    there from the member lengths."""
    codes, starts = _member_layout(member_codes)
    lengths = torch.from_numpy(np.diff(np.append(starts, codes.shape[0]))).to(device)
    gids = torch.repeat_interleave(
        torch.arange(len(member_codes), dtype=torch.int64, device=device), lengths
    )
    return torch.from_numpy(codes).to(device), gids
