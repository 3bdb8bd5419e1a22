"""The packed text, the layout in which the port hands genomes to the
device (khoice_tpu/engine/occurrence.py::pack_members, cut into slabs as
khoice_tpu/dist/sharded.py::make_slabs cuts it): uint8 parts laid end to
end, a group's members each followed by one separator, the invalid code
4, so that no window spans two members.  A position belongs to the member
it falls in (a separator to the member before it), past the end to member
0.  Rank r's slab holds window starts [r * chunk, (r + 1) * chunk), chunk
= ceil(n / n_shards), and a k - 1 halo padded with 4, so that a k-mer
across a slab boundary is counted once."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..io.packing import SEP_CODE


def layout(member_codes: Sequence[np.ndarray]) -> Tuple[List[np.ndarray], np.ndarray, int]:
    """(the group's parts, each member's first position int64, length n)."""
    sep = np.full(1, SEP_CODE, np.uint8)
    parts = [p for codes in member_codes for p in (np.asarray(codes, np.uint8), sep)]
    starts, n = offsets(parts)
    return parts, np.ascontiguousarray(starts[::2]), n


def read_rows(mat: np.ndarray) -> np.ndarray:
    """The part of an [r, l] read matrix: each row and a separator."""
    return np.concatenate([mat, np.full((mat.shape[0], 1), SEP_CODE, mat.dtype)], 1).reshape(-1)


def offsets(parts: Sequence[np.ndarray]) -> Tuple[np.ndarray, int]:
    """(each part's first position int64, the text's length n)."""
    lengths = np.array([p.shape[0] for p in parts], np.int64)
    ends = np.cumsum(lengths)
    return ends - lengths, int(ends[-1]) if len(parts) else 0


def join(parts: Sequence[np.ndarray]) -> np.ndarray:
    return np.concatenate(parts)


def chunk_len(n: int, n_shards: int) -> int:
    return max(1, math.ceil(n / n_shards))


def slab(parts: Sequence[np.ndarray], n_shards: int, k: int, rank: int) -> Tuple[np.ndarray, int]:
    """(rank's slab, uint8 [chunk + k - 1]: the row of make_slabs over the
    parts' join, copied from the parts it overlaps; its first position)."""
    starts, n = offsets(parts)
    chunk = chunk_len(n, n_shards)
    lo = rank * chunk
    out = np.full(chunk + k - 1, SEP_CODE, np.uint8)
    for start, part in zip(starts.tolist(), parts):
        a, b = max(start, lo), min(start + part.shape[0], lo + out.shape[0])
        if a < b:
            out[a - lo:b - lo] = part[a - start:b - start]
    return out, lo


def member_ids(starts: np.ndarray, n: int, lo: int, hi: int, device) -> torch.Tensor:
    """int64 [hi - lo] on `device`: the member index of positions [lo, hi).
    Only the member lengths clipped to the range cross to the device."""
    ends = np.append(starts, n)[1:]
    counts = np.append(np.clip(ends, lo, hi) - np.clip(starts, lo, hi), max(0, hi - max(lo, n)))
    ids = np.append(np.arange(starts.shape[0], dtype=np.int64), 0)
    pair = torch.from_numpy(np.stack([ids, counts])).to(device)
    return torch.repeat_interleave(pair[0], pair[1], output_size=hi - lo)


def member_index(starts: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The member index of positions `pos`, on the device of `starts`."""
    return torch.searchsorted(starts, pos, right=True) - 1
