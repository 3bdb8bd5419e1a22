"""State carried between the JAX package and the port.

khoice_tpu holds a sorted sweep array as a tuple of numpy-convertible
uint32 key words (MSB-first) plus an optional uint32 payload, and packed
members as (uint8 codes, uint32 gids).  The port holds the same values
in int64 tensors (engine/ksweep.py's key layout).  These functions move
either way without changing a bit, so a test can feed one package's
intermediate state straight into the other.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def words_from_numpy(words: Sequence[np.ndarray], device) -> torch.Tensor:
    """KW uint32 word arrays -> int64 [KW, n] tensor on `device`."""
    stacked = np.stack([np.asarray(w, np.uint32) for w in words]).astype(np.int64)
    return torch.from_numpy(stacked).to(device)


def words_to_numpy(words: torch.Tensor) -> tuple:
    """int64 [KW, n] tensor -> tuple of KW uint32 numpy arrays."""
    arr = words.cpu().numpy()
    if arr.size and (arr.min() < 0 or arr.max() > 0xFFFFFFFF):
        raise ValueError("key words outside [0, 2^32)")
    return tuple(arr.astype(np.uint32))


def payload_from_numpy(payload: np.ndarray | None, device) -> torch.Tensor | None:
    """uint32 payload -> int64 [n] tensor (None stays None)."""
    if payload is None:
        return None
    return torch.from_numpy(np.asarray(payload, np.uint32).astype(np.int64)).to(device)


def payload_to_numpy(payload: torch.Tensor | None) -> np.ndarray | None:
    if payload is None:
        return None
    return payload.cpu().numpy().astype(np.uint32)


def members_from_numpy(codes: np.ndarray, gids: np.ndarray, device):
    """(uint8 codes, uint32 gids) -> (uint8 tensor, int64 tensor)."""
    return (
        torch.from_numpy(np.asarray(codes, np.uint8).copy()).to(device),
        torch.from_numpy(np.asarray(gids, np.uint32).astype(np.int64)).to(device),
    )


def members_to_numpy(codes: torch.Tensor, gids: torch.Tensor):
    """(uint8 tensor, int64 tensor) -> (uint8 codes, uint32 gids)."""
    return codes.cpu().numpy().astype(np.uint8), gids.cpu().numpy().astype(np.uint32)
