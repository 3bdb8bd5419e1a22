"""Device memory budget of the shared-sort sweeps and of the per-k fused
path, exp1's and the classification experiments' (port of the budget
part of khoice_tpu/engine/streaming.py).

The JAX package dispatches a group whose in-core sweep would not fit the
device to a bounded-memory streaming sweep.  That sweep is not ported
yet (ROADMAP.md queue 1 item 5): here a group over budget raises, on the
shared-sort sweep and on the per-k path alike.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..kernels.extract import occ_words_static
from .bits import key_words
from .ksweep import plan_sweep
from .occurrence import gid_packable

# The port's peak bytes per element of one sort (a doubled-text element
# of a class sort, a text position of a per-k sort), in int64 units: the
# extracted words and their sorted copy (2 x W: W = KW, +1 for a separate
# payload; per k, occ_words_static(k) packed or key_words(k) + 1 with the
# gid apart) plus the sort's key, value and permutation vectors (6).
_SORT_OVERHEAD_WORDS = 6


class DeviceBudgetExceeded(RuntimeError):
    """A group's in-core sweep needs more device memory than the budget."""


def default_device_budget_bytes(device) -> int:
    """~85% of the CUDA device's memory (the rest covers the resident
    codes, the allocator's slack and the outputs); 64 GB, KMC's own
    `-m64`, for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total * 0.85)
    return 64 << 30


def incore_sweep_bytes(total_positions: int, ks: Sequence[int], n_members: int) -> int:
    """Estimated peak device bytes of the port's in-core sweep over a
    group whose packed text (members + separators) spans `total_positions`:
    the largest class sort over n2 = 2 * total_positions elements."""
    classes, _rest = plan_sweep(ks, n_members)
    n2 = 2 * total_positions
    worst = 0
    for _kmax, KW, _cks, packed in classes:
        words = KW if packed else KW + 1
        worst = max(worst, n2 * 8 * (2 * words + _SORT_OVERHEAD_WORDS))
    return worst


def perk_bytes(total_positions: int, ks: Sequence[int], n_members: int) -> int:
    """Estimated peak device bytes of the per-k fused path over a group
    whose packed text spans `total_positions`: its largest per-k sort
    (engine/occurrence.py), 0 for no ks."""
    worst = 0
    for k in ks:
        words = occ_words_static(k) if gid_packable(n_members, k) else key_words(k) + 1
        worst = max(worst, total_positions * 8 * (2 * words + _SORT_OVERHEAD_WORDS))
    return worst


def check_device_budget(need_bytes: int, budget_bytes: int, label: str) -> None:
    """Raise DeviceBudgetExceeded when `need_bytes` would not fit."""
    if need_bytes > budget_bytes:
        raise DeviceBudgetExceeded(
            f"{label}: needs ~{need_bytes / 2**30:.1f} GiB of device memory, over the "
            f"device budget of {budget_bytes / 2**30:.1f} GiB; the bounded-memory "
            "streaming sweep is not yet ported (ROADMAP.md queue 1 item 5)"
        )


def check_incore_budget(total_positions: int, ks: Sequence[int], n_members: int,
                        budget_bytes: int, label: str) -> None:
    """Raise DeviceBudgetExceeded when the group's plan (its class sorts
    and the per-k sorts of the ks it leaves over) would not fit."""
    _classes, remaining = plan_sweep(ks, n_members)
    need = max(incore_sweep_bytes(total_positions, ks, n_members),
               perk_bytes(total_positions, remaining, n_members))
    check_device_budget(need, budget_bytes, label)
