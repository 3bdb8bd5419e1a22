"""Device-side k-mer match annotation (port of the Annotation part of
khoice_tpu/classify/annotate.py): the merge_lists.py core that exp4's
per-k path needs.

The reference tags every pivot k-mer with the datasets whose group union
contains it, by streaming KMC text dumps through Python dicts (reference
src/merge_lists.py:14-33).  Here the pivot table and all D group sets are
concatenated and sorted once; per-run segment sums give the pivot's count
and a presence bitmask over the datasets, aligned on the same keys.
Buckets are exact integers.  exp6's read voting stays with the JAX
package until it is ported (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..engine.ops import _run_starts, _run_sums
from ..engine.table import KmerTable
from ..kernels.sort import sort_words


@dataclasses.dataclass
class Annotation:
    """Merged, sorted keys of a pivot table and D group sets.

    keys: int64 [W, C] unique ascending keys of the pivot and the groups
    pivot_count: int64 [C], the pivot's count (0 where it lacks the key)
    mask: int64 [C], bit d set iff dataset d's group holds the key
    """

    keys: torch.Tensor
    pivot_count: torch.Tensor
    mask: torch.Tensor
    num_datasets: int
    k: int


def build_annotation(pivot: KmerTable, groups: List[KmerTable]) -> Annotation:
    """pivot: a raw-count table; groups: per-dataset set tables (counts 1).
    Each table's keys are unique, so a run holds each source at most once
    and the sum of its sources' bits is their OR."""
    d = len(groups)
    assert 1 <= d <= 62, "the dataset mask is an int64 bitmask"
    tables = [pivot] + list(groups)
    src = torch.cat([torch.full((len(t),), i, dtype=torch.int64, device=pivot.device)
                     for i, t in enumerate(tables)])
    counts = torch.cat([t.counts for t in tables])
    skeys, perm = sort_words(torch.cat([t.keys for t in tables], 1),
                             torch.arange(src.shape[0], device=pivot.device))
    src, counts = src[perm], counts[perm]
    is_new = _run_starts(skeys)
    pivot_count = _run_sums(torch.where(src == 0, counts, 0), is_new)
    bit = torch.bitwise_left_shift(torch.ones_like(src), (src - 1).clamp(min=0))
    mask = _run_sums(torch.where(src > 0, bit, 0), is_new)
    return Annotation(skeys[:, is_new], pivot_count, mask, d, pivot.k)


def feature_buckets(ann: Annotation):
    """(buckets [D, D] int64, unique int) on the host: bucket[d, m-1] =
    total pivot count of keys in dataset d matched by m datasets; unique =
    total pivot count of keys matching no dataset."""
    D = ann.num_datasets
    bits = torch.stack([(ann.mask >> d) & 1 for d in range(D)])
    nmatch = bits.sum(0)
    present = ann.pivot_count > 0
    unique = int(ann.pivot_count[present & (nmatch == 0)].sum())
    buckets = torch.zeros(D, D, dtype=torch.int64, device=ann.mask.device)
    for d in range(D):
        sel = present & (bits[d] == 1)
        buckets[d].index_add_(0, nmatch[sel] - 1, ann.pivot_count[sel])
    return buckets.cpu().numpy().astype(np.int64), unique
