"""Multi-process entry points of the sharded engine (port of
khoice_tpu/dist/multihost.py).

The JAX package runs one SPMD program over a mesh that spans
`jax.distributed` processes: each process builds the full slab matrix on
the host and uploads only its own rows (`_to_global`), and the outputs
come back replicated.  torch.distributed runs one process per rank
already, so every rank of a dist/mesh.py KvGroup is that case: each
process is given the full host inputs (genome bytes are host RAM), cuts
its own slab and uploads only that (dist/occurrence.py::_make_slab_pair,
dist/vote.py), and every rank returns the same result.  These entry
points are the sharded drivers of dist/occurrence.py, dist/ksweep.py and
dist/vote.py, with the JAX package's limits.

The group is the processes' default process group, initialised from the
environment (env://: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK) as processes on separate hosts start it: under
`torchrun --nnodes H --nproc-per-node P ...` call
`dist/mesh.py::init_kv_group("cuda")` in each process, or
`init_multihost(coordinator_address, num_processes, process_id)` where no
launcher set the variables.  Results are equal to the single-device ones
for every process count: integer counters, and integer LCM weights whose
sums do not depend on their order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..kernels.extract import GID_BITS, PACK_KMAX
from .ksweep import run_sweep_plan
from .mesh import KvGroup
from .occurrence import sharded_occurrence_histograms
from .vote import sharded_read_votes_multi


def local_shard_rows(group: KvGroup) -> List[int]:
    """Indices along the kv axis owned by THIS process, in group order: its
    rank (a torch.distributed process holds one rank)."""
    return [group.rank]


def _multihost_occurrence_histograms(group, member_codes, ks, cs, cx, slack=1.5):
    """{k: multihost_occurrence_histogram(...)} over the ks, on one slab
    (dist/occurrence.py::sharded_occurrence_histograms)."""
    if len(member_codes) > (1 << GID_BITS) or max(ks) > PACK_KMAX:
        raise ValueError("multihost path supports <=256 members and k<=60")
    return sharded_occurrence_histograms(group, member_codes, ks, cs=cs, cx=cx, slack=slack)


def multihost_occurrence_histogram(
    group: KvGroup,
    member_codes: Sequence[np.ndarray],
    k: int,
    cs: int = 5000,
    cx: int = 10000,
    bucket_cap: int | None = None,
    slack: float = 1.5,
) -> List[int]:
    """occurrence_histogram over the processes of the group: a list of cx
    ints, equal on every process and to the single-device histogram.  The
    gid-packed path (kernels A, the sort and B) at any k; at most 256
    members and k <= 60, as in the JAX package.  `bucket_cap` is accepted
    and ignored (the shares are uneven)."""
    del bucket_cap
    return _multihost_occurrence_histograms(group, member_codes, [k], cs, cx, slack)[k]


def multihost_occurrence_histograms_sweep(
    group: KvGroup,
    member_codes: Sequence[np.ndarray],
    ks: Sequence[int],
    cs: int = 5000,
    cx: int = 10000,
    bucket_cap: int | None = None,
    slack: float = 1.7,
) -> Dict[int, List[int]]:
    """The shared-sort k-sweep (dist/ksweep.py::run_sweep_plan) over the
    processes of the group: {k: histogram}, equal to the single-device
    sweep; the ks it leaves over take multihost_occurrence_histogram's
    path, all on one slab."""
    return run_sweep_plan(
        group, member_codes, ks, cs, cx, slack,
        per_k_fallback=lambda rest: _multihost_occurrence_histograms(
            group, member_codes, rest, cs, cx),
    )


def multihost_read_votes_multi(
    group: KvGroup,
    group_codes: Sequence[np.ndarray],
    read_mats: Sequence[np.ndarray],
    ks: Sequence[int],
    bucket_cap: int | None = None,
) -> dict:
    """exp6's sharded read voting (dist/vote.py) over the processes of the
    group: {k: [per-pivot (votes, unmatched, n_kmers)]}, equal to the
    single-device votes on every process."""
    return sharded_read_votes_multi(group, group_codes, read_mats, ks, bucket_cap=bucket_cap)
