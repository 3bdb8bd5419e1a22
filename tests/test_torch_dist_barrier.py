"""KvGroup.barrier (khoice_tpu_torch/dist/mesh.py) while rank 0 works
alone, as it does in the sharded CLI (exp0, exp2-4's per-k fallback, the
output files), on gloo ranks on the CPU.

The rank program (tests/torch_dist_ranks.py::solo_wait) makes a group
whose collectives time out after TIMEOUT_S, lets rank 0 sleep SOLO_S >
TIMEOUT_S before the barrier, and runs one all_reduce after it.  A
barrier that waits in a collective fails on the other ranks; this one
waits on the store, so every rank must leave it after rank 0's work ends
and the all_reduce must sum one per rank (exact).
"""

import pytest
import torch

import torch_dist_ranks
from khoice_tpu_torch.dist.launch import run_ranks

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

SOLO_S = 5.0
TIMEOUT_S = 2.0
RANK_TIMEOUT_S = 120


@pytest.mark.parametrize("world", [2, 3])
def test_barrier_outlasts_the_collective_timeout(world, tmp_path):
    ranks = run_ranks(world, torch_dist_ranks.solo_wait,
                      (str(tmp_path / "store"), SOLO_S, TIMEOUT_S), timeout_s=RANK_TIMEOUT_S)
    done = ranks[0][0]
    assert done is not None and all(out[0] is None for out in ranks[1:])
    for _, left, total in ranks:
        assert left >= done
        assert total == world
