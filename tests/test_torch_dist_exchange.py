"""The count of rows each rank exchanges (khoice_tpu_torch/dist/mesh.py's
`exchanged`, gathered by `exchange_totals`), on gloo ranks on the CPU.

The ranks run through dist/launch.py::run_ranks (the rank program is
tests/torch_dist_ranks.py::exchange_count).  In every step each rank's
counts must equal the rows that all_to_all_single moved with split sizes
(watched in the rank), the rows sent over the group must equal the rows
received, and the totals gathered by `exchange_totals` must be every
rank's own counts, on every rank.  Every value is a row count, so the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks
from khoice_tpu_torch.dist.launch import run_ranks
from khoice_tpu_torch.io.packing import encode_records
from khoice_tpu_torch.pipelines.exp6 import reads_matrix

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

RANK_TIMEOUT_S = 240
STEPS = ("hand", "count", "sweep", "occurrence", "votes")


def _case(world):
    """Three related genomes with N runs and reads drawn from them, made
    from a seed; the hand-made exchange's shares: rank r sends r + 1 + 2 j
    rows to rank j, and none to itself on the last rank."""
    rng = np.random.default_rng(5)
    core = rng.integers(0, 4, 1500)
    genomes = []
    for g in range(3):
        seq = core.copy()
        idx = rng.choice(1500, 40 * (g + 1), replace=False)
        seq[idx] = rng.integers(0, 4, idx.shape[0])
        text = "".join("ACGT"[c] for c in seq)
        genomes.append(text[:300 + 50 * g] + "N" * 5 + text[305 + 50 * g:])
    shares = [[r + 1 + 2 * j for j in range(world)] for r in range(world)]
    shares[-1][-1] = 0
    mats = [reads_matrix([genomes[d][40 * i:40 * i + 60] for i in range(4 + d)]
                         + ["A" * 30]) for d in range(3)]
    return {"shares": shares, "codes": encode_records(genomes),
            "genomes": [encode_records([s]) for s in genomes], "mats": mats}


@pytest.mark.parametrize("world", [2, 3])
def test_exchange_counts_match_the_rows_exchanged(world):
    case = _case(world)
    ranks = run_ranks(world, torch_dist_ranks.exchange_count, (case,), timeout_s=RANK_TIMEOUT_S)
    shares = case["shares"]
    for r, out in enumerate(ranks):
        assert out["rank"] == r
        # the hand-made exchange: what r sends the others, and what they send r
        assert out["steps"]["hand"]["counted"] == {
            "sent": sum(shares[r]) - shares[r][r],
            "received": sum(shares[j][r] for j in range(world)) - shares[r][r]}
        assert out["hand_rows"] == sum(shares[j][r] for j in range(world))
        for step in STEPS:
            assert out["steps"][step]["counted"] == out["steps"][step]["watched"], (r, step)
        assert out["totals"][r] == (out["own"]["sent"], out["own"]["received"], 0)
        assert out["own"] == {key: sum(out["steps"][s]["counted"][key] for s in STEPS)
                              for key in ("sent", "received")}
    assert all(out["totals"] == ranks[0]["totals"] for out in ranks)
    for step in STEPS:
        sent = sum(out["steps"][step]["counted"]["sent"] for out in ranks)
        received = sum(out["steps"][step]["counted"]["received"] for out in ranks)
        assert sent == received > 0, step
