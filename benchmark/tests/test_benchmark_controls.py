"""Each cell's control (the reference with canonical keys narrowed to
32-bit fingerprints, in the program's place) comes out of the harness's
own run and check as not correct, at a size a test run holds: enough
distinct k-mers that fingerprints collide."""

import pytest
import torch

import controls
from bench_tiny import TINY, parts

SIZES = {
    # 8 Mbp of distinct 21- and 31-mers: tens of fingerprint collisions
    "exp1.4x8x5mbp": dict(num_datasets=2, genomes_per_dataset=2, genome_mbp=2.0,
                          k_values=[21, 31]),
    "ksweep.4x8x5mbp": dict(num_datasets=2, genomes_per_dataset=2, genome_mbp=2.0,
                            k_values=[21, 31]),
    "exp6.4x8x5mbp": dict(num_datasets=2, genomes_per_dataset=2, genome_mbp=0.5,
                          k_values=[21, 31, 35], kmers_per_dataset=200_000),
}


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_is_not_correct(cell):
    torch.set_num_threads(2)
    result = controls.control_run(cell, 2**32 + 5, torch.device("cpu"),
                                  parts=parts(cell, **SIZES[cell]))
    assert result["correct"] is False, result["compared"]
    assert any(v["value"] > v["limit"] for v in result["compared"].values())


def test_tiny_sizes_are_the_real_configs_but_for_scale():
    cfg, _mix, _kind = parts("exp1.4x8x5mbp")
    assert cfg["union_cs"] == 5000 and cfg["hist_cx"] == 10000
    assert {k: cfg[k] for k in TINY} == TINY
