"""Rank programs of tests/test_torch_dist.py and tests/test_torch_dist_cli.py.

khoice_tpu_torch/dist/launch.py::run_ranks pickles a module-level function
and calls it in every rank of a gloo group on the CPU.  A rank imports this
module and what it imports: the port and numpy, never jax, the JAX package
or a test module, so the ranks start fast and `"jax" in sys.modules` in a
rank tells whether the port pulled jax in.  Every input arrives as numpy
arrays from the test, which made them from seeds; every output is
plain data (dumps, lists, numpy arrays) for the test to compare.
"""

import logging
import sys

import numpy as np

from khoice_tpu_torch.dist import ksweep_classify as dkc
from khoice_tpu_torch.dist import sharded as sh
from khoice_tpu_torch.dist.ksweep import sharded_occurrence_histograms_sweep
from khoice_tpu_torch.dist.mesh import init_kv_group
from khoice_tpu_torch.dist.occurrence import sharded_occurrence_histogram


class _Keep(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def battery(case):
    """Every sharded function of the port on `case`'s inputs (see
    tests/test_torch_dist.py::_case), at this group's world size."""
    g = init_kv_group("cpu")
    keep = _Keep()
    for name in ("khoice.dist.sharded", "khoice.dist.ksweep"):
        logging.getLogger(name).addHandler(keep)
    out = {"jax": "jax" in sys.modules, "world_size": g.world_size}

    sh.reset_session_splits()
    out["count"] = {k: sh.sharded_count_codes(g, case["count_codes"], k).dump()
                    for k in case["count_ks"]}

    # the algebra over the adversarial genomes at one k, as the JAX
    # package's dryrun_multichip composes it
    k = case["algebra_k"]
    raw = [sh.sharded_count_codes(g, c, k) for c in case["genomes"]]
    sets = [sh.sharded_set_counts(t, 1) for t in raw]
    union = sh.sharded_union_many(sets, cs=5000)
    out["algebra"] = {
        "union": union.dump(),
        "union_cs2": sh.sharded_union_many(sets, cs=2).dump(),
        "intersect": sh.sharded_intersect_sum(raw[0], raw[1]).dump(),
        "subtract": sh.sharded_subtract(raw[0], raw[1]).dump(),
        "set_counts": sh.sharded_set_counts(raw[2], 3).dump(),
        "hist": sh.sharded_histogram(union, cx=16).tolist(),
        "hist_raw": sh.sharded_histogram(raw[0], cx=8).tolist(),
        "same_splits": all(np.array_equal(raw[0].splits, t.splits) for t in raw[1:]),
    }

    # skewed keys stay balanced: nothing logged
    before = len(keep.lines)
    out["skew"] = sh.sharded_count_codes(g, case["skew_codes"], case["skew_k"]).dump()
    out["skew_warnings"] = keep.lines[before:]

    # a table of another session: foreign splits, re-partitioned
    k = case["resplit_k"]
    sh.reset_session_splits()
    ta = sh.sharded_count_codes(g, case["resplit_a"], k)
    sh.reset_session_splits()
    tb = sh.sharded_count_codes(g, case["resplit_b"], k)
    out["resplit"] = {
        "foreign": not np.array_equal(ta.splits, tb.splits),
        "moved": sh.resplit(tb, ta.splits).dump(),
        "b": tb.dump(),
        "intersect": sh.sharded_intersect_sum(ta, tb).dump(),
    }

    # state carried across from the JAX package (its table at D = 2)
    host = case["jax_table"]
    if host["words"].shape[1] == g.world_size:
        t = sh.sharded_table_from_host(host["words"], host["counts"], host["splits"],
                                       host["k"], g)
        own = sh.sharded_set_counts(sh.sharded_count_codes(g, host["other"], host["k"]), 1)
        back = sh.sharded_table_to_host(t)
        again = sh.sharded_table_from_host(*back, host["k"], g)
        out["carried"] = {
            "dump": t.dump(),
            "union": sh.sharded_union_many([t, own], cs=5000).dump(),
            "again": again.dump(),
            "splits": back[2],
        }

    out["occ"] = {(name, k): sharded_occurrence_histogram(g, case[name], k, cx=16)
                  for name in ("genomes", "short") for k in case["occ_ks"]}
    out["sweep"] = {tuple(ks): sharded_occurrence_histograms_sweep(g, case["genomes"], ks, cx=16)
                    for ks in case["sweep_ks"]}

    members, ks = case["classify_members"], case["classify_ks"]
    n = len(members)
    out["classify"] = {
        "pivot_rest": dkc.sharded_pivot_rest_counts_sweep(g, members, ks),
        "multi_pivot": dkc.sharded_multi_pivot_counts_sweep(g, members[:4], 2, ks),
        "containment": dkc.sharded_containment_counts_sweep(g, members, 2, n - 2, ks),
        "buckets": dkc.sharded_feature_buckets_sweep(g, members, n - 1, ks, cap=5),
    }
    return out


def run_cli(argvs):
    """khoice_tpu_torch.cli.main on each argv in turn, in this rank: the
    exit codes (the exception's class name where one raised), and whether
    jax was imported."""
    from khoice_tpu_torch.cli import main

    out = []
    for argv in argvs:
        try:
            out.append(main(argv))
        except Exception as exc:  # noqa: BLE001 - reported to the test
            out.append(type(exc).__name__)
    return out, "jax" in sys.modules
