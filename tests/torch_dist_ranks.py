"""Rank programs of tests/test_torch_dist.py, tests/test_torch_dist_vote.py,
tests/test_torch_dist_cli.py, tests/test_torch_dist_exchange.py and
tests/test_torch_dist_barrier.py.

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


def votes(cases, device="cpu"):
    """dist/vote.py::sharded_read_votes_multi on each case of
    tests/test_torch_dist_vote.py (name -> groups, read matrices, ks,
    bucket_cap), at this group's world size: the votes as lists, and the
    query windows this rank received in each call of read_votes (the
    validity it gives the kernel's wrapper, counted here).  With device
    "cuda" every rank takes cuda:0 (gloo takes CUDA tensors, so the ranks
    share one card)."""
    import torch
    import torch.distributed as dist

    from khoice_tpu_torch.dist.mesh import KvGroup
    from khoice_tpu_torch.dist.vote import sharded_read_votes_multi
    from khoice_tpu_torch.kernels import vote as kvote

    if device == "cpu":
        g = init_kv_group("cpu")
    else:
        g = KvGroup(rank=dist.get_rank(), world_size=dist.get_world_size(),
                    device=torch.device("cuda", 0))
    received = []
    read_votes = kvote.read_votes

    def counted(qmask, valid, *args):
        received.append(int(valid.sum()))
        return read_votes(qmask, valid, *args)

    kvote.read_votes = counted
    out = {"jax": "jax" in sys.modules, "world_size": g.world_size}
    try:
        for name, case in cases.items():
            received.clear()
            got = sharded_read_votes_multi(g, case["groups"], case["mats"], case["ks"],
                                           bucket_cap=case["bucket_cap"])
            out[name] = {"votes": {k: [[a.tolist() for a in t] for t in v]
                                   for k, v in got.items()},
                         "received": list(received)}
    finally:
        kvote.read_votes = read_votes
    return out


def exchange_count(case):
    """dist/mesh.py's counter of rows exchanged, in this rank, over: a
    hand-made exchange of known uneven shares (`case["shares"][rank]`), the
    tables' count (dist/sharded.py), exp1's sweep (dist/ksweep.py), the
    per-k occurrence (dist/occurrence.py) and exp6's votes (dist/vote.py).
    Each step's counts are returned beside the rows that
    torch.distributed.all_to_all_single moved with split sizes in that
    step (watched here, this rank's share for itself left out), and the
    run's totals as exchange_totals gathers them on every rank."""
    import torch
    import torch.distributed as dist

    from khoice_tpu_torch.dist import mesh
    from khoice_tpu_torch.dist.vote import sharded_read_votes_multi

    g = init_kv_group("cpu")
    seen = {"sent": 0, "received": 0}
    all_to_all_single = dist.all_to_all_single

    def watched(output, input, output_split_sizes=None, input_split_sizes=None, **kw):
        if input_split_sizes is not None:  # rows; the counts go without splits
            seen["sent"] += sum(input_split_sizes) - input_split_sizes[g.rank]
            seen["received"] += sum(output_split_sizes) - output_split_sizes[g.rank]
        return all_to_all_single(output, input, output_split_sizes, input_split_sizes, **kw)

    def hand():
        shares = case["shares"][g.rank]
        rows = torch.arange(sum(shares) * 3, dtype=torch.int64).view(-1, 3)
        return mesh.exchange_rows(rows, shares, mesh.exchange_counts(shares, g)).shape[0]

    steps = [
        ("hand", hand),
        ("count", lambda: sh.sharded_count_codes(g, case["codes"], 21)),
        ("sweep", lambda: sharded_occurrence_histograms_sweep(g, case["genomes"], [11, 21, 31])),
        ("occurrence", lambda: sharded_occurrence_histogram(g, case["genomes"], 15)),
        ("votes", lambda: sharded_read_votes_multi(g, case["genomes"], case["mats"], [11, 21])),
    ]
    before = dict(mesh.exchanged)
    out = {"rank": g.rank, "steps": {}}
    dist.all_to_all_single = watched
    try:
        for name, fn in steps:
            counted, watched_before = dict(mesh.exchanged), dict(seen)
            result = fn()
            out["steps"][name] = {
                "counted": {key: mesh.exchanged[key] - counted[key] for key in counted},
                "watched": {key: seen[key] - watched_before[key] for key in seen},
            }
            if name == "hand":
                out["hand_rows"] = result
    finally:
        dist.all_to_all_single = all_to_all_single
    out["own"] = {key: mesh.exchanged[key] - before[key] for key in before}
    out["totals"] = mesh.exchange_totals(g, before)
    return out


def solo_wait(store_path, solo_s, timeout_s):
    """KvGroup.barrier while rank 0 works alone (a sleep of `solo_s`) on a
    gloo group, made anew on the FileStore `store_path`, whose collectives
    time out after `timeout_s` < solo_s; then one all_reduce of ones.
    Returns (when rank 0's work ended, on rank 0, else None; when this rank
    left the barrier; the all_reduce's sum), on the host's clock."""
    import datetime
    import time

    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    g = init_kv_group("cpu", world_size=world)
    done = None
    if rank == 0:
        time.sleep(solo_s)
        done = time.time()
    g.barrier()
    left = time.time()
    ones = torch.ones(1, dtype=torch.int64)
    dist.all_reduce(ones)
    return done, left, int(ones.item())


def cli_repeat(argvs, traced_run):
    """khoice_tpu_torch.cli.main on each argv in turn, in this rank, on the
    group run_ranks initialised (so the CLI does not own it, as a
    long-lived caller's group): for each run its exit code, the rows
    dist/mesh.py's `exchanged` counted over it and the rows
    torch.distributed.all_to_all_single moved with split sizes (watched
    here, this rank's share left out), the counter after it, and the slab
    builds of the run (a wrapper around dist/occurrence.py::_make_slab_pair).
    Run `traced_run` goes under torch.profiler, and every all_to_all_single
    call is annotated `test:all_to_all` (`test:all_to_all_rows` where it
    has split sizes); its trace's user annotations are returned."""
    import json
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, record_function

    from khoice_tpu_torch.cli import main
    from khoice_tpu_torch.dist import mesh
    from khoice_tpu_torch.dist import occurrence as docc

    rank = dist.get_rank()
    seen = {"sent": 0, "received": 0, "slab_builds": 0}
    make_slab_pair = docc._make_slab_pair

    def counted(*args):
        seen["slab_builds"] += 1
        return make_slab_pair(*args)
    all_to_all_single = dist.all_to_all_single

    def watched(output, input, output_split_sizes=None, input_split_sizes=None, **kw):
        label = "test:all_to_all"
        if input_split_sizes is not None:  # rows; the counts go without splits
            label = "test:all_to_all_rows"
            seen["sent"] += sum(input_split_sizes) - input_split_sizes[rank]
            seen["received"] += sum(output_split_sizes) - output_split_sizes[rank]
        with record_function(label):
            return all_to_all_single(output, input, output_split_sizes, input_split_sizes, **kw)

    runs, events = [], []
    dist.all_to_all_single = watched
    docc._make_slab_pair = counted
    try:
        for i, argv in enumerate(argvs):
            counted, watched_before = dict(mesh.exchanged), dict(seen)
            if i == traced_run:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    rc = main(argv)
                fd, path = tempfile.mkstemp(suffix=".json")
                os.close(fd)
                try:
                    prof.export_chrome_trace(path)
                    with open(path) as f:
                        events = [{key: e[key] for key in ("name", "ts", "dur")}
                                  for e in json.load(f)["traceEvents"]
                                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
                finally:
                    os.remove(path)
            else:
                rc = main(argv)
            runs.append({"rc": rc,
                         "counted": {key: mesh.exchanged[key] - counted[key] for key in counted},
                         "watched": {key: seen[key] - watched_before[key]
                                     for key in ("sent", "received")},
                         "slab_builds": seen["slab_builds"] - watched_before["slab_builds"],
                         "after": dict(mesh.exchanged)})
    finally:
        dist.all_to_all_single = all_to_all_single
        docc._make_slab_pair = make_slab_pair
    return {"rank": rank, "runs": runs, "events": events}


def slab_batches(case):
    """The sharded per-k path on one slab, at this group's world size: for
    each member set of `case["sets"]`, dist/occurrence.py's many-k entry
    over `case["ks"]` beside its one-k calls, and exp1's sweep
    (dist/ksweep.py::sharded_occurrence_histograms_sweep over
    run_sweep_plan) on `case["sweep"]` over `case["sweep_ks"]`; each
    with the ks of its slab builds (a wrapper around `_make_slab_pair`)
    and the part counts of the texts it joined whole (a wrapper around
    engine/members.py::join)."""
    from khoice_tpu_torch.dist import occurrence as docc
    from khoice_tpu_torch.engine import members

    g = init_kv_group("cpu")
    builds, joins = [], []
    make, join = docc._make_slab_pair, members.join

    def counted(member_codes, n_shards, k, rank, device):
        builds.append(k)
        return make(member_codes, n_shards, k, rank, device)

    def joined(parts):
        joins.append(len(parts))
        return join(parts)

    def watched(fn):
        builds.clear()
        joins.clear()
        return {"got": fn(), "builds": list(builds), "joins": list(joins)}

    docc._make_slab_pair, members.join = counted, joined
    try:
        out = {"world_size": g.world_size}
        for name, group in case["sets"].items():
            out[name] = {
                "many": watched(lambda: docc.sharded_occurrence_histograms(
                    g, group, case["ks"], cx=case["cx"])),
                "one": watched(lambda: {k: sharded_occurrence_histogram(g, group, k,
                                                                         cx=case["cx"])
                                        for k in case["ks"]}),
            }
        out["sweep"] = watched(lambda: sharded_occurrence_histograms_sweep(
            g, case["sweep"], case["sweep_ks"], cx=case["cx"]))
    finally:
        docc._make_slab_pair, members.join = make, join
    return out
