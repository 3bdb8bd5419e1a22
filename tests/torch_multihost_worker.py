"""Rank program of tests/test_torch_multihost.py: one process of a two-process
group, started on its own as a process on another host would be.

    python tests/torch_multihost_worker.py PORT RANK NPROCS OUT

It joins the group over env:// on gloo (dist/mesh.py::init_multihost with
the coordinator 127.0.0.1:PORT), runs the three multi-process entry points
of the port (dist/multihost.py) on a seeded dataset that every process
builds alike (tests/test_torch_multihost.py::dataset), and writes the
results as JSON to OUT.  It imports the port and numpy, never jax.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    port, rank, nprocs, out = sys.argv[1:5]
    from khoice_tpu_torch.dist import multihost as mh
    from khoice_tpu_torch.dist.mesh import init_multihost

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_multihost import HIST_KS, SWEEP_KS, VOTE_KS, dataset

    group = init_multihost(f"127.0.0.1:{port}", int(nprocs), int(rank), device="cpu")
    members, vote_groups, mats = dataset()
    res = {
        "rank": group.rank,
        "rows": mh.local_shard_rows(group),
        "hist": {k: mh.multihost_occurrence_histogram(group, members, k, cx=8) for k in HIST_KS},
        "sweep": mh.multihost_occurrence_histograms_sweep(group, members, SWEEP_KS, cx=8),
        "votes": {k: [[a.tolist() for a in t] for t in v] for k, v in
                  mh.multihost_read_votes_multi(group, vote_groups, mats, VOTE_KS).items()},
        "jax": "jax" in sys.modules,
    }
    import torch.distributed as dist

    dist.destroy_process_group()
    with open(out, "w") as fd:
        json.dump(res, fd)


if __name__ == "__main__":
    main()
