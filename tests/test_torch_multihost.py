"""The port's multi-process entry points (khoice_tpu_torch/dist/multihost.py)
in two real processes, on the CPU.

Two processes are started with subprocess, each on its own as a process on
another host would be (tests/torch_multihost_worker.py): each joins the
group over env:// on gloo (dist/mesh.py::init_multihost) and runs
multihost_occurrence_histogram, multihost_occurrence_histograms_sweep and
multihost_read_votes_multi on the same seeded dataset.  Both processes
must agree with each other and with the port's single-device results,
exactly (integer counts).  The JAX twin is tests/test_multihost.py (slow:
its processes compile); the port's take a few seconds.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIST_KS = (11, 31)
SWEEP_KS = (9, 15, 21, 33)
VOTE_KS = (11, 21, 33)


def dataset():
    """(members, vote groups, read matrices), the same in every process: 5
    genomes of 1500 bases sharing a 700-base core (tests/test_multihost.py's
    shape), the first 3 as exp6's datasets, and reads from each of them."""
    from khoice_tpu_torch.io.packing import encode_records
    from khoice_tpu_torch.pipelines.exp6 import reads_matrix

    rng = np.random.default_rng(4242)
    genomes = ["".join("ACGT"[c] for c in rng.integers(0, 4, 1500)) for _ in range(5)]
    core = genomes[0][200:900]
    genomes = [g[:200] + core + g[900:] for g in genomes]
    members = [encode_records([g]) for g in genomes]
    mats = [reads_matrix([genomes[m][i:i + 60] for i in range(0, 180, 60)] + ["A" * 30])
            for m in range(3)]
    return members, members[:3], mats


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_equal_single_device(tmp_path):
    from khoice_tpu_torch.classify import annotate as tann
    from khoice_tpu_torch.engine.ksweep import occurrence_histograms_sweep
    from khoice_tpu_torch.engine.occurrence import occurrence_histogram

    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    worker = os.path.join(REPO, "tests", "torch_multihost_worker.py")
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, worker, str(port), str(r), "2", str(outs[r])],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = [json.loads(o.read_text()) for o in outs]
    assert [r["rank"] for r in res] == [0, 1] and [r["rows"] for r in res] == [[0], [1]]
    assert not any(r["jax"] for r in res)
    for key in ("hist", "sweep", "votes"):
        assert res[0][key] == res[1][key], key

    members, vote_groups, mats = dataset()
    got = res[0]
    for k in HIST_KS:
        want = occurrence_histogram(members, k, "cpu", cx=8)
        assert got["hist"][str(k)] == want and any(want), f"k={k}"
    want = occurrence_histograms_sweep(members, list(SWEEP_KS), "cpu", cx=8)
    assert {int(k): v for k, v in got["sweep"].items()} == want
    texts = tann.pack_group_texts(vote_groups, "cpu")
    big, spans = tann.concat_flat_reads([tann.flat_reads_device(m, "cpu") for m in mats])
    for k in VOTE_KS:
        want = [[a.tolist() for a in t]
                for t in tann.read_votes_bulk_multi(texts, big, spans, k, len(vote_groups))]
        assert got["votes"][str(k)] == want, f"votes k={k}"


def test_limits_of_the_per_k_entry():
    """At most 256 members and k <= 60, as in the JAX package (checked
    before any collective)."""
    from khoice_tpu_torch.dist.multihost import multihost_occurrence_histogram

    codes = np.zeros(10, np.uint8)
    with pytest.raises(ValueError, match="256 members"):
        multihost_occurrence_histogram(None, [codes] * 257, 11)
    with pytest.raises(ValueError, match="k<=60"):
        multihost_occurrence_histogram(None, [codes] * 3, 61)
