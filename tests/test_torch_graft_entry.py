"""__graft_entry_torch__.py, the port's entry hooks, on the CPU: entry()'s
fused exp1 step against __graft_entry__.entry()'s on the same seeded
members (the histogram, and the count table's valid keys and counts with
the JAX table's capacity padding dropped), and dryrun_multichip on two
gloo ranks (its own checks hold every rank to the single-device engine
and the oracle).  Every value is an integer, so the tolerance is exact
equality."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import __graft_entry__ as jax_graft  # noqa: E402
import __graft_entry_torch__ as graft  # noqa: E402

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)


def test_entry_equals_jax_entry():
    jfn, jargs = jax_graft.entry()
    jhist, jkeys, jcounts = jfn(*jargs)
    fn, args = graft.entry(device="cpu")
    hist, keys, counts = fn(*args)
    assert args[2] == 31 and int(jargs[2]) == 31
    assert hist.tolist() == np.asarray(jhist).astype(np.int64).tolist()
    assert int(hist.sum()) > 0
    # the JAX table's run form: each key's count at its run's first slot,
    # the other slots and the capacity padding 0
    jc = np.asarray(jcounts)
    live = jc > 0
    want_keys = np.stack([np.asarray(w)[live] for w in jkeys]).astype(np.int64)
    assert keys.shape == want_keys.shape
    assert np.array_equal(keys.numpy(), want_keys)
    assert np.array_equal(counts.numpy(), jc[live].astype(np.int64))


def test_dryrun_multichip_two_gloo_ranks(capsys):
    graft.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "ok on 2 rank(s) (gloo, cpu)" in out
    assert "max occurrence=3" in out


def test_dryrun_multichip_needs_cuda_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        graft.dryrun_multichip(1)
    with pytest.raises(SystemExit, match="no CUDA device"):
        graft.entry()
