"""The rest of the port's surface vs the JAX package's, on the CPU: the
package-level names of engine, classify and dist, the one-pass k-sweep
extraction (engine/extract.py::extract_canonical_sweep) and the
dict-based oracle (oracle/), each on the same seeded inputs.  Keys and
counts are integers, so the tolerance is exact equality.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khoice_tpu import oracle as joracle
from khoice_tpu.engine.extract import extract_canonical_sweep as jax_sweep
from khoice_tpu.io.packing import encode_records
from khoice_tpu_torch import oracle as toracle
from khoice_tpu_torch.engine import extract_canonical, extract_canonical_sweep

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

SWEEP_KS = tuple(range(7, 50))


@pytest.mark.parametrize("package", ["engine", "classify", "dist"])
def test_package_level_names_match(package):
    """`from khoice_tpu_torch.<package> import name` works for every name
    the JAX package's <package> exports, and no other."""
    jax_mod = importlib.import_module(f"khoice_tpu.{package}")
    port_mod = importlib.import_module(f"khoice_tpu_torch.{package}")
    assert sorted(port_mod.__all__) == sorted(jax_mod.__all__)
    for name in jax_mod.__all__:
        assert getattr(port_mod, name) is not None, name


def _codes():
    """Random bases with N runs, single Ns and record separators (4s)."""
    rng = np.random.default_rng(31)
    seqs = []
    for i in range(3):
        s = list("".join("ACGT"[c] for c in rng.integers(0, 4, 700 + 50 * i)))
        for p in rng.choice(len(s), 6, replace=False):
            s[p] = "N"
        s[100 * (i + 1):100 * (i + 1) + 20] = "N" * 20
        seqs.append("".join(s))
    seqs.append("ACGT" * 20)  # palindromic windows: forward == reverse complement
    return encode_records(seqs)


def test_extract_canonical_sweep_equals_jax_and_per_k():
    """Every k of 7-49 from one pass: the JAX package's sweep's keys and
    validity, and the port's per-k extraction (kernel A's plain version)."""
    codes = _codes()
    got = extract_canonical_sweep(torch.from_numpy(codes), SWEEP_KS)
    want = jax_sweep(jnp.asarray(codes), SWEEP_KS)
    assert sorted(got) == list(SWEEP_KS)
    for k in SWEEP_KS:
        keys, valid = got[k]
        jkeys, jvalid = want[k]
        np.testing.assert_array_equal(keys.numpy(), np.stack([np.asarray(w) for w in jkeys])
                                      .astype(np.int64), err_msg=f"k={k}")
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid), err_msg=f"k={k}")
        one_keys, one_valid = extract_canonical(torch.from_numpy(codes), k)
        assert torch.equal(keys, one_keys) and torch.equal(valid, one_valid), f"k={k}"
        assert 0 < int(valid.sum()) < codes.shape[0]


def test_oracle_equals_jax_oracle():
    """The port's copy of the dict-based oracle gives the JAX package's
    answers on the same sequences."""
    rng = np.random.default_rng(5)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, 300)) + "N" + "AC" * 30
            for _ in range(3)]
    assert toracle.__all__ == joracle.__all__
    for k in (3, 11, 21):
        a, b = (mod.count_kmers(seqs[:2], k, cs=3) for mod in (toracle, joracle))
        assert a == b and len(a) > 10
        c = toracle.count_kmers(seqs[2:], k)
        for name, args in (("set_counts", (a, 2)), ("union_sum", ([a, c], 4)),
                           ("intersect_sum", (a, c, 5)), ("subtract", (a, c)),
                           ("histogram", (a, 8)), ("sorted_dump", (a,))):
            assert getattr(toracle, name)(*args) == getattr(joracle, name)(*args), (name, k)
    for km in ("GAT", "ACGT", "TTTTA"):
        assert toracle.canonical(km) == joracle.canonical(km)
        assert toracle.revcomp(km) == joracle.revcomp(km)
