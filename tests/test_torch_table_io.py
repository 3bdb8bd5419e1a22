"""The port's table persistence (khoice_tpu_torch/engine/table_io.py and
kmc_format.py) vs the JAX package's on the CPU: the cases of
tests/test_table_io.py and tests/test_kmc_format.py through both packages,
and files written by each package loaded by the other.  Keys and counts
are integers and files are compared as bytes, so the tolerance is exact
equality throughout."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna
from khoice_tpu import oracle
from khoice_tpu.engine import count_codes as jax_count_codes
from khoice_tpu.engine import kmc_format as jax_kmc
from khoice_tpu.engine import table_io as jax_io
from khoice_tpu.io import encode_records
from khoice_tpu_torch.engine import kmc_format, table_io
from khoice_tpu_torch.engine.ops import count_codes


def _tables(rng, k, length=500):
    """The same sequence counted by the port (on the CPU) and the JAX
    package."""
    codes = encode_records([random_dna(rng, length, n_prob=0.01), random_dna(rng, length // 3)])
    port = count_codes(torch.from_numpy(codes), k)
    ref = jax_count_codes(jnp.asarray(codes), k)
    assert port.dump() == ref.dump()
    return port, ref


def _bytes(path):
    with open(path, "rb") as fd:
        return fd.read()


@pytest.mark.parametrize("k", [9, 13, 21, 35])
def test_npz_roundtrip_across_packages(rng, tmp_path, k):
    """save_table's arrays equal the JAX package's, and each package loads
    the other's file to the same table."""
    port, ref = _tables(rng, k)
    table_io.save_table(str(tmp_path / "port.npz"), port)
    jax_io.save_table(str(tmp_path / "jax.npz"), ref)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name
    for path in ("port.npz", "jax.npz"):
        got = table_io.load_table(str(tmp_path / path), device="cpu")
        assert got.k == k and got.device == torch.device("cpu")
        assert got.dump() == port.dump()
        assert jax_io.load_table(str(tmp_path / path)).dump() == port.dump()


@pytest.mark.parametrize("k", [9, 21])
def test_dump_txt_equals_jax(rng, tmp_path, k):
    port, ref = _tables(rng, k, 400)
    table_io.write_dump_txt(str(tmp_path / "port.txt"), port)
    jax_io.write_dump_txt(str(tmp_path / "jax.txt"), ref)
    assert _bytes(tmp_path / "port.txt") == _bytes(tmp_path / "jax.txt")
    lines = _bytes(tmp_path / "port.txt").decode().strip().split("\n")
    assert all(len(line.split("\t")) == 2 for line in lines)
    kmers = [line.split("\t")[0] for line in lines]
    assert kmers == sorted(kmers)
    assert table_io.read_dump_txt(str(tmp_path / "jax.txt"), k, device="cpu").dump() == port.dump()
    assert jax_io.read_dump_txt(str(tmp_path / "port.txt"), k).dump() == port.dump()


@pytest.mark.parametrize("k", [11, 13, 31])
def test_kmc_binary_equals_jax(rng, tmp_path, k):
    """The port's .kmc_pre/.kmc_suf pair is byte-equal to the JAX
    package's for the same table, and each package reads the other's."""
    port, ref = _tables(rng, k, 400)
    pre, suf = table_io.write_kmc_binary(str(tmp_path / "port"), port)
    jpre, jsuf = jax_io.write_kmc_binary(str(tmp_path / "jax"), ref)
    assert _bytes(pre) == _bytes(jpre) and _bytes(suf) == _bytes(jsuf)
    back = table_io.read_kmc_binary(str(tmp_path / "jax"), device="cpu")
    assert back.k == k and back.dump() == port.dump()
    assert jax_io.read_kmc_binary(str(tmp_path / "port")).dump() == port.dump()


def test_empty_table_roundtrips_at_two_words(tmp_path):
    """A table with no keys at k = 21 (two key words) reads back empty."""
    empty = table_io._from_kmers(21, [], [], "cpu")
    assert len(empty) == 0 and empty.n_words == 2
    table_io.write_dump_txt(str(tmp_path / "dump.txt"), empty)
    assert _bytes(tmp_path / "dump.txt") == b""
    back = table_io.read_dump_txt(str(tmp_path / "dump.txt"), 21, device="cpu")
    assert len(back) == 0 and back.n_words == 2


def test_default_lut_prefix_equals_jax():
    for k in range(2, 64):
        for total in (0, 1, 100, 10**6):
            try:
                want = jax_kmc.default_lut_prefix(k, total)
            except ValueError:
                with pytest.raises(ValueError):
                    kmc_format.default_lut_prefix(k, total)
                continue
            p = kmc_format.default_lut_prefix(k, total)
            assert p == want and p >= 1 and (k - p) % 4 == 0, (k, total)


@pytest.mark.parametrize("k", [5, 13, 21, 31])
def test_kmc_database_roundtrip_equals_jax(rng, tmp_path, k):
    seqs = [random_dna(rng, 600, n_prob=0.01), random_dna(rng, 300)]
    counts = oracle.count_kmers(seqs, k)
    pre, suf = kmc_format.write_kmc_database(str(tmp_path / "port"), counts, k)
    jpre, jsuf = jax_kmc.write_kmc_database(str(tmp_path / "jax"), counts, k)
    assert _bytes(pre) == _bytes(jpre) and _bytes(suf) == _bytes(jsuf)
    back, params = kmc_format.read_kmc_database(str(tmp_path / "jax"))
    assert back == counts and list(back) == sorted(counts)  # prefix-major = sorted
    assert params == jax_kmc.read_kmc_database(str(tmp_path / "port"))[1]
    assert params["kmer_length"] == k and params["total_kmers"] == len(counts)
    assert params["both_strands"] is True


def test_counter_sizes_and_saturation_equal_jax(tmp_path):
    counts = {"A" * 7: 255, "C" * 7: 70000}
    for cs_bytes in (1, 2, 4):
        capped = {km: min(v, (1 << (8 * cs_bytes)) - 1) for km, v in counts.items()}
        prefix = str(tmp_path / f"db{cs_bytes}")
        pre, suf = kmc_format.write_kmc_database(prefix, capped, 7, counter_size=cs_bytes)
        jpre, jsuf = jax_kmc.write_kmc_database(prefix + "_jax", capped, 7,
                                                counter_size=cs_bytes)
        assert _bytes(pre) == _bytes(jpre) and _bytes(suf) == _bytes(jsuf)
        back, params = kmc_format.read_kmc_database(prefix)
        assert back == capped and params["counter_size"] == cs_bytes


def test_corrupt_markers_and_bad_kmers_raise(rng, tmp_path):
    counts = oracle.count_kmers([random_dna(rng, 100)], 5)
    pre, suf = kmc_format.write_kmc_database(str(tmp_path / "db"), counts, 5)
    data = _bytes(pre)
    with open(pre, "wb") as fd:
        fd.write(b"XXXX" + data[4:])
    with pytest.raises(ValueError, match="KMCP"):
        kmc_format.read_kmc_database(str(tmp_path / "db"))
    with pytest.raises(ValueError, match="non-ACGT"):
        kmc_format.write_kmc_database(str(tmp_path / "bad"), {"ACNTA": 1}, 5)
    with pytest.raises(ValueError, match="not length"):
        kmc_format.write_kmc_database(str(tmp_path / "bad"), {"ACGT": 1}, 5)
    assert not os.path.exists(str(tmp_path / "bad.kmc_suf"))
