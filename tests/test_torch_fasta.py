"""The port's FASTA reader (khoice_tpu_torch/io/fasta.py): its native
scanner raises when it cannot be built, where the JAX package's copy falls
back to the Python loop; KHOICE_NO_NATIVE=1 is the one way to that loop,
and both give the JAX package's records and codes."""

import gzip
import os

import numpy as np
import pytest

from khoice_tpu.io.fasta import read_fasta as jax_read_fasta
from khoice_tpu_torch.io import fasta

TEXT = (
    ">rec1 description\nacgtACGTnN\nGGGcccTTT\n\n>rec2\r\nAAAA\r\ncc\r\n"
    "> rec3 trailing words\nTTTTTT\n>empty_seq\n>last\nacgt"
)


@pytest.fixture
def fresh_codec(monkeypatch, tmp_path):
    """The codec unloaded, building into a directory of its own."""
    monkeypatch.setattr(fasta, "_CODEC_LIB", None)
    monkeypatch.setattr(fasta, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delenv("KHOICE_NO_NATIVE", raising=False)
    return tmp_path


@pytest.mark.parametrize("fault", ["broken source", "no compiler"])
def test_failed_build_raises_without_fallback(fresh_codec, monkeypatch, fault):
    tmp_path = fresh_codec
    path = tmp_path / "t.fna"
    path.write_text(TEXT)
    if fault == "broken source":
        native = tmp_path / "native"
        native.mkdir()
        (native / "fasta_codec.cpp").write_text('extern "C" long fasta_scan( { not C++\n')
        monkeypatch.setattr(fasta, "_NATIVE_DIR", str(native))
        match = "(?s)g\\+\\+ failed .*error"
    else:
        monkeypatch.setenv("PATH", str(tmp_path / "empty"))
        match = "cannot run g\\+\\+"
    for read in (fasta.read_fasta, fasta.read_fasta_codes):
        with pytest.raises(fasta.NativeCodecError, match=match):
            read(str(path))
    assert os.listdir(tmp_path / "build") == []  # no library, no temporary left


@pytest.mark.parametrize("gz", [False, True])
def test_native_and_python_loop_equal_jax(fresh_codec, monkeypatch, gz):
    path = fresh_codec / ("t.fna.gz" if gz else "t.fna")
    with (gzip.open(path, "wt") if gz else open(path, "w")) as fd:
        fd.write(TEXT)
    native = [(r.name, r.seq) for r in fasta.read_fasta(str(path))]
    native_codes = fasta.read_fasta_codes(str(path))
    assert fasta._codec_lib() is not None
    monkeypatch.setenv("KHOICE_NO_NATIVE", "1")
    assert fasta._codec_lib() is None
    loop = [(r.name, r.seq) for r in fasta.read_fasta(str(path))]
    loop_codes = fasta.read_fasta_codes(str(path))
    assert native == loop == [(r.name, r.seq) for r in jax_read_fasta(str(path))]
    assert [n for n, _ in native] == ["rec1", "rec2", "rec3", "empty_seq", "last"]
    assert native[0][1] == "ACGTACGTNNGGGCCCTTT"
    for (n1, c1), (n2, c2) in zip(native_codes, loop_codes, strict=True):
        assert n1 == n2
        np.testing.assert_array_equal(c1, c2)
