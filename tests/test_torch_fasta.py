"""The port's FASTA reader (khoice_tpu_torch/io/fasta.py): its native
scanner raises when it cannot be built, where the JAX package's copy falls
back to the Python loop; KHOICE_NO_NATIVE=1 is the one way to that loop,
and both give the JAX package's records and codes.  The pooled read of many
files (`read_fasta_files`, the database's through
pipelines/exp0.load_database_dir) gives read_fasta's records, or their
codes as io/packing.encode_records joins them, at every pool width."""

import gzip
import os

import numpy as np
import pytest
import torch

from khoice_tpu.io.fasta import read_fasta as jax_read_fasta
from khoice_tpu_torch.io import fasta
from khoice_tpu_torch.io.packing import encode_records
from khoice_tpu_torch.pipelines.exp0 import load_database_dir

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

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
    for read in (fasta.read_fasta, fasta.read_fasta_codes,
                 lambda p: fasta.read_fasta_files([p, p], codes=True)):
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


# awkward files for the pooled reader: (file name, text, gzip members)
AWKWARD = [
    ("multi.fna", ">a one\nACGTNACGT\nGGCC\n>b\nTTTT\n>c\nA\n", 1),
    ("lower.fna.gz", ">low\nacgtnrykm\nAcGt\n", 1),
    ("iupac.fa", ">iu\nACGTRYKMSWBDHVN\nNNNNACGT\n>iu2\nnnnn\n", 1),
    ("crlf.fna.gz", ">crlf desc\r\nACGT\r\nTTGA\r\n\r\n>crlf2\r\nGG\r\n", 1),
    ("blank.fna", "\n\n>bl\n\nACGT\n\n\nCCGG\n\n>bl2\n\nT\n\n", 1),
    ("noseq.fna.gz", ">empty\n>full\nACGTACGT\n>empty_last\n", 1),
    ("twomember.fna.gz", TEXT, 2),
    ("bare.fna", ">x\nACGTTGCA", 1),
    ("nothing.fna", "", 1),
    ("prefix.fna", "ACGTAC\nGG\n>after\nGGTT\n", 1),  # bases before the first header
]


def _write_awkward(root):
    paths = []
    for name, text, members in AWKWARD:
        path = os.path.join(root, name)
        if name.endswith(".gz"):
            cut = len(text) // members
            with open(path, "wb") as fd:  # each member a gzip stream of its own
                for i in range(members):
                    fd.write(gzip.compress(text[i * cut:(i + 1) * cut if i + 1 < members else None]
                                           .encode()))
        else:
            with open(path, "w", newline="") as fd:
                fd.write(text)
        paths.append(path)
    return paths


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("cpus", [1, 2, 8])
def test_pooled_read_equals_read_fasta(monkeypatch, tmp_path, cpus, native):
    """read_fasta_files at pool widths 1, 2 and 8, with the native scanner
    and with the Python loop: the str form is read_fasta's records (and the
    JAX package's, which inflates through gzip.open), the codes form
    encode_records of them, byte for byte."""
    paths = _write_awkward(str(tmp_path)) * 2
    for var in ("WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    if not native:
        monkeypatch.setenv("KHOICE_NO_NATIVE", "1")
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)))
    assert fasta.pool_width(len(paths)) == cpus
    records = [[(r.name, r.seq) for r in fasta.read_fasta(p)] for p in paths]
    assert records == [[(r.name, r.seq) for r in jax_read_fasta(p)] for p in paths]
    got = fasta.read_fasta_files(paths)
    assert [[(r.name, r.seq) for r in recs] for recs in got] == records
    codes = fasta.read_fasta_files(paths, codes=True)
    assert len(codes) == len(paths)
    for arr, recs in zip(codes, records, strict=True):
        want = encode_records([seq for _, seq in recs])
        assert arr.dtype == np.uint8 and arr.tobytes() == want.tobytes()
    assert records[6][0] == ("rec1", "ACGTACGTNNGGGCCCTTT")  # both gzip members read
    assert [n for n, _ in records[6]] == ["rec1", "rec2", "rec3", "empty_seq", "last"]


@pytest.mark.parametrize(("env", "cpus", "n_files", "width"), [
    ({}, 8, 32, 8),
    ({}, 8, 3, 3),
    ({}, 8, 0, 1),
    ({"WORLD_SIZE": "4"}, 8, 32, 2),
    ({"WORLD_SIZE": "8", "LOCAL_WORLD_SIZE": "4"}, 32, 192, 8),
    ({"LOCAL_WORLD_SIZE": "3"}, 8, 32, 2),
    ({"WORLD_SIZE": "16"}, 8, 32, 1),
])
def test_pool_width(monkeypatch, env, cpus, n_files, width):
    """The CPUs this process may run on over the ranks of this host
    (LOCAL_WORLD_SIZE, else WORLD_SIZE, else 1), within [1, n_files]."""
    for var in ("WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)))
    assert fasta.pool_width(n_files) == width


def _serial_database(root):
    """The database as one loop over its files reads it, file by file."""
    out, i = {}, 1
    while os.path.isdir(os.path.join(root, f"dataset_{i}")):
        ddir = os.path.join(root, f"dataset_{i}")
        out[i] = {}
        for f in sorted(os.listdir(ddir)):
            if f.endswith((".fna.gz", ".fna", ".fa")):
                name = f.split(".fna")[0].split(".fa")[0]
                out[i][name] = [r.seq for r in fasta.read_fasta(os.path.join(ddir, f))]
        i += 1
    return out


def test_database_order_and_counter(monkeypatch, tmp_path):
    """load_database_dir: datasets in order, genomes by sorted file name
    (files written in another order, gzipped or not, a file that is no
    FASTA left out, a dataset with none), the str form equal to a serial
    read and the codes form to its encode_records; the pool's counter
    counts each file once a read, by form."""
    root = tmp_path / "db"
    texts = [text for _, text, _ in AWKWARD]
    layout = {1: ["g_b.fna.gz", "g_a.fna", "g_c.fa", "z.fna.gz"], 2: [], 3: ["b.fna", "a.fna.gz"]}
    n_files = 0
    for num, files in layout.items():
        (root / f"dataset_{num}").mkdir(parents=True)
        (root / f"dataset_{num}" / "notes.txt").write_text(">no\nACGT\n")
        for f in files:
            text = texts[n_files % len(texts)]
            if f.endswith(".gz"):
                with gzip.open(root / f"dataset_{num}" / f, "wt") as fd:
                    fd.write(text)
            else:
                (root / f"dataset_{num}" / f).write_text(text)
            n_files += 1
    monkeypatch.setattr(fasta, "pooled_files", {"codes": 0, "str": 0})
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(4)))
    want = _serial_database(str(root))
    got = load_database_dir(str(root))
    assert fasta.pooled_files == {"codes": 0, "str": n_files}
    codes = load_database_dir(str(root), codes=True)
    assert fasta.pooled_files == {"codes": n_files, "str": n_files}
    assert list(got) == list(codes) == [1, 2, 3]
    assert [list(got[n]) for n in got] == [["g_a", "g_b", "g_c", "z"], [], ["a", "b"]]
    assert got == want
    for num in want:
        assert list(codes[num]) == list(want[num])
        for name, seqs in want[num].items():
            assert codes[num][name].tobytes() == encode_records(seqs).tobytes()
