"""The port's MEM layer (khoice_tpu_torch/mems/, native/ms_engine.cpp,
pipelines/mem_common.py, exp5/7/8) vs the JAX package's on the CPU: the
cases of tests/test_mems.py through both packages.  Every compared value
is an integer array or the bytes of a file, so the tolerance is exact
equality throughout."""

import dataclasses
import os

import numpy as np
import pytest

from conftest import random_dna
from khoice_tpu.mems import ms as jax_ms
from khoice_tpu.mems.extract import extract_half_mems as jax_extract_half_mems
from khoice_tpu.mems.extract import extract_mems as jax_extract_mems
from khoice_tpu.pipelines.exp5 import run_exp5 as jax_run_exp5
from khoice_tpu.pipelines.exp7 import run_exp7 as jax_run_exp7
from khoice_tpu.pipelines.exp8 import run_exp8 as jax_run_exp8
from khoice_tpu.pipelines.exp8 import simulate_exp8_reads as jax_simulate_exp8_reads
from khoice_tpu_torch.mems import ms
from khoice_tpu_torch.mems.extract import extract_half_mems, extract_mems
from khoice_tpu_torch.pipelines.exp5 import run_exp5
from khoice_tpu_torch.pipelines.exp7 import run_exp7
from khoice_tpu_torch.pipelines.exp8 import run_exp8, simulate_exp8_reads
from test_mems import brute_ms, make_mem_world
from test_torch_classify import _tree

PKG = os.path.dirname(os.path.dirname(os.path.abspath(ms.__file__)))


def _indexes(text):
    """The port's native and Python indexes and the JAX package's engine."""
    assert jax_ms._build_lib() is not None
    return (ms.MatchingStatisticsIndex(text), ms.MatchingStatisticsIndex(text, native=False),
            jax_ms.MatchingStatisticsIndex(text))


def test_native_engine_builds_into_the_port():
    lib = ms._build_lib()
    assert os.path.samefile(lib._name, os.path.join(PKG, "_build", "libkhoice_ms.so"))
    assert ms.MatchingStatisticsIndex("ACGT")._handle is not None


def test_matching_statistics_equal_jax_and_brute(rng):
    text = random_dna(rng, 500)
    idxs = _indexes(text)
    for _ in range(5):
        q = random_dna(rng, 40)
        q = q[:10] + text[100:120] + q[30:]  # a guaranteed match
        want = brute_ms(text, q)
        for idx in idxs:
            assert idx.matching_statistics(q).tolist() == want


def test_batch_matching_statistics_equal_jax_and_brute(rng):
    """Zero matches, an exact substring, a repeat family and symbols absent
    from the text, through the batch path of each index."""
    text = random_dna(rng, 400) + "ACGT" * 50 + random_dna(rng, 200)
    reads = [
        random_dna(rng, 35),
        text[50:120],
        "ACGT" * 12,
        random_dna(rng, 10) + text[500:540] + random_dna(rng, 10),
        "N" * 20,
    ]
    port, py, jax_idx = _indexes(text)
    want = [brute_ms(text, q) for q in reads]
    for idx in (port, py, jax_idx):
        assert [m.tolist() for m in idx.batch_matching_statistics(reads)] == want
    assert [port.matching_statistics(q).tolist() for q in reads] == want
    assert port.batch_matching_statistics([]) == []


def test_batch_matching_statistics_no_cross_read_leak(rng):
    """A pattern shared by two reads but absent from the text does not
    inflate MS (the batch SA's unique separators)."""
    text = random_dna(rng, 300)
    shared = "TTTTGGGGCCCCAAAATTTT"
    assert shared not in text
    reads = [shared + random_dna(rng, 20), random_dna(rng, 20) + shared]
    port, _py, jax_idx = _indexes(text)
    got = [m.tolist() for m in port.batch_matching_statistics(reads)]
    assert got == [m.tolist() for m in jax_idx.batch_matching_statistics(reads)]
    assert got == [brute_ms(text, q) for q in reads]


def test_locate_equals_jax(rng):
    text = random_dna(rng, 300)
    idxs = _indexes(text)
    pos = idxs[0].locate(text[50:80])
    assert pos >= 0 and text[pos:pos + 30] == text[50:80]
    for pattern in (text[50:80], text[:1], text[-7:], "N" * 10, random_dna(rng, 25), ""):
        got = [idx.locate(pattern) for idx in idxs]
        assert got[0] == got[2], pattern
        assert (got[1] >= 0) == (got[0] >= 0), pattern
        if got[1] >= 0:
            assert text[got[1]:got[1] + len(pattern)] == pattern
    assert idxs[0].contains(text[10:40]) and not idxs[0].contains("N")


@pytest.mark.parametrize("seq,ms_row,threshold", [
    ("ACGTACGTACGT", [5, 4, 3, 6, 5, 4, 3, 2, 1, 1, 1, 1], 3),
    ("ACGTACGTACGT", [5, 4, 3, 6, 5, 4, 3, 2, 1, 1, 1, 1], 4),
    ("A" * 1200, [1100] * 1200, 5),  # the 1000 cap: the name keeps the length
])
def test_extract_equals_jax(seq, ms_row, threshold):
    row = np.array(ms_row)
    for port, ref in ((extract_mems, jax_extract_mems), (extract_half_mems, jax_extract_half_mems)):
        got = [dataclasses.astuple(f) for f in port([seq, seq[:5]], [row, row[:5]], threshold)]
        want = [dataclasses.astuple(f) for f in ref([seq, seq[:5]], [row, row[:5]], threshold)]
        assert got == want and got
    half = extract_half_mems([seq], [row], threshold)
    assert len(half) == int((row >= threshold).sum())
    assert all(len(f.seq) <= 1000 and f"_length_{f.length}" in f.name for f in half)
    assert len(half[0].seq) == min(len(seq), int(row[0]), 1000)


def test_exp5_files_equal_jax(rng, tmp_path):
    pivots, datasets = make_mem_world(rng)
    got = run_exp5(pivots, datasets, str(tmp_path / "port"), threshold=10)
    jax_run_exp5(pivots, datasets, str(tmp_path / "jax"), threshold=10)
    files = _tree(tmp_path / "port")
    assert files == _tree(tmp_path / "jax")
    assert "sam_type_5/mems/pivot_1_align_dataset_2.sam" in files
    assert "mems_type_5/pivot_2.fastq" in files
    rows = open(got["mems"]["confusion_matrix"]).read().strip().split("\n")
    cm = np.array([[float(x) for x in r.split(",")] for r in rows])
    assert cm[0, 0] > cm[0, 1] and cm[1, 1] > cm[1, 0]  # the markers decide


def test_exp7_files_equal_jax(rng, tmp_path):
    """Both read types at trial 3 (the four trial CSVs), and the legacy
    form without a read type."""
    pivots, datasets = make_mem_world(rng)
    reads = {
        "illumina": {num: [pivots[num][0][i:i + 60] for i in range(0, 120, 20)]
                     for num in pivots},
        "ont": {num: [datasets[num][0][0][:120], datasets[num][1][0][:90]] for num in pivots},
    }
    for name, arg in (("typed", reads), ("legacy", reads["illumina"])):
        run_exp7(arg, datasets, str(tmp_path / name / "port"), threshold=10, trial=3)
        jax_run_exp7(arg, datasets, str(tmp_path / name / "jax"), threshold=10, trial=3)
        files = _tree(tmp_path / name / "port")
        assert files == _tree(tmp_path / name / "jax")
    for mt in ("mems", "half_mems"):
        for rt in ("illumina", "ont"):
            assert f"final_output_type_7/trial_3_{mt}_{rt}.csv" in _tree(tmp_path / "typed" / "port")
    cm = _tree(tmp_path / "typed/port")["output_type_7/mems/ont/confusion_matrix.csv"]
    assert cm == b"2,0\r\n0,2\r\n"


def test_exp8_files_equal_jax(rng, tmp_path):
    pivots, datasets = make_mem_world(rng)
    pivots = {num: [p[0] * 8] for num, p in pivots.items()}  # long enough for ONT reads
    reads = simulate_exp8_reads(pivots, num_reads=3, seed=0)
    assert reads == jax_simulate_exp8_reads(pivots, num_reads=3, seed=0)
    assert all(len(reads[rt][num]) == 3 for rt in reads for num in pivots)
    run_exp8(reads, datasets, str(tmp_path / "port"), t_values=[1, 20])
    jax_run_exp8(reads, datasets, str(tmp_path / "jax"), t_values=[1, 20])
    files = _tree(tmp_path / "port")
    assert files == _tree(tmp_path / "jax")
    for mt in ("mems", "half_mems"):
        for t in (1, 20):
            for rt in ("illumina", "ont"):
                assert f"output_type_8/{mt}/t_{t}/{rt}/confusion_matrix.csv" in files


@pytest.mark.parametrize("fault", ["broken source", "no compiler"])
def test_failed_build_raises_without_fallback(tmp_path, monkeypatch, fault):
    """A build that fails raises with the compiler's message; no index is
    made from the Python suffix list behind the caller's back."""
    monkeypatch.setattr(ms, "_LIB", None)
    monkeypatch.setattr(ms, "_BUILD_DIR", str(tmp_path / "build"))
    if fault == "broken source":
        src = tmp_path / "ms_engine.cpp"
        src.write_text("extern \"C\" int ms_build( { this is not C++\n")
        monkeypatch.setattr(ms, "_SOURCE", str(src))
        match = "(?s)g\\+\\+ failed .*error"
    else:
        monkeypatch.setenv("PATH", str(tmp_path / "empty"))
        match = "cannot run g\\+\\+"
    with pytest.raises(ms.NativeEngineError, match=match):
        ms.MatchingStatisticsIndex("ACGTACGT")
    assert not os.path.exists(tmp_path / "build" / "libkhoice_ms.so")
    assert os.listdir(tmp_path / "build") == []  # the temporary file went too
    # the Python index stays reachable when asked for
    assert ms.MatchingStatisticsIndex("ACGTACGT", native=False).locate("GTAC") == 2
