"""The port's kmc_tools-shaped table layer (khoice_tpu_torch: engine/table.py,
engine/ops.py, engine/session.py, occurrence_table, classify/annotate.py)
and the per-k fallbacks of exp2/3/4 vs the JAX package's, on the CPU.
Tables are compared through `to_host()` (present keys and counts),
histograms and CSVs as integers and bytes: the tolerance is exact
equality throughout."""

import numpy as np
import pytest
import torch

from conftest import random_dna
from khoice_tpu.classify.annotate import build_annotation as jax_build_annotation
from khoice_tpu.classify.annotate import feature_buckets as jax_feature_buckets
from khoice_tpu.engine import ops as jops
from khoice_tpu.engine.occurrence import occurrence_table as jax_occurrence_table
from khoice_tpu.engine.session import KmerEngine as JaxEngine
from khoice_tpu.engine.table import table_from_host as jax_table_from_host
from khoice_tpu.io.packing import encode_records
from khoice_tpu.pipelines.exp2 import run_exp2 as jax_run_exp2
from khoice_tpu.pipelines.exp3 import run_exp3 as jax_run_exp3
from khoice_tpu.pipelines.exp4 import run_exp4 as jax_run_exp4
from khoice_tpu_torch.classify.annotate import build_annotation, feature_buckets
from khoice_tpu_torch.engine import ops
from khoice_tpu_torch.engine.occurrence import occurrence_table
from khoice_tpu_torch.engine.session import KmerEngine
from khoice_tpu_torch.engine.streaming import DeviceBudgetExceeded
from khoice_tpu_torch.engine.table import decode_key, encode_kmer, table_from_host
from khoice_tpu_torch.pipelines.exp2 import run_exp2
from khoice_tpu_torch.pipelines.exp3 import run_exp3, simulate_exp3_reads
from khoice_tpu_torch.pipelines.exp4 import run_exp4
from khoice_tpu_torch.reports.csvio import read_hist_txt
from test_exp023 import make_world

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

KS = (11, 31, 45)  # one, two and four key words


def _same(port, jax_table):
    a, b = port.to_host(), jax_table.to_host()
    assert a[0].dtype == b[0].dtype == np.uint32
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert len(port) == a[1].shape[0]


def _genomes(rng, n, glen=300):
    """n genomes sharing a core, each with SNPs, an N run and a repeat."""
    core = random_dna(rng, glen)
    out = []
    for i in range(n):
        seq = list(core)
        for _ in range(glen // 20):
            seq[rng.randrange(glen)] = "ACGT"[rng.randrange(4)]
        p = rng.randrange(glen - 20)
        seq[p:p + 5] = "NNNNN"
        out.append(["".join(seq) + core[:40] * (i + 4), random_dna(rng, 50)])
    return out


@pytest.mark.parametrize("k", KS)
def test_table_ops_equal_jax(rng, k):
    genomes = _genomes(rng, 3)
    codes = [encode_records(g) for g in genomes]
    eng, jeng = KmerEngine("cpu"), JaxEngine()
    a, ja = eng.count_codes(codes[0], k, cs=3), jeng.count_codes(codes[0], k, cs=3)
    _same(a, ja)
    assert (a.counts == 3).any()  # the repeat saturates at cs
    sets = [eng.set_counts(eng.count_codes(c, k), 1) for c in codes]
    jsets = [jeng.set_counts(jeng.count_codes(c, k), 1) for c in codes]
    for s, js in zip(sets, jsets):
        _same(s, js)
    u, ju = eng.union(sets + [a], cs=4), jeng.union(jsets + [ja], cs=4)
    _same(u, ju)
    assert (u.counts == 4).any()
    for cs in (255, 5):
        _same(eng.intersect_sum(a, u, cs=cs), jeng.intersect_sum(ja, ju, cs=cs))
    _same(eng.subtract(a, sets[1]), jeng.subtract(ja, jsets[1]))
    _same(eng.subtract(sets[1], sets[1]), jeng.subtract(jsets[1], jsets[1]))  # empty
    assert eng.histogram(u, cx=3) == jeng.histogram(ju, cx=3)
    assert eng.histogram(u) == jeng.histogram(ju)
    assert eng.n_present(u) == jeng.n_present(ju)
    assert ops.total_count(u) == int(jops.total_count(ju))
    assert ops.n_present(ops.set_counts(u, 0)) == int(jops.n_present(jops.set_counts(ju, 0))) == 0
    assert a.dump() == ja.dump()


@pytest.mark.parametrize("n_members,k", [(4, 21), (4, 40), (4, 61), (260, 13)])
def test_occurrence_table_equals_jax(rng, n_members, k):
    """The gid-packed layout (4 members, k = 21) and key words with a
    separate gid (k = 61; 260 members)."""
    core = random_dna(rng, 150)
    members = [encode_records([core[: 120 + i % 30] + random_dna(rng, 10)])
               for i in range(n_members)]
    _same(occurrence_table(members, k, "cpu", cs=7), jax_occurrence_table(members, k, cs=7))
    t = occurrence_table(members, k, "cpu")
    assert int(t.counts.max()) == min(n_members, 5000)


def test_table_from_host_dump_and_keys(rng):
    k = 17
    kmers = sorted({random_dna(rng, k) for _ in range(40)}, reverse=True)
    keys = np.stack([encode_kmer(km) for km in kmers])
    counts = np.arange(len(kmers), dtype=np.uint32)  # one zero count: dropped
    t = table_from_host(k, keys, counts, device="cpu")
    jt = jax_table_from_host(k, keys, counts)
    _same(t, jt)
    assert t.dump() == jt.dump()
    assert [km for km, _ in t.dump()] == sorted(kmers[1:])
    assert all(decode_key(encode_kmer(km), k) == km for km in kmers)


@pytest.mark.parametrize("k", [11, 31])
def test_annotation_buckets_equal_jax(rng, k):
    genomes = _genomes(rng, 4)
    eng, jeng = KmerEngine("cpu"), JaxEngine()
    pivot = encode_records(genomes[0] + [genomes[1][0]])
    groups = [encode_records(g) for g in genomes[1:]]
    ann = build_annotation(eng.count_codes(pivot, k, cs=3),
                           [eng.set_counts(eng.count_codes(g, k), 1) for g in groups])
    jann = jax_build_annotation(jeng.count_codes(pivot, k, cs=3),
                                [jeng.set_counts(jeng.count_codes(g, k), 1) for g in groups])
    got, want = feature_buckets(ann), jax_feature_buckets(jann)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[1] > 0 and got[0].sum() > 0


def test_engine_budget_raises():
    eng = KmerEngine("cpu", device_budget_bytes=1000)
    codes = np.zeros(100, np.uint8)
    with pytest.raises(DeviceBudgetExceeded, match="count"):
        eng.count_codes(codes, 21)
    with pytest.raises(DeviceBudgetExceeded, match="occurrence table"):
        eng.occurrence_table([codes, codes], 21)


def _read(path):
    with open(path, "rb") as fd:
        return fd.read()


def test_exp234_per_k_csvs_equal_jax(rng, tmp_path):
    """A 2-k grid sends every k of exp2/3/4 to the per-k table ops."""
    db = make_world(rng, glen=2000)
    pivots = {num: db[num]["genome_%d_0" % num] for num in db}
    rest = {num: [db[num][f"genome_{num}_{g}"] for g in (1, 2)] for num in db}
    ks = [21, 31]
    port = run_exp2(pivots, rest, ks, str(tmp_path / "port"), "cpu")
    ref = jax_run_exp2(pivots, rest, ks, str(tmp_path / "jax"))
    assert _read(port["within"]) == _read(ref["within"])
    assert _read(port["across"]) == _read(ref["across"])
    reads = simulate_exp3_reads(pivots, 1500, seed=5)
    assert (_read(run_exp3(reads, rest, ks, str(tmp_path / "port"), "cpu"))
            == _read(jax_run_exp3(reads, rest, ks, str(tmp_path / "jax"))))
    rest4 = {num: rest[num] + [pivots[num]] for num in rest}
    assert (_read(run_exp4(pivots, rest4, ks, str(tmp_path / "port"), "cpu", count_cs=3))
            == _read(jax_run_exp4(pivots, rest4, ks, str(tmp_path / "jax"), count_cs=3)))
    for k in ks:
        rel = f"accuracies_type_4/confusion_matrix/k_{k}_confusion_matrix_with_unidentified.txt"
        assert _read(tmp_path / "port" / rel) == _read(tmp_path / "jax" / rel)


def test_exp2_large_group_equals_jax(rng, tmp_path):
    """A dataset of 70 rest genomes: its within scope is beyond the sweep's
    64-member mask and takes the per-k path; the across scope sweeps."""
    core = random_dna(rng, 150)
    pivots, rest = {}, {}
    for num, n in ((1, 70), (2, 3)):
        genomes = []
        for i in range(n + 1):
            seq = list(core)
            for _ in range(4 * num - 3):
                seq[rng.randrange(len(seq))] = "ACGT"[rng.randrange(4)]
            genomes.append(["".join(seq) + random_dna(rng, 10 + i % 5)])
        pivots[num], rest[num] = genomes[0], genomes[1:]
    ks = [9, 12, 21]
    port = run_exp2(pivots, rest, ks, str(tmp_path / "port"), "cpu")
    ref = jax_run_exp2(pivots, rest, ks, str(tmp_path / "jax"))
    assert _read(port["within"]) == _read(ref["within"])
    assert _read(port["across"]) == _read(ref["across"])
    rel = "within_dataset_results_type_2/k_21/dataset_1/intersect/dataset_1_pivot_intersect_group.hist.txt"
    assert _read(tmp_path / "port" / rel) == _read(tmp_path / "jax" / rel)
    assert sum(read_hist_txt(str(tmp_path / "port" / rel))[40:]) > 0  # > 40 rest members
