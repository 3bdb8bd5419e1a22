"""The port's key-range SPMD path (khoice_tpu_torch/dist/) vs the JAX
package's (khoice_tpu/dist/) and the port's single-device engine, on the
CPU.

The port's ranks run on gloo through dist/launch.py::run_ranks at world
sizes 1, 2 and 3, one call per world size (the rank program is
tests/torch_dist_ranks.py::battery); the JAX package runs on the
conftest's virtual CPU devices.  At world size 2 the port is held to the
JAX package's sharded result on a 2-device mesh, at 1 and 3 to its
single-device result (its own tests hold the two equal at every device
count), and at every world size to the port's single-device result and,
for the tables, to the JAX package's dict-based oracle.  Every value is an
integer count, so the tolerance is exact equality.  Mirrors
tests/test_sharded.py, tests/test_sharded_occurrence.py,
tests/test_dist_ksweep.py and tests/test_dist_classify.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks
from conftest import cpu_devices
from khoice_tpu import oracle
from khoice_tpu.dist import make_mesh as jax_make_mesh
from khoice_tpu.dist import ksweep_classify as jdkc
from khoice_tpu.dist import sharded as jsh
from khoice_tpu.dist.ksweep import sharded_occurrence_histograms_sweep as jax_sharded_sweep
from khoice_tpu.dist.occurrence import sharded_occurrence_histogram as jax_sharded_occ
from khoice_tpu.engine import count_codes as jax_count_codes
from khoice_tpu.engine import histogram as jax_histogram
from khoice_tpu.engine import intersect_sum as jax_intersect_sum
from khoice_tpu.engine import set_counts as jax_set_counts
from khoice_tpu.engine import subtract as jax_subtract
from khoice_tpu.engine import union_many as jax_union_many
from khoice_tpu.engine import ksweep_classify as jkc
from khoice_tpu.engine.ksweep import occurrence_histograms_sweep as jax_sweep
from khoice_tpu.engine.occurrence import occurrence_histogram as jax_occ
from khoice_tpu.io.packing import encode_records
from khoice_tpu_torch.dist.launch import run_ranks
from khoice_tpu_torch.engine import ksweep_classify as tkc
from khoice_tpu_torch.engine.ksweep import occurrence_histograms_sweep
from khoice_tpu_torch.engine.occurrence import occurrence_histogram
from khoice_tpu_torch.engine.session import KmerEngine

WORLD_SIZES = (1, 2, 3)
RANK_TIMEOUT_S = 240


def _dna(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))


def _adversarial(seed=0, n=3):
    """__graft_entry__.py's dryrun_multichip genomes: a shared mutated
    core (union counts reach the member count), N bases and a poly-A
    block (a repeated-key pileup)."""
    rng = np.random.default_rng(seed)
    core = _dna(rng, 1500)
    genomes = []
    for m in range(n):
        s = list(core)
        for _ in range(40 * (m + 1)):
            s[int(rng.integers(0, len(core)))] = "ACGT"[int(rng.integers(0, 4))]
        for _ in range(10):
            s[int(rng.integers(0, len(core)))] = "N"
        genomes.append("".join(s) + "A" * 600 + _dna(rng, 400))
    return genomes


def _case():
    rng = np.random.default_rng(11)
    genomes = _adversarial()
    with_n = []
    for _ in range(2):
        s = list(_dna(rng, 700))
        for i in rng.choice(700, 7, replace=False):
            s[i] = "N"
        with_n.append("".join(s))
    skew = "A" * 4000 + _dna(rng, 500)  # ~90% poly-A keys
    a = _dna(rng, 900)
    b = a[:400] + _dna(rng, 500)
    short = [_dna(rng, 40) for _ in range(300)]  # > 256 members: the gid apart
    return {
        "seqs": {"with_n": with_n, "genomes": genomes, "skew": skew, "a": a, "b": b},
        "count_codes": encode_records(with_n),
        "count_ks": (11, 21, 33),
        "genomes": [encode_records([g]) for g in genomes],
        "algebra_k": 21,
        "skew_codes": encode_records([skew]),
        "skew_k": 13,
        "resplit_a": encode_records([a]),
        "resplit_b": encode_records([b]),
        "resplit_k": 11,
        "short": [encode_records([s]) for s in short],
        "occ_ks": (11, 31),
        # a packed master class, an unpacked class (kmax 48: no spare
        # bits) and a grid the per-k path serves
        "sweep_ks": ([9, 15, 21, 31, 35, 49], [34, 40, 44, 48], [11, 15]),
        # a pivot holding part of its sequence twice (buckets' multiplicities)
        "classify_members": [encode_records([genomes[0], genomes[0][:900]])]
        + [encode_records([g]) for g in genomes[1:]] + [encode_records([a])],
        "classify_ks": [7, 10, 13, 21],
    }


CASE = _case()


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's results: sharded on a 2-device mesh ("mesh") and
    on one device ("single")."""
    case = CASE
    mesh = jax_make_mesh(devices=cpu_devices(2))
    out = {}
    for name in ("mesh", "single"):
        jsh.reset_session_splits()
        count = ((lambda c, k: jsh.sharded_count_codes(mesh, c, k)) if name == "mesh"
                 else (lambda c, k: jax_count_codes(jnp.asarray(c), k)))
        res = {"count": {k: count(case["count_codes"], k).dump() for k in case["count_ks"]}}
        k = case["algebra_k"]
        raw = [count(c, k) for c in case["genomes"]]
        if name == "mesh":
            sets = [jsh.sharded_set_counts(t, 1) for t in raw]
            union = jsh.sharded_union_many(sets, cs=5000)
            res["algebra"] = {
                "union": union.dump(),
                "union_cs2": jsh.sharded_union_many(sets, cs=2).dump(),
                "intersect": jsh.sharded_intersect_sum(raw[0], raw[1]).dump(),
                "subtract": jsh.sharded_subtract(raw[0], raw[1]).dump(),
                "set_counts": jsh.sharded_set_counts(raw[2], 3).dump(),
                "hist": jsh.sharded_histogram(union, cx=16).tolist(),
                "hist_raw": jsh.sharded_histogram(raw[0], cx=8).tolist(),
            }
            # a table to carry across (genome 0 at D = 2) and its union with
            # genome 1's set
            out["host"] = {"words": np.asarray(raw[0].table.keys),
                           "counts": np.asarray(raw[0].table.counts),
                           "splits": np.asarray(raw[0].splits), "k": k,
                           "other": case["genomes"][1]}
            out["carried"] = {"dump": raw[0].dump(),
                              "union": jsh.sharded_union_many([raw[0], sets[1]]).dump()}
            res["occ"] = {(nm, k): jax_sharded_occ(mesh, case[nm], k, cx=16)
                          for nm in ("genomes", "short") for k in case["occ_ks"]}
            res["sweep"] = {tuple(ks): jax_sharded_sweep(mesh, case["genomes"], ks, cx=16)
                            for ks in case["sweep_ks"]}
            cl = jdkc
            args = (mesh,)
        else:
            sets = [jax_set_counts(t, 1) for t in raw]
            union = jax_union_many(sets, cs=5000)
            res["algebra"] = {
                "union": union.dump(),
                "union_cs2": jax_union_many(sets, cs=2).dump(),
                "intersect": jax_intersect_sum(raw[0], raw[1]).dump(),
                "subtract": jax_subtract(raw[0], raw[1]).dump(),
                "set_counts": jax_set_counts(raw[2], 3).dump(),
                "hist": np.asarray(jax_histogram(union, cx=16)).tolist(),
                "hist_raw": np.asarray(jax_histogram(raw[0], cx=8)).tolist(),
            }
            res["occ"] = {(nm, k): jax_occ(case[nm], k, cx=16)
                          for nm in ("genomes", "short") for k in case["occ_ks"]}
            res["sweep"] = {tuple(ks): jax_sweep(case["genomes"], ks, cx=16)
                            for ks in case["sweep_ks"]}
            cl = type("single", (), {
                "sharded_pivot_rest_counts_sweep": staticmethod(jkc.pivot_rest_counts_sweep),
                "sharded_multi_pivot_counts_sweep": staticmethod(jkc.multi_pivot_counts_sweep),
                "sharded_containment_counts_sweep": staticmethod(jkc.containment_counts_sweep),
                "sharded_feature_buckets_sweep": staticmethod(jkc.feature_buckets_sweep),
            })
            args = ()
        members, ks = case["classify_members"], case["classify_ks"]
        n = len(members)
        res["classify"] = {
            "pivot_rest": cl.sharded_pivot_rest_counts_sweep(*args, members, ks),
            "multi_pivot": cl.sharded_multi_pivot_counts_sweep(*args, members[:4], 2, ks),
            "containment": cl.sharded_containment_counts_sweep(*args, members, 2, n - 2, ks),
            "buckets": cl.sharded_feature_buckets_sweep(*args, members, n - 1, ks, cap=5),
        }
        out[name] = res
    jsh.reset_session_splits()
    return out


@pytest.fixture(scope="module", params=WORLD_SIZES, ids=lambda w: f"world{w}")
def port(request, jax_side):
    """Every rank's battery results at one world size (with the JAX
    package's table at D = 2 to carry across)."""
    w = request.param
    case = dict(CASE, jax_table=jax_side["host"])
    ranks = run_ranks(w, torch_dist_ranks.battery, (case,), timeout_s=RANK_TIMEOUT_S)
    return w, ranks


def _ref(jax_side, w):
    return jax_side["mesh" if w == 2 else "single"]


def _norm(stats):
    """A sweep's ({k: stats}, leftover ks) as plain lists, comparable."""
    got, rest = stats

    def plain(v):
        if isinstance(v, tuple):
            return [plain(x) for x in v]
        return np.asarray(v).tolist()

    return {int(k): plain(v) for k, v in got.items()}, list(rest)


def test_ranks_never_import_jax(port):
    w, ranks = port
    assert [r["world_size"] for r in ranks] == [w] * w
    assert not any(r["jax"] for r in ranks)


def test_sharded_count_codes(port, jax_side):
    w, ranks = port
    seqs = CASE["seqs"]["with_n"]
    eng = KmerEngine("cpu")
    for k in CASE["count_ks"]:
        want = _ref(jax_side, w)["count"][k]
        assert dict(want) == oracle.count_kmers(seqs, k)
        assert eng.count_codes(CASE["count_codes"], k).dump() == want
        kmers = [km for km, _ in want]
        assert kmers == sorted(kmers) and len(kmers) > 500
        for r in ranks:  # globally sorted, equal on every rank
            assert r["count"][k] == want, f"world {w} k={k}"


def test_sharded_algebra(port, jax_side):
    """Union (two caps), intersect_sum, subtract, set_counts and the
    histograms over the adversarial genomes: the JAX package's, the
    port's single-device table ops' and the oracle's."""
    w, ranks = port
    want = _ref(jax_side, w)["algebra"]
    k = CASE["algebra_k"]
    eng = KmerEngine("cpu")
    raw = [eng.count_codes(c, k) for c in CASE["genomes"]]
    sets = [eng.set_counts(t, 1) for t in raw]
    union = eng.union(sets, cs=5000)
    single = {
        "union": union.dump(), "union_cs2": eng.union(sets, cs=2).dump(),
        "intersect": eng.intersect_sum(raw[0], raw[1]).dump(),
        "subtract": eng.subtract(raw[0], raw[1]).dump(),
        "set_counts": eng.set_counts(raw[2], 3).dump(),
        "hist": eng.histogram(union, cx=16), "hist_raw": eng.histogram(raw[0], cx=8),
    }
    genomes = CASE["seqs"]["genomes"]
    ounion = oracle.union_sum([oracle.set_counts(oracle.count_kmers([g], k), 1)
                               for g in genomes], cs=5000)
    assert dict(want["union"]) == ounion and max(ounion.values()) == 3
    assert want["hist"] == oracle.histogram(ounion, cx=16)
    assert single == want
    for r in ranks:
        got = dict(r["algebra"])
        assert got.pop("same_splits"), "in-session tables must share the pinned splits"
        assert got == want, f"world {w}"


def test_sharded_count_skewed_stays_balanced(port):
    """~90% poly-A keys: the sampled splits balance the ranks, so no share
    is logged as past the balanced estimate (tests/test_sharded.py::
    test_sharded_count_skewed_no_retry), and the counts stay exact."""
    w, ranks = port
    seq = CASE["seqs"]["skew"]
    k = CASE["skew_k"]
    want = {km: min(c, 255) for km, c in oracle.count_kmers([seq], k).items()}
    for r in ranks:
        assert dict(r["skew"]) == want
        assert r["skew_warnings"] == []


def test_resplit_foreign_partition(port):
    """A table of another session (its own sampled splits) re-partitions
    onto the first table's splits, with the same dump, and the algebra
    does it on its own (tests/test_sharded.py::test_resplit_foreign_partition)."""
    w, ranks = port
    k = CASE["resplit_k"]
    a, b = CASE["seqs"]["a"], CASE["seqs"]["b"]
    want_b = oracle.count_kmers([b], k)
    want = oracle.intersect_sum(oracle.count_kmers([a], k), want_b)
    for r in ranks:
        res = r["resplit"]
        assert res["foreign"] == (w > 1)
        assert dict(res["b"]) == want_b and res["moved"] == res["b"]
        assert dict(res["intersect"]) == want


def test_state_carried_from_jax(port, jax_side):
    """A JAX package ShardedKmerTable built at D = 2 loads at world size 2
    (sharded_table_from_host); its union with the port's own table (other
    splits: the algebra re-partitions it) equals the JAX union, and the
    table round-trips through sharded_table_to_host."""
    w, ranks = port
    if w != 2:
        assert all("carried" not in r for r in ranks)
        return
    host, want = jax_side["host"], jax_side["carried"]
    for r in ranks:
        got = r["carried"]
        assert got["dump"] == want["dump"]
        assert got["union"] == want["union"]
        assert got["again"] == want["dump"]
        np.testing.assert_array_equal(got["splits"], host["splits"])


def test_sharded_occurrence_histogram(port, jax_side):
    """k 11 and 31, gid-packed (3 genomes, kernel B's layout) and with the
    gid apart (300 short genomes, kernel C's)."""
    w, ranks = port
    want = _ref(jax_side, w)["occ"]
    for (name, k), hist in want.items():
        assert occurrence_histogram(CASE[name], k, "cpu", cx=16) == hist
        assert any(hist)
        for r in ranks:
            assert r["occ"][(name, k)] == hist, f"world {w} {name} k={k}"


def test_sharded_sweep(port, jax_side):
    """The sharded shared-sort sweep over a packed class, an unpacked class
    and a grid left to the sharded per-k path: the JAX package's and the
    port's single-device sweep's histograms."""
    w, ranks = port
    want = _ref(jax_side, w)["sweep"]
    for ks, hists in want.items():
        assert occurrence_histograms_sweep(CASE["genomes"], list(ks), "cpu", cx=16) == hists
        for r in ranks:
            assert r["sweep"][ks] == hists, f"world {w} ks={ks}"


def test_sharded_classification_drivers(port, jax_side):
    """The four drivers of dist/ksweep_classify.py (pivot_rest,
    multi_pivot, containment and exp4's buckets, which keeps repeats):
    the JAX package's stats and the port's single-device sweeps'."""
    w, ranks = port
    want = {mode: _norm(v) for mode, v in _ref(jax_side, w)["classify"].items()}
    members, ks = CASE["classify_members"], CASE["classify_ks"]
    n = len(members)
    single = {
        "pivot_rest": tkc.pivot_rest_counts_sweep(members, ks, device="cpu"),
        "multi_pivot": tkc.multi_pivot_counts_sweep(members[:4], 2, ks, device="cpu"),
        "containment": tkc.containment_counts_sweep(members, 2, n - 2, ks, device="cpu"),
        "buckets": tkc.feature_buckets_sweep(members, n - 1, ks, cap=5, device="cpu"),
    }
    assert {mode: _norm(v) for mode, v in single.items()} == want
    assert want["buckets"][0][21][0] != [[0] * (n - 1)] * (n - 1)
    for r in ranks:
        assert {mode: _norm(v) for mode, v in r["classify"].items()} == want, f"world {w}"
