"""exp6's sharded read votes of the port (khoice_tpu_torch/dist/vote.py)
vs the JAX package's (khoice_tpu/dist/vote.py) and the port's single-device
votes, on the CPU.

The port's ranks run on gloo through dist/launch.py::run_ranks at world
sizes 1, 2 and 3 (the rank program is tests/torch_dist_ranks.py::votes);
the JAX package runs on the conftest's 8 virtual CPU devices.  Every vote,
unmatched count and k-mer count is an integer, so the tolerance is exact
equality.  The datasets stay at D <= 12, below the JAX package's uint32
vote wrap (ROADMAP.md section 3).  Mirrors tests/test_dist_classify.py's
vote tests.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks
from conftest import cpu_devices
from khoice_tpu.dist import make_mesh as jax_make_mesh
from khoice_tpu.dist.vote import build_vote_world as jax_build_vote_world
from khoice_tpu.dist.vote import sharded_read_votes_multi as jax_sharded_votes
from khoice_tpu.io.packing import encode_records
from khoice_tpu.pipelines.exp6 import reads_matrix
from khoice_tpu_torch.classify import annotate as tann
from khoice_tpu_torch.dist import vote as tvote
from khoice_tpu_torch.dist.launch import run_ranks
from khoice_tpu_torch.kernels.sort import sort_words

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

WORLD_SIZES = (1, 2, 3)
RANK_TIMEOUT_S = 240


def _dna(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))


def _mutated(rng, core, n_sub):
    s = list(core)
    for i in rng.choice(len(core), n_sub, replace=False):
        s[i] = "ACGT"[int(rng.integers(0, 4))]
    return "".join(s)


def _cases():
    """name -> (groups: one code array per dataset, read matrices, ks,
    the JAX package's bucket cap)."""
    rng = np.random.default_rng(23)
    core = _dna(rng, 900)
    # six datasets of related genomes with N runs and a shared tandem
    # repeat; reads from the core (every dataset holds their keys), from
    # one dataset's genome, random, with Ns, and an all-A read (a run of
    # one key with no text): uneven counts and lengths per pivot
    seqs = []
    for d in range(6):
        g = list(_mutated(rng, core, 20 * (d + 1)))
        g[100 * d:100 * d + 7] = "N" * 7
        seqs.append(["".join(g), "ACGT" * 12 + _dna(rng, 60)])
    groups = [encode_records(s) for s in seqs]
    mats = []
    for p in range(6):
        reads = [core[30 * i:30 * i + 45 + 5 * p] for i in range(3 + p)]
        reads += [seqs[p][0][200 + 20 * i:260 + 20 * i] for i in range(3)]
        reads += [_dna(rng, 50 + 3 * p), "NN" + _dna(rng, 40), "A" * 48]
        mats.append(reads_matrix(reads))
    main = (groups, mats, (7, 11, 21, 33, 49), None)
    # tests/test_dist_classify.py::test_sharded_votes_overflow_retry: a
    # poly-A genome whose repeated key overflowed the JAX package's caps
    polya = ([encode_records(["A" * 300 + _dna(rng, 100)]), encode_records([_dna(rng, 300)])],
             [reads_matrix(["A" * 50, _dna(rng, 50)]),
              reads_matrix([_dna(rng, 50) for _ in range(3)])],
             (11,), 8)
    # every query window holds one key (poly-A reads): all of them go to
    # one rank, and the others receive texts only
    one_key = ([encode_records([_dna(rng, 400), "A" * 40 + _dna(rng, 200)]),
                encode_records([_dna(rng, 500)]), encode_records(["T" * 30 + _dna(rng, 300)])],
               [reads_matrix(["A" * 40, "A" * 25]), reads_matrix(["T" * 33]),
                reads_matrix(["A" * 60, "T" * 20, "A" * 12])],
               (11, 21), None)
    return {"main": main, "polya": polya, "one_key": one_key}


CASES = _cases()


def _plain(per_pivot):
    return [[np.asarray(a).astype(np.int64).tolist() for a in t] for t in per_pivot]


def _single(groups, mats, k):
    """The port's single-device votes on the CPU."""
    texts = tann.pack_group_texts(groups, "cpu")
    big, spans = tann.concat_flat_reads([tann.flat_reads_device(m, "cpu") for m in mats])
    return _plain(tann.read_votes_bulk_multi(texts, big, spans, k, len(groups)))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's sharded votes on the 8-device mesh, per case."""
    mesh = jax_make_mesh(devices=cpu_devices(8))
    out = {}
    for name, (groups, mats, ks, cap) in CASES.items():
        got = jax_sharded_votes(mesh, groups, mats, list(ks), bucket_cap=cap)
        out[name] = {k: _plain(got[k]) for k in ks}
    return out


@pytest.fixture(scope="module", params=WORLD_SIZES, ids=lambda w: f"world{w}")
def port(request):
    w = request.param
    cases = {name: {"groups": g, "mats": m, "ks": list(ks), "bucket_cap": cap}
             for name, (g, m, ks, cap) in CASES.items()}
    return w, run_ranks(w, torch_dist_ranks.votes, (cases,), timeout_s=RANK_TIMEOUT_S)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_votes_equal_single_device_and_jax(port, jax_side, name):
    """Every rank's votes, unmatched and n_kmers per read at every k equal
    the port's single-device votes and the JAX package's sharded votes:
    the key-word classes 1, 2 and 4 (k 7-49, D = 6); the poly-A pile-up
    (one key's run over the JAX package's bucket cap); reads whose keys
    all go to one rank."""
    w, ranks = port
    groups, mats, ks, _cap = CASES[name]
    assert [r["world_size"] for r in ranks] == [w] * w
    assert not any(r["jax"] for r in ranks)
    for k in ks:
        want = _single(groups, mats, k)
        assert want == jax_side[name][k], f"{name} k={k}"
        assert any(any(v) for t in want for v in t[0]), f"{name} k={k}: no vote"
        for r in ranks:
            assert r[name]["votes"][k] == want, f"world {w} {name} k={k}"


def test_every_query_window_is_received_once(port):
    """Each valid query window reaches exactly one rank, so the
    windows received over the ranks sum to the single-device n_kmers, and
    in the one-key case one rank receives every query window and the
    others none (their read sums run over no window)."""
    w, ranks = port
    for name, (groups, mats, ks, _cap) in CASES.items():
        for i, k in enumerate(ks):
            n_kmers = sum(sum(t[2]) for t in _single(groups, mats, k))
            got = [r[name]["received"][i] for r in ranks]
            assert sum(got) == n_kmers, f"{name} k={k}"
            if name == "one_key":
                assert sorted(got) == [0] * (w - 1) + [n_kmers], f"k={k}: {got}"


def _merge(recv, W, D, n_query, row_starts):
    """A rank's steps after the exchange (dist/vote.py::_local_vote's
    tail): texts first, the stable sort, the masks and sums."""
    words, pay, here = tvote._texts_first(recv, W, D, n_query)
    sw, spay = sort_words(words, pay)
    return sw, spay, tvote._join_votes(sw, spay, here, row_starts, D, tann.vote_lcm(D))


def test_received_rows_laid_out_texts_first():
    """Rows arrive grouped by the rank that sent them, so one
    rank's queries can precede another rank's texts in a key run.  The
    merge lays them out texts first, and after the stable sort every
    text of a run precedes its queries (vote_mask's kernel rests on it);
    the votes come out as the texts say."""
    D, W, lcm = 3, 1, tann.vote_lcm(3)
    # from "rank 0": queries of key 5 (flat positions 0, 1) and key 7 (2);
    # from "rank 1": texts of key 5 (datasets 1, 0), key 7 (2) and key 9 (1)
    recv = torch.tensor([[5, D + 0], [5, D + 1], [7, D + 2],
                         [5, 1], [5, 0], [7, 2], [9, 1]], dtype=torch.int64)
    words, pay, here = tvote._texts_first(recv, W, D, 3)
    assert pay.tolist() == [1, 0, 2, 1, D, D + 1, D + 2] and here.all()
    # reads: positions 0, 1 (read 0) and 2 (read 1) of 3
    sw, spay, got = _merge(recv, W, D, 3, torch.tensor([0, 2, 3]))
    starts = torch.ones_like(spay, dtype=torch.bool)
    starts[1:] = sw[0, 1:] != sw[0, :-1]
    run = torch.cumsum(starts, 0)
    for r in run.unique():
        p = spay[run == r]
        is_text = p < D
        assert not (~is_text[:-1] & is_text[1:]).any(), f"a query precedes a text: {p.tolist()}"
    half = lcm // 2
    assert got.tolist() == [[2 * half, 2 * half, 0, 0, 2], [0, 0, lcm, 0, 1]]


@pytest.mark.parametrize("what", ["texts only", "nothing"])
def test_rank_without_queries_adds_nothing(what):
    """A rank that receives texts only, or no element at all, adds zero
    votes, unmatched and n_kmers to every read."""
    D = 2
    rows = [[5, 0], [5, 1], [8, 1]] if what == "texts only" else []
    recv = torch.tensor(rows, dtype=torch.int64).reshape(-1, 2)
    got = _merge(recv, 1, D, 4, torch.tensor([0, 2, 4]))[2]
    assert got.tolist() == [[0] * (D + 2)] * 2


def test_build_vote_world_matches_jax_layout():
    """The world's codes and spans are the JAX package's, but for the
    padding of its texts to a bucketed length (left out with the shape
    buckets); a text position's payload is its dataset as there, a read
    position's D + its flat position in the reads (the port's payload),
    where the JAX package's is D + its read id."""
    groups, mats, _ks, _cap = CASES["main"]
    codes, pays, spans = tvote.build_vote_world(groups, mats)
    jcodes, jpays, jspans = jax_build_vote_world(groups, mats)
    assert spans == jspans
    D = len(groups)
    n_text, jn_text = int((pays < D).sum()), int((jpays < D).sum())
    np.testing.assert_array_equal(codes[:n_text], jcodes[:n_text])
    assert (jcodes[n_text:jn_text] == 4).all()
    np.testing.assert_array_equal(codes[n_text:], jcodes[jn_text:])
    np.testing.assert_array_equal(pays[:n_text], jpays[:n_text])
    np.testing.assert_array_equal(pays[n_text:], D + np.arange(codes.shape[0] - n_text))
