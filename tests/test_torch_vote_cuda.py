"""exp6's voting kernels (khoice_tpu_torch/csrc/vote.cu: vote_mask,
read_votes) vs their plain PyTorch versions on the card, exact equality:
on synthetic merge-join arrays (runs of texts then queries, at W = 1-4
and D = 1, 4 and 32: runs of queries only, runs over more than two
tiles, queries at tile edges, no text, no query, the SENTINEL run), on a
real merge-join (extraction and radix sort on the card), and on read
rows of ONT and Illumina lengths with empty rows.

Needs a CUDA device and skips without one.  The file imports no jax, so
it runs where the JAX package is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_vote_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from khoice_tpu_torch.classify import annotate as ann
from khoice_tpu_torch.kernels import _build
from khoice_tpu_torch.kernels import vote as kvote

ONES = 0xFFFFFFFF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def merged(rng, W, D, runs, sentinel=None):
    """A sorted merge-join: run i (a distinct random key of W words) holds
    runs[i] = (texts, queries) elements, the texts first with random gids
    < D, the queries numbered in a random order; `sentinel` = (texts,
    queries) adds the SENTINEL run last (its texts' payload 0).  Returns
    (words int64 [W, n], payload int64 [n], n_query) as numpy arrays."""
    keys = rng.integers(0, 2**32, (len(runs) + 8, W), dtype=np.int64)
    keys[:, 0] >>= 1  # no valid key is all ones
    keys = np.unique(keys, axis=0)[:len(runs)]  # ascending, distinct
    runs = list(runs)[:keys.shape[0]]
    if sentinel is not None:
        keys = np.concatenate([keys, np.full((1, W), ONES, np.int64)])
        runs.append(sentinel)
    lens = np.array([t + q for t, q in runs], np.int64)
    words = np.repeat(keys, lens, axis=0).T.copy()
    n_query = sum(q for _, q in runs)
    order = D + rng.permutation(n_query)
    pay, qi = [], 0
    for i, (t, q) in enumerate(runs):
        gids = np.zeros(t, np.int64) if i == len(runs) - 1 and sentinel else \
            np.sort(rng.integers(0, D, t))
        pay += [gids, order[qi:qi + q]]
        qi += q
    return words, np.concatenate(pay).astype(np.int64), n_query


def check_mask(dev, words, pay, D, n_query):
    w, p = (torch.as_tensor(x, device=dev) for x in (words, pay))
    before = kvote.launches["vote_mask"]
    got = kvote.vote_mask(w, p, D, n_query)
    torch.cuda.synchronize()
    assert kvote.launches["vote_mask"] == before + int(n_query > 0)
    want = kvote.vote_mask_reference(w, p, D, n_query)
    assert torch.equal(got, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("D", [1, 4, 32])
def test_vote_mask_random_runs(cuda, W, D):
    """Runs of 1-40 elements, some of queries only, some of texts only,
    over many tiles, with the SENTINEL run last."""
    rng = np.random.default_rng(W * 100 + D)
    runs = [(int(rng.integers(0, 20)), int(rng.integers(0, 20))) for _ in range(12000)]
    words, pay, nq = merged(rng, W, D, runs, sentinel=(50, 70))
    assert nq == sum(q for _, q in runs) + 70
    want = check_mask(cuda, words, pay, D, nq)
    assert want.any() and (want == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 4])
def test_vote_mask_edges(cuda, W):
    tile = _build.load().vote_mask_tile_elems()
    rng = np.random.default_rng(W)
    D = 4
    cases = {
        # one run over more than two tiles, texts spread over its start,
        # its queries over the rest; then runs crossing the next tiles
        "run over 3 tiles": [(5, 3)] * 10 + [(tile + 17, 2 * tile)] + [(3, 4)] * 900,
        # queries at tile - 1, tile + 1 and 2 tile - 1, and at 2 tile, the
        # first element of a tile whose run's texts all lie before it
        "queries at tile edges": [(tile - 1, 1), (1, 1), (tile - 3, 2), (2, 2)] * 3,
        "runs of queries only": [(0, 7)] * 1000 + [(3, 0), (0, 5)] * 500,
        "no text element": [(0, int(q)) for q in rng.integers(1, 30, 2000)],
        "one element": [(0, 1)],
        "a tile exactly": [(tile // 2, tile // 2)],
    }
    for label, runs in cases.items():
        words, pay, nq = merged(rng, W, D, runs)
        want = check_mask(cuda, words, pay, D, nq)
        if label.startswith("run over") or label.startswith("queries at"):
            assert want.all(), label
        if label in ("no text element", "one element"):
            assert not want.any(), label
    # only the SENTINEL run, and no query at all
    words, pay, nq = merged(rng, W, D, [], sentinel=(100, 3 * tile))
    assert not check_mask(cuda, words, pay, D, nq).any()
    words, pay, _ = merged(rng, W, D, [(5, 0)] * 50)
    assert check_mask(cuda, words, pay, D, 0).shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 21, 33, 49])
def test_vote_mask_on_a_real_merge_join(cuda, k):
    """Group texts of 4 datasets (one with a poly-A tract: a run over many
    tiles) and reads drawn from them, through the extraction and the
    radix sort on the card (annotate._merge_join), as exp6 runs them."""
    rng = np.random.default_rng(k)
    base = rng.integers(0, 4, 200_000).astype(np.uint8)
    groups = []
    for d in range(4):
        g = base.copy()
        g[rng.integers(0, g.shape[0], 2000 * (d + 1))] = rng.integers(0, 4, 2000 * (d + 1))
        groups.append(g)
    groups[2] = np.concatenate([groups[2], np.zeros(50_000, np.uint8)])
    starts = rng.integers(0, 199_000, 3000)
    reads = np.stack([groups[int(i) % 4][s:s + 150] for i, s in enumerate(starts)])
    reads[rng.random(reads.shape) < 0.01] = 4
    codes, gids = ann.pack_group_texts(groups, cuda)
    flat, _, _ = ann.flat_reads_device(reads, cuda)
    sw, sp, qvalid = ann._merge_join(codes, gids, flat, k, 4)
    want = check_mask(cuda, sw, sp, 4, flat.shape[0])
    assert (want[qvalid] != 0).float().mean() > 0.5


def rows(rng, lengths, D, p_zero=0.3, p_invalid=0.05):
    n = int(sum(lengths))
    qmask = rng.integers(0, 2**D, n, dtype=np.int64)
    qmask[rng.random(n) < p_zero] = 0
    valid = rng.random(n) >= p_invalid
    row_starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    return qmask, valid, row_starts


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 4, 32])
@pytest.mark.parametrize("shape", ["ont", "illumina", "ragged"])
def test_read_votes_equal_plain(cuda, D, shape):
    rng = np.random.default_rng(D)
    lengths = {"ont": [1001] * 2000, "illumina": [151] * 20000,
               "ragged": rng.integers(0, 70, 5000)}[shape]
    if shape == "ragged":
        lengths[:3] = 0  # empty rows, the first ones included
        lengths[-1] = 0
    qm, valid, rs = (torch.from_numpy(x).to(cuda) for x in rows(rng, lengths, D))
    lcm = math.lcm(*range(1, D + 1))
    before = kvote.launches["read_votes"]
    got = kvote.read_votes(qm, valid, rs, D, lcm)
    torch.cuda.synchronize()
    assert kvote.launches["read_votes"] == before + 1
    want = kvote.read_votes_reference(qm, valid, rs, D, lcm)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert want[0].any() and want[1].any()
    if D == 32 and shape == "ont":
        assert int(want[0].max()) > 2**32  # int64 sums past uint32


@pytest.mark.cuda
def test_read_votes_no_rows_and_bad_inputs(cuda):
    qm = torch.zeros(10, dtype=torch.int64, device=cuda)
    valid = torch.ones(10, dtype=torch.bool, device=cuda)
    before = kvote.launches["read_votes"]
    votes, unmatched, nk = kvote.read_votes(qm, valid, torch.zeros(1, dtype=torch.int64,
                                                                   device=cuda), 3, 6)
    assert votes.shape == (0, 3) and unmatched.shape == (0,) and nk.shape == (0,)
    assert kvote.launches["read_votes"] == before
    with pytest.raises(ValueError):
        kvote.read_votes(qm, valid.int(), torch.tensor([0, 10], device=cuda), 3, 6)
    with pytest.raises(ValueError):
        kvote.read_votes(qm, valid, torch.tensor([0, 10], device=cuda), 33, 6)
    with pytest.raises(ValueError):
        kvote.vote_mask(qm[None], qm, 0, 1)


@pytest.mark.cuda
def test_read_votes_bulk_multi_on_the_card_equals_the_cpu(cuda):
    """The whole vote step on the card against the same step on the CPU
    (plain versions): every pivot's votes, unmatched and n_kmers."""
    rng = np.random.default_rng(9)
    groups = [rng.integers(0, 4, 30_000).astype(np.uint8) for _ in range(3)]
    mats = [np.stack([g[s:s + 120] for s in rng.integers(0, 29_000, 200)]) for g in groups]
    for k in (11, 31, 45):
        out = {}
        for dev in ("cpu", cuda):
            group = ann.pack_group_texts(groups, dev)
            big, spans = ann.concat_flat_reads([ann.flat_reads_device(m, dev) for m in mats])
            out[str(dev)] = ann.read_votes_bulk_multi(group, big, spans, k, 3)
        for a, b in zip(out["cpu"], out[str(cuda)]):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
