"""exp6's read-level voting in the port (khoice_tpu_torch: kernels/vote.py's
plain versions, classify/annotate.py's merge-join voting,
pipelines/exp6.py) vs the JAX package's, on the CPU.  Both get the same
inputs, made from a seed; every compared value is an integer or the
bytes of a file, so the tolerance is exact equality throughout.  Parity
is held at D <= 12, where the JAX package's uint32 votes do not wrap; at
D = 17 the port's int64 votes are held to a Python-int oracle."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna
from khoice_tpu import oracle
from khoice_tpu.classify import annotate as jann
from khoice_tpu.io.packing import encode_records
from khoice_tpu.pipelines.exp6 import reads_matrix as jax_reads_matrix
from khoice_tpu.pipelines.exp6 import run_exp6 as jax_run_exp6
from khoice_tpu_torch.classify import annotate as tann
from khoice_tpu_torch.engine.bits import words_starts
from khoice_tpu_torch.kernels import vote as kvote
from khoice_tpu_torch.kernels.sort import sort_words_reference
from khoice_tpu_torch.pipelines.exp6 import reads_matrix, run_exp6
from test_classify import make_world

KS = (7, 11, 21, 33, 49)  # key words 1, 1, 2, 4, 4; "7" sorts after the others


def _world(rng, d, genomes_per=2, glen=300, n_reads=12, read_len=60):
    """make_world's groups (one base genome, mutated per dataset) with
    reads per pivot: windows of the pivot, random reads, and a short read
    (rows padded with 4s)."""
    pivots, rest = make_world(rng, d=d, genomes_per=genomes_per, glen=glen)
    reads = {
        num: [pivots[num][0][i:i + read_len] for i in range(0, glen - read_len, 23)][:n_reads]
        + [random_dna(rng, read_len, n_prob=0.02) for _ in range(3)] + [pivots[num][0][:40]]
        for num in rest
    }
    return reads, rest


def _group_codes(rest):
    return [encode_records([s for g in rest[num] for s in g]) for num in sorted(rest)]


@pytest.mark.parametrize("k", KS)
def test_vote_mask_plain_equals_jax_merge(rng, k):
    """The merge-join's run masks: the port's (its extraction, stable
    sort and plain vote_mask) against _read_votes_merge's qmask, masked
    by validity, at every read window."""
    reads, rest = _world(rng, 3)
    gc = _group_codes(rest)
    mat = reads_matrix(reads[1] + reads[2])
    jq, jvalid = jann._read_votes_merge(jann.pack_group_texts(gc),
                                        jann.flat_reads_device(mat)[0], k, 3, 0)
    want = np.where(np.asarray(jvalid), np.asarray(jq), 0).astype(np.int64)
    codes, gids = tann.pack_group_texts(gc, "cpu")
    flat, _, _ = tann.flat_reads_device(mat, "cpu")
    skeys, spay, qvalid = tann._merge_join(codes, gids, flat, k, 3)
    got = torch.where(qvalid, kvote.vote_mask(skeys, spay, 3, flat.shape[0]), 0).numpy()
    n = flat.shape[0]  # the JAX flat array is padded to a multiple of 8
    assert np.array_equal(got, want[:n]) and not want[n:].any()
    assert got.any() and (got == 0).any()


def test_read_votes_plain_equals_jax(nprng):
    """The per-read sums of the plain read_votes against
    _votes_from_masks, at D = 3 and 12, on random masks and validity."""
    for D, r, l in ((3, 40, 30), (12, 17, 150)):
        n = r * (l + 1)
        qmask = nprng.integers(0, 1 << D, n).astype(np.uint32)
        qmask[nprng.random(n) < 0.3] = 0
        valid = nprng.random(n) < 0.9
        lcm = jann.vote_lcm(D)
        want = jann._votes_from_masks(jnp.asarray(qmask), jnp.asarray(valid), r, l, D, lcm)
        got = kvote.read_votes(torch.from_numpy(qmask.astype(np.int64)),
                               torch.from_numpy(valid),
                               torch.arange(r + 1) * (l + 1), D, lcm)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("D", [3, 12])
def test_read_votes_bulk_multi_equals_jax(rng, D):
    """Every pivot's (votes, unmatched, n_kmers) from one merge-join per
    k, at ks of 1, 2 and 4 key words."""
    reads, rest = _world(rng, D, genomes_per=1, glen=200, n_reads=6)
    gc = _group_codes(rest)
    mats = [reads_matrix(reads[num]) for num in sorted(rest)]
    jbig, jspans = jann.concat_flat_reads([jann.flat_reads_device(m) for m in mats])
    group = tann.pack_group_texts(gc, "cpu")
    big, spans = tann.concat_flat_reads([tann.flat_reads_device(m, "cpu") for m in mats])
    voted = 0
    for k in (7, 21, 49):
        want = jann.read_votes_bulk_multi(jann.pack_group_texts(gc), jbig, jspans, k, D)
        got = tann.read_votes_bulk_multi(group, big, spans, k, D)
        assert len(got) == D
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == np.int64 and np.array_equal(a, b)
        voted += sum(int(v.sum()) for v, _, _ in got)
    assert voted > 0


@pytest.mark.parametrize("read_type", ["illumina", "ont"])
def test_run_exp6_files_equal_jax(rng, tmp_path, read_type):
    """The trial CSV and every per-k file, byte for byte; the ks put "7"
    after "11".."49" in the trial CSV (the glob order)."""
    reads, rest = _world(rng, 3)
    jax_out = jax_run_exp6(reads, rest, KS, str(tmp_path / "jax"), read_type=read_type)
    out = run_exp6(reads, rest, KS, str(tmp_path / "port"), "cpu", read_type=read_type)
    assert os.path.basename(out) == os.path.basename(jax_out)
    with open(out, "rb") as fd, open(jax_out, "rb") as ref:
        data = fd.read()
        assert data == ref.read()
    assert data.splitlines()[1].startswith(b"11,")
    files = 0
    for root, _dirs, names in os.walk(tmp_path / "jax"):
        for name in names:
            rel = os.path.relpath(os.path.join(root, name), tmp_path / "jax")
            with open(tmp_path / "port" / rel, "rb") as fd, open(os.path.join(root, name), "rb") as ref:
                assert fd.read() == ref.read(), rel
            files += 1
    assert files == 1 + 3 * len(KS)


def test_reads_matrix_equals_jax(rng):
    reads = [random_dna(rng, n) for n in (5, 60, 1, 33)]
    assert np.array_equal(reads_matrix(reads), jax_reads_matrix(reads))


@pytest.mark.parametrize("k", [11, 33])
def test_group_mask_annotation_and_read_votes_equal_jax(rng, k):
    """build_group_mask_annotation's keys and masks (the JAX package's at
    each run's first slot, its SENTINEL run left out) and read_votes
    against it."""
    reads, rest = _world(rng, 3)
    gc = _group_codes(rest)
    jax_ann = jann.build_group_mask_annotation(gc, k)
    ann = tann.build_group_mask_annotation(gc, k, "cpu")
    jkeys = np.stack([np.asarray(w) for w in jax_ann.keys]).astype(np.int64)
    first = np.ones(jkeys.shape[1], bool)
    first[1:] = (jkeys[:, 1:] != jkeys[:, :-1]).any(0)
    first &= ~(jkeys == 0xFFFFFFFF).all(0)
    assert np.array_equal(ann.keys.numpy(), jkeys[:, first])
    assert np.array_equal(ann.mask.numpy(), np.asarray(jax_ann.mask).astype(np.int64)[first])
    mat = reads_matrix(reads[1] + reads[3])
    got, want = tann.read_votes(ann, mat), jann.read_votes(jax_ann, mat)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[0].any() and got[1].any()


def test_vote_mask_order_after_a_stable_sort():
    """What the vote_mask kernel rests on: after the stable sort of a
    concatenation with the texts first, no query precedes a text element
    in any key run (keys drawn from a few values: long runs mixing
    both)."""
    nt, nq = 5000, 3000
    g = np.random.default_rng(5)
    for W in (1, 2, 4):
        words = torch.from_numpy(g.integers(0, 40, (W, nt + nq)))
        pay = torch.cat([torch.from_numpy(g.integers(0, 4, nt)), 4 + torch.arange(nq)])
        sw, sp = sort_words_reference(words, pay)
        starts = words_starts(sw)
        text = sp < 4
        assert not (~text[:-1] & text[1:] & ~starts[1:]).any()
        assert (text[1:] & ~starts[1:]).any() and (~text[1:] & ~starts[1:]).any()


def test_vote_mask_plain_ignores_order_within_runs():
    """The plain vote_mask's run OR does not rest on the order: queries
    before texts, gids out of order and the SENTINEL run."""
    S = 0xFFFFFFFF
    words = torch.tensor([[1, 1, 1, 1, 2, 2, 5, S, S]])
    pay = torch.tensor([4, 2, 0, 2, 5, 1, 6, 0, 7])  # D = 4: queries 4, 5, 6, 7
    got = kvote.vote_mask(words, pay, 4, 4)
    assert got.tolist() == [0b101, 0b010, 0, 0]


def test_vote_datasets_held_to_32(rng):
    reads, rest = _world(rng, 2)
    group = tann.pack_group_texts(_group_codes(rest), "cpu")
    big, spans = tann.concat_flat_reads([tann.flat_reads_device(reads_matrix(reads[1]), "cpu")])
    with pytest.raises(ValueError, match="1 to 32"):
        tann.read_votes_bulk_multi(group, big, spans, 11, 33)
    with pytest.raises(ValueError, match="1 to 32"):
        tann.build_group_mask_annotation([np.zeros(10, np.uint8)] * 33, 11, "cpu")
    with pytest.raises(ValueError):
        kvote.vote_mask(torch.zeros(1, 4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64),
                        0, 1)


def test_votes_past_uint32_equal_python_ints(rng):
    """D = 17 (LCM 12,252,240): ~400-base reads drawn from a genome that
    only dataset 1 holds sum ~390 windows of the full LCM each, past
    2^32.  The port's int64 votes equal a dict-based voter in Python
    ints; the JAX package's uint32 votes are those modulo 2^32 (a
    deliberate divergence, ROADMAP.md section 3)."""
    D, k = 17, 21
    lcm = tann.vote_lcm(D)
    assert lcm == 12_252_240
    shared = random_dna(rng, 300)
    unique = random_dna(rng, 1200)
    rest = {num: [[shared + random_dna(rng, 200)]] for num in range(1, D + 1)}
    rest[1][0][0] += unique
    reads = [unique[i:i + 400] for i in range(0, 800, 100)] + [shared[:150] + unique[:250]]
    sets = [{oracle.canonical(s[i:i + k]) for g in rest[num] for s in g
             for i in range(len(s) - k + 1)} for num in sorted(rest)]
    want = []
    for read in reads:
        v = [0] * D
        for i in range(len(read) - k + 1):
            km = oracle.canonical(read[i:i + k])
            hits = [d for d in range(D) if km in sets[d]]
            for d in hits:
                v[d] += lcm // len(hits)
        want.append(v)
    assert max(max(v) for v in want) > 2**32
    votes, _, nk = tann.read_votes_bulk(_group_codes(rest), reads_matrix(reads), k, D, "cpu")
    assert votes.tolist() == want
    assert nk.tolist() == [len(r) - k + 1 for r in reads]
    jvotes, _, _ = jann.read_votes_bulk(_group_codes(rest), jax_reads_matrix(reads), k, D)
    assert jvotes.tolist() == [[x % 2**32 for x in v] for v in want] != want
