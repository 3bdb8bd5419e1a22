"""The port's per-k fused occurrence path (khoice_tpu_torch: the plain
versions of the extraction and occurrence-histogram kernels,
engine/occurrence.py, exp1's per-k dispatch) vs the JAX package's, its
Pallas kernels in interpret mode and the dict-based oracle, on the CPU.
Every compared value is an integer or the bytes of a file, so the
tolerance is exact equality throughout."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from conftest import random_dna
from khoice_tpu.engine import occurrence as jocc
from khoice_tpu.engine.extract import extract_canonical as jax_extract
from khoice_tpu.engine.ksweep import occurrence_histograms_sweep as jax_sweep
from khoice_tpu.kernels import extract_pallas
from khoice_tpu.kernels.occ_scan_pallas import TILE, occ_hist_packed_pallas, occ_hist_pallas
from khoice_tpu.pipelines.exp1 import run_exp1 as jax_run_exp1
from khoice_tpu_torch.engine import interop
from khoice_tpu_torch.engine import ksweep as tks
from khoice_tpu_torch.engine import occurrence as tocc
from khoice_tpu_torch.engine.streaming import (
    DeviceBudgetExceeded,
    check_incore_budget,
    perk_bytes,
)
from khoice_tpu_torch.kernels import extract as kex
from khoice_tpu_torch.kernels import occ_scan
from khoice_tpu_torch.pipelines.exp1 import run_exp1
from test_exp1 import oracle_exp1_csvs

SENT = 0xFFFFFFFF


def _codes(nprng, n, n_runs=4):
    """Random codes with N runs (code 4), one at the very end."""
    c = nprng.integers(0, 4, size=n, dtype=np.uint8)
    for _ in range(n_runs):
        p = int(nprng.integers(0, max(n - 40, 1)))
        c[p:p + int(nprng.integers(1, 40))] = 4
    c[-3:] = 4
    return c


def _np_words(words):
    return np.stack([np.asarray(w) for w in words]).astype(np.int64)


@pytest.mark.parametrize("k", [5, 7, 15, 16, 31, 32, 49, 63])
def test_extract_plain_equals_jax_and_pallas(nprng, monkeypatch, k):
    codes = _codes(nprng, 2500)
    jkeys, jvalid = jax_extract(jnp.asarray(codes), k)
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, interpret=True, **kw))
    pkeys, pvalid = extract_pallas.extract_canonical_pallas.__wrapped__(jnp.asarray(codes), k)
    before = dict(kex.launches)
    keys, valid = kex.extract_canonical(torch.from_numpy(codes), k)
    assert kex.launches == before  # the CPU path launches nothing
    assert keys.dtype == torch.int64 and keys.shape == (jocc.key_words(k), codes.shape[0])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(pvalid))
    np.testing.assert_array_equal(keys.numpy(), _np_words(jkeys))
    np.testing.assert_array_equal(keys.numpy(), _np_words(pkeys))
    assert (~valid).sum() > k and valid.sum() > 0
    if k <= 60:  # the packed form: JAX's pack_gid_static of the same keys
        gids = nprng.integers(0, 256, codes.shape[0]).astype(np.uint32)
        want = jocc.pack_gid_static(jkeys, jvalid, jnp.asarray(gids), k)
        got = kex.extract_packed(torch.from_numpy(codes),
                                 torch.from_numpy(gids.astype(np.int64)), k)
        np.testing.assert_array_equal(got.numpy(), _np_words(want))


def _sorted_jax(members, k, packed):
    """JAX's per-k sorted arrays of packed members, padded with SENTINEL to
    a multiple of the Pallas tile: (words tuple, gids or None)."""
    codes, gids = jocc.pack_members(members)
    keys, valid = jax_extract(jnp.asarray(codes), k)
    if packed:
        ws = list(jocc.pack_gid_static(keys, valid, jnp.asarray(gids), k))
    else:
        ws = list(keys) + [jnp.where(valid, jnp.asarray(gids), jnp.uint32(SENT))]
    n = ws[0].shape[0]
    pad = -n % TILE
    ws = [jnp.concatenate([w, jnp.full((pad,), SENT, jnp.uint32)]) for w in ws]
    srt = jax.lax.sort(ws, num_keys=len(ws), is_stable=False)
    return (tuple(srt), None) if packed else (tuple(srt[:-1]), srt[-1])


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("k", [11, 31])
def test_occ_hist_plain_equals_pallas(nprng, packed, k):
    """Sorted words of 5 related members plus a poly-A member whose key
    run spans more than one 65536-element tile."""
    base = _codes(nprng, 3000)
    members = [base.copy() for _ in range(5)]
    for m in members:
        pos = nprng.integers(0, 3000, 60)
        m[pos] = nprng.integers(0, 4, 60, dtype=np.uint8)
    members.append(np.zeros(70000, np.uint8))
    words, gid = _sorted_jax(members, k, packed)
    assert words[0].shape[0] == 2 * TILE
    g = len(members)
    if packed:
        want = occ_hist_packed_pallas.__wrapped__(words, g, 8, interpret=True)
        got = occ_scan.occ_hist_packed(interop.words_from_numpy(words, "cpu"), g, 5000)
    else:
        want = occ_hist_pallas.__wrapped__(words, gid, g, interpret=True)
        got = occ_scan.occ_hist(interop.words_from_numpy(words, "cpu"),
                                interop.payload_from_numpy(np.asarray(gid), "cpu"), g, 5000)
    assert got.dtype == torch.int64 and got.shape == (g,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] > 0 and got[4] > 0


@pytest.mark.parametrize("n_members,ks", [(70, (12, 13, 28, 29, 44, 45, 61)),
                                          (260, (15, 16, 31, 32))])
def test_occurrence_histogram_equals_jax(nprng, n_members, ks):
    """70 members: the gid-packed layout (k <= 60); 260 members, and k = 61:
    key words and a separate gid."""
    base = nprng.integers(0, 4, size=150, dtype=np.uint8)
    base[140:143] = 4
    members = []
    for i in range(n_members):
        m = base.copy()
        pos = nprng.integers(100, 150, 3)  # the first 100 bases are shared
        m[pos] = nprng.integers(0, 4, 3, dtype=np.uint8)
        members.append(m[: 100 + i % 50])
    packed = tocc.pack_members(members, "cpu")
    for k in ks:
        assert tocc.gid_packable(n_members, k) == (n_members <= 256 and k <= 60)
        want = jocc.occurrence_histogram(members, k, cx=300)
        got = tocc.occurrence_histogram_packed(packed, n_members, k, cx=300)
        assert got == want, k
        assert got[n_members - 1] > 0  # the shared core
    # cs and cx below the member count cap and cut the bins
    k = ks[0]
    assert (tocc.occurrence_histogram(members, k, "cpu", cs=3, cx=50)
            == jocc.occurrence_histogram(members, k, cs=3, cx=50))


def test_sweep_sends_leftover_ks_to_the_per_k_path(nprng):
    """exp1's sweep: a 2-k grid and a 70-member group take the per-k path
    (equal to JAX's sweep, which does the same); the budget covers it."""
    members = [_codes(nprng, 200, 1) for _ in range(3)]
    for mem, ks in ((members, [11, 21]), (members, [7, 9, 21, 31, 33]),
                    ([_codes(nprng, 60, 1) for _ in range(70)], [7, 9, 11])):
        assert tks.occurrence_histograms_sweep(mem, ks, "cpu", cx=80) == jax_sweep(mem, ks, cx=80)
    need = perk_bytes(1000, [11, 21], 3)
    assert need == 1000 * 8 * (2 * 2 + 6)  # k = 21: (key << 8) | gid in 2 words
    assert perk_bytes(1000, [31], 300) == 1000 * 8 * (2 * 3 + 6)  # 2 key words + gid
    check_incore_budget(1000, [11, 21], 3, need, "g")
    with pytest.raises(DeviceBudgetExceeded, match="stream under a budget"):
        check_incore_budget(1000, [11, 21], 3, need - 1, "g")


@pytest.mark.parametrize("ks,per_group", [([11, 21, 31, 35], 70), ([21, 31], 3)])
def test_exp1_per_k_csvs_equal_jax_and_oracle(rng, tmp_path, ks, per_group):
    """A 70-member group (beyond the sweep's mask) and a 2-k grid: step_5
    and step_9 bytes equal the JAX package's and the oracle's."""
    base = random_dna(rng, 120)
    groups = {}
    for num in (1, 2):
        genomes = []
        for i in range(per_group):
            seq = list(base)
            for _ in range(4 + 3 * num):
                seq[rng.randrange(len(seq))] = "ACGT"[rng.randrange(4)]
            genomes.append(["".join(seq), random_dna(rng, 20 + i % 7)])
        groups[num] = genomes
    port = run_exp1(groups, ks, str(tmp_path / "port"), "cpu")
    ref = jax_run_exp1(groups, ks, str(tmp_path / "jax"), fused=True)
    o5, o9 = oracle_exp1_csvs(groups, ks, str(tmp_path / "oracle"))
    for key, oracle_path in (("step_5", o5), ("step_9", o9)):
        with open(port[key], "rb") as a, open(ref[key], "rb") as b, open(oracle_path, "rb") as c:
            assert a.read() == b.read() == c.read()
