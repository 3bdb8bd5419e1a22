"""The port's shared-sort k-sweep (khoice_tpu_torch/engine/ksweep.py) vs the
JAX package's, on the CPU.  Every compared number is an integer, so the
tolerance is exact equality throughout."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from khoice_tpu.engine import ksweep as jks
from khoice_tpu.engine.occurrence import pack_members as jax_pack_members
from khoice_tpu_torch.engine import interop
from khoice_tpu_torch.engine import ksweep as tks
from khoice_tpu_torch.engine.occurrence import pack_members
from khoice_tpu_torch.engine.streaming import (
    DeviceBudgetExceeded,
    check_incore_budget,
    incore_sweep_bytes,
)
from khoice_tpu_torch.kernels import ksweep_scan

K_GRID = list(range(7, 31)) + list(range(34, 50, 3))


def _dna(nprng, n, n_runs=2):
    """Random codes with a few N runs (code 4)."""
    c = nprng.integers(0, 4, size=n, dtype=np.uint8)
    for _ in range(n_runs):
        p = int(nprng.integers(0, max(n - 40, 1)))
        c[p:p + int(nprng.integers(1, 40))] = 4
    return c


def _mutants(nprng, g, n, rate=0.03):
    """g members sharing a base sequence, each with its own SNPs."""
    base = _dna(nprng, n)
    out = []
    for _ in range(g):
        c = base.copy()
        pos = nprng.integers(0, n, int(n * rate))
        c[pos] = nprng.integers(0, 4, pos.shape[0], dtype=np.uint8)
        out.append(c)
    return out


def _doubled(members):
    """JAX doubled text of packed members, as numpy (codes2, gids2)."""
    codes, gids = jax_pack_members(members)
    cj, gj = jnp.asarray(codes), jnp.asarray(gids)
    rc = jnp.where(cj < 4, cj ^ 3, cj)[::-1]
    return (np.asarray(jnp.concatenate([cj, rc])),
            np.asarray(jnp.concatenate([gj, gj[::-1]])))


def _jax_sorted(codes2, gids2, kmax, KW, packed):
    fwd, pay = jks._extract_fwd_sweep(jnp.asarray(codes2), jnp.asarray(gids2),
                                      kmax, KW, packed=packed)
    if packed:
        return tuple(jax.lax.sort(list(fwd), num_keys=KW, is_stable=False)), None
    ops = jax.lax.sort(list(fwd) + [pay], num_keys=KW, is_stable=False)
    return tuple(ops[:KW]), ops[KW]


@pytest.mark.parametrize(
    "ks,n_members",
    [(K_GRID, 8), (K_GRID, 64), (K_GRID, 65), ([11, 21, 31, 35], 3),
     ([13, 40], 5), ([7, 9, 12, 20, 30], 8), (range(11, 32), 8)],
)
def test_planners_equal_jax(ks, n_members):
    assert tks.sweep_classes(ks) == jks.sweep_classes(ks)
    # the port's default limit is exp1's (the JAX package's XLA limit)
    assert (tks.plan_sweep(ks, n_members)
            == jks.plan_sweep(ks, n_members, jks.MASK_MEMBERS_XLA))
    assert (tks.plan_sweep(ks, n_members, jks.MASK_MEMBERS_PALLAS)
            == jks.plan_sweep(ks, n_members))
    for kmax in range(2, 64):
        KW = (2 * kmax + 31) // 32
        assert tks.can_pack_payload(kmax, KW) == jks.can_pack_payload(kmax, KW)


@pytest.mark.parametrize(
    "kmax,packed",
    [(15, False), (31, False), (35, False), (35, True), (49, False), (49, True)],
)
def test_extract_fwd_sweep_bit_exact(nprng, kmax, packed):
    KW = (2 * kmax + 31) // 32
    codes2, gids2 = _doubled([_dna(nprng, 700, 4), _dna(nprng, 90), _dna(nprng, 400, 3)])
    fj, pj = jks._extract_fwd_sweep(jnp.asarray(codes2), jnp.asarray(gids2),
                                    kmax, KW, packed=packed)
    codes_t, gids_t = interop.members_from_numpy(codes2, gids2, "cpu")
    ft, pt = tks._extract_fwd_sweep(codes_t, gids_t, kmax, KW, packed=packed)
    assert ft.shape == (KW, codes2.shape[0])
    for a, b in zip(fj, interop.words_to_numpy(ft)):
        np.testing.assert_array_equal(np.asarray(a), b)
    if packed:
        assert pj is None and pt is None
    else:
        np.testing.assert_array_equal(np.asarray(pj), interop.payload_to_numpy(pt))


@pytest.mark.parametrize("kmax", [35, 49])
def test_packed_sort_bit_exact(nprng, kmax):
    """Packed ties are identical elements: the sorted arrays are equal."""
    KW = (2 * kmax + 31) // 32
    codes2, gids2 = _doubled(_mutants(nprng, 4, 500))
    sj, _ = _jax_sorted(codes2, gids2, kmax, KW, True)
    ft, _ = tks._extract_fwd_sweep(*interop.members_from_numpy(codes2, gids2, "cpu"),
                                   kmax, KW, packed=True)
    st, _ = tks.sort_words(ft)
    for a, b in zip(sj, interop.words_to_numpy(st)):
        np.testing.assert_array_equal(np.asarray(a), b)


def _members_case(nprng, case):
    if case == "polyA":
        return [np.concatenate([np.zeros(300, np.uint8), _dna(nprng, 200)]),
                np.zeros(150, np.uint8), _dna(nprng, 250)]
    if case == "palindromes":
        pal = np.frombuffer(b"ACGCGT" * 30, np.uint8)
        pal = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), pal).astype(np.uint8)
        return [np.concatenate([pal, _dna(nprng, 200)]),
                np.concatenate([np.zeros(100, np.uint8), pal]), _dna(nprng, 300)]
    return _mutants(nprng, int(case), 120 if int(case) > 8 else 400)


@pytest.mark.parametrize(
    "case,ks",
    [("1", (7, 8, 12, 21, 33)), ("8", (7, 8, 12, 21, 33, 49)),
     ("33", (7, 12, 16, 21, 33)), ("64", (7, 12, 16, 21, 33)),
     ("polyA", (6, 7, 8, 10, 14, 20)), ("palindromes", (6, 8, 10, 14, 22, 34, 40, 48)),
     ("palindromes", (6, 8, 10, 14, 22, 34, 40, 49))],
)
def test_scan_on_jax_sorted_array(nprng, case, ks):
    """JAX's sorted array, carried across, through the port's scan (the
    CPU path of the kernel wrapper) equals _scan_multi_k_xla(raw=True)."""
    members = _members_case(nprng, case)
    g = len(members)
    classes, rest = jks.plan_sweep(ks, g, jks.MASK_MEMBERS_XLA)
    assert classes and not rest
    codes2, gids2 = _doubled(members)
    for kmax, KW, cks, packed in classes:
        sj, pj = _jax_sorted(codes2, gids2, kmax, KW, packed)
        want = np.asarray(jks._scan_multi_k_xla(sj, pj, cks, kmax, KW, g, 5000,
                                                packed=packed, raw=True))
        words = interop.words_from_numpy([np.asarray(w) for w in sj], "cpu")
        pay = interop.payload_from_numpy(None if pj is None else np.asarray(pj), "cpu")
        before = dict(ksweep_scan.launches)
        got = ksweep_scan.scan_multi_k(words, pay, cks, g, 5000, packed)
        assert ksweep_scan.launches == before  # the CPU path launches nothing
        assert got.dtype == torch.int64 and got.shape == (2, len(cks), g)
        np.testing.assert_array_equal(got.numpy(), want)
        if case == "palindromes" and 6 in cks:
            assert want[1].sum() > 0  # palindromic runs were really counted


def test_sweep_histograms_equal_jax_on_reference_grid(nprng):
    members = _mutants(nprng, 5, 600)
    want = jks.occurrence_histograms_sweep(members, K_GRID, cx=16)
    got = tks.occurrence_histograms_sweep(members, K_GRID, "cpu", cx=16)
    assert got == want


def test_pack_members_matches_jax_prefix(nprng):
    members = [_dna(nprng, 50), _dna(nprng, 7), _dna(nprng, 20)]
    jc, jg = jax_pack_members(members)
    tc, tg = interop.members_to_numpy(*pack_members(members, "cpu"))
    n = tc.shape[0]
    np.testing.assert_array_equal(jc[:n], tc)
    np.testing.assert_array_equal(jg[:n], tg)
    assert (jc[n:] == 4).all()  # the JAX package's shape padding is invalid


def test_per_k_path_and_budget_raise(nprng):
    """Grids the plan leaves to the per-k path (< 3 ks, > 64 members) run
    it, equal to the JAX package's sweep; a group over budget raises."""
    members = [_dna(nprng, 100) for _ in range(3)]
    assert (tks.occurrence_histograms_sweep(members, [11, 21], "cpu", cx=8)
            == jks.occurrence_histograms_sweep(members, [11, 21], cx=8))
    wide = [_dna(nprng, 30) for _ in range(65)]
    assert (tks.occurrence_histograms_sweep(wide, [7, 9, 11], "cpu", cx=70)
            == jks.occurrence_histograms_sweep(wide, [7, 9, 11], cx=70))
    need = incore_sweep_bytes(1000, K_GRID, 3)
    assert need == 2 * 1000 * 8 * (2 * 4 + 6)  # one packed KW=4 class
    check_incore_budget(1000, K_GRID, 3, need, "g")
    with pytest.raises(DeviceBudgetExceeded, match="stream under a budget"):
        check_incore_budget(1000, K_GRID, 3, need - 1, "g")


def test_scan_wrapper_rejects_bad_inputs():
    words = torch.zeros(4, 10, dtype=torch.int64)
    with pytest.raises(ValueError):
        ksweep_scan.scan_multi_k(words.to(torch.int32), None, [7], 2, 5000, True)
    with pytest.raises(ValueError):
        ksweep_scan.scan_multi_k(words, None, [7], 65, 5000, True)
    with pytest.raises(ValueError):
        ksweep_scan.scan_multi_k(words, None, [7], 2, 5000, False)  # payload missing
    with pytest.raises(ValueError):
        ksweep_scan.scan_multi_k(words[:1], None, [15], 2, 5000, True)  # no spare bits
