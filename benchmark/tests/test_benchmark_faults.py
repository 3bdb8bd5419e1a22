"""Whole runs of the harness on the CPU with the timed path broken
underneath: each fault a cell can have makes `correct` false.  The
faults: a step that returns its state unchanged (the first result it
computed, for every later call), half of the batch left out, an answer
altered where it is produced.  The cells run on one chip: there is no
exchange between chips to leave out."""

import io

import pytest

from bench_tiny import run_tiny
from khoice_tpu_torch.engine import ksweep
from khoice_tpu_torch.pipelines import exp1, exp6


def _stale(fn):
    """fn, returning its first result for every later call."""
    first = []

    def stale(*a, **k):
        if not first:
            first.append(fn(*a, **k))
        return first[0]

    return stale


def _exp1_unchanged(mp):
    mp.setattr(exp1, "occurrence_histograms_sweep", _stale(exp1.occurrence_histograms_sweep))


def _exp1_half(mp):
    sweep = exp1.occurrence_histograms_sweep
    mp.setattr(exp1, "occurrence_histograms_sweep",
               lambda members, *a, **k: sweep(members[:max(1, len(members) // 2)], *a, **k))


def _bump(hists):
    k = sorted(hists)[0]
    hists[k] = [hists[k][0] + 1] + list(hists[k][1:])
    return hists


def _exp1_altered(mp):
    sweep = exp1.occurrence_histograms_sweep
    mp.setattr(exp1, "occurrence_histograms_sweep", lambda *a, **k: _bump(sweep(*a, **k)))


def _sweep_unchanged(mp):
    mp.setattr(ksweep, "occurrence_histograms_sweep_packed",
               _stale(ksweep.occurrence_histograms_sweep_packed))


def _sweep_half(mp):
    sweep = ksweep.occurrence_histograms_sweep_packed
    mp.setattr(ksweep, "occurrence_histograms_sweep_packed",
               lambda packed, *a, **k: sweep(tuple(t[:t.shape[0] // 2] for t in packed), *a, **k))


def _sweep_altered(mp):
    sweep = ksweep.occurrence_histograms_sweep_packed
    mp.setattr(ksweep, "occurrence_histograms_sweep_packed",
               lambda *a, **k: _bump(sweep(*a, **k)))


def _exp6_unchanged(mp):
    mp.setattr(exp6, "read_votes_bulk_multi", _stale(exp6.read_votes_bulk_multi))


def _exp6_half(mp):
    votes = exp6.read_votes_bulk_multi
    mp.setattr(exp6, "read_votes_bulk_multi", lambda group, flat, spans, *a, **k: votes(
        group, flat, [(off, r // 2, l) for off, r, l in spans], *a, **k))


def _exp6_altered(mp):
    votes = exp6.read_votes_bulk_multi

    def altered(*a, **k):
        out = votes(*a, **k)
        out[0][0][0, 0] += 1  # the first read's vote for the first dataset
        return out

    mp.setattr(exp6, "read_votes_bulk_multi", altered)


FAULTS = {
    "exp1.4x8x5mbp": [_exp1_unchanged, _exp1_half, _exp1_altered],
    "ksweep.4x8x5mbp": [_sweep_unchanged, _sweep_half, _sweep_altered],
    "exp6.4x8x5mbp": [_exp6_unchanged, _exp6_half, _exp6_altered],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_makes_correct_false(monkeypatch, cell, fault):
    fault(monkeypatch)
    r = run_tiny(cell, out=io.StringIO(), err=io.StringIO())
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["compared"].values())
