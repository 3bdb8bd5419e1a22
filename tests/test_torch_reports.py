"""The port's report writers and metric math (khoice_tpu_torch/reports/)
over the nonzero extent of a histogram: write_hist_txt's bytes against
the per-line format, summarize_histogram_type1's floats, bit for bit,
against the padded list and the JAX package's, and exp1's step_4/step_8
files against the histograms its CSVs were computed from."""

import random

import numpy as np
import pytest
import torch

from khoice_tpu.reports.metrics import summarize_histogram_type1 as jax_summarize
from khoice_tpu_torch.pipelines import exp1
from khoice_tpu_torch.reports.csvio import read_hist_txt, write_hist_txt
from khoice_tpu_torch.reports.metrics import nonzero_extent, summarize_histogram_type1
from test_exp1 import make_groups

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)


def _spec_bytes(hist, cx):
    """The histogram file as one line per bin, i = 1..cx, zero past the list."""
    return "".join(f"{i + 1}\t{int(hist[i]) if i < len(hist) else 0}\n"
                   for i in range(cx)).encode()


def _occurrence(n_nonzero, seed, gaps=()):
    """Counts of a histogram over n_nonzero members, a few bins zero."""
    r = random.Random(seed)
    return [0 if i in gaps else r.randrange(1, 10**7) for i in range(n_nonzero)]


WRITE_CASES = {
    "all_zeros": (10000, [0] * 10000),
    "empty": (10000, []),
    "bin_1_only": (10000, [17] + [0] * 9999),
    "last_bin_nonzero": (10000, [0] * 9999 + [3]),
    "interior_zeros": (10000, _occurrence(96, 1, gaps={0, 5, 50}) + [0] * 9904),
    "dense_10000": (10000, _occurrence(10000, 2)),
    "longer_than_cx": (300, _occurrence(400, 3)),
    "longer_than_cx_zero_at_cx": (300, _occurrence(299, 4) + [0] + _occurrence(100, 5)),
    "shorter_than_cx": (300, _occurrence(50, 6)),
    "cx_5": (5, [4, 0, 2]),
    "cx_5_last_bin": (5, [0, 0, 0, 0, 9, 8]),
    "numpy_array": (300, np.array(_occurrence(8, 7) + [0] * 292, dtype=np.int64)),
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_write_hist_txt_equals_per_line_format(tmp_path, case):
    cx, hist = WRITE_CASES[case]
    path = tmp_path / "k_21" / "h.txt"
    write_hist_txt(str(path), hist, cx=cx)
    assert path.read_bytes() == _spec_bytes(hist, cx)
    assert read_hist_txt(str(path)) == [int(v) for v in hist[:cx]] + [0] * (cx - len(hist[:cx]))


@pytest.mark.parametrize("hist, want", [
    ([], 0), ([0] * 10, 0), ([1], 1), ([0, 0, 5], 3), ([5, 0, 0], 1), ([0, 2, 0, 3, 0], 4),
    (np.array([0, 7, 0]), 2), ([1] + [0] * 9999, 1), ([0] * 5000 + [1] + [0] * 4999, 5001),
    ([0] * 4999 + [2, 0, 3] + [0] * 4998, 5002), (list(range(1, 10001)), 10000),
])
def test_nonzero_extent(hist, want):
    assert nonzero_extent(hist) == want


# (members, across, nonzero bins): within a group of n members, and the
# across set over 2 and 4 groups, whose bands [5, 20] lie past its bins
SUMMARY_CASES = {
    "within_n1": (1, False, _occurrence(1, 11)),
    "within_n8": (8, False, _occurrence(8, 12)),
    "within_n8_gaps": (8, False, _occurrence(8, 13, gaps={2, 7})),
    "within_n96": (96, False, _occurrence(96, 14, gaps={40, 90})),
    "across_2_groups": (2, True, _occurrence(2, 15)),
    "across_4_groups": (4, True, _occurrence(4, 16)),
    "across_4_groups_gap": (4, True, _occurrence(4, 17, gaps={1})),
}


def _bits(metrics):
    return [float(x).hex() for x in metrics]


@pytest.mark.parametrize("k", [7, 31])
@pytest.mark.parametrize("case", sorted(SUMMARY_CASES))
def test_summarize_type1_exact_on_padded_and_trimmed(case, k):
    n, across, counts = SUMMARY_CASES[case]
    padded = counts + [0] * (10000 - len(counts))
    trimmed = counts[:nonzero_extent(counts)]
    want = jax_summarize(padded, n, across, k)
    for hist in (padded, trimmed, counts):
        got = summarize_histogram_type1(hist, n, across, k)
        assert got == want and _bits(got) == _bits(want)


@pytest.mark.parametrize("hist_cx", [10000, 2])
def test_exp1_hist_files_equal_the_histograms_it_summarised(rng, tmp_path, monkeypatch, hist_cx):
    """Every step_4/step_8 file, read back, is the histogram exp1 took its
    CSV row from, zero-filled to hist_cx (hist_cx 2 cuts the groups' 3-bin
    histograms)."""
    seen = []

    def recording(hist, n, across, k):
        seen.append((k, n, across, list(hist)))
        return summarize_histogram_type1(hist, n, across, k)

    monkeypatch.setattr(exp1, "summarize_histogram_type1", recording)
    ks = [11, 21, 31, 35]
    groups = make_groups(rng, n_groups=2, genomes_per_group=3, glen=300)
    out = tmp_path / "out"
    exp1.run_exp1(groups, ks, str(out), "cpu", hist_cx=hist_cx)
    files = [out / f"step_4/k_{k}/dataset_{num}/dataset_{num}_k{k}_hist.txt"
             for k in ks for num in sorted(groups)]
    files += [out / f"step_8/k_{k}/all_datasets_k{k}_hist.txt" for k in ks]
    assert len(seen) == len(files) == 3 * len(ks)
    for (k, n, across, hist), path in zip(seen, files):
        assert len(hist) <= hist_cx and sum(hist) > 0
        assert read_hist_txt(str(path)) == hist + [0] * (hist_cx - len(hist)), (k, n, across)
