# Copied from khoice_tpu/analysis/msa.py.
"""MSA column entropy + conserved-region cut points.

Equivalent of src/analyze_msa.py in the reference: per-column Shannon
entropy of a multiple sequence alignment (src/analyze_msa.py:10-33), a
250bp rolling average, and extraction of low-entropy cut points used to
partition virus genomes into sections (:50-90).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


def column_entropy(column: Sequence[str]) -> float:
    """Shannon entropy over symbol frequencies of one alignment column."""
    counts: Dict[str, int] = {}
    for ch in column:
        counts[ch] = counts.get(ch, 0) + 1
    n = len(column)
    ent = 0.0
    for c in counts.values():
        p = c / n
        ent -= p * math.log2(p)
    return ent


def msa_entropy(rows: Sequence[str]) -> np.ndarray:
    lengths = {len(r) for r in rows}
    assert len(lengths) == 1, "MSA rows must have equal length"
    n = lengths.pop()
    return np.array(
        [column_entropy([r[i] for r in rows]) for i in range(n)], np.float64
    )


def rolling_average(values: np.ndarray, window: int = 250) -> np.ndarray:
    """Centered-ish rolling mean with partial windows at the edges."""
    csum = np.concatenate([[0.0], np.cumsum(values)])
    n = values.shape[0]
    out = np.empty(n)
    for i in range(n):
        lo = max(0, i - window + 1)
        out[i] = (csum[i + 1] - csum[lo]) / (i + 1 - lo)
    return out


def find_cut_points(
    smoothed: np.ndarray,
    threshold: float = 0.3,
    min_gap: int = 500,
) -> List[int]:
    """Low-entropy positions (below threshold), at least min_gap apart —
    the conserved anchors used to split genomes into sections."""
    cuts: List[int] = []
    for i, v in enumerate(smoothed):
        if v < threshold and (not cuts or i - cuts[-1] >= min_gap):
            cuts.append(i)
    return cuts


def sections_from_cuts(length: int, cuts: Sequence[int]) -> List[Tuple[int, int]]:
    bounds = [0] + list(cuts) + [length]
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1) if bounds[i + 1] > bounds[i]]


# ---------------------------------------------------------------------------
# Reference-exact surface: clustal-style MSA file in, figures + section
# FASTAs out (src/analyze_msa.py:34-47 figures, :50-90 extraction).
# ---------------------------------------------------------------------------


def entropy_scores_nat(rows: Sequence[str]) -> List[float]:
    """Per-column Shannon entropy in NATS (math.log), the reference's unit
    (src/analyze_msa.py:26-28), over one block of equal-length rows."""
    lengths = {len(r) for r in rows}
    assert len(lengths) == 1, "all alignments should be equal length"
    n_cols = lengths.pop()
    out: List[float] = []
    for i in range(n_cols):
        counts: Dict[str, int] = {}
        for r in rows:
            ch = r[i]
            counts[ch] = counts.get(ch, 0) + 1
        ent = 0.0
        for c in counts.values():
            p = c / len(rows)
            ent -= p * math.log(p)
        out.append(ent)
    return out


def parse_msa_file(path: str) -> Tuple[List[float], Dict[str, str]]:
    """Parse a clustal-style MSA file into (per-column entropy in nats,
    {genome name: full gapped alignment}).

    Mirrors src/analyze_msa.py:93-121: skips the 3 header lines, treats
    2-field lines as alignment rows, accumulates per-genome alignments
    across blocks, and scores entropy block by block (conservation '*'
    lines are excluded from both).
    """
    with open(path) as fd:
        lines = fd.readlines()

    block: List[str] = []
    entropy: List[float] = []
    genomes: Dict[str, str] = {}

    def flush() -> None:
        rows = [ln.split()[1] for ln in block if "*" not in ln]
        if rows:
            entropy.extend(entropy_scores_nat(rows))

    for line in lines[3:]:
        fields = line.split()
        if len(line) > 1 and len(fields) == 2:
            block.append(line.strip())
            if "*" in line:
                continue
            name, seq = fields
            genomes[name] = genomes.get(name, "") + seq
        elif block:
            flush()
            block = []
    if block:
        flush()

    assert len({len(v) for v in genomes.values()}) <= 1, (
        "each genome's alignment must have equal length"
    )
    return entropy, genomes


def reference_rolling(values: Sequence[float], window: int = 250) -> np.ndarray:
    """'valid'-mode 250bp moving average (src/analyze_msa.py:42)."""
    return np.convolve(np.asarray(values, np.float64), np.ones(window) / window, mode="valid")


def generate_entropy_figures(msa_file: str, entropy: Sequence[float]) -> List[str]:
    """Entropy + rolling-average bar figures (src/analyze_msa.py:34-47):
    writes <msa_file>.png and <msa_file>.rolling.png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    paths = []
    for vals, suffix, ylabel in (
        (np.asarray(entropy), ".png", "Shannon Entropy"),
        (reference_rolling(entropy), ".rolling.png",
         "Avg Shannon Entropy (over 250 bp windows)"),
    ):
        fig, ax = plt.subplots()
        ax.bar(range(1, len(vals) + 1), vals, width=1.0)
        ax.set_xlabel("Base Position in DNA Sequence")
        ax.set_ylabel(ylabel)
        out = msa_file + suffix
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        paths.append(out)
    return paths


def extract_sections(
    rolling: np.ndarray,
    msa_file: str,
    genomes: Dict[str, str],
    num_to_extract: int,
    output_dir: str,
    threshold: float = 0.35,
) -> List[str]:
    """Cut the MSA at the reference's three entropy crossings and write
    per-genome section FASTAs (src/analyze_msa.py:49-90).

    start = first pos >= 500 with rolling > threshold; middle = first
    >= 3000 with rolling <= threshold; end = first >= 5000 with rolling
    > threshold. Writes <msa>.rolling_with_cuts.png plus
    seq_{i}_left.fna / seq_{i}_right.fna (gaps stripped) for the first
    num_to_extract genomes.
    """
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    start = next((i for i in range(500, len(rolling)) if rolling[i] > threshold), None)
    middle = next((i for i in range(3000, len(rolling)) if rolling[i] <= threshold), None)
    end = next((i for i in range(5000, len(rolling)) if rolling[i] > threshold), None)
    if start is None or middle is None or end is None:
        missing = [n for n, v in (("start", start), ("middle", middle), ("end", end)) if v is None]
        raise ValueError(
            f"no entropy threshold crossing for {missing} (threshold={threshold}, "
            f"rolling length={len(rolling)}); the MSA does not follow the "
            "expected Enterovirus section structure"
        )

    fig, ax = plt.subplots()
    ax.bar(range(1, len(rolling) + 1), rolling, width=1.0)
    for x in (start, middle, end):
        ax.axvline(x=x, color="red", linestyle="dashed")
    ax.axhline(y=threshold, color="black", linestyle="solid")
    ax.set_xlabel("Base Position in DNA Sequence")
    ax.set_ylabel("Avg Shannon Entropy (over 250 bp windows)")
    cuts_png = msa_file + ".rolling_with_cuts.png"
    fig.savefig(cuts_png, dpi=150, bbox_inches="tight")
    plt.close(fig)

    written = [cuts_png]
    num_to_extract = min(max(1, num_to_extract), len(genomes))
    for i, key in enumerate(genomes):
        aln = genomes[key]
        left = aln[start:middle].replace("-", "")
        right = aln[middle:end].replace("-", "")
        assert aln[middle:end].count("-") + len(right) == end - middle
        assert aln[start:middle].count("-") + len(left) == middle - start
        for side, seq in (("left", left), ("right", right)):
            path = os.path.join(output_dir, f"seq_{i}_{side}.fna")
            with open(path, "w") as out_fd:
                out_fd.write(f">seq_{i}_{side}\n{seq}\n")
            written.append(path)
        if i >= num_to_extract - 1:
            break
    return written


def analyze_msa_file(
    msa_file: str,
    output_dir: str | None = None,
    num_to_extract: int = 0,
    plots: bool = False,
) -> Tuple[List[float], Dict[str, str]]:
    """End-to-end equivalent of `python analyze_msa.py` (src/analyze_msa.py
    main): parse, optionally emit figures, optionally extract sections."""
    entropy, genomes = parse_msa_file(msa_file)
    if plots:
        generate_entropy_figures(msa_file, entropy)
    if output_dir is not None and num_to_extract > 0:
        extract_sections(
            reference_rolling(entropy), msa_file, genomes, num_to_extract, output_dir
        )
    return entropy, genomes
