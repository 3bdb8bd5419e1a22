# Frozen copy of khoice_tpu_torch/sim/reads.py (sim_illumina, sim_ont, subset_reads_kmers: exp0's read simulation), so that no change to the program moves the benchmark's reference reads.
"""Seeded read simulators + read subsetting (exp0 toolchain equivalents).

The reference shells out to external C++ simulators — ART HS25 for
150bp Illumina reads at 10x fold-coverage and pbsim with an HMM error
model, accuracy 0.95, lengths 900-1100 (reference:
workflow/rules/prepare_data.smk:81,97-98) — and to src/grab_reads.py /
src/subset_reads.py for sampling. Exact ART/pbsim output cannot be
reproduced (their error models are external binaries); these equivalents
keep the parameters that matter downstream (read length/coverage/error
rate regimes) and are fully deterministic under a numpy seed, per the
contract's "make seedable" note (SURVEY.md section 7.1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

_BASES = np.array(list("ACGT"))


def _mutate_sub(read: np.ndarray, positions: np.ndarray, rng: np.random.Generator):
    """Substitute bases at positions with a uniformly different base."""
    if positions.size == 0:
        return read
    shift = rng.integers(1, 4, size=positions.size)
    read[positions] = (read[positions] + shift) % 4
    return read


def _codes_of(seq: str) -> np.ndarray:
    lut = np.full(256, 255, np.uint8)
    for i, ch in enumerate("ACGT"):
        lut[ord(ch)] = i
        lut[ord(ch.lower())] = i
    arr = lut[np.frombuffer(seq.encode(), np.uint8)]
    return arr[arr != 255]  # simulators sample from unambiguous bases only


def _to_str(codes: np.ndarray) -> str:
    return "".join(_BASES[codes])


_ASCII = np.frombuffer(b"ACGT", np.uint8)


def _rows_to_strs(rows: np.ndarray) -> List[str]:
    """Batch code-matrix -> strings via one ASCII lookup + one buffer."""
    r, l = rows.shape
    buf = np.ascontiguousarray(_ASCII[rows]).tobytes()
    return [buf[i * l : (i + 1) * l].decode("ascii") for i in range(r)]


def sim_illumina(
    seqs: Sequence[str],
    rng: np.random.Generator,
    coverage: float = 10.0,
    read_len: int = 150,
    subst_rate: float = 0.0015,
    profile=None,
) -> List[str]:
    """Illumina-like reads with a per-position quality profile: errors
    rise toward the 3' end like ART's empirical HS25 profile (reference
    prepare_data.smk:81). profile defaults to
    error_models.IlluminaProfile.hs25_like(read_len, subst_rate)."""
    from .sim_error_models import IlluminaProfile

    if profile is None:
        profile = IlluminaProfile.hs25_like(read_len, mean_rate=subst_rate)
    out: List[str] = []
    for seq in seqs:
        codes = _codes_of(seq)
        n = codes.shape[0]
        if n < read_len:
            continue
        n_reads = int(math.ceil(coverage * n / read_len))
        starts = rng.integers(0, n - read_len + 1, size=n_reads)
        # fully vectorized over reads (the scalar per-read loop dominated
        # realistic-scale exp0 wall time): gather [R, L], one error mask
        # from the positional profile, one substitution shift
        reads = codes[starts[:, None] + np.arange(read_len)[None, :]]
        errm = rng.random((n_reads, read_len)) < profile.pos_error[None, :]
        shift = rng.integers(1, 4, size=(n_reads, read_len), dtype=np.uint8)
        reads = np.where(errm, (reads + shift) & 3, reads)
        out.extend(_rows_to_strs(reads))
    return out


def sim_ont(
    seqs: Sequence[str],
    rng: np.random.Generator,
    depth: float = 10.0,
    accuracy_mean: float = 0.95,
    length_min: int = 900,
    length_max: int = 1100,
    model=None,
    model_file: str | None = None,
) -> List[str]:
    """ONT-like long reads with an error-burst quality HMM (pbsim regime,
    prepare_data.smk:97-98): per-base Phred qualities come from an HMM
    walk (model_file parses the on-disk format, see
    error_models.QualityHmm.from_pbsim_file; PBSIM_MODEL in
    config/config.yaml:11), error probability is 10^(-q/10), and error
    TYPES follow pbsim2's sub:ins:del difference ratio. Defaults to a
    2-state bursty model calibrated to accuracy_mean."""
    from .sim_error_models import QualityHmm, load_model_file

    if model is None:
        model = (
            # sniffs the layout: pbsim1 model_qc tables AND the HMM
            # contract both load; unknown layouts fail loudly
            load_model_file(model_file, accuracy_mean=accuracy_mean)
            if model_file
            else QualityHmm.from_accuracy(accuracy_mean)
        )
    from .sim_error_models import sample_qualities_batch

    rsub, rins, rdel = model.difference_ratio
    rtot = rsub + rins + rdel
    psub, pins = rsub / rtot, rins / rtot
    out: List[str] = []
    for seq in seqs:
        codes = _codes_of(seq)
        n = codes.shape[0]
        if n < length_max:
            continue
        mean_len = (length_min + length_max) / 2
        n_reads = int(math.ceil(depth * n / mean_len))
        # batch draws (quality walks vectorized across reads; the scalar
        # per-BASE loop was 50M Python iterations at realistic scale)
        lens = rng.integers(length_min, length_max + 1, size=n_reads)
        starts = rng.integers(0, n - lens + 1)
        lmax = int(length_max)
        quals = sample_qualities_batch(model, rng, n_reads, lmax)
        errp = model.error_probs(quals)
        live = np.arange(lmax)[None, :] < lens[:, None]
        err = (rng.random((n_reads, lmax)) < errp) & live
        kinds = rng.random((n_reads, lmax))
        shifts = rng.integers(1, 4, size=(n_reads, lmax), dtype=np.uint8)
        sub = err & (kinds < psub)
        ins = err & (kinds >= psub) & (kinds < psub + pins)
        dele = err & (kinds >= psub + pins)
        # fully vectorized indel assembly across the whole read batch (the
        # per-read loop was ~50k iterations x ~10 small-array numpy calls
        # per dataset at reference scale): emit counts per position are
        # 0 = deletion, 1 = keep, 2 = keep + inserted base after it; one
        # flat np.repeat over [R * lmax] builds every read at once, and
        # insertion slots are the run ends at flat `ins` positions.
        idx = (starts[:, None] + np.arange(lmax, dtype=np.int64)[None, :])
        mat = codes[np.minimum(idx, n - 1)]  # uint8
        mat = np.where(sub, (mat + shifts) & 3, mat)
        counts = np.where(live, 1 - dele.astype(np.int8) + ins, 0).astype(np.int8)
        flat_counts = counts.reshape(-1)
        result = np.repeat(mat.reshape(-1), flat_counts)
        ins_flat = ins.reshape(-1)
        n_ins = int(ins_flat.sum())
        if n_ins:
            ends = np.cumsum(flat_counts, dtype=np.int64)
            result[ends[ins_flat] - 1] = rng.integers(
                0, 4, size=n_ins, dtype=np.uint8
            )
        out_lens = counts.sum(axis=1, dtype=np.int64)
        buf = _ASCII[result].tobytes()
        offs = np.concatenate([[0], np.cumsum(out_lens)])
        out.extend(
            buf[offs[r] : offs[r + 1]].decode("ascii")
            for r in range(n_reads)
            if out_lens[r]
        )
    return out


def subset_reads_kmers(
    reads: Sequence[str],
    rng: np.random.Generator,
    num_kmers: int,
    k: int,
) -> List[str]:
    """Sample reads without replacement until the k-mer budget
    sum(len - k + 1) >= num_kmers is reached (src/subset_reads.py:22-47).
    Raises if the input cannot satisfy the budget, like the reference."""
    order = rng.permutation(len(reads))
    out: List[str] = []
    total = 0
    for i in order:
        if total >= num_kmers:
            break
        r = reads[i]
        out.append(r)
        total += max(0, len(r) - k + 1)
    if total < num_kmers:
        raise ValueError(
            f"read set has only {total} k-mers, {num_kmers} requested"
        )
    return out
