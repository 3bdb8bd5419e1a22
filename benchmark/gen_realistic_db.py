# Copied from tools/gen_realistic_db.py (the benchmark's own copy: later changes to tools/ cannot move its inputs).
"""Generate a realistic-scale khoice database for end-to-end runs.

The reference's input layout (`dataset_{i}/*.fna.gz`, prepare_data.smk
expectations) at Mbp scale with the pathologies real genomes have:

- shared conserved cores across datasets (so across-group occurrence
  counts exceed 1),
- within-dataset divergence via SNPs (1-2%) + indel blocks,
- repeat families (interspersed multi-kbp repeats at high copy number,
  the classic sort-skew stressor),
- GC skew segments (breaks uniform-key CDF assumptions),
- occasional N runs (validity masking),
- multi-record FASTA (plasmid-like short contigs).

The copy differs from the original in one respect: `generate` returns
every record it makes (name, ASCII bytes) as well as writing it, and
writes nothing when `out` is None, so the benchmark hands the same bases
to the program (through the files) and to its reference (in memory).
The draws from the seed, and so the bases, are the original's.

Usage: python benchmark/gen_realistic_db.py OUT_DIR [--datasets 4]
       [--genomes 8] [--mbp 5.0] [--seed 7]
"""

import argparse
import gzip
import os

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def _rand_seq(rng: np.random.Generator, n: int, gc: float = 0.5) -> np.ndarray:
    p_gc = gc / 2.0
    p_at = (1.0 - gc) / 2.0
    return rng.choice(BASES, size=n, p=[p_at, p_gc, p_gc, p_at])


def _mutate(rng: np.random.Generator, seq: np.ndarray, snp_rate: float) -> np.ndarray:
    out = seq.copy()
    n_mut = int(len(seq) * snp_rate)
    pos = rng.integers(0, len(seq), n_mut)
    out[pos] = rng.choice(BASES, size=n_mut)
    return out


def make_dataset_ancestor(
    rng: np.random.Generator, core: np.ndarray, mbp: float
) -> np.ndarray:
    n = int(mbp * 1e6)
    parts = []
    # GC-skewed unique backbone segments interleaved with the shared core
    # and a repeat family
    repeat = _rand_seq(rng, 3000, gc=0.62)
    remaining = n - len(core)
    seg = max(50_000, remaining // 12)
    used = 0
    gc_cycle = [0.35, 0.5, 0.68, 0.5]
    i = 0
    while used < remaining:
        ln = min(seg, remaining - used)
        parts.append(_rand_seq(rng, ln, gc=gc_cycle[i % 4]))
        used += ln
        # sprinkle the repeat family (high copy number -> heavy key skew)
        if i % 2 == 0 and used < remaining:
            parts.append(repeat)
            used += len(repeat)
        i += 1
    parts.insert(len(parts) // 2, core)
    return np.concatenate(parts)[:n]


def genome_records(seq: np.ndarray, name: str, rng: np.random.Generator):
    """[(record name, ASCII uint8 array)]: the genome with a couple of N
    runs, and a short plasmid-like second record."""
    seq = seq.copy()
    for _ in range(3):
        p = rng.integers(0, max(len(seq) - 500, 1))
        seq[p : p + rng.integers(20, 400)] = ord("N")
    plasmid = _rand_seq(rng, int(rng.integers(5_000, 20_000)), gc=0.45)
    return [(name, seq), (name + "_plasmid", plasmid)]


def write_records(path: str, records) -> None:
    with gzip.open(path, "wb", compresslevel=1) as fd:
        for rec, s in records:
            fd.write(b">" + rec.encode() + b"\n")
            b = s.tobytes()
            for lo in range(0, len(b), 80):
                fd.write(b[lo : lo + 80] + b"\n")


def generate(out, datasets: int = 4, genomes: int = 8, mbp: float = 5.0, seed: int = 7):
    """{dataset: {genome name: [(record name, ASCII uint8 array), ...]}};
    each genome is also written to OUT/dataset_{d}/genome_{g}.fna.gz
    unless `out` is None."""
    rng = np.random.default_rng(seed)
    # conserved core shared across ALL datasets (~5% of each genome)
    core = _rand_seq(rng, int(mbp * 1e6 * 0.05), gc=0.5)
    db = {}
    for d in range(1, datasets + 1):
        if out is not None:
            os.makedirs(os.path.join(out, f"dataset_{d}"), exist_ok=True)
        anc = make_dataset_ancestor(rng, core, mbp)
        db[d] = {}
        for g in range(1, genomes + 1):
            seq = _mutate(rng, anc, snp_rate=0.01 + 0.002 * g)
            # indel block: drop a random 0.5% slice so lengths differ
            cut = rng.integers(0, len(seq) - len(seq) // 200)
            seq = np.delete(seq, slice(int(cut), int(cut) + len(seq) // 200))
            recs = genome_records(seq, f"ds{d}_g{g}", rng)
            db[d][f"genome_{g}"] = recs
            if out is not None:
                write_records(os.path.join(out, f"dataset_{d}", f"genome_{g}.fna.gz"), recs)
    return db


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--datasets", type=int, default=4)
    ap.add_argument("--genomes", type=int, default=8)
    ap.add_argument("--mbp", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    generate(args.out, args.datasets, args.genomes, args.mbp, args.seed)
    print(f"{args.datasets} datasets x {args.genomes} genomes x ~{args.mbp} Mbp", flush=True)


if __name__ == "__main__":
    main()
