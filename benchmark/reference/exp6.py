"""exp6's trial CSVs worked out from the generated database alone.

exp0 first, as the program's exp0 does it with the configuration's
defaults (seed 0, read seed 0, trial 1, in-pivot): per dataset a pivot
drawn from the sorted genome names, Illumina-like and ONT-like reads
simulated from it and subset to the k-mer budget at k = 31, with frozen
copies of the simulator (sim_reads.py, sim_error_models.py).

Then, per k, from the definition: a read's window (k bases A, C, G, T)
matches the datasets whose genomes (the rest of the set, which in-pivot
holds every genome of the dataset) contain its canonical k-mer; a window
matched by m datasets gives each of them lcm(1..D) / m votes.  The votes
are worked out in plain PyTorch: one table of every dataset's distinct
canonical k-mers with the mask of the datasets holding it, and a stable
sort of the table with the reads' windows.  Each read is classified by
its votes' argmax with a seeded tie-break, and the one-vs-rest accuracy
rows follow, both from the reference workflow's merge_lists.py.
"""

from __future__ import annotations

import math
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import kmers
from benchmark.reference.sim_reads import sim_illumina, sim_ont, subset_reads_kmers

READ_TYPES = ("illumina", "ont")
LABEL = {"illumina": "short", "ont": "long"}
HEADER = "k,pivotnum,TP,TN,FP,FN,TP-U,TN-U,FP-U,FN-U\n"
SEED = 0        # the program's default seed (pivots, tie-breaks)
READ_SEED = 0   # its default read simulation seed
TRIAL = 1


def dataset_reads(num: int, seqs: List[str], kmers_per_dataset: int) -> list:
    """[reads of each read type] of one dataset's pivot (its records)."""
    out = []
    for i, rt in enumerate(READ_TYPES):
        rrng = np.random.default_rng([READ_SEED, TRIAL, num, i])
        raw = sim_illumina(seqs, rrng) if rt == "illumina" else sim_ont(seqs, rrng)
        out.append(subset_reads_kmers(raw, rrng, kmers_per_dataset, 31))
    return out


def exp0_reads(records: Dict[int, Dict[str, list]], kmers_per_dataset: int):
    """({dataset: pivot name}, {(dataset, read type): [read strings]}).
    The datasets' reads are simulated in worker processes, one a dataset
    (each from its own seeded generators, so the reads are the same as in
    one process), all ended before it returns."""
    pivots, jobs = {}, {}
    for num in sorted(records):
        names = sorted(records[num])
        rng = np.random.default_rng([SEED, TRIAL, num])
        pivot = names[int(rng.integers(0, len(names)))]
        pivots[num] = pivot
        jobs[num] = [seq.tobytes().decode() for _name, seq in records[num][pivot]]
    with ProcessPoolExecutor(max_workers=len(jobs),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {num: pool.submit(dataset_reads, num, seqs, kmers_per_dataset)
                   for num, seqs in jobs.items()}
        reads = {(num, rt): part for num, f in futures.items()
                 for rt, part in zip(READ_TYPES, f.result())}
    return pivots, reads


def flat_reads(reads: Sequence[str]):
    """(uint8 codes of the reads joined by a 4, start offset of each read)."""
    codes = kmers.encode(np.frombuffer("N".join(reads).encode(), np.uint8))
    lens = np.fromiter((len(r) for r in reads), np.int64, len(reads))
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]])
    return codes, starts


def dataset_table(groups: Dict[int, List[np.ndarray]], k: int, device, fold32: bool = False):
    """(hi, lo, mask) of every canonical k-mer some dataset holds, with
    bit i set for the i-th dataset (sorted) that holds it."""
    his, los, bits = [], [], []
    for i, num in enumerate(sorted(groups)):
        hi, lo = kmers.union_keys(groups[num], k, device, fold32)
        his.append(hi)
        los.append(lo)
        bits.append(torch.full_like(hi, 1 << i))
    hi, lo, bit = torch.cat(his), torch.cat(los), torch.cat(bits)
    del his, los
    order = kmers.pair_order(hi, lo)
    hi, lo, bit = hi[order], lo[order], bit[order]
    new = kmers.run_starts(hi, lo)
    run = torch.cumsum(new.to(torch.int64), 0) - 1
    mask = torch.zeros(int(new.sum()), dtype=torch.int64, device=hi.device).index_add_(0, run, bit)
    return hi[new], lo[new], mask


def lookup(table, qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """The table's mask of each query key (0 where the table lacks it)."""
    thi, tlo, tmask = table
    nt = thi.shape[0]
    hi, lo = torch.cat([thi, qhi]), torch.cat([tlo, qlo])
    order = kmers.pair_order(hi, lo)  # stable: a run's table entry comes first
    new = kmers.run_starts(hi[order], lo[order])
    del hi, lo
    run = torch.cumsum(new.to(torch.int64), 0) - 1
    first = order[new]
    run_mask = torch.where(first < nt, tmask[first.clamp(max=max(nt - 1, 0))], 0)
    is_q = order >= nt
    out = torch.zeros(qhi.shape[0], dtype=torch.int64, device=qhi.device)
    out[order[is_q] - nt] = run_mask[run[is_q]]
    return out


def read_votes(table, reads: Sequence[str], k: int, D: int, device, fold32: bool = False):
    """(votes int64 [R, D], unmatched [R], windows [R]) of each read: a
    window matched by m datasets gives each lcm(1..D) // m; unmatched
    counts the read's windows that no dataset holds."""
    codes, starts = flat_reads(reads)
    hi, lo, pos = kmers.canonical_windows(torch.from_numpy(codes).to(device), k, fold32)
    read = torch.searchsorted(torch.from_numpy(starts).to(device), pos, right=True) - 1
    mask = lookup(table, hi, lo)
    del hi, lo, pos
    lcm = math.lcm(*range(1, D + 1))
    bits = torch.stack([(mask >> d) & 1 for d in range(D)])
    pc = bits.sum(0)
    weight = torch.where(pc > 0, lcm // pc.clamp(min=1), 0)
    votes = torch.zeros(len(reads) * D, dtype=torch.int64, device=device)
    for d in range(D):
        votes.index_add_(0, read * D + d, bits[d] * weight)
    windows = torch.bincount(read, minlength=len(reads))
    unmatched = torch.bincount(read[pc == 0], minlength=len(reads))
    return tuple(t.cpu().numpy() for t in (votes.view(len(reads), D), unmatched, windows))


# --- classification and accuracy, from the reference workflow's
# src/merge_lists.py: read-level argmax of the votes with a random choice
# among the maxima (:151-183), one-vs-rest TP/TN/FP/FN rows
# (calculate_accuracy_values, :35-51); the trial CSV concatenates the
# per-k rows in the lexicographic order of their files' names, as the
# workflow's glob of those files returns them.  The workflow draws its
# tie-breaks unseeded; the seeded stream below is the configuration's
# (seed 0, the trial, k, the dataset), drawn once for all tied reads in
# read order.

def classify_reads(votes: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The class of each read: the dataset with the most votes; where
    several share the most (every dataset, for a read without votes), the
    draw-th of them in dataset order, draw uniform below their number."""
    votes = np.asarray(votes)
    is_max = votes == votes.max(axis=1, keepdims=True)
    nmax = is_max.sum(axis=1)
    maxima_first = np.argsort(~is_max, axis=1, kind="stable")
    draw = np.zeros(len(votes), np.int64)
    tied = np.flatnonzero(nmax > 1)
    if tied.size:
        draw[tied] = rng.integers(0, nmax[tied])
    return maxima_first[np.arange(len(votes)), draw]


def accuracy_rows(confusion: np.ndarray, k: str) -> List[list]:
    """[k, dataset, TP, TN, FP, FN] of each dataset against the rest, from
    a confusion matrix with a row per dataset of the reads' origin and a
    column per class, the last for reads left unidentified."""
    cm = np.asarray(confusion, dtype=np.int64)
    rows = []
    for p in range(cm.shape[0]):
        tp = cm[p, p]
        fp = cm[:, p].sum() - tp
        fn = cm[p].sum() - tp
        tn = cm.sum() - cm[p].sum() - fp
        rows.append([k, p] + [int(x) for x in (tp, tn, fp, fn)])
    return rows


def by_file_name(k_values: Sequence[int]) -> List[int]:
    return sorted(k_values, key=lambda k: f"k_{k}_accuracy_values.csv")


def expected(records, cfg: dict, device, vote_ks=(), fold32: bool = False, reads=None):
    """({"short": trial_1_short_acc.csv text, "long": trial_1_long_acc.csv
    text}, {(k, read type): [(votes, unmatched, windows) of each
    dataset's reads]} for the ks of `vote_ks`) of exp6 on the generated
    database (`fold32`: the control's; `reads`: exp0_reads' reads, where
    the caller has them already)."""
    ks = [int(k) for k in cfg["k_values"]]
    nums = sorted(records)
    D = len(nums)
    if reads is None:
        _pivots, reads = exp0_reads(records, int(cfg["kmers_per_dataset"]))
    groups = {num: [kmers.genome_codes(records[num][g]) for g in sorted(records[num])]
              for num in nums}
    lines = {rt: {} for rt in READ_TYPES}
    kept = {}
    for k in ks:
        table = dataset_table(groups, k, device, fold32)
        for rt in READ_TYPES:
            cm = np.zeros((D, D + 1), np.int64)
            for i, num in enumerate(nums):
                out = read_votes(table, reads[(num, rt)], k, D, device, fold32)
                if k in vote_ks:
                    kept.setdefault((k, rt), []).append(out)
                classes = classify_reads(out[0], np.random.default_rng([SEED, TRIAL, k, num]))
                cm[i] = np.bincount(classes, minlength=D + 1)
            lines[rt][k] = "".join(",".join(str(x) for x in row + row[2:]) + "\n"
                                   for row in accuracy_rows(cm, str(k)))
        del table
    csvs = {LABEL[rt]: HEADER + "".join(lines[rt][k] for k in by_file_name(ks))
            for rt in READ_TYPES}
    return csvs, kept
