"""Entry hooks of the PyTorch/CUDA port (the counterpart of __graft_entry__.py).

entry(device="cuda"): the fused exp1 inner step at k = 31 on 4 x 2^14
bases from numpy's default_rng(0): the per-k packed occurrence histogram
(kernel A in its gid-packed form, the radix sort, kernel B) and the
canonical k-mer count of the same codes (kernel A and the sort), as
`fn(codes, gids, k) -> (hist, table.keys, table.counts)`.  The JAX
package's step traces k (`_occurrence_histogram_dyn_packed`); the port has
no dynamic-k path and takes the static one
(engine/occurrence.py::occurrence_histogram_packed), which gives the same
histogram.

dryrun_multichip(n_devices, device="cuda"): the whole sharded pipeline
(khoice_tpu_torch/dist/) in `n_devices` ranks (dist/launch.py::run_ranks)
on the adversarial genomes of __graft_entry__.py, each rank's results held
against the single-device engine and the dict-based oracle: the per-k
occurrence histogram, the 6-k sweep, exp2's pivot_rest sweep, the table
algebra's union, intersect and subtract dumps, and exp6's read votes.
On cuda the ranks run over NCCL, one card each, and it raises when there
are fewer cards than ranks; on cpu over gloo.  Neither falls back to the
other.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from khoice_tpu_torch.cli import _device

K = 31  # entry()'s k
DRYRUN_K = 21
SWEEP_KS = [9, 15, 21, 31, 35, 49]  # 2- and 4-word classes
CLASSIFY_KS = [9, 15, 21]


def entry(device="cuda"):
    from khoice_tpu_torch.engine import ops
    from khoice_tpu_torch.engine.occurrence import occurrence_histogram_packed, pack_members

    dev = _device(device)
    n_members = 4

    def step(codes, gids, k):
        # the fused exp1 inner op: gid-packed extraction, sort, occurrence
        # histogram; then the kmc-shaped count of the same codes
        hist = occurrence_histogram_packed((codes, gids), n_members, k, cs=5000, cx=255)
        t = ops.count_codes(codes, k=k, cs=255)
        return torch.tensor(hist, dtype=torch.int64), t.keys, t.counts

    rng = np.random.default_rng(0)
    members = [rng.integers(0, 4, size=1 << 14, dtype=np.uint8) for _ in range(n_members)]
    codes, gids = pack_members(members, dev)
    return step, (codes, gids, K)


def adversarial_genomes():
    """__graft_entry__.py's genomes, the regimes that break sharding:
    members share a mutated core (union counts reach the member count),
    carry N bases (invalid windows) and a poly-A block (a repeated-key
    pile-up)."""
    rng = np.random.default_rng(0)
    core = "".join("ACGT"[c] for c in rng.integers(0, 4, size=1500))
    genomes = []
    for m in range(3):
        s = list(core)
        for _ in range(40 * (m + 1)):  # member-specific mutations
            s[int(rng.integers(0, len(core)))] = "ACGT"[int(rng.integers(0, 4))]
        for _ in range(10):  # N bases
            s[int(rng.integers(0, len(core)))] = "N"
        tail = "".join("ACGT"[c] for c in rng.integers(0, 4, size=400))
        genomes.append("".join(s) + "A" * 600 + tail)
    return genomes


def _read_mats(genomes):
    from khoice_tpu_torch.pipelines.exp6 import reads_matrix

    return [reads_matrix([genomes[m][i:i + 50] for i in range(0, 150, 50)]) for m in range(3)]


def dryrun_rank(codes, mats, device_type: str):
    """Rank program of dryrun_multichip: every sharded result, as plain data."""
    from khoice_tpu_torch.dist import (
        sharded_count_codes,
        sharded_histogram,
        sharded_intersect_sum,
        sharded_set_counts,
        sharded_subtract,
        sharded_union_many,
    )
    from khoice_tpu_torch.dist.ksweep import sharded_occurrence_histograms_sweep
    from khoice_tpu_torch.dist.ksweep_classify import sharded_pivot_rest_counts_sweep
    from khoice_tpu_torch.dist.mesh import init_kv_group
    from khoice_tpu_torch.dist.occurrence import sharded_occurrence_histogram
    from khoice_tpu_torch.dist.vote import sharded_read_votes_multi

    g = init_kv_group(device_type)
    if g.device.type == "cuda":
        torch.cuda.set_device(g.device)
    k = DRYRUN_K
    out = {"device": str(g.device)}
    # the fused exp1 step (count + union + histogram) over the group:
    # slab extraction, key-range exchange, local occurrence scan, sum
    out["hist"] = sharded_occurrence_histogram(g, codes, k, cs=5000, cx=16)
    # the shared-sort k-sweep over 2- and 4-word classes
    out["sweep"] = sharded_occurrence_histograms_sweep(g, codes, SWEEP_KS, cx=16)
    # exp2's classification sweep (pivot_rest) on the same sharded sort
    out["pivot_rest"] = sharded_pivot_rest_counts_sweep(g, codes, CLASSIFY_KS)
    # the kmc_tools-shaped algebra over sharded tables, at dump granularity
    tables = [sharded_set_counts(sharded_count_codes(g, c, k), 1) for c in codes]
    union = sharded_union_many(tables, cs=5000)
    out["union"] = union.dump()
    out["union_hist"] = sharded_histogram(union, cx=16).tolist()
    out["intersect"] = sharded_intersect_sum(tables[0], union).dump()
    out["subtract"] = sharded_subtract(tables[0], tables[1]).dump()
    # exp6's read votes: all pivots' reads on one key-range merge-join
    out["votes"] = sharded_read_votes_multi(g, codes[:3], mats, [k])[k]
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    from khoice_tpu_torch import oracle
    from khoice_tpu_torch.classify.annotate import (
        concat_flat_reads,
        flat_reads_device,
        pack_group_texts,
        read_votes_bulk_multi,
    )
    from khoice_tpu_torch.dist.launch import run_ranks
    from khoice_tpu_torch.engine.ksweep import occurrence_histograms_sweep
    from khoice_tpu_torch.engine.ksweep_classify import pivot_rest_counts_sweep
    from khoice_tpu_torch.engine.occurrence import occurrence_histogram
    from khoice_tpu_torch.io.packing import encode_records

    dev = _device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if n_devices > cards:
            raise ValueError(f"dryrun_multichip({n_devices}) needs a card a rank over NCCL; "
                             f"{cards} visible")
        backend = "nccl"
    else:
        backend = "gloo"
    k = DRYRUN_K
    genomes = adversarial_genomes()
    codes = [encode_records([g]) for g in genomes]
    mats = _read_mats(genomes)

    # the single-device engine and the oracle, in this process
    want_hist = occurrence_histogram(codes, k, dev, cs=5000, cx=16)
    want_sweep = occurrence_histograms_sweep(codes, SWEEP_KS, dev, cx=16)
    want_cls, want_rest = pivot_rest_counts_sweep(codes, CLASSIFY_KS, device=dev)
    osets = [oracle.set_counts(oracle.count_kmers([g], k), 1) for g in genomes]
    ounion = oracle.union_sum(osets, cs=5000)
    if want_rest or max(ounion.values()) != len(genomes):
        raise AssertionError("the data lost its shared core, or a k left the sweep")
    if want_hist != oracle.histogram(ounion, cx=16):
        raise AssertionError("single-device occurrence histogram != oracle")
    bigf, spans = concat_flat_reads([flat_reads_device(m, dev) for m in mats])
    want_votes = read_votes_bulk_multi(pack_group_texts(codes[:3], dev), bigf, spans, k, 3)

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ranks = run_ranks(n_devices, dryrun_rank, (codes, mats, dev.type), backend=backend,
                      timeout_s=600)
    for rank, got in enumerate(ranks):
        where = f"rank {rank} of {n_devices} ({backend}, {got['device']})"
        if got["hist"] != want_hist:
            raise AssertionError(f"{where}: sharded fused step diverged from single-device")
        for kk in SWEEP_KS:
            if got["sweep"][kk] != want_sweep[kk]:
                raise AssertionError(f"{where}: sharded k-sweep diverged at k={kk}")
        cls, rest = got["pivot_rest"]
        if rest != [] or any(not np.array_equal(cls[kk], want_cls[kk]) for kk in CLASSIFY_KS):
            raise AssertionError(f"{where}: sharded pivot_rest sweep diverged")
        if dict(got["union"]) != ounion:
            raise AssertionError(f"{where}: sharded union dump != oracle")
        if got["union_hist"] != want_hist:
            raise AssertionError(f"{where}: sharded union histogram != the fused step's")
        if dict(got["intersect"]) != oracle.intersect_sum(osets[0], ounion):
            raise AssertionError(f"{where}: sharded intersect_sum dump != oracle")
        if dict(got["subtract"]) != oracle.subtract(osets[0], osets[1]):
            raise AssertionError(f"{where}: sharded subtract dump != oracle")
        for (gv, gu, gn), (wv, wu, wn) in zip(got["votes"], want_votes, strict=True):
            if not (np.array_equal(gv, wv) and np.array_equal(gu, wu)
                    and np.array_equal(gn, wn)):
                raise AssertionError(f"{where}: sharded exp6 voting diverged")
    print(f"[dryrun_multichip] ok on {n_devices} rank(s) ({backend}, {device}): "
          f"union={len(ounion)} distinct k-mers, max occurrence={max(ounion.values())}")
