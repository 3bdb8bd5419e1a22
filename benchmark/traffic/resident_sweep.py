"""Traffic kind `resident_sweep`: the k-sweep over codes already on the
device, back to back, as a caller that keeps its groups resident does.

Set-up generates the configuration's database from the seed in memory
(no files), encodes every genome with the program's encoder and packs
each species group, and the across set (each group's genomes joined with
a separator after each, as exp1 builds it), once with
`engine/occurrence.pack_members`.  A pass is
`engine/ksweep.occurrence_histograms_sweep_packed` over every set in
turn, each set's histograms back on the host.  Work: the grid's points
times the positions of each set (its members' codes), summed over sets,
as bench_torch.py counts k-mers.

What is checked: every set's histogram at every k, bin by bin, of the
last pass and of two passes drawn from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import gen_realistic_db
from benchmark.reference import kmers

LABELS = {
    "engine.sweep": [("khoice_tpu_torch.engine.ksweep", "occurrence_histograms_sweep_packed")],
    "engine.class": [("khoice_tpu_torch.engine.ksweep", "sweep_class_hists")],
}


def sample_indices(seed: int, n: int = 2, below: int = 16) -> set:
    """Pass indices, drawn from the seed, whose outputs are kept for the
    check beside the last pass's."""
    return {int(i) for i in np.random.default_rng(seed).choice(below, n, replace=False)}


class Traffic:
    def __init__(self, ctx):
        from khoice_tpu_torch.engine import ksweep
        from khoice_tpu_torch.engine.occurrence import pack_members
        from khoice_tpu_torch.io.packing import encode_records

        self._draw(ctx)
        self.ksweep = ksweep  # called through the module: the traced run wraps it there
        groups = {d: [encode_records([seq.tobytes() for _name, seq in self.records[d][g]])
                      for g in sorted(self.records[d])] for d in sorted(self.records)}
        across = [np.concatenate([np.concatenate([c, np.full(1, 4, np.uint8)]) for c in groups[d]])
                  for d in sorted(groups)]
        self.sets = [(f"group_{d}", groups[d]) for d in sorted(groups)] + [("across", across)]
        self.packed = [(name, pack_members(members, ctx.device), len(members))
                       for name, members in self.sets]
        positions = sum(int(c.shape[0]) for _name, members in self.sets for c in members)
        self.kmers_per_pass = len(self.ks) * positions
        self.run_pass(-1)  # the warm pass: every shape of the window, untimed
        self.kept.clear()
        self.passes = 0

    def _draw(self, ctx) -> None:
        """The run's data from the seed: the database, the passes kept."""
        cfg = ctx.config
        self.ctx = ctx
        self.ks = [int(k) for k in cfg["k_values"]]
        self.cs, self.cx = int(cfg["union_cs"]), int(cfg["hist_cx"])
        self.records = gen_realistic_db.generate(
            None, cfg["num_datasets"], cfg["genomes_per_dataset"], cfg["genome_mbp"], ctx.seed)
        self.sample = sample_indices(ctx.seed)
        self.kept = {}
        self.passes = 0
        self.kmers_per_pass = 0

    def _keep(self, i: int, out: dict) -> None:
        self.kept.pop(("last",), None)
        self.kept[(i,) if i in self.sample else ("last",)] = out
        self.passes += 1

    def run_pass(self, i: int) -> None:
        self._keep(i, {name: self.ksweep.occurrence_histograms_sweep_packed(
            packed, n, self.ks, cs=self.cs, cx=self.cx) for name, packed, n in self.packed})

    def work(self) -> dict:
        return {"kmers": self.kmers_per_pass * self.passes}

    def failed(self) -> int:
        return 0

    def release(self) -> None:
        self.packed = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _expected(self, fold32: bool = False) -> dict:
        """{set name: {k: histogram}} of every set by the reference."""
        groups = {d: [kmers.genome_codes(self.records[d][g]) for g in sorted(self.records[d])]
                  for d in sorted(self.records)}
        within, across = kmers.exp1_histograms(groups, self.ks, self.ctx.device,
                                               cs=self.cs, cx=self.cx, fold32=fold32)
        want = {f"group_{d}": {k: within[(k, d)] for k in self.ks} for d in groups}
        want["across"] = across
        return want

    def check(self) -> dict:
        want = self._expected()
        off = 0
        for out in self.kept.values():
            for name, hists in want.items():
                for k in self.ks:
                    got = out[name].get(k)
                    off += self.cx if got is None else sum(
                        a != b for a, b in zip(got, hists[k])) + abs(len(got) - len(hists[k]))
        return {"hist_bins_off": (off, 0)}


class Control(Traffic):
    """The cell's control in the program's place: each pass returns every
    set's histograms as the reference computes them with each canonical
    key narrowed to a 32-bit fingerprint (reference/kmers.py `fold32`), and
    check() is the cell's own.  It runs none of the program."""

    def __init__(self, ctx):
        self._draw(ctx)

    def run_pass(self, i: int) -> None:
        self._keep(i, self._expected(fold32=True))

    def release(self) -> None:
        pass
