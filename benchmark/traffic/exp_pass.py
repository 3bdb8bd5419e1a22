"""Traffic kind `exp_pass`: a user's closed loop of whole experiments.

Set-up generates the configuration's database from the seed and writes
it gzipped under the run's directory (the reference layout,
`dataset_{i}/genome_{g}.fna.gz`).  Where the mix asks for it
(`exp0_in_setup`), set-up runs exp0 once, as a user's first run of a
trial does, and every pass reuses its pivots and reads.  A pass is
`khoice_tpu_torch.cli.main(["run", "--exp-type", N, ...])` in this
process, from the database files to the last CSV written; the next pass
starts when it returns.  exp1 passes get a fresh work root each (the
previous pass's is deleted); later experiments run with `--force` on
exp0's work root, as a user's rerun of a trial does.

What is checked: every pass's CSV bytes (exp1: step_5 and step_9; exp6:
both trial CSVs) against the reference's; for exp1 the last pass's
step_4 and step_8 histogram files bin by bin; for exp6 every read's
votes, unmatched and valid windows, as the program's voting step
(`classify/annotate.read_votes_bulk_multi`, as exp6 bound it) returned
them to exp6 in the last pass, at three ks drawn from the seed and both
read types.  The votes are kept by a wrapper that set-up puts around
that name, which holds a reference to what the call returns and does
nothing else.

The configuration's settings reach the program as `run`'s flags where it
has one (`--k-values`; `--num-datasets` and `--kmers-per-dataset` for the
experiments that read them); the rest (`SETTINGS`) have no flag, and
set-up stops the run where the program's defaults differ from them.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from benchmark import gen_realistic_db
from benchmark.reference import exp1_report, kmers
from benchmark.reference import exp6 as ref6

# configuration key -> the program's setting (khoice_tpu_torch.config.KhoiceConfig),
# which `run` takes no flag for
SETTINGS = {"count_cs": "count_cs", "union_cs": "union_cs", "hist_cx": "hist_cx",
            "out_pivot": "out_pivot", "trial": "curr_trial"}
# what the exp6 reference assumes of the program's settings
REFERENCE_SETTINGS = {"seed": ref6.SEED, "read_sim_seed": ref6.READ_SEED,
                      "curr_trial": ref6.TRIAL}

# spans that name what the host was doing in the traced run's idle gaps
LABELS = {
    "cli.run": [("khoice_tpu_torch.cli", "_run_one")],
    "pipeline.exp1": [("khoice_tpu_torch.pipelines.exp1", "run_exp1")],
    "pipeline.exp6": [("khoice_tpu_torch.pipelines.exp6", "run_exp6")],
    "engine.sweep": [("khoice_tpu_torch.engine.ksweep", "occurrence_histograms_sweep_packed")],
    "engine.votes": [("khoice_tpu_torch.pipelines.exp6", "read_votes_bulk_multi")],
}


def _read(path: str):
    try:
        with open(path, "rb") as fd:
            return fd.read()
    except FileNotFoundError:
        return None


def lines_off(got, want: str) -> int:
    """Lines of `want` that `got` (bytes or None) does not hold at the same
    place, plus lines it has beyond them."""
    want_lines = want.splitlines()
    if got is None:
        return len(want_lines)
    got_lines = got.decode(errors="replace").splitlines()
    off = sum(a != b for a, b in zip(got_lines, want_lines))
    return off + abs(len(got_lines) - len(want_lines))


def hist_file_off(path: str, want, cx: int) -> int:
    """Bins of a KMC-text histogram file ("i<TAB>count" for i = 1..cx) that
    differ from `want`; a missing file is cx bins off."""
    got = _read(path)
    if got is None:
        return cx
    rows = [line.split("\t") for line in got.decode().splitlines() if line.strip()]
    off = abs(len(rows) - cx)
    for i, row in enumerate(rows[:cx]):
        off += row != [str(i + 1), str(want[i])]
    return off


def reads_differing(got, want) -> int:
    """Reads whose (votes, unmatched, windows) differ, over the datasets'
    outputs of one voting call."""
    off = 0
    for (gv, gu, gn), (wv, wu, wn) in zip(got, want):
        if gv.shape != wv.shape:
            off += len(wv)
            continue
        off += int(((gv != wv).any(1) | (gu != wu) | (gn != wn)).sum())
    return off + sum(len(w[0]) for w in want[len(got):])


def settings_off(cfg: dict) -> list:
    """The configuration's settings, and the exp6 reference's assumptions,
    that the program's defaults do not hold, as lines to print."""
    from khoice_tpu_torch.config import KhoiceConfig

    program = KhoiceConfig()
    off = [f"{key} {cfg[key]!r}, the program's {attr} {getattr(program, attr)!r}"
           for key, attr in SETTINGS.items() if cfg[key] != getattr(program, attr)]
    off += [f"the reference's {attr} {want!r}, the program's {getattr(program, attr)!r}"
            for attr, want in REFERENCE_SETTINGS.items() if getattr(program, attr) != want]
    return off


class Traffic:
    def __init__(self, ctx):
        from khoice_tpu_torch import cli

        cfg, mix = ctx.config, ctx.mix
        off = settings_off(cfg)
        if off:
            raise SystemExit("[bench] `run` has no flag for these settings, and the program's "
                             "defaults differ: " + "; ".join(off))
        self._draw(ctx, os.path.join(ctx.tmp, "db"))
        self.cli = cli
        # exp1 reads every dataset and every k-mer, and warns of these flags
        sizes = [] if self.exp_type == 1 else [
            "--num-datasets", str(cfg["num_datasets"]),
            "--kmers-per-dataset", str(cfg["kmers_per_dataset"])]
        self.argv = ["run", "--exp-type", str(self.exp_type), "--database-root", self.db_dir,
                     "--k-values", ",".join(map(str, self.ks)), "--device", str(ctx.device)
                     ] + sizes
        if mix.get("exp0_in_setup"):
            rc = cli.main(["run", "--exp-type", "0", "--database-root", self.db_dir,
                           "--work-root", self.exp0_root] + sizes)
            if rc != 0:
                raise RuntimeError(f"exp0 returned {rc}")
        if self.exp_type == 6:
            self._keep_votes()
        self.run_pass(-1)  # the warm pass: every shape of the window, untimed
        self.outputs.clear()

    def _draw(self, ctx, db_dir) -> None:
        """The run's data from the seed: the database (its files under
        `db_dir` where that is given), the ks whose votes are checked."""
        cfg = ctx.config
        self.ctx, self.db_dir = ctx, db_dir
        self.exp_type = int(ctx.mix["exp_type"])
        self.ks = [int(k) for k in cfg["k_values"]]
        self.records = gen_realistic_db.generate(
            db_dir, cfg["num_datasets"], cfg["genomes_per_dataset"], cfg["genome_mbp"], ctx.seed)
        self.exp0_root = os.path.join(ctx.tmp, "trial")
        self.outputs = []  # per pass: (rc, {csv name: bytes or None})
        self.root = None
        self.vote_ks = sorted(int(k) for k in np.random.default_rng(ctx.seed).choice(
            self.ks, min(3, len(self.ks)), replace=False))
        self.votes = []  # this pass's (k, votes per dataset) at vote_ks, in call order
        self.ref_reads = None  # exp0's reads as the reference simulates them, once made

    def _keep_votes(self) -> None:
        from khoice_tpu_torch.pipelines import exp6

        fn, kept, ks = exp6.read_votes_bulk_multi, self.votes, set(self.vote_ks)

        def keeping(group, big_flat, spans, k, *args, **kwargs):
            out = fn(group, big_flat, spans, k, *args, **kwargs)
            if k in ks:
                kept.append((k, out))
            return out

        exp6.read_votes_bulk_multi = keeping
        self._undo = (exp6, fn)

    def _csvs(self, root):
        if self.exp_type == 1:
            return {"step_5": os.path.join(root, "step_5/within_datasets_analysis.csv"),
                    "step_9": os.path.join(root, "step_9/across_datasets_analysis.csv")}
        if self.exp_type == 6:
            trial = self.ctx.config["trial"]
            return {rt: os.path.join(root, f"trial_{trial}_{rt}_acc.csv") for rt in ("short", "long")}
        raise ValueError(f"exp_pass checks exp types 1 and 6, not {self.exp_type}")

    def run_pass(self, i: int) -> None:
        if self.exp_type == 1:
            root = os.path.join(self.ctx.tmp, "work", f"pass_{i}")
            rc = self.cli.main(self.argv + ["--work-root", root])
            if self.root is not None:
                shutil.rmtree(self.root)  # the last pass's files stay for check()
        else:
            root = self.exp0_root
            self.votes.clear()
            rc = self.cli.main(self.argv + ["--work-root", root, "--force"])
        self.root = root
        self.outputs.append((rc, {name: _read(p) for name, p in self._csvs(root).items()}))

    def work(self) -> dict:
        return {}

    def failed(self) -> int:
        return sum(rc != 0 for rc, _ in self.outputs)

    def release(self) -> None:
        if self.exp_type == 6:
            mod, fn = self._undo
            mod.read_votes_bulk_multi = fn

    def check(self) -> dict:
        """{compared name: (value, limit)} against the reference."""
        if self.exp_type == 1:
            return self._check_exp1()
        want, want_votes = ref6.expected(self.records, self.ctx.config, self.ctx.device,
                                         self.vote_ks, reads=self.ref_reads)
        off = sum(lines_off(out.get(name), want[name])
                  for _rc, out in self.outputs for name in want)
        seen, reads_off = set(), 0
        for k, got in self.votes:  # each k comes once per read type, illumina first
            rt = ref6.READ_TYPES[(k, ref6.READ_TYPES[0]) in seen]
            seen.add((k, rt))
            reads_off += reads_differing(got, want_votes[(k, rt)])
        missing = [key for key in want_votes if key not in seen]
        reads_off += sum(len(v[0]) for key in missing for v in want_votes[key])
        return {"csv_lines_off": (off, 0), "reads_off": (reads_off, 0)}

    def _exp1_expected(self, fold32: bool = False):
        """(within, across histograms, {CSV name: text}) of exp1 by the reference."""
        cfg = self.ctx.config
        groups = {d: [kmers.genome_codes(self.records[d][g]) for g in sorted(self.records[d])]
                  for d in sorted(self.records)}
        within, across = kmers.exp1_histograms(groups, self.ks, self.ctx.device,
                                               cs=cfg["union_cs"], cx=cfg["hist_cx"],
                                               fold32=fold32)
        texts = {"step_5": exp1_report.step5_text(
                     within, {d: len(g) for d, g in groups.items()}, self.ks),
                 "step_9": exp1_report.step9_text(across, len(groups), self.ks)}
        return within, across, texts

    def _hist_paths(self, root):
        """{(k, dataset or None for the across set): exp1's histogram file}."""
        out = {}
        for k in self.ks:
            for d in sorted(self.records):
                out[(k, d)] = os.path.join(
                    root, f"step_4/k_{k}/dataset_{d}/dataset_{d}_k{k}_hist.txt")
            out[(k, None)] = os.path.join(root, f"step_8/k_{k}/all_datasets_k{k}_hist.txt")
        return out

    def _check_exp1(self) -> dict:
        cfg = self.ctx.config
        within, across, want = self._exp1_expected()
        csv_off = sum(lines_off(out.get(name), want[name])
                      for _rc, out in self.outputs for name in want)
        bins_off = sum(hist_file_off(path, within[key] if key[1] is not None else across[key[0]],
                                     cfg["hist_cx"])
                       for key, path in self._hist_paths(self.root).items())
        return {"csv_lines_off": (csv_off, 0), "hist_bins_off": (bins_off, 0)}


def _write(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fd:
        fd.write(text)


class Control(Traffic):
    """The cell's control in the program's place: each pass writes the
    files the program would, from the reference computed with each
    canonical key narrowed to a 32-bit fingerprint (reference/kmers.py
    `fold32`), and check() is the cell's own.  It runs none of the program."""

    def __init__(self, ctx):
        self._draw(ctx, None)
        if self.exp_type == 6:
            _pivots, self.ref_reads = ref6.exp0_reads(self.records,
                                                      int(ctx.config["kmers_per_dataset"]))

    def run_pass(self, i: int) -> None:
        root = os.path.join(self.ctx.tmp, "control", f"pass_{i}")
        paths = self._csvs(root)
        if self.exp_type == 1:
            within, across, texts = self._exp1_expected(fold32=True)
            for (k, d), path in self._hist_paths(root).items():
                hist = within[(k, d)] if d is not None else across[k]
                _write(path, "".join(f"{b + 1}\t{c}\n" for b, c in enumerate(hist)))
        else:
            texts, kept = ref6.expected(self.records, self.ctx.config, self.ctx.device,
                                        self.vote_ks, fold32=True, reads=self.ref_reads)
            self.votes[:] = [(k, kept[(k, rt)]) for k in self.vote_ks for rt in ref6.READ_TYPES]
        for name, path in paths.items():
            _write(path, texts[name])
        self.root = root
        self.outputs.append((0, {name: _read(p) for name, p in paths.items()}))

    def release(self) -> None:
        pass

