"""Traffic kind `sharded_exp_pass`: exp_pass's closed loop of whole exp1
experiments, run over a key-range group of `ranks` processes, one device
each, as `torchrun --nproc-per-node N -m khoice_tpu_torch run --exp-type 1
--mesh-shards N` runs them.

Rank 0 is this process, on the run's device (`cuda:0`); ranks 1.. are
worker processes that set-up starts (this file run as a script), rank r
on `cuda:r`, NCCL between them (gloo on the CPU, where the ranks share
it).  Set-up draws the configuration's database from the seed as exp_pass
does and writes the same gzipped files, several at a time; sets the
variables torchrun would (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR, and MASTER_PORT: a free port, taken by the group's store);
initialises the default process group; and runs the warm pass, after
which every rank resets its peak-memory statistics.  A pass is
`khoice_tpu_torch.cli.main(["run", "--exp-type", "1", "--mesh-shards", N,
...])` in this process and, at the same time, in every worker (the
command reaches them through the group's store), with a fresh work root
(the previous pass's is deleted).  It ends when every rank has returned,
and fails if any rank's return code is not 0.

`work()` gives each rank's rows sent to and received from the other
ranks over the window (dist/mesh.py's `exchanged`) and its peak
allocated device bytes.  `release()` ends the workers and destroys the
group; `check()` is exp_pass's exp1 check (every pass's step_5/step_9
bytes, the last pass's step_4/step_8 files bin by bin, limit 0), its
reference computed in blocks of the key space (reference/exp1_blocked.py),
as the database's whole sorts do not fit one card, its ks dealt out to the
cell's cards.

No failure leaves the run waiting: a worker that finds this process gone
exits; while the workers run, a thread here ends the run (exit code 3)
within a second of a worker's exit; a rank that has not returned
GROUP_TIMEOUT_S after rank 0 fails the pass (the run raises); the group's
collectives time out after COLLECTIVE_TIMEOUT_S.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:  # as a worker script
    sys.path.insert(0, ROOT)

from benchmark import gen_realistic_db  # noqa: E402
from benchmark.reference import exp1_blocked, exp1_report, kmers  # noqa: E402
from benchmark.traffic import exp_pass  # noqa: E402

ADDR = "127.0.0.1"
ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT")
# a rank that has not returned this long after rank 0 fails the pass
GROUP_TIMEOUT_S = 60
# a collective whose peers have not come fails after this long: above the
# kernels' first build, which each rank of a fresh checkout makes alone
COLLECTIVE_TIMEOUT_S = 180
# how long a worker waits for the harness: set-up's database, a pass, the
# traced window's export before the stop
STORE_TIMEOUT_S = 900
POLL_S = 0.05
KEY = "bench"  # prefix of the store keys the harness and its workers share
WRITERS = 8

LABELS = exp_pass.LABELS


def _rank_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": ADDR, "MASTER_PORT": str(port)}


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def write_database(db_dir: str, records) -> None:
    """The files gen_realistic_db.generate writes for `records`, written
    by up to WRITERS processes (its writer is a Python step a line)."""
    paths, recs = [], []
    for d, genomes in records.items():
        os.makedirs(os.path.join(db_dir, f"dataset_{d}"), exist_ok=True)
        for name, genome in genomes.items():
            paths.append(os.path.join(db_dir, f"dataset_{d}", f"{name}.fna.gz"))
            recs.append(genome)
    with ProcessPoolExecutor(min(WRITERS, len(paths)),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        list(pool.map(gen_realistic_db.write_records, paths, recs))


class _BlockedReference:
    """exp_pass's expected exp1 outputs, from the reference computed in
    blocks of the key space (reference/exp1_blocked.py): the whole
    database's sorts do not fit one card.  The ks are dealt out to the
    cell's cards (cuda:0.., as many as the mix has ranks and the host has
    cards): the check runs after release(), when no rank holds them."""

    def _cards(self) -> list:
        if self.ctx.device.type != "cuda":
            return [self.ctx.device]
        n = min(int(self.ctx.mix["ranks"]), torch.cuda.device_count())
        return [torch.device("cuda", i) for i in range(n)]

    def _exp1_expected(self, fold32: bool = False):
        cfg = self.ctx.config
        groups = {d: [kmers.genome_codes(self.records[d][g]) for g in sorted(self.records[d])]
                  for d in sorted(self.records)}
        within, across = exp1_blocked.exp1_histograms(groups, self.ks, self._cards(),
                                                      cs=cfg["union_cs"], cx=cfg["hist_cx"],
                                                      fold32=fold32)
        texts = {"step_5": exp1_report.step5_text(
                     within, {d: len(g) for d, g in groups.items()}, self.ks),
                 "step_9": exp1_report.step9_text(across, len(groups), self.ks)}
        return within, across, texts


class Traffic(_BlockedReference, exp_pass.Traffic):
    def __init__(self, ctx):
        from khoice_tpu_torch import cli
        from khoice_tpu_torch.dist import mesh

        cfg, mix = ctx.config, ctx.mix
        off = exp_pass.settings_off(cfg)
        if off:
            raise SystemExit("[bench] `run` has no flag for these settings, and the program's "
                             "defaults differ: " + "; ".join(off))
        if int(mix["exp_type"]) != 1:
            raise ValueError(f"sharded_exp_pass runs exp1, not exp type {mix['exp_type']}")
        self.world = int(mix["ranks"])
        cuda = ctx.device.type == "cuda"
        if cuda and torch.cuda.device_count() < self.world:
            raise SystemExit(f"[bench] {self.world} ranks need {self.world} CUDA devices, "
                             f"{torch.cuda.device_count()} visible")
        if dist.is_initialized():
            raise RuntimeError("a default process group is initialised already")
        self.cli, self.mesh, self.cuda = cli, mesh, cuda
        self.seq = 0  # commands sent to the workers
        self.reports = []  # each worker's report of the last pass
        self.workers = []
        self._stopping = threading.Event()
        self._env_before = {key: os.environ.get(key) for key in ENV_KEYS}

        self.store = dist.TCPStore(ADDR, 0, self.world, is_master=True,
                                   timeout=datetime.timedelta(seconds=STORE_TIMEOUT_S),
                                   wait_for_workers=False)
        port = self.store.port
        os.environ.update(_rank_env(0, self.world, port))
        # the workers import torch and the port while the database is drawn
        for r in range(1, self.world):
            self.workers.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", "--device",
                 ctx.device.type, "--threads", str(torch.get_num_threads())],
                env={**os.environ, **_rank_env(r, self.world, port)}, cwd=ROOT, stdout=2))
        threading.Thread(target=self._watch, args=(ctx.tmp,), daemon=True).start()
        try:
            self._draw(ctx, None)
            self.db_dir = os.path.join(ctx.tmp, "db")
            write_database(self.db_dir, self.records)
            self.argv = ["run", "--exp-type", "1", "--database-root", self.db_dir,
                         "--k-values", ",".join(map(str, self.ks)), "--device",
                         ctx.device.type, "--mesh-shards", str(self.world)]
            self.store.set(f"{KEY}/go", "1")
            if cuda:
                torch.cuda.set_device(ctx.device)
            dist.init_process_group(_backend(ctx.device.type), store=self.store, rank=0,
                                    world_size=self.world,
                                    timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
            self.run_pass(-1)  # the warm pass: every shape of the window, untimed
        except BaseException:
            self._stopping.set()
            self._kill()
            self._restore_env()
            raise
        self.outputs.clear()
        self.since = dict(mesh.exchanged)

    def _watch(self, tmp: str) -> None:
        """End the run when a worker exits before release() stops it: the
        other ranks would wait for it in their next collective."""
        while not self._stopping.is_set():
            for r, proc in enumerate(self.workers, 1):
                code = proc.poll()
                if code is not None and not self._stopping.is_set():
                    print(f"[bench] rank {r} exited with code {code}; ending the run",
                          file=sys.stderr, flush=True)
                    self._kill()
                    shutil.rmtree(tmp, ignore_errors=True)
                    os._exit(3)
            time.sleep(0.5)

    def _kill(self) -> None:
        for proc in self.workers:
            if proc.poll() is None:
                proc.kill()
        for proc in self.workers:
            proc.wait()

    def _send(self, command: dict) -> int:
        seq = self.seq
        self.store.set(f"{KEY}/cmd/{seq}", json.dumps(command))
        self.seq += 1
        return seq

    def _collect(self, seq: int) -> list:
        """Every worker's report of command `seq`, once each has returned;
        raises where one has not within GROUP_TIMEOUT_S."""
        keys = [f"{KEY}/done/{seq}/{r}" for r in range(1, self.world)]
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        while not self.store.check(keys):
            if time.monotonic() > deadline:
                self._stopping.set()
                self._kill()
                raise RuntimeError(f"a rank did not return within {GROUP_TIMEOUT_S} s of "
                                   f"rank 0 (pass {seq})")
            time.sleep(POLL_S)
        return [json.loads(self.store.get(key)) for key in keys]

    def run_pass(self, i: int) -> None:
        root = os.path.join(self.ctx.tmp, "work", f"pass_{i}")
        argv = self.argv + ["--work-root", root]
        seq = self._send({"argv": argv, "reset": i < 0})
        try:
            rc = self.cli.main(argv)
        except BaseException:
            self._stopping.set()
            self._kill()  # they would wait for rank 0 in their next collective
            raise
        self.reports = self._collect(seq)
        if self.root is not None:
            shutil.rmtree(self.root)  # the last pass's files stay for check()
        self.root = root
        rcs = [rc] + [rep["rc"] for rep in self.reports]
        self.outputs.append((next((c for c in rcs if c != 0), 0),
                             {name: exp_pass._read(p) for name, p in self._csvs(root).items()}))

    def work(self) -> dict:
        peak = torch.cuda.max_memory_allocated(self.ctx.device) if self.cuda else 0
        ranks = [{"rank": 0, "rows_sent": self.mesh.exchanged["sent"] - self.since["sent"],
                  "rows_received": self.mesh.exchanged["received"] - self.since["received"],
                  "peak_bytes": peak}]
        ranks += [{"rank": r, "rows_sent": rep["sent"], "rows_received": rep["received"],
                   "peak_bytes": rep["peak"]} for r, rep in enumerate(self.reports, 1)]
        return {"ranks": ranks}

    def release(self) -> None:
        self._stopping.set()
        self._send({"argv": None})
        dist.destroy_process_group()
        for proc in self.workers:
            try:
                proc.wait(timeout=GROUP_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self._restore_env()

    def _restore_env(self) -> None:
        for key, value in self._env_before.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


class Control(_BlockedReference, exp_pass.Control):
    """exp_pass's control (each pass writes the files of the reference with
    keys narrowed to 32-bit fingerprints, in rank 0's place; none of the
    program runs), with the blocked reference; the check is the cell's."""


def _watch_parent(parent: int) -> None:
    """Exit this worker once the harness's process is gone."""
    while os.getppid() == parent:
        time.sleep(0.5)
    os._exit(1)


def worker(device_type: str, threads: int) -> int:
    """Rank RANK of the group: run each pass's command from the store until
    the stop, reporting each pass's return code, the rows exchanged since
    the warm pass and the peak allocated device bytes since it."""
    threading.Thread(target=_watch_parent, args=(os.getppid(),), daemon=True).start()
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    store = dist.TCPStore(os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]), world,
                          is_master=False, timeout=datetime.timedelta(seconds=STORE_TIMEOUT_S))
    torch.set_num_threads(threads)
    from khoice_tpu_torch import cli
    from khoice_tpu_torch.dist import mesh

    wait = datetime.timedelta(seconds=STORE_TIMEOUT_S)
    store.wait([f"{KEY}/go"], wait)
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(_backend(device_type), store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    since = dict(mesh.exchanged)
    seq = 0
    try:
        while True:
            store.wait([f"{KEY}/cmd/{seq}"], wait)
            command = json.loads(store.get(f"{KEY}/cmd/{seq}"))
            if command["argv"] is None:
                return 0
            rc = cli.main(command["argv"])
            if command.get("reset"):
                since = dict(mesh.exchanged)
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
            peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
            store.set(f"{KEY}/done/{seq}/{rank}", json.dumps({
                "rc": rc, "sent": mesh.exchanged["sent"] - since["sent"],
                "received": mesh.exchanged["received"] - since["received"], "peak": peak}))
            seq += 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="a worker rank of sharded_exp_pass")
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--threads", type=int, required=True)
    args = ap.parse_args()
    sys.exit(worker(args.device, args.threads))
