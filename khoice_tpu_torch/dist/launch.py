"""Start the ranks of a key-range group in one call: `run_ranks`.

The JAX package's tests get their devices from one process (eight virtual
CPU devices); torch.distributed needs a process per rank.  `run_ranks`
spawns them with torch.multiprocessing, initialises each one's default
process group from a FileStore in a fresh temporary directory (no TCP
port, so concurrent callers never collide), sets the torchrun variables
(RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE), and calls `fn(*args)`
in every rank; `fn` builds its group with dist/mesh.py::init_kv_group,
which takes the initialised default group, so `cli.main(argv)` runs as a
rank unchanged.  The CLI itself runs under `torchrun` and does not use
this.

`fn` and its arguments are pickled, so `fn` is a module-level function of
a module that imports no more than the rank needs: a rank imports what
`fn`'s module imports, and nothing of the caller's.  A rank's exception
fails every rank, and a group that has not finished within `timeout_s`
is killed and raises: one rank stuck in a collective whose peers are gone
stops the call instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class RankFailed(RuntimeError):
    """A rank raised, or the group did not finish in time."""


def _rank_main(rank: int, world_size: int, store_path: str, backend: str, timeout_s: float,
               fn, args, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size))
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, store=dist.FileStore(store_path, world_size),
                                rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(world_size: int, fn, args=(), backend: str = "gloo", timeout_s: float = 120.0):
    """[fn(*args) of rank 0, ..., of rank world_size - 1], each run in its own
    process of a `world_size`-rank group on `backend`; raises RankFailed
    with the first failing rank's traceback, or when `timeout_s` passes."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="khoice_ranks_")
    procs = []
    done = False
    try:
        for rank in range(world_size):
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                rank, world_size, os.path.join(tmp, "store"), backend, timeout_s, fn, args,
                results))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout_s
        out, reported = [None] * world_size, set()
        while len(reported) < world_size:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in reported and p.exitcode]
                if dead:
                    raise RankFailed(f"rank {dead[0]} of {world_size} exited with code "
                                     f"{procs[dead[0]].exitcode} and no result") from None
                if time.monotonic() > deadline:
                    raise RankFailed(f"{world_size} ranks of {fn.__name__} did not finish "
                                     f"within {timeout_s:.0f} s") from None
                continue
            if not ok:
                raise RankFailed(f"rank {rank} of {world_size} failed:\n{value}")
            out[rank] = value
            reported.add(rank)
        done = True
        return out
    finally:
        for p in procs:  # finished ranks exit on their own; a failed call's are killed
            if done:
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
