"""The key-range process group and its split keys (port of
khoice_tpu/dist/mesh.py).

The JAX package runs SPMD in one process over a device mesh with one axis,
"kv", which partitions canonical k-mer key space into contiguous ranges,
one per device.  torch.distributed runs one process per rank, so the
port's mesh is a `KvGroup`: the process group, this process's rank, the
world size and the rank's device.  Rank r holds key range r, and the
ranges ascend with the rank, so a rank-order concatenation of the shards
is globally sorted.  NCCL serves CUDA devices, gloo the CPU.

`init_kv_group` takes the default process group when one is initialised
(after checking its world size), else initialises it from the `torchrun`
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).
Each rank takes the card `cuda:{LOCAL_RANK}`; two ranks are never mapped
onto one card behind the caller's back.  The JAX package's
`init_multihost` (jax.distributed) has no counterpart yet: every rank of a
torch.distributed group is already its own process.

The split keys (`split_keys_for`) are the JAX package's uniform-CDF
quantiles, numpy only, copied: canonical keys are min(fwd, rc) of two
~uniform 2k-bit values, so P(key <= x * 4^k) ~ 1 - (1 - x)^2, and the
quantiles x_i = 1 - sqrt(1 - i/D) balance the ranges.  Tables and sweeps
sample their splits from the data instead (dist/occurrence.py
`_sampled_splits`); the per-k occurrence histogram keeps these.
"""

from __future__ import annotations

import dataclasses
import math
import os
import numpy as np
import torch
import torch.distributed as dist

from ..engine.bits import key_words

AXIS = "kv"


@dataclasses.dataclass(frozen=True)
class KvGroup:
    """One rank's view of the key-range group: the default process group's
    ranks, this one's rank and its device."""

    rank: int
    world_size: int
    device: torch.device

    def barrier(self) -> None:
        dist.barrier()

    def broadcast_flag(self, value: bool) -> bool:
        """Rank 0's `value`, on every rank."""
        flag = torch.tensor([int(bool(value))], dtype=torch.int64, device=self.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())


def exchange_counts(send_counts, group: KvGroup) -> list:
    """The first half of the JAX package's tiled all_to_all with uneven
    shares: every rank's send_counts[r] (the rows it sends rank r) in one
    all_to_all_single of a [world] int64 tensor -> the number of rows each
    rank sends here, in rank order."""
    send = torch.as_tensor(send_counts, dtype=torch.int64).to(group.device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    return recv.tolist()


def exchange_rows(rows: torch.Tensor, send_counts, recv_counts) -> torch.Tensor:
    """The second half: element-major rows [n, c], send_counts[r] of them
    for rank r in rank order, in one all_to_all_single with uneven splits
    -> the rows every rank sent here, [sum(recv_counts), c], in rank
    order.  Empty shares flow through."""
    out = rows.new_empty((sum(recv_counts),) + tuple(rows.shape[1:]))
    dist.all_to_all_single(out, rows, output_split_sizes=list(recv_counts),
                           input_split_sizes=list(send_counts))
    return out


def gather_rows(rows: torch.Tensor, group: KvGroup) -> list:
    """Every rank's rows [n_r, ...], on every rank, in rank order (counts
    first, then the rows padded to the largest count)."""
    n = torch.tensor([rows.shape[0]], dtype=torch.int64, device=group.device)
    counts = [torch.empty_like(n) for _ in range(group.world_size)]
    dist.all_gather(counts, n)
    counts = [int(c.item()) for c in counts]
    top = max(counts)
    padded = rows.new_zeros((top,) + tuple(rows.shape[1:]))
    padded[:rows.shape[0]] = rows
    parts = [torch.empty_like(padded) for _ in range(group.world_size)]
    dist.all_gather(parts, padded)
    return [part[:c] for part, c in zip(parts, counts)]


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """psum: the elementwise sum of every rank's int64 `t`, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def rank_device(device, local_rank: int) -> torch.device:
    """The device of the rank with `local_rank` on its host: cuda:{local_rank}
    for a CUDA device (raising if the host has fewer cards), else `device`."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    n_cards = torch.cuda.device_count()
    if local_rank >= n_cards:
        raise ValueError(
            f"rank with LOCAL_RANK {local_rank} needs card cuda:{local_rank}, but this host "
            f"has {n_cards} CUDA device(s); launch at most one rank per card"
        )
    return torch.device("cuda", local_rank)


def init_kv_group(device="cuda", world_size: int | None = None) -> KvGroup:
    """This process's KvGroup on the default process group: the one already
    initialised (its world size checked against `world_size`), or one
    initialised here from the torchrun environment, on NCCL for CUDA and
    gloo for the CPU."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = rank_device(device, local_rank)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    size = dist.get_world_size()
    if world_size is not None and size != world_size:
        raise ValueError(f"the process group has {size} ranks, {world_size} were asked for")
    return KvGroup(rank=dist.get_rank(), world_size=size, device=dev)


def make_mesh(n_devices: int | None = None, device="cuda") -> KvGroup:
    """The JAX package's make_mesh: a key-range group of n_devices ranks
    (init_kv_group)."""
    return init_kv_group(device, world_size=n_devices)


def _fraction_to_key(frac: float, k: int) -> np.ndarray:
    """Map a fraction of the 2k-bit key space to a multi-word uint32 key."""
    w = key_words(k)
    total_bits = 2 * k
    v = int(frac * (1 << total_bits))
    v = max(0, min(v, (1 << total_bits) - 1))
    words = []
    for i in range(w):
        shift = 32 * (w - 1 - i)
        words.append((v >> shift) & 0xFFFFFFFF)
    return np.array(words, np.uint32)


def split_keys_for(k: int, n_shards: int) -> np.ndarray:
    """(n_shards-1, n_words) ascending split keys for the canonical-key CDF."""
    w = key_words(k)
    out = np.zeros((max(n_shards - 1, 0), w), np.uint32)
    for i in range(1, n_shards):
        frac = 1.0 - math.sqrt(1.0 - i / n_shards)
        out[i - 1] = _fraction_to_key(frac, k)
    return out
