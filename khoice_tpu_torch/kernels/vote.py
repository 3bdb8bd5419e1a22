"""exp6's read-level voting: the wrappers of its two CUDA kernels
(csrc/vote.cu) and their plain PyTorch versions.

They replace XLA code of the JAX package (no Pallas kernel is on exp6's
path): `vote_mask` the run masks of the merge-join and their return to
read order (khoice_tpu/classify/annotate.py:250-266), `read_votes` the
per-read sums (`_votes_from_masks`, annotate.py:497-510).  For a CUDA
tensor each launches its kernel on the current stream, or raises; for a
CPU tensor it runs its plain version.  Launches are counted per kernel in
`launches`.

Layout: the merge-join's sorted keys are int64 [W, n] of 32-bit words,
most significant first (engine/bits.py), W = 1..4, with an int64 payload;
masks and sums are int64 (the JAX package's votes are uint32 and wrap
past 2^32, ROADMAP.md section 3).
"""

from __future__ import annotations

import torch

from ..engine.bits import words_is_sentinel, words_starts
from . import _build

MAX_DATASETS = 32  # a mask bit per dataset, in the kernels' 32-bit masks

# kernel launches since the last reset (CPU calls of the plain versions do
# not count)
launches = {"vote_mask": 0, "read_votes": 0}


def runs_mask(run: torch.Tensor, n_runs: int, gid: torch.Tensor, D: int) -> torch.Tensor:
    """int64 [n_runs]: bit d of run i set iff an element with run id i has
    gid d (run and gid int64 [m], gid < D), whatever their order: a
    presence flag per (run, dataset), then the flags' bits summed."""
    present = torch.zeros(n_runs * D, dtype=torch.bool, device=run.device)
    present[run * D + gid] = True
    bits = torch.tensor([1 << d for d in range(D)], device=run.device)
    return (present.view(n_runs, D).to(torch.int64) * bits).sum(1)


def vote_mask_reference(words: torch.Tensor, payload: torch.Tensor, D: int,
                        n_query: int) -> torch.Tensor:
    """Plain version: for each query element e (payload D + its read
    position), out[pay_e - D] = the OR of 1 << gid over the text elements
    (payload gid < D) of e's key run, 0 for the SENTINEL run, whatever the
    order of the elements within the run."""
    out = torch.zeros(n_query, dtype=torch.int64, device=words.device)
    if n_query == 0:
        return out
    run = torch.cumsum(words_starts(words), 0) - 1
    text = payload < D
    mask = runs_mask(run[text], int(run[-1]) + 1, payload[text], D)
    query = ~text
    val = mask[run[query]]
    val.masked_fill_(words_is_sentinel(words[:, query]), 0)
    out[payload[query] - D] = val
    return out


def read_votes_reference(qmask: torch.Tensor, valid: torch.Tensor, row_starts: torch.Tensor,
                         D: int, lcm: int):
    """Plain version: (votes int64 [R, D], unmatched int64 [R], n_kmers
    int64 [R]) over the rows row_starts[r]..row_starts[r + 1] - 1 of the
    flat masks.  A valid window with mask m (its low D bits) != 0 votes
    lcm // popcount(m) for each dataset in m; the popcount is the sum of
    the D bits."""
    R = row_starts.shape[0] - 1
    dev = qmask.device
    lo, hi = int(row_starts[0]), int(row_starts[-1])
    row = torch.repeat_interleave(torch.arange(R, device=dev), row_starts.diff())
    qm = torch.where(valid, qmask & ((1 << D) - 1), 0)[lo:hi]
    bits = [(qm >> d) & 1 for d in range(D)]
    pc = torch.stack(bits).sum(0)
    weight = torch.where(pc > 0, lcm // pc.clamp(min=1), 0)

    def per_row(x):
        return torch.zeros(R, dtype=torch.int64, device=dev).index_add_(0, row, x)

    votes = torch.stack([per_row(b * weight) for b in bits], 1) if R else \
        torch.zeros(0, D, dtype=torch.int64, device=dev)
    v = valid[lo:hi].to(torch.int64)
    return votes, per_row(v * (pc == 0)), per_row(v)


def check_datasets(D: int):
    """Raise ValueError unless 1 <= D <= 32: a mask bit per dataset."""
    if not 1 <= D <= MAX_DATASETS:
        raise ValueError(f"{D} datasets: the masks hold 1 to {MAX_DATASETS}")


def _check_mask_args(words: torch.Tensor, payload: torch.Tensor, D: int, n_query: int):
    if (words.dtype != torch.int64 or words.dim() != 2 or not 1 <= words.shape[0] <= 4
            or not words.is_contiguous()):
        raise ValueError(f"words must be contiguous int64 [W<=4, n], got {words.dtype} "
                         f"{tuple(words.shape)}")
    if (payload.dtype != torch.int64 or payload.shape != words.shape[1:]
            or not payload.is_contiguous() or payload.device != words.device):
        raise ValueError("payload must be a contiguous int64 [n] on the words' device")
    check_datasets(D)
    if not 0 <= n_query <= words.shape[1]:
        raise ValueError(f"n_query={n_query} outside [0, n={words.shape[1]}]")


def _check_vote_args(qmask, valid, row_starts, D: int, lcm: int):
    if qmask.dtype != torch.int64 or qmask.dim() != 1 or not qmask.is_contiguous():
        raise ValueError(f"qmask must be a contiguous int64 [N], got {qmask.dtype} "
                         f"{tuple(qmask.shape)}")
    if (valid.dtype != torch.bool or valid.shape != qmask.shape or not valid.is_contiguous()
            or valid.device != qmask.device):
        raise ValueError("valid must be a contiguous bool [N] on qmask's device")
    if (row_starts.dtype != torch.int64 or row_starts.dim() != 1 or row_starts.shape[0] < 1
            or not row_starts.is_contiguous() or row_starts.device != qmask.device):
        raise ValueError("row_starts must be a contiguous int64 [R + 1] on qmask's device")
    check_datasets(D)
    if lcm < 1:
        raise ValueError(f"lcm={lcm} must be >= 1")


def _device_check(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {t.device}")


def vote_mask(words: torch.Tensor, payload: torch.Tensor, D: int, n_query: int) -> torch.Tensor:
    """int64 [n_query] run masks of the merge-join: words int64 [W, n] and
    payload int64 [n] sorted STABLY by key from a concatenation with every
    text element (payload = its dataset gid < D) before every query
    element (payload = D + its read position, each of 0..n_query - 1
    once).  For each query, bit d is set iff a text element of dataset d
    has its key; SENTINEL keys give 0.

    The kernel's forward scan takes a query's value from the elements
    before it in its run, so it rests on that order (stable sort, texts
    first: every text element of a run precedes its queries,
    tests/test_torch_exp6.py); the plain version does not."""
    D, n_query = int(D), int(n_query)
    _check_mask_args(words, payload, D, n_query)
    if words.device.type == "cpu":
        return vote_mask_reference(words, payload, D, n_query)
    _device_check(words, "vote_mask")
    W, n = words.shape
    out = torch.empty(n_query, dtype=torch.int64, device=words.device)
    if n_query == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(words.device):
        # a status word per tile, then the tile counter
        tile = lib.vote_mask_tile_elems()
        status = torch.zeros((n + tile - 1) // tile + 1, dtype=torch.int64, device=words.device)
        err = lib.vote_mask_launch(words.data_ptr(), payload.data_ptr(), n, W, D, n_query,
                                   status.data_ptr(), out.data_ptr(),
                                   torch.cuda.current_stream(words.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vote_mask launch failed: CUDA error {err}")
    launches["vote_mask"] += 1
    return out


def read_votes(qmask: torch.Tensor, valid: torch.Tensor, row_starts: torch.Tensor, D: int,
               lcm: int):
    """(votes int64 [R, D], unmatched int64 [R], n_kmers int64 [R]) of the
    read rows row_starts[r]..row_starts[r + 1] - 1 (int64 [R + 1],
    ascending) of the flat window masks qmask (int64 [N]) and their
    validity (bool [N]): a valid window with mask m != 0 votes
    lcm // popcount(m) for each of its datasets (bits below D); unmatched
    counts the valid windows with mask 0, n_kmers the valid windows."""
    D, lcm = int(D), int(lcm)
    _check_vote_args(qmask, valid, row_starts, D, lcm)
    if qmask.device.type == "cpu":
        return read_votes_reference(qmask, valid, row_starts, D, lcm)
    _device_check(qmask, "read_votes")
    R = row_starts.shape[0] - 1
    dev = qmask.device
    votes = torch.empty(R, D, dtype=torch.int64, device=dev)
    unmatched = torch.empty(R, dtype=torch.int64, device=dev)
    n_kmers = torch.empty(R, dtype=torch.int64, device=dev)
    if R == 0:
        return votes, unmatched, n_kmers
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.read_votes_launch(qmask.data_ptr(), valid.data_ptr(), row_starts.data_ptr(),
                                    R, D, lcm, votes.data_ptr(), unmatched.data_ptr(),
                                    n_kmers.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"read_votes launch failed: CUDA error {err}")
    launches["read_votes"] += 1
    return votes, unmatched, n_kmers
