"""The multi-word sort: the wrapper of its CUDA kernel
(csrc/radix_sort.cu, a stable LSD radix sort in one-sweep passes) and its
plain PyTorch version.

Replaces the TPU kernel khoice_tpu/kernels/merge_pallas.py::merge_sort
(:340) in its role: the sort of the engine's key words, which the JAX
package runs as a flat lax.sort (engine/ksweep.py:384,386) and built the
merge-path kernel to replace.  Every sort of the port goes through
`sort_words`: the shared-sort sweeps (engine/ksweep.py), the streaming
sweep (engine/streaming.py), the per-k path (engine/occurrence.py), the
table ops (engine/ops.py) and the annotation (classify/annotate.py).

Layout: int64 [W, n] of 32-bit words, most significant first (the port's
key layout, engine/bits.py), W = 1..5; the payload is int64 [n].  For a
CUDA tensor `sort_words` launches the kernel on the current stream, or
raises; for a CPU tensor it runs `sort_words_reference`.  Both are
stable, so their results are equal bit for bit, payload included.
Launches are counted in `launches` (one per sort), and the last sort's
plan is kept in `last_plan`.

The kernel's first pass takes `sort_stats`: every byte digit's histogram
over the elements that are not all ones (SENTINEL in every word, the
largest key), their count, and whether they already sit at the tail.
`plan_passes` turns these into the digit passes the kernel runs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_WORDS = 5
ONES = 0xFFFFFFFF

# kernel launches since the last reset (CPU calls of the plain version do
# not count)
launches = 0

# (digits, sentinel bucket) of the last sort the kernel ran
last_plan = None


def sort_words_reference(words: torch.Tensor, payload: torch.Tensor | None = None):
    """Plain version: sort int64 [W, n] key words as unsigned W*32-bit
    keys, stably; the payload (if any) follows its element.

    Word pairs fold into signed int64 keys with the sign bit flipped
    ((w0 - 2^31) * 2^32 + w1), and stable sorts run from the least
    significant pair up (LSD)."""
    KW = words.shape[0]
    cols = list(words) + [torch.zeros_like(words[0])] * (KW % 2)
    perm = None
    for j in reversed(range(0, len(cols), 2)):
        key = (cols[j] - (1 << 31)) * (1 << 32) + cols[j + 1]
        if perm is not None:
            key = key[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return words[:, perm], (None if payload is None else payload[perm])


def sort_stats_reference(words: torch.Tensor):
    """Plain version of the first pass's statistics of int64 [W, n] words:
    (hist int64 [W * 4, 256], row word * 4 + byte (byte 0 the least
    significant) over the elements that are not all ones; their count of
    all-ones elements; whether those are all at the tail)."""
    W, n = words.shape
    ones = (words == ONES).all(0)
    rest = words[:, ~ones]
    hist = torch.stack([torch.bincount((rest[w] >> (8 * b)) & 255, minlength=256)
                        for w in range(W) for b in range(4)])
    n_ones = int(ones.sum())
    return hist.cpu(), n_ones, bool(ones[n - n_ones:].all())


def plan_passes(hist: torch.Tensor, n_ones: int, ones_at_tail: bool):
    """(digits, sentinel bucket): the digit passes of a sort, least
    significant first (digit = word * 4 + byte), and whether its passes
    put all-ones elements in a 257th bucket after bucket 255.

    A digit on which the other elements all fall into one bucket is
    skipped (a stable pass over it is the identity on them).  All-ones
    elements take the 257th bucket in every pass, which keeps them at the
    tail in input order, where the stable sort puts them; one pass runs
    when they are not at the tail yet and no digit varies."""
    W = hist.shape[0] // 4
    h = hist.reshape(W * 4, 256)
    varying = (h.amax(1) != h.sum(1)).tolist()
    digits = [w * 4 + b for w in reversed(range(W)) for b in range(4) if varying[w * 4 + b]]
    if n_ones and not ones_at_tail and not digits:
        digits = [(W - 1) * 4]
    return digits, bool(n_ones and digits)


def _check(words: torch.Tensor, payload: torch.Tensor | None):
    if (words.dtype != torch.int64 or words.dim() != 2
            or not 1 <= words.shape[0] <= MAX_WORDS or not words.is_contiguous()):
        raise ValueError(f"words must be contiguous int64 [W<={MAX_WORDS}, n], got "
                         f"{words.dtype} {tuple(words.shape)}")
    if payload is not None and (payload.dtype != torch.int64
                                or payload.shape != words.shape[1:]
                                or not payload.is_contiguous()
                                or payload.device != words.device):
        raise ValueError("payload must be a contiguous int64 [n] on the words' device")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _first_pass(lib, words: torch.Tensor, payload: torch.Tensor | None, stream):
    """The kernel's first pass: (records int32 [n * R], statistics on the
    host as sort_stats_reference returns them)."""
    W, n = words.shape
    R = W + (0 if payload is None else 2)
    rec = torch.empty(n * R, dtype=torch.int32, device=words.device)
    stats = torch.zeros(W * 4 * 256 + 2, dtype=torch.int64, device=words.device)
    err = lib.radix_sort_first_pass(words.data_ptr(), _ptr(payload), n, W, rec.data_ptr(),
                                    stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"radix_sort first pass launch failed: CUDA error {err}")
    host = stats.cpu()  # the sort's one synchronisation
    n_ones, end = int(host[-2]), int(host[-1])
    return rec, stats, (host[:-2].view(W * 4, 256), n_ones, end == n - n_ones)


def _device_check(words: torch.Tensor):
    if words.device.type != "cuda":
        raise ValueError(f"no radix_sort kernel for device {words.device}")


def sort_stats(words: torch.Tensor):
    """The first pass's statistics of int64 [W, n] words, as
    `sort_stats_reference` gives them: the kernel's first pass alone on a
    CUDA tensor (not counted as a sort), the plain version on the CPU."""
    _check(words, None)
    if words.device.type == "cpu" or words.shape[1] == 0:
        return sort_stats_reference(words)
    _device_check(words)
    lib = _build.load()
    with torch.cuda.device(words.device):
        return _first_pass(lib, words, None, torch.cuda.current_stream(words.device).cuda_stream)[2]


def _launch(words: torch.Tensor, payload: torch.Tensor | None):
    global launches, last_plan
    _device_check(words)
    W, n = words.shape
    if n == 0:
        return words.clone(), (None if payload is None else payload.clone())
    lib = _build.load()
    dev = words.device
    pay = payload is not None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rec, stats, plan_in = _first_pass(lib, words, payload, stream)
        digits, ones = plan_passes(*plan_in)
        launches += 1
        last_plan = (digits, ones)
        if not digits:  # sorted already
            return words.clone(), (None if payload is None else payload.clone())
        D = len(digits)
        tile = lib.radix_sort_tile_elems(W, int(pay))
        status = torch.zeros((n + tile - 1) // tile * 256 + D, dtype=torch.int64, device=dev)
        plan = (ctypes.c_int * D)(*digits)
        bufs = [rec, torch.empty_like(rec) if D > 1 else None]
        del rec

        def run(out, pout, begin, end):
            err = lib.radix_sort_passes(_ptr(bufs[0]), _ptr(bufs[1]), _ptr(out), _ptr(pout), n, W,
                                        int(pay), plan, D, begin, end, int(ones),
                                        stats.data_ptr(), status.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"radix_sort passes {begin}..{end} launch failed: "
                                   f"CUDA error {err}")

        if D > 1:
            run(None, None, 0, D - 1)
        # the buffer the last pass does not read goes before its output is
        # allocated (the allocator reuses it in stream order)
        bufs[D % 2] = None
        out = torch.empty((W, n), dtype=torch.int64, device=dev)
        pout = torch.empty(n, dtype=torch.int64, device=dev) if pay else None
        run(out, pout, D - 1, D)
    return out, pout


def sort_words(words: torch.Tensor, payload: torch.Tensor | None = None):
    """(sorted int64 [W, n] words, payload in the same order or None):
    int64 [W, n] key words sorted as unsigned W*32-bit keys, stably."""
    _check(words, payload)
    if words.device.type == "cpu":
        return sort_words_reference(words, payload)
    return _launch(words, payload)
