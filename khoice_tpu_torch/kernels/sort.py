"""The multi-word sort: the wrapper of its CUDA kernel
(csrc/radix_sort.cu, a stable LSD radix sort) and its plain PyTorch
version.

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
Launches are counted in `launches`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_WORDS = 5

# kernel launches since the last reset (CPU calls of the plain version do
# not count)
launches = 0


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


def _varying_digits(hist: torch.Tensor, W: int, n: int) -> list:
    """The digits (word * 4 + byte) whose histogram has more than one
    non-empty bucket, least significant first."""
    full = (hist.view(W * 4, 256).cpu() == n).any(1).tolist()
    return [w * 4 + b for w in reversed(range(W)) for b in range(4) if not full[w * 4 + b]]


def _launch(words: torch.Tensor, payload: torch.Tensor | None):
    global launches
    if words.device.type != "cuda":
        raise ValueError(f"no radix_sort kernel for device {words.device}")
    W, n = words.shape
    if n == 0:
        return words.clone(), (None if payload is None else payload.clone())
    lib = _build.load()
    dev = words.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        keys = [torch.empty((W, n), dtype=torch.int32, device=dev) for _ in range(2)]
        hist = torch.zeros(W * 4 * 256, dtype=torch.int64, device=dev)
        err = lib.radix_sort_prepare(words.data_ptr(), n, W, keys[0].data_ptr(),
                                     hist.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"radix_sort prepare launch failed: CUDA error {err}")
        digits = _varying_digits(hist, W, n)
        pays = ([torch.empty(n, dtype=torch.int64, device=dev) for _ in range(2)]
                if payload is not None and digits else [None, None])
        if digits:
            n_tiles = (n + lib.radix_sort_tile_elems() - 1) // lib.radix_sort_tile_elems()
            slots = torch.empty(256 * n_tiles, dtype=torch.int64, device=dev)
            err = lib.radix_sort_passes(
                keys[0].data_ptr(), keys[1].data_ptr(),
                None if payload is None else payload.data_ptr(),
                None if pays[0] is None else pays[0].data_ptr(),
                None if pays[1] is None else pays[1].data_ptr(),
                n, W, (ctypes.c_int * len(digits))(*digits), len(digits), hist.data_ptr(),
                slots.data_ptr(), stream,
            )
            if err != 0:
                raise RuntimeError(f"radix_sort passes launch failed: CUDA error {err}")
            del slots
        # pass p writes keys[(p + 1) % 2] and pays[p % 2]; the buffers not
        # read by the write-back are released before its output is allocated
        last = len(digits) % 2
        keys = keys[last]
        pay = payload if not digits else pays[(len(digits) - 1) % 2]
        del pays
        out = torch.empty((W, n), dtype=torch.int64, device=dev)
        pout = None if payload is None else torch.empty(n, dtype=torch.int64, device=dev)
        err = lib.radix_sort_finish(keys.data_ptr(), None if pay is None else pay.data_ptr(),
                                    out.data_ptr(), None if pout is None else pout.data_ptr(),
                                    n, W, stream)
    if err != 0:
        raise RuntimeError(f"radix_sort finish launch failed: CUDA error {err}")
    launches += 1
    return out, pout


def sort_words(words: torch.Tensor, payload: torch.Tensor | None = None):
    """(sorted int64 [W, n] words, payload in the same order or None):
    int64 [W, n] key words sorted as unsigned W*32-bit keys, stably."""
    _check(words, payload)
    if words.device.type == "cpu":
        return sort_words_reference(words, payload)
    return _launch(words, payload)
