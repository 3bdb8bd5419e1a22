"""KmerTable: a device-resident k-mer database (port of
khoice_tpu/engine/table.py).

Plays the role of a KMC3 database (`.kmc_pre`/`.kmc_suf`, reference
workflow/rules/exp_type_1.smk:156-163).  The port holds a table compact:
`keys` is int64 [W, n] of 32-bit words (engine/bits.py), unique and
ascending, and `counts` is int64 [n], every count > 0.  The JAX package's
run form (duplicate keys whose count sits at the run's first slot, SENTINEL
padding) and its power-of-two capacities served XLA's static shapes;
eager PyTorch has none, so the port leaves them out.  `to_host()` and
`dump()` give what the JAX package's give.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bits import SENTINEL, key_words

__all__ = ["KmerTable", "key_words", "SENTINEL", "table_from_host", "decode_key",
           "encode_kmer"]


@dataclasses.dataclass
class KmerTable:
    keys: torch.Tensor    # int64 [n_words, n]: unique ascending keys
    counts: torch.Tensor  # int64 [n]: every count > 0
    k: int

    @property
    def n_words(self) -> int:
        return self.keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.counts.device

    def __len__(self) -> int:
        return self.counts.shape[0]

    # ---- host-side helpers (pull data off the device) ----

    def to_host(self):
        """(keys_2d [n, n_words] uint32, counts [n] uint32) of the present
        keys, ascending."""
        keys = self.keys.cpu().numpy().T.astype(np.uint32)
        return keys, self.counts.cpu().numpy().astype(np.uint32)

    def dump(self):
        """Sorted text-dump records [(kmer_str, count)], ascending by k-mer:
        `kmc_tools transform ... dump -s` order (reference
        workflow/rules/exp_type_4.smk:255-258)."""
        keys, counts = self.to_host()
        return [(decode_key(keys[i], self.k), int(counts[i])) for i in range(keys.shape[0])]


def table_from_host(k: int, keys_2d: np.ndarray, counts: np.ndarray,
                    device="cuda") -> KmerTable:
    """A table on `device` from host (n, n_words) unique keys and their
    counts; keys are sorted here and zero counts dropped."""
    w = key_words(k)
    counts = np.asarray(counts)
    order = np.lexsort(tuple(keys_2d[:, i] for i in reversed(range(w))))
    order = order[counts[order] > 0]
    keys = np.asarray(keys_2d, np.uint32)[order].T.astype(np.int64).reshape(w, -1)
    return KmerTable(
        keys=torch.from_numpy(np.ascontiguousarray(keys)).to(device),
        counts=torch.from_numpy(counts[order].astype(np.int64)).to(device),
        k=k,
    )


_BASES = np.array(["A", "C", "G", "T"])


def decode_key(words: np.ndarray, k: int) -> str:
    """Decode an (n_words,) uint32 big-endian key into its k-mer string."""
    total_words = words.shape[0]
    digits = []
    # walk 2-bit digits from the least significant; yields the k-mer reversed
    vals = [int(x) for x in words]
    for _ in range(k):
        d = vals[-1] & 3
        digits.append(d)
        # shift the whole multiword right by 2
        carry = 0
        for i in range(total_words):
            v = vals[i]
            vals[i] = (v >> 2) | (carry << 30)
            carry = v & 3
    return "".join(_BASES[d] for d in reversed(digits))


def encode_kmer(kmer: str) -> np.ndarray:
    """Encode a k-mer string into its (n_words,) uint32 big-endian key."""
    w = key_words(len(kmer))
    vals = [0] * w
    lut = {"A": 0, "C": 1, "G": 2, "T": 3}
    for ch in kmer:
        d = lut[ch]
        out = []
        for i in range(w - 1):
            out.append(((vals[i] << 2) | (vals[i + 1] >> 30)) & 0xFFFFFFFF)
        out.append(((vals[w - 1] << 2) | d) & 0xFFFFFFFF)
        vals = out
    return np.array(vals, np.uint32)
