"""Member packing and the per-k fused occurrence path (port of
khoice_tpu/engine/occurrence.py).

Packing (engine/members.py).  The JAX package pads the packed text to a
geometric shape bucket (`_padded_len`) to bound XLA recompiles; eager
PyTorch has none, and the padding (code 4) changes no histogram: the
port leaves it out.

The per-k fused path.  What exp1 computes per (k, group) is "how many
distinct members contain each canonical k-mer": ONE sort of (canonical
key, gid) pairs, after which a key's run holds its (key, gid) sub-runs
and occ = the number of sub-run starts.  Two layouts, as in the JAX
package:
  * gid-packed (n_members <= 256, k <= 60): value = (key << 8) | gid over
    occ_words_static(k) words, so ordering by value is ordering by
    (key, gid) with the fewest sort words; the kernels are the extraction
    in its packed form (kernels/extract.py) and the occurrence histogram
    in its packed layout (kernels/occ_scan.py);
  * otherwise key_words(k) key words plus a separate gid.
The JAX package traces k as a runtime scalar and pads words to kmax
classes (kmax_class_packed) so that one XLA compile serves a word class;
the port takes k as a plain int and the exact width occ_words_static(k),
which changes no histogram.  This is exp1's path for groups of more than
64 members and for ks of small grids (engine/ksweep.py::plan_sweep), and
occurrence_table is the group union of exp2's per-k fallback.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..kernels.extract import GID_BITS, PACK_KMAX, extract_canonical, extract_packed
from ..kernels.occ_scan import occ_hist, occ_hist_packed, run_occurrences
from ..kernels.sort import sort_words
from ..utils import trace
from . import members
from .bits import key_words
from .table import KmerTable


def pack_members(member_codes: Sequence[np.ndarray], device):
    """(codes uint8 [n], gids int64 [n]) on `device`: the group's text
    (engine/members.py), each position labelled with its member index.
    Only the codes (1 B per position) cross to the device; the gids are
    expanded there from the member lengths."""
    with trace.span("engine:upload"):
        parts, starts, n = members.layout(member_codes)
        codes = torch.from_numpy(members.join(parts)).to(device)
        return codes, members.member_ids(starts, n, 0, n, device)


def pad_hist(counts, n_members: int, cx: int = 10000) -> List[int]:
    """exp1's histogram, cx ints: bins 1..min(n_members, cx) of `counts`, then 0s."""
    m = min(n_members, cx)
    head = counts[:m]
    return (head if isinstance(head, list) else head.tolist()) + [0] * (cx - m)


def gid_packable(n_members: int, k: int) -> bool:
    """The gid-packed layout holds the pair: gids < 2^GID_BITS, k <= 60."""
    return n_members <= (1 << GID_BITS) and k <= PACK_KMAX


def unpack_keys_static(sp: torch.Tensor, k: int) -> torch.Tensor:
    """key_words(k)-layout keys from gathered packed words, computed in
    place (sp is overwritten): key = packed >> GID_BITS, one row at a
    time.  sp holds no SENTINEL (occurrence_table drops that run first)."""
    ow = sp.shape[0]
    for j in range(ow - 1, -1, -1):
        sp[j] >>= GID_BITS
        if j:
            low = sp[j - 1] & ((1 << GID_BITS) - 1)
            low <<= 32 - GID_BITS
            sp[j] |= low
            del low
    wk = key_words(k)  # 4 for every k of 32-63, so one more than ow at k 32-44
    if wk > ow:
        keys = sp.new_zeros(wk, sp.shape[1])
        keys[wk - ow:] = sp
        return keys
    return sp[ow - wk:].clone() if wk < ow else sp  # the leading words are zero


def _sorted_pairs(codes: torch.Tensor, gids: torch.Tensor, k: int, packed: bool):
    """The per-k fused sort: (sorted words, sorted gid or None).  packed:
    int64 [occ_words_static(k), n] of (key << 8) | gid; else key words
    sorted by (key, gid) with the gid (0xFFFFFFFF where invalid) apart."""
    if packed:
        return sort_words(extract_packed(codes, gids, k))[0], None
    keys, valid = extract_canonical(codes, k)
    gid = torch.where(valid, gids, 0xFFFFFFFF)
    s, _ = sort_words(torch.cat([keys, gid[None]]))
    return s[:-1], s[-1]


def occurrence_histogram_packed(packed, n_members: int, k: int, cs: int = 5000,
                                cx: int = 10000) -> List[int]:
    """hist[i-1] = number of distinct canonical k-mers present in exactly i
    members (capped at cs), a list of cx ints, over packed (codes, gids)
    tensors (pack_members); runs on their device."""
    with trace.span("engine:perk"):
        codes, gids = packed
        n_bins = min(n_members, cx)
        if gid_packable(n_members, k):
            sp, _ = _sorted_pairs(codes, gids, k, True)
            small = occ_hist_packed(sp, n_bins, cs)
        else:
            keys, gid = _sorted_pairs(codes, gids, k, False)
            small = occ_hist(keys, gid, n_bins, cs)
        with trace.span("engine:readback"):
            return pad_hist(small, n_members, cx)


def occurrence_histogram(member_codes: Sequence[np.ndarray], k: int, device,
                         cs: int = 5000, cx: int = 10000) -> List[int]:
    """occurrence_histogram_packed over raw member code arrays."""
    return occurrence_histogram_packed(pack_members(member_codes, device),
                                       len(member_codes), k, cs=cs, cx=cx)


def occurrence_table(member_codes: Sequence[np.ndarray], k: int, device,
                     cs: int = 5000) -> KmerTable:
    """KmerTable whose counts are the number of members containing each
    key (capped at cs): `set_counts 1` + the n-way `kmc_tools complex`
    union in ONE sort (reference exp_type_1.smk:165-182,
    exp_type_2.smk:440-454)."""
    codes, gids = pack_members(member_codes, device)
    packed = gid_packable(len(member_codes), k)
    words, gid = _sorted_pairs(codes, gids, k, packed)
    del codes, gids
    # after the sort, each step frees what the next does not need
    # (engine/streaming.py::occurrence_table_bytes)
    starts, occ = run_occurrences(words, gid, cs)
    if starts.shape[0] and not occ[-1]:  # the SENTINEL run
        starts, occ = starts[:-1], occ[:-1]
    keys = words[:, starts]
    del words, gid, starts
    if packed:
        keys = unpack_keys_static(keys, k)
    return KmerTable(keys=keys, counts=occ, k=k)
