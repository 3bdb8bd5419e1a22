"""The shared-sort sweep's extraction: the wrappers of its CUDA kernel
(csrc/extract_sweep.cu) and its plain PyTorch versions.

Replaces XLA code of the JAX package, khoice_tpu/engine/ksweep.py::
_extract_fwd_sweep (:142) and the doubling in _sweep_doubled (:366).
Every position i of a text yields KW forward 16-base words, word w
packing bases [i + 16w, i + 16w + 16) most significant first (a base
>= 4 packs as 0; bases past the text read as 4), the last word's low
KW * 32 - 2 * kmax bits zeroed, and a payload of its gid and nio (the
consecutive valid bases from i, capped at kmax): (gid << 6) | nio ORed
into the last word when `packed`, else an int64 row (gid << 8) | nio.

- `extract_fwd_sweep(codes2, gids2, kmax, KW, packed)` extracts a text
  as given (the streaming sweep's chunks);
- `doubled_elements(codes, gids, kmax, KW, packed)` extracts the doubled
  text codes ++ revcomp(codes), with gids ++ flip(gids), in one pass
  that reads the second half from the mirrored range.

Both return (int64 [KW, n2] words, int64 [n2] payload or None).  For a
CUDA tensor each launches the kernel on the current stream, or raises;
for a CPU tensor it runs its plain version.  Kernel launches are counted
per mode in `launches`.
"""

from __future__ import annotations

import torch

from . import _build
from .ksweep_scan import NIO_BITS, PACK_MIN_SPARE, PACK_NIO_BITS, _U32

# kernel launches per mode since the last reset (CPU calls of the plain
# versions do not count)
launches = {"direct": 0, "doubled": 0}


def extract_fwd_sweep_reference(codes2: torch.Tensor, gids2: torch.Tensor, kmax: int,
                                KW: int, packed: bool = False):
    """Forward kmax-mer keys (int64 [KW, n], left-aligned) and payload.

    codes2: uint8 [n] codes (4 = invalid); gids2: int64 [n].  Word w of
    position i packs bases [i+16w, i+16w+16), so one 16-base packing of
    an extended range yields every word as a slice.  nio (consecutive
    valid bases from i, capped at kmax) is the distance to the next
    invalid position.  Bases at invalid positions pack as 0; bases after
    one inside the window keep their values, which no k <= nio ever
    reads.

    packed=False: payload = (gid << 8) | nio, returned separately.
    packed=True: (gid << 6) | nio ORed into the last word's spare bits
    (requires can_pack_payload(kmax, KW)); payload None."""
    n = codes2.shape[0]
    dev = codes2.device
    m = n + 16 * (KW - 1)
    cp = torch.cat([codes2, torch.full((16 * KW,), 4, dtype=codes2.dtype, device=dev)])
    valid = cp < 4
    w = torch.where(valid, cp.to(torch.int64) & 3, 0)
    # pairs -> quads -> bytes -> 16-base words; w[i] packs 2^s bases from i
    for s in range(4):
        span = 1 << s
        w = (w[: w.shape[0] - span] << (2 * span)) | w[span:]
    w = w[:m]
    fwd = torch.stack([w[16 * wi: 16 * wi + n] for wi in range(KW)])
    del w
    spare = KW * 32 - 2 * kmax
    if spare:
        fwd[-1] &= (_U32 >> spare) << spare
    # nio from the next invalid position at or after i: a binary search
    # in the sorted invalid positions (the padding guarantees one), the
    # exact equivalent of the JAX package's reverse cummin
    inv = torch.nonzero(~valid).squeeze(1)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    nio = torch.clamp(inv[torch.searchsorted(inv, idx)] - idx, max=kmax)
    if packed:
        if spare < PACK_MIN_SPARE:
            raise ValueError(f"payload does not fit the spare bits of kmax={kmax}, KW={KW}")
        fwd[-1] |= (gids2 << PACK_NIO_BITS) | nio
        return fwd, None
    return fwd, (gids2 << NIO_BITS) | nio


def doubled_elements_reference(codes: torch.Tensor, gids: torch.Tensor, kmax: int,
                               KW: int, packed: bool):
    """Doubled text (codes ++ revcomp) -> its forward kmax-mer elements,
    unsorted: (int64 [KW, n2] words, payload or None)."""
    rc = torch.where(codes < 4, codes ^ 3, codes).flip(0)
    codes2 = torch.cat([codes, rc])
    gids2 = torch.cat([gids, gids.flip(0)])
    return extract_fwd_sweep_reference(codes2, gids2, kmax, KW, packed=packed)


def _check(codes: torch.Tensor, gids: torch.Tensor, kmax: int, KW: int, packed: bool):
    if codes.dtype != torch.uint8 or codes.dim() != 1 or not codes.is_contiguous():
        raise ValueError(f"codes must be contiguous uint8 [n], got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    if (gids.dtype != torch.int64 or gids.shape != codes.shape or not gids.is_contiguous()
            or gids.device != codes.device):
        raise ValueError("gids must be a contiguous int64 [n] on the codes' device, got "
                         f"{gids.dtype} {tuple(gids.shape)} on {gids.device}")
    if not (2 <= kmax <= 63 and 1 <= KW <= 4 and 2 * kmax <= 32 * KW):
        raise ValueError(f"kmax={kmax} does not fit KW={KW} words (2 <= kmax <= 63, KW <= 4)")
    if packed and KW * 32 - 2 * kmax < PACK_MIN_SPARE:
        raise ValueError(f"payload does not fit the spare bits of kmax={kmax}, KW={KW}")


def _launch(codes: torch.Tensor, gids: torch.Tensor, kmax: int, KW: int, packed: bool,
            doubled: bool):
    if codes.device.type != "cuda":
        raise ValueError(f"no extract_sweep kernel for device {codes.device}")
    lib = _build.load()
    n = codes.shape[0]
    n2 = 2 * n if doubled else n
    words = torch.empty(KW, n2, dtype=torch.int64, device=codes.device)
    payload = None if packed else torch.empty(n2, dtype=torch.int64, device=codes.device)
    if n == 0:
        return words, payload
    with torch.cuda.device(codes.device):
        err = lib.extract_sweep_launch(
            codes.data_ptr(), gids.data_ptr(), n, int(doubled), kmax, KW,
            words.data_ptr(), None if payload is None else payload.data_ptr(),
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"extract_sweep launch failed: CUDA error {err}")
    launches["doubled" if doubled else "direct"] += 1
    return words, payload


def extract_fwd_sweep(codes2: torch.Tensor, gids2: torch.Tensor, kmax: int, KW: int,
                      packed: bool = False):
    """(int64 [KW, n] words, payload or None) of every position of the
    text codes2 (uint8 [n]) with gids2 (int64 [n]); positions past n read
    as invalid."""
    kmax, KW, packed = int(kmax), int(KW), bool(packed)
    _check(codes2, gids2, kmax, KW, packed)
    if codes2.device.type == "cpu":
        return extract_fwd_sweep_reference(codes2, gids2, kmax, KW, packed)
    return _launch(codes2, gids2, kmax, KW, packed, False)


def doubled_elements(codes: torch.Tensor, gids: torch.Tensor, kmax: int, KW: int,
                     packed: bool):
    """(int64 [KW, 2n] words, payload or None) of every position of the
    doubled text codes ++ revcomp(codes), gids ++ flip(gids)."""
    kmax, KW, packed = int(kmax), int(KW), bool(packed)
    _check(codes, gids, kmax, KW, packed)
    if codes.device.type == "cpu":
        return doubled_elements_reference(codes, gids, kmax, KW, packed)
    return _launch(codes, gids, kmax, KW, packed, True)
