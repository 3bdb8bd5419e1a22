"""The two extraction kernels (khoice_tpu_torch/csrc/extract_canonical.cu,
kernel A, and csrc/extract_sweep.cu, the sweep's doubled-text extraction)
vs their plain PyTorch versions on the card, exact equality: every size
around a block's tile, texts shorter than the halo, invalid codes at a
tile boundary and at the doubled text's junction, codes that are not
16-B aligned, and each wrapper's launch counter.

Needs a CUDA device and skips without one.  The file imports no jax, so
it runs where the JAX package is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_extract_cuda.py
"""

import numpy as np
import pytest
import torch

from khoice_tpu_torch.kernels import _build, extract
from khoice_tpu_torch.kernels import extract_sweep as kxs

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)

# the sweep's (kmax, KW, packed): each class of the 30-point grid
# (engine/ksweep.py::sweep_classes; the master class 49 packed), and kmax 63
SWEEP_CLASSES = [(30, 2, False), (46, 3, False), (49, 4, False), (49, 4, True),
                 (63, 4, False)]
A_KS = [2, 7, 15, 16, 31, 32, 60, 61, 63]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tile(name):
    return getattr(_build.load(), f"{name}_tile_elems")()


def _codes(rng, n, n_prob=0.01):
    """Random codes with some invalid ones (4 and 5)."""
    c = rng.integers(0, 4, size=n, dtype=np.uint8)
    c[rng.random(n) < n_prob] = 4
    c[rng.random(n) < n_prob / 4] = 5
    return c


def _sizes(tile):
    """n 1, below the 64-code halo, a tile - 1, + 0, + 1, and several tiles."""
    return [1, 15, 63, tile - 1, tile, tile + 1, 3 * tile + 17]


def _check_a(codes, k, gids):
    before = dict(extract.launches)
    keys, valid = extract.extract_canonical(codes, k)
    torch.cuda.synchronize()
    assert extract.launches["keys"] == before["keys"] + 1
    want_keys, want_valid = extract.extract_canonical_reference(codes, k)
    assert torch.equal(valid, want_valid) and torch.equal(keys, want_keys)
    if k <= extract.PACK_KMAX:
        got = extract.extract_packed(codes, gids, k)
        torch.cuda.synchronize()
        assert extract.launches["packed"] == before["packed"] + 1
        assert torch.equal(got, extract.extract_packed_reference(codes, gids, k))


def _check_sweep(codes, gids, kmax, KW, packed, doubled):
    mode = "doubled" if doubled else "direct"
    fn, plain = ((kxs.doubled_elements, kxs.doubled_elements_reference) if doubled
                 else (kxs.extract_fwd_sweep, kxs.extract_fwd_sweep_reference))
    before = kxs.launches[mode]
    words, pay = fn(codes, gids, kmax, KW, packed)
    torch.cuda.synchronize()
    assert kxs.launches[mode] == before + 1
    want_words, want_pay = plain(codes, gids, kmax, KW, packed)
    assert torch.equal(words, want_words)
    assert (pay is None and want_pay is None) or torch.equal(pay, want_pay)


@pytest.mark.cuda
@pytest.mark.parametrize("k", A_KS)
def test_extract_canonical_sizes(cuda, k):
    """Kernel A at every size around its tile, keys and packed."""
    for n in _sizes(_tile("extract_canonical")):
        rng = np.random.default_rng(n * 64 + k)
        codes = torch.from_numpy(_codes(rng, n)).to(cuda)
        _check_a(codes, k, torch.from_numpy(rng.integers(0, 256, n)).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("k", A_KS)
def test_extract_canonical_edges(cuda, k):
    """Invalid codes at and beside a tile boundary, codes at an unaligned
    offset (the 16-B loads' two-load path), all invalid and all valid."""
    tile = _tile("extract_canonical")
    rng = np.random.default_rng(k)
    base = _codes(rng, 4 * tile + 100, n_prob=0.0)
    for p in (tile - 1, tile, 2 * tile + 1, 3 * tile - k):
        base[p] = 4
    full = torch.from_numpy(base).to(cuda)
    gids = torch.from_numpy(rng.integers(0, 256, base.shape[0])).to(cuda)
    _check_a(full, k, gids)
    for off in (1, 5, 8, 13):
        n = 2 * tile + 33
        _check_a(full[off:off + n], k, gids[off:off + n])
    _check_a(torch.full((tile + 5,), 4, dtype=torch.uint8, device=cuda), k, gids[:tile + 5])
    _check_a(full[:tile - 50].clamp(max=3), k, gids[:tile - 50])


@pytest.mark.cuda
def test_extract_canonical_empty_and_rejects(cuda):
    codes = torch.zeros(0, dtype=torch.uint8, device=cuda)
    before = dict(extract.launches)
    keys, valid = extract.extract_canonical(codes, 21)
    assert keys.shape == (2, 0) and valid.shape == (0,) and extract.launches == before
    with pytest.raises(ValueError):
        extract.extract_canonical(codes.to(torch.int64), 21)
    with pytest.raises(ValueError):
        extract.extract_packed(codes, torch.zeros(0, dtype=torch.int64, device=cuda), 61)


@pytest.mark.cuda
@pytest.mark.parametrize("doubled", [False, True], ids=["direct", "doubled"])
@pytest.mark.parametrize("kmax,KW,packed", SWEEP_CLASSES)
def test_extract_sweep_sizes(cuda, kmax, KW, packed, doubled):
    """The sweep kernel at every size around its tile (doubled: n2 = 2n
    around it too)."""
    tile = _tile("extract_sweep")
    for n in _sizes(tile) + [(tile - 1) // 2, tile // 2, (tile + 1) // 2]:
        rng = np.random.default_rng(n * 64 + kmax)
        codes = torch.from_numpy(_codes(rng, n)).to(cuda)
        gids = torch.from_numpy(rng.integers(0, 64, n)).to(cuda)
        _check_sweep(codes, gids, kmax, KW, packed, doubled)


@pytest.mark.cuda
@pytest.mark.parametrize("kmax,KW,packed", SWEEP_CLASSES)
def test_extract_sweep_edges(cuda, kmax, KW, packed):
    """Invalid codes at a tile boundary and at the doubled text's junction
    (the last code, whose complement opens the second half), a text whose
    doubled half starts off a 16-B boundary, direct slices at unaligned
    offsets whose buffer holds valid codes past their end, and texts of
    nothing but invalid codes."""
    tile = _tile("extract_sweep")
    rng = np.random.default_rng(kmax)
    for n in (3 * tile + 8, 3 * tile + 16, 2 * tile - 3):
        c = _codes(rng, n, n_prob=0.0)
        c[[tile - 1, tile, n - 1]] = 4
        codes = torch.from_numpy(c).to(cuda)
        gids = torch.from_numpy(rng.integers(0, 64, n)).to(cuda)
        _check_sweep(codes, gids, kmax, KW, packed, True)
        _check_sweep(codes, gids, kmax, KW, packed, False)
    buf = torch.from_numpy(_codes(rng, 5 * tile, n_prob=0.0)).to(cuda)
    gbuf = torch.from_numpy(rng.integers(0, 64, 5 * tile)).to(cuda)
    for off in (1, 5, 8, 13, tile):
        n = 2 * tile + 45
        _check_sweep(buf[off:off + n], gbuf[off:off + n], kmax, KW, packed, False)
        _check_sweep(buf[off:off + n], gbuf[off:off + n], kmax, KW, packed, True)
    bad = torch.full((tile + 7,), 4, dtype=torch.uint8, device=cuda)
    for doubled in (False, True):
        _check_sweep(bad, gbuf[:tile + 7], kmax, KW, packed, doubled)


@pytest.mark.cuda
def test_extract_sweep_engine_names_and_empty(cuda):
    """The names the engine calls launch the kernel; n 0 launches nothing."""
    rng = np.random.default_rng(9)
    codes = torch.from_numpy(_codes(rng, 50000)).to(cuda)
    gids = torch.from_numpy(rng.integers(0, 8, 50000)).to(cuda)
    before = dict(kxs.launches)
    words, _ = kxs.doubled_elements(codes, gids, 49, 4, True)
    fwd, _ = kxs.extract_fwd_sweep(codes, gids, 49, 4, True)
    torch.cuda.synchronize()
    assert kxs.launches == {"doubled": before["doubled"] + 1, "direct": before["direct"] + 1}
    assert torch.equal(words, kxs.doubled_elements_reference(codes, gids, 49, 4, True)[0])
    assert torch.equal(fwd, kxs.extract_fwd_sweep_reference(codes, gids, 49, 4, True)[0])
    empty = codes[:0]
    words, pay = kxs.doubled_elements(empty, gids[:0], 30, 2, False)
    assert words.shape == (2, 0) and pay.shape == (0,)
    assert kxs.launches["doubled"] == before["doubled"] + 1
    with pytest.raises(ValueError, match="payload does not fit"):
        kxs.doubled_elements(codes, gids, 30, 2, True)
