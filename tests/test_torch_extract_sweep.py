"""The sweep's extraction (khoice_tpu_torch/kernels/extract_sweep.py: the
plain versions that the CPU runs and the wrappers' checks) vs the JAX
package's khoice_tpu/engine/ksweep.py::_extract_fwd_sweep, on the CPU.
The doubled form is held against the JAX function on the concatenated
text, codes ++ revcomp(codes), as its _sweep_doubled builds it.  Every
compared value is an integer word, so the tolerance is exact equality."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from khoice_tpu.engine import ksweep as jks
from khoice_tpu_torch.engine import interop
from khoice_tpu_torch.engine import ksweep as tks
from khoice_tpu_torch.engine.occurrence import pack_members
from khoice_tpu_torch.kernels import extract_sweep as kxs

# (kmax, KW, packed): every class the wrappers take at these kmax; the
# packed payload fits the spare bits at 35 and 49 only
CLASSES = [(15, 1, False), (31, 2, False), (35, 3, False), (35, 3, True),
           (49, 4, False), (49, 4, True)]
CASES = ["runs and separators", "shorter than 16 KW", "all invalid"]


def _members(nprng, case, KW):
    """Member code arrays of a named text: N runs longer than any kmax and
    a code 5 among three members joined by separators; one member shorter
    than 16 * KW bases; or nothing but invalid codes."""
    if case == "shorter than 16 KW":
        return [nprng.integers(0, 4, 16 * KW - 3, dtype=np.uint8)]
    if case == "all invalid":
        return [np.full(300, 4, np.uint8), np.full(40, 5, np.uint8)]
    out = []
    for n in (900, 70, 400):
        c = nprng.integers(0, 4, n, dtype=np.uint8)
        p = int(nprng.integers(0, n - 10))
        c[p:p + int(nprng.integers(64, 90))] = 4
        c[int(nprng.integers(0, n))] = 5
        out.append(c)
    return out


def _jax(codes2, gids2, kmax, KW, packed):
    fwd, pay = jks._extract_fwd_sweep(jnp.asarray(codes2), jnp.asarray(gids2), kmax, KW,
                                      packed=packed)
    return np.stack([np.asarray(w) for w in fwd]), None if pay is None else np.asarray(pay)


def _assert_equal(got, want, n2, KW):
    words, pay = got
    assert words.shape == (KW, n2) and words.dtype == torch.int64
    np.testing.assert_array_equal(np.stack(interop.words_to_numpy(words)), want[0])
    if want[1] is None:
        assert pay is None
    else:
        np.testing.assert_array_equal(interop.payload_to_numpy(pay), want[1])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("doubled", [False, True], ids=["direct", "doubled"])
@pytest.mark.parametrize("kmax,KW,packed", CLASSES)
def test_sweep_extraction_equals_jax(nprng, kmax, KW, packed, doubled, case):
    """The direct form on the JAX doubled text, and the doubled form on the
    packed members, equal the JAX function on that doubled text; the CPU
    path launches nothing."""
    codes_t, gids_t = pack_members(_members(nprng, case, KW), "cpu")
    codes, gids = interop.members_to_numpy(codes_t, gids_t)
    rc = np.where(codes < 4, codes ^ 3, codes)[::-1]
    codes2, gids2 = np.concatenate([codes, rc]), np.concatenate([gids, gids[::-1]])
    want = _jax(codes2, gids2, kmax, KW, packed)
    before = dict(kxs.launches)
    if doubled:
        got = kxs.doubled_elements(codes_t, gids_t, kmax, KW, packed)
        assert all(torch.equal(a, b) if a is not None else b is None for a, b in zip(
            got, tks._doubled_elements(codes_t, gids_t, kmax, KW, packed)))
    else:
        got = kxs.extract_fwd_sweep(*interop.members_from_numpy(codes2, gids2, "cpu"),
                                    kmax, KW, packed)
    assert kxs.launches == before
    _assert_equal(got, want, codes2.shape[0], KW)
    nio = (want[0][-1] if packed else want[1]) & 0x3F
    if case == "all invalid":
        assert not nio.any()
    elif case == "runs and separators":
        assert nio.max() == kmax  # some windows were whole


@pytest.mark.parametrize("kmax,KW,packed", CLASSES)
def test_direct_slice_pads_its_end(nprng, kmax, KW, packed):
    """A chunk sliced out of a longer buffer (the streaming sweep's call):
    the positions past the slice read as invalid although the buffer
    behind it holds valid codes, as the JAX function pads its input."""
    buf = nprng.integers(0, 4, 2000, dtype=np.uint8)
    gbuf = nprng.integers(0, 3, 2000).astype(np.uint32)
    start, stop = 37, 37 + 1100
    codes_t, gids_t = interop.members_from_numpy(buf, gbuf, "cpu")
    got = kxs.extract_fwd_sweep(codes_t[start:stop], gids_t[start:stop], kmax, KW, packed)
    want = _jax(buf[start:stop], gbuf[start:stop], kmax, KW, packed)
    _assert_equal(got, want, stop - start, KW)
    nio = (want[0][-1] if packed else want[1]) & 0x3F
    np.testing.assert_array_equal(nio[-kmax:], np.arange(kmax, 0, -1))


def test_streaming_chunk_call_equals_jax(nprng):
    """engine/ksweep.py::_extract_fwd_sweep, the name the streaming sweep
    calls, on a chunk of a doubled text with its halo."""
    codes2, gids2 = np.concatenate([nprng.integers(0, 4, 3000, dtype=np.uint8),
                                    np.full(5, 4, np.uint8)]), nprng.integers(0, 5, 3005)
    codes_t, gids_t = interop.members_from_numpy(codes2, gids2.astype(np.uint32), "cpu")
    got = tks._extract_fwd_sweep(codes_t[1000:2048 + 48], gids_t[1000:2048 + 48], 49, 4, True)
    _assert_equal(got, _jax(codes2[1000:2096], gids2[1000:2096].astype(np.uint32), 49, 4,
                            True), 1096, 4)


@pytest.mark.parametrize("wrapper", ["extract_fwd_sweep", "doubled_elements"])
def test_wrappers_reject_bad_inputs(wrapper):
    fn = getattr(kxs, wrapper)
    codes = torch.zeros(100, dtype=torch.uint8)
    gids = torch.zeros(100, dtype=torch.int64)
    with pytest.raises(ValueError, match="codes must be"):
        fn(codes.to(torch.int32), gids, 35, 3, True)  # dtype
    with pytest.raises(ValueError, match="codes must be"):
        fn(codes.view(10, 10), gids, 35, 3, True)  # shape
    with pytest.raises(ValueError, match="gids must be"):
        fn(codes, gids.to(torch.int32), 35, 3, True)
    with pytest.raises(ValueError, match="gids must be"):
        fn(codes, gids[:99], 35, 3, True)
    with pytest.raises(ValueError, match="gids must be"):
        fn(codes, gids.to("meta"), 35, 3, True)  # device
    with pytest.raises(ValueError, match="does not fit"):
        fn(codes, gids, 35, 2, False)  # 70 bits in two words
    for kmax, KW in ((31, 2), (15, 1), (60, 4)):
        with pytest.raises(ValueError, match="payload does not fit"):
            fn(codes, gids, kmax, KW, True)
    # a tensor on no CPU goes to the kernel, which has no build for it
    with pytest.raises(ValueError, match="no extract_sweep kernel"):
        fn(codes.to("meta"), gids.to("meta"), 35, 3, True)


def test_plain_packed_raises_where_the_payload_does_not_fit():
    codes = torch.zeros(10, dtype=torch.uint8)
    gids = torch.zeros(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="payload does not fit"):
        kxs.extract_fwd_sweep_reference(codes, gids, 31, 2, True)
    words, pay = kxs.extract_fwd_sweep_reference(codes, gids, 31, 2, False)
    assert words.shape == (2, 10) and pay.shape == (10,)
