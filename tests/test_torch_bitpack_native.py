"""The port's fixed-width bitpack codec (ops/bitpack.py) and native host
runtime (native.py) against the JAX package's: the checks of
tests/test_bitpack.py and tests/test_native.py on the port, the device
decode bit for bit against the JAX gather and the host decode, the same
codec bytes as the JAX package's, and the numpy fallbacks' bytes equal to
the C++ library's."""

import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from knowhere_tpu import native as jnative
from knowhere_tpu.ops import bitpack as jbp
from knowhere_tpu_torch import native
from knowhere_tpu_torch.ops.bitpack import pack_fixed, unpack_all, unpack_gather, width_for

ROOT = Path(__file__).resolve().parents[1]


def _gather(p, idx, bits):
    return unpack_gather(torch.from_numpy(p.view(np.int32)), torch.from_numpy(np.asarray(idx, np.int64)), bits).numpy()


@pytest.mark.parametrize("bits", [1, 3, 8, 13, 16, 17, 18, 24, 31, 32])
def test_roundtrip_and_gather(bits):
    rng = np.random.default_rng(bits)
    a = rng.integers(0, 1 << bits, size=5003, dtype=np.uint64).astype(np.uint32)
    p = pack_fixed(a, bits)
    np.testing.assert_array_equal(p, jbp.pack_fixed(a, bits))
    assert p.size == (a.size * bits + 31) // 32 + 1
    assert (unpack_all(p, a.size, bits) == a).all()
    idx = rng.integers(0, a.size, size=2048)
    got = _gather(p, idx, bits)
    assert got.dtype == np.int64 and (got == a[idx]).all()
    want = np.asarray(jbp.unpack_gather(jax.device_put(p), jax.device_put(idx.astype(np.int32)), bits))
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_word_boundary_offsets():
    # 20 bits cross every offset mod 32, ofs == 0 included (where the
    # reference guards a shift by 32)
    a = np.arange(64, dtype=np.uint32) + 0xFF000
    p = pack_fixed(a, 20)
    assert (_gather(p, np.arange(64), 20) == a).all()
    # all-ones words: the high word's top bit set, every value the mask
    ones = np.full(100, (1 << 31) - 1, np.uint32)
    assert (_gather(pack_fixed(ones, 31), np.arange(100), 31) == ones).all()
    top = np.full(100, 0xFFFFFFFF, np.uint32)
    assert (_gather(pack_fixed(top, 32), np.arange(100), 32) == top.astype(np.int64)).all()


def test_value_too_wide_rejected():
    with pytest.raises(ValueError):
        pack_fixed(np.asarray([8], np.uint32), 3)
    with pytest.raises(ValueError):
        pack_fixed(np.asarray([1], np.uint32), 33)


def test_empty_and_width_for():
    assert pack_fixed(np.zeros(0, np.uint32), 7).size == 1
    assert unpack_all(pack_fixed(np.zeros(0, np.uint32), 7), 0, 7).size == 0
    for n, w in ((2, 1), (65535, 16), (65536, 16), (65537, 17), (200_000, 18), (10_000_000, 24)):
        assert width_for(n) == w == jbp.width_for(n)


# ---------------------------------------------------------------------------
# native.py
# ---------------------------------------------------------------------------


def test_library_builds_under_build_not_native():
    """The C++ library builds with g++ into build/knowhere_tpu_torch/; the
    tracked native/libknowhere_native.so is not written."""
    tracked = ROOT / "native" / "libknowhere_native.so"
    before = (tracked.stat().st_mtime_ns, tracked.read_bytes()) if tracked.exists() else None
    assert native.available()
    so = native._so_path()
    assert so.exists() and so.parent == ROOT / "build" / "knowhere_tpu_torch"
    after = (tracked.stat().st_mtime_ns, tracked.read_bytes()) if tracked.exists() else None
    assert after == before


def test_posting_roundtrip_and_bytes():
    rng = np.random.default_rng(0)
    ids = np.unique(rng.integers(0, 1_000_000, size=5000)).astype(np.uint32)
    blob = native.encode_postings(ids)
    assert len(blob) < ids.nbytes  # delta+varint compresses
    assert blob == jnative.encode_postings(ids)
    np.testing.assert_array_equal(native.decode_postings(blob, len(ids)), ids.astype(np.int64))
    one = native.encode_postings(np.array([42], np.uint32))
    np.testing.assert_array_equal(native.decode_postings(one, 1), [42])


def test_bitpack_roundtrip_and_bytes():
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 1 << 17, size=4096).astype(np.uint32)
    blob, bits = native.bitpack(vals)
    assert bits <= 17 and (blob, bits) == jnative.bitpack(vals)
    np.testing.assert_array_equal(native.bitunpack(blob, len(vals), bits), vals)


def test_popcount_and_gather_rows(tmp_path):
    rng = np.random.default_rng(2)
    buf = rng.integers(0, 256, size=100_003, dtype=np.uint8)
    assert native.popcount(buf) == int(np.unpackbits(buf).sum())
    data = rng.standard_normal((500, 16)).astype(np.float32)
    path = str(tmp_path / "rows.bin")
    with open(path, "wb") as f:
        f.write(b"HDR!")  # a 4-byte header before the rows
        data.tofile(f)
    ids = np.array([3, 499, 0, 77, 77])
    rows = native.gather_rows(path, 4, 64, ids)
    np.testing.assert_array_equal(rows.view(np.float32).reshape(5, 16), data[ids])
    np.testing.assert_array_equal(native.gather_rows_mt(path, 4, 64, ids, n_threads=4), rows)


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_codecs_match_jax(seed):
    """The CSR index codecs (delta-varint, the adaptive choice) give the JAX
    package's bytes and decode back, both ways."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 40, size=500)
    lens[::50] = 0  # empty rows
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    scale = 30_000 if seed else 200  # large deltas (varint) / small (bitpack)
    indices = np.concatenate([np.sort(rng.choice(scale, size=n, replace=False)) for n in lens]).astype(np.int32)
    vb = native.encode_csr_indices(indices, indptr)
    assert vb == jnative.encode_csr_indices(indices, indptr)
    ad, codec = native.encode_csr_indices_adaptive(indices, indptr)
    assert (ad, codec) == jnative.encode_csr_indices_adaptive(indices, indptr)
    for blob, name in ((vb, "delta_varint"), (ad, codec)):
        np.testing.assert_array_equal(native.decode_csr_indices_any(blob, indptr, name), indices)
        np.testing.assert_array_equal(jnative.decode_csr_indices_any(blob, indptr, name), indices)


def test_numpy_fallbacks_give_the_same_bytes(monkeypatch):
    """Without the C++ library (no g++) every codec's numpy fallback gives
    the library's bytes and values."""
    rng = np.random.default_rng(3)
    ids = np.unique(rng.integers(0, 1 << 31, size=3000)).astype(np.uint32)
    vals = rng.integers(0, 1 << 13, size=2000).astype(np.uint32)
    big = np.array([0, 1, 127, 128, 16383, 16384, (1 << 28) - 1, 1 << 28, 0xFFFFFFFF], np.uint32)
    buf = rng.integers(0, 256, size=1001, dtype=np.uint8)
    want = (native.encode_postings(ids), native.bitpack(vals), native.varint_encode(big), native.popcount(buf))
    monkeypatch.setattr(native, "_build_and_load", lambda: None)
    assert not native.available()
    got = (native.encode_postings(ids), native.bitpack(vals), native.varint_encode(big), native.popcount(buf))
    assert got == want
    np.testing.assert_array_equal(native.decode_postings(want[0], len(ids)), ids.astype(np.int64))
    np.testing.assert_array_equal(native.bitunpack(want[1][0], len(vals), want[1][1]), vals)
    np.testing.assert_array_equal(native.varint_decode(want[2], len(big)), big)
    assert native.gather_rows_mt(os.devnull, 0, 1, np.zeros(0, np.int64)) is None


@pytest.mark.parametrize("fallback", [False, True])
def test_truncated_varint_raises(monkeypatch, fallback):
    blob = native.varint_encode(np.array([300, 5], np.uint32))
    if fallback:
        monkeypatch.setattr(native, "_build_and_load", lambda: None)
    with pytest.raises(ValueError):
        native.varint_decode(blob[:-1], 2)
