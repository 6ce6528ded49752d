"""repro_torch.core.bitset against repro.core.bitset on identical inputs.

Host helpers must be byte-equal; the torch device helpers (int32 words)
must carry exactly the reference's uint32 bit patterns, bit 31 included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jb
from repro.serve import matching as jmatching
from repro_torch.core import bitset as tb


def _words(rng, shape):
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    w.reshape(-1, shape[-1])[:, 0] |= np.uint32(0x80000000)   # bit 31 set
    return w


def _t(words):
    return tb.to_tensor(words, "cpu")


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 257])
def test_np_helpers_byte_equal(n):
    rng = np.random.default_rng(n)
    bits = rng.random((5, n)) < 0.5
    bits[:, -1] = True
    packed = tb.np_pack(bits)
    ref = jb.np_pack(bits)
    assert packed.dtype == ref.dtype and packed.tobytes() == ref.tobytes()
    np.testing.assert_array_equal(tb.np_unpack(ref, n), jb.np_unpack(ref, n))
    idx = np.nonzero(bits[0])[0]
    np.testing.assert_array_equal(tb.np_from_indices(idx, n),
                                  jb.np_from_indices(idx, n))
    got, want = tb.np_to_indices(ref[0], n), jb.np_to_indices(ref[0], n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tb.np_popcount(ref), jb.np_popcount(ref))


def test_tensor_boundary_keeps_bits():
    w = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = tb.to_tensor(w, "cpu")
    assert t.dtype == torch.int32
    assert t.tolist() == [0, 1, 2 ** 31 - 1, -2 ** 31, -1]
    assert tb.to_numpy(t).tobytes() == w.tobytes()


@pytest.mark.parametrize("shape", [(1, 1), (4, 3), (7, 33)])
def test_device_helpers_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    a, m = _words(rng, shape), _words(rng, shape[-1:])
    ja, jm = jnp.asarray(a), jnp.asarray(m)
    ta, tm = _t(a), _t(m)
    n = shape[-1] * 32 - 5
    np.testing.assert_array_equal(tb.unpack(ta).numpy(), np.asarray(jb.unpack(ja)))
    np.testing.assert_array_equal(tb.unpack(ta, n).numpy(),
                                  np.asarray(jb.unpack(ja, n)))
    np.testing.assert_array_equal(tb.popcount(ta).numpy(),
                                  np.asarray(jb.popcount(ja)))
    np.testing.assert_array_equal(tb.count_and_not(ta, tm).numpy(),
                                  np.asarray(jb.count_and_not(ja, jm)))
    for axis in (0, 1):
        assert tb.to_numpy(tb.or_rows(ta, axis)).tobytes() == \
            np.asarray(jb.or_rows(ja, axis)).tobytes()
    sub = a & m[None, :]
    np.testing.assert_array_equal(
        tb.is_subset(_t(sub), tm[None, :]).numpy(),
        np.asarray(jb.is_subset(jnp.asarray(sub), jm[None, :])))
    np.testing.assert_array_equal(tb.is_subset(ta, tm[None, :]).numpy(),
                                  np.asarray(jb.is_subset(ja, jm[None, :])))


@pytest.mark.parametrize("n", [1, 32, 45, 96])
def test_pack_matches_jax(n):
    bits = np.random.default_rng(n).random((6, n)) < 0.5
    bits[:, n - 1] = True
    got = tb.to_numpy(tb.pack(torch.from_numpy(bits)))
    assert got.tobytes() == np.asarray(jb.pack(jnp.asarray(bits))).tobytes()


def test_or_rows_empty_stack_is_zero():
    assert tb.or_rows(torch.zeros((0, 3), dtype=torch.int32)).tolist() == [0, 0, 0]


def test_pack_tokens_matches_host_pack():
    queries = [(0,), (3, 31, 32, 63), (5, 5, 9), (), (99,), (1, 2, 3, 4, 98)]
    toks = jmatching.pad_token_batch(queries)
    got = tb.to_numpy(tb.pack_tokens(torch.from_numpy(toks), 100))
    want = jmatching.pack_query_bits([tuple(set(q)) for q in queries], 100)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("chunk_words", [1, 5, 1 << 20])
def test_rows_to_indices_matches_np(chunk_words):
    rng = np.random.default_rng(5)
    words = _words(rng, (9, 4))
    words[3] = 0
    words[5] = 0xFFFFFFFF                     # padding bits beyond n are dropped
    words[6, 1:] = 0
    n = 4 * 32 - 7
    got = tb.rows_to_indices(_t(words), n, chunk_words=chunk_words)
    assert len(got) == 9
    for g, r in zip(got, words):
        want = jb.np_to_indices(r, n)
        assert g.dtype == want.dtype
        np.testing.assert_array_equal(g, want)
    assert tb.rows_to_indices(_t(words[:0]), n) == []
