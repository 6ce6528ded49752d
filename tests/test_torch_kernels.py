"""The port's kernel ops on the CPU (their plain PyTorch versions) against
the reference's ops, through both the Pallas kernel body
(`backend="interpret"`) and the XLA path (`backend="xla"`).

Integer kernels must be equal; bit_matvec allclose at rtol 1e-5, atol 1e-4
(the reference's own kernel tolerance). The CUDA kernels themselves are
held against these plain versions on the card by `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jbitset
from repro.kernels import ops as jops
from repro.serve import matching as jmatching
from repro_torch.core import bitset
from repro_torch.kernels import _build, ops, ref

BACKENDS = ["interpret", "xla"]
SHAPES_CW = [(1, 1), (13, 3), (130, 5), (300, 17)]


def _words(rng, c, w):
    a = rng.integers(0, 2 ** 32, size=(c, w), dtype=np.uint32)
    a[:, 0] |= np.uint32(0x80000000)          # bit 31 in every row
    return a


def _t(words):
    return bitset.to_tensor(words, "cpu")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("c,w", SHAPES_CW)
def test_coverage_gain_matches_reference(backend, c, w):
    rng = np.random.default_rng(c * 7 + w)
    a, mask = _words(rng, c, w), _words(rng, 1, w)[0]
    want = jops.coverage_gain(jnp.asarray(a), jnp.asarray(mask), backend=backend)
    got = ops.coverage_gain(_t(a), _t(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("c,w", SHAPES_CW)
@pytest.mark.parametrize("r", [1, 3])
def test_bit_matvec_matches_reference(backend, c, w, r):
    rng = np.random.default_rng(c * 100 + w + r)
    a = _words(rng, c, w)
    x = rng.standard_normal((w * 32, r)).astype(np.float32)
    want = jops.bit_matvec(jnp.asarray(a), jnp.asarray(x), backend=backend)
    got = ops.bit_matvec(_t(a), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (c, r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_bit_matvec_sums_are_order_independent():
    """f64 accumulation rounded once: a permutation of the columns (another
    summation order) gives bit-identical sums."""
    rng = np.random.default_rng(9)
    bits = rng.random((40, 640)) < 0.3
    x = rng.random(640).astype(np.float32)
    perm = rng.permutation(640)
    one = ops.bit_matvec(_t(jbitset.np_pack(bits)), torch.from_numpy(x)[:, None])
    two = ops.bit_matvec(_t(jbitset.np_pack(bits[:, perm])),
                         torch.from_numpy(x[perm])[:, None])
    assert torch.equal(one, two)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,k,wv", [(1, 1, 1), (7, 3, 2), (65, 17, 3),
                                    (130, 70, 5), (16, 1, 9)])
def test_clause_match_matches_reference(backend, b, k, wv):
    rng = np.random.default_rng(b * 31 + k * 7 + wv)
    q = _words(rng, b, wv)
    c = jbitset.np_pack(rng.random((k, wv * 32)) < 0.05)
    c[: k // 2] &= q[: k // 2]                # some clauses are subsets
    want = jops.clause_match(jnp.asarray(q), jnp.asarray(c), backend=backend)
    got = ops.clause_match(_t(q), _t(c))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_clause_match_empty_inputs_and_impossible_clause():
    q = _t(_words(np.random.default_rng(0), 20, 2))
    assert not ops.clause_match(q, torch.zeros((0, 2), dtype=torch.int32)).any()
    assert ops.clause_match(torch.zeros((0, 2), dtype=torch.int32), q).shape == (0,)
    allbits = _t(jbitset.np_pack(np.ones((1, 64), bool)))
    assert not ops.clause_match(q[:, :2] & 0, allbits).any()


def _fused_case(seed, b=19, ell=4, v=37, w=5, wv=3, k=6):
    rng = np.random.default_rng(seed)
    t1 = rng.integers(0, 2 ** 32, size=(v, w), dtype=np.uint32)
    t2 = t1 | rng.integers(0, 2 ** 32, size=(v, w), dtype=np.uint32)
    toks = rng.integers(-1, v, size=(b, ell)).astype(np.int32)
    toks[0] = -1                              # a query with no valid token
    q = _words(rng, b, wv)
    cl = jbitset.np_pack(rng.random((k, wv * 32)) < 0.1)
    cl[: k // 2] &= q[: k // 2]
    return q, cl, toks, t1, t2


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("empty", [False, True])
def test_fused_match_matches_reference(backend, empty):
    q, cl, toks, t1, t2 = _fused_case(int(empty))
    if empty:
        cl = cl[:0]
    jm, je = jops.fused_match(*(jnp.asarray(z) for z in (q, cl, toks, t1, t2)),
                              backend=backend)
    tm, te = ops.fused_match(_t(q), _t(cl), torch.from_numpy(toks), _t(t1), _t(t2))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert bitset.to_numpy(tm).tobytes() == np.asarray(jm).tobytes()
    assert empty or (te.any() and not te.all())


def test_match_batch_matches_reference():
    _, _, toks, t1, _ = _fused_case(3, b=33, ell=6)
    want = np.asarray(jmatching.match_batch(jnp.asarray(t1), jnp.asarray(toks)))
    got = ops.match_batch(_t(t1), torch.from_numpy(toks))
    assert bitset.to_numpy(got).tobytes() == want.tobytes()
    assert (bitset.to_numpy(got)[0] == 0xFFFFFFFF).all()    # no token: all-ones


def test_plain_versions_chunk_like_whole():
    """The chunked plain versions give the unchunked answer."""
    rng = np.random.default_rng(4)
    a, mask = _t(_words(rng, 50, 9)), _t(_words(rng, 1, 9)[0])
    x = torch.rand((9 * 32, 2), dtype=torch.float32)
    toks = torch.from_numpy(rng.integers(-1, 50, size=(30, 3)).astype(np.int32))
    sel = torch.from_numpy(rng.random(30) < 0.5)
    q, cl = _t(_words(rng, 30, 9)), a[:7] & a[7:14]
    whole = (ref.coverage_gain(a, mask), ref.bit_matvec(a, x),
             ref.clause_match(q, cl), ref.tier_match(a, a & mask, sel, toks))
    old = ref.CHUNK_BYTES
    ref.CHUNK_BYTES = 64
    try:
        small = (ref.coverage_gain(a, mask), ref.bit_matvec(a, x, chunk_w=2),
                 ref.clause_match(q, cl), ref.tier_match(a, a & mask, sel, toks))
    finally:
        ref.CHUNK_BYTES = old
    for u, v in zip(whole, small):
        assert torch.equal(u, v)


def test_block_dim_helper():
    assert ops.block_dim(300, 128) == (128, 84, 3)
    assert ops.block_dim(5, 128) == (5, 0, 1)
    assert ops.block_dim(128, 128) == (128, 0, 1)


def test_cpu_path_launches_nothing_and_other_devices_raise():
    """CPU tensors take the plain version (no launch counted); a tensor on
    any other non-CUDA device is refused rather than computed some other
    way."""
    _build.reset_launches()
    a = torch.zeros((4, 2), dtype=torch.int32)
    ops.coverage_gain(a, a[0])
    ops.bit_matvec(a, torch.zeros((64, 1)))
    ops.clause_match(a, a)
    ops.match_batch(a, torch.zeros((3, 2), dtype=torch.int32))
    assert all(v == 0 for v in _build.LAUNCHES.values())
    meta = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.coverage_gain(meta, meta[0])
    with pytest.raises(ValueError, match="CUDA"):
        ops.clause_match(meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        ops.match_batch(meta, torch.empty((3, 2), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.bit_matvec(meta, torch.empty((64, 1), device="meta"))
