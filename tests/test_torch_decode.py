"""The split-KV decode path of the port's flash_attention on the CPU: the
split plan, the visible-key interval, and `ref.flash_decode` (the split
arithmetic of `csrc/flash_decode.cu`) against the reference's
`ref.flash_attention` and its Pallas kernel in interpret mode, on the same
numpy-seeded inputs. The CUDA kernel itself is held against
`ref.flash_attention` on the card by `chip_smoke.py` phase 4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_decode import (MIN_KEYS, Split, plan, row_chunk,
                                              split_plan, vec16)

SLOTS = 264          # an H100's 132 SMs x 2 CTAs of the gemma2 instantiation
# the reference's tolerances: f32 2e-4, bf16 2e-2 (test_flash_dtypes)
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _check_cut(n_keys, n, per):
    """n runs of `per` keys cover [0, n_keys) exactly, none empty."""
    assert n >= 1 and per >= 1
    assert (n - 1) * per < n_keys <= n * per


@pytest.mark.parametrize("slots", [132, SLOTS])
@pytest.mark.parametrize("ctas", [1, 2, 3, 8, 32, 33, 64, 132, 256, 511, 512])
def test_plan_covers_every_key_count(ctas, slots):
    """Every key in one split, none empty, at least MIN_KEYS keys a split
    where there are that many, and one wave of the card's CTA slots."""
    for n_keys in range(1, 40001):
        n, per = plan(n_keys, ctas, slots)
        _check_cut(n_keys, n, per)
        assert per >= min(n_keys, MIN_KEYS)
        assert n == 1 or n * ctas <= slots


@pytest.mark.parametrize("n_keys", [1, 255, 256, 257, 4096, 32768, 40000])
def test_plan_covers_every_cta_count(n_keys):
    for ctas in range(1, 513):
        got = plan(n_keys, ctas, SLOTS)
        assert got == plan(n_keys, ctas, SLOTS)          # a pure function
        _check_cut(n_keys, *got)


def test_plan_at_gemma2_decode():
    """B = 8 x 4 KV heads with G = 2 in one row chunk: 8 splits fill the
    264 slots once (256 CTAs), against the 32768-position cache and the
    4096-key window alike."""
    assert row_chunk(2) == 2
    assert plan(32768, 32, SLOTS) == (8, 4096)
    assert plan(4096, 32, SLOTS) == (8, 512)
    assert plan(1000, 32, SLOTS) == (3, 334)
    assert plan(100, 32, SLOTS) == (1, 100)
    assert plan(0, 32, SLOTS) == (1, 0)
    # the decode step's two calls: global at cur_len 32767, local window 4096
    assert split_plan(8, 8, 4, 32768, 32767, True, None, SLOTS) == \
        Split(0, 32768, 4096, 8, 2, False)
    assert split_plan(8, 8, 4, 32768, 32767, True, 4096, SLOTS) == \
        Split(28672, 4096, 512, 8, 2, False)


def test_split_plan_edges():
    """G = 16 in four row chunks; no visible key takes [0, kv_len)."""
    assert split_plan(1, 16, 1, 3000, 2999, True, None, 132) == \
        Split(0, 3000, 273, 11, 4, False)
    assert split_plan(2, 4, 2, 50, 120, True, 16, SLOTS) == \
        Split(0, 50, 50, 1, 2, True)
    assert split_plan(1, 2, 1, 0, 0, True, None, SLOTS) == Split(0, 0, 0, 1, 2, True)


@pytest.mark.parametrize("n_keys,n_splits", [(1, 1), (1, 5), (10, 3), (10, 10),
                                             (10, 11), (40000, 17), (7, 7)])
def test_split_keys(n_keys, n_splits):
    n, per = ref.split_keys(n_keys, n_splits)
    _check_cut(n_keys, n, per)
    assert n <= n_splits


def test_row_chunks():
    assert [row_chunk(g) for g in (1, 2, 3, 4, 5, 8, 16)] == [1, 2, 4, 4, 4, 4, 4]


def test_decode_keys_is_the_mask():
    """[lo, hi) holds exactly the keys the causal / window mask keeps."""
    for kv_len in range(0, 12):
        for q_offset in range(-2, 16):
            for causal in (True, False):
                for window in (None, 1, 3, 8):
                    lo, hi = ref.decode_keys(kv_len, q_offset, causal, window)
                    keep = [kp for kp in range(kv_len)
                            if (not causal or q_offset >= kp)
                            and (window is None or q_offset - kp < window)]
                    assert keep == list(range(lo, hi))


def test_vec16_sees_8_byte_rows():
    x = torch.zeros((2, 8, 4, 72), dtype=torch.bfloat16)
    assert vec16(x[..., :64])
    y = torch.zeros((2, 8, 4, 68), dtype=torch.bfloat16)
    assert not vec16(y[..., :64])             # a 136-byte row stride
    assert vec16(torch.zeros((2, 8, 4, 68))[..., :64])


# b, hq, hkv, d, smax, kv_len, q_offset, window, cap, n_splits
CASES = [
    (1, 2, 1, 8, 24, 24, 23, None, None, 1),          # one split, G = 2
    (2, 4, 2, 8, 24, 24, 23, None, 30.0, 2),
    (1, 4, 1, 8, 40, 33, 32, None, None, 3),          # G = 4
    (2, 8, 1, 8, 48, 41, 40, 13, 50.0, 3),            # G = 8, window inside a split
    (1, 2, 2, 8, 32, 29, 28, None, 50.0, 7),          # G = 1, 7 splits
    (1, 4, 2, 8, 16, 6, 5, None, None, 50),           # more splits than keys
    (2, 4, 2, 8, 16, 1, 0, None, 20.0, 2),            # cur_len 0
    (1, 2, 1, 256, 40, 37, 36, 16, 50.0, 3),          # D = 256
    (2, 8, 4, 256, 32, 20, 19, None, None, 7),        # D = 256, G = 2
]


def _cache(seed, b, hq, hkv, d, smax):
    """q and one layer's slice of a [3, B, Smax, Hkv, D] cache (strided
    when kv_len < Smax)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    ck = rng.standard_normal((3, b, smax, hkv, d)).astype(np.float32)
    cv = rng.standard_normal((3, b, smax, hkv, d)).astype(np.float32)
    return q, ck, cv


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,d,smax,kv_len,q_offset,window,cap,n_splits", CASES)
def test_split_decode_matches_reference_and_pallas(
        b, hq, hkv, d, smax, kv_len, q_offset, window, cap, n_splits, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    q, ck, cv = _cache(kv_len * 31 + hq * d + n_splits, b, hq, hkv, d, smax)
    tq = torch.from_numpy(q).to(tdt)
    tk, tv = (torch.from_numpy(c).to(tdt)[1] for c in (ck, cv))
    kw = dict(causal=True, window=window, softcap=cap, q_offset=q_offset)
    got = ref.flash_decode(tq, tk, tv, kv_len=kv_len, n_splits=n_splits, **kw)
    assert got.dtype == tdt and got.shape == (b, 1, hq, d)
    jq = jnp.asarray(q).astype(jdt)
    jk, jv = (jnp.asarray(c[1, :, :kv_len]).astype(jdt) for c in (ck, cv))
    want = jref.flash_attention(jq, jk, jv, **kw)
    pallas = pallas_flash(jq, jk, jv, block_q=8, block_k=8, interpret=True, **kw)
    for other in (want, pallas):
        np.testing.assert_allclose(_f32(got), _f32(other), rtol=tol, atol=tol)


@pytest.mark.parametrize("kv_len,q_offset,window,causal", [
    (20, 30, 4, True),        # the window starts past the last key
    (12, 40, 8, False),
    (9, -1, None, True),      # a query before every key
])
def test_no_visible_key_gives_the_masked_softmax(kv_len, q_offset, window, causal):
    """Every key masked: the uniform mean of the first kv_len values, as the
    plain flash_attention's softmax over -1e30 gives."""
    q, ck, cv = _cache(kv_len, 2, 4, 2, 16, 24)
    tq = torch.from_numpy(q)
    tk, tv = torch.from_numpy(ck)[1], torch.from_numpy(cv)[1]
    kw = dict(causal=causal, window=window, softcap=50.0, q_offset=q_offset,
              kv_len=kv_len)
    assert ref.decode_keys(kv_len, q_offset, causal, window)[0] >= \
        ref.decode_keys(kv_len, q_offset, causal, window)[1]
    want = ref.flash_attention(tq, tk, tv, **kw)
    mean = tv[:, :kv_len].mean(1).repeat_interleave(2, dim=1)[:, None]
    np.testing.assert_allclose(want.numpy(), mean.numpy(), rtol=2e-4, atol=2e-4)
    for n_splits in (1, 2, 5):
        got = ref.flash_decode(tq, tk, tv, n_splits=n_splits, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_no_key_at_all_gives_zeros():
    q, ck, cv = _cache(0, 1, 2, 1, 8, 8)
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(ck)[1], torch.from_numpy(cv)[1]
    want = ref.flash_attention(tq, tk, tv, q_offset=0, kv_len=0)
    got = ref.flash_decode(tq, tk, tv, q_offset=0, kv_len=0, n_splits=3)
    assert torch.equal(got, want) and not got.any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window,cap", [(None, None), (5, 50.0)])
def test_ops_decode_on_cpu_is_the_plain_version(window, cap, dtype):
    """CPU tensors at Sq = 1 still take ref.flash_attention, bit for bit."""
    tdt = DTYPES[dtype][0]
    q, ck, cv = _cache(3, 2, 8, 4, 32, 20)
    tq = torch.from_numpy(q).to(tdt)
    tk, tv = (torch.from_numpy(c).to(tdt)[2] for c in (ck, cv))
    kw = dict(causal=True, window=window, softcap=cap, q_offset=14, kv_len=15)
    assert torch.equal(ops.flash_attention(tq, tk, tv, **kw),
                       ref.flash_attention(tq, tk, tv, **kw))
