"""The port's flash_attention (plain version, CPU tensors) against the
reference's oracle `kernels.ref.flash_attention` and its Pallas kernel in
interpret mode, on the same numpy-seeded inputs; and the decode form (a
strided slice of a layer-stacked cache with a valid length) against a
contiguous copy and the reference's `chunked_attention`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import common as jcommon
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import SMEM_PER_BLOCK, tile_plan

# the reference's own cases (tests/test_flash_attention.py)
CASES = [
    # b, sq, skv, hq, hkv, d, causal, window, cap, q_offset
    (1, 16, 16, 2, 1, 8, True, None, None, 0),
    (2, 32, 32, 4, 2, 16, True, None, None, 0),
    (1, 32, 32, 4, 4, 8, True, 8, None, 0),          # sliding window
    (1, 24, 24, 2, 1, 8, True, None, 20.0, 0),       # softcap
    (1, 16, 16, 8, 2, 8, False, None, None, 0),      # bidirectional
    (1, 1, 48, 4, 2, 8, True, None, None, 47),       # decode step
    (1, 1, 48, 4, 2, 8, True, 16, 30.0, 40),         # decode + window + cap
    (1, 20, 36, 2, 2, 8, True, None, None, 16),      # ragged, non-tile sizes
]
# the reference's tolerances: f32 2e-4, bf16 2e-2 (test_flash_dtypes)
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window,cap,q_offset", CASES)
def test_flash_attention_matches_reference_and_pallas(
        b, sq, skv, hq, hkv, d, causal, window, cap, q_offset, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = _qkv(sq * skv + hq, b, sq, skv, hq, hkv, d)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    got = ops.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), **kw)
    assert got.dtype == tdt and got.shape == (b, sq, hq, d)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    want = jref.flash_attention(jq, jk, jv, **kw)
    pallas = pallas_flash(jq, jk, jv, block_q=8, block_k=8, interpret=True, **kw)
    for other in (want, pallas):
        np.testing.assert_allclose(_f32(got), _f32(other), rtol=tol, atol=tol)


@pytest.mark.parametrize("cur_len,window", [(0, None), (19, None), (19, 8),
                                            (31, 4)])
def test_decode_on_a_strided_cache_slice(cur_len, window):
    """One layer's slice of a [L, B, Smax, Hkv, D] cache with kv_len =
    cur_len + 1 gives what the contiguous valid prefix gives, and what the
    reference's chunked_attention gives with its kv_len mask."""
    rng = np.random.default_rng(cur_len)
    n_layers, b, smax, hq, hkv, d = 3, 2, 32, 4, 2, 16
    cache_k = rng.standard_normal((n_layers, b, smax, hkv, d)).astype(np.float32)
    cache_v = rng.standard_normal((n_layers, b, smax, hkv, d)).astype(np.float32)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=50.0, q_offset=cur_len)
    tk, tv = torch.from_numpy(cache_k)[1], torch.from_numpy(cache_v)[1]
    n = cur_len + 1
    got = ops.flash_attention(torch.from_numpy(q), tk, tv, kv_len=n, **kw)
    view_k, view_v = tk[:, :n], tv[:, :n]          # strided when n < smax
    assert view_k.is_contiguous() == (n == smax)
    for kk, vv in ((view_k, view_v), (view_k.contiguous(), view_v.contiguous())):
        assert torch.equal(got, ops.flash_attention(torch.from_numpy(q), kk, vv, **kw))
    want = jcommon.chunked_attention(
        jnp.asarray(q), jnp.asarray(cache_k[1]), jnp.asarray(cache_v[1]),
        causal=True, window=window, cap=50.0, q_offset=cur_len,
        kv_len=jnp.int32(cur_len + 1), chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_wrapper_refuses_operands_that_do_not_fit():
    q = torch.zeros((1, 4, 4, 8))
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q, torch.zeros((1, 4, 3, 8)), torch.zeros((1, 4, 3, 8)))
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2, 8)),
                            kv_len=5)


def test_row_tile_choice():
    """The tile kernel takes 64 (position, group head) rows per CTA and
    32-key tiles at every head dim and dtype, within a block's shared
    memory: one warp per 16 rows, two (one per half of D) at D = 256, where
    Q and two K/V stages in f32 take 201 KiB (chip_smoke.py drives it on
    the card)."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in (8, 16, 32, 64, 128, 256):
            plan = tile_plan(d, dtype)
            assert (plan.rows, plan.keys, plan.stages) == (64, 32, 2)
            assert plan.warps == (8 if d == 256 else 4)
            assert plan.smem <= SMEM_PER_BLOCK
    assert tile_plan(256, torch.float32).smem == 4 * (64 * 272 + 2 * 32 * (272 + 260)) + 16384
    assert tile_plan(128, torch.float32).smem * 2 <= 228 * 1024   # two CTAs an SM
