"""The bf16 prefill kernel's arithmetic and routing on the CPU.

`ref.flash_prefill` is the plain version of `csrc/flash_prefill.cu`: 64-key
tiles of online softmax in base 2, the scale after the product, the
accurate softcap, P·V as hi + lo bf16 terms. It is held against the
reference's oracle `repro.kernels.ref.flash_attention` and its Pallas
kernel in interpret mode, on the same numpy-seeded bf16 inputs, at the
reference's bf16 tolerance (2e-2, `tests/test_flash_attention.py`). Rows
that see no key must give the masked softmax's uniform mean, through the
plain version and through `ops.flash_attention` on the CPU. The routing
rule (`flash_attention.route`) is checked on meta and CPU tensors; the CUDA
kernels themselves run only on the card (`chip_smoke.py` phase 4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import route
from repro_torch.kernels.flash_prefill import flash_prefill, kernel_window, takes

BF16_TOL = 2e-2        # the reference's bf16 tolerance (test_flash_dtypes)

# D 64, 128 and 256 (the kernel's), G 1, 2 and 4, windows and softcaps,
# causal or not, a q_offset, lengths that cut a 64-key tile; then the MoE
# models' head groups at D 128: G 5 (llama4, Hq 40 / Hkv 8) and G 8
# (kimi-k2, Hq 64 / Hkv 8), with Sq not a multiple of 64 / G, so one
# position's heads straddle the kernel's 64-row halves and 128-row tiles
CASES = [
    # b, sq, skv, hq, hkv, d, causal, window, cap, q_offset
    (1, 16, 16, 2, 1, 64, True, None, None, 0),
    (2, 32, 32, 4, 2, 64, True, None, None, 0),
    (1, 32, 32, 4, 4, 64, True, 8, None, 0),
    (1, 24, 24, 2, 1, 64, True, None, 20.0, 0),
    (1, 16, 16, 8, 2, 64, False, None, None, 0),
    (1, 20, 36, 2, 2, 64, True, None, None, 16),
    (1, 80, 80, 4, 2, 128, True, 40, 50.0, 0),
    (1, 70, 130, 4, 1, 128, True, None, 30.0, 60),
    (1, 48, 48, 8, 2, 256, True, 16, 50.0, 0),
    (2, 40, 100, 4, 2, 256, False, 30, None, 20),
    (1, 45, 45, 40, 8, 128, True, None, None, 0),
    (1, 29, 93, 10, 2, 128, True, None, None, 64),
    (1, 37, 37, 64, 8, 128, True, None, None, 0),
    (2, 19, 50, 16, 2, 128, True, None, None, 31),
]


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


def _bf16(*xs):
    return [torch.from_numpy(x).to(torch.bfloat16) for x in xs]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window,cap,q_offset", CASES)
def test_plain_prefill_matches_reference_and_pallas(
        b, sq, skv, hq, hkv, d, causal, window, cap, q_offset):
    q, k, v = _qkv(sq * skv + hq + d, b, sq, skv, hq, hkv, d)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    got = ref.flash_prefill(*_bf16(q, k, v), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, hq, d)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jref.flash_attention(jq, jk, jv, **kw)
    pallas = pallas_flash(jq, jk, jv, block_q=8, block_k=8, interpret=True, **kw)
    for other in (want, pallas):
        np.testing.assert_allclose(_f32(got), _f32(other), rtol=BF16_TOL, atol=BF16_TOL)


# rows that see no key: the window starts past the last valid key
NO_KEY_CASES = [
    # b, sq, skv, hq, hkv, d, window, cap, q_offset, kv_len
    (1, 8, 40, 4, 2, 64, 16, None, 500, 40),          # every row
    (1, 40, 300, 4, 2, 64, 8, None, 250, 260),        # rows 17.. of 40
    (1, 64, 100, 8, 4, 256, 20, 50.0, 70, 90),        # rows 39.. in one tile
    (1, 30, 30, 4, 2, 128, None, None, 0, 0),         # kv_len 0
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window,cap,q_offset,kv_len", NO_KEY_CASES)
def test_rows_with_no_visible_key(b, sq, skv, hq, hkv, d, window, cap, q_offset, kv_len):
    """Such a row gives the uniform mean of v[:kv_len] (0 when kv_len is 0),
    as the reference's masked softmax does; the other rows are unchanged."""
    q, k, v = _qkv(sq + kv_len, b, sq, skv, hq, hkv, d)
    tq, tk, tv = _bf16(q, k, v)
    kw = dict(causal=True, window=window, softcap=cap, q_offset=q_offset)
    pos = np.arange(sq) + q_offset
    none = pos - (window or 0) + 1 >= kv_len if window else np.full(sq, kv_len == 0)
    assert none.any()
    mean = tv[:, :kv_len].float().mean(1) if kv_len else torch.zeros((b, hkv, d))
    uniform = mean.repeat_interleave(hq // hkv, dim=1)            # [b, hq, d]
    plain = ref.flash_prefill(tq, tk, tv, kv_len=kv_len, **kw)
    via_ops = ops.flash_attention(tq, tk, tv, kv_len=kv_len, **kw)
    for got in (plain, via_ops):
        for i in np.nonzero(none)[0]:
            np.testing.assert_allclose(_f32(got[:, i]), uniform.numpy(), rtol=BF16_TOL,
                                       atol=BF16_TOL)
    if kv_len:
        jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k[:, :kv_len],
                                                                     v[:, :kv_len]))
        want = jref.flash_attention(jq, jk, jv, **kw)
        for got in (plain, via_ops):
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=BF16_TOL, atol=BF16_TOL)
    else:
        assert not plain.float().abs().any() and not via_ops.float().abs().any()


def test_keys_past_kv_len_are_never_read():
    """NaN keys and values at or past kv_len change nothing."""
    q, k, v = _qkv(3, 1, 40, 100, 4, 2, 64)
    k[:, 70:] = np.nan
    v[:, 70:] = np.nan
    kw = dict(causal=True, window=16, softcap=50.0, q_offset=45, kv_len=70)
    got = ref.flash_prefill(*_bf16(q, k, v), **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got, ref.flash_prefill(*_bf16(q, k[:, :70], v[:, :70]),
                                                      **kw))


def test_prefill_keys_cover_every_visible_key():
    """A block's key range holds every key its rows see, starts on a tile
    edge, and is all of [0, kv_len) once its last row sees none."""
    for kv_len in (0, 1, 63, 64, 200):
        for window in (None, 1, 8, 100):
            for causal in (True, False):
                for p_lo in (0, 5, 64, 190, 300):
                    for n in (1, 7, 64):
                        p_hi = p_lo + n - 1
                        begin, end = ref.prefill_keys(p_lo, p_hi, kv_len, causal, window)
                        assert begin % ref.PREFILL_KEYS == 0
                        lo, hi = ref.decode_keys(kv_len, p_hi, causal, window)
                        if lo >= hi:
                            assert (begin, end) == (0, kv_len)
                        for p in range(p_lo, p_hi + 1):
                            lo, hi = ref.decode_keys(kv_len, p, causal, window)
                            assert lo >= hi or (begin <= lo and hi <= end)


def test_split_reconstructs_p():
    """p = hi + lo to 2^-16 relative, over (0, 1] and down to 1e-30."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy(np.concatenate([
        rng.random(100_000), 10.0 ** rng.uniform(-30, 0, 100_000), [1.0]]).astype(np.float32))
    hi, lo = ref.split_bf16(p)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.double() + lo.double() - p.double()).abs()
    assert bool((err <= 2.0 ** -16 * p.double()).all())


@pytest.mark.parametrize("cap", [20.0, 30.0, 50.0])
def test_accurate_softcap(cap):
    """cap * tanh(x / cap) by the kernel's formula stays within 1e-6 of
    torch.tanh (before the cap's scaling) over x in [-20, 20] x cap."""
    y = torch.linspace(-20.0, 20.0, 400_001, dtype=torch.float32)
    x = y * cap
    got = ref.tanh_accurate(x * torch.tensor(1.0 / cap, dtype=torch.float32))
    assert float((got.double() - torch.tanh(y.double())).abs().max()) <= 1e-6
    assert torch.equal(ref.tanh_accurate(-y), -ref.tanh_accurate(y))


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_route_by_dtype_head_dim_and_sq():
    for d in (64, 128, 256):
        q, k = _meta((1, 8, 4, d)), _meta((1, 8, 2, d))
        assert takes(q, k, k) and route(q, k, k) == "flash_prefill"
        assert route(q.float(), k.float(), k.float()) == "flash_attention"
        assert route(q[:, :1], k, k) == "flash_decode"
    for d in (8, 16, 32):
        q, k = _meta((1, 8, 4, d)), _meta((1, 8, 2, d))
        assert route(q, k, k) == "flash_attention_short"     # up to 256 keys
        long = _meta((1, 257, 2, d))
        assert route(_meta((1, 257, 4, d)), long, long) == "flash_attention"
    q, k = _meta((1, 8, 4, 64)), _meta((1, 8, 2, 64))
    assert route(q, k.float(), k) == "flash_attention"


def test_route_by_alignment():
    """TMA's rule: every base pointer and stride 16-byte aligned."""
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    assert route(q, k, k) == "flash_prefill"
    padded = torch.zeros((1, 8, 2, 68), dtype=torch.bfloat16)[..., :64]   # 136-byte rows
    assert route(q, padded, k) == "flash_attention"
    flat = torch.zeros(1 * 8 * 2 * 64 + 4, dtype=torch.bfloat16)
    shifted = flat[4:].view(1, 8, 2, 64)                                   # base + 8 bytes
    assert shifted.data_ptr() % 16 == 8 and route(q, k, shifted) == "flash_attention"
    wide = torch.zeros((1, 8, 2, 72), dtype=torch.bfloat16)[..., :64]    # 144-byte rows
    assert route(q, wide, wide) == "flash_prefill"


def test_wrappers_on_the_cpu_take_their_plain_versions():
    q, k, v = _bf16(*_qkv(5, 1, 20, 20, 4, 2, 64))
    kw = dict(causal=True, window=8, softcap=30.0, q_offset=0, kv_len=20)
    assert torch.equal(flash_prefill(q, k, v, **kw), ref.flash_prefill(q, k, v, **kw))
    assert torch.equal(ops.flash_attention(q, k, v, **kw), ref.flash_attention(q, k, v, **kw))


def test_kernel_window_fits_int32():
    """A window that reaches past key 0 from the last query is no window:
    the kernel gets -1, so a huge window cannot wrap around in int32."""
    assert kernel_window(None, 0, 8) == -1
    assert kernel_window(2 ** 40, 0, 8) == -1
    assert kernel_window(2 ** 31, 2 ** 30, 2 ** 30 - 1) == -1
    assert kernel_window(108, 100, 8) == -1
    assert kernel_window(107, 100, 8) == 107
    assert kernel_window(1, 0, 8) == 1
    q, k, v = _bf16(*_qkv(7, 1, 8, 108, 4, 2, 64))
    kw = dict(causal=True, softcap=30.0, q_offset=100)
    assert torch.equal(ref.flash_prefill(q, k, v, window=108, **kw),
                       ref.flash_prefill(q, k, v, window=None, **kw))
    assert not torch.equal(ref.flash_prefill(q, k, v, window=107, **kw),
                           ref.flash_prefill(q, k, v, window=None, **kw))


def _row_limit_ratio(window) -> float:
    """The largest error of the bf16 prefill arithmetic over
    `chip_smoke.py`'s model-shape limit, at gemma2-2b's head shape (D 256,
    G 2, softcap 50) over 512 tokens: each element within 2e-4 x its row's
    rms plus the output's rounding 2^-8 |want| of the reference on f32
    copies."""
    q, k, v = _qkv(11, 1, 512, 512, 4, 2, 256)
    tq, tk, tv = _bf16(q, k, v)
    kw = dict(causal=True, window=window, softcap=50.0, q_offset=0)
    got = ref.flash_prefill(tq, tk, tv, **kw).float()
    want = ref.flash_attention(tq.float(), tk.float(), tv.float(), **kw)
    rms = want.pow(2).mean(dim=(2, 3), keepdim=True).sqrt()
    lim = 2e-4 * rms + 2.0 ** -8 * want.abs()
    return float(((got - want).abs() / lim).max())


@pytest.mark.parametrize("window", [None, 128])
def test_plain_prefill_within_the_row_limit(window):
    """The kernel's arithmetic keeps the model-shape rule."""
    ratio = _row_limit_ratio(window)
    assert ratio <= 1.0, ratio


def _round_mantissa(x: torch.Tensor, bits: int, truncate: bool = False) -> torch.Tensor:
    """x (f32) kept to `bits` explicit mantissa bits, rounded to nearest or
    truncated toward zero."""
    i = x.contiguous().view(torch.int32)
    drop = 23 - bits
    if not truncate:
        i = i + (1 << (drop - 1))
    return (i & ~((1 << drop) - 1)).view(torch.float32)


# one step of the arithmetic made coarser, as a faster kernel might do it
COARSER = {
    # P rounded once to bf16, no lo term (FA2 / FA3's P·V)
    "bf16 P": ("split_bf16", lambda p: (p.to(torch.bfloat16),
                                        torch.zeros_like(p, dtype=torch.bfloat16))),
    # P kept to TF32's 10-bit mantissa, no lo term
    "tf32 P": ("split_bf16", lambda p: (_round_mantissa(p, 10),
                                        torch.zeros_like(p, dtype=torch.bfloat16))),
    # the softcap's tanh to 11 bits, the relative error of tanh.approx.f32
    "tanh.approx": ("tanh_accurate",
                    lambda y: _round_mantissa(torch.tanh(y), 11, truncate=True)),
}


@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("variant", sorted(COARSER))
def test_coarser_arithmetic_breaks_the_row_limit(variant, window, monkeypatch):
    """Dropping p_lo (one bf16 P, or TF32 P) or an 11-bit tanh puts the
    output past the model-shape rule: why the kernel splits P and computes
    tanh from ex2."""
    monkeypatch.setattr(ref, *COARSER[variant])
    ratio = _row_limit_ratio(window)
    assert ratio > 1.0, ratio
