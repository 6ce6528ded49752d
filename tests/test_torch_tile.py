"""The tile attention kernel's arithmetic and tiling on the CPU.

`ref.flash_tile` is the plain version of `csrc/flash_attention.cu`: 64-row
blocks of flattened (position, group head) rows, 32-key tiles of online
softmax in base 2, Q·K^T and P·V as three TF32 products of split operands
(`ref.split_tf32`), the accurate softcap. It is held against the
reference's oracle `repro.kernels.ref.flash_attention` and its Pallas
kernel in interpret mode, on the same numpy-seeded inputs, at the
reference's tolerances (f32 2e-4, bf16 2e-2, `tests/test_flash_attention.py`),
and on gemma2-2b's head shape in f32 against `chip_smoke.py`'s row limit
(2e-4 x each row's rms), which one TF32 pass misses. `split_tf32` is held
to cvt.rna.tf32.f32's rounding on hand-made bit patterns, and
`flash_attention.tile_plan` to the kernel's shared-memory budget and
bank-conflict-free strides. The CUDA kernel itself runs only on the card
(`chip_smoke.py` phase 4, `tools/tile_probe.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, SMEM_PER_BLOCK, tile_plan

# the reference's tolerances (test_flash_dtypes)
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


def _bits(x: float | int) -> torch.Tensor:
    return torch.tensor([x], dtype=torch.int64).to(torch.int32).view(torch.float32)


# x's bits -> tf32(x)'s bits: to nearest, ties away from zero
TF32_CASES = [
    (0x3F800000, 0x3F800000),      # 1.0
    (0x3F801000, 0x3F802000),      # 1 + 2^-11: a tie, away from zero (even is down)
    (0x3F800FFF, 0x3F800000),      # just below the tie
    (0x3F803000, 0x3F804000),      # a tie whose lower neighbour is odd
    (0xBF801000, 0xBF802000),      # a negative tie, away from zero
    (0x7F7FE000, 0x7F7FE000),      # the largest TF32 value
    (0x7F7FEFFF, 0x7F7FE000),      # just below the tie past it
    (0x7F7FFFFF, 0x7F800000),      # the largest f32 value rounds past TF32's: Inf
    (0x00000FFF, 0x00000000),      # subnormals round in place
    (0x00001000, 0x00002000),
    (0x807FF000, 0x80800000),      # a subnormal that carries into the exponent
    (0x00000000, 0x00000000),      # +0
    (0x80000000, 0x80000000),      # -0
    (0x7F800000, 0x7F800000),      # Inf
    (0xFF800000, 0xFF800000),      # -Inf
]


@pytest.mark.parametrize("x,want", TF32_CASES, ids=lambda v: f"{v:08x}")
def test_split_tf32_rounds_as_cvt_rna(x, want):
    hi, lo = ref.split_tf32(_bits(x))
    assert int(hi.view(torch.int32)) & 0xFFFFFFFF == want
    if torch.isfinite(hi).all():
        assert int(lo.view(torch.int32)) & 0x1FFF == 0
        assert float(lo) == float(ref._tf32(_bits(x) - hi))


@pytest.mark.parametrize("x", [0x7FC00000, 0x7F800001, 0xFFC01234])
def test_split_tf32_keeps_nan(x):
    """A NaN stays NaN (one with a payload in the low 13 bits too, which a
    bare round-and-mask would turn into Inf)."""
    hi, lo = ref.split_tf32(_bits(x))
    assert torch.isnan(hi).all() and torch.isnan(lo).all()


def test_split_tf32_reconstructs_x():
    """hi and lo are TF32 values (low 13 bits zero) and hi + lo is within
    2^-22 relative of x, over normal f32 values of every magnitude; bf16
    values are exact in TF32 (lo = 0)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(200_000)
                          * 10.0 ** rng.uniform(-30, 30, 200_000)).astype(np.float32))
    hi, lo = ref.split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    xb = x.to(torch.bfloat16)
    hb, lb = ref.split_tf32(xb)
    assert torch.equal(hb, xb.float()) and not lb.any()


# D 8-256, G 1-4 (3 splits a position across a 64-row block), causal or
# not, windows, softcaps, q_offset, kv_len inside the cache, lengths that
# cut a 32-key tile
CASES = [
    # b, sq, skv, hq, hkv, d, causal, window, cap, q_offset, kv_len
    (1, 16, 16, 2, 1, 8, True, None, None, 0, None),
    (2, 32, 32, 4, 2, 16, True, None, None, 0, None),
    (1, 32, 32, 4, 4, 8, True, 8, None, 0, None),
    (1, 24, 24, 2, 1, 32, True, None, 20.0, 0, None),
    (1, 16, 16, 8, 2, 16, False, None, None, 0, None),
    (1, 20, 36, 2, 2, 8, True, None, None, 16, None),
    (1, 45, 70, 3, 1, 64, True, 40, 50.0, 25, 70),
    (2, 24, 50, 4, 1, 128, False, 30, None, 20, 41),
    (1, 40, 40, 4, 2, 256, True, None, 50.0, 0, None),
    (1, 17, 64, 4, 2, 256, True, 24, 30.0, 40, 57),
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window,cap,q_offset,kv_len", CASES)
def test_flash_tile_matches_reference_and_pallas(
        b, sq, skv, hq, hkv, d, causal, window, cap, q_offset, kv_len, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = _qkv(sq * skv + hq + d, b, sq, skv, hq, hkv, d)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    got = ref.flash_tile(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                         kv_len=kv_len, **kw)
    assert got.dtype == tdt and got.shape == (b, sq, hq, d)
    n = skv if kv_len is None else kv_len
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k[:, :n], v[:, :n]))
    want = jref.flash_attention(jq, jk, jv, **kw)
    pallas = pallas_flash(jq, jk, jv, block_q=8, block_k=8, interpret=True, **kw)
    for other in (want, pallas):
        np.testing.assert_allclose(_f32(got), _f32(other), rtol=tol, atol=tol)


# rows that see no key: the window starts past the last valid key
NO_KEY_CASES = [
    # b, sq, skv, hq, hkv, d, window, cap, q_offset, kv_len
    (1, 8, 40, 4, 2, 16, 16, None, 500, 40),          # every row
    (1, 40, 300, 4, 2, 64, 8, None, 250, 260),        # rows 17.. of 40
    (1, 64, 100, 8, 4, 256, 20, 50.0, 70, 90),        # rows 39.., two 64-row blocks
    (1, 30, 30, 4, 2, 8, None, None, 0, 0),           # kv_len 0
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window,cap,q_offset,kv_len", NO_KEY_CASES)
def test_rows_with_no_visible_key(b, sq, skv, hq, hkv, d, window, cap, q_offset,
                                  kv_len, dtype):
    """Such a row gives the uniform mean of v[:kv_len] (0 when kv_len is 0),
    as the reference's masked softmax does; the other rows are unchanged."""
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = _qkv(sq + kv_len, b, sq, skv, hq, hkv, d)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    kw = dict(causal=True, window=window, softcap=cap, q_offset=q_offset)
    pos = np.arange(sq) + q_offset
    none = pos - (window or 0) + 1 >= kv_len if window else np.full(sq, kv_len == 0)
    assert none.any()
    got = ref.flash_tile(tq, tk, tv, kv_len=kv_len, **kw)
    mean = tv[:, :kv_len].float().mean(1) if kv_len else torch.zeros((b, hkv, d))
    uniform = mean.repeat_interleave(hq // hkv, dim=1)            # [b, hq, d]
    for i in np.nonzero(none)[0]:
        np.testing.assert_allclose(_f32(got[:, i]), uniform.numpy(), rtol=tol, atol=tol)
    if kv_len:
        jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k[:, :kv_len], v[:, :kv_len]))
        np.testing.assert_allclose(_f32(got), _f32(jref.flash_attention(jq, jk, jv, **kw)),
                                   rtol=tol, atol=tol)
    else:
        assert not got.float().abs().any()


@pytest.mark.parametrize("d", [16, 256])
def test_keys_past_kv_len_are_never_read(d):
    """NaN keys and values at or past kv_len change nothing."""
    q, k, v = _qkv(3, 1, 40, 100, 4, 2, d)
    k[:, 70:] = np.nan
    v[:, 70:] = np.nan
    kw = dict(causal=True, window=16, softcap=50.0, q_offset=45, kv_len=70)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ref.flash_tile(tq, tk, tv, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.flash_tile(tq, tk[:, :70], tv[:, :70], **kw))


def _row_limit_ratio(window) -> float:
    """The largest error of the tile kernel's arithmetic over `chip_smoke.py`'s
    model-shape limit, at gemma2-2b's head shape (D 256, G 2, softcap 50) in
    f32 over 512 tokens: each element within 2e-4 x its row's rms of the
    plain version."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(11, 1, 512, 512, 4, 2, 256))
    kw = dict(causal=True, window=window, softcap=50.0, q_offset=0)
    got = ref.flash_tile(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    rms = want.pow(2).mean(dim=(2, 3), keepdim=True).sqrt()
    return float(((got - want).abs() / (2e-4 * rms)).max())


@pytest.mark.parametrize("window", [None, 128])
def test_split_tf32_within_the_row_limit(window):
    ratio = _row_limit_ratio(window)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("window", [None, 128])
def test_one_tf32_pass_breaks_the_row_limit(window, monkeypatch):
    """Each operand rounded once to TF32 (lo dropped) puts the f32 output
    past the model-shape rule: why the kernel splits every operand."""
    monkeypatch.setattr(ref, "split_tf32", lambda x: (ref._tf32(x.float()),
                                                      torch.zeros_like(x, dtype=torch.float32)))
    ratio = _row_limit_ratio(window)
    assert ratio > 1.0, ratio


def test_wrapper_on_the_cpu_takes_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 20, 20, 4, 2, 16))
    kw = dict(causal=True, window=8, softcap=30.0, q_offset=0, kv_len=20)
    assert torch.equal(ops.flash_attention(q, k, v, **kw), ref.flash_attention(q, k, v, **kw))


def _phase_banks(addrs: list[int], width: int) -> bool:
    """Do 32 lanes loading `width` consecutive words at `addrs` hit distinct
    banks within each phase (a phase is 128 bytes of the warp's request)?"""
    per = 32 // width
    for p0 in range(0, 32, per):
        banks = [(a + w) % 32 for a in addrs[p0:p0 + per] for w in range(width)]
        if len(set(banks)) != len(banks):
            return False
    return True


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tile_plan_fits_and_loads_without_bank_conflicts(d, dtype):
    """The plan fits a block's shared memory, pairs warps over D only at
    D = 256, and its strides put each fragment load's lanes (lane = 4g + t)
    on distinct banks: Q (f32) and K rows g at columns KC*t, V rows 2t and
    2t + 1 at columns VC*g; rows start on the cp.async copies' alignment."""
    plan = tile_plan(d, dtype)
    size = torch.empty((), dtype=dtype).element_size()
    assert (plan.rows, plan.keys) == (ref.TILE_ROWS, ref.TILE_KEYS)
    assert plan.warps == (8 if d == 256 else 4) and plan.smem <= SMEM_PER_BLOCK
    kc, vc = (4 if d >= 16 else 2), min(d, 32) // 8
    k_row, v_row = plan.k_words * 4 // size, plan.v_words * 4 // size   # in elements
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    assert _phase_banks([g * plan.q_words + kc * t for g, t in lanes], kc)
    assert _phase_banks([(g * k_row + kc * t) * size // 4 for g, t in lanes], kc * size // 4)
    if vc * size >= 4:
        for r in (0, 1):
            assert _phase_banks([((2 * t + r) * v_row + vc * g) * size // 4 for g, t in lanes],
                                vc * size // 4)
    copy = 4 * size                          # bytes of one cp.async: 4 elements
    assert plan.q_words % 4 == 0 and k_row * size % copy == 0 and v_row * size % copy == 0
