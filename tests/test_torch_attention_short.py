"""The short-sequence attention backward (`csrc/flash_backward_short.cu`):
its routing rule and tiling on meta tensors, and its arithmetic.

`flash_backward.route` sends every gradient without the tensor-core pair's
lse, Skv up to SHORT_MAX_S and D up to 32 (below 8 too) to the kernel, and
the rest where it went before; every plan fits a block's shared memory and
puts the kernel's fragment loads on distinct banks. The kernel's plain
version `ref.flash_backward_short` (per-unit full-row softmax, each product
three TF32 products of split operands) agrees with `jax.vjp` of the
reference's `chunked_attention` at BWD_RTOL (rtol, and atol times the
output's max); one TF32 pass would not. On the CPU the gradient stays
`ref.flash_attention_bwd`. The kernel runs only on the card
(`chip_smoke.py` phases 6a and 7a hold it to both plain versions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro_torch.kernels import _build, flash_backward, ops, ref

BWD_RTOL = 1e-4     # chip_smoke's limit for the f32 backward kernels
SMEM_PER_BLOCK = 232448
# b, s, hq, hkv, d, causal, window, cap: BST's head (S 21, H 8, D 4),
# BERT4Rec's (S 200, H 2, D 32), G 2, a window, a softcap, causal and not
CASES = [
    (3, 21, 8, 8, 4, False, None, None),
    (1, 200, 2, 2, 32, False, None, None),
    (2, 33, 4, 2, 16, False, None, None),
    (2, 21, 4, 2, 4, True, None, None),
    (1, 64, 2, 1, 8, False, 17, None),
    (2, 40, 2, 2, 32, True, 9, 30.0),
    (1, 50, 6, 2, 12, False, None, 50.0),
    (1, 256, 2, 1, 32, True, None, None),
]


def _ids(c):
    return "b{}s{}hq{}hkv{}d{}c{}w{}cap{}".format(*c)


def _draw(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv, hq)]


def _jax_vjp(q, k, v, g, causal, window, cap):
    def f(q, k, v):
        return jcommon.chunked_attention(q, k, v, causal=causal, window=window, cap=cap,
                                         chunk=64)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _ratio(got, want, tol=BWD_RTOL) -> float:
    """The worst |got - want| over tol * |want| + tol * max|want|, over
    (dq, dk, dv), as chip_smoke's `bwd_agree` takes it."""
    worst = 0.0
    for g, w in zip(got, want):
        w = torch.as_tensor(np.array(w))
        assert g.shape == w.shape and g.dtype == torch.float32
        lim = tol * w.abs() + tol * float(w.abs().max()) + 1e-30
        worst = max(worst, float(((g - w).abs() / lim).max()))
    return worst


def _meta(b, s, h, d, dtype=torch.float32):
    return torch.empty((b, s, h, d), dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [1, 4, 8, 12, 16, 32])
@pytest.mark.parametrize("s", [1, 2, 21, 200, flash_backward.SHORT_MAX_S])
def test_short_sequences_route_to_the_short_kernel(s, d, dtype):
    """f32 or bf16 without an lse, Skv up to SHORT_MAX_S, D up to 32, any
    G: the short kernel (the mask does not enter the rule)."""
    for hq, hkv in ((8, 8), (4, 2), (8, 1)):
        q, k = _meta(3, s, hq, d, dtype), _meta(3, s, hkv, d, dtype)
        assert flash_backward.route(q, k, k, None) == "flash_backward_short"


def test_long_sequences_wide_heads_and_the_lse_keep_their_routes():
    """Skv past SHORT_MAX_S (D 4 and 32) and D 64 and above go to the
    CUDA-core kernel; bf16 at D 64 with the forward's lse to the tensor-core
    pair; other dtypes are not the short kernel's."""
    past = flash_backward.SHORT_MAX_S + 1
    for s, d in ((past, 4), (past, 32), (300, 32), (21, 64), (200, 128), (64, 256)):
        q = _meta(2, s, 4, d)
        assert flash_backward.route(q, _meta(2, s, 2, d), _meta(2, s, 2, d), None) \
            == "flash_backward", (s, d)
    qb, kb = _meta(2, 64, 8, 64, torch.bfloat16), _meta(2, 64, 2, 64, torch.bfloat16)
    lse = torch.empty((2, 8, 64), device="meta")
    assert flash_backward.route(qb, kb, kb, lse) == "flash_backward_tc"
    assert flash_backward.route(qb, kb, kb, None) == "flash_backward"
    # an lse at D 32 is no tensor-core call: the short kernel takes it
    q32, k32 = _meta(2, 64, 8, 32, torch.bfloat16), _meta(2, 64, 2, 32, torch.bfloat16)
    assert flash_backward.route(q32, k32, k32, lse) == "flash_backward_short"
    assert flash_backward.short_plan(21, 4, 1, torch.float16) is None
    assert flash_backward.short_plan(past, 4, 1, torch.float32) is None
    assert flash_backward.short_plan(21, 33, 1, torch.float32) is None


def _phase_banks(addrs: list[int], width: int) -> bool:
    """Do 32 lanes loading `width` consecutive words at `addrs` hit distinct
    banks within each phase (a phase is 128 bytes of the warp's request)?"""
    per = 32 // width
    for p0 in range(0, 32, per):
        banks = [(a + w) % 32 for a in addrs[p0:p0 + per] for w in range(width)]
        if len(set(banks)) != len(banks):
            return False
    return True


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("d", [4, 8, 16, 32])
@pytest.mark.parametrize("s", [2, 21, 32, 33, 64, 65, 200, flash_backward.SHORT_MAX_S])
def test_short_plan_fits_and_loads_without_bank_conflicts(s, d, g):
    """Every plan the route takes fits a block's shared memory, as the
    kernel's own size formulas count it. The CUDA-core route (D <= 8, Skv
    <= 32, a unit's rows in one CTA) takes one thread a row and P, dS rows
    of an odd stride. The tensor-core route's warps own at most
    SHORT_KV_ITEMS dK/dV items (two 16-key tiles each), and its strides
    put the lanes (lane = 4 gr
    + t) of each fragment load on distinct banks: float2s at row gr, column
    2t (S and dP's operands, dQ's A, the accumulators' stores, and step 3's
    four threads a row), one word at row t, column gr (P^T, dS^T and their
    B operands)."""
    plan = flash_backward.short_plan(s, d, g, torch.float32)
    assert plan is not None and plan.smem <= SMEM_PER_BLOCK
    tiny = d <= flash_backward.TINY_MAX_D and s <= flash_backward.TINY_MAX_S \
        and s * g <= flash_backward.TINY_THREADS
    assert plan.tiny == tiny
    if tiny:
        assert plan.dp == (4 if d <= 4 else 8) and (plan.s_pad, plan.rows) == (s, s * g)
        assert plan.units == flash_backward.TINY_THREADS // plan.rows >= 1
        assert plan.p_words >= s and plan.p_words % 2 == 1 and plan.warps == 4
        assert plan.smem == 4 * plan.units * (2 * s * plan.dp + 2 * plan.rows * plan.dp
                                              + 2 * plan.rows * plan.p_words)
        return
    assert plan.dp >= d and plan.dp in (8, 16, 32) and plan.s_pad >= s
    assert plan.s_pad % 16 == 0 and plan.rows % 16 == 0
    assert plan.warps == flash_backward.SHORT_WARPS
    pairs = -(-plan.s_pad // 32)   # pairs of 16-key tiles
    assert 2 * plan.units * pairs <= flash_backward.SHORT_KV_ITEMS * plan.warps
    q, p = plan.q_words, plan.p_words
    assert q >= plan.dp and p >= plan.s_pad
    assert plan.smem == 4 * plan.units * (2 * plan.s_pad * q + 3 * plan.rows * q
                                          + 2 * plan.rows * p + plan.rows)
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    for stride in (q, p):
        assert stride % 4 == 0    # 16-byte rows
        assert _phase_banks([gr * stride + 2 * t for gr, t in lanes], 2)
        assert _phase_banks([t * stride + gr for gr, t in lanes], 1)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_version_matches_jax_vjp(case):
    """`ref.flash_backward_short`, given the forward's output, against
    jax.vjp of chunked_attention at BWD_RTOL; and against
    `ref.flash_attention_bwd`, the f32 plain version chip_smoke holds the
    kernel to."""
    b, s, hq, hkv, d, causal, window, cap = case
    q, k, v, g = _draw(sum(case[:5]), b, s, hq, hkv, d)
    o, want = _jax_vjp(q, k, v, g, causal, window, cap)
    t = _t(q, k, v, o, g)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = ref.flash_backward_short(*t, **kw)
    assert _ratio(got, want) <= 1.0
    assert _ratio(got, ref.flash_attention_bwd(*t, **kw)) <= 1.0


def test_one_tf32_pass_breaks_the_limit(monkeypatch):
    """Each operand rounded once to TF32 (lo dropped) puts BERT4Rec's
    gradient past BWD_RTOL: why the kernel splits every operand."""
    b, s, hq, hkv, d, causal, window, cap = CASES[1]
    q, k, v, g = _draw(11, b, s, hq, hkv, d)
    o, want = _jax_vjp(q, k, v, g, causal, window, cap)
    t = _t(q, k, v, o, g)
    assert _ratio(ref.flash_backward_short(*t, causal=causal), want) <= 1.0
    split = ref.split_tf32_raw
    monkeypatch.setattr(ref, "split_tf32_raw", lambda x: (
        split(x)[0], torch.zeros_like(x, dtype=torch.float32)))
    assert _ratio(ref.flash_backward_short(*t, causal=causal), want) > 1.0


def test_plain_version_handles_grouped_rows_and_bf16():
    """The flattened (position, group head) rows give each query head its
    own gradient: G 4 equals the same call with K and V repeated to every
    head and dK, dV summed over each group; bf16 operands are read as f32."""
    q, k, v, g = _t(*_draw(5, 2, 19, 8, 2, 8))
    o = ref.flash_attention(q, k, v, causal=True, window=6)
    got = ref.flash_backward_short(q, k, v, o, g, causal=True, window=6)
    kr, vr = (x.repeat_interleave(4, dim=2) for x in (k, v))
    dq, dk, dv = ref.flash_backward_short(q, kr, vr, o, g, causal=True, window=6)
    torch.testing.assert_close(got[0], dq, rtol=1e-5, atol=1e-5)
    for x, y in zip(got[1:], (dk, dv)):
        torch.testing.assert_close(x, y.reshape(2, 19, 2, 4, 8).sum(3), rtol=1e-5, atol=1e-5)
    qb, kb, vb, ob, gb = (x.to(torch.bfloat16) for x in (q, k, v, o, g))
    want = ref.flash_backward_short(*(x.float() for x in (qb, kb, vb, ob, gb)), causal=True,
                                    window=6)
    for x, y in zip(ref.flash_backward_short(qb, kb, vb, ob, gb, causal=True, window=6), want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_function_cpu_gradient_is_the_f32_plain_version(causal):
    """At BST's head shape the `Attention` Function's CPU gradient is
    `ref.flash_attention_bwd`'s, bit for bit, as before the short kernel
    (which the route would take on the card): no launch."""
    q, k, v, g = _t(*_draw(3, 3, 21, 8, 8, 4))
    assert flash_backward.route(q, k, v, None) == "flash_backward_short"
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(_build.LAUNCHES)
    out = ops.flash_attention(*leaves, causal=causal)
    out.backward(g)
    want = ref.flash_attention_bwd(q, k, v, out.detach(), g, causal=causal)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)
    direct = flash_backward.flash_backward(q, k, v, out.detach(), g, causal=causal)
    for x, w in zip(direct, want):
        assert torch.equal(x, w)
    assert _build.LAUNCHES == before
