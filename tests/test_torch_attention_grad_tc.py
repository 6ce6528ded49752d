"""The tensor-core route of the port's attention gradient, on the CPU:
`ref.flash_prefill`'s per-row log-sum-exp (the forward's `lse_out`, in
base 2) against torch.logsumexp of the masked, scaled, softcapped f32
scores, with the output the same bits with and without it;
`ref.flash_backward_tc` (the arithmetic of `csrc/flash_backward_tc.cu`:
the forward's lse, P and dS rounded to bf16 before the products that take
them) against `jax.vjp` of the reference's `chunked_attention` and against
the f32 plain backward `ref.flash_attention_bwd`; the routing rule
`flash_backward.route` on CPU and meta tensors; and `Attention` saving the
lse only where its forward takes `flash_prefill` and handing it to the
backward, also under remat. The kernel itself runs only on the card
(`chip_smoke.py` phase 6a holds it to its plain version there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models import common as jcommon
from repro_torch.kernels import _build, flash_attention, flash_backward, ops, ref

LOG2E = 1.4426950408889634
# P and dS enter the tensor cores as bf16 (as SDPA's flash backward rounds
# them), and the gradients are rounded to bf16 after the kernel anyway: the
# bf16 route's rtol, and atol this x max|plain| per output
BWD_BF16_TOL = 2e-2
LSE_TOL = 1e-5                 # rtol and atol of the lse, base 2

# b, s, hq, hkv, d, window, cap: causal, G 1/2/4/8, D 64/128/256, S
# 1/17/255, windows and softcaps alone and together; the last three at D 256
# (gemma2-like: G 2, window and softcap 50; gemma3-like: G 2; G 4)
CASES = [
    (1, 1, 2, 2, 64, None, None),
    (2, 17, 4, 2, 64, None, None),
    (1, 17, 8, 1, 128, 5, None),
    (1, 255, 2, 1, 64, None, 50.0),
    (2, 17, 2, 2, 128, None, 50.0),
    (1, 255, 8, 1, 64, 100, 50.0),
    (1, 255, 4, 2, 128, 8, None),
    (3, 17, 8, 8, 64, 3, 30.0),
    (1, 255, 8, 4, 256, 100, 50.0),
    (2, 17, 16, 8, 256, 5, None),
    (1, 17, 4, 1, 256, None, None),
]
D256 = CASES[-3:]


def _ids(c):
    return "b{}s{}hq{}hkv{}d{}w{}c{}".format(*c)


def _draw(seed, b, s, hq, hkv, d, sk=None):
    """q, k, v, dO as bf16 tensors from numpy draws."""
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    shapes = ((b, s, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, s, hq, d))
    return [torch.tensor(rng.standard_normal(sh), dtype=torch.float32).to(torch.bfloat16)
            for sh in shapes]


def _forward(q, k, v, window, cap):
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32)
    o = ref.flash_prefill(q, k, v, window=window, softcap=cap, lse_out=lse)
    return o, lse


def _within(got, want, tol, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.as_tensor(np.array(w))
        assert g.dtype == torch.float32 and g.shape == w.shape, (what, name)
        lim = tol * w.abs() + tol * float(w.abs().max())
        err = (g - w).abs()
        assert bool((err <= lim).all()), \
            f"{what} {name}: {float((err / lim).max()):.3f} of the limit"


@pytest.mark.parametrize("q_offset,cut", [(0, False), (5, True)])
@pytest.mark.parametrize("case", CASES[1:], ids=_ids)
def test_prefill_lse_is_the_rows_logsumexp(case, q_offset, cut):
    """ref.flash_prefill's lse_out is log2(sum 2^(s log2 e)) over each row's
    visible keys, s the scaled and softcapped f32 score: torch.logsumexp of
    the masked scores times log2 e, within 1e-5; the output is the same bits
    with and without lse_out. Also at a query offset with kv_len short of
    the last rows' positions."""
    b, s, hq, hkv, d, window, cap = case
    sk = s + q_offset + 3
    kv_len = s + q_offset - 3 if cut else None
    q, k, v, _ = _draw(sum(case[:5]), b, s, hq, hkv, d, sk)
    lse = torch.full((b, hq, s), float("nan"))
    kw = dict(window=window, softcap=cap, q_offset=q_offset, kv_len=kv_len)
    out = ref.flash_prefill(q, k, v, lse_out=lse, **kw)
    assert torch.equal(out, ref.flash_prefill(q, k, v, **kw))
    g = hq // hkv
    n = sk if kv_len is None else kv_len
    sc = torch.einsum("bqhgd,bkhd->bhgqk", q.float().reshape(b, s, hkv, g, d),
                      k[:, :n].float()) / d ** 0.5
    if cap is not None:
        sc = cap * torch.tanh(sc / cap)
    qp = torch.arange(s)[:, None] + q_offset
    kp = torch.arange(n)[None, :]
    mask = qp >= kp
    if window is not None:
        mask &= qp - kp < window
    want = torch.logsumexp(torch.where(mask, sc, -torch.inf), -1).reshape(b, hq, s) * LOG2E
    seen = mask.any(-1)                       # rows that see no key have no lse
    np.testing.assert_allclose(lse[..., seen].numpy(), want[..., seen].numpy(),
                               rtol=LSE_TOL, atol=LSE_TOL)


def test_prefill_wrapper_checks_lse_out():
    """flash_prefill's wrapper takes a contiguous f32 [B, Hq, Sq] lse_out on
    q's device, and gives the plain version's on the CPU."""
    from repro_torch.kernels import flash_prefill
    q, k, v, _ = _draw(1, 1, 9, 4, 2, 64)
    good = torch.empty((1, 4, 9))
    out = flash_prefill.flash_prefill(q, k, v, lse_out=good)
    want = torch.empty((1, 4, 9))
    assert torch.equal(out, ref.flash_prefill(q, k, v, lse_out=want))
    assert torch.equal(good, want)
    for bad in (torch.empty((1, 9, 4)), torch.empty((1, 4, 9), dtype=torch.float64),
                torch.empty((1, 4, 18))[..., ::2]):
        with pytest.raises(ValueError, match="lse_out"):
            flash_prefill.flash_prefill(q, k, v, lse_out=bad)


def _jax_vjp(q, k, v, g, window, cap):
    def f(q, k, v):
        return jcommon.chunked_attention(q, k, v, causal=True, window=window, cap=cap,
                                         chunk=16)
    _, vjp = jax.vjp(f, *(jnp.asarray(x.float().numpy()) for x in (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g.float().numpy()))]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_tc_backward_matches_jax_vjp(case):
    """ref.flash_backward_tc on bf16 operands, from ref.flash_prefill's
    output and lse, against jax.vjp of chunked_attention in f32 on the same
    bf16 values, and against ref.flash_attention_bwd, at BWD_BF16_TOL."""
    b, s, hq, hkv, d, window, cap = case
    q, k, v, do = _draw(sum(case[:5]) + 1, b, s, hq, hkv, d)
    o, lse = _forward(q, k, v, window, cap)
    got = ref.flash_backward_tc(q, k, v, o, do, lse, causal=True, window=window,
                                softcap=cap)
    _within(got, _jax_vjp(q, k, v, do, window, cap), BWD_BF16_TOL, "vs jax.vjp")
    _within(got, ref.flash_attention_bwd(q, k, v, o, do, window=window, softcap=cap),
            BWD_BF16_TOL, "vs ref.flash_attention_bwd")


@pytest.mark.parametrize("case", CASES[1:4], ids=_ids)
def test_plain_tc_backward_rounds_p_and_ds(case):
    """The bf16 roundings are where the kernel makes them: with P and dS
    kept in f32 the same steps give ref.flash_attention_bwd within 1e-4 of
    max (so the rest is the f32 arithmetic of record), and the rounded
    version differs from that by more (the roundings are really made)."""
    b, s, hq, hkv, d, window, cap = case
    q, k, v, do = _draw(sum(case[:5]) + 2, b, s, hq, hkv, d)
    o, lse = _forward(q, k, v, window, cap)
    f32 = ref.flash_attention_bwd(q, k, v, o, do, window=window, softcap=cap)
    real = torch.Tensor.to

    def keep_f32(x, *a, **kw):
        if (a and a[0] is torch.bfloat16) or kw.get("dtype") is torch.bfloat16:
            return x
        return real(x, *a, **kw)
    got = ref.flash_backward_tc(q, k, v, o, do, lse, window=window, softcap=cap)
    try:
        torch.Tensor.to = keep_f32
        unrounded = ref.flash_backward_tc(q, k, v, o, do, lse, window=window, softcap=cap)
    finally:
        torch.Tensor.to = real
    for u, g, w in zip(unrounded, got, f32):
        top = float(w.abs().max())
        assert float((u - w).abs().max()) <= 1e-4 * top
        assert float((g - w).abs().max()) > float((u - w).abs().max())


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_route(dev):
    """flash_backward.route: bf16, D 64, 128 or 256, 16-byte aligned, Sq > 1
    and the forward's lse -> flash_backward_tc; f32, an unaligned view, one
    query position or no lse -> flash_backward; D 32 (16 positions) ->
    flash_backward_short."""
    def make(b, s, h, d, dtype=torch.bfloat16):
        return torch.empty((b, s, h, d), dtype=dtype, device=dev)
    lse = torch.empty((2, 8, 16), device=dev)
    for d in (64, 128, 256):
        q, k = make(2, 16, 8, d), make(2, 16, 2, d)
        assert flash_backward.route(q, k, k, lse) == "flash_backward_tc"
        assert flash_backward.route(q, k, k, None) == "flash_backward"
        qf, kf = make(2, 16, 8, d, torch.float32), make(2, 16, 2, d, torch.float32)
        assert flash_backward.route(qf, kf, kf, lse) == "flash_backward"
        q1, k1 = make(2, 1, 8, d), make(2, 1, 2, d)
        assert flash_backward.route(q1, k1, k1, lse) == "flash_backward"
    q, k = make(2, 16, 8, 32), make(2, 16, 2, 32)
    assert flash_backward.route(q, k, k, lse) == "flash_backward_short"
    if dev == "cpu":
        big = torch.empty((2, 16, 8, 72), dtype=torch.bfloat16)
        q, k = big[..., 1:65], make(2, 16, 2, 64)
        assert flash_backward.route(q, k, k, lse) == "flash_backward"


def test_saves_lse_only_on_the_prefill_route():
    """Attention asks for the lse exactly where its forward is a kernel
    call routed to flash_prefill and its gradient takes the tensor-core
    pair: D 64, 128 and 256 in bf16; not on the CPU's plain path, not in
    f32, not at Sq = 1, not at D 32 (the tile kernel's forward)."""
    for d in (64, 128, 256):
        q, k = _meta((1, 16, 4, d)), _meta((1, 16, 2, d))
        assert flash_attention.route(q, k, k) == "flash_prefill"
        assert flash_attention.saves_lse(q, k, k)
    q, k = _meta((1, 16, 4, 32)), _meta((1, 16, 2, 32))
    assert flash_attention.route(q, k, k) != "flash_prefill"
    assert not flash_attention.saves_lse(q, k, k)
    q, k = _meta((1, 16, 4, 128), torch.float32), _meta((1, 16, 2, 128), torch.float32)
    assert not flash_attention.saves_lse(q, k, k)
    q, k = _meta((1, 1, 4, 128)), _meta((1, 16, 2, 128))
    assert not flash_attention.saves_lse(q, k, k)
    q, k, v, _ = _draw(3, 1, 16, 4, 2, 128)
    assert not flash_attention.saves_lse(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_attention_saves_no_lse(dtype):
    """On the CPU the forward is the plain one: Attention saves None for
    the lse, and its gradient is ref.flash_attention_bwd's, no launch."""
    q, k, v, g = (x.to(dtype) for x in _draw(4, 2, 17, 4, 2, 64))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(_build.LAUNCHES)
    out = ops.flash_attention(*leaves, window=8, softcap=50.0)
    assert out.grad_fn.saved_tensors[4] is None
    out.backward(g)
    want = ref.flash_attention_bwd(q, k, v, out.detach(), g, window=8, softcap=50.0)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w.to(dtype))
    assert _build.LAUNCHES == before


def _spies(monkeypatch, seen):
    """Attention with saves_lse forced on, its forward and backward replaced
    by the plain versions of flash_prefill and flash_backward_tc, and every
    lse that passes recorded."""
    def forward(q, k, v, *, causal, window, softcap, q_offset, kv_len, lse_out=None):
        seen.setdefault("fwd", []).append(lse_out)
        return ref.flash_prefill(q, k, v, causal=causal, window=window, softcap=softcap,
                                 q_offset=q_offset, kv_len=kv_len, lse_out=lse_out)

    def backward(q, k, v, o, do, *, causal, window, softcap, lse=None):
        seen.setdefault("bwd", []).append(lse)
        return ref.flash_backward_tc(q, k, v, o, do, lse, causal=causal, window=window,
                                     softcap=softcap)
    monkeypatch.setattr(flash_attention, "saves_lse", lambda q, k, v: True)
    monkeypatch.setattr(flash_attention, "_forward", forward)
    monkeypatch.setattr(flash_backward, "flash_backward", backward)


@pytest.mark.parametrize("remat", [False, True])
def test_attention_hands_its_lse_to_the_backward(monkeypatch, remat):
    """Where saves_lse holds, Attention allocates an f32 [B, Hq, S] lse,
    the forward fills it, and the backward gets that lse: the gradients are
    ref.flash_backward_tc's from it, in the operands' dtype. Under
    non-reentrant checkpointing (the trainer's per-layer remat) both the
    first forward and the recompute write one, and the backward takes the
    recompute's."""
    seen = {}
    _spies(monkeypatch, seen)
    q, k, v, g = _draw(5, 1, 33, 4, 2, 64)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def attn(q, k, v):
        return ops.flash_attention(q, k, v, window=16, softcap=50.0)
    out = checkpoint(attn, *leaves, use_reentrant=False) if remat else attn(*leaves)
    out.backward(g)
    assert len(seen["fwd"]) == (2 if remat else 1) and len(seen["bwd"]) == 1
    lse = seen["fwd"][-1]
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 33)
    assert seen["bwd"][0] is lse
    o, want_lse = _forward(q, k, v, 16, 50.0)
    assert torch.equal(lse, want_lse)
    want = ref.flash_backward_tc(q, k, v, o, g, want_lse, window=16, softcap=50.0)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, w.to(torch.bfloat16))


@pytest.mark.parametrize("case", CASES[1:5] + D256, ids=_ids)
def test_wrapper_takes_the_routed_plain_version_on_cpu(case):
    """flash_backward.flash_backward on CPU tensors takes the routed
    kernel's plain version: ref.flash_backward_tc with the lse (where
    `route` says so), ref.flash_attention_bwd without it; no launch."""
    b, s, hq, hkv, d, window, cap = case
    q, k, v, do = _draw(6, b, s, hq, hkv, d)
    o, lse = _forward(q, k, v, window, cap)
    kw = dict(window=window, softcap=cap)
    before = dict(_build.LAUNCHES)
    tc = flash_backward.flash_backward(q, k, v, o, do, lse=lse, **kw)
    cc = flash_backward.flash_backward(q, k, v, o, do, **kw)
    for x, y in zip(tc, ref.flash_backward_tc(q, k, v, o, do, lse, **kw)):
        assert torch.equal(x, y)
    for x, y in zip(cc, ref.flash_attention_bwd(q, k, v, o, do, **kw)):
        assert torch.equal(x, y)
    assert _build.LAUNCHES == before


def test_wrapper_checks_the_lse_shape():
    """An lse that is not [B, Hq, S] raises before any launch."""
    q, k, v, do = _draw(7, 1, 9, 4, 2, 64)
    with pytest.raises(ValueError, match="lse must be"):
        flash_backward.flash_backward(q, k, v, q, do, lse=torch.empty((1, 9, 4)))
