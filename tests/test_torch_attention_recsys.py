"""The recsys blocks' attention on the port: non-causal, at every head dim
the recsys configs use, D 4 (BST: 32 / 8) among them.

The plain versions (`ref.flash_attention` forward, `ref.flash_tile` the
tile kernel's arithmetic, `ref.flash_attention_bwd` the CUDA-core
backward's) against `jax.vjp` of the reference's `chunked_attention(causal=
False)` at rtol = atol = 1e-5 (f32); the `Attention` autograd Function's
CPU gradient with causal=False; and the padding the CUDA wrappers apply
below D 8 (`flash_backward.pad_head_dim` with the true D's scale 1/sqrt(4)),
through the plain versions, equal to the unpadded call within 1e-6 (the
zero columns add exact zeros; only the summation's blocking may move an
ulp). The kernels run only on the card (`chip_smoke.py` phase 7a)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro_torch.kernels import flash_attention, flash_backward, ops, ref

TOL = 1e-5
PAD_TOL = 1e-6
# b, s, hq, hkv, d, window: non-causal; BST's head (S 21, H 8, D 4),
# BERT4Rec's (H 2, D 32, S cut from 200), GQA, a window, ragged S
CASES = [
    (3, 21, 8, 8, 4, None),
    (2, 40, 2, 2, 32, None),
    (1, 33, 4, 2, 4, None),
    (2, 7, 4, 1, 8, 3),
    (1, 65, 2, 2, 16, None),
]


def _draw(rng, b, s, hq, hkv, d):
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    g = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    return q, k, v, g


def _jax_vjp(q, k, v, g, window):
    def f(q, k, v):
        return jcommon.chunked_attention(q, k, v, causal=False, window=window,
                                         chunk=q.shape[1])
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}s{}hq{}hkv{}d{}w{}".format(*c))
def test_non_causal_plain_versions_match_jax_vjp(case):
    """The forward (`ref.flash_attention` and the tile kernel's arithmetic
    `ref.flash_tile`) and the backward `ref.flash_attention_bwd`, all with
    causal=False, against jax.vjp of chunked_attention(causal=False)."""
    b, s, hq, hkv, d, window = case
    q, k, v, g = _draw(np.random.default_rng(sum(case[:5])), b, s, hq, hkv, d)
    o, want = _jax_vjp(q, k, v, g, window)
    tq, tk, tv, to, tg = _t(q, k, v, o, g)
    _close(ref.flash_attention(tq, tk, tv, causal=False, window=window), o)
    _close(ref.flash_tile(tq, tk, tv, causal=False, window=window), o)
    got = ref.flash_attention_bwd(tq, tk, tv, to, tg, causal=False, window=window)
    for x, w in zip(got, want):
        assert x.shape == w.shape
        _close(x, w)


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: "b{}s{}hq{}hkv{}d{}w{}".format(*c))
def test_attention_function_gradient_non_causal(case):
    """`ops.flash_attention(causal=False)` under autograd (the recsys
    blocks' call) on CPU tensors: output and (dq, dk, dv) equal jax.vjp's."""
    b, s, hq, hkv, d, window = case
    q, k, v, g = _draw(np.random.default_rng(7 + d), b, s, hq, hkv, d)
    o, want = _jax_vjp(q, k, v, g, window)
    tq, tk, tv, tg = (x.requires_grad_(i < 3) for i, x in enumerate(_t(q, k, v, g)))
    out = ops.flash_attention(tq, tk, tv, causal=False, window=window)
    assert out.grad_fn is not None
    out.backward(tg)
    _close(out.detach(), o)
    for x, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(x, w)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(3, 21, 8, 8), (2, 9, 4, 2)], ids=str)
def test_padding_d4_to_8_computes_the_unpadded_function(shape, causal):
    """D 4 zero-padded to 8 with scale 1/sqrt(4), as the CUDA wrappers call
    the kernels, through `ref.flash_tile` and `ref.flash_attention_bwd`:
    the padded columns of the output and of every gradient are exactly 0,
    and the rest equals the unpadded call."""
    b, s, hq, hkv = shape
    q, k, v, g = _t(*_draw(np.random.default_rng(s), b, s, hq, hkv, 4))
    qp, kp, vp, gp = flash_backward.pad_head_dim(q, k, v, g)
    assert qp.shape[3] == flash_backward.MIN_HEAD_DIM == 8 and qp.is_contiguous()
    assert torch.equal(qp[..., :4], q) and not qp[..., 4:].any()
    scale = 1.0 / math.sqrt(4)
    want = ref.flash_tile(q, k, v, causal=causal)
    got = ref.flash_tile(qp, kp, vp, causal=causal, scale=scale)
    assert not got[..., 4:].any()
    _close(got[..., :4], want, PAD_TOL)
    o = ref.flash_attention(q, k, v, causal=causal)
    op = flash_backward.pad_head_dim(o)[0]
    want = ref.flash_attention_bwd(q, k, v, o, g, causal=causal)
    got = ref.flash_attention_bwd(qp, kp, vp, op, gp, causal=causal, scale=scale)
    for x, w in zip(got, want):
        assert not x[..., 4:].any()
        _close(x[..., :4], w, PAD_TOL)
    # without the scale the padded call is the 1/sqrt(8) function, another one
    assert not torch.allclose(ref.flash_tile(qp, kp, vp, causal=causal)[..., :4],
                              ref.flash_tile(q, k, v, causal=causal), rtol=1e-3, atol=1e-3)


def test_d4_routes_to_the_tile_kernel():
    """On the card a head dim below 8 takes the short forward up to
    SHORT_MAX_S keys at every Sq (BST's S 21, and one query row), and the
    tile kernel, padded, past it (the decode and prefill kernels have no
    scale to pass); its gradient takes the short-sequence kernel up to
    SHORT_MAX_S keys and the CUDA-core kernel past it; the CPU takes the
    plain version at any D."""
    meta = torch.empty((2, 21, 8, 4), device="meta")
    one = torch.empty((2, 1, 8, 4), device="meta")
    assert flash_attention.route(meta, meta, meta) == "flash_attention_short"
    assert flash_attention.route(one, meta, meta) == "flash_attention_short"
    assert flash_backward.route(meta, meta, meta, None) == "flash_backward_short"
    long = torch.empty((2, flash_backward.SHORT_MAX_S + 1, 8, 4), device="meta")
    assert flash_attention.route(long, long, long) == "flash_attention"
    assert flash_attention.route(one, long, long) == "flash_attention"
    assert flash_backward.route(long, long, long, None) == "flash_backward"
