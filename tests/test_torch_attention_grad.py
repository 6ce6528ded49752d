"""The gradient of the port's attention: the plain backward
`ref.flash_attention_bwd` (the arithmetic of `csrc/flash_backward.cu`)
against `jax.vjp` of the reference's `chunked_attention`, which the
reference's training forward runs and `jax.grad` differentiates (it has no
Pallas backward); the `Attention` autograd Function's CPU gradient equal to
the plain version's; and the contract (causal, q_offset 0, kv_len = Skv =
Sq) outside which a gradient raises. The kernel itself runs only on the
card (`chip_smoke.py` phase 6a holds it to the plain version there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro_torch.kernels import _build, flash_backward, ops, ref

# b, s, hq, hkv, d, window, cap: causal throughout, G 1/2/4, D 8/16/64,
# S 1/7/33/130, windows and softcaps alone and together
CASES = [
    (1, 1, 2, 2, 8, None, None),
    (2, 7, 4, 2, 16, None, None),
    (1, 33, 4, 1, 8, 5, None),
    (2, 33, 2, 2, 64, None, 50.0),
    (1, 130, 4, 2, 16, 17, 50.0),
    (1, 130, 8, 2, 64, None, None),
    (2, 7, 4, 4, 64, 3, 20.0),
    (1, 130, 4, 1, 8, 64, None),
    (3, 33, 8, 2, 16, None, 30.0),
    (1, 7, 2, 1, 8, 1, None),
]


def _draw(rng, b, s, hq, hkv, d):
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    g = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    return q, k, v, g


def _jax_vjp(q, k, v, g, window, cap):
    def f(q, k, v):
        return jcommon.chunked_attention(q, k, v, causal=True, window=window, cap=cap,
                                         chunk=16)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}s{}hq{}hkv{}d{}w{}c{}".format(*c))
def test_plain_backward_matches_jax_vjp(case):
    """(dq, dk, dv) of the plain backward, given the forward's output, equal
    jax.vjp of chunked_attention at rtol = atol = 1e-5 (f32)."""
    b, s, hq, hkv, d, window, cap = case
    q, k, v, g = _draw(np.random.default_rng(sum(case[:5])), b, s, hq, hkv, d)
    o, want = _jax_vjp(q, k, v, g, window, cap)
    t = [torch.from_numpy(np.array(x)) for x in (q, k, v, o, g)]
    got = ref.flash_attention_bwd(*t, causal=True, window=window, softcap=cap)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        np.testing.assert_allclose(x.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", CASES[1:6], ids=lambda c: "b{}s{}hq{}hkv{}d{}w{}c{}".format(*c))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_equals_plain(case, dtype):
    """On CPU tensors `ops.flash_attention` under autograd goes through
    `Attention`: its output is the plain forward's, and q.grad, k.grad,
    v.grad are the plain backward's (from the saved output), cast to the
    operands' dtype; `flash_backward.flash_backward` takes the same plain
    version on the CPU and launches nothing."""
    b, s, hq, hkv, d, window, cap = case
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in
                  _draw(np.random.default_rng(7), b, s, hq, hkv, d))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(_build.LAUNCHES)
    out = ops.flash_attention(*leaves, window=window, softcap=cap)
    assert out.grad_fn is not None and "Attention" in type(out.grad_fn).__name__
    plain = ref.flash_attention(q, k, v, window=window, softcap=cap)
    assert torch.equal(out.detach(), plain)
    out.backward(g)
    want = ref.flash_attention_bwd(q, k, v, plain, g, window=window, softcap=cap)
    got2 = flash_backward.flash_backward(q, k, v, plain, g, window=window, softcap=cap)
    for leaf, w, w2 in zip(leaves, want, got2):
        assert leaf.grad.dtype == dtype
        assert torch.equal(leaf.grad, w.to(dtype))
        assert torch.equal(w2, w)
    assert _build.LAUNCHES == before


def test_no_gradient_wanted_takes_the_plain_forward():
    """Without a gradient (no_grad, or operands that need none) the call is
    the routed forward alone: no autograd node."""
    q, k, v, _ = (torch.from_numpy(x) for x in _draw(np.random.default_rng(3), 1, 9, 4, 2, 16))
    assert ops.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert ops.flash_attention(q.requires_grad_(), k, v).grad_fn is None


@pytest.mark.parametrize("kw,sq,skv", [
    (dict(q_offset=8, kv_len=9), 1, 12),          # a decode step
    (dict(kv_len=6), 8, 8),                       # kv_len < Skv
    (dict(causal=False, kv_len=6), 8, 8),         # not causal, kv_len < Skv
    (dict(q_offset=4), 8, 8),                     # a query offset
    (dict(), 5, 8),                               # Sq != Skv
])
def test_gradient_outside_the_contract_raises(kw, sq, skv):
    """The backward's contract is the training forward's; a gradient asked
    for outside it raises NotImplementedError and takes no other path."""
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.standard_normal((1, sq, 4, 16)), dtype=torch.float32,
                     requires_grad=True)
    k = torch.tensor(rng.standard_normal((1, skv, 2, 16)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((1, skv, 2, 16)), dtype=torch.float32)
    out = ops.flash_attention(q, k, v, **kw)
    with pytest.raises(NotImplementedError, match="training forward"):
        out.sum().backward()


def test_kernel_window_and_shape_checks():
    """A window of at least S is none for the kernel (-1); shapes that do not
    fit raise before any launch."""
    assert flash_backward.kernel_window(None, 100) == -1
    assert flash_backward.kernel_window(100, 100) == -1
    assert flash_backward.kernel_window(99, 100) == 99
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="do not fit"):
        flash_backward.flash_backward(q, k, k, q, q)
