"""The port's segment sum (`repro_torch.kernels.segment_sum`, plain version
`ref.segment_sum`) on the CPU: against `jax.ops.segment_sum`, against a
sequential `index_add_` bit for bit, chunked against unchunked bit for bit,
its index plan, and the two autograd Functions (`sum_rows`, `gather_rows`)
against `torch.autograd.gradcheck` in f64 and against `jax.grad`.

The card's kernel (`csrc/segment_sum.cu`) is held to the same plain version
bit for bit by `chip_smoke.py` phase 8a; a CUDA tensor launches it or the
wrapper raises, which a meta tensor shows here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import segment_sum as S

# (N, E, kind): random edges, more segments than edges (most empty), -1 pads
# scattered and at the end, a non-zero out0, every edge into one segment
CASES = [(24, 64, "random"), (500, 60, "random"), (40, 300, "pad"), (30, 200, "out0"),
         (7, 150, "hub"), (16, 0, "random")]
FS = [1, 3, 64]


def _case(n, e, f, kind, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((e, f)).astype(np.float32)
    idx = (np.full(e, n // 2) if kind == "hub" else rng.integers(0, n, e)).astype(np.int32)
    if kind == "pad":
        idx[rng.random(e) < 0.3] = -1
        idx[-5:] = -1
    out0 = rng.standard_normal((n, f)).astype(np.float32) if kind == "out0" else None
    return rows, idx, out0


def _sum(rows, idx, n, out0=None):
    p = S.plan(torch.from_numpy(idx), n)
    return S.segment_sum(torch.from_numpy(rows), p.perm, p.offsets,
                         None if out0 is None else torch.from_numpy(out0))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("n,e,kind", CASES)
def test_plain_matches_jax_segment_sum(n, e, kind, f):
    rows, idx, out0 = _case(n, e, f, kind)
    got = _sum(rows, idx, n, out0).numpy()
    valid = idx >= 0
    want = jax.ops.segment_sum(jnp.asarray(rows[valid]), jnp.asarray(idx[valid]),
                               num_segments=n)
    if out0 is not None:
        want = want + out0
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("n,e,kind", CASES)
def test_plain_equals_sequential_index_add(n, e, kind, f):
    """Left to right in ascending edge order within each segment: equal to
    index_add_ over the valid rows in edge order (the CPU's loop) and to a
    numpy loop, bit for bit."""
    rows, idx, out0 = _case(n, e, f, kind)
    got = _sum(rows, idx, n, out0)
    valid = idx >= 0
    base = torch.zeros((n, f)) if out0 is None else torch.from_numpy(out0).clone()
    want = base.index_add_(0, torch.from_numpy(idx[valid]).long(),
                           torch.from_numpy(rows[valid]))
    assert torch.equal(_bits(got), _bits(want))
    loop = np.zeros((n, f), np.float32) if out0 is None else out0.copy()
    for i in np.nonzero(valid)[0]:
        loop[idx[i]] = loop[idx[i]] + rows[i]
    assert torch.equal(_bits(got), _bits(torch.from_numpy(loop)))


@pytest.mark.parametrize("chunks", [2, 3, 7])
@pytest.mark.parametrize("f", FS)
def test_chunked_equals_unchunked(chunks, f):
    """Contiguous chunks, each continuing the sums through out0, equal one
    call bit for bit."""
    n, e = 50, 700
    rows, idx, out0 = _case(n, e, f, "pad", seed=chunks)
    whole = _sum(rows, idx, n, out0)
    acc = None if out0 is None else torch.from_numpy(out0)
    for c in np.array_split(np.arange(e), chunks):
        p = S.plan(torch.from_numpy(idx[c]), n)
        acc = S.segment_sum(torch.from_numpy(rows[c]), p.perm, p.offsets, acc)
    assert torch.equal(_bits(acc), _bits(whole))


def test_plan_sorts_stably_and_counts():
    idx = torch.tensor([3, -1, 0, 3, 2, 0, -1, 3], dtype=torch.int32)
    p = S.plan(idx, 5)
    assert p.perm.dtype == torch.int32 and p.offsets.dtype == torch.int32
    assert p.perm.tolist() == [2, 5, 4, 0, 3, 7]
    assert p.offsets.tolist() == [0, 2, 2, 3, 6, 6]
    assert p.counts().tolist() == [2, 0, 1, 3, 0] and p.n_segments == 5
    assert p.valid.tolist() == (idx >= 0).tolist()
    assert p.index.tolist() == [3, 0, 0, 3, 2, 0, 0, 3]
    # an explicit mask drops rows whose own index is valid
    q = S.plan(idx, 5, valid=torch.tensor([True] * 7 + [False]) & (idx >= 0))
    assert q.perm.tolist() == [2, 5, 4, 0, 3] and q.counts().tolist() == [2, 0, 1, 2, 0]
    # every row valid: no mask kept
    assert S.plan(torch.tensor([1, 0, 1]), 2).valid is None


def test_routes():
    assert [S.route(f) for f in (1, 3, 5, 8)] == ["thread"] * 4
    assert [S.route(f) for f in (9, 64, 100, 128, 300)] == ["warp"] * 5


def test_plain_version_on_segments_longest_first():
    """The plain version's steps take the segments in order of length, so a
    segment of many rows among short ones keeps its own order."""
    rows = torch.tensor([[1e8], [1.0], [-1e8], [1.0], [0.5]], dtype=torch.float32)
    idx = torch.tensor([0, 0, 0, 0, 1], dtype=torch.int32)
    p = S.plan(idx, 2)
    got = ref.segment_sum(rows, p.perm, p.offsets)
    assert got[:, 0].tolist() == [1.0, 0.5]       # ((1e8 + 1) - 1e8) + 1 in f32


def test_cuda_operands_never_take_the_plain_version():
    """Operands off the CPU go to the kernel's checks, never to ref; all
    on meta (the dry run) they only propagate the result's shape."""
    p = S.plan(torch.tensor([0, 1], dtype=torch.int32), 2)
    meta = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        S.segment_sum(meta, p.perm, p.offsets)
    out = S.segment_sum(meta, p.perm.to("meta"), p.offsets.to("meta"))
    assert out.is_meta and out.shape == (2, 4)


def test_gradcheck_sum_rows_and_gather_rows_f64():
    rows, idx, out0 = _case(9, 40, 3, "pad", seed=3)
    p = S.plan(torch.from_numpy(idx), 9)
    r = torch.from_numpy(rows).double().requires_grad_()
    o = torch.from_numpy(_case(9, 1, 3, "out0")[2]).double().requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: S.sum_rows(a, p, b), (r, o))
    assert torch.autograd.gradcheck(lambda a: S.sum_rows(a, p), (r,))
    t = torch.randn((9, 3), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: S.gather_rows(a, p), (t,))


@pytest.mark.parametrize("kind", ["random", "pad"])
def test_grads_match_jax(kind):
    """y = sum over dst of h[src] * w by edge, then a weighted sum: the value
    and the gradients of h and w against jax.grad of the same function on
    jax.ops.segment_sum."""
    n, e, f = 30, 200, 5
    rng = np.random.default_rng(11)
    h = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal((e, f)).astype(np.float32)
    c = rng.standard_normal((n, f)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if kind == "pad":
        src[rng.random(e) < 0.2] = -1
        dst[-7:] = -1
    valid = (src >= 0) & (dst >= 0)

    def jloss(h, w):
        m = jnp.where(valid[:, None], h[np.where(valid, src, 0)] * w, 0)
        return jnp.sum(jax.ops.segment_sum(m, np.where(valid, dst, 0), num_segments=n) * c)

    jv, (jh, jw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    vt = torch.from_numpy(valid)
    ps, pd = S.plan(torch.from_numpy(src), n, vt), S.plan(torch.from_numpy(dst), n, vt)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tv = torch.sum(S.sum_rows(S.gather_rows(th, ps) * tw, pd) * torch.from_numpy(c))
    gh, gw = torch.autograd.grad(tv, (th, tw))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for got, want in ((gh, jh), (gw, jw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
