"""The port's segment sum (`repro_torch.kernels.segment_sum`, plain version
`ref.segment_sum`) on the CPU: both plans (permuted, for the gather route;
sorted, for the stream route over rows already in segment order) against
`jax.ops.segment_sum`, against a sequential `index_add_` and against each
other bit for bit, chunked and node-ranged in place against unchunked bit for
bit, the plans themselves (on meta too), and the autograd Functions
(`sum_rows`, in place or not, `gather_rows`, `gather_pair`) against
`torch.autograd.gradcheck` in f64 and against `jax.grad`.

The card's kernels (`csrc/segment_sum.cu`) are held to the same plain
version bit for bit by `chip_smoke.py` phase 8a; a CUDA tensor launches one
or the wrapper raises, which a meta tensor shows here.
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


# -- the sorted plan (the stream route: rows already in segment order) ------------

def _sorted(rows, idx, n):
    """The valid rows put in segment order (stably) and the sorted plan of
    their index, beside the permuted plan of `idx`."""
    p = S.plan(torch.from_numpy(idx), n)
    order = p.perm.long()
    key = p.index[order]
    return p, torch.from_numpy(rows)[order], key, S.sorted_plan(key, n)


@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("n,e,kind", CASES)
def test_sorted_plan_matches_jax_segment_sum(n, e, kind, f):
    rows, idx, out0 = _case(n, e, f, kind)
    _, srt, _, sp = _sorted(rows, idx, n)
    got = S.segment_sum(srt, None, sp.offsets, None if out0 is None else torch.from_numpy(out0),
                        bounds=sp.bounds).numpy()
    valid = idx >= 0
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(rows[valid]), jnp.asarray(idx[valid]),
                                          num_segments=n))
    if out0 is not None:
        want = want + out0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("n,e,kind", CASES)
def test_sorted_plan_equals_index_add_and_permuted_plan(n, e, kind, f):
    """The sorted plan's plain version on the rows in segment order equals a
    sequential index_add_ over the valid rows in edge order and the permuted
    plan on the rows as they were, bit for bit."""
    rows, idx, out0 = _case(n, e, f, kind)
    p, srt, key, sp = _sorted(rows, idx, n)
    o0 = None if out0 is None else torch.from_numpy(out0)
    got = S.segment_sum(srt, None, sp.offsets, o0, bounds=sp.bounds)
    valid = idx >= 0
    base = torch.zeros((n, f)) if o0 is None else o0.clone()
    want = base.index_add_(0, torch.from_numpy(idx[valid]).long(),
                           torch.from_numpy(rows[valid]))
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(S.segment_sum(torch.from_numpy(rows), p.perm,
                                                       p.offsets, o0)))


@pytest.mark.parametrize("cuts", [(1, 7, 333), (0, 0, 50, 51), (2, 600), (699,)])
@pytest.mark.parametrize("f", FS)
def test_ranges_in_place_equal_unchunked(cuts, f):
    """The rows in segment order cut anywhere (an empty range too), each cut
    a sorted plan over its own node range summed in place on a running sum:
    equal to one call bit for bit, with a hub segment (node 3) longer than
    any cut, and nothing written outside a range."""
    n, e = 50, 700
    rows, idx, out0 = _case(n, e, f, "pad", seed=len(cuts))
    idx[(idx >= 0) & (np.arange(e) % 3 == 0)] = 3
    _, srt, key, sp = _sorted(rows, idx, n)
    o0 = torch.from_numpy(out0) if out0 is not None else torch.randn((n, f))
    whole = S.segment_sum(srt, None, sp.offsets, o0, bounds=sp.bounds)
    run = o0.clone()
    m = srt.shape[0]
    edges = sorted({min(c, m) for c in cuts} | {0, m})
    for c0, c1 in zip(edges, edges[1:] + [m]):
        cp = S.sorted_plan(key[c0:c1], n)
        lo, hi = cp.bounds.tolist()
        before = run.clone()
        out = S.segment_sum(srt[c0:c1], None, cp.offsets, run, bounds=cp.bounds, out=run)
        assert out is run
        assert torch.equal(run[:lo], before[:lo]) and torch.equal(run[hi:], before[hi:])
    assert torch.equal(_bits(run), _bits(whole))
    # a range without out sums onto a copy of out0, which it leaves alone
    cp = S.sorted_plan(key[5:9], n)
    copy = S.segment_sum(srt[5:9], None, cp.offsets, o0, bounds=cp.bounds)
    assert copy is not o0 and not torch.equal(copy, o0)


def test_sorted_plan_offsets_bounds_and_index():
    idx = torch.tensor([1, 1, 3, 3, 3, 4, 9, -1], dtype=torch.int32)
    valid = torch.tensor([True] * 6 + [False] * 2)
    p = S.sorted_plan(idx, 6, valid)
    assert p.perm is None and p.valid is valid and p.n_segments == 6
    assert p.offsets.tolist() == [0, 0, 2, 2, 5, 6, 6]
    assert p.bounds.tolist() == [1, 5] and p.bounds.dtype == torch.int32
    assert p.counts().tolist() == [0, 2, 0, 3, 1, 0]
    assert p.index.tolist() == [1, 1, 3, 3, 3, 4, 5, 5]     # nondecreasing
    q = S.sorted_plan(torch.tensor([0, 2, 2]), 4)
    assert q.valid is None and q.bounds.tolist() == [0, 3] and q.offsets.tolist() == [0, 1, 1, 3, 3]
    # no valid row, and no row at all: an empty range
    none = S.sorted_plan(torch.tensor([-1, -1], dtype=torch.int32), 4,
                         torch.tensor([False, False]))
    assert none.bounds.tolist() == [0, 0] and none.counts().tolist() == [0] * 4
    assert S.sorted_plan(torch.zeros(0, dtype=torch.int32), 4).bounds.tolist() == [0, 0]
    out0 = torch.randn((4, 2))
    got = S.segment_sum(torch.ones((2, 2)), None, none.offsets, out0, bounds=none.bounds)
    assert torch.equal(got, out0)


def test_sorted_plan_on_meta_keeps_its_shapes():
    """No host read: the dry run builds sorted plans and sums on meta."""
    idx = torch.empty(40, dtype=torch.int32, device="meta")
    p = S.sorted_plan(idx, 9, torch.empty(40, dtype=torch.bool, device="meta"))
    assert p.offsets.is_meta and p.offsets.shape == (10,) and p.bounds.shape == (2,)
    rows = torch.empty((40, 3), device="meta")
    assert S.segment_sum(rows, None, p.offsets, bounds=p.bounds).shape == (9, 3)
    acc = torch.empty((9, 3), device="meta")
    assert S.sum_rows(rows, p, acc, inplace=True) is acc
    assert S.gather_rows(torch.empty((9, 3), device="meta"), p).shape == (40, 3)


def test_stream_route_never_takes_the_plain_version_off_the_cpu():
    """A sorted plan's operands off the CPU go to the kernel's checks, never
    to ref: a meta row tensor beside CPU offsets and bounds raises."""
    p = S.sorted_plan(torch.tensor([0, 1], dtype=torch.int32), 2)
    meta = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        S.segment_sum(meta, None, p.offsets, bounds=p.bounds)
    with pytest.raises(ValueError, match="CUDA tensor"):
        S.segment_sum(torch.ones((2, 4)), None, p.offsets, bounds=p.bounds.to("meta"))


def test_gradcheck_on_a_sorted_plan_f64():
    rows, idx, _ = _case(9, 40, 3, "pad", seed=5)
    _, srt, key, sp = _sorted(rows, idx, 9)
    r = srt.double().requires_grad_()
    o = torch.randn((9, 3), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: S.sum_rows(a, sp, b), (r, o))
    assert torch.autograd.gradcheck(lambda a: S.sum_rows(a, sp), (r,))
    t = torch.randn((9, 3), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: S.gather_rows(a, sp), (t,))
    # a valid prefix: the rows past it gather zeros and take no gradient
    valid = torch.arange(12) < 9
    k = torch.cat([key[:9], torch.full((3,), -1, dtype=torch.int32)])
    vp = S.sorted_plan(k, 9, valid)
    assert torch.autograd.gradcheck(lambda a: S.gather_rows(a, vp), (t,))
    assert torch.autograd.gradcheck(lambda a: S.sum_rows(a, vp),
                                    (torch.randn((12, 3), dtype=torch.float64,
                                                 requires_grad=True),))


@pytest.mark.parametrize("sorted_", [False, True])
def test_sum_rows_in_place(sorted_):
    """In place on a running sum (not a leaf): the same values and gradients
    as out of place, out0 returned, and its gradient passed through."""
    rows, idx, _ = _case(20, 120, 5, "pad", seed=7)
    p, srt, key, sp = _sorted(rows, idx, 20)
    plan_, r_in = (sp, srt) if sorted_ else (p, torch.from_numpy(rows))
    base = torch.randn((20, 5), dtype=torch.float64).float()
    g = torch.randn((20, 5))
    grads = []
    for inplace in (False, True):
        r = r_in.clone().requires_grad_()
        b = base.clone().requires_grad_()
        acc = b * 1.0                       # a running sum, not a leaf
        y = S.sum_rows(r, plan_, acc, inplace=inplace)
        assert (y is acc) == inplace
        grads.append((y.detach().clone(), *torch.autograd.grad(y, (r, b), g)))
    for a, b_ in zip(*grads):
        assert torch.equal(_bits(a), _bits(b_))


@pytest.mark.parametrize("kinds", [("sorted", "permuted"), ("permuted", "permuted")])
def test_gather_pair(kinds):
    """Two gathers of one table: the same rows as gather_rows; the backward
    (the sums by the second plan, then the first's rows added on in place)
    passes gradcheck in f64 and equals the two gathers' summed gradients."""
    n, e = 12, 70
    rows, idx, _ = _case(n, e, 4, "pad", seed=9)
    rng = np.random.default_rng(9)
    other = rng.integers(0, n, e).astype(np.int32)
    p, _, key, sp = _sorted(rows, idx, n)
    first = sp if kinds[0] == "sorted" else p
    m = key.shape[0] if kinds[0] == "sorted" else e
    q = S.plan(torch.from_numpy(other[:m]), n)
    t = torch.randn((n, 4), dtype=torch.float64, requires_grad=True)
    a, b = S.gather_pair(t, first, q)
    assert torch.equal(a, S.gather_rows(t, first)) and torch.equal(b, S.gather_rows(t, q))
    assert torch.autograd.gradcheck(lambda x: S.gather_pair(x, first, q), (t,))
    ga, gb = torch.randn(a.shape, dtype=torch.float64), torch.randn(b.shape, dtype=torch.float64)
    (got,) = torch.autograd.grad((a, b), t, (ga, gb))
    (w1,) = torch.autograd.grad(S.gather_rows(t, first), t, ga)
    (w2,) = torch.autograd.grad(S.gather_rows(t, q), t, gb)
    torch.testing.assert_close(got, w1 + w2, rtol=1e-12, atol=1e-12)
