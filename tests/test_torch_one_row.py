"""One-row calls of the port's `coverage_gain` and `bit_matvec`: the route a
call takes, the plain versions at one row against the reference's ops, and
lazy greedy's exact evaluation against the reference's.

On the CUDA card a call of at most `tiles.SPLIT_MAX_TASKS[kernel]` tasks
(rows, or (row, column) pairs of `bit_matvec`) over rows of at least
`tiles.SPLIT_MIN_WORDS[kernel]` words takes the split route (a row to a
thread-block cluster), any other the warp route; `chip_smoke.py` holds
both routes against the plain versions there. Here, on the CPU, the route
is only chosen and checked, and the plain versions run.

One-row operands are sliced at several rows of a larger matrix (a view with
a storage offset, as `_exact_gains_one` slices `clause_*_bits[j:j + 1]`).
`coverage_gain` must be equal; `bit_matvec` equal on weights k/256 (their
f32 sums are exact in any order) and within rtol 1e-5, atol 1e-4 (the
reference's kernel tolerance) on random ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constraint as jconstraint
from repro.core.lazy_greedy import _exact_gains_one as ref_exact_gains_one
from repro.core.problem import SCSKProblem as JProblem
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import constraint
from repro_torch.core.lazy_greedy import _exact_gains_one
from repro_torch.kernels import bit_matvec, coverage_gain, ops, tiles
from repro_torch.kernels.tiles import (MAX_SPLIT_CTAS, SPLIT_MAX_TASKS, SPLIT_MIN_WORDS,
                                      SPLIT_WORDS)

BACKENDS = ["interpret", "xla"]
WIDTHS = [1, 3, 625, 849, 1029]
ROWS = [0, 4, 8]             # rows sliced from a [9, W] matrix


def _words(rng, c, w):
    a = rng.integers(0, 2 ** 32, size=(c, w), dtype=np.uint32)
    a[:, -1] |= np.uint32(0x80000000)         # bit 31 of the last word
    return a


def _t(words):
    return torch.from_numpy(words.view(np.int32).copy())


# -- the route ----------------------------------------------------------------

def test_the_limits_are_the_sweeps():
    """optpes's 4096 refreshed rows and greedy's 2^16 stay on the warp
    route; lazy's and ingest's one row takes the split route at the
    production width (32768 words); `medium`'s rows (625 doc words, 849
    query words) stay on the warp route."""
    kernels = ("coverage_gain", "bit_matvec")
    assert {k: SPLIT_MAX_TASKS[k] for k in kernels} == {"coverage_gain": 128, "bit_matvec": 1024}
    assert {k: SPLIT_MIN_WORDS[k] for k in kernels} == {"coverage_gain": 8192, "bit_matvec": 2048}
    for k in ("coverage_gain", "bit_matvec"):
        assert tiles.gain_route(k, 4096, 32768) == tiles.gain_route(k, 65536, 32768) == "warp"
        assert tiles.gain_route(k, 1, 32768) == tiles.gain_route(k, 1, 33163) == "split"
        assert tiles.gain_route(k, 1, 625) == tiles.gain_route(k, 1023, 849) == "warp"


@pytest.mark.parametrize("kernel", ["coverage_gain", "bit_matvec"])
@pytest.mark.parametrize("w", [1, 625, 849, 2047, 2048, 8191, 8192, 32768, 40003])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_gain_route_at_the_threshold(kernel, w, edge):
    tasks = SPLIT_MAX_TASKS[kernel] + edge
    wide = w >= SPLIT_MIN_WORDS[kernel]
    want = "split" if wide and edge <= 0 else "warp"
    assert tiles.gain_route(kernel, tasks, w) == want
    assert tiles.gain_route(kernel, 1, w) == ("split" if wide else "warp")


@pytest.mark.parametrize("c,r", [(1, 1), (1, 3), (341, 3), (342, 3),
                                 (1024, 1), (1025, 1), (512, 2), (513, 2)])
def test_bit_matvec_route_counts_row_column_tasks(c, r):
    """bit_matvec's tasks are C·R (row, column) pairs: the route follows
    their number, not the rows'."""
    want = "split" if c * r <= SPLIT_MAX_TASKS["bit_matvec"] else "warp"
    assert tiles.gain_route("bit_matvec", c * r, 32768) == want


@pytest.mark.parametrize("w,want", [(1, 1), (SPLIT_WORDS, 1), (SPLIT_WORDS + 1, 2),
                                    (625, 1), (849, 1), (9001, 3), (32768, 8),
                                    (40003, MAX_SPLIT_CTAS), (2 ** 20, MAX_SPLIT_CTAS)])
def test_split_ctas(w, want):
    assert tiles.split_ctas(w) == want


@pytest.mark.parametrize("route", ["rows", "", 1, "Split"])
def test_a_route_outside_the_routes_raises(route):
    rng = np.random.default_rng(0)
    a, m = _t(_words(rng, 1, 3)), _t(_words(rng, 1, 3))[0]
    x = torch.ones((96, 1))
    with pytest.raises(ValueError, match="route"):
        coverage_gain.coverage_gain(a, m, route=route)
    with pytest.raises(ValueError, match="route"):
        bit_matvec.bit_matvec(a, x, route=route)


@pytest.mark.parametrize("route", [None, "warp", "split"])
def test_the_plain_version_ignores_the_route(route):
    rng = np.random.default_rng(1)
    a, m = _t(_words(rng, 3, 5)), _t(_words(rng, 1, 5))[0]
    x = torch.from_numpy(rng.random((160, 2)).astype(np.float32))
    assert torch.equal(coverage_gain.coverage_gain(a, m, route=route),
                       coverage_gain.coverage_gain(a, m))
    assert torch.equal(bit_matvec.bit_matvec(a, x, route=route),
                       bit_matvec.bit_matvec(a, x))


# -- the plain versions at one row against the reference ------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("w", WIDTHS)
def test_coverage_gain_one_row_matches_reference(backend, w):
    rng = np.random.default_rng(w)
    a, mask = _words(rng, 9, w), _words(rng, 1, w)[0]
    ta, tm = _t(a), _t(mask[None])[0]
    for j in ROWS:
        want = jops.coverage_gain(jnp.asarray(a[j][None]), jnp.asarray(mask),
                                  backend=backend)
        got = ops.coverage_gain(ta[j:j + 1], tm)
        assert got.shape == (1,) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("r", [1, 3])
def test_bit_matvec_one_row_exact_on_dyadic_weights(backend, w, r):
    rng = np.random.default_rng(100 + w + r)
    a = _words(rng, 9, w)
    x = (rng.integers(0, 257, size=(w * 32, r)) / 256).astype(np.float32)
    ta = _t(a)
    for j in ROWS:
        want = jops.bit_matvec(jnp.asarray(a[j][None]), jnp.asarray(x), backend=backend)
        got = ops.bit_matvec(ta[j:j + 1], torch.from_numpy(x))
        assert got.shape == (1, r) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("w", WIDTHS)
def test_bit_matvec_one_row_random_weights(backend, w):
    rng = np.random.default_rng(200 + w)
    a = _words(rng, 9, w)
    x = rng.standard_normal((w * 32, 1)).astype(np.float32)
    ta = _t(a)
    for j in ROWS:
        want = jops.bit_matvec(jnp.asarray(a[j][None]), jnp.asarray(x), backend=backend)
        got = ops.bit_matvec(ta[j:j + 1], torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


# -- lazy greedy's exact evaluation ---------------------------------------------

C, WQ, WD = 40, 5, 7
N_QUERIES, N_DOCS = WQ * 32 - 3, WD * 32 - 5


def _problem_arrays(seed):
    rng = np.random.default_rng(seed)
    q = np.packbits(rng.random((C, WQ * 32)) < 0.08, axis=1, bitorder="little")
    d = np.packbits(rng.random((C, WD * 32)) < 0.1, axis=1, bitorder="little")
    q = q.view(np.uint32).copy()
    d = d.view(np.uint32).copy()
    w = np.zeros(WQ * 32, np.float32)
    w[:N_QUERIES] = rng.integers(1, 64, N_QUERIES) / 4096
    t = np.zeros(WQ * 32, np.float32)
    t[:N_QUERIES] = rng.integers(1, 64, N_QUERIES) / 4096
    return q, d, w, t


def _states(q, d, kept):
    cq = np.bitwise_or.reduce(q[kept], axis=0)
    cd = np.bitwise_or.reduce(d[kept], axis=0)
    return cq, cd


def _constraints(kind):
    if kind == "global":
        return jconstraint.GlobalBudget(40.0), constraint.GlobalBudget(40.0)
    bounds = (0, 2, 5, WD)
    caps = [20.0, 30.0, 25.0]
    return (jconstraint.PartitionedBudget(caps=caps, bounds=bounds),
            constraint.PartitionedBudget(caps, bounds))


@pytest.mark.parametrize("kind", ["global", "partitioned"])
@pytest.mark.parametrize("kept", [(), (3,), (0, 7, 19, 33)])
def test_exact_gains_one_matches_reference(kind, kept):
    q, d, w, t = _problem_arrays(7)
    jp = JProblem(clause_query_bits=jnp.asarray(q), clause_doc_bits=jnp.asarray(d),
                  query_weights=jnp.asarray(w), test_weights=jnp.asarray(t),
                  n_queries=N_QUERIES, n_docs=N_DOCS)
    tp = convert.problem_from_numpy(q, d, w, t, N_QUERIES, N_DOCS, device="cpu")
    jc, tc = _constraints(kind)
    cq, cd = _states(q, d, list(kept))
    tcq = convert.state_from_numpy(cq, cd, np.zeros(C, bool), 0.0, 0,
                                   device="cpu")
    x = tp.uncovered_weights(tcq.covered_q)
    for j in range(C):
        want_f, want_g = ref_exact_gains_one(jp, jc, jnp.asarray(cq), jnp.asarray(cd), j)
        got_f, got_g = _exact_gains_one(tp, tc, x, tcq.covered_d, j)
        assert got_f == float(want_f)
        np.testing.assert_array_equal(got_g, np.asarray(want_g, np.float64))
        assert got_g.shape == (1 if kind == "global" else 3,)
