"""The port's lazy greedy (Alg. 1), constraint-agnostic greedy (§5.1) and
ISK (Alg. 3) against the reference's.

Both packages mine the same seeded log, its weights rescaled to counts over
a power-of-two denominator (`dyadic`, as in `test_torch_solvers.py`), so
every f32 sum is exact in any order and the orders must be equal (ROADMAP
fault 1). Lazy greedy ranks with float64 ratios on the host and dense
greedy with f32 ratios on the device; on these weights they must agree too.
ISK at `small` runs two outer iterations in both packages (the default
ten at `tiny`).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.isk import _coverage_counts as ref_coverage_counts
from repro.core.isk import _or_except_one as ref_or_except_one
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import bitset, isk, registry
from repro_torch.core.config import SolveConfig

SOLVERS = ["lazy", "agnostic", "isk1", "isk2"]


def dyadic(log):
    """Weights as counts over a power-of-two denominator (exact f32 sums)."""
    for name, n in (("train_weights", log.n_train_samples),
                    ("test_weights", log.n_test_samples)):
        counts = np.rint(getattr(log, name) * n)
        setattr(log, name, counts / 2.0 ** math.ceil(math.log2(n)))


_PIPES: dict = {}
_RESULTS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its CPU solves are long chains
    of small tensor ops, where more threads cost more CPU than they save
    and take cores from the test run's other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pipes(scale):
    """(scale, reference pipeline, port pipeline), mined once per module."""
    if scale not in _PIPES:
        jp = japi.TieringPipeline.from_synthetic(0, scale)
        tp = tapi.TieringPipeline.from_synthetic(0, scale, device="cpu")
        dyadic(jp.log)
        dyadic(tp.log)
        _PIPES[scale] = (scale, jp.mine(min_support=1e-3),
                         tp.mine(min_support=1e-3))
    return _PIPES[scale]


@pytest.fixture(scope="module", params=["tiny", "small"])
def pipes(request):
    return _pipes(request.param)


@pytest.fixture(scope="module")
def tiny():
    return _pipes("tiny")


def _options(scale, solver):
    return {"max_outer": 2} if scale == "small" and solver.startswith("isk") \
        else {}


def _solved(pipes, solver):
    """(reference, port) results of one solve at budget_frac 0.5, once per
    module."""
    scale, jp, tp = pipes
    key = (scale, solver)
    if key not in _RESULTS:
        kw = _options(scale, solver)
        _RESULTS[key] = (jp.solve(solver, budget_frac=0.5, **kw).result,
                         tp.solve(solver, budget_frac=0.5, **kw).result)
    return _RESULTS[key]


@pytest.mark.parametrize("solver", SOLVERS)
def test_solver_matches_reference(pipes, solver):
    want, got = _solved(pipes, solver)
    assert got.name == want.name
    assert got.order == want.order and len(got.order) > 10
    np.testing.assert_array_equal(got.selected, want.selected)
    assert got.g_final == want.g_final
    np.testing.assert_allclose(got.f_final, want.f_final, rtol=1e-6)
    assert got.n_exact_evals == want.n_exact_evals
    np.testing.assert_array_equal(got.g_history, want.g_history)
    np.testing.assert_allclose(got.f_history, want.f_history, rtol=1e-6)


def test_lazy_equals_port_greedy_with_fewer_evaluations(pipes):
    lazy = _solved(pipes, "lazy")[1]
    greedy = _solved(pipes, "greedy")[1]
    assert lazy.order == greedy.order
    assert lazy.f_final == greedy.f_final and lazy.g_final == greedy.g_final
    assert lazy.n_exact_evals < greedy.n_exact_evals


def test_paper_orderings_and_feasibility(pipes):
    """§5.1: greedy beats agnostic; every ISK history point fits B."""
    _, _, tp = pipes
    budget = float(int(tp.corpus.n_docs * 0.5))
    greedy = _solved(pipes, "greedy")[1]
    assert greedy.f_final > _solved(pipes, "agnostic")[1].f_final
    for name in ("isk1", "isk2"):
        r = _solved(pipes, name)[1]
        assert np.all(r.g_history <= budget)
        st = tp.problem.state_for(r.order)
        assert float(st.g_used) == r.g_final <= budget


def test_lazy_warm_start_continues_like_the_reference(tiny):
    """A lazy solve resumed from a 10-step prefix: equal to the cold solve,
    and to the reference resumed from the same (converted) state."""
    _, jp, tp = tiny
    budget = float(int(tp.corpus.n_docs * 0.5))
    cfg = SolveConfig(budget=budget, solver="lazy")
    full = _solved(tiny, "lazy")[1]
    head = registry.solve(tp.problem, cfg.replace(max_steps=10))
    tail = registry.solve(tp.problem, cfg, state=head.state)
    assert head.order + tail.order == full.order
    assert not head.state.selected[full.order[10]]   # the state was not mutated
    jhead = japi.solve(jp.problem, japi.SolveConfig(budget=budget,
                                                    solver="lazy",
                                                    max_steps=10))
    s = jhead.state
    state = convert.state_from_numpy(
        np.asarray(s.covered_q), np.asarray(s.covered_d),
        np.asarray(s.selected), float(s.g_used), int(s.step), device="cpu")
    want = japi.solve(jp.problem, japi.SolveConfig(budget=budget,
                                                   solver="lazy"), state=s)
    # the port's 10-step state is the reference's, so its tail is too
    for name in ("covered_q", "covered_d", "selected", "g_used"):
        assert torch.equal(getattr(head.state, name), getattr(state, name))
    assert tail.order == want.order
    assert tail.n_exact_evals == want.n_exact_evals
    assert tail.state.step == int(want.state.step)


@pytest.mark.parametrize("n_shards", [4])
def test_lazy_under_partitioned_budget(tiny, n_shards):
    """Lazy under traffic-split per-shard caps: the reference's order, caps
    and fills, the port's greedy's order, every fill within its cap."""
    _, jp, tp = tiny
    kw = dict(budget_frac=0.5, budget_split="traffic", n_shards=n_shards)
    want = jp.solve("lazy", **kw).result
    got = tp.solve("lazy", **kw).result
    greedy = tp.solve("greedy", **kw).result
    assert got.order == want.order == greedy.order
    np.testing.assert_array_equal(got.extra["caps"], want.extra["caps"])
    np.testing.assert_array_equal(got.extra["g_part"], want.extra["g_part"])
    assert np.all(got.extra["g_part"] <= got.extra["caps"])
    assert got.n_exact_evals == want.n_exact_evals < greedy.n_exact_evals


@pytest.mark.parametrize("t,w", [(1, 3), (2, 5), (7, 9), (64, 4)])
def test_or_except_one_matches_reference(t, w):
    rng = np.random.default_rng(t * 10 + w)
    rows = rng.integers(0, 2 ** 32, size=(t, w), dtype=np.uint32)
    rows &= rng.integers(0, 2 ** 32, size=(t, w), dtype=np.uint32)
    want = np.asarray(ref_or_except_one(jnp.asarray(rows)))
    got = bitset.to_numpy(isk._or_except_one(bitset.to_tensor(rows, "cpu")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c,w", [(1, 1), (5, 3), (130, 9), (300, 2)])
def test_coverage_counts_matches_reference(c, w, monkeypatch):
    rng = np.random.default_rng(c + w)
    rows = rng.integers(0, 2 ** 32, size=(c, w), dtype=np.uint32)
    rows[:, -1] |= np.uint32(0x80000000)           # bit 31 of the last word
    want = np.asarray(ref_coverage_counts(jnp.asarray(rows)))
    # blocks of 7 rows, so the block loop runs with a ragged last block
    monkeypatch.setattr(isk, "CHUNK_BYTES", 7 * w * 32 * 4)
    got = isk._coverage_counts(bitset.to_tensor(rows, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_f_gains_with_doc_length_weights(tiny):
    """ISK2's use of `f_gains(weights=)`: the weights lie in the doc space
    (Wd*32 long, not Wq*32), over the clause-doc rows."""
    _, jp, tp = tiny
    wd = tp.problem.wd
    rng = np.random.default_rng(3)
    w = (rng.integers(0, 5, size=wd * 32) / 8.0).astype(np.float32)
    covered = rng.integers(0, 2 ** 32, size=wd, dtype=np.uint32)
    want = jp.problem.f_gains(jnp.asarray(covered),
                              rows=jp.problem.clause_doc_bits,
                              weights=jnp.asarray(w))
    got = tp.problem.f_gains(bitset.to_tensor(covered, "cpu"),
                             rows=tp.problem.clause_doc_bits,
                             weights=torch.from_numpy(w))
    assert got.shape == (tp.problem.n_clauses,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vw = tp.problem.f_value(bitset.to_tensor(covered, "cpu"),
                            weights=torch.from_numpy(w))
    assert float(vw) == float(jp.problem.f_value(jnp.asarray(covered),
                                                 weights=jnp.asarray(w)))


def test_isk_refuses_warm_starts(tiny):
    _, _, tp = tiny
    with pytest.raises(ValueError, match="warm"):
        registry.solve(tp.problem, SolveConfig(budget=10.0, solver="isk1"),
                       state=tp.problem.init_state())
