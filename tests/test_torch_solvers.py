"""The port's greedy and Opt/Pes solvers against the reference's.

Both packages mine the same seeded log. Its empirical weights are counts
over n samples; here they are rescaled to counts over the next power of two
(a constant factor, so the same optimisation problem) so that every f32 sum
of weights is exact in any order. Without that, clauses whose f/g ratios
differ by less than one f32 ulp are ordered by rounding noise, which
differs between any two summation orders (the reference's own FP32 sums are
not correctly rounded either; see ROADMAP "Faults found"). With it, the
orders must be equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import greedy as tgreedy
from repro_torch.core import optpes as toptpes
from repro_torch.core import registry
from repro_torch.core.config import SolveConfig


def dyadic(log):
    """Weights as counts over a power-of-two denominator (exact f32 sums)."""
    for name, n in (("train_weights", log.n_train_samples),
                    ("test_weights", log.n_test_samples)):
        counts = np.rint(getattr(log, name) * n)
        setattr(log, name, counts / 2.0 ** math.ceil(math.log2(n)))


@pytest.fixture(scope="module", params=["tiny", "small"])
def pipes(request):
    jp = japi.TieringPipeline.from_synthetic(0, request.param)
    tp = tapi.TieringPipeline.from_synthetic(0, request.param, device="cpu")
    dyadic(jp.log)
    dyadic(tp.log)
    return jp.mine(min_support=1e-3), tp.mine(min_support=1e-3)


@pytest.mark.parametrize("solver", ["greedy", "optpes"])
def test_solver_matches_reference(pipes, solver):
    jp, tp = pipes
    want = jp.solve(solver, budget_frac=0.5).result
    got = tp.solve(solver, budget_frac=0.5).result
    assert got.name == want.name
    assert got.order == want.order and len(got.order) > 10
    np.testing.assert_array_equal(got.selected, want.selected)
    assert got.g_final == want.g_final
    np.testing.assert_allclose(got.f_final, want.f_final, rtol=1e-6)
    assert got.n_exact_evals == want.n_exact_evals


def test_sweep_warm_equals_cold_and_reference(pipes):
    jp, tp = pipes
    n = tp.corpus.n_docs
    budgets = [n // 4, n // 2]
    warm = tp.sweep(budgets, "greedy")
    ref = jp.sweep(budgets, "greedy")
    for b, w, r in zip(budgets, warm, ref):
        cold = registry.solve(tp.problem, SolveConfig(
            budget=float(b), solver="greedy", stop_policy="truncate"))
        assert w.order == cold.order == r.order
        np.testing.assert_array_equal(w.selected, cold.selected)
        assert w.g_final == cold.g_final == r.g_final
        np.testing.assert_allclose(w.f_final, cold.f_final, rtol=1e-6)


def test_converted_problem_and_warm_state_continue_the_reference(pipes):
    """convert.* carries a reference problem and a mid-solve state across;
    the port resumes exactly where the reference would have gone."""
    jp, _ = pipes
    jprob = jp.problem
    prob = convert.problem_from_numpy(
        np.asarray(jprob.clause_query_bits), np.asarray(jprob.clause_doc_bits),
        np.asarray(jprob.query_weights), np.asarray(jprob.test_weights),
        jprob.n_queries, jprob.n_docs, device="cpu")
    budget = float(int(jprob.n_docs * 0.5))
    full = japi.solve(jprob, japi.SolveConfig(budget=budget, solver="greedy"))
    head = japi.solve(jprob, japi.SolveConfig(budget=budget, solver="greedy",
                                              max_steps=10))
    s = head.state
    state = convert.state_from_numpy(
        np.asarray(s.covered_q), np.asarray(s.covered_d),
        np.asarray(s.selected), float(s.g_used), int(s.step), device="cpu")
    for solver in ("greedy", "optpes"):
        want = japi.solve(jprob, japi.SolveConfig(budget=budget, solver=solver),
                          state=s)
        tail = registry.solve(prob, SolveConfig(budget=budget, solver=solver),
                              state=state)
        assert tail.order == want.order and tail.g_final == want.g_final
    assert head.order + registry.solve(
        prob, SolveConfig(budget=budget, solver="greedy"), state=state
    ).order == full.order
    assert not state.selected[full.order[10]]          # the state was not mutated


def test_state_for_matches_reference(pipes):
    jp, tp = pipes
    kept = np.arange(0, tp.problem.n_clauses, 7)
    js, ts = jp.problem.state_for(kept), tp.problem.state_for(kept)
    for name in ("covered_q", "covered_d"):
        assert getattr(ts, name).numpy().view(np.uint32).tobytes() == \
            np.asarray(getattr(js, name)).tobytes()
    np.testing.assert_array_equal(ts.selected.numpy(), np.asarray(js.selected))
    assert float(ts.g_used) == float(js.g_used) and ts.step == int(js.step)


def test_top_k_ties_break_by_lower_index_like_lax():
    v = np.array([1.0, 3.0, 3.0, -np.inf, 2.0, 3.0, 2.0, -np.inf], np.float32)
    for k in (1, 3, 5, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(v), k)
        tv, ti = toptpes.top_k_stable(torch.from_numpy(v), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_greedy_step_with_no_candidate_stops_at_index_zero(pipes):
    _, tp = pipes
    prob = tp.problem
    full = prob.state_for(np.arange(prob.n_clauses))
    state, j, stop = tgreedy.greedy_step(prob, full, 1e9)
    assert (j, stop) == (0, True) and state is full


def test_partitioned_budgets_are_refused(pipes):
    """Per-shard budgets are refused where they cannot be honoured: an
    unresolved "traffic" split at the registry level, and a solver that
    does not mask per-partition caps."""
    _, tp = pipes
    with pytest.raises(ValueError, match="traffic"):
        registry.solve(tp.problem, SolveConfig(
            budget=100.0, solver="greedy", budget_split="traffic"))

    @registry.register_solver("no-partition", supports_state=True)
    def _solve(problem, config, state=None):
        raise AssertionError("must be refused before it runs")

    try:
        with pytest.raises(ValueError, match="partitioned"):
            registry.solve(tp.problem, SolveConfig(
                budget=100.0, solver="no-partition", budget_split=[50.0, 50.0]))
    finally:
        del registry._REGISTRY["no-partition"]
    with pytest.raises(KeyError):
        registry.get_solver("lazy")
