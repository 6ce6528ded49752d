"""The port's stochastic greedy (§3.2), flow baselines (§2.3/§5.2), solver
registry and multi-tier builder (§6) against the reference's.

Both packages mine the same seeded log with `dyadic` weights (counts over a
power-of-two denominator, ROADMAP fault 1). Stochastic greedy draws its
minibatches with numpy from the same seed in both packages, and with
`batch_queries` a power of two every minibatch weight is dyadic too, so the
orders must be equal. popularity and flow-max are numpy in both: equal.
flow-sgd's logits are float32 SGD (`jax.grad` against `torch.autograd`):
allclose, and the Tier-1 doc sets may differ only among docs whose logits
lie within that tolerance of the budget's boundary.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import flow as jflow
from repro.core import multitier as jmultitier
from repro_torch import api as tapi
from repro_torch.core import multitier, registry
from repro_torch.core.config import SolveConfig

# flow-sgd: 120 float32 SGD steps; the logits are held to this
SGD_RTOL, SGD_ATOL = 1e-4, 1e-5


def dyadic(log):
    """Weights as counts over a power-of-two denominator (exact f32 sums)."""
    for name, n in (("train_weights", log.n_train_samples),
                    ("test_weights", log.n_test_samples)):
        counts = np.rint(getattr(log, name) * n)
        setattr(log, name, counts / 2.0 ** math.ceil(math.log2(n)))


_PIPES: dict = {}


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
    if scale not in _PIPES:
        jp = japi.TieringPipeline.from_synthetic(0, scale)
        tp = tapi.TieringPipeline.from_synthetic(0, scale, device="cpu")
        dyadic(jp.log)
        dyadic(tp.log)
        _PIPES[scale] = (jp.mine(min_support=1e-3), tp.mine(min_support=1e-3))
    return _PIPES[scale]


@pytest.fixture(scope="module", params=["tiny", "small"])
def pipes(request):
    return _pipes(request.param)


@pytest.fixture(scope="module")
def tiny():
    return _pipes("tiny")


# -- stochastic greedy ---------------------------------------------------------

@pytest.mark.parametrize("scale,m", [("tiny", 512), ("tiny", 2048),
                                     ("small", 2048)])
def test_stochastic_matches_reference(scale, m):
    jp, tp = _pipes(scale)
    want = jp.solve("stochastic", budget_frac=0.5, batch_queries=m,
                    seed=3).result
    got = tp.solve("stochastic", budget_frac=0.5, batch_queries=m,
                   seed=3).result
    assert got.name == want.name == f"stochastic-greedy-m{m}"
    assert got.order == want.order and len(got.order) > 10
    np.testing.assert_array_equal(got.selected, want.selected)
    assert got.g_final == want.g_final <= float(int(tp.corpus.n_docs * 0.5))
    np.testing.assert_allclose(got.f_final, want.f_final, rtol=1e-6)
    assert got.n_exact_evals == want.n_exact_evals


def test_stochastic_under_partitioned_budget(tiny):
    jp, tp = tiny
    kw = dict(budget_frac=0.5, budget_split="traffic", n_shards=3,
              batch_queries=1024)
    want = jp.solve("stochastic", **kw).result
    got = tp.solve("stochastic", **kw).result
    assert got.order == want.order
    np.testing.assert_array_equal(got.extra["g_part"], want.extra["g_part"])
    assert np.all(got.extra["g_part"] <= got.extra["caps"])


# -- flow baselines -------------------------------------------------------------

@pytest.mark.parametrize("solver", ["flow-popularity", "flow-max"])
def test_numpy_flow_baselines_equal_reference(pipes, solver):
    jp, tp = pipes
    want = jp.solve(solver, budget_frac=0.5).result
    got = tp.solve(solver, budget_frac=0.5).result
    assert got.name == want.name and got.order == want.order == []
    for key in ("tier1_docs", "eligible_queries"):
        np.testing.assert_array_equal(got.extra[key], want.extra[key])
    assert got.f_final == want.f_final
    assert got.g_final == want.g_final
    assert got.extra["test_coverage"] == want.extra["test_coverage"]


def _reference_theta(data, budget, *, steps, batch, seed, lam=0.0, lr=0.5,
                     tau=0.05, mu=10.0):
    """The reference flow-sgd's logits, by its own loop and step."""
    w = data.log.train_weights.copy()
    w[w < lam] = 0.0
    keep = np.nonzero(w > 0)[0]
    probs = w[keep] / w[keep].sum()
    rng = np.random.default_rng(seed)
    theta = jnp.zeros(data.n_docs, jnp.float32)
    q_bits_all = jnp.asarray(data.query_doc_bits)
    for _ in range(steps):
        idx = keep[rng.choice(len(keep), size=min(batch, len(keep)), p=probs)]
        theta = jflow._sgd_step(theta, q_bits_all[idx],
                                jnp.ones(len(idx), jnp.float32) / len(idx),
                                jnp.float32(budget), jnp.float32(lr),
                                jnp.float32(tau), jnp.float32(mu),
                                data.n_docs)
    return np.asarray(theta, np.float64)


@pytest.mark.parametrize("lam", [0.0, 1e-4])
def test_flow_sgd_logits_allclose_and_tier1_up_to_boundary_ties(tiny, lam):
    jp, tp = tiny
    budget = tp.corpus.n_docs // 2
    kw = dict(steps=120, batch=128, seed=0, lam=lam)
    want = jp.solve("flow-sgd", budget=budget, **kw).result
    got = tp.solve("flow-sgd", budget=budget, **kw).result
    theta = got.extra["flow"].doc_scores
    np.testing.assert_allclose(
        theta, _reference_theta(jp.data, budget, steps=120, batch=128,
                                seed=0, lam=lam),
        rtol=SGD_RTOL, atol=SGD_ATOL)
    t1, r1 = got.extra["tier1_docs"], want.extra["tier1_docs"]
    assert t1.sum() == r1.sum() <= budget
    cut = np.sort(theta)[::-1][budget - 1]          # the budget's boundary
    differ = np.nonzero(t1 != r1)[0]
    assert np.all(np.abs(theta[differ] - cut)
                  <= SGD_ATOL + SGD_RTOL * abs(cut)), differ
    # ψ^flow never reaches a query unseen in training (the paper's point)
    novel = tp.data.log.train_weights == 0
    assert not np.any(got.extra["eligible_queries"] & novel)
    if not len(differ):
        np.testing.assert_array_equal(got.extra["eligible_queries"],
                                      want.extra["eligible_queries"])
        assert got.f_final == want.f_final


def test_flow_adapter_takes_data_from_options(tiny):
    jp, tp = tiny
    budget = float(tp.corpus.n_docs // 3)
    got = registry.solve(tp.problem, SolveConfig(
        budget=budget, solver="flow-max", options={"data": tp.data}))
    want = japi.solve(jp.problem, japi.SolveConfig(
        budget=budget, solver="flow-max", options={"data": jp.data}))
    np.testing.assert_array_equal(got.extra["tier1_docs"],
                                  want.extra["tier1_docs"])
    with pytest.raises(ValueError, match="TieringData"):
        registry.solve(tp.problem, SolveConfig(budget=budget,
                                               solver="flow-max"))


# -- the registry and the pipeline ----------------------------------------------

def test_registry_round_trip_of_every_name():
    names = japi.list_solvers()
    assert tapi.list_solvers() == names and len(names) == 10
    for needs in (True, False):
        assert tapi.list_solvers(needs_data=needs) == \
            japi.list_solvers(needs_data=needs)
    for name in names:
        got, want = tapi.get_solver(name), japi.get_solver(name)
        assert got.name == want.name == name
        for flag in ("supports_state", "supports_truncate",
                     "supports_partition", "needs_data", "description"):
            assert getattr(got, flag) == getattr(want, flag), (name, flag)
        assert callable(got)


def test_pipeline_flow_solve_refuses_to_deploy(tiny):
    jp, tp = tiny
    want = jp.solve("flow-popularity", budget_frac=0.5).result
    got = tp.solve("flow-popularity", budget_frac=0.5).result
    assert got.f_final == want.f_final
    assert got.extra["flow"].name == "popularity"
    with pytest.raises(RuntimeError, match="flow baseline"):
        tp.tiering()
    with pytest.raises(RuntimeError, match="flow baseline"):
        tp.deploy()
    with pytest.raises(ValueError, match="SCSK solver"):
        tp.refit(tp.log.test_weights)
    tp.solve("greedy", budget_frac=0.5)          # the pipeline goes on as usual
    assert tp.verify()


# -- multi-tier ------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["optpes", "greedy"])
def test_multitier_matches_reference(tiny, solver):
    jp, tp = tiny
    n = tp.corpus.n_docs
    budgets = [n // 8, n // 4, n // 2]
    want = jmultitier.build_multitier(jp.data, budgets, solver=solver)
    got = multitier.build_multitier(tp.data, budgets, solver=solver,
                                    device="cpu")
    assert multitier.verify_multitier(got, tp.data)
    assert jmultitier.verify_multitier(want, jp.data)
    for a, b in zip(got.tier_docs, want.tier_docs):
        np.testing.assert_array_equal(a, b)
    for ga, wa in zip(got.tiers, want.tiers):
        assert ga.clauses == wa.clauses
    qb = tp.data.log.query_bits
    np.testing.assert_array_equal(got.route(qb), want.route(qb))
    w = tp.data.log.test_weights
    assert got.coverage(qb, w) == want.coverage(qb, w)
    assert got.expected_cost(qb, w) == want.expected_cost(qb, w) < 1.0
    for docs, b in zip(got.tier_docs, budgets):
        assert docs.sum() <= b


def test_multitier_with_a_callable_solver_on_reweighted_traffic(tiny):
    """A `(problem, budget)` callable solving reweighted traffic: still
    nested and Theorem-3.1-exact."""
    _, tp = tiny
    rng = np.random.default_rng(7)
    w2 = tp.log.train_weights * rng.uniform(0.05, 1.0, tp.log.n_queries)
    w2 = w2 / w2.sum()

    def reweighted(problem, budget):
        return registry.solve(problem.with_weights(w2),
                              SolveConfig(budget=float(budget)))

    n = tp.corpus.n_docs
    mt = multitier.build_multitier(tp.data, [n // 4, n // 2],
                                   solver=reweighted, device="cpu")
    assert multitier.verify_multitier(mt, tp.data)
    assert mt.expected_cost(tp.data.log.query_bits, w2) < 1.0
