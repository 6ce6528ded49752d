"""The port's per-shard budgets against the reference's.

`partition_gain` (plain version) against the reference's Pallas body and
XLA path; `partition_bounds`, the traffic allocator and `PartitionedBudget`
arithmetic bit for bit; partitioned greedy / Opt/Pes solves, sweeps and
refits against the reference on `tiny`. As in `test_torch_solvers.py`, the
log's weights are rescaled to counts over a power-of-two denominator so
every f32 sum is exact and the orders must be equal (ROADMAP fault 1).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.cluster import plan_shards
from repro.core import constraint as jconstraint
from repro.kernels import ops as jops
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import bitset, registry
from repro_torch.core import constraint as tconstraint
from repro_torch.core.config import SolveConfig
from repro_torch.kernels import ops

BACKENDS = ["interpret", "xla"]


def dyadic(log):
    """Weights as counts over a power-of-two denominator (exact f32 sums)."""
    for name, n in (("train_weights", log.n_train_samples),
                    ("test_weights", log.n_test_samples)):
        counts = np.rint(getattr(log, name) * n)
        setattr(log, name, counts / 2.0 ** math.ceil(math.log2(n)))


@pytest.fixture(scope="module")
def pipes():
    jp = japi.TieringPipeline.from_synthetic(0, "tiny")
    tp = tapi.TieringPipeline.from_synthetic(0, "tiny", device="cpu")
    dyadic(jp.log)
    dyadic(tp.log)
    return jp.mine(min_support=1e-3), tp.mine(min_support=1e-3)


def _t(words):
    return bitset.to_tensor(words, "cpu")


def _hand_problem(cd_words):
    """Three clauses over three queries, two one-word doc partitions (the
    reference's hand-built cases)."""
    cq = np.zeros((3, 1), np.uint32)
    cq[:, 0] = [0b0001, 0b0010, 0b0100]
    w = np.zeros(32, np.float32)
    w[:3] = [0.5, 0.3, 0.4]
    return convert.problem_from_numpy(cq, np.asarray(cd_words, np.uint32),
                                      w, w, 3, 64, device="cpu")


# -- the kernel's plain version ------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("c,w,parts", [(37, 11, 3), (5, 3, 1), (130, 33, 5),
                                       (64, 8, 8), (13, 7, 3)])
def test_partition_gain_matches_reference(backend, c, w, parts):
    rng = np.random.default_rng(c * 31 + w + parts)
    bounds = jconstraint.partition_bounds(w * 32, parts)
    a = rng.integers(0, 2 ** 32, size=(c, w), dtype=np.uint32)
    a[:, 0] |= np.uint32(0x80000000)          # bit 31 in every row
    m = rng.integers(0, 2 ** 32, size=(w,), dtype=np.uint32)
    want = jops.partition_gain(jnp.asarray(a), jnp.asarray(m), bounds,
                               backend=backend)
    got = ops.partition_gain(_t(a), _t(m), bounds)
    assert got.dtype == torch.int32 and got.shape == (c, len(bounds) - 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.sum(-1).numpy(),
                                  ops.coverage_gain(_t(a), _t(m)).numpy())


def test_partition_gain_checks_bounds():
    a = torch.zeros((2, 4), dtype=torch.int32)
    for bad in [(0, 2), (1, 4), (0, 2, 2, 4), (0,)]:
        with pytest.raises(ValueError, match="bounds"):
            ops.partition_gain(a, a[0], bad)


# -- bounds, allocator, caps ---------------------------------------------------

@pytest.mark.parametrize("n_docs,p", [(200, 2), (200, 4), (33, 4), (1, 3),
                                      (4096, 7), (11 * 32, 3), (2048, 8)])
def test_partition_bounds_match_reference_plan_shards(n_docs, p):
    bounds = tconstraint.partition_bounds(n_docs, p)
    assert bounds == jconstraint.partition_bounds(n_docs, p)
    shards = plan_shards(n_docs, p)
    assert [(s.word_lo, s.word_hi) for s in shards] == list(zip(bounds, bounds[1:]))
    assert tconstraint.partition_capacities(n_docs, bounds) == \
        jconstraint.partition_capacities(n_docs, bounds) == \
        [s.n_docs for s in shards]


@pytest.mark.parametrize("shards,weights,total", [
    ([100, 100, 100], [0.5, 0.3, 0.2], 90),
    ([10, 100, 100], [0.9, 0.05, 0.05], 90),
    ([10, 10, 100], [1.0, 0.0, 0.0], 60),
    ([64, 64, 32, 7], [0.1, 0.2, 0.3, 0.4], 100.7),
    ([5, 5], [0.0, 0.0], 7)])
def test_partition_budgets_match_reference(shards, weights, total):
    assert tapi.partition_budgets(shards, weights, total) == \
        japi.partition_budgets(shards, weights, total)


def test_partition_budgets_refuse_over_capacity():
    with pytest.raises(ValueError, match="capacity"):
        tapi.partition_budgets([10, 10], [0.5, 0.5], 50)


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_shard_traffic_shares_match_reference(pipes, parts):
    jp, tp = pipes
    bounds = tconstraint.partition_bounds(tp.corpus.n_docs, parts)
    w = np.asarray(tp.log.train_weights, np.float64)
    got = tapi.shard_traffic_shares(tp.data.query_doc_bits, w, bounds)
    want = japi.shard_traffic_shares(jp.data.query_doc_bits, w, bounds)
    assert got.tobytes() == np.asarray(want).tobytes()
    zero = tapi.shard_traffic_shares(tp.data.query_doc_bits, 0 * w, bounds)
    np.testing.assert_array_equal(zero, np.full(len(bounds) - 1,
                                                1.0 / (len(bounds) - 1)))


@pytest.mark.parametrize("split", [[0.7 * 1500, 0.3 * 1500],
                                   {0: 61.0, 1: 17.5, 2: 0.1},
                                   [1e7 / 3, 2e7 / 3, 1.0, 2.0]])
def test_partitioned_budget_caps_bit_equal_reference(split):
    n_docs = 1000
    want = jconstraint.PartitionedBudget.from_split(n_docs, split)
    got = tconstraint.PartitionedBudget.from_split(n_docs, split)
    assert got.bounds == want.bounds and got.n_parts == want.n_parts
    assert got.caps.dtype == np.float32
    assert got.caps.tobytes() == np.asarray(want.caps).tobytes()
    assert got.total == want.total
    for new_total in (want.total / 3, 12345.0, 1.0):
        a, b = got.scaled(new_total), want.scaled(new_total)
        assert a.caps.tobytes() == np.asarray(b.caps).tobytes()
        assert a.bounds == b.bounds


def test_partitioned_budget_rejects_bad_splits():
    with pytest.raises(ValueError, match="keys"):
        tconstraint.PartitionedBudget.from_split(1000, {0: 1.0, 2: 1.0})
    with pytest.raises(ValueError, match="postings words"):
        tconstraint.PartitionedBudget.from_split(40, [1.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="ascending"):
        tconstraint.PartitionedBudget(caps=[1.0, 1.0], bounds=(0, 3, 3))
    with pytest.raises(ValueError, match="shape"):
        tconstraint.PartitionedBudget(caps=[1.0], bounds=(0, 3, 5))


def test_g_value_and_gains_per_partition(pipes):
    jp, tp = pipes
    rng = np.random.default_rng(5)
    bounds = tconstraint.partition_bounds(tp.corpus.n_docs, 3)
    cd = rng.integers(0, 2 ** 32, size=(tp.problem.wd,), dtype=np.uint32)
    got = tp.problem.g_value(_t(cd), bounds=bounds)
    want = jp.problem.g_value(jnp.asarray(cd), bounds=bounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.sum()) == float(tp.problem.g_value(_t(cd)))
    gp = tp.problem.g_gains(_t(cd), bounds=bounds)
    assert gp.dtype == torch.float32
    np.testing.assert_array_equal(
        gp.numpy(), np.asarray(jp.problem.g_gains(jnp.asarray(cd), bounds=bounds)))


# -- the two hand-built cases of the reference's tests --------------------------

def test_partition_masks_clause_global_budget_would_admit():
    cd = np.zeros((3, 2), np.uint32)
    cd[0, 0] = 0x000000FF        # 8 docs, partition 0
    cd[1, 1] = 0x000000FF        # 8 docs, partition 1
    cd[2, 0] = 0x0000FF00        # 8 other docs, partition 0
    problem = _hand_problem(cd)
    r_global = registry.solve(problem, SolveConfig(budget=24.0, solver="greedy"))
    assert set(r_global.order) == {0, 1, 2}
    for solver in ("greedy", "optpes"):
        r = registry.solve(problem, SolveConfig(
            budget=24.0, solver=solver, budget_split=[8.0, 16.0]))
        assert r.order == [0, 1]
        np.testing.assert_array_equal(r.extra["g_part"], [8.0, 8.0])
        np.testing.assert_array_equal(r.extra["caps"], [8.0, 16.0])
        assert r.extra["bounds"] == (0, 1, 2)


def test_partitioned_admission_fills_shard_to_exact_cap():
    cd = np.zeros((3, 2), np.uint32)
    cd[0, 0] = 0xFF000000        # 8 docs at word 0's top: partition 0
    cd[1, 1] = 0x00000001        # doc 32, first past the boundary
    cd[2, 0] = 0x00000001        # one more partition-0 doc
    problem = _hand_problem(cd)
    constraint = tconstraint.PartitionedBudget(caps=[8.0, 4.0], bounds=(0, 1, 2))
    state = problem.init_state()

    def offer(j):
        _, g_part = constraint.gains(problem, state.covered_d,
                                     rows=problem.clause_doc_bits[j:j + 1])
        used = constraint.used(problem, state)
        return bool(constraint.feasible(used, g_part)[0]), g_part[0].tolist()

    assert offer(0) == (True, [8.0, 0.0])
    state = problem.apply(state, 0)
    assert constraint.used(problem, state).tolist() == [8.0, 0.0]
    assert constraint.np_value(bitset.to_numpy(state.covered_d)).tolist() == [8.0, 0.0]
    assert offer(2) == (False, [1.0, 0.0])
    assert offer(1) == (True, [0.0, 1.0])
    state = problem.apply(state, 1)
    assert constraint.used(problem, state).tolist() == [8.0, 1.0]


# -- partitioned solves against the reference ------------------------------------

@pytest.mark.parametrize("solver", ["greedy", "optpes"])
@pytest.mark.parametrize("split", ["traffic", "explicit"])
def test_partitioned_solve_matches_reference(pipes, solver, split):
    jp, tp = pipes
    if split == "traffic":
        kw = dict(budget_frac=0.5, budget_split="traffic", n_shards=3)
    else:
        b = float(tp.corpus.n_docs // 2)
        kw = dict(budget_split={0: 0.7 * b, 1: 0.3 * b})
    want = jp.solve(solver, **kw).result
    got = tp.solve(solver, **kw).result
    assert got.order == want.order and len(got.order) > 10
    np.testing.assert_array_equal(got.selected, want.selected)
    assert got.extra["g_part"].tobytes() == want.extra["g_part"].tobytes()
    assert got.extra["caps"].tobytes() == want.extra["caps"].tobytes()
    assert got.extra["bounds"] == want.extra["bounds"]
    assert np.all(got.extra["g_part"] <= got.extra["caps"])
    assert got.g_final == want.g_final and tp.n_partitions == jp.n_partitions
    assert tp.verify()


def test_single_partition_equals_global(pipes):
    _, tp = pipes
    b = float(tp.corpus.n_docs // 2)
    for solver in ("greedy", "optpes"):
        one = registry.solve(tp.problem, SolveConfig(
            budget=b, solver=solver, budget_split=[b]))
        glob = registry.solve(tp.problem, SolveConfig(budget=b, solver=solver))
        assert one.order == glob.order


def test_partitioned_sweep_warm_equals_cold_and_reference(pipes):
    jp, tp = pipes
    n = tp.corpus.n_docs
    budgets = [n // 4, n // 2]
    kw = dict(budget_split="traffic", n_shards=2)
    warm = tp.sweep(budgets, "greedy", **kw)
    ref = jp.sweep(budgets, "greedy", **kw)
    base = tp.config.constraint
    for b, w, r in zip(budgets, warm, ref):
        cold = registry.solve(tp.problem, SolveConfig(
            budget=float(b), solver="greedy", stop_policy="truncate",
            constraint=base.scaled(float(b))))
        assert w.order == cold.order == r.order
        np.testing.assert_array_equal(w.selected, cold.selected)
        assert w.extra["caps"].tobytes() == r.extra["caps"].tobytes()
        assert np.all(w.extra["g_part"] <= w.extra["caps"])


def test_warm_refit_shrunk_caps_matches_reference(pipes):
    """A warm refit onto inverted caps trims the prefix (same clauses as the
    reference drops) and solves to the reference's order."""
    jp, tp = pipes
    b = float(tp.corpus.n_docs // 2)
    first = {0: 0.8 * b, 1: 0.2 * b}
    jprev = jp.solve("greedy", budget_split=first).result
    tprev = tp.solve("greedy", budget_split=first).result
    assert tprev.order == jprev.order and tprev.extra["g_part"][0] > 0.3 * b

    inverted = {0: 0.2 * b, 1: 0.8 * b}
    tight = tconstraint.PartitionedBudget.from_split(tp.corpus.n_docs,
                                                     list(inverted.values()))
    state, dropped = tconstraint.trim_state(tp.problem, tprev.state, tight)
    jstate, jdropped = jconstraint.trim_state(
        jp.problem, jprev.state,
        jconstraint.PartitionedBudget.from_split(jp.corpus.n_docs,
                                                 list(inverted.values())))
    assert len(dropped) > 0
    np.testing.assert_array_equal(dropped, jdropped)
    np.testing.assert_array_equal(state.selected.numpy(),
                                  np.asarray(jstate.selected))
    assert np.all(tight.np_value(bitset.to_numpy(state.covered_d)) <= tight.caps)

    w = np.asarray(tp.log.test_weights, np.float64)
    got = tp.refit(w, state=tprev.state, budget_split=inverted).result
    want = jp.refit(w, state=jprev.state, budget_split=inverted).result
    assert got.order == want.order
    np.testing.assert_array_equal(got.extra["caps"], [0.2 * b, 0.8 * b])
    assert np.all(got.extra["g_part"] <= got.extra["caps"])
    np.testing.assert_array_equal(got.selected, want.selected)


def test_trim_state_is_a_noop_when_caps_fit(pipes):
    _, tp = pipes
    b = float(tp.corpus.n_docs // 2)
    r = registry.solve(tp.problem, SolveConfig(
        budget=b, solver="greedy", budget_split=[0.8 * b, 0.2 * b]))
    fills = r.extra["g_part"]
    loose = tconstraint.PartitionedBudget.from_split(
        tp.corpus.n_docs, [fills[0] + 1, fills[1] + 1])
    same, dropped = tconstraint.trim_state(tp.problem, r.state, loose)
    assert same is r.state and len(dropped) == 0


def test_traffic_refit_reallocates_caps_like_reference(pipes):
    jp, tp = pipes
    kw = dict(budget_frac=0.5, budget_split="traffic", n_shards=2)
    jp.solve("greedy", **kw)
    tp.solve("greedy", **kw)
    w = np.asarray(tp.log.train_weights, np.float64)[::-1].copy()
    got = tp.refit(w, state=tp.result.state).result
    want = jp.refit(w, state=jp.result.state).result
    assert got.extra["caps"].tobytes() == want.extra["caps"].tobytes()
    assert got.extra["caps"].sum() == float(int(tp.corpus.n_docs * 0.5))
    assert got.order == want.order
    assert np.all(got.extra["g_part"] <= got.extra["caps"])
    tp.refit(w, state=None, budget_split=None)
    assert "caps" not in tp.result.extra and tp.n_partitions is None


def test_refit_carries_explicit_constraint(pipes):
    _, tp = pipes
    b = float(tp.corpus.n_docs // 2)
    constraint = tconstraint.PartitionedBudget.from_split(
        tp.corpus.n_docs, [0.6 * b, 0.4 * b])
    tp.solve(config=SolveConfig(budget=b, solver="greedy",
                                constraint=constraint))
    w = np.asarray(tp.log.train_weights, np.float64)
    tp.refit(w, state=None)
    assert tp.config.constraint is constraint
    assert np.all(tp.result.extra["g_part"] <= constraint.caps)
    tp.refit(w, state=None, budget=b / 2)
    np.testing.assert_allclose(tp.config.constraint.caps, constraint.caps / 2)


def test_adopt_selection_installs_a_state(pipes):
    jp, tp = pipes
    tp.solve("greedy", budget_frac=0.5)
    kept = tp.result.order[:5]
    state = tp.problem.state_for(kept)
    tp.adopt_selection(state)
    assert tp.result.selected.sum() == 5 and tp.result.g_final == float(state.g_used)
    assert tp.verify()
    jp.solve("greedy", budget_frac=0.5)
    jp.adopt_selection(jp.problem.state_for(kept))
    assert tp.coverage() == jp.coverage()


def test_explicit_caps_conflicting_budget_raises(pipes):
    _, tp = pipes
    with pytest.raises(ValueError, match="pass one or the other"):
        tp.solve("greedy", budget=30.0, budget_split={0: 60.0, 1: 40.0})
    with pytest.raises(ValueError, match="n_shards"):
        tp.solve("greedy", budget_split=[1.0, 2.0], n_shards=3)
    tp.solve("greedy", budget=100.0, budget_split={0: 60.0, 1: 40.0})
    assert tp.n_partitions == 2
