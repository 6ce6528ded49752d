"""Cost-aware greedy for SCSK (paper eq. 13) — dense recompute-all variant.

The port's counterpart of `repro.core.greedy`. Each step evaluates f(j|X)
and g(j|X) for every candidate (one `bit_matvec` launch, and one
`coverage_gain` launch, or one `partition_gain` launch under per-shard
budgets) and adds argmax_{feasible} f(j|X)/g(j|X). Opt/Pes greedy must select
the same sequence (up to exact ties).

Registered as "greedy". Warm-startable: pass the `state` of a previous
`SolverResult` to resume — with `stop_policy="truncate"` the selection path
is budget-independent, so `solve_sweep` resumes across budgets instead of
re-solving from scratch (paper Fig. 3).
"""
from __future__ import annotations

import torch

from repro_torch.core.config import SolveConfig
from repro_torch.core.constraint import as_constraint, resolve_constraint
from repro_torch.core.problem import SCSKProblem, SolverResult
from repro_torch.core.registry import register_solver
from repro_torch.core.state import SolverState
from repro_torch.core.trace import Trace

BIG = 1e12   # ratio stand-in for "free" clauses (g-gain == 0, f-gain > 0)


def ratio_of(fg: torch.Tensor, gg: torch.Tensor) -> torch.Tensor:
    """f/g in f32, with g <= 0 scored as f * BIG (as the reference)."""
    return torch.where(gg <= 0.0, fg * BIG, fg / torch.clamp(gg, min=1e-30))


def greedy_step(problem: SCSKProblem, state: SolverState, budget, *,
                cost_aware: bool = True, truncate: bool = False):
    """One greedy selection over a SolverState.

    `budget` is a scalar knapsack budget or any `KnapsackConstraint` (a
    `PartitionedBudget` masks candidates that overflow any per-shard cap).
    Returns (state, j, stop) with `j` and `stop` read to the host (the one
    sync of the step). `truncate=False` masks the score to feasible
    candidates ("exhaust": classic greedy); `truncate=True` ranks ALL
    unselected candidates and stops at the first infeasible argmax, which
    makes the selection path budget-independent (warm-start sweeps).
    """
    constraint = as_constraint(budget)
    fg = problem.f_gains(state.covered_q)
    gg, gg_part = constraint.gains(problem, state.covered_d)
    used = constraint.used(problem, state)
    candidates = (~state.selected) & (fg > 0.0)
    feasible = candidates & constraint.feasible(used, gg_part)
    score = ratio_of(fg, gg) if cost_aware else fg
    score = torch.where(candidates if truncate else feasible, score,
                        float("-inf"))
    j = torch.argmax(score)      # first maximum; 0 when every score is -inf
    j, stop = torch.stack([j, (~feasible[j]).long()]).tolist()
    if stop:
        return state, j, True
    return problem.apply(state, j), j, False


@register_solver("greedy", supports_state=True, supports_truncate=True,
                 supports_partition=True,
                 description="dense cost-ratio greedy (paper eq. 13)")
def solve_greedy(problem: SCSKProblem, config: SolveConfig,
                 state: SolverState | None = None) -> SolverResult:
    cost_aware = bool(config.opt("cost_aware", True))
    state = problem.init_state() if state is None else state
    trace = Trace(config, f0=float(problem.f_value(state.covered_q)),
                  g0=float(state.g_used))
    constraint = resolve_constraint(problem, config)
    truncate = config.stop_policy == "truncate"
    c = problem.n_clauses

    order: list[int] = []
    steps = config.max_steps or c
    for _ in range(steps):
        state, j, stop = greedy_step(problem, state, constraint,
                                     cost_aware=cost_aware, truncate=truncate)
        trace.add_evals(2 * c)
        if stop:
            break
        order.append(j)
        f_val, g_val = torch.stack(
            [problem.f_value(state.covered_q), state.g_used]).tolist()
        trace.on_select(f_val, g_val)
        if trace.should_stop():
            break
    name = "greedy" if cost_aware else "agnostic-dense"
    return trace.result(name, problem, state, order)
