"""Stochastic greedy: minibatch f-gain estimates (paper §3.2's "stochastic
version [15]" — Karimi et al. 2017 style).

The port's counterpart of `repro.core.stochastic`. Each round estimates
f(j|X) from a weighted minibatch of queries (sampled from the empirical
distribution) while the cost g(j|X) stays exact (the constraint must never
be violated). The final objective is reported exactly.

The minibatches are drawn on the host with numpy's
`default_rng(config.seed)`, exactly as the reference draws them, so one seed
gives the same minibatches in both packages. With `batch_queries` a power
of two every minibatch weight `count / m` is dyadic and every minibatch
f-gain is exact in any summation order.

Registered as "stochastic"; minibatch size via
`options={"batch_queries": m}`, RNG via `config.seed`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.config import SolveConfig
from repro_torch.core.constraint import resolve_constraint
from repro_torch.core.greedy import ratio_of
from repro_torch.core.problem import SCSKProblem, SolverResult
from repro_torch.core.registry import register_solver
from repro_torch.core.state import SolverState
from repro_torch.core.trace import Trace


def stochastic_step(problem: SCSKProblem, state: SolverState, constraint,
                    w_mb: torch.Tensor):
    """One selection on minibatch f-gains and exact g-gains. Returns (state,
    j, stop) with `j` and `stop` read to the host in one transfer."""
    fg = problem.f_gains(state.covered_q, weights=w_mb)   # minibatch estimate
    gg, gg_part = constraint.gains(problem, state.covered_d)  # exact cost
    used = constraint.used(problem, state)
    feasible = (~state.selected) & constraint.feasible(used, gg_part) \
        & (fg > 0.0)
    score = torch.where(feasible, ratio_of(fg, gg), float("-inf"))
    j = torch.argmax(score)
    j, stop = torch.stack([j, (~feasible[j]).long()]).tolist()
    if stop:
        return state, j, True
    return problem.apply(state, j), j, False


@register_solver("stochastic", supports_state=True, supports_partition=True,
                 description="minibatch-f greedy (§3.2, Karimi-style)")
def solve_stochastic(problem: SCSKProblem, config: SolveConfig,
                     state: SolverState | None = None) -> SolverResult:
    batch_queries = int(config.opt("batch_queries", 2048))
    rng = np.random.default_rng(config.seed)
    w_full = problem.query_weights.cpu().numpy().astype(np.float64)
    probs = w_full / w_full.sum()
    n = len(probs)

    state = problem.init_state() if state is None else state
    constraint = resolve_constraint(problem, config)
    trace = Trace(config, f0=float(problem.f_value(state.covered_q)),
                  g0=float(state.g_used))
    order: list[int] = []

    for _ in range(config.max_steps or problem.n_clauses):
        idx = rng.choice(n, size=batch_queries, p=probs)
        counts = np.bincount(idx, minlength=n).astype(np.float32)
        w_mb = torch.from_numpy(counts / batch_queries).to(problem.device)
        state, j, stop = stochastic_step(problem, state, constraint, w_mb)
        if stop:
            break
        order.append(j)
        # exact reporting (the minibatch only drives selection)
        f_val, g_val = torch.stack(
            [problem.f_value(state.covered_q), state.g_used]).tolist()
        trace.on_select(f_val, g_val)
        if trace.should_stop():
            break

    trace.add_evals(2 * problem.n_clauses * max(1, len(order)))
    return trace.result(f"stochastic-greedy-m{batch_queries}",
                        problem, state, order)
