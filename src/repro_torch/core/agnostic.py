"""Constraint-Agnostic Greedy (Iyer & Bilmes 2013) — the paper's baseline.

The port's counterpart of `repro.core.agnostic`. Scores candidates by
f-gain only (the cost g never enters the comparison), with a classic lazy
heap [Minoux 1978]. Feasibility of the popped winner is still enforced
(g(X ∪ {j}) <= B), as the paper's §5.1 describes: "much faster ...
because it ignores the constraint in the selection process, [but]
converges to a clearly suboptimal solution".

Registered as "agnostic".
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core.config import SolveConfig
from repro_torch.core.constraint import resolve_constraint
from repro_torch.core.lazy_greedy import _exact_gains_one, _singleton_gains
from repro_torch.core.problem import SCSKProblem, SolverResult
from repro_torch.core.registry import register_solver
from repro_torch.core.state import SolverState
from repro_torch.core.trace import Trace


@register_solver("agnostic", supports_state=True,
                 description="f-gain-only lazy greedy baseline (§5.1)")
def solve_agnostic(problem: SCSKProblem, config: SolveConfig,
                   state: SolverState | None = None) -> SolverResult:
    c = problem.n_clauses
    state = problem.init_state() if state is None else state
    covered_q, covered_d = state.covered_q, state.covered_d
    budget = config.budget
    constraint = resolve_constraint(problem, config)

    fbar, _ = _singleton_gains(problem, constraint, covered_q, covered_d)

    selected = state.selected.cpu().numpy().copy()
    order: list[int] = []
    g_used = float(state.g_used)
    f_val = float(problem.f_value(covered_q))
    trace = Trace(config, f0=f_val, g0=g_used)
    trace.add_evals(2 * c)

    cand = np.nonzero((fbar > 0) & ~selected)[0]
    heap = list(zip((-fbar[cand]).tolist(), cand.tolist()))
    heapq.heapify(heap)
    steps = config.max_steps or c
    for _ in range(steps):
        x = problem.uncovered_weights(covered_q)     # fixed for this selection
        chosen = -1
        while heap:
            _, j = heapq.heappop(heap)
            if selected[j]:
                continue
            fbar[j], gg_part = _exact_gains_one(problem, constraint, x,
                                                covered_d, j)
            trace.add_evals(2)
            if fbar[j] <= 0:
                continue
            if g_used + float(gg_part.sum()) > budget:
                continue                      # infeasible winner: drop
            if not heap or fbar[j] >= -heap[0][0]:
                chosen = j
                break
            heapq.heappush(heap, (-fbar[j], j))
        if chosen < 0:
            break
        covered_q, covered_d = problem.add_clause(covered_q, covered_d, chosen)
        selected[chosen] = True
        order.append(chosen)
        f_val += fbar[chosen]
        g_used = float(problem.g_value(covered_d))
        trace.on_select(f_val, g_used)
        if trace.should_stop():
            break

    final = SolverState(
        covered_q=covered_q, covered_d=covered_d,
        selected=torch.from_numpy(selected).to(problem.device),
        g_used=torch.tensor(g_used, dtype=torch.float32, device=problem.device),
        step=state.step + len(order))
    return trace.result("constraint-agnostic", problem, final, order)
