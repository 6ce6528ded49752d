"""Lazy Greedy for SCSK — paper Algorithm 1, host-heap version.

The port's counterpart of `repro.core.lazy_greedy`. Keeps a max-heap keyed
by the optimistic ratio f̄(j|X)/g̲(j|X) where
  f̄ : stale (upper-bound, by submodularity of f) marginal f-gains
  g̲ : lower bound of the g-gain maintained with the paper's update rule
      (eq. 14), proven correct in Theorem 4.1:
          g̲(j|X^{t+1}) = max(0, g̲(j|X^t) − g(j^{(t)}|X^t))

Only heap-top candidates get an exact re-evaluation: one one-row
`bit_matvec` and one one-row `coverage_gain` (per-shard budgets:
`partition_gain`) launch, read to the host in one transfer. The count of
exact oracle calls, `n_exact_evals`, is the laziness metric of Figs. 2/4.
The selected sequence equals dense greedy's up to f32 ties (the ratios here
are float64 on the host, greedy's f32 on the device).

The knapsack side is a pluggable `KnapsackConstraint`: every g̲ bound is a
per-partition vector (each g_k is submodular, so eq. 14 holds
coordinatewise) and feasibility masks candidates whose optimistic cost
overflows any partition cap.

Registered as "lazy". Warm-startable: resuming re-seeds the bounds with
exact singleton gains at the resumed state.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core.config import SolveConfig
from repro_torch.core.constraint import resolve_constraint
from repro_torch.core.greedy import BIG
from repro_torch.core.problem import SCSKProblem, SolverResult
from repro_torch.core.registry import register_solver
from repro_torch.core.state import SolverState
from repro_torch.core.trace import Trace
from repro_torch.kernels import ops


def _exact_gains_one(problem: SCSKProblem, constraint, x: torch.Tensor,
                     covered_d: torch.Tensor, j: int) -> tuple[float, np.ndarray]:
    """Exact f(j|X) and g_k(j|X) of one clause, read to the host in one
    transfer. `x` is `problem.uncovered_weights(covered_q)`, which does not
    change within a selection."""
    fg = ops.bit_matvec(problem.clause_query_bits[j:j + 1], x[:, None])[0]
    _, gg_part = constraint.gains(problem, covered_d,
                                  rows=problem.clause_doc_bits[j:j + 1])
    vals = torch.cat([fg, gg_part[0]]).tolist()
    return vals[0], np.asarray(vals[1:], np.float64)


def _singleton_gains(problem: SCSKProblem, constraint, covered_q, covered_d):
    """f(j|X) [C] and g_k(j|X) [C, P] of every clause, on the host in f64."""
    fg = problem.f_gains(covered_q)
    _, gg_part = constraint.gains(problem, covered_d)
    return (fg.cpu().numpy().astype(np.float64),
            gg_part.cpu().numpy().astype(np.float64))


def _ratio(f: float, g: float) -> float:
    return f * BIG if g <= 0 else f / g


def _ratios(f: np.ndarray, g: np.ndarray) -> np.ndarray:
    """`_ratio` elementwise, the same float64 arithmetic."""
    free = g <= 0
    return np.where(free, f * BIG, f / np.where(free, 1.0, g))


@register_solver("lazy", supports_state=True, supports_partition=True,
                 description="lazy greedy with Thm-4.1 bounds (Alg. 1)")
def solve_lazy_greedy(problem: SCSKProblem, config: SolveConfig,
                      state: SolverState | None = None) -> SolverResult:
    c = problem.n_clauses
    state = problem.init_state() if state is None else state
    covered_q, covered_d = state.covered_q, state.covered_d
    constraint = resolve_constraint(problem, config)
    caps = np.asarray(constraint.caps, np.float64) \
        if hasattr(constraint, "caps") else \
        np.asarray([float(constraint.budget)], np.float64)

    fbar, glow = _singleton_gains(problem, constraint, covered_q, covered_d)
    glow_tot = glow.sum(axis=-1)                    # glow: [C, P] g̲

    selected = state.selected.cpu().numpy().copy()
    order: list[int] = []
    g_used = float(state.g_used)
    g_part = constraint.np_value(bitset.to_numpy(covered_d))
    f_val = float(problem.f_value(covered_q))
    trace = Trace(config, f0=f_val, g0=g_used)
    trace.add_evals(2 * c)

    def fits(j: int) -> bool:
        """Optimistic feasibility: the lower-bound cost fits every cap."""
        return bool(np.all(g_part + glow[j] <= caps))

    steps = config.max_steps or c
    for _ in range(steps):
        # rebuild the heap of optimistically feasible candidates (Alg. 1's
        # outer loop): the same (key, j) entries, in ascending j, as a scan
        # over every clause would push
        cand = np.nonzero(~selected & np.all(g_part + glow <= caps, axis=-1)
                          & (fbar > 0))[0]
        heap = list(zip((-_ratios(fbar[cand], glow_tot[cand])).tolist(),
                        cand.tolist()))
        heapq.heapify(heap)
        x = problem.uncovered_weights(covered_q)     # fixed for this selection
        chosen = -1
        while heap:
            _, j = heapq.heappop(heap)
            # tighten the bounds with an exact evaluation
            fbar[j], glow[j] = _exact_gains_one(problem, constraint, x,
                                                covered_d, j)
            glow_tot[j] = glow[j].sum()
            trace.add_evals(2)
            if not fits(j):
                continue                          # Alg. 1: infeasible, skip
            if fbar[j] <= 0:
                continue
            r = _ratio(fbar[j], glow_tot[j])
            if not heap or r >= -heap[0][0]:
                chosen = j                        # exact top beats next optimist
                break
            heapq.heappush(heap, (-r, j))
        if chosen < 0:
            break
        # select
        fg_star, gg_star = fbar[chosen], glow[chosen].copy()
        covered_q, covered_d = problem.add_clause(covered_q, covered_d, chosen)
        selected[chosen] = True
        order.append(chosen)
        g_part = constraint.np_value(bitset.to_numpy(covered_d))
        g_used = float(g_part.sum())   # partitions tile covered_d exactly
        f_val += fg_star
        # Theorem 4.1 bound update (eq. 14), per partition, every candidate
        glow = np.maximum(0.0, glow - gg_star[None, :])
        glow_tot = glow.sum(axis=-1)
        # f̄ stays as it is: stale f-gains upper-bound current ones
        trace.on_select(f_val, g_used)
        if trace.should_stop():
            break

    final = SolverState(
        covered_q=covered_q, covered_d=covered_d,
        selected=torch.from_numpy(selected).to(problem.device),
        g_used=torch.tensor(g_used, dtype=torch.float32, device=problem.device),
        step=state.step + len(order))
    return trace.result("lazy-greedy", problem, final, order)
