"""Optimistic/Pessimistic Greedy — paper Algorithm 2, batched form.

The port's counterpart of `repro.core.optpes`. Every candidate whose
*optimistic* ratio f̄/g̲ beats the best *pessimistic* ratio f̲/ḡ is in the
refresh set C. Each round gathers the top-K optimistic members of C,
re-evaluates their exact gains with one `bit_matvec` and one
`coverage_gain` (per-shard budgets: `partition_gain`) launch over the
gathered rows, and selects once the exact argmax provably dominates every
non-refreshed optimistic ratio (Theorem 4.2 guarantees j^(t) ∈ C, so this
terminates with the exact greedy choice).

Bounds maintained per candidate (all eq.-14-style updates, Thm 4.1):
  f̄ upper / f̲ lower bounds of f(j|X);  ḡ upper / g̲ lower bounds of g(j|X),
the g bounds as [C, P] matrices over the constraint's partitions (P = 1 for
the global budget).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.config import SolveConfig
from repro_torch.core.constraint import resolve_constraint
from repro_torch.core.greedy import ratio_of
from repro_torch.core.problem import SCSKProblem, SolverResult
from repro_torch.core.registry import register_solver
from repro_torch.core.state import SolverState
from repro_torch.core.trace import Trace

NEG = float("-inf")


@dataclasses.dataclass
class RoundState:
    """Opt/Pes progress. The solver owns every tensor here and updates the
    bound vectors and `selected` in place (the reference's `.at[].set`)."""
    covered_q: torch.Tensor
    covered_d: torch.Tensor
    selected: torch.Tensor      # bool [C]
    g_part: torch.Tensor        # f32 [P] fill per partition
    fbar: torch.Tensor          # f32 [C]
    flow: torch.Tensor          # f32 [C]
    gbar: torch.Tensor          # f32 [C, P]
    glow: torch.Tensor          # f32 [C, P]
    f_val: torch.Tensor         # f32 0-d


def top_k_stable(values: torch.Tensor, k: int):
    """The k largest values and their indices, ties broken by lower index
    (as `lax.top_k`; `torch.topk` promises no order among equal values)."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[:k], idx[:k]


def _subset_gains(problem: SCSKProblem, constraint, covered_q, covered_d,
                  top_idx):
    """Exact f gains [K] and per-partition g gains [K, P] for K gathered rows."""
    fg = problem.f_gains(covered_q, rows=problem.clause_query_bits[top_idx])
    _, gg_part = constraint.gains(problem, covered_d,
                                  rows=problem.clause_doc_bits[top_idx])
    return fg, gg_part


def optpes_round(problem: SCSKProblem, rs: RoundState, constraint, *,
                 k: int) -> tuple[bool, bool, int]:
    """One refresh-(and maybe select) round over `rs`, in place.

    Returns (selected_this_round, any_feasible, j_star), read to the host in
    one transfer.
    """
    feasible = (~rs.selected) & constraint.feasible(rs.g_part, rs.glow) \
        & (rs.fbar > 0.0)
    opt = torch.where(feasible, ratio_of(rs.fbar, rs.glow.sum(-1)), NEG)
    pes = torch.where(feasible, ratio_of(rs.flow, rs.gbar.sum(-1)), NEG)
    in_c = feasible & (opt >= pes.max())

    # top-K of the refresh set C by optimistic ratio
    top_vals, top_idx = top_k_stable(torch.where(in_c, opt, NEG), k)
    valid = top_vals > NEG

    # exact re-evaluation over the gathered rows
    fg, gg_part = _subset_gains(problem, constraint, rs.covered_q,
                                rs.covered_d, top_idx)
    gg = gg_part.sum(-1)
    for arr, vals in ((rs.fbar, fg), (rs.flow, fg),
                      (rs.gbar, gg_part), (rs.glow, gg_part)):
        keep = valid if vals.dim() == 1 else valid[:, None]
        arr[top_idx] = torch.where(keep, vals, arr[top_idx])

    # selection test: exact-argmax among refreshed beats all other optimists
    exact_feas = valid & (~rs.selected[top_idx]) \
        & constraint.feasible(rs.g_part, gg_part) & (fg > 0.0)
    exact_ratio = torch.where(exact_feas, ratio_of(fg, gg), NEG)
    bi = torch.argmax(exact_ratio)
    r_star = exact_ratio[bi]

    refreshed = torch.zeros_like(rs.selected)
    refreshed[top_idx] = valid
    opt2 = torch.where(feasible & ~refreshed,
                       ratio_of(rs.fbar, rs.glow.sum(-1)), NEG)
    do_select = (r_star > NEG) & (r_star >= opt2.max())
    did, any_feasible, j = torch.stack(
        [do_select.long(), feasible.any().long(), top_idx[bi]]).tolist()

    if did:
        fg_s, gg_s = fg[bi], gg_part[bi]
        rs.covered_q = rs.covered_q | problem.clause_query_bits[j]
        rs.covered_d = rs.covered_d | problem.clause_doc_bits[j]
        rs.selected[j] = True
        rs.g_part = constraint.value(problem, rs.covered_d)
        # eq. (14) lower-bound updates for every candidate, per partition
        rs.glow = torch.clamp(rs.glow - gg_s[None, :], min=0.0)
        rs.flow = torch.clamp(rs.flow - fg_s, min=0.0)
        rs.f_val = rs.f_val + fg_s
    return bool(did), bool(any_feasible), j


@register_solver("optpes", supports_state=True, supports_partition=True,
                 description="batched optimistic/pessimistic greedy (Alg. 2)")
def solve_optpes(problem: SCSKProblem, config: SolveConfig,
                 state: SolverState | None = None) -> SolverResult:
    c = problem.n_clauses
    k = min(int(config.opt("k", 256)), c)
    state = problem.init_state() if state is None else state
    constraint = resolve_constraint(problem, config)
    f0 = float(problem.f_value(state.covered_q))
    # warm start: exact singleton gains at the resumed state are valid
    # optimistic AND pessimistic bounds (they are exact)
    fg0 = problem.f_gains(state.covered_q)
    _, gg0 = constraint.gains(problem, state.covered_d)
    rs = RoundState(
        covered_q=state.covered_q, covered_d=state.covered_d,
        selected=state.selected.clone(),
        g_part=constraint.used(problem, state),
        fbar=fg0, flow=fg0.clone(), gbar=gg0.clone(), glow=gg0.clone(),
        f_val=torch.tensor(f0, dtype=torch.float32, device=problem.device))

    trace = Trace(config, f0=f0, g0=float(state.g_used))
    trace.add_evals(2 * c)
    order: list[int] = []
    max_sel = config.max_steps or c
    rounds_cap = 50 * c // max(k, 1) + 200
    rounds = 0
    while len(order) < max_sel and rounds < rounds_cap:
        did, any_feasible, j = optpes_round(problem, rs, constraint, k=k)
        rounds += 1
        trace.add_evals(2 * k)
        if not any_feasible:
            break
        if did:
            order.append(j)
            f_val, g_val = torch.stack([rs.f_val, rs.g_part.sum()]).tolist()
            trace.on_select(f_val, g_val)
            if trace.should_stop():
                break

    final = SolverState(
        covered_q=rs.covered_q, covered_d=rs.covered_d,
        selected=rs.selected, g_used=rs.g_part.sum(),
        step=state.step + len(order))
    return trace.result(f"optpes-k{k}", problem, final, order)
