"""Iterative Submodular Knapsack — paper Algorithm 3 (Iyer & Bilmes 2013).

The port's counterpart of `repro.core.isk`. The submodular cost g is
replaced by a modular upper bound that is tight at the current solution
X_t (eq. 15):

  ĝ₁: cost g(j|X_t∖j) for kept items, g({j}) for new items
  ĝ₂: cost g(j|X̄∖j)  for kept items, g(j|X_t) for new items

Since ĝ ≥ g everywhere, every inner solution is feasible for the true
constraint. The inner problem — max f(X) s.t. modular cost ≤ B' — is a plain
submodular knapsack solved with a cost-ratio greedy: one `bit_matvec`
launch per inner step. ĝ₂'s "covered only once" counts run over the doc
rows with one more `bit_matvec`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core.config import SolveConfig
from repro_torch.core.greedy import ratio_of
from repro_torch.core.problem import SCSKProblem, SolverResult
from repro_torch.core.registry import register_solver
from repro_torch.core.state import SolverState
from repro_torch.core.trace import Trace

WORD = 32
CHUNK_BYTES = 1 << 28     # unpacked intermediate per block of rows


def _modular_knapsack(problem: SCSKProblem, w: torch.Tensor, b_eff: float,
                      max_steps: int) -> np.ndarray:
    """Cost-ratio greedy for max f(X) s.t. sum_{j∈X} w_j <= b_eff, in f32
    as the reference; one host read per step."""
    dev = problem.device
    covered_q = torch.zeros(problem.wq, dtype=torch.int32, device=dev)
    selected = torch.zeros(problem.n_clauses, dtype=torch.bool, device=dev)
    spent = torch.zeros((), dtype=torch.float32, device=dev)
    w = w.to(device=dev, dtype=torch.float32)
    b_eff = torch.tensor(b_eff, dtype=torch.float32, device=dev)
    for _ in range(max_steps):
        fg = problem.f_gains(covered_q)
        feasible = (~selected) & (spent + w <= b_eff) & (fg > 0.0)
        score = torch.where(feasible, ratio_of(fg, w), float("-inf"))
        j = torch.argmax(score)
        j, stop = torch.stack([j, (~feasible[j]).long()]).tolist()
        if stop:
            break
        covered_q = covered_q | problem.clause_query_bits[j]
        selected[j] = True
        spent = spent + w[j]
    return selected.cpu().numpy()


def _or_except_one(rows: torch.Tensor) -> torch.Tensor:
    """[T, W] -> [T, W]: OR of all rows except row t, from an exclusive
    prefix OR and an exclusive suffix OR (each by doubling)."""
    def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
        s = 1
        while s < x.shape[0]:
            x = torch.cat([x[:s], x[s:] | x[:-s]])
            s *= 2
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]])
    prefix = exclusive_scan(rows)
    suffix = exclusive_scan(rows.flip(0)).flip(0)
    return prefix | suffix


def _coverage_counts(rows: torch.Tensor) -> torch.Tensor:
    """[C, W] packed -> int32 [W*32]: per-doc cover multiplicity, on the
    rows' device in blocks of rows (unpacked whole it would not fit)."""
    c, w = rows.shape
    shifts = torch.arange(WORD, dtype=torch.int32, device=rows.device)
    acc = torch.zeros((w, WORD), dtype=torch.int32, device=rows.device)
    step = max(1, CHUNK_BYTES // max(1, w * WORD * 4))
    for r0 in range(0, c, step):
        acc += ((rows[r0:r0 + step, :, None] >> shifts) & 1).sum(
            0, dtype=torch.int32)
    return acc.reshape(-1)


def _solve_isk(problem: SCSKProblem, config: SolveConfig, variant: int,
               state: SolverState | None = None) -> SolverResult:
    assert variant in (1, 2)
    if state is not None:
        raise ValueError("isk does not support warm starts")
    budget = config.budget
    c = problem.n_clauses
    dev = problem.device
    zeros_d = torch.zeros(problem.wd, dtype=torch.int32, device=dev)
    singleton_g = problem.g_gains(zeros_d)
    if variant == 2:
        # g(j | X̄∖j) = #docs covered only by clause j — precomputable
        counts = _coverage_counts(problem.clause_doc_bits)            # [Wd*32]
        only_once = (counts == 1).to(torch.float32)
        w_kept_global = problem.f_gains(                              # reuse matvec
            zeros_d, rows=problem.clause_doc_bits,
            weights=only_once).cpu().numpy().astype(np.float64)

    selected = np.zeros(c, bool)
    trace = Trace(config)
    f_final, g_final = 0.0, 0.0
    max_inner = config.opt("max_inner") or c
    max_outer = int(config.opt("max_outer", 10))
    covered_q2 = torch.zeros(problem.wq, dtype=torch.int32, device=dev)
    covered_d2 = zeros_d

    def union(bits: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        return bitset.or_rows(bits[torch.as_tensor(idx, device=dev)])

    for _ in range(max_outer):
        sel_idx = np.nonzero(selected)[0]
        covered_d = union(problem.clause_doc_bits, sel_idx)
        g_xt = float(problem.g_value(covered_d))

        w = singleton_g.cpu().numpy().astype(np.float64) if variant == 1 \
            else problem.g_gains(covered_d).cpu().numpy().astype(np.float64)
        if len(sel_idx):
            if variant == 1:
                rows = problem.clause_doc_bits[torch.as_tensor(sel_idx,
                                                               device=dev)]
                kept = problem.g_gains(zeros_d,
                                       rows=rows & ~_or_except_one(rows))
                w[sel_idx] = kept.cpu().numpy().astype(np.float64)
            else:
                w[sel_idx] = w_kept_global[sel_idx]
        b_eff = budget - g_xt + float(w[sel_idx].sum()) if len(sel_idx) \
            else budget

        new_sel = _modular_knapsack(problem, torch.from_numpy(w), b_eff,
                                    max_inner)
        sel_idx2 = np.nonzero(new_sel)[0]
        covered_d2 = union(problem.clause_doc_bits, sel_idx2)
        covered_q2 = union(problem.clause_query_bits, sel_idx2)
        f_final = float(problem.f_value(covered_q2))
        g_final = float(problem.g_value(covered_d2))
        trace.on_select(f_final, g_final)
        if np.array_equal(new_sel, selected):
            break
        selected = new_sel
        if trace.should_stop():
            break

    final = SolverState(
        covered_q=covered_q2, covered_d=covered_d2,
        selected=torch.from_numpy(selected).to(dev),
        g_used=torch.tensor(g_final, dtype=torch.float32, device=dev),
        step=int(selected.sum()))
    return trace.result(f"isk{variant}", problem, final,
                        np.nonzero(selected)[0].tolist())


@register_solver("isk1", description="iterative submodular knapsack, ĝ₁ bound")
def solve_isk1(problem: SCSKProblem, config: SolveConfig,
               state: SolverState | None = None) -> SolverResult:
    return _solve_isk(problem, config, 1, state)


@register_solver("isk2", description="iterative submodular knapsack, ĝ₂ bound")
def solve_isk2(problem: SCSKProblem, config: SolveConfig,
               state: SolverState | None = None) -> SolverResult:
    return _solve_isk(problem, config, 2, state)
