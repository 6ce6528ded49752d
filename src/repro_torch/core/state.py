"""SolverState: the explicit, resumable state shared by every solver.

The port's counterpart of `repro.core.state`. Holding the full solve state
in one value is what makes every solver warm-startable: `solve(problem,
cfg_B1)` returns a `SolverResult` carrying its final state, and
`solve(problem, cfg_B2, state=result.state)` resumes it — the budget-sweep
API (Figs. 2/3) is built on exactly this. Solvers never modify a state they
were given; they build new tensors.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SolverState:
    """Solve progress over an `SCSKProblem`.

    covered_q : int32 [Wq]  packed bitset of covered queries, ∪_{c∈X} {q : c⊆q}
    covered_d : int32 [Wd]  packed bitset of Tier-1 docs, ∪_{c∈X} m(c)
    selected  : bool  [C]   clause membership of X
    g_used    : f32 0-d     g(X) = |covered_d| (the knapsack fill)
    step      : int         number of selections so far
    """
    covered_q: torch.Tensor
    covered_d: torch.Tensor
    selected: torch.Tensor
    g_used: torch.Tensor
    step: int

    def replace(self, **kw) -> "SolverState":
        return dataclasses.replace(self, **kw)
