"""Registry adapters for the data-based flow baselines (paper §2.3/§5.2).

The port's counterpart of `repro.api.flow_adapter`. The flow family
(popularity / flow-max / flow-sgd) parameterizes tiering by a document set
rather than clauses, and consumes the full `TieringData` (it needs
per-query match sets, not the clause incidence an `SCSKProblem` keeps).
These adapters put them behind the same `solve(problem, config, state)`
signature as the SCSK solvers.

Calling convention: pass the `TieringData` either as the problem argument,
or via `config.options["data"]` when the positional slot holds an
`SCSKProblem`. The returned `SolverResult` maps the flow quantities onto
the common record (f_final = train coverage, g_final = Tier-1 doc count,
selected = no clauses) and keeps the native `FlowResult` in
`result.extra["flow"]`. flow-sgd runs on `config.options["device"]`
(default CUDA; `TieringPipeline` passes its own device).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import flow
from repro_torch.core.config import SolveConfig
from repro_torch.core.problem import SolverResult
from repro_torch.core.registry import register_solver
from repro_torch.core.state import SolverState
from repro_torch.data.incidence import TieringData


def _data_of(problem, config: SolveConfig) -> TieringData:
    if isinstance(problem, TieringData):
        return problem
    data = config.opt("data")
    if data is None:
        raise ValueError(
            "flow baselines need the TieringData: pass it as the problem "
            "argument or in config.options['data']")
    return data


def _to_result(r: flow.FlowResult, data: TieringData) -> SolverResult:
    n_clauses = len(data.clauses)
    return SolverResult(
        name=r.name,
        selected=np.zeros(n_clauses, bool),   # flow selects docs, not clauses
        order=[],
        f_final=r.train_coverage,
        g_final=float(r.tier1_docs.sum()),
        f_history=np.asarray([0.0, r.train_coverage]),
        g_history=np.asarray([0.0, float(r.tier1_docs.sum())]),
        time_history=np.asarray([0.0, r.wall_seconds]),
        extra={"flow": r, "test_coverage": r.test_coverage,
               "tier1_docs": r.tier1_docs,
               "eligible_queries": r.eligible_queries},
    )


@register_solver("flow-popularity", needs_data=True,
                 description="top-B docs by P[d ∈ m(q)] (Leung et al.)")
def solve_flow_popularity(problem, config: SolveConfig,
                          state: SolverState | None = None) -> SolverResult:
    data = _data_of(problem, config)
    return _to_result(flow.popularity(data, int(config.budget)), data)


@register_solver("flow-max", needs_data=True,
                 description="top-B docs by max_q P[q] (Leung et al.)")
def solve_flow_max(problem, config: SolveConfig,
                   state: SolverState | None = None) -> SolverResult:
    data = _data_of(problem, config)
    return _to_result(flow.flow_max(data, int(config.budget)), data)


@register_solver("flow-sgd", needs_data=True,
                 description="smooth-min SGD relaxation of eq. 5 (Leung et al.)")
def solve_flow_sgd(problem, config: SolveConfig,
                   state: SolverState | None = None) -> SolverResult:
    data = _data_of(problem, config)
    kw = {k: config.options[k] for k in
          ("lam", "steps", "batch", "lr", "tau", "mu", "device")
          if k in config.options}
    return _to_result(
        flow.flow_sgd(data, int(config.budget), seed=config.seed, **kw), data)
