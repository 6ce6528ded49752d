"""Solver registry: names -> uniform `solve(problem, config, state)` callables.

The port's counterpart of `repro.core.registry`. Solver modules
self-register with

    @register_solver("greedy", supports_state=True)
    def solve_greedy(problem, config, state=None) -> SolverResult: ...

and every consumer goes through the uniform entry points:

    solve(problem, config, state=None)        single solve / warm start
    solve_sweep(problem, budgets, config)     warm-started budget sweep
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import bitset
from repro_torch.core.config import SolveConfig
from repro_torch.core.constraint import resolve_constraint
from repro_torch.core.problem import SolverResult
from repro_torch.core.state import SolverState

_REGISTRY: dict[str, "SolverSpec"] = {}


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    name: str
    fn: Callable  # (problem, config, state) -> SolverResult
    supports_state: bool = False     # accepts state= for warm starts
    supports_truncate: bool = False  # implements stop_policy="truncate"
    supports_partition: bool = False  # masks per-partition knapsack caps
    description: str = ""


def register_solver(name: str, *, supports_state: bool = False,
                    supports_truncate: bool = False,
                    supports_partition: bool = False, description: str = ""):
    """Decorator: register `fn(problem, config, state=None) -> SolverResult`."""
    def deco(fn):
        if name in _REGISTRY and _REGISTRY[name].fn is not fn:
            raise ValueError(f"solver {name!r} already registered")
        _REGISTRY[name] = SolverSpec(
            name=name, fn=fn, supports_state=supports_state,
            supports_truncate=supports_truncate,
            supports_partition=supports_partition,
            description=description or (fn.__doc__ or "").strip().split("\n")[0])
        return fn
    return deco


def get_solver(name: str) -> SolverSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown solver {name!r}; registered: {list_solvers()}") from None


def list_solvers() -> list[str]:
    return sorted(_REGISTRY)


def solve(problem, config: SolveConfig,
          state: SolverState | None = None) -> SolverResult:
    """The uniform entrypoint: dispatch `config.solver` from the registry."""
    spec = get_solver(config.solver)
    if state is not None and not spec.supports_state:
        raise ValueError(f"solver {spec.name!r} does not support warm starts")
    if config.stop_policy == "truncate" and not spec.supports_truncate:
        raise ValueError(
            f"solver {spec.name!r} does not implement stop_policy='truncate'")
    if config.partitioned and not spec.supports_partition:
        raise ValueError(
            f"solver {spec.name!r} does not implement partitioned budgets "
            f"(budget_split); solvers that do: "
            f"{[n for n, s in _REGISTRY.items() if s.supports_partition]}")
    result = spec.fn(problem, config, state)
    if config.partitioned and result.state is not None:
        # per-partition fill report: g_k(X), the caps and the bounds
        constraint = resolve_constraint(problem, config)
        result.extra["g_part"] = constraint.np_value(
            bitset.to_numpy(result.state.covered_d))
        result.extra["caps"] = constraint.caps.astype(np.float64)
        result.extra["bounds"] = constraint.bounds
    return result


def solve_sweep(problem, budgets: list[float],
                config: SolveConfig) -> list[SolverResult]:
    """Warm-started budget sweep: solve to B1, resume the SAME state to B2...

    Uses the "truncate" stop policy, under which the greedy selection path is
    budget-independent (paper Fig. 3), so each result's SELECTION —
    `order` (patched to the cumulative sequence), `selected`, `f_final`,
    `g_final`, `state` — is exactly what a cold solve at that budget would
    produce. The per-call bookkeeping (`f_history`/`time_history`/
    `n_exact_evals`) covers only each resumed segment.
    """
    if list(budgets) != sorted(budgets):
        raise ValueError("budgets must be ascending")
    spec = get_solver(config.solver)
    if not (spec.supports_state and spec.supports_truncate):
        raise ValueError(
            f"solver {config.solver!r} cannot sweep: it needs both warm "
            f"starts and the 'truncate' stop policy; solvers that can: "
            f"{[n for n, s in _REGISTRY.items() if s.supports_state and s.supports_truncate]}")
    cfg = config.replace(stop_policy="truncate")
    base_constraint = None
    if config.partitioned:
        # per-point constraints keep the same split shares, rescaled to each
        # total; the truncate ranking never reads the caps, so the selection
        # path stays budget-independent and warm == cold per point
        base_constraint = resolve_constraint(problem, config)
        if not hasattr(base_constraint, "scaled"):
            raise ValueError("budget_split sweeps need a PartitionedBudget "
                             "(or a constraint implementing .scaled)")
    state = None
    results: list[SolverResult] = []
    order: list[int] = []
    for b in budgets:
        step_cfg = cfg.replace(budget=float(b))
        if base_constraint is not None:
            step_cfg = step_cfg.replace(
                constraint=base_constraint.scaled(float(b)))
        r = solve(problem, step_cfg, state=state)
        order = order + r.order
        r.order = list(order)
        results.append(r)
        state = r.state
    return results
