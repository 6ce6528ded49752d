"""Knapsack constraints: the budget side of SCSK as an object.

The port's counterpart of `repro.core.constraint`, for the paper's single
budget g(X) <= B (eq. 12). Per-shard budgets (`PartitionedBudget`) are not
ported yet (ROADMAP item 7): a config that asks for them raises
`NotImplementedError`.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch


class GlobalBudget:
    """The paper's scalar knapsack g(X) <= B, with the reference
    `KnapsackConstraint` protocol's methods over one partition (P = 1):
    used/value give f32 [1] fills, gains (total [C], per-part [C, 1])
    marginal costs, feasible the candidates that fit.

    The budget is rounded to f32 once, as the reference's `jnp.float32`,
    and feasibility is the same f32 comparison `g_used + g_gain <= budget`.
    """

    def __init__(self, budget: float):
        self.budget = float(np.float32(budget))

    def __repr__(self) -> str:
        return f"GlobalBudget(budget={self.budget})"

    def used(self, problem, state) -> torch.Tensor:
        return state.g_used.reshape(1)

    def value(self, problem, covered_d) -> torch.Tensor:
        return problem.g_value(covered_d).reshape(1)

    def gains(self, problem, covered_d, *, rows=None):
        gg = problem.g_gains(covered_d, rows=rows)
        return gg, gg[..., None]

    def feasible(self, used, g_part) -> torch.Tensor:
        return used[0] + g_part[..., 0] <= self.budget


def _partitioned() -> NotImplementedError:
    return NotImplementedError(
        "per-shard budgets (budget_split / PartitionedBudget) are not ported "
        "to repro_torch yet; see ROADMAP.md open item 7")


def as_constraint(budget) -> GlobalBudget:
    """Normalize a scalar budget (or pass a GlobalBudget through); any other
    constraint object is a per-shard budget and raises."""
    if isinstance(budget, GlobalBudget):
        return budget
    if isinstance(budget, numbers.Real):
        return GlobalBudget(budget)
    raise _partitioned()


def resolve_constraint(problem, config) -> GlobalBudget:
    """The constraint a SolveConfig implies: an explicit `constraint` wins,
    else the scalar `budget`. A partitioned config raises."""
    if config.constraint is not None:
        return as_constraint(config.constraint)
    if config.budget_split is not None:
        raise _partitioned()
    return GlobalBudget(config.budget)
