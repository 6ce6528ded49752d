"""SolveConfig: one config object for every solver behind `repro_torch.api`.

A copy of `repro.core.config`.

Replaces the per-solver keyword soup (`budget`, `max_steps`, `record_every`,
`time_limit`, `seed`, plus solver-specific knobs) with a single frozen
dataclass consumed by the uniform signature

    solve(problem, config, state=None) -> SolverResult

Solver-specific options (`k` for optpes, `batch_queries` for stochastic,
`lam`/`steps` for flow-sgd, ...) travel in `options` so the registry stays
signature-uniform without losing per-solver tunability.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    budget: float
    solver: str = "greedy"
    # Partitioned knapsack (shard-aware budgets, see core.constraint):
    #   budget_split — {partition: cap} mapping / cap sequence over the
    #       word-aligned doc partition, or the string "traffic" (resolved
    #       from observed traffic shares by TieringPipeline; invalid at the
    #       bare registry level). None = single global budget.
    #   constraint — an explicit constraint object; wins over both
    #       `budget` and `budget_split`.
    budget_split: Mapping[int, float] | Sequence[float] | str | None = None
    constraint: Any = None
    max_steps: int | None = None        # cap on selections this call
    record_every: int = 1               # trace density (history points)
    time_limit: float | None = None     # wall-clock seconds, checked per step
    seed: int = 0                       # stochastic solvers only
    # "exhaust": keep selecting the best *feasible* candidate until none
    #            remain (classic greedy; the pre-registry semantics).
    # "truncate": stop at the first step whose best candidate overflows the
    #            budget. The selection path then does not depend on the
    #            budget at all (paper Fig. 3: "greedy finds the entire
    #            solution path"), which is what makes warm-started budget
    #            sweeps exactly equal cold solves.
    stop_policy: str = "exhaust"
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    # Trace hooks: on_step(trace) after every selection, on_record(trace)
    # after every recorded history point. Used by benchmarks for live
    # emission; returning is the only contract (raise to abort).
    on_step: Callable | None = None
    on_record: Callable | None = None

    def __post_init__(self):
        if self.stop_policy not in ("exhaust", "truncate"):
            raise ValueError(f"unknown stop_policy: {self.stop_policy!r}")
        if self.record_every < 1:
            raise ValueError("record_every must be >= 1")
        if isinstance(self.budget_split, str) and \
                self.budget_split != "traffic":
            raise ValueError(
                f"unknown budget_split: {self.budget_split!r} "
                "(a mapping, a cap sequence, or 'traffic')")

    @property
    def partitioned(self) -> bool:
        """True when this config implies a multi-partition constraint."""
        if self.constraint is not None:
            return getattr(self.constraint, "n_parts", 1) > 1
        return self.budget_split is not None

    def replace(self, **kw) -> "SolveConfig":
        return dataclasses.replace(self, **kw)

    def opt(self, key: str, default=None):
        """Solver-specific option with a default."""
        return self.options.get(key, default)
