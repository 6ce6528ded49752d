"""Trace: shared per-solve bookkeeping (history, timing, stop conditions).

The port's counterpart of `repro.core.trace`, with the same telemetry:
`solver_selections_total{solver}`, `solver_evals_total{solver}`,
`solver_last_f{solver}` and a `solve_done` event per solve (`repro_torch.obs`).

  * `on_select(f, g)` after each selection — records a history point every
    `record_every` selections and fires the config's `on_step`/`on_record`
    callbacks.
  * `should_stop()` — checks the wall clock directly each step.
  * `result(...)` — assembles the uniform `SolverResult`.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch import obs
from repro_torch.core.config import SolveConfig
from repro_torch.core.problem import SolverResult
from repro_torch.core.state import SolverState

_SELECTIONS = obs.counter("solver_selections_total",
                          "clauses selected across solves",
                          labels=("solver",))
_EVALS = obs.counter("solver_evals_total",
                     "exact (f, g) evaluations across solves",
                     labels=("solver",))
_SOLVE_F = obs.gauge("solver_last_f", "last solve's final objective",
                     labels=("solver",))


class Trace:
    def __init__(self, config: SolveConfig, *, f0: float = 0.0,
                 g0: float = 0.0):
        self.config = config
        self.f_history: list[float] = [f0]
        self.g_history: list[float] = [g0]
        self.time_history: list[float] = [0.0]
        self.n_selections = 0
        self.n_exact_evals = 0
        self.last_f = f0
        self.last_g = g0
        self._t0 = time.perf_counter()
        # label value cached once: the solver name is fixed per Trace and
        # the counters fire on the per-selection hot path
        self._solver = str(config.solver)

    # -- clock ---------------------------------------------------------------
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def should_stop(self) -> bool:
        """Wall-clock time limit, checked against the live clock."""
        limit = self.config.time_limit
        return limit is not None and self.elapsed() > limit

    # -- recording -----------------------------------------------------------
    def add_evals(self, n: int) -> None:
        self.n_exact_evals += n
        _EVALS.inc(n, solver=self._solver)

    def on_select(self, f_val: float, g_val: float) -> None:
        """Call once per selection with the exact post-selection f/g."""
        self.last_f, self.last_g = float(f_val), float(g_val)
        if (self.n_selections % self.config.record_every) == 0:
            self.record()
        self.n_selections += 1
        _SELECTIONS.inc(solver=self._solver)
        if self.config.on_step is not None:
            self.config.on_step(self)

    def record(self) -> None:
        """Force a history point at the current (f, g, elapsed)."""
        self.f_history.append(self.last_f)
        self.g_history.append(self.last_g)
        self.time_history.append(self.elapsed())
        if self.config.on_record is not None:
            self.config.on_record(self)

    # -- result assembly ------------------------------------------------------
    def result(self, name: str, problem, state: SolverState,
               order: list[int], *, extra: dict | None = None) -> SolverResult:
        # flush the tail: with record_every > 1 the last selections may not
        # have a history point yet, which would leave *_history[-1] stale
        if self.n_selections and \
                (self.n_selections - 1) % self.config.record_every != 0:
            self.record()
        f_final = float(problem.f_value(state.covered_q))
        g_final = float(state.g_used)
        _SOLVE_F.set(f_final, solver=self._solver)
        obs.event("solve_done", solver=name, n_selections=self.n_selections,
                  n_exact_evals=self.n_exact_evals, f_final=f_final,
                  g_final=g_final, seconds=round(self.elapsed(), 4))
        return SolverResult(
            name=name,
            selected=state.selected.cpu().numpy(),
            order=order,
            f_final=f_final,
            g_final=g_final,
            f_history=np.asarray(self.f_history),
            g_history=np.asarray(self.g_history),
            time_history=np.asarray(self.time_history),
            n_exact_evals=self.n_exact_evals,
            state=state,
            extra=extra or {},
        )
