"""TieringPipeline: the paper's whole pipeline behind one fluent facade.

The port's counterpart of `repro.api.pipeline`:

    from repro_torch import api

    engine = (api.TieringPipeline.from_synthetic(seed=0, scale="tiny")
              .mine(min_support=1e-3)
              .solve("optpes", budget_frac=0.5)
              .deploy())

Each stage materializes the artifact the next one consumes:

    from_*      -> corpus + query log (host)
    mine        -> TieringData (FPGrowth clauses + packed incidence, host)
                   and the device-resident SCSKProblem
    solve       -> SolverResult via the solver registry
    tiering     -> ClauseTiering (ψ/φ classifiers of §3.1)
    deploy      -> serve.TieredEngine ready for traffic

The pipeline runs on `device` (default CUDA; `device="cpu"` takes every
kernel's plain version). Per-shard budgets, `refit` and cluster deployment
are later slices of the port.
"""
from __future__ import annotations

from repro_torch.core import registry
from repro_torch.core.config import SolveConfig
from repro_torch.core.problem import SCSKProblem, SolverResult
from repro_torch.core.state import SolverState
from repro_torch.core.tiering import ClauseTiering
from repro_torch.device import resolve_device

# SolveConfig fields settable via TieringPipeline.solve(**options);
# `budget_split` reaches the config so that the solver refuses it (per-shard
# budgets are not ported yet) instead of taking it as a solver option
_CONFIG_KEYS = ("max_steps", "record_every", "time_limit", "seed",
                "stop_policy", "on_step", "on_record", "budget_split")


class TieringPipeline:
    def __init__(self, corpus, log, *, device=None):
        self.device = resolve_device(device)
        self.corpus = corpus
        self.log = log
        self.data = None               # data.incidence.TieringData
        self.problem: SCSKProblem | None = None
        self.config: SolveConfig | None = None
        self.result: SolverResult | None = None
        self._tiering: ClauseTiering | None = None

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_synthetic(cls, seed: int = 0, scale: str = "tiny", *,
                       device=None) -> "TieringPipeline":
        from repro_torch.data import synthetic
        corpus, log = synthetic.make_tiering_dataset(seed, scale)
        return cls(corpus, log, device=device)

    @classmethod
    def from_corpus(cls, corpus, log, *, device=None) -> "TieringPipeline":
        return cls(corpus, log, device=device)

    @classmethod
    def from_data(cls, data, *, device=None) -> "TieringPipeline":
        """Start from an already-built TieringData (skips `mine`)."""
        pipe = cls(data.corpus, data.log, device=device)
        pipe.data = data
        pipe.problem = SCSKProblem.from_data(data, pipe.device)
        return pipe

    # -- stages --------------------------------------------------------------
    def mine(self, min_support: float = 1e-3, *, max_clause_len: int = 4,
             max_clauses: int | None = None) -> "TieringPipeline":
        """FPGrowth clause mining (§3.3) + packed incidence structures."""
        from repro_torch.data import incidence
        self.data = incidence.build_tiering_data(
            self.corpus, self.log, min_support=min_support,
            max_clause_len=max_clause_len, max_clauses=max_clauses)
        self.problem = SCSKProblem.from_data(self.data, self.device)
        self._tiering = None
        return self

    def solve(self, solver: str = "optpes", budget: float | None = None, *,
              budget_frac: float = 0.5, state: SolverState | None = None,
              config: SolveConfig | None = None, **options) -> "TieringPipeline":
        """SCSK solve via the registry. `**options` splits into SolveConfig
        fields (max_steps, time_limit, ...) and solver-specific options.
        An explicit `config=` carries everything itself and cannot be
        combined with budget/options arguments."""
        if self.data is None:
            raise RuntimeError("call mine() (or from_data) before solve()")
        if config is not None and (budget is not None or options):
            raise ValueError(
                "pass either config= or budget/budget_frac/**options — an "
                "explicit SolveConfig already carries those")
        if config is None:
            # int truncation matches the reference (budget = int(n_docs * frac))
            budget = float(int(self.corpus.n_docs * budget_frac)
                           if budget is None else budget)
            cfg_kw = {k: options.pop(k) for k in _CONFIG_KEYS if k in options}
            config = SolveConfig(budget=budget, solver=solver,
                                 options=options, **cfg_kw)
        self.config = config
        self.result = registry.solve(self.problem, config, state=state)
        self._tiering = None
        return self

    def sweep(self, budgets: list[float], solver: str = "greedy",
              **options) -> list[SolverResult]:
        """Warm-started budget sweep (Fig. 2/3); leaves the largest-budget
        result as the pipeline's current result."""
        if self.problem is None:
            raise RuntimeError("call mine() (or from_data) before sweep()")
        cfg_kw = {k: options.pop(k) for k in _CONFIG_KEYS if k in options}
        config = SolveConfig(budget=float(budgets[-1]), solver=solver,
                             options=options, **cfg_kw)
        results = registry.solve_sweep(self.problem, budgets, config)
        self.config = config
        self.result = results[-1]
        self._tiering = None
        return results

    # -- artifacts -----------------------------------------------------------
    def tiering(self) -> ClauseTiering:
        """The deployable ψ/φ artifact for the current solve."""
        if self.result is None:
            raise RuntimeError("call solve() before tiering()")
        if self._tiering is None:
            self._tiering = ClauseTiering.from_selection(
                self.data, self.result.selected)
        return self._tiering

    def coverage(self) -> dict[str, float]:
        return self.tiering().coverage(self.data)

    def verify(self) -> bool:
        """Theorem 3.1, checked exhaustively over the query log."""
        return self.tiering().verify_correctness(self.data)

    def deploy(self):
        """-> serve.TieredEngine serving guaranteed-complete match sets."""
        from repro_torch.serve.engine import TieredEngine
        return TieredEngine(self.data.postings, self.tiering(),
                            self.data.n_docs, device=self.device)

    def summary(self) -> str:
        parts = [f"{self.corpus.n_docs} docs", f"{self.log.n_queries} queries"]
        if self.data is not None:
            parts.append(f"{len(self.data.clauses)} clauses")
        if self.result is not None:
            parts.append(self.result.summary())
        return " | ".join(parts)
