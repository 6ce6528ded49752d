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
    solve       -> SolverResult via the solver registry (any registered
                   name, the flow baselines among them)
    tiering     -> ClauseTiering (ψ/φ classifiers of §3.1)
    deploy      -> serve.TieredEngine ready for traffic
    deploy_cluster -> cluster.TieredCluster: the same tiering on a sharded,
                   replicated fleet (host path)

`solve`, `sweep` and `refit` take `budget_split` (per-shard caps, or
"traffic" with `n_shards`) for shard-aware budgets. The pipeline runs on
`device` (default CUDA; `device="cpu"` takes every kernel's plain version).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.api.partition import partition_budgets, shard_traffic_shares
from repro_torch.core import registry
from repro_torch.core.config import SolveConfig
from repro_torch.core.constraint import (PartitionedBudget, partition_bounds,
                                         partition_capacities,
                                         resolve_constraint, trim_state)
from repro_torch.core.problem import SCSKProblem, SolverResult
from repro_torch.core.state import SolverState
from repro_torch.core.tiering import ClauseTiering
from repro_torch.device import resolve_device

# SolveConfig fields settable via TieringPipeline.solve(**options)
_CONFIG_KEYS = ("max_steps", "record_every", "time_limit", "seed",
                "stop_policy", "on_step", "on_record")

_UNSET = object()   # "argument not passed" sentinel (None is meaningful)


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

    # -- shard-aware budgets --------------------------------------------------
    def partition_constraint(self, total: float | None, budget_split,
                             n_shards: int | None = None,
                             weights: np.ndarray | None = None,
                             ) -> PartitionedBudget:
        """Resolve a `budget_split` spec into a `PartitionedBudget`.

        `budget_split="traffic"` sizes each shard's cap from its share of
        the weighted match-set mass (`api.partition.shard_traffic_shares`
        of `weights`, default: the problem's current solve weights) with the
        `partition_budgets` allocator; a mapping or sequence is taken as the
        caps directly. Partitions are the word-aligned
        `core.constraint.partition_bounds` split.
        """
        n_docs = self.corpus.n_docs
        if not isinstance(budget_split, str):
            split = dict(budget_split) if isinstance(budget_split, Mapping) \
                else list(budget_split)
            if n_shards is not None and len(split) != n_shards:
                raise ValueError(f"budget_split has {len(split)} caps but "
                                 f"n_shards={n_shards}")
            constraint = PartitionedBudget.from_split(n_docs, split)
            # explicit caps are the budget; a conflicting explicit total is
            # a mistake, not something to ignore
            if total is not None and abs(constraint.total - float(total)) \
                    > 1e-6:
                raise ValueError(
                    f"budget_split caps sum to {constraint.total:.0f} but "
                    f"budget={float(total):.0f}; pass one or the other")
            return constraint
        if self.data is None:
            raise RuntimeError("budget_split='traffic' needs mined data")
        if total is None:
            raise ValueError("budget_split='traffic' needs a total budget")
        bounds = partition_bounds(n_docs, n_shards or 2)
        if weights is None:
            weights = self.problem.query_weights.cpu().numpy().astype(
                np.float64)[:self.log.n_queries]
        shares = shard_traffic_shares(self.data.query_doc_bits, weights,
                                      bounds)
        caps = partition_budgets(partition_capacities(n_docs, bounds),
                                 shares, total)
        return PartitionedBudget.from_split(n_docs, caps)

    @property
    def n_partitions(self) -> int | None:
        """Partition count of the current solve's constraint (None=global)."""
        if self.config is None or not self.config.partitioned:
            return None
        if self.config.constraint is not None:
            return self.config.constraint.n_parts
        split = self.config.budget_split
        return None if isinstance(split, str) else len(split)

    def solve(self, solver: str = "optpes", budget: float | None = None, *,
              budget_frac: float = 0.5, state: SolverState | None = None,
              config: SolveConfig | None = None, budget_split=None,
              n_shards: int | None = None, **options) -> "TieringPipeline":
        """SCSK solve via the registry. `**options` splits into SolveConfig
        fields (max_steps, time_limit, ...) and solver-specific options.
        An explicit `config=` carries everything itself and cannot be
        combined with budget/options arguments.

        `budget_split` makes the knapsack shard-aware: a {shard: cap}
        mapping or cap sequence (the caps define the total; an explicit
        `budget=` must agree or this raises), or "traffic" to size
        `n_shards` caps from each shard's share of the weighted match
        traffic, splitting the `budget`/`budget_frac` total."""
        if self.data is None:
            raise RuntimeError("call mine() (or from_data) before solve()")
        if config is not None and (budget is not None or options or
                                   budget_split is not None):
            raise ValueError(
                "pass either config= or budget/budget_frac/budget_split/"
                "**options — an explicit SolveConfig already carries those")
        if config is None:
            # int truncation matches the reference (budget = int(n_docs * frac));
            # an explicit budget is kept as it is
            explicit = None if budget is None else float(budget)
            budget = float(int(self.corpus.n_docs * budget_frac)
                           if budget is None else budget)
            cfg_kw = {k: options.pop(k) for k in _CONFIG_KEYS if k in options}
            if budget_split is not None:
                # explicit cap splits define their own total (checked
                # against an explicit budget=); "traffic" splits the
                # budget/budget_frac total by observed shares
                constraint = self.partition_constraint(
                    budget if isinstance(budget_split, str) else explicit,
                    budget_split, n_shards)
                cfg_kw.update(budget=constraint.total, constraint=constraint,
                              budget_split=budget_split)
            else:
                cfg_kw["budget"] = budget
            config = SolveConfig(solver=solver, options=options, **cfg_kw)
        spec = registry.get_solver(config.solver)
        if spec.needs_data and "device" not in config.options:
            # flow-sgd runs where the pipeline runs
            config = config.replace(
                options={**config.options, "device": self.device})
        target = self.data if spec.needs_data else self.problem
        self.config = config
        self.result = registry.solve(target, config, state=state)
        self._tiering = None
        return self

    def sweep(self, budgets: list[float], solver: str = "greedy", *,
              budget_split=None, n_shards: int | None = None,
              **options) -> list[SolverResult]:
        """Warm-started budget sweep (Fig. 2/3); leaves the largest-budget
        result as the pipeline's current result.

        With `budget_split`, each total budget keeps the same split shares
        (the largest-budget constraint rescaled per point); the truncate
        ranking ignores caps, so the warm path still equals cold solves."""
        if self.problem is None:
            raise RuntimeError("call mine() (or from_data) before sweep()")
        cfg_kw = {k: options.pop(k) for k in _CONFIG_KEYS if k in options}
        if budget_split is not None:
            constraint = self.partition_constraint(
                float(budgets[-1]) if isinstance(budget_split, str)
                else None, budget_split, n_shards)
            # explicit caps act as shares over a sweep: rescaled per point
            constraint = constraint.scaled(float(budgets[-1]))
            cfg_kw.update(constraint=constraint, budget_split=budget_split)
        config = SolveConfig(budget=float(budgets[-1]), solver=solver,
                             options=options, **cfg_kw)
        results = registry.solve_sweep(self.problem, budgets, config)
        self.config = config
        self.result = results[-1]
        self._tiering = None
        return results

    def refit(self, weights, *, state: SolverState | None = None,
              budget: float | None = None, budget_frac: float | None = None,
              solver: str | None = None, budget_split=_UNSET,
              n_shards: int | None = None, **options) -> "TieringPipeline":
        """Re-solve against a new empirical query distribution (re-tiering).

        `weights` is the updated distribution over the pipeline's
        unique-query universe (length `n_queries`). The problem is
        reweighted with `SCSKProblem.with_weights` (the packed incidence is
        reused) and solved with the prior config (budget/solver/options
        default to the previous solve's). Pass `state=` to warm-start from a
        prior `SolverState`; omit it for a cold re-solve.

        `budget_split` defaults to the previous solve's: a "traffic" split
        re-allocates the per-shard caps from the new `weights` (total
        unchanged) on every refit, and a warm state is trimmed of the
        clauses touching any shard whose new cap its fill exceeds. Pass
        `budget_split=None` to drop back to a global budget.
        """
        if self.problem is None:
            raise RuntimeError("call mine() (or from_data) before refit()")
        base = self.config if self.config is not None else \
            SolveConfig(budget=float(int(self.corpus.n_docs * 0.5)))
        if budget is not None and budget_frac is not None:
            raise ValueError("pass either budget= or budget_frac=, not both")
        kw = {}
        if budget_frac is not None:
            budget = float(int(self.corpus.n_docs * budget_frac))
        if budget is not None:
            kw["budget"] = float(budget)
        if solver is not None:
            kw["solver"] = solver
        cfg_kw = {k: options.pop(k) for k in _CONFIG_KEYS if k in options}
        if options:
            kw["options"] = {**dict(base.options), **options}
        split = base.budget_split if budget_split is _UNSET else budget_split
        if split is not None:
            constraint = self.partition_constraint(
                kw.get("budget", base.budget) if isinstance(split, str)
                else kw.get("budget"),
                split, n_shards or self.n_partitions,
                weights=np.asarray(weights, np.float64)[:self.log.n_queries]
                if isinstance(split, str) else None)
            kw.update(budget=constraint.total, budget_split=split,
                      constraint=constraint)
        elif budget_split is not _UNSET:
            kw.update(budget_split=None, constraint=None)  # explicit opt-out
        elif base.constraint is not None:
            # an explicit constraint object (no budget_split spec) carries
            # through refits, rescaled to any new total
            if "budget" in kw and hasattr(base.constraint, "scaled"):
                kw["constraint"] = base.constraint.scaled(kw["budget"])
        config = base.replace(**kw, **cfg_kw)
        spec = registry.get_solver(config.solver)
        if spec.needs_data:
            raise ValueError(
                f"refit() requires an SCSK solver (got {config.solver!r}): "
                "flow baselines consume the full TieringData whose weights "
                "are frozen at mine() time")
        if state is not None and not spec.supports_state:
            raise ValueError(
                f"solver {config.solver!r} does not support warm starts; "
                "pass state=None for a cold refit")
        if state is not None and state.covered_d.shape[0] != self.problem.wd:
            raise ValueError(
                f"stale warm-start state: covered_d has "
                f"{state.covered_d.shape[0]} words but the problem has "
                f"wd={self.problem.wd}; re-derive it with problem.state_for "
                "before refitting")
        self.problem = self.problem.with_weights(weights)
        if state is not None and config.partitioned:
            # re-allocation can shrink a cap below the warm prefix's fill;
            # solvers only mask new candidates, so shed the overflow first
            state, _ = trim_state(self.problem, state,
                                  resolve_constraint(self.problem, config))
        self.config = config
        self.result = registry.solve(self.problem, config, state=state)
        self._tiering = None
        return self

    def adopt_selection(self, state: SolverState) -> "TieringPipeline":
        """Install an externally evolved selection as the current result, so
        that `tiering()`, `refit(state=...)` and `deploy` see it. The state
        must be sized for the current problem."""
        if self.result is None:
            raise RuntimeError("call solve() before adopt_selection()")
        if state.covered_d.shape[0] != self.problem.wd:
            raise ValueError(
                f"state covered_d has {state.covered_d.shape[0]} words, "
                f"problem has wd={self.problem.wd}; derive the state against "
                "the current problem")
        self.result.state = state
        self.result.selected = state.selected.cpu().numpy()
        self.result.f_final = float(self.problem.f_value(state.covered_q))
        self.result.g_final = float(state.g_used)
        self._tiering = None
        return self

    # -- artifacts -----------------------------------------------------------
    def tiering(self) -> ClauseTiering:
        """The deployable ψ/φ artifact for the current solve."""
        if self.result is None:
            raise RuntimeError("call solve() before tiering()")
        if self.config is not None and \
                registry.get_solver(self.config.solver).needs_data:
            raise RuntimeError(
                f"solver {self.config.solver!r} is a flow baseline: it "
                "selects a document set, not clauses, so there is no clause "
                "tiering to deploy (ψ^flow cannot serve novel queries, paper "
                "§2.3). Its artifacts are in result.extra['flow'].")
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

    def deploy_cluster(self, *, n_shards: int | None = None,
                       t1_replicas: int = 2, t2_replicas: int = 1,
                       trace_capacity: int | None | str = "default",
                       cache=None):
        """-> cluster.TieredCluster: the same tiering served by a sharded,
        replicated fleet (scatter-gather + rolling swaps), still exact, on
        the pipeline's device.

        `n_shards` defaults to the solve's partition count when the solve
        used a shard-aware `budget_split` (the fleet's shards then coincide
        with the budget partitions, so each B_k bounds exactly one shard's
        local Tier-1 sub-index), else 2. `trace_capacity` bounds the
        retained `BatchTrace` history (None = keep every batch). `cache`
        attaches a classify-keyed front-end result cache (True = defaults,
        an int = capacity, or a configured `cluster.ResultCache`)."""
        from repro_torch.cluster import TieredCluster
        from repro_torch.cluster.router import DEFAULT_TRACE_CAPACITY
        if n_shards is None:
            n_shards = self.n_partitions or 2
        if trace_capacity == "default":
            trace_capacity = DEFAULT_TRACE_CAPACITY
        return TieredCluster(self.data.postings, self.tiering(),
                             self.data.n_docs, n_shards=n_shards,
                             t1_replicas=t1_replicas,
                             t2_replicas=t2_replicas,
                             trace_capacity=trace_capacity,
                             cache=cache, device=self.device)

    def summary(self) -> str:
        parts = [f"{self.corpus.n_docs} docs", f"{self.log.n_queries} queries"]
        if self.data is not None:
            parts.append(f"{len(self.data.clauses)} clauses")
        if self.result is not None:
            parts.append(self.result.summary())
        return " | ".join(parts)
