"""The re-tiering control loop: serve → accumulate → detect → refit → swap.

One `RetieringController.step(window)` call per traffic window:

  1. serve the window's queries through the live `TieredEngine`
     (per-window stats via `ServeStats.reset/snapshot`, cumulative via
     `merge` — the engine's counters are window-scoped under this loop);
  2. fold the window into the `LogAccumulator`'s decayed weights;
  3. feed windowed stats + weights to the `DriftDetector`;
  4. on a trigger, re-solve via `TieringPipeline.refit`: prune stale clauses
     from the previous `SolverState` (`prune_state`) and warm-start from the
     rest — falling back to a cold solve if the warm tiering would cover
     less of the current traffic than the deployed one — then
  5. `TieredEngine.swap_tiering` the new generation in atomically.

Theorem 3.1 exactness is preserved on every window: ψ and D₁ always come
from one clause selection, whatever the weights that chose it.

The port's counterpart of `repro.stream.controller`. The per-tiering
eligibility of the whole query universe (predicted coverage, the
detector's anchor, the cold-fallback test) is the ψ the engine serves
with: the universe's padded tokens are packed on the pipeline's device in
chunks and tested by `ops.clause_match`, the same function as
`ClauseTiering.classify_queries` (the host reference).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import bitset
from repro_torch.kernels import ops
from repro_torch.obs.render import render_line
from repro_torch.serve import matching
from repro_torch.serve.engine import ServeStats, TieredEngine
from repro_torch.stream.detector import DriftDetector
from repro_torch.stream.drift import TrafficSimulator, TrafficWindow
from repro_torch.stream.window import (LogAccumulator, prune_partitions,
                                       prune_state)

# query words packed per ψ chunk of the universe (int64 scratch: 8 B a word)
_ELIG_CHUNK_WORDS = 1 << 26

_REFITS = obs.counter("refits_total", "re-solves shipped", labels=("kind",))
_W_COV = obs.gauge("window_coverage", "last window's Tier-1 eligible fraction")
_W_SAVING = obs.gauge("window_cost_saving", "last window's word-traffic saving")
_W_TV = obs.gauge("window_tv_distance", "drift signal vs last refit")
_GEN = obs.gauge("live_generation", "tiering generation serving traffic")
_REFIT_S = obs.gauge("refit_seconds", "last refit wall-clock, seconds")
_W_CACHE = obs.gauge("frontend_cache_hit_rate",
                     "last window's front-end result-cache hit rate")


@dataclasses.dataclass
class WindowReport:
    """Everything the loop observed and did during one window."""
    index: int
    stats: ServeStats            # this window's serve counters (detached)
    coverage: float              # windowed Tier-1 eligible fraction
    cost_saving: float           # windowed word-traffic saving
    tv_distance: float           # drift signal vs last refit
    refit: str = ""              # "" | "warm" | "cold"
    refit_steps: int = 0         # selections made by the refit solve
    refit_seconds: float = 0.0   # wall time: prune + solve + build + swap
    pruned: int = 0              # clauses dropped before the warm start
    generation: int = 0          # engine generation serving this window's END
    parity_ok: bool | None = None  # Theorem-3.1 spot check (verify_swaps)
    shard_tv: tuple[float, ...] = ()  # per-shard TV drift (partitioned only)
    scope: tuple[int, ...] = ()  # shards a scoped warm refit re-tiered

    def line(self) -> str:
        refit = f"{self.refit}({self.refit_steps} steps, " \
                f"{self.refit_seconds:.2f}s, -{self.pruned})" if self.refit \
                else "-"
        return render_line(f"window {self.index:3d}", [
            ("cov", self.coverage), ("saving", self.cost_saving),
            ("tv", self.tv_distance), ("refit", refit),
            ("gen", self.generation),
            ("cache_hit", self.stats.cache_hit_rate
             if self.stats.cache_hits else None),
            ("scope", list(self.scope) if self.scope else None),
            ("parity", self.parity_ok)])

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if f.name != "stats"}
        d["stats"] = self.stats.to_dict()
        d["shard_tv"] = list(self.shard_tv)
        d["scope"] = list(self.scope)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "WindowReport":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        kw["stats"] = ServeStats.from_dict(d.get("stats", {}))
        kw["shard_tv"] = tuple(kw.get("shard_tv", ()))
        kw["scope"] = tuple(kw.get("scope", ()))
        return cls(**kw)


@dataclasses.dataclass
class StreamReport:
    """A whole run: per-window reports + cumulative serve stats."""
    scenario: str
    windows: list[WindowReport]
    cumulative: ServeStats

    @property
    def mean_coverage(self) -> float:
        return float(np.mean([w.coverage for w in self.windows])) \
            if self.windows else 0.0

    @property
    def n_refits(self) -> int:
        return sum(1 for w in self.windows if w.refit)

    @property
    def n_warm(self) -> int:
        return sum(1 for w in self.windows if w.refit == "warm")

    @property
    def n_parity_checks(self) -> int:
        return sum(1 for w in self.windows if w.parity_ok is not None)

    def parity_all_ok(self) -> bool:
        """True iff no performed check failed — vacuously true when nothing
        was checked; gate on `n_parity_checks` for a non-vacuous claim."""
        return all(w.parity_ok for w in self.windows
                   if w.parity_ok is not None)

    def summary(self) -> str:
        return render_line(f"[{self.scenario}]", [
            ("@windows", f"{len(self.windows)} windows"),
            ("mean_cov", self.mean_coverage),
            ("cum_saving", self.cumulative.cost_saving),
            ("refits", f"{self.n_refits} ({self.n_warm} warm)")])

    def to_dict(self) -> dict:
        return {"scenario": self.scenario,
                "windows": [w.to_dict() for w in self.windows],
                "cumulative": self.cumulative.to_dict(),
                "mean_coverage": self.mean_coverage,
                "n_refits": self.n_refits, "n_warm": self.n_warm}

    @classmethod
    def from_dict(cls, d: dict) -> "StreamReport":
        return cls(scenario=d["scenario"],
                   windows=[WindowReport.from_dict(w)
                            for w in d.get("windows", [])],
                   cumulative=ServeStats.from_dict(d.get("cumulative", {})))


class RetieringController:
    """Drift-aware online re-tiering over a solved `TieringPipeline`.

    The controller owns the serving engine, the decayed-log accumulator and
    the drift detector; the pipeline it wraps is mutated on refit (its
    problem is reweighted in place of the traffic, its result/tiering
    replaced). `enable_refit=False` turns the loop into the static-tiering
    baseline — same serving, same accounting, never re-solves — so A/B runs
    compare on identical traffic.
    """

    def __init__(self, pipe, *, engine: TieredEngine | None = None,
                 accumulator: LogAccumulator | None = None,
                 detector: DriftDetector | None = None,
                 warm: bool = True, enable_refit: bool = True,
                 prune_below: float = 2e-3, cold_fallback: bool = True,
                 blend_prior: float = 0.35, verify_swaps: bool = False,
                 scoped: bool = True, shard_tv_threshold: float = 0.15,
                 scope_frac: float = 0.5, serve_batch: int | None = None):
        self.pipe = pipe
        # serve a window in chunks of this many queries (None = one batch);
        # the ingest loop uses small chunks so rolling swaps interleave with
        # traffic the way a live fleet would see them
        self.serve_batch = serve_batch
        self.engine = engine if engine is not None else pipe.deploy()
        self.queries = pipe.log.queries
        nq = pipe.log.n_queries
        self.accumulator = accumulator if accumulator is not None else \
            LogAccumulator(nq, halflife=1.0,
                           prior=np.asarray(pipe.log.train_weights),
                           prior_strength=32.0)
        self.detector = detector if detector is not None else DriftDetector()
        self.warm = warm
        self.enable_refit = enable_refit
        self.prune_below = prune_below
        self.cold_fallback = cold_fallback
        # refits hedge: solve against (1-λ)·decayed + λ·long-term prior, so
        # the tiering tilts toward the hot traffic without abandoning the
        # baseline head (over-specializing loses the epoch-boundary windows)
        self.blend_prior = blend_prior
        self._prior = np.asarray(pipe.log.train_weights, np.float64)
        self._prior = self._prior / max(self._prior.sum(), 1e-30)
        self.verify_swaps = verify_swaps
        # the offline tiering is the refit quality bar: a warm candidate
        # predicting below it (or below the deployed tiering) triggers the
        # cold-solve fallback instead of shipping a regression
        self._baseline_tiering = self.engine.tiering
        self._elig_cache: list = []    # (tiering, eligibility mask) pairs
        self._query_tokens: torch.Tensor | None = None   # universe, padded
        self.cumulative = ServeStats()
        # shard-aware re-tiering: when the pipe solved with a budget_split,
        # track each doc partition's traffic distribution so refits can be
        # SCOPED — only the drifted shards' clauses are unfrozen and only
        # their caps get re-spent (global drift still re-solves everything)
        self.scoped = scoped
        self.shard_tv_threshold = shard_tv_threshold
        self.scope_frac = scope_frac
        self._bounds: tuple[int, ...] | None = None
        if pipe.config is not None and pipe.config.partitioned and \
                pipe.data is not None:
            from repro_torch.core.constraint import resolve_constraint
            constraint = resolve_constraint(pipe.problem, pipe.config)
            self._bounds = constraint.bounds
            qdb = pipe.data.query_doc_bits
            # mass[q, k] = |m(q) ∩ D_k|: each query's demand on shard k
            self._shard_mass = np.stack(
                [bitset.np_popcount(qdb[:, lo:hi]).astype(np.float64)
                 for lo, hi in zip(self._bounds, self._bounds[1:])], axis=1)
            self._shard_ref = self._shard_dists(self.accumulator.weights())
        self.detector.rebase(self.accumulator.weights(),
                             self.predicted_coverage(self.accumulator.weights()))

    # -- observability --------------------------------------------------------
    def _eligible(self, tiering) -> np.ndarray:
        """ψ eligibility over the query universe, cached per tiering object.

        The universe's padded tokens live on the pipeline's device; each
        chunk is packed there (`bitset.pack_tokens`) and classified by
        `ops.clause_match` against the tiering's clauses."""
        for t, elig in self._elig_cache:
            if t is tiering:
                return elig
        dev = self.pipe.device
        if self._query_tokens is None:
            self._query_tokens = torch.from_numpy(
                matching.pad_token_batch(self.queries)).to(dev)
        toks = self._query_tokens
        clause_bits = bitset.to_tensor(tiering.clause_vocab_bits, dev)
        step = max(1, _ELIG_CHUNK_WORDS // bitset.n_words(tiering.vocab_size))
        elig = torch.cat([
            ops.clause_match(bitset.pack_tokens(toks[lo:lo + step],
                                                tiering.vocab_size),
                             clause_bits)
            for lo in range(0, toks.shape[0], step)]).cpu().numpy()
        self._elig_cache = [(tiering, elig)] + self._elig_cache[:3]
        return elig

    def coverage_of(self, tiering, weights: np.ndarray) -> float:
        """Tier-1 eligible mass of `weights` under a given tiering."""
        return float(
            np.asarray(weights, np.float64)[self._eligible(tiering)].sum())

    def predicted_coverage(self, weights: np.ndarray) -> float:
        """Tier-1 eligible mass of `weights` under the DEPLOYED tiering."""
        return self.coverage_of(self.engine.tiering, weights)

    # -- per-shard drift ------------------------------------------------------
    def _shard_dists(self, weights: np.ndarray) -> np.ndarray:
        """Per-shard query distributions [Nq, P]: column k is the traffic a
        shard k machine sees, dist_k(q) ∝ w(q)·|m(q) ∩ D_k|."""
        d = np.asarray(weights, np.float64)[:, None] * self._shard_mass
        s = d.sum(axis=0)
        d = np.divide(d, s[None, :], out=np.full_like(d, 0.0),
                      where=s[None, :] > 0)
        d[:, s <= 0] = 1.0 / d.shape[0]
        return d

    def shard_drift(self, weights: np.ndarray) -> np.ndarray:
        """TV distance per shard between its CURRENT traffic distribution
        and the one at the last refit. Empty when the solve is unpartitioned."""
        if self._bounds is None:
            return np.empty(0)
        cur = self._shard_dists(weights)
        return 0.5 * np.abs(cur - self._shard_ref).sum(axis=0)

    # -- the loop -------------------------------------------------------------
    def _serve_window(self, window: TrafficWindow):
        """Serve + observe one window; returns (report, weights, signal,
        queries) so subclasses can splice work (e.g. ingest) between the
        serve and the refit decision."""
        self.engine.stats.reset()
        queries = [self.queries[i] for i in window.query_ids]
        bsz = self.serve_batch or len(queries) or 1
        for lo in range(0, len(queries), bsz):
            self.engine.serve(queries[lo:lo + bsz])
        wstats = self.engine.stats.snapshot()
        if self.cumulative.full_words_per_query not in \
                (0, wstats.full_words_per_query):
            # corpus grew since the last window: the cumulative saving
            # denominator follows the live width (merge pins equality)
            self.cumulative.full_words_per_query = \
                wstats.full_words_per_query
        self.cumulative.merge(wstats)

        self.accumulator.observe(window.query_ids)
        weights = self.accumulator.weights()
        signal = self.detector.update(wstats, weights,
                                      n_samples=self.accumulator.total())

        report = WindowReport(
            index=window.index, stats=wstats,
            coverage=wstats.tier1_fraction, cost_saving=wstats.cost_saving,
            tv_distance=signal.tv_distance, generation=self.engine.generation,
            shard_tv=tuple(float(t) for t in self.shard_drift(weights)))
        if signal.triggered:
            obs.event("drift_detected", window=window.index,
                      tv=float(signal.tv_distance),
                      coverage=float(wstats.tier1_fraction),
                      will_refit=bool(self.enable_refit))
        return report, weights, signal, queries

    def _refit_window(self, report: WindowReport, weights: np.ndarray,
                      queries: list[tuple[int, ...]]) -> None:
        lam = self.blend_prior
        solve_w = (1.0 - lam) * weights + lam * self._prior
        self._refit(solve_w, weights, report)
        if self.verify_swaps:
            report.parity_ok = self._check_parity(queries)

    def step(self, window: TrafficWindow) -> WindowReport:
        report, weights, signal, queries = self._serve_window(window)
        if signal.triggered and self.enable_refit:
            self._refit_window(report, weights, queries)
        self._observe_window(report)
        return report

    def _observe_window(self, report, serve: WindowReport | None = None
                        ) -> None:
        """Publish window gauges and (when an exporter is installed) one
        JSONL snapshot. `report` is what gets exported; `serve` points at
        its WindowReport leg when they differ (the ingest loop)."""
        s = serve if serve is not None else report
        _W_COV.set(s.coverage)
        _W_SAVING.set(s.cost_saving)
        _W_TV.set(s.tv_distance)
        _GEN.set(s.generation)
        if s.stats.cache_hits:      # fleet serves through a front-end cache
            _W_CACHE.set(round(s.stats.cache_hit_rate, 6))
        if obs.enabled() and obs.get_exporter() is not None:
            obs.export_window(s.index, report=report.to_dict())

    def run(self, simulator: TrafficSimulator) -> StreamReport:
        reports = [self.step(w) for w in simulator.windows()]
        return StreamReport(scenario=simulator.scenario, windows=reports,
                            cumulative=self.cumulative)

    # -- refit ----------------------------------------------------------------
    def _refit(self, solve_w: np.ndarray, raw_w: np.ndarray,
               report: WindowReport) -> None:
        with obs.span("refit", window=report.index):
            self._refit_inner(solve_w, raw_w, report)
        _REFITS.inc(kind=report.refit)
        _REFIT_S.set(round(report.refit_seconds, 4))
        obs.event("refit", window=report.index, mode=report.refit,
                  steps=report.refit_steps, pruned=report.pruned,
                  seconds=round(report.refit_seconds, 4),
                  generation=report.generation,
                  scope=list(report.scope))

    def _refit_inner(self, solve_w: np.ndarray, raw_w: np.ndarray,
                     report: WindowReport) -> None:
        t0 = time.perf_counter()
        prev = self.pipe.result
        deployed_cov = self.predicted_coverage(solve_w)
        kind = "cold"
        if self.warm and prev is not None and prev.state is not None:
            # prune under the NEW weights, then resume from what survives
            state, _, dropped = prune_state(
                self.pipe.problem, prev.state, weights=solve_w,
                min_unique_mass=self.prune_below)
            report.pruned = len(dropped)
            if self._bounds is not None and self.scoped:
                # scope the re-solve: unfreeze ONLY the drifted shards'
                # clauses (a drift everywhere degenerates to a full warm
                # re-solve, which is exactly right)
                tv = self.shard_drift(raw_w)
                drifted = tuple(int(k) for k in
                                np.nonzero(tv > self.shard_tv_threshold)[0])
                if drifted:
                    state, _, unfrozen = prune_partitions(
                        self.pipe.problem, state, self._bounds, drifted,
                        scope_frac=self.scope_frac)
                    report.scope = drifted
                    report.pruned += len(unfrozen)
            self.pipe.refit(solve_w, state=state)
            kind = "warm"
            baseline_cov = self.coverage_of(self._baseline_tiering, solve_w)
            if self.cold_fallback and \
                    self.coverage_of(self.pipe.tiering(), solve_w) + 1e-9 \
                    < max(deployed_cov, baseline_cov):
                # warm path couldn't un-specialize enough: pay for cold
                self.pipe.refit(solve_w, state=None)
                kind = "cold"
                report.pruned = 0          # cold solves don't prune
                report.scope = ()          # ... and aren't scoped
        else:
            self.pipe.refit(solve_w, state=None)
        with obs.span("swap"):
            buf = self.engine.prepare_tiering(self.pipe.tiering())  # off-path
            report.generation = self.engine.swap_tiering(buf)       # atomic
        self.detector.rebase(raw_w, self.predicted_coverage(raw_w))
        if self._bounds is not None:
            self._shard_ref = self._shard_dists(raw_w)
        report.refit = kind
        report.refit_steps = len(self.pipe.result.order)
        report.refit_seconds = time.perf_counter() - t0

    # -- Theorem 3.1 spot check -----------------------------------------------
    def _check_parity(self, queries: list[tuple[int, ...]]) -> bool:
        """Served match sets == single-tier oracle on a query sample."""
        sample = queries[:64]
        got = self.engine.serve(sample)
        want = self.engine.serve_reference(sample)
        return all(np.array_equal(a, b) for a, b in zip(got, want))


def run_stream(pipe, *, scenario: str = "rotate", n_windows: int = 8,
               queries_per_window: int = 512, seed: int = 0,
               strength: float = 1.0, warm: bool = True,
               enable_refit: bool = True, verify_swaps: bool = False,
               engine: TieredEngine | None = None,
               **controller_kw) -> StreamReport:
    """Replay a drift scenario end to end through a RetieringController.

    `engine` accepts anything with the TieredEngine serving surface — in
    particular a `cluster.TieredCluster`, whose `swap_tiering` rolls the
    re-tiering out replica-by-replica instead of one atomic store (the
    controller neither knows nor cares; exactness holds either way).
    """
    sim = TrafficSimulator(pipe.log, scenario, seed=seed, n_windows=n_windows,
                           queries_per_window=queries_per_window,
                           strength=strength)
    ctrl = RetieringController(pipe, engine=engine, warm=warm,
                               enable_refit=enable_refit,
                               verify_swaps=verify_swaps, **controller_kw)
    return ctrl.run(sim)
