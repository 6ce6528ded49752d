"""The ingest control loop: serve → ingest → (maybe) refit, per window.

`IngestController` grows `stream.RetieringController` with a live-corpus leg.
Each window:

  1. serve the window's queries (in small chunks, so rolling corpus swaps
     interleave with traffic the way a live fleet sees them);
  2. INGEST the window's document arrivals (`DocumentFeed`):
       a. append them to the corpus as one word-aligned block
          (`data.incidence.append_docs`) and grow the device problem
          (`SCSKProblem.with_doc_block`) — existing words never move;
       b. MANDATORY admission: with the selection fixed, any new doc matching
          a selected clause must enter Tier 1 (Theorem 3.1) — re-deriving the
          solver state from the fixed selection (`state_for`) against the
          grown problem does exactly that, and may overspend caps: eviction
          is deferred to the next warm refit (`trim_state` sheds overflow);
       c. OPTIONAL admission: clauses the last solve skipped but the new
          block activated are offered one-pass to the secretary-style
          `AdmissionPolicy`, scored by live marginal ratio through the
          existing f/g kernels and gated on real `KnapsackConstraint`
          headroom;
       d. roll the fleet to the new corpus version (`swap_corpus`): rolling
          replica-by-replica by default, or stop-the-world (`immediate`) as
          the comparison arm;
  3. on drift triggers, warm-refit exactly as the base loop — against the
     grown problem, with per-shard caps grown to the appended bounds.

Budget policy: `"track_corpus"` scales the caps with document growth (the
fleet buys shelf space as the corpus grows — coverage comparisons stay
budget-fair per doc); `"fixed"` keeps the original caps (ingest squeezes the
existing budget).

The port's counterpart of `repro.ingest.controller`, on the port's
`RetieringController`, with the same reports and decisions. Each optional
offer is a one-row `f_gains` (`bit_matvec`) and a one-row
`constraint.gains` (`coverage_gain` or `partition_gain`) on the problem's
device, read back to the host for the policy. A deployment held on a device
grows its postings there (`append_docs`); its clause bits are the problem's
own, so after `with_doc_block` the data points at the grown tensor and the
old problem is dropped before anything else is built.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import bitset
from repro_torch.core.constraint import (GlobalBudget, PartitionedBudget,
                                         resolve_constraint)
from repro_torch.data import incidence
from repro_torch.ingest.admission import AdmissionPolicy
from repro_torch.ingest.feed import DocumentFeed
from repro_torch.obs.render import render_line
from repro_torch.serve.engine import ServeStats
from repro_torch.stream.controller import RetieringController, WindowReport
from repro_torch.stream.drift import TrafficSimulator, TrafficWindow

_ADMISSION = obs.counter("admission_total",
                         "optional-admission offer decisions",
                         labels=("decision",))
_INGESTED = obs.counter("ingest_docs_total", "documents appended")
_CORPUS_V = obs.gauge("corpus_version", "live corpus version")
_REJECT_FRAC = obs.gauge("admission_reject_frac",
                         "rejected fraction of this window's offers")


@dataclasses.dataclass
class IngestWindowReport:
    """One window of the serve → ingest → refit loop."""
    serve: WindowReport
    n_arrived: int = 0           # docs the feed delivered this window
    n_docs: int = 0              # corpus size after the append
    corpus_version: int = 0      # engine corpus version after the swap
    n_mandatory: int = 0         # Tier-1 docs added by the fixed selection
    n_offers: int = 0            # optional clauses offered to the policy
    n_admitted: int = 0          # ... of which admitted
    cap_overflow: float = 0.0    # max docs over any cap after mandatory growth
    ingest_seconds: float = 0.0  # append + admission + swap wall time
    ingest_ok: bool | None = None  # served-vs-reference parity (verify only)

    def line(self) -> str:
        return render_line(self.serve.line(), [
            ("@docs", f"+{self.n_arrived}docs "
                      f"(v{self.corpus_version}, {self.n_docs} total)"),
            ("admit", f"{self.n_admitted}/{self.n_offers}"),
            ("t1+", self.n_mandatory),
            ("ingest", self.ingest_ok)])

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if f.name != "serve"}
        d["serve"] = self.serve.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "IngestWindowReport":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        kw["serve"] = WindowReport.from_dict(d.get("serve", {}))
        return cls(**kw)


@dataclasses.dataclass
class IngestReport:
    """A whole ingest run: per-window reports + cumulative serve stats."""
    scenario: str
    windows: list[IngestWindowReport]
    cumulative: ServeStats
    rollout: str = "rolling"
    admission_summary: str = ""

    @property
    def mean_coverage(self) -> float:
        return float(np.mean([w.serve.coverage for w in self.windows])) \
            if self.windows else 0.0

    @property
    def late_coverage(self) -> float:
        """Mean windowed coverage over the back half of the run — where the
        admission policy has had arrivals to act on (the A/B metric)."""
        if not self.windows:
            return 0.0
        tail = self.windows[len(self.windows) // 2:]
        return float(np.mean([w.serve.coverage for w in tail]))

    @property
    def n_ingested(self) -> int:
        return sum(w.n_arrived for w in self.windows)

    @property
    def n_admitted(self) -> int:
        return sum(w.n_admitted for w in self.windows)

    @property
    def n_refits(self) -> int:
        return sum(1 for w in self.windows if w.serve.refit)

    def failed_windows(self) -> int:
        """Windows where a performed check failed — served-vs-reference
        parity (`ingest_ok`) or refit parity — the bench's outage count."""
        return sum(1 for w in self.windows
                   if w.ingest_ok is False or w.serve.parity_ok is False)

    def summary(self) -> str:
        return render_line(f"[{self.scenario}/{self.rollout}]", [
            ("@windows", f"{len(self.windows)} windows"),
            ("@docs", f"+{self.n_ingested} docs"),
            ("admitted", self.n_admitted),
            ("mean_cov", self.mean_coverage),
            ("late_cov", self.late_coverage),
            ("refits", self.n_refits),
            ("failed", self.failed_windows())])

    def to_dict(self) -> dict:
        return {"scenario": self.scenario, "rollout": self.rollout,
                "admission_summary": self.admission_summary,
                "windows": [w.to_dict() for w in self.windows],
                "cumulative": self.cumulative.to_dict(),
                "mean_coverage": self.mean_coverage,
                "late_coverage": self.late_coverage,
                "n_ingested": self.n_ingested, "n_admitted": self.n_admitted,
                "n_refits": self.n_refits,
                "failed_windows": self.failed_windows()}

    @classmethod
    def from_dict(cls, d: dict) -> "IngestReport":
        return cls(scenario=d["scenario"],
                   windows=[IngestWindowReport.from_dict(w)
                            for w in d.get("windows", [])],
                   cumulative=ServeStats.from_dict(d.get("cumulative", {})),
                   rollout=d.get("rollout", "rolling"),
                   admission_summary=d.get("admission_summary", ""))


class IngestController(RetieringController):
    """Drift-aware re-tiering PLUS live document ingestion.

    `rollout="rolling"` swaps corpus versions replica-by-replica through the
    cluster's `swap_corpus` (single engines are inherently stop-the-world);
    `"stw"` forces `immediate=True` — the A/B comparison arm. `admission`
    None disables optional admission (mandatory Theorem-3.1 growth always
    happens; without it exactness would break the moment a doc arrived).
    """

    def __init__(self, pipe, *, feed: DocumentFeed,
                 admission: AdmissionPolicy | None = None,
                 rollout: str = "rolling",
                 budget_policy: str = "track_corpus",
                 verify_ingest: bool = False,
                 serve_batch: int | None = 64, **kw):
        if rollout not in ("rolling", "stw"):
            raise ValueError(f"rollout must be 'rolling' or 'stw', "
                             f"got {rollout!r}")
        if budget_policy not in ("track_corpus", "fixed"):
            raise ValueError(f"budget_policy must be 'track_corpus' or "
                             f"'fixed', got {budget_policy!r}")
        super().__init__(pipe, serve_batch=serve_batch, **kw)
        self.feed = feed
        self.admission = admission
        self.rollout = rollout
        self.budget_policy = budget_policy
        self.verify_ingest = verify_ingest

    # -- the loop -------------------------------------------------------------
    def step(self, window: TrafficWindow) -> IngestWindowReport:
        report, weights, signal, queries = self._serve_window(window)
        irep = self._ingest(window, weights)
        irep.serve = report
        if signal.triggered and self.enable_refit:
            self._refit_window(report, weights, queries)
        self._observe_window(irep, serve=report)
        return irep

    def run(self, simulator: TrafficSimulator) -> IngestReport:
        reports = [self.step(w) for w in simulator.windows()]
        return IngestReport(
            scenario=simulator.scenario, windows=reports,
            cumulative=self.cumulative, rollout=self.rollout,
            admission_summary=self.admission.summary()
            if self.admission else "off")

    # -- ingest ---------------------------------------------------------------
    def _ingest(self, window: TrafficWindow,
                weights: np.ndarray) -> IngestWindowReport:
        t0 = time.perf_counter()
        irep = IngestWindowReport(serve=None)  # caller splices the serve leg
        docs = self.feed.window(window.index, window.probs)
        irep.n_arrived = len(docs)
        if not docs:
            irep.n_docs = self.pipe.data.n_docs
            irep.corpus_version = getattr(self.engine, "corpus_version", 0)
            return irep
        with obs.span("ingest", window=window.index, n_docs=len(docs)):
            self._ingest_inner(window, weights, irep, docs)
        _INGESTED.inc(irep.n_arrived)
        _CORPUS_V.set(irep.corpus_version)
        obs.event("append", window=window.index, n_arrived=irep.n_arrived,
                  n_docs=irep.n_docs, corpus_version=irep.corpus_version,
                  n_mandatory=irep.n_mandatory, n_offers=irep.n_offers,
                  n_admitted=irep.n_admitted)
        irep.ingest_seconds = time.perf_counter() - t0
        return irep

    def _ingest_inner(self, window: TrafficWindow, weights: np.ndarray,
                      irep: IngestWindowReport, docs) -> None:
        pipe = self.pipe
        with obs.span("append", n_docs=len(docs)):
            # a device deployment shares the problem's clause bits: append_docs
            # drops them, with_doc_block grows them, the data adopts those
            shared = isinstance(pipe.data.clause_doc_bits, torch.Tensor)
            delta = incidence.append_docs(pipe.data, docs)
            pipe.problem = problem = pipe.problem.with_doc_block(
                delta.clause_cols, delta.n_docs)
            if shared:
                pipe.data.clause_doc_bits = problem.clause_doc_bits
            self._grow_budget(delta)

        # mandatory admission (Theorem 3.1): the state re-derived from the
        # FIXED selection against the grown problem folds every new doc a
        # selected clause matches into Tier 1 — overspent caps are shed at
        # the next warm refit, never here
        with obs.span("admission"):
            selected = np.asarray(pipe.result.selected)
            t1_before = int(pipe.result.g_final)
            state = problem.state_for(np.nonzero(selected)[0])
            constraint = resolve_constraint(problem, pipe.config)
            if self.admission is not None:
                state = self._admit(problem, state, constraint, delta,
                                    weights, irep)
            fills = constraint.np_value(bitset.to_numpy(state.covered_d))
            caps = np.asarray(constraint.caps, np.float64) \
                if isinstance(constraint, PartitionedBudget) \
                else np.asarray([constraint.total], np.float64)
            irep.cap_overflow = float(np.maximum(fills - caps, 0.0).max())
            pipe.adopt_selection(state)
            irep.n_mandatory = max(0, int(pipe.result.g_final) - t1_before)
        if irep.n_mandatory:
            obs.event("mandatory_admission", window=window.index,
                      n_docs_t1=irep.n_mandatory,
                      cap_overflow=irep.cap_overflow)

        with obs.span("swap", kind="corpus"):
            irep.corpus_version = self.engine.swap_corpus(
                pipe.data.postings, delta.n_docs, pipe.tiering(),
                immediate=(self.rollout == "stw"))
            if hasattr(self.engine, "corpus_version"):
                irep.corpus_version = self.engine.corpus_version
        irep.n_docs = delta.n_docs
        if self.verify_ingest:
            irep.ingest_ok = self._check_parity(
                [self.queries[i] for i in window.query_ids[:64]])

    def _admit(self, problem, state, constraint, delta, weights,
               irep: IngestWindowReport):
        """One-pass secretary offers over the clauses the new block ACTIVATED
        (nonzero match bits among appended docs) but the solve didn't select.
        Ratios use the CURRENT decayed traffic weights — admission chases the
        live distribution, not the one the last refit solved against."""
        activated = np.nonzero(
            (bitset.np_popcount(np.asarray(delta.clause_cols)) > 0)
            & ~state.selected.cpu().numpy())[0]
        if not len(activated):
            return state
        wpad = np.zeros(problem.wq * 32, np.float32)
        wpad[:len(weights)] = np.asarray(weights, np.float32)
        wdev = torch.from_numpy(wpad).to(problem.device)
        for j in activated:
            rows_q = problem.clause_query_bits[int(j):int(j) + 1]
            rows_d = problem.clause_doc_bits[int(j):int(j) + 1]
            fg = float(problem.f_gains(state.covered_q, rows=rows_q,
                                       weights=wdev)[0])
            _, g_part = constraint.gains(problem, state.covered_d,
                                         rows=rows_d)
            used = constraint.used(problem, state)
            feasible = bool(constraint.feasible(used, g_part)[0])
            g_tot = float(g_part.sum())
            ratio = fg / max(g_tot, 1.0)
            irep.n_offers += 1
            accepted = self.admission.offer(int(j), ratio, feasible)
            _ADMISSION.inc(decision="accept" if accepted else "reject")
            obs.event("admission", clause=int(j), ratio=round(ratio, 6),
                      feasible=feasible, accepted=accepted)
            if accepted:
                state = problem.apply(state, int(j))
                irep.n_admitted += 1
        if irep.n_offers:
            _REJECT_FRAC.set(round(
                1.0 - irep.n_admitted / irep.n_offers, 6))
        return state

    def _grow_budget(self, delta) -> None:
        """Align the knapsack with the appended doc space.

        Partitioned caps MUST grow their bounds to the new width (the last
        partition absorbs the appended words, mirroring `shard.grow_shards`)
        or every subsequent gains/feasibility call would misalign; whether
        the CAPS grow too is `budget_policy`. The explicit constraint then
        replaces any `budget_split` spec — re-allocation from traffic would
        silently rebuild stale bounds on the next refit."""
        pipe = self.pipe
        if pipe.config is None:
            return
        growth = delta.n_docs / max(delta.doc_lo, 1)
        scale = growth if self.budget_policy == "track_corpus" else 1.0
        cfg, split = pipe.config, pipe.config.budget_split
        if cfg.constraint is not None:
            old = cfg.constraint
        elif split is None:
            old = GlobalBudget(budget=float(cfg.budget))
        elif isinstance(split, str):
            return  # pipeline always pairs a string split with a constraint
        else:
            # caps spec never resolved to an object: bounds follow the
            # PRE-append doc space (delta.doc_lo), matching the fleet's plan
            old = PartitionedBudget.from_split(delta.doc_lo, split)
        if isinstance(old, PartitionedBudget):
            bounds = old.bounds[:-1] + (delta.word_hi,)
            caps = np.asarray(old.caps, np.float32).copy()
            # grow mode puts every appended word in the LAST partition
            # (shard.grow_shards), so the shelf space the growth buys goes
            # entirely to the last cap — proportional scaling would starve
            # it (mandatory admissions land there) while padding partitions
            # that gained no docs
            caps[-1] += old.total * (scale - 1.0)
            new = PartitionedBudget(caps=caps, bounds=bounds)
            pipe.config = pipe.config.replace(
                constraint=new, budget=new.total, budget_split=None)
            self._bounds = new.bounds
            qdb = pipe.data.query_doc_bits
            self._shard_mass = np.stack(
                [bitset.np_popcount(qdb[:, lo:hi]).astype(np.float64)
                 for lo, hi in zip(self._bounds, self._bounds[1:])], axis=1)
            self._shard_ref = self._shard_dists(self.accumulator.weights())
        elif isinstance(old, GlobalBudget):
            budget = float(old.total) * scale
            pipe.config = pipe.config.replace(
                budget=budget,
                constraint=GlobalBudget(budget=budget)
                if pipe.config.constraint is not None else None)

    # -- Theorem 3.1 spot check, corpus-version aware --------------------------
    def _check_parity(self, queries: list[tuple[int, ...]]) -> bool:
        """Served match sets == single-tier oracle AT THE VERSION SERVED.

        Mid-ingest-rollout a cluster legitimately serves an older corpus
        version; the oracle must be pinned to that version (the fleet's
        per-buffer Tier-2 snapshot), not the newest postings."""
        sample = queries[:64]
        if not sample:
            return True
        got = self.engine.serve(sample)
        trace = getattr(self.engine, "trace", None)
        if trace:
            want = self.engine.serve_reference(
                sample, corpus_version=trace[-1].corpus_version)
        else:
            want = self.engine.serve_reference(sample)
        return all(np.array_equal(a, b) for a, b in zip(got, want))


def run_ingest(pipe, *, scenario: str = "rotate", n_windows: int = 8,
               queries_per_window: int = 512, seed: int = 0,
               strength: float = 1.0,
               arrivals_per_window: float = 32.0, correlation: float = 0.6,
               admission: bool | AdmissionPolicy = True,
               enable_refit: bool = True, engine=None,
               rollout: str = "rolling", budget_policy: str = "track_corpus",
               verify: bool = False, **controller_kw) -> IngestReport:
    """Replay a drift scenario with live document ingestion end to end.

    `engine` accepts anything with the corpus-swap serving surface — a
    `serve.TieredEngine` (stop-the-world by nature) or a
    `cluster.TieredCluster` (rolling corpus swaps). The feed is seeded from
    `seed`, so A/B arms over the same seed see identical arrivals.
    """
    feed = DocumentFeed(log=pipe.log, vocab_size=pipe.corpus.vocab_size,
                        rate=arrivals_per_window, correlation=correlation,
                        seed=seed)
    policy = admission if isinstance(admission, AdmissionPolicy) else \
        (AdmissionPolicy() if admission else None)
    sim = TrafficSimulator(pipe.log, scenario, seed=seed, n_windows=n_windows,
                           queries_per_window=queries_per_window,
                           strength=strength)
    ctrl = IngestController(pipe, feed=feed, admission=policy,
                            rollout=rollout, budget_policy=budget_policy,
                            verify_ingest=verify, engine=engine,
                            enable_refit=enable_refit,
                            verify_swaps=verify, **controller_kw)
    return ctrl.run(sim)
