"""Declarative SLO rules + SRE-style multi-window burn-rate alerting.

A copy of `repro.obs.slo` (numpy + stdlib).

An `SLORule` names a metric *spec* — a tiny expression language evaluated
against the live `MetricsRegistry` once per export window:

    gauge:NAME[{k=v,...}]   last written value (mean over matching series)
    delta:NAME[{k=v,...}]   counter increase since the previous window
    pQQ:NAME[{k=v,...}]     windowed percentile (QQ in (0, 100]) over a
                            histogram's bucket-count DELTAS since the
                            previous window — the registry histograms are
                            cumulative, so per-window tails need the diff
    ratio:A/B               windowed delta(A) / delta(B) over two counter
                            targets; None while the denominator is flat

plus a bound (`max=` and/or `min=`) saying what good looks like. Each
window the rule's indicator (in/out of bound) feeds two sliding burn
windows — a fast one for paging-grade spikes and a slow one so a single
blip doesn't alarm — and an alert fires only when BOTH burn fractions
exceed their thresholds (the multi-window burn-rate pattern from the SRE
workbook). Recovery has hysteresis: `clear_windows` consecutive good
windows before `slo_recovered`. Transitions land in the `EventLog`
(`slo_breach` / `slo_recovered`), increment `slo_breaches_total{rule=}`,
and the full per-rule status rides in every JSONL window snapshot under
`"slo"` (see `repro_torch.obs.snapshot_window`).

A rule with `when=` only counts windows where the guard spec clears
`when_min` — e.g. the refit wall-clock budget is judged only on windows
that actually refit, so a stale gauge never alarms.

Everything is inert under `REPRO_OBS=0`: `evaluate` returns `{}` without
touching rule state, so disabled runs stay bit-identical.
"""
from __future__ import annotations

import collections
import dataclasses
import re

import numpy as np

from repro_torch.obs import _state
from repro_torch.obs.registry import Counter, Gauge, Histogram, MetricsRegistry

_TARGET_RE = re.compile(r"^(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
                        r"(?:\{(?P<filt>[^}]*)\})?$")


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One objective: a metric spec, its bound, and burn-rate shaping."""
    name: str                    # rule id ("serve_p95", ...)
    metric: str                  # spec, e.g. "p95:loadgen_latency_ms"
    max: float | None = None     # breach indicator when value > max
    min: float | None = None     # breach indicator when value < min
    fast_windows: int = 1        # paging window (recent windows)
    slow_windows: int = 4        # confirmation window
    fast_burn: float = 1.0       # bad fraction of the fast window to alarm
    slow_burn: float = 0.5       # bad fraction of the slow window to alarm
    clear_windows: int = 2       # consecutive good windows to recover
    when: str | None = None      # guard spec: window counts only when ...
    when_min: float = 1.0        # ... eval(when) >= when_min

    def __post_init__(self):
        if self.max is None and self.min is None:
            raise ValueError(f"SLO rule {self.name!r} needs max= or min=")
        if self.fast_windows < 1 or self.slow_windows < self.fast_windows:
            raise ValueError(
                f"SLO rule {self.name!r} needs 1 <= fast_windows "
                f"<= slow_windows, got {self.fast_windows}/{self.slow_windows}")


class _RuleState:
    __slots__ = ("history", "breached", "last")

    def __init__(self):
        self.history: collections.deque = collections.deque(maxlen=64)
        self.breached = False
        self.last: dict[str, object] = {}   # spec -> prior cumulative value


def _parse_target(text: str) -> tuple[str, dict[str, str]]:
    m = _TARGET_RE.match(text.strip())
    if not m:
        raise ValueError(f"bad SLO metric target {text!r} "
                         "(want NAME or NAME{label=value,...})")
    filt = {}
    if m.group("filt"):
        for part in m.group("filt").split(","):
            k, sep, v = part.partition("=")
            if not sep:
                raise ValueError(f"bad label filter {part!r} in {text!r}")
            filt[k.strip()] = v.strip()
    return m.group("name"), filt


def _matching_series(inst, filt: dict) -> list:
    return [s for s in inst.to_dict()["series"]
            if all(s["labels"].get(k) == v for k, v in filt.items())]


def _percentile_of_counts(buckets: list[float], counts: np.ndarray,
                          q: float) -> float:
    """Bucket-interpolated percentile over windowed count deltas. The last
    entry of `counts` is the overflow bucket; a target landing there clamps
    to the top bound (the delta's true max is unknowable)."""
    target = counts.sum() * q / 100.0
    cum = np.cumsum(counts)
    b = int(np.searchsorted(cum, target, side="left"))
    if b >= len(buckets):
        return float(buckets[-1])
    lo = buckets[b - 1] if b > 0 else 0.0
    hi = buckets[b]
    prev = cum[b - 1] if b > 0 else 0.0
    frac = (target - prev) / max(counts[b], 1)
    return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))


class SLOEngine:
    """Evaluates the installed rules against a registry, once per window."""

    def __init__(self, registry: MetricsRegistry, events):
        self.registry = registry
        self.events = events
        self.rules: list[SLORule] = []
        self._rule_state: dict[str, _RuleState] = {}
        self._breaches = registry.counter(
            "slo_breaches_total", "good->breach transitions per SLO rule",
            labels=("rule",))

    # -- rule management ------------------------------------------------------
    def set_rules(self, rules) -> "SLOEngine":
        self.rules = list(rules)
        self._rule_state.clear()
        return self

    def add_rule(self, rule: SLORule) -> "SLOEngine":
        self.rules.append(rule)
        return self

    def reset(self) -> None:
        """Drop burn/breach/delta state; the installed rules survive."""
        self._rule_state.clear()

    # -- spec evaluation ------------------------------------------------------
    def _eval_spec(self, spec: str, st: _RuleState) -> float | None:
        kind, sep, rest = spec.partition(":")
        if not sep:
            raise ValueError(f"bad SLO metric spec {spec!r} (want KIND:...)")
        if kind == "ratio":
            num, sep, den = rest.partition("/")
            if not sep:
                raise ValueError(f"ratio spec {spec!r} wants NUM/DEN")
            da = self._eval_spec(f"delta:{num.strip()}", st)
            db = self._eval_spec(f"delta:{den.strip()}", st)
            if da is None or not db:
                return None
            return da / db
        if kind == "gauge":
            name, filt = _parse_target(rest)
            inst = self.registry.get(name)
            if not isinstance(inst, Gauge):
                return None
            series = _matching_series(inst, filt)
            if not series:
                return None
            return float(np.mean([s["value"] for s in series]))
        if kind == "delta":
            name, filt = _parse_target(rest)
            inst = self.registry.get(name)
            if not isinstance(inst, Counter):
                return None
            cur = float(sum(s["value"]
                            for s in _matching_series(inst, filt)))
            prev = st.last.get(spec)
            st.last[spec] = cur
            if prev is None:
                return cur                    # counters start at 0 per run
            return max(cur - float(prev), 0.0)   # obs.reset() rewinds them
        if kind.startswith("p"):
            q = float(kind[1:])
            if not 0.0 < q <= 100.0:
                raise ValueError(f"percentile spec {spec!r} wants p(0,100]")
            name, filt = _parse_target(rest)
            inst = self.registry.get(name)
            if not isinstance(inst, Histogram):
                return None
            series = _matching_series(inst, filt)
            counts = np.zeros(len(inst.buckets) + 1, np.int64)
            for s in series:
                counts += np.asarray(s["value"]["counts"], np.int64)
            prev = st.last.get(spec)
            st.last[spec] = counts
            delta = counts if prev is None else \
                np.maximum(counts - np.asarray(prev, np.int64), 0)
            if delta.sum() == 0:
                return None                   # no new observations: N/A
            return _percentile_of_counts(list(inst.buckets), delta, q)
        raise ValueError(f"unknown SLO metric spec kind {kind!r} in {spec!r}")

    # -- the per-window pass --------------------------------------------------
    def evaluate(self, window: int) -> dict:
        """Evaluate every rule against the current registry; emits breach /
        recovery transitions and returns the JSON-ready status payload.
        Complete no-op (returns {}) when the plane is disabled."""
        if not _state.on or not self.rules:
            return {}
        out: dict[str, dict] = {}
        for r in self.rules:
            st = self._rule_state.setdefault(r.name, _RuleState())
            # prime the series so the counter exports even when never burned
            self._breaches.inc(0, rule=r.name)
            value = self._eval_spec(r.metric, st)
            applicable = True
            if r.when is not None:
                guard = self._eval_spec(r.when, st)
                applicable = guard is not None and guard >= r.when_min
            bad = None
            if applicable and value is not None:
                bad = bool((r.max is not None and value > r.max)
                           or (r.min is not None and value < r.min))
                st.history.append(1.0 if bad else 0.0)
            h = list(st.history)
            fast = float(np.mean(h[-r.fast_windows:])) if h else 0.0
            slow = float(np.mean(h[-r.slow_windows:])) if h else 0.0
            transition = None
            if not st.breached:
                if len(h) >= r.fast_windows and fast >= r.fast_burn \
                        and slow >= r.slow_burn:
                    st.breached = True
                    transition = "slo_breach"
                    self._breaches.inc(1, rule=r.name)
            else:
                tail = h[-r.clear_windows:]
                if len(tail) >= r.clear_windows and not any(tail):
                    st.breached = False
                    transition = "slo_recovered"
            if transition:
                self.events.emit(transition, rule=r.name, window=window,
                                 metric=r.metric, value=value,
                                 max=r.max, min=r.min,
                                 fast_burn=round(fast, 4),
                                 slow_burn=round(slow, 4))
            out[r.name] = {"value": value, "bad": bad,
                           "breached": st.breached,
                           "fast_burn": round(fast, 4),
                           "slow_burn": round(slow, 4)}
        return {"rules": out,
                "breached": sorted(n for n, s in out.items()
                                   if s["breached"])}

    # -- status ---------------------------------------------------------------
    def breached(self) -> list[str]:
        return sorted(n for n, s in self._rule_state.items() if s.breached)

    def segment(self) -> str | None:
        """The dashboard fragment: None without rules, else ok/BREACH."""
        if not self.rules:
            return None
        b = self.breached()
        return f"BREACH({','.join(b)})" if b else f"ok({len(self.rules)})"


def default_slo_rules() -> list[SLORule]:
    """The fleet defaults the launchers install: generous bounds meant to
    catch pathologies (runaway tails, collapsed coverage, refits eating the
    window), not to page on tiny-scale noise."""
    return [
        SLORule("serve_p95", "p95:loadgen_latency_ms", max=250.0,
                fast_windows=1, slow_windows=4),
        SLORule("serve_p99", "p99:loadgen_latency_ms", max=1000.0,
                fast_windows=1, slow_windows=4),
        SLORule("coverage_floor", "gauge:window_coverage", min=0.01,
                fast_windows=2, slow_windows=4, fast_burn=1.0,
                slow_burn=0.5),
        SLORule("t2_fallback_rate",
                "ratio:cluster_fallback_batches_total/cluster_queries_total",
                max=0.5),
        SLORule("refit_budget", "gauge:refit_seconds", max=120.0,
                when="delta:refits_total", when_min=1.0),
        # secretary admission legitimately rejects almost every offer under
        # tight headroom; alarm only when essentially NOTHING gets through
        SLORule("admission_reject_rate",
                "ratio:admission_total{decision=reject}/admission_total",
                max=0.999, fast_windows=2, slow_windows=4),
        # front-end (cluster.frontend): a cache that stops hitting entirely
        # under repeat traffic means epoch churn or key instability (the
        # ratio is None — rule inert — until lookups actually flow), and a
        # fleet shedding most of its traffic is answering degraded
        SLORule("cache_hit_rate_floor",
                "ratio:frontend_cache_hits_total/frontend_cache_lookups_total",
                min=0.001, fast_windows=2, slow_windows=6),
        SLORule("shed_ratio_ceiling", "gauge:loadgen_shed_frac", max=0.5,
                fast_windows=2, slow_windows=4),
    ]
