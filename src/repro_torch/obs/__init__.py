"""repro_torch.obs — the fleet-wide telemetry plane.

The port's counterpart of `repro.obs`, with the same metric, label and
event names and the same JSONL snapshot layout, so that one reader (`python
-m repro_torch.launch.obs`) takes either package's files. Only the
kernel profiler's `path` label differs: "cuda" or "cpu" where the reference
says "pallas", "interpret" or "xla". Nothing here imports torch until a
span or the profiler is asked to wait for a CUDA tensor.

Numpy + stdlib observability for every layer of the system: a process-global `MetricsRegistry` of typed instruments, a
`SpanRecorder` for nested request/control-path traces, an `EventLog` for
discrete control-plane occurrences, and a per-window JSONL exporter.

The module-level singletons (`REGISTRY`, `SPANS`, `EVENTS`) are what the
instrumented call sites use, via the shortcuts below:

    words = obs.counter("cluster_words_total", labels=("tier", "shard"))
    words.inc(n, tier="t1", shard=k)

    with obs.span("t1_match", shard=k) as sp:
        hits = sp.sync(match_batch(...))

    obs.event("drift_detected", window=i, tv=signal.tv_distance)

On top of the raw plane sit two judgment layers: `SLO` (repro_torch.obs.slo) —
declarative SLO rules with multi-window burn-rate alerting, evaluated once
per exported window — and `PROFILER` (repro_torch.obs.profile) — the
per-dispatch kernel cost accountant behind `kernel_words_scanned_total`
and its achieved-vs-roofline rows (against the H100's HBM rate).

Everything is gated on one switch: `REPRO_OBS=0` in the environment (or
`obs.disable()` at runtime) turns the whole plane into no-ops — counters
skip, `span()` returns the shared `NULL_SPAN`, events drop, SLO
evaluation and kernel profiling never run — and serve results stay
bit-identical (pinned by tests/test_torch_obs.py). Instruments built directly with `always=True` (e.g. the
loadgen latency histogram) bypass the switch so simulation OUTPUTS never
depend on it.
"""
from __future__ import annotations

from repro_torch.obs import _state
from repro_torch.obs.events import DEFAULT_EVENT_CAPACITY, EventLog
from repro_torch.obs.export import DEFAULT_DIR, JsonlExporter, load_dir, read_jsonl
from repro_torch.obs.profile import HBM_BW, ICI_BW, PEAK_FLOPS, KernelProfiler
from repro_torch.obs.registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                                MetricsRegistry)
from repro_torch.obs.render import fmt_value, render_line
from repro_torch.obs.ring import Ring
from repro_torch.obs.slo import SLOEngine, SLORule, default_slo_rules
from repro_torch.obs.spans import (DEFAULT_SPAN_CAPACITY, NULL_SPAN, Span,
                             SpanRecorder)

__all__ = [
    "REGISTRY", "SPANS", "EVENTS", "SLO", "PROFILER",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Ring",
    "SpanRecorder", "Span", "NULL_SPAN", "EventLog", "JsonlExporter",
    "SLOEngine", "SLORule", "default_slo_rules", "KernelProfiler",
    "counter", "gauge", "histogram", "span", "event",
    "enabled", "disabled", "enable", "disable", "set_enabled",
    "set_exporter", "get_exporter", "export_window", "dashboard", "reset",
    "read_jsonl", "load_dir", "render_line", "fmt_value",
    "DEFAULT_BUCKETS", "DEFAULT_DIR",
    "DEFAULT_SPAN_CAPACITY", "DEFAULT_EVENT_CAPACITY",
    "PEAK_FLOPS", "HBM_BW", "ICI_BW",
]

REGISTRY = MetricsRegistry()
SPANS = SpanRecorder()
EVENTS = EventLog()
SLO = SLOEngine(REGISTRY, EVENTS)
PROFILER = KernelProfiler(REGISTRY)

_exporter: JsonlExporter | None = None
_span_cursor = 0
_event_cursor = 0


# -- the switch ----------------------------------------------------------------
def enabled() -> bool:
    return _state.on


def disabled() -> bool:
    return not _state.on


def enable() -> bool:
    """Turn collection on process-wide; returns the previous setting."""
    return _state.enable()


def disable() -> bool:
    """Turn collection off process-wide; returns the previous setting."""
    return _state.disable()


def set_enabled(value: bool) -> bool:
    """Set the switch to `value`; returns the previous setting (so callers
    can save/restore around a scoped section)."""
    return _state.set_enabled(value)


# -- instruments ---------------------------------------------------------------
def counter(name: str, help: str = "",  # noqa: A002
            labels: tuple[str, ...] = ()) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "",  # noqa: A002
          labels: tuple[str, ...] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "",  # noqa: A002
              labels: tuple[str, ...] = (),
              buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets)


def span(name: str, **attrs):
    """A context-managed `Span` — or the no-op `NULL_SPAN` when disabled,
    so the hot path never allocates."""
    if not _state.on:
        return NULL_SPAN
    return SPANS.span(name, **attrs)


def event(kind: str, **fields) -> dict | None:
    if not _state.on:
        return None
    return EVENTS.emit(kind, **fields)


# -- export --------------------------------------------------------------------
def set_exporter(exporter: JsonlExporter | None) -> JsonlExporter | None:
    """Install (or clear, with None) the process exporter. Controllers call
    `export_window` unconditionally; without an installed exporter it is a
    no-op, so test runs don't spray snapshot files."""
    global _exporter, _span_cursor, _event_cursor
    prev, _exporter = _exporter, exporter
    _span_cursor = SPANS.seq
    _event_cursor = EVENTS.seq
    return prev


def get_exporter() -> JsonlExporter | None:
    return _exporter


def snapshot_window(index: int, **extra) -> dict:
    """Build (without writing) one window snapshot; advances the span and
    event cursors so the next snapshot carries only new activity.

    SLO rules are evaluated FIRST, so a breach/recovery transition lands in
    this window's `events` delta and the primed `slo_breaches_total` series
    in its `metrics`. The `rings` block surfaces span/event retention
    (`n_seen`/`n_dropped`) so silent truncation never reads as coverage —
    `launch.obs --check --max-dropped-frac` gates on it."""
    global _span_cursor, _event_cursor
    import time
    slo = SLO.evaluate(index)
    snap = {
        "window": index,
        "ts": time.time(),
        "metrics": REGISTRY.collect(),
        "spans": SPANS.since(_span_cursor),
        "events": EVENTS.since(_event_cursor),
        "slo": slo,
        "rings": {
            "spans": {"n_seen": SPANS.ring.n_seen,
                      "n_dropped": SPANS.ring.n_dropped},
            "events": {"n_seen": EVENTS.ring.n_seen,
                       "n_dropped": EVENTS.ring.n_dropped},
        },
    }
    snap.update(extra)
    _span_cursor = SPANS.seq
    _event_cursor = EVENTS.seq
    return snap


def export_window(index: int, **extra) -> dict | None:
    """Snapshot + write one window to the installed exporter. No-op (returns
    None) when the plane is disabled or no exporter is installed."""
    if not _state.on or _exporter is None:
        return None
    snap = snapshot_window(index, **extra)
    _exporter.export(snap)
    return snap


def dashboard() -> str:
    """One human line over the whole registry — the launchers print this."""
    pairs = [
        ("queries", int(REGISTRY.total("serve_queries_total"))
         or int(REGISTRY.total("cluster_queries_total"))),
        ("t1_hits", int(REGISTRY.total("serve_tier1_hits_total"))),
        ("words", int(REGISTRY.total("serve_words_total"))
         or int(REGISTRY.total("cluster_words_total"))),
        ("refits", int(REGISTRY.total("refits_total")) or None),
        ("swaps", int(REGISTRY.total("swaps_total")) or None),
        ("admitted", int(REGISTRY.total("admission_total")) or None),
        ("kernel_words",
         int(REGISTRY.total("kernel_words_scanned_total")) or None),
        ("events", len(EVENTS) or None),
        ("spans", len(SPANS.ring) or None),
        ("slo", SLO.segment()),
    ]
    return render_line("obs:", [(k, v) for k, v in pairs if v is not None])


def reset() -> None:
    """Zero every series and drop spans/events/cursors plus SLO burn state
    and profiler aggregation (tests, A/B arms). Instrument registrations,
    installed SLO rules and the installed exporter survive."""
    global _span_cursor, _event_cursor
    REGISTRY.reset()
    SPANS.reset()
    EVENTS.reset()
    SLO.reset()
    PROFILER.reset()
    _span_cursor = 0
    _event_cursor = 0
