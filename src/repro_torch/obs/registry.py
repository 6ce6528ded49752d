"""Typed metric instruments and the registry that names them.

A copy of `repro.obs.registry` (numpy + stdlib).

Three instrument kinds, all label-aware:

  * `Counter` — monotonic accumulators (queries served, words scanned,
    refits performed); `inc()` only, negative increments raise.
  * `Gauge` — last-write-wins point-in-time values (live generation,
    corpus version, window coverage).
  * `Histogram` — fixed-bucket distributions (latency, span durations);
    bucket bounds are pinned at registration so two snapshots of the same
    series are always mergeable bucket-by-bucket.

Series are keyed by label values (`shard`, `tier`, `solver`, `generation`,
`corpus_version`, ...). A `MetricsRegistry` maps names to instruments
idempotently — registering the same (name, kind, labelnames) twice returns
the same instrument, so callers never coordinate; a conflicting
re-registration raises instead of silently forking the series.

Hot-path cost: every mutator starts with one attribute check of
`_state.on` — with the plane disabled (`REPRO_OBS=0`) nothing else runs.
Detached instruments (constructed directly with `always=True`, e.g. the
loadgen latency histogram) record regardless of the switch, so simulation
outputs never depend on whether telemetry is on.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs import _state

# latency-shaped default: sub-0.1ms to 1s, roughly x2-x2.5 per step
DEFAULT_BUCKETS = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                   100.0, 200.0, 500.0, 1000.0)


class Instrument:
    kind = "instrument"

    def __init__(self, name: str, help: str = "",  # noqa: A002
                 labels: tuple[str, ...] = (), always: bool = False):
        self.name = name
        self.help = help
        self.labelnames = tuple(labels)
        self._always = always
        self._series: dict[tuple, object] = {}

    # -- label plumbing -------------------------------------------------------
    def _key(self, labels: dict) -> tuple:
        if len(labels) != len(self.labelnames) or \
                any(k not in labels for k in self.labelnames):
            raise ValueError(
                f"{self.kind} {self.name!r} takes labels "
                f"{list(self.labelnames)}, got {sorted(labels)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def labels_of(self, key: tuple) -> dict:
        return dict(zip(self.labelnames, key))

    @property
    def n_series(self) -> int:
        return len(self._series)

    def clear(self) -> None:
        self._series.clear()

    # -- export ---------------------------------------------------------------
    def _export_value(self, value):
        return value

    def to_dict(self) -> dict:
        return {
            "type": self.kind,
            "help": self.help,
            "labels": list(self.labelnames),
            "series": [{"labels": self.labels_of(k),
                        "value": self._export_value(v)}
                       for k, v in sorted(self._series.items())],
        }


class Counter(Instrument):
    kind = "counter"

    def inc(self, value: float = 1, **labels) -> None:
        if not (_state.on or self._always):
            return
        if value < 0:
            raise ValueError(
                f"counter {self.name!r} is monotonic, got inc({value})")
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels) -> float:
        return self._series.get(self._key(labels), 0)

    def total(self) -> float:
        return sum(self._series.values())


class Gauge(Instrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not (_state.on or self._always):
            return
        self._series[self._key(labels)] = value

    def value(self, **labels) -> float | None:
        return self._series.get(self._key(labels))


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = np.zeros(n_buckets + 1, np.int64)  # +1: overflow
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")


class Histogram(Instrument):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",  # noqa: A002
                 labels: tuple[str, ...] = (), always: bool = False,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels, always)
        buckets = tuple(float(b) for b in buckets)
        if not buckets or any(b >= a for b, a in zip(buckets, buckets[1:])):
            raise ValueError(
                f"histogram {name!r} needs strictly increasing bucket "
                f"upper bounds, got {buckets}")
        self.buckets = buckets

    def _series_for(self, labels: dict) -> _HistSeries:
        key = self._key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.buckets))
        return s

    def observe(self, value: float, **labels) -> None:
        if not (_state.on or self._always):
            return
        s = self._series_for(labels)
        s.counts[int(np.searchsorted(self.buckets, value, side="left"))] += 1
        s.sum += float(value)
        s.count += 1
        s.min = min(s.min, float(value))
        s.max = max(s.max, float(value))

    def observe_many(self, values, **labels) -> None:
        """Vectorized `observe` (the loadgen folds whole latency arrays)."""
        if not (_state.on or self._always):
            return
        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return
        s = self._series_for(labels)
        idx = np.searchsorted(self.buckets, v, side="left")
        s.counts += np.bincount(idx, minlength=len(self.buckets) + 1)
        s.sum += float(v.sum())
        s.count += int(v.size)
        s.min = min(s.min, float(v.min()))
        s.max = max(s.max, float(v.max()))

    def percentile(self, q: float, **labels) -> float:
        """Bucket-interpolated percentile estimate (q in [0, 100])."""
        s = self._series.get(self._key(labels))
        if s is None or s.count == 0:
            return float("nan")
        target = s.count * q / 100.0
        cum = np.cumsum(s.counts)
        b = int(np.searchsorted(cum, target, side="left"))
        if b >= len(self.buckets):          # landed in the overflow bucket
            return s.max
        lo = self.buckets[b - 1] if b > 0 else min(s.min, self.buckets[b])
        hi = self.buckets[b]
        prev = cum[b - 1] if b > 0 else 0
        frac = (target - prev) / max(s.counts[b], 1)
        return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))

    def snapshot(self, **labels) -> dict:
        """One series as a plain dict (the uniform exporter payload)."""
        s = self._series.get(self._key(labels))
        if s is None:
            s = _HistSeries(len(self.buckets))
        return self._export_value(s)

    def _export_value(self, s: _HistSeries) -> dict:
        return {
            "buckets": list(self.buckets),
            "counts": [int(c) for c in s.counts],
            "count": int(s.count),
            "sum": float(s.sum),
            "min": None if s.count == 0 else float(s.min),
            "max": None if s.count == 0 else float(s.max),
        }


class MetricsRegistry:
    """Name -> instrument, idempotent per (name, kind, labelnames)."""

    def __init__(self):
        self._instruments: dict[str, Instrument] = {}

    def _register(self, cls, name: str, help: str,  # noqa: A002
                  labels: tuple[str, ...], **kw) -> Instrument:
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name, help, tuple(labels),
                                                 **kw)
            return inst
        if not isinstance(inst, cls) or inst.labelnames != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {inst.kind} with "
                f"labels {list(inst.labelnames)}; cannot re-register as "
                f"{cls.kind} with labels {list(labels)}")
        if isinstance(inst, Histogram) and "buckets" in kw and \
                inst.buckets != tuple(float(b) for b in kw["buckets"]):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{inst.buckets}; conflicting buckets {kw['buckets']}")
        return inst

    def counter(self, name: str, help: str = "",  # noqa: A002
                labels: tuple[str, ...] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",  # noqa: A002
              labels: tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",  # noqa: A002
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str) -> Instrument | None:
        return self._instruments.get(name)

    def names(self) -> list[str]:
        return sorted(self._instruments)

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def total(self, name: str, default: float = 0.0) -> float:
        """Sum of a counter's series across all labels (dashboard helper)."""
        inst = self._instruments.get(name)
        if not isinstance(inst, Counter):
            return default
        return inst.total()

    def collect(self) -> dict:
        """The whole registry as a JSON-ready dict (series with any data)."""
        return {name: inst.to_dict()
                for name, inst in sorted(self._instruments.items())
                if inst.n_series}

    def reset(self) -> None:
        """Zero every series; registered instruments (and their identity —
        callers may hold references) survive."""
        for inst in self._instruments.values():
            inst.clear()
