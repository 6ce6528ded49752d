"""Span tracing: timed, nested sections of the request and control paths.

The port's counterpart of `repro.obs.spans`. A span times one named
section (`classify`, `t1_match`, `merge`, `refit`, `swap`, `append`, ...)
with wall-clock duration and — when the caller asks via `span.sync(x)` —
device-sync timing that waits for the CUDA device of every tensor in `x`,
so the measured interval covers actual device work, not just the launch.
Host values (numpy, CPU tensors, plain Python) pass through untouched.

Spans nest: the recorder keeps a stack per process, so a `serve` span
opened around a batch contains `classify`/`t1_match`/`merge` children with
parent ids and depths, making one served batch or one drift-triggered
refit a single readable trace. Finished spans land in a bounded `Ring` as
plain dicts (JSON-ready for the exporter).

When the plane is disabled `repro_torch.obs.span()` hands out the shared
`NULL_SPAN` whose methods are all no-ops — the hot path never builds a
Span object at all.
"""
from __future__ import annotations

import time
from typing import Iterator

from repro_torch.obs.ring import Ring

DEFAULT_SPAN_CAPACITY = 4096


def block_until_ready(value):
    """Wait for the work behind every CUDA tensor in `value` (nested lists,
    tuples and dict values included); returns `value`. Nothing is imported
    or waited for when `value` holds no CUDA tensor."""
    devices = set()

    def walk(v):
        if isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif getattr(v, "is_cuda", False):
            devices.add(v.device)
    walk(value)
    if devices:
        import torch
        for dev in devices:
            torch.cuda.synchronize(dev)
    return value


class _NullSpan:
    """Shared do-nothing span handed out while the plane is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def sync(self, value):
        return value


NULL_SPAN = _NullSpan()


class Span:
    """One timed section; append-on-exit into the recorder's ring."""

    __slots__ = ("recorder", "name", "id", "parent", "depth",
                 "t0_s", "_t0", "wall_ms", "sync_ms", "attrs")

    def __init__(self, recorder: "SpanRecorder", name: str, attrs: dict):
        self.recorder = recorder
        self.name = name
        self.id = -1
        self.parent = -1
        self.depth = 0
        self.t0_s = 0.0
        self._t0 = 0.0
        self.wall_ms = 0.0
        self.sync_ms = 0.0
        self.attrs = attrs

    def __enter__(self) -> "Span":
        self.recorder._open(self)
        self.t0_s = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.wall_ms = (time.perf_counter() - self._t0) * 1e3
        self.recorder._close(self)
        return False

    def set(self, **attrs) -> "Span":
        """Attach attributes (batch size, generation, words scanned...)."""
        self.attrs.update(attrs)
        return self

    def sync(self, value):
        """Block until `value` is device-ready, folding the wait into
        `sync_ms`; returns `value` so call sites stay expressions."""
        t0 = time.perf_counter()
        value = block_until_ready(value)
        self.sync_ms += (time.perf_counter() - t0) * 1e3
        return value

    def to_dict(self) -> dict:
        d = {
            "id": self.id,
            "parent": self.parent,
            "name": self.name,
            "depth": self.depth,
            "t0_s": self.t0_s,
            "wall_ms": round(self.wall_ms, 4),
            "sync_ms": round(self.sync_ms, 4),
        }
        if self.attrs:
            d.update(self.attrs)
        return d


class SpanRecorder:
    """Stack-nested span recorder over a bounded ring of finished spans.

    `seq` numbers every finished span monotonically (drops included), so
    the per-window exporter can cursor with `since(seq)` instead of
    re-reading the whole ring.
    """

    def __init__(self, capacity: int | None = DEFAULT_SPAN_CAPACITY):
        self.ring = Ring(capacity)
        self._stack: list[Span] = []
        self._next_id = 0

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def _open(self, span: Span) -> None:
        span.id = self._next_id
        self._next_id += 1
        if self._stack:
            span.parent = self._stack[-1].id
            span.depth = self._stack[-1].depth + 1
        self._stack.append(span)

    def _close(self, span: Span) -> None:
        # tolerate out-of-order exits (exceptions unwound a child first)
        if span in self._stack:
            while self._stack and self._stack[-1] is not span:
                self._stack.pop()
            self._stack.pop()
        self.ring.append(span.to_dict())

    @property
    def seq(self) -> int:
        """Count of spans ever finished (drops included)."""
        return self.ring.n_seen

    def since(self, seq: int) -> list[dict]:
        """Finished spans with ordinal >= `seq` still retained in the ring."""
        start = self.ring.n_seen - len(self.ring)  # ordinal of ring[0]
        if seq <= start:
            return self.ring.to_list()
        if seq >= self.ring.n_seen:
            return []
        return self.ring[seq - start:]

    def to_list(self) -> list[dict]:
        return self.ring.to_list()

    def of_name(self, name: str) -> list[dict]:
        return [s for s in self.ring if s["name"] == name]

    def children(self, span_id: int) -> list[dict]:
        return [s for s in self.ring if s["parent"] == span_id]

    def walk(self) -> Iterator[dict]:
        return iter(self.ring)

    def reset(self) -> None:
        self.ring = Ring(self.ring.capacity)
        self._stack.clear()
        self._next_id = 0
