"""Structured event log for discrete control-plane occurrences.

A copy of `repro.obs.events` (numpy + stdlib).

Counters say *how much*, spans say *how long*; events say *what happened* —
drift detected, warm-vs-cold refit, replica drain/undrain, corpus swap,
admission accept/reject, rollout begin/done. Each event is one JSON-ready
dict with a monotonic `seq`, wall-clock `t_s`, a `kind`, and free-form
fields, retained in a bounded `Ring`.
"""
from __future__ import annotations

import time

from repro_torch.obs.ring import Ring

DEFAULT_EVENT_CAPACITY = 4096


class EventLog:
    def __init__(self, capacity: int | None = DEFAULT_EVENT_CAPACITY):
        self.ring = Ring(capacity)

    def emit(self, kind: str, **fields) -> dict:
        ev = {"seq": self.ring.n_seen, "t_s": time.time(), "kind": kind}
        ev.update(fields)
        self.ring.append(ev)
        return ev

    @property
    def seq(self) -> int:
        """Count of events ever emitted (drops included)."""
        return self.ring.n_seen

    def since(self, seq: int) -> list[dict]:
        start = self.ring.n_seen - len(self.ring)
        if seq <= start:
            return self.ring.to_list()
        if seq >= self.ring.n_seen:
            return []
        return self.ring[seq - start:]

    def of_kind(self, kind: str) -> list[dict]:
        return [e for e in self.ring if e["kind"] == kind]

    def to_list(self) -> list[dict]:
        return self.ring.to_list()

    def __len__(self) -> int:
        return len(self.ring)

    def reset(self) -> None:
        self.ring = Ring(self.ring.capacity)
