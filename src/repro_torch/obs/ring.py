"""Bounded append-only buffer with list semantics over the retained tail.

A copy of `repro.obs.ring` (numpy + stdlib).

The telemetry plane's containment primitive: spans, events and the
cluster's `BatchTrace` history all go through a `Ring`, so a long
`run_stream`/`run_ingest` session holds a fixed amount of history instead
of growing without limit. `capacity=None` is the explicit full-history
mode the parity tests use (every batch retained, nothing dropped).
"""
from __future__ import annotations

import collections
from typing import Iterable, Iterator


class Ring:
    """A deque-backed ring that quacks like the list it replaced.

    Supports `append`/`extend`, `len`, truthiness, iteration, negative
    indexing and slicing (slices materialize the retained tail). Tracks
    `n_seen` (ever appended) so `n_dropped` makes silent truncation
    visible — exporters and dashboards report it instead of pretending
    the retained tail is the whole history.
    """

    __slots__ = ("_q", "n_seen")

    def __init__(self, capacity: int | None = None,
                 items: Iterable | None = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None for unbounded, "
                             f"got {capacity}")
        self._q: collections.deque = collections.deque(maxlen=capacity)
        self.n_seen = 0
        if items is not None:
            self.extend(items)

    @property
    def capacity(self) -> int | None:
        return self._q.maxlen

    @property
    def n_dropped(self) -> int:
        return self.n_seen - len(self._q)

    def append(self, item) -> None:
        self._q.append(item)
        self.n_seen += 1

    def extend(self, items: Iterable) -> None:
        for item in items:
            self.append(item)

    def clear(self) -> None:
        """Drop the retained tail (keeps `n_seen` so drops stay auditable)."""
        self._q.clear()

    def to_list(self) -> list:
        return list(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self) -> Iterator:
        return iter(self._q)

    def __getitem__(self, index):
        if isinstance(index, slice):
            return list(self._q)[index]
        return self._q[index]

    def __repr__(self) -> str:
        cap = "∞" if self.capacity is None else str(self.capacity)
        return (f"Ring({len(self._q)}/{cap} retained, "
                f"{self.n_dropped} dropped)")
