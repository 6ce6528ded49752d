"""Serving front-end: classify-keyed result cache + overload policies.

A copy of `repro.cluster.frontend` (numpy, zlib and OrderedDict): the
same keys land in the same cache shards.

The paper prices every query by the postings words it scans (§2.2), yet real
traffic is heavy-tailed and repetitive — the same conjunctive query pattern
arrives again and again. A conjunctive match set m(q) depends ONLY on the
query's token SET, so the packed query vocab bitset the ψ^clause kernel
already consumes (`matching.pack_query_bits`) is an EXACT result key: two
queries with equal keys have bit-identical match sets at a fixed corpus
version. `ResultCache` exploits that:

  * key   = the packed classification bitset row, as bytes;
  * epoch = (generation, corpus_version, tier-1-served) — entries are scoped
    to the exact (ψ, corpus) state they were computed under, so every
    rolling tiering swap and every rolling corpus swap invalidates by
    construction and a hit stays bit-identical to `serve_reference`;
  * LRU + optional TTL, sharded by key hash so one hot bucket can't evict
    the whole working set.

The module also carries the front-end's overload policy surface
(`AdmissionPolicy`: bounded per-shard queues + deadline-aware shedding) and
the Zipf traffic helpers the frontend benchmarks replay
(`zipf_keys` / `keys_of`). Hedged dispatch and the admission queue model
live in `cluster.loadgen`, which consumes `AdmissionPolicy` directly.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from collections import OrderedDict

import numpy as np

from repro_torch import obs

_LOOKUPS = obs.counter("frontend_cache_lookups_total",
                       "result-cache lookups at the serving front-end")
_HITS = obs.counter("frontend_cache_hits_total",
                    "result-cache hits (zero postings words scanned)")
_MISSES = obs.counter("frontend_cache_misses_total",
                      "result-cache misses (fresh tier match)")
_EVICT = obs.counter("frontend_cache_evictions_total",
                     "result-cache entries dropped",
                     labels=("reason",))     # lru | ttl | epoch


def prime_counters() -> None:
    """Create the front-end counter series at zero so a run that never
    caches still exports them (`launch.obs --check --require-metric`)."""
    _LOOKUPS.inc(0)
    _HITS.inc(0)
    _MISSES.inc(0)


@dataclasses.dataclass
class CacheStats:
    lookups: int = 0
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0       # LRU capacity pressure
    expirations: int = 0     # TTL lapse
    invalidations: int = 0   # epoch moved (tiering/corpus swap)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


class ResultCache:
    """Sharded LRU + TTL cache of exact match-set rows, epoch-scoped.

    Stored value per key: (epoch, inserted_at, elig, packed row). `lookup`
    returns `(elig, row)` only when the entry's epoch equals the epoch the
    batch is being served at — a stale entry is evicted on sight, so a hit
    can never cross a tiering generation or corpus version. Exactness is
    therefore structural: the cache stores what the fleet computed at the
    SAME (ψ, Tier-1, Tier-2, corpus) tuple the batch would use afresh.
    """

    def __init__(self, capacity: int = 8192, ttl_s: float | None = None,
                 n_shards: int = 8, clock=time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.capacity = capacity
        self.ttl_s = ttl_s
        self.n_shards = min(n_shards, capacity)
        self._per_shard = max(1, capacity // self.n_shards)
        self._shards: list[OrderedDict] = [
            OrderedDict() for _ in range(self.n_shards)]
        self._clock = clock
        self.stats = CacheStats()
        prime_counters()

    def _shard(self, key: bytes) -> OrderedDict:
        return self._shards[zlib.crc32(key) % self.n_shards]

    def __len__(self) -> int:
        return sum(len(d) for d in self._shards)

    def lookup(self, epoch: tuple, key: bytes):
        """Return `(elig, row)` for a live entry at `epoch`, else None."""
        self.stats.lookups += 1
        _LOOKUPS.inc()
        d = self._shard(key)
        ent = d.get(key)
        if ent is None:
            self.stats.misses += 1
            _MISSES.inc()
            return None
        e_epoch, born, elig, row = ent
        if e_epoch != epoch:
            del d[key]
            self.stats.invalidations += 1
            _EVICT.inc(reason="epoch")
            self.stats.misses += 1
            _MISSES.inc()
            return None
        if self.ttl_s is not None and self._clock() - born > self.ttl_s:
            del d[key]
            self.stats.expirations += 1
            _EVICT.inc(reason="ttl")
            self.stats.misses += 1
            _MISSES.inc()
            return None
        d.move_to_end(key)
        self.stats.hits += 1
        _HITS.inc()
        return elig, row

    def insert(self, epoch: tuple, key: bytes, elig: bool,
               row: np.ndarray) -> None:
        d = self._shard(key)
        d[key] = (epoch, self._clock(), bool(elig),
                  np.array(row, copy=True))
        d.move_to_end(key)
        self.stats.insertions += 1
        while len(d) > self._per_shard:
            d.popitem(last=False)
            self.stats.evictions += 1
            _EVICT.inc(reason="lru")

    def invalidate_below(self, generation: int, corpus_version: int) -> int:
        """Eagerly drop entries older than the fleet's new target epoch —
        called when a rollout completes, so superseded results free memory
        immediately instead of lingering until LRU pressure finds them."""
        dropped = 0
        for d in self._shards:
            stale = [k for k, (e, *_rest) in d.items()
                     if e[0] < generation or e[1] < corpus_version]
            for k in stale:
                del d[k]
            dropped += len(stale)
        if dropped:
            self.stats.invalidations += dropped
            _EVICT.inc(dropped, reason="epoch")
        return dropped

    def clear(self) -> None:
        for d in self._shards:
            d.clear()

    def snapshot(self) -> dict:
        return {"size": len(self), "capacity": self.capacity,
                "ttl_s": self.ttl_s, "n_shards": self.n_shards,
                **self.stats.to_dict()}


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Overload admission for the front-end queue model (cluster.loadgen).

    `queue_bound_ms`: an arriving query whose chosen replicas' worst queue
    backlog exceeds this is not admitted to that tier — eligible queries
    demote to the Tier-2 scatter; Tier-2-bound queries shed to a degraded
    immediate answer priced at `t_fixed` only (no postings scanned).
    `deadline_ms`: same treatment when the predicted completion (queue wait
    + base service, stragglers unknowable at dispatch) would land past the
    deadline.
    """
    queue_bound_ms: float | None = None
    deadline_ms: float | None = None

    @classmethod
    def parse(cls, spec: str) -> "AdmissionPolicy":
        """Parse a `QUEUE_MS[,DEADLINE_MS]` CLI spec ('-' skips a bound)."""
        parts = [p.strip() for p in spec.split(",")]
        if not 1 <= len(parts) <= 2:
            raise ValueError(
                f"admission spec must be QUEUE_MS[,DEADLINE_MS], got {spec!r}")
        vals = [None if p in ("", "-") else float(p) for p in parts]
        vals += [None] * (2 - len(vals))
        return cls(queue_bound_ms=vals[0], deadline_ms=vals[1])

    @property
    def active(self) -> bool:
        return self.queue_bound_ms is not None or self.deadline_ms is not None


def zipf_keys(n: int, n_keys: int, skew: float, seed: int = 0) -> np.ndarray:
    """A seeded rank-skewed key stream: P(rank k) ∝ 1/k^skew over `n_keys`
    distinct keys. `skew=0` is uniform; ~1.0+ is web-like repeat traffic.
    Drives both the loadgen cache model and the real-fleet replay bench."""
    if n_keys < 1:
        raise ValueError(f"n_keys must be >= 1, got {n_keys}")
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    p = ranks ** -float(skew)
    p /= p.sum()
    rng = np.random.default_rng(seed)
    return rng.choice(n_keys, size=n, p=p).astype(np.int64)


def keys_of(queries: list[tuple[int, ...]]) -> np.ndarray:
    """Map each query to a stable small-int key by token SET (first-seen
    order) — the loadgen-side stand-in for the packed-bitset cache key,
    which is likewise insensitive to token order and duplicates."""
    ids: dict[frozenset, int] = {}
    out = np.empty(len(queries), np.int64)
    for i, q in enumerate(queries):
        out[i] = ids.setdefault(frozenset(q), len(ids))
    return out
