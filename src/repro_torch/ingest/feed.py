"""Seeded live-document feeds for the ingest loop.

A `DocumentFeed` produces per-window batches of new documents whose token
content is CORRELATED with the window's query traffic: with probability
`correlation`, a new document is seeded from a traffic-sampled query's token
set (it will therefore match the clauses that query satisfies — the arrivals
the admission policy should care about), plus zipf-sampled filler tokens;
otherwise it is pure background (zipf tokens only). Drifting traffic thus
drags the DOCUMENT distribution along with it, which is what makes streaming
Tier-1 admission a live decision rather than a warm-refit afterthought.

Determinism contract: `window(t, probs)` derives its rng from
`(seed, t)` alone — NOT from call order — so two controller arms (admission
on/off, rolling/stop-the-world) replaying the same scenario observe
bit-identical document arrivals, and A/B deltas are attributable to the
policy, not the feed.

The port's counterpart of `repro.ingest.feed` (numpy only), with the same
documents for the same `(seed, t)` from the same `default_rng` stream. Each
weighted draw is numpy's own `Generator.choice(n, size, p=p)` step — the
normalized cumulative sum, then `random(size)` searched on its right side —
with each distribution's cumulative sum taken once (the zipf's at
construction, the window's per window) instead of once per draw: a window
at 2^20 queries draws in milliseconds where a choice per draw spends ~8 ms
on the sum.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _cdf(p: np.ndarray) -> np.ndarray:
    """What `Generator.choice` searches: the cumulative sum over its last."""
    cdf = np.asarray(p, np.float64).cumsum()
    cdf /= cdf[-1]
    return cdf


def _draw(rng: np.random.Generator, cdf: np.ndarray, size=None):
    """`rng.choice(len(cdf), size, p=p)` for the `p` whose `_cdf` is `cdf`:
    the same rng draws and the same indices."""
    return cdf.searchsorted(rng.random(size), side="right")


@dataclasses.dataclass
class DocumentFeed:
    """Poisson document arrivals correlated with window traffic.

    rate             : mean arrivals per window (Poisson)
    correlation      : P[a new doc is seeded from a traffic-sampled query]
    extra_tokens_mean: mean zipf filler tokens added per document
    """
    log: object                   # QueryLog: queries + probs universe
    vocab_size: int
    rate: float = 32.0
    correlation: float = 0.6
    extra_tokens_mean: float = 3.0
    zipf_a: float = 1.1
    seed: int = 0

    def __post_init__(self):
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** self.zipf_a
        self._zipf = p / p.sum()
        self._zipf_cdf = _cdf(self._zipf)
        self.n_emitted = 0

    def window(self, t: int, probs: np.ndarray | None = None
               ) -> list[tuple[int, ...]]:
        """The documents arriving during window `t`.

        `probs` is the window's query-traffic distribution (e.g.
        `TrafficWindow.probs`); None falls back to the log's base weights.
        Deterministic in `(seed, t)` regardless of call order or arm.
        """
        rng = np.random.default_rng((self.seed, 9173, t))
        n = int(rng.poisson(self.rate))
        if probs is None:
            probs = np.asarray(self.log.train_weights, np.float64)
        probs = np.asarray(probs, np.float64)
        probs = probs / max(probs.sum(), 1e-30)
        query_cdf = None
        docs = []
        for _ in range(n):
            toks: set[int] = set()
            if rng.random() < self.correlation:
                if query_cdf is None:
                    query_cdf = _cdf(probs)
                qi = int(_draw(rng, query_cdf))
                toks |= set(self.log.queries[qi])
            k = int(rng.poisson(self.extra_tokens_mean))
            if k:
                toks |= set(int(v) for v in _draw(rng, self._zipf_cdf, k))
            if not toks:
                toks = {int(_draw(rng, self._zipf_cdf))}
            docs.append(tuple(sorted(toks)))
        self.n_emitted += len(docs)
        return docs
