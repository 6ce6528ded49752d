"""Nonstationary traffic simulator: named drift scenarios over a QueryLog.

A copy of `repro.stream.drift` (numpy only): the same seed gives the
same windows, bit for bit.

The paper frames tiering as *stochastic* optimization because live traffic
drifts away from any static log (§2.3, Fig. 5). This module turns the
synthetic QueryLog (data/synthetic.py) into a windowed, drifting request
stream: a scenario maps the base distribution p0 over the unique-query
universe to a per-window distribution p_t, and the simulator samples a
seeded query batch from each p_t.

Scenarios (all seeded, fully deterministic given (seed, n_windows)):

  static    p_t = p0 — the control/baseline stream.
  rotate    topic/head rotation: queries are partitioned into K topics and
            window t multiplicatively boosts topic (t mod K).
  burst     spike traffic: on burst windows a tiny random query set seizes
            a large fraction of the mass.
  churn     vocabulary churn: mass moves monotonically from queries seen in
            the training log onto NOVEL queries (train weight zero) — the
            regime where clause tiering must generalize.
  seasonal  gradual interpolation p_t = (1-a_t) p0 + a_t p1 toward a
            head-permuted target, a_t = strength * sin^2(pi t / (T-1)) —
            drifts out and back within one run.

A scenario factory has signature `factory(log, p0, rng, n_windows, strength)
-> (t -> p_t)`; register new ones in `SCENARIOS`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

from repro_torch.data.synthetic import QueryLog


@dataclasses.dataclass(frozen=True)
class TrafficWindow:
    """One window of the stream: sampled batch + the true distribution."""
    index: int
    query_ids: np.ndarray    # int64 [n] ids into log.queries
    probs: np.ndarray        # f64 [Nq] the window's true distribution


def _normalize(p: np.ndarray) -> np.ndarray:
    s = p.sum()
    if s <= 0:
        return np.full_like(p, 1.0 / max(1, len(p)))
    return p / s


def _static(log: QueryLog, p0: np.ndarray, rng: np.random.Generator,
            n_windows: int, strength: float) -> Callable[[int], np.ndarray]:
    return lambda t: p0


def _rotate(log: QueryLog, p0: np.ndarray, rng: np.random.Generator,
            n_windows: int, strength: float) -> Callable[[int], np.ndarray]:
    """K random topics; the hot topic dwells for 3 windows, then rotates.

    Window t boosts topic ((t // 3) mod K) by 1 + 15*strength. The dwell is
    what makes reacting worthwhile: a controller that refits on the first
    window of a topic epoch serves the rest of the epoch well, while a
    per-window flip would always keep it one window behind.
    """
    k, dwell = 4, 3
    topic = rng.integers(0, k, size=len(p0))
    boost = 1.0 + 15.0 * strength

    def probs(t: int) -> np.ndarray:
        p = p0 * np.where(topic == ((t // dwell) % k), boost, 1.0)
        return _normalize(p)
    return probs


def _burst(log: QueryLog, p0: np.ndarray, rng: np.random.Generator,
           n_windows: int, strength: float) -> Callable[[int], np.ndarray]:
    """Recurring 2-window spikes: a ~1% query set takes 0.6*strength of the
    mass on windows t%4 ∈ {1,2} (a fresh set per burst), then vanishes.
    The 2-window persistence is what a reactive controller can exploit."""
    n = len(p0)
    frac = min(0.9, 0.6 * strength)
    sets = [rng.choice(n, size=max(1, n // 100), replace=False)
            for _ in range(n_windows // 4 + 1)]

    def probs(t: int) -> np.ndarray:
        if t % 4 not in (1, 2):
            return p0
        p = p0 * (1.0 - frac)
        spike = np.zeros(n)
        spike[sets[t // 4]] = frac / len(sets[t // 4])
        return _normalize(p + spike)
    return probs


def _churn(log: QueryLog, p0: np.ndarray, rng: np.random.Generator,
           n_windows: int, strength: float) -> Callable[[int], np.ndarray]:
    """Mass migrates from train-seen queries onto novel (train-unseen) ones."""
    novel = np.asarray(log.train_weights) == 0
    if not novel.any() or novel.all():           # degenerate log: no churn
        return lambda t: p0
    p_seen = _normalize(np.where(novel, 0.0, p0))
    p_novel = _normalize(np.where(novel, np.maximum(p0, 1e-12), 0.0))

    def probs(t: int) -> np.ndarray:
        a = min(0.9, 0.8 * strength) * (t / max(1, n_windows - 1))
        return _normalize((1.0 - a) * p_seen + a * p_novel)
    return probs


def _seasonal(log: QueryLog, p0: np.ndarray, rng: np.random.Generator,
              n_windows: int, strength: float) -> Callable[[int], np.ndarray]:
    """Smoothly interpolate toward a head-permuted target and back."""
    head = np.argsort(-p0)[:max(2, len(p0) // 2)]
    p1 = p0.copy()
    p1[head] = p0[head][rng.permutation(len(head))]
    p1 = _normalize(p1)

    def probs(t: int) -> np.ndarray:
        a = min(1.0, strength) * np.sin(np.pi * t / max(1, n_windows - 1)) ** 2
        return _normalize((1.0 - a) * p0 + a * p1)
    return probs


SCENARIOS: dict[str, Callable] = {
    "static": _static,
    "rotate": _rotate,
    "burst": _burst,
    "churn": _churn,
    "seasonal": _seasonal,
}


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)


class TrafficSimulator:
    """Seeded windowed request stream over a QueryLog's unique queries.

    Two simulators built with identical arguments yield bit-identical
    windows, so a static-tiering baseline and a re-tiering run can be
    compared on exactly the same traffic.
    """

    def __init__(self, log: QueryLog, scenario: str = "rotate", *,
                 seed: int = 0, n_windows: int = 8,
                 queries_per_window: int = 512, strength: float = 1.0,
                 base: str = "test"):
        if scenario not in SCENARIOS:
            raise KeyError(
                f"unknown scenario {scenario!r}; known: {list_scenarios()}")
        if base not in ("test", "train"):
            raise ValueError("base must be 'test' or 'train'")
        self.log = log
        self.scenario = scenario
        self.n_windows = n_windows
        self.queries_per_window = queries_per_window
        p0 = _normalize(np.asarray(
            log.test_weights if base == "test" else log.train_weights,
            np.float64))
        # structure rng (topic/burst/target choices) is independent of the
        # sampling rng so window distributions don't depend on batch size
        self._probs = SCENARIOS[scenario](
            log, p0, np.random.default_rng(seed), n_windows, strength)
        self._seed = seed

    def window_probs(self, t: int) -> np.ndarray:
        """The true query distribution of window t."""
        return self._probs(t)

    def windows(self) -> Iterator[TrafficWindow]:
        rng = np.random.default_rng(self._seed + 1)
        for t in range(self.n_windows):
            p = self.window_probs(t)
            ids = rng.choice(len(p), size=self.queries_per_window, p=p)
            yield TrafficWindow(index=t, query_ids=ids, probs=p)
