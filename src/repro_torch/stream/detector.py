"""Drift detection: decide WHEN the control loop should re-tier.

A copy of `repro.stream.detector` (numpy only).

Two complementary signals, both cheap enough to run every window:

  * serve-quality regression — the windowed Tier-1 eligible fraction
    (`ServeStats.tier1_fraction`) dropping below the coverage the current
    tiering predicted at refit time means the deployed clause set no longer
    matches live traffic;
  * distribution shift — total-variation distance between the accumulator's
    decayed weights and the weights the current tiering was solved against.
    TV bounds the coverage change of ANY fixed clause set (coverage is an
    expectation of a 0/1 function), so a large TV is a leading indicator
    even before quality visibly degrades.

`rebase(weights, coverage)` re-anchors both references after a refit;
`update(stats, weights)` returns a `DriftSignal` each window.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.engine import ServeStats


@dataclasses.dataclass(frozen=True)
class DriftSignal:
    triggered: bool
    reasons: tuple[str, ...]
    tv_distance: float       # TV(current weights, weights at last refit)
    coverage_gap: float      # predicted coverage at refit - windowed coverage
    tv_noise_floor: float = 0.0  # expected TV from sampling noise alone


def tv_distance(p: np.ndarray, q: np.ndarray) -> float:
    """Total-variation distance between two distributions."""
    return float(0.5 * np.abs(np.asarray(p, np.float64)
                              - np.asarray(q, np.float64)).sum())


class DriftDetector:
    """Thresholded windowed drift triggers with refit hysteresis.

    coverage_drop        absolute tolerated drop of windowed tier1_fraction
                         below the coverage predicted at the last refit
    tv_threshold         TV distance that triggers regardless of coverage
                         (on top of the sampling-noise floor, see below)
    noise_scale          multiplier on the estimated TV sampling-noise floor
                         added to tv_threshold; 0 disables the correction
    min_windows_between  hysteresis: windows to wait after a refit
    warmup_windows       windows to observe before the first trigger

    An EMPIRICAL distribution over thousands of queries has a nonzero
    expected TV to its own source purely from sampling: per query,
    E|p̂_q - p_q| ≈ sqrt(2 p_q / (π n)), so the floor is
    0.5 · sqrt(2/(π n)) · Σ_q sqrt(p_q) for n effective samples. Without
    that correction the trigger fires forever on noise under a perfectly
    static workload (callers pass `n_samples`, e.g. the accumulator's
    decayed total).
    """

    def __init__(self, *, coverage_drop: float = 0.05,
                 tv_threshold: float = 0.2, noise_scale: float = 1.0,
                 min_windows_between: int = 1, warmup_windows: int = 1):
        self.coverage_drop = coverage_drop
        self.tv_threshold = tv_threshold
        self.noise_scale = noise_scale
        self.min_windows_between = min_windows_between
        self.warmup_windows = warmup_windows
        self._ref_weights: np.ndarray | None = None
        self._ref_coverage: float | None = None
        self._windows_seen = 0
        self._windows_since_refit = 10 ** 9

    def rebase(self, weights: np.ndarray, coverage: float) -> None:
        """Anchor the references to a freshly deployed tiering."""
        self._ref_weights = np.array(weights, np.float64, copy=True)
        self._ref_coverage = float(coverage)
        self._windows_since_refit = 0

    def update(self, stats: ServeStats, weights: np.ndarray,
               n_samples: float | None = None) -> DriftSignal:
        """Consume one window's serve stats + accumulator weights.

        `n_samples` is the effective sample count behind `weights` (e.g.
        `LogAccumulator.total()`); when given, the TV trigger only counts
        drift above the sampling-noise floor it implies.
        """
        tv = 0.0 if self._ref_weights is None \
            else tv_distance(weights, self._ref_weights)
        gap = 0.0 if self._ref_coverage is None \
            else self._ref_coverage - stats.tier1_fraction
        floor = 0.0
        if n_samples and self._ref_weights is not None and self.noise_scale:
            floor = self.noise_scale * 0.5 * \
                float(np.sqrt(2.0 / (np.pi * n_samples))
                      * np.sqrt(self._ref_weights).sum())
        self._windows_seen += 1
        self._windows_since_refit += 1

        reasons = []
        if tv > self.tv_threshold + floor:
            reasons.append(f"tv={tv:.3f}>{self.tv_threshold}+{floor:.3f}")
        if gap > self.coverage_drop:
            reasons.append(f"coverage_gap={gap:.3f}>{self.coverage_drop}")
        eligible = (self._windows_seen >= self.warmup_windows
                    and self._windows_since_refit >= self.min_windows_between)
        return DriftSignal(triggered=bool(reasons) and eligible,
                           reasons=tuple(reasons), tv_distance=tv,
                           coverage_gap=gap, tv_noise_floor=floor)
