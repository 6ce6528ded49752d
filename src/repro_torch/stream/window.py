"""Sliding-window log accumulation + warm-start state hygiene.

The port's counterpart of `repro.stream.window`. `LogAccumulator` keeps
exponentially-decayed empirical query weights over the unique-query
universe — the online analogue of the offline QueryLog's `train_weights` —
on the host (a copy of the reference's). Its `weights()` feed
`SCSKProblem.with_weights` and `TieringPipeline.refit`.

`prune_state` is the other half of a cheap re-solve: before warm-starting
from the previous `SolverState`, drop selected clauses whose *unique*
weighted query coverage under the CURRENT distribution has decayed below a
floor. The exactly-once query mask is built on the problem's device from
the K selected rows of `clause_query_bits` (int32 words: `&`, `|`, `~`),
and each clause's unique mass is one `SCSKProblem.f_gains` call over those
rows (`bit_matvec`) with the mask folded into the weights.

`prune_partitions` scopes a warm re-solve to the doc-space partitions that
drifted: selected clauses whose document mass is concentrated in the
drifted shards are unfrozen; the rest stay a frozen warm prefix.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core.problem import SCSKProblem
from repro_torch.core.state import SolverState


class LogAccumulator:
    """Exponentially-decayed query counts over the unique-query universe.

    `halflife` is measured in windows: after observing h windows of purely
    new traffic, the old traffic contributes half the mass it did. A prior
    (e.g. the offline log's train_weights, scaled by `prior_strength`
    pseudo-observations) keeps early windows from being all sampling noise.
    """

    def __init__(self, n_queries: int, *, halflife: float = 2.0,
                 prior: np.ndarray | None = None,
                 prior_strength: float = 0.0):
        if halflife <= 0:
            raise ValueError("halflife must be positive (windows)")
        self.n_queries = n_queries
        self.decay = 0.5 ** (1.0 / halflife)
        self.counts = np.zeros(n_queries, np.float64)
        if prior is not None and prior_strength > 0:
            p = np.asarray(prior, np.float64)
            if p.shape != (n_queries,):
                raise ValueError(
                    f"prior must have shape ({n_queries},), got {p.shape}")
            self.counts += prior_strength * p / max(p.sum(), 1e-30)
        self.n_windows = 0

    def observe(self, query_ids: np.ndarray) -> None:
        """Fold one window's sampled query ids into the decayed counts."""
        self.counts *= self.decay
        np.add.at(self.counts, np.asarray(query_ids, np.int64), 1.0)
        self.n_windows += 1

    def weights(self) -> np.ndarray:
        """Normalized decayed empirical distribution, f64 [n_queries]."""
        s = self.counts.sum()
        if s <= 0:
            return np.full(self.n_queries, 1.0 / max(1, self.n_queries))
        return self.counts / s

    def total(self) -> float:
        return float(self.counts.sum())


def _selected(state: SolverState) -> np.ndarray:
    """Indices of the state's selected clauses, int64 on the host."""
    return torch.nonzero(state.selected)[:, 0].cpu().numpy().astype(np.int64)


def check_state_width(problem: SCSKProblem, state: SolverState) -> None:
    """Reject a `SolverState` whose doc bitset width doesn't match `problem`.

    Raised instead of silently zero-padding because the pad would be wrong:
    after a corpus append, already-selected clauses may match the appended
    documents, so the only exact post-append state is a re-derivation
    (`problem.state_for`) over the grown incidence.
    """
    wd = int(state.covered_d.shape[0])
    if wd != problem.wd:
        raise ValueError(
            f"stale SolverState: covered_d has {wd} words but the problem "
            f"has wd={problem.wd} (corpus appended since the state was "
            "captured?); re-derive it with "
            "problem.state_for(np.nonzero(state.selected)[0])")
    if int(state.selected.shape[0]) != problem.n_clauses:
        raise ValueError(
            f"stale SolverState: {state.selected.shape[0]} "
            f"selection slots vs {problem.n_clauses} clauses")


def prune_state(problem: SCSKProblem, state: SolverState, *,
                min_unique_mass: float = 0.0,
                weights: np.ndarray | None = None,
                ) -> tuple[SolverState, np.ndarray, np.ndarray]:
    """Drop stale clauses from a SolverState; returns (state, kept, dropped).

    A selected clause is stale when the traffic mass it UNIQUELY covers
    (queries no other selected clause matches) under `weights` (default:
    `problem.query_weights`) is below `min_unique_mass`. Passing `weights`
    directly (length `n_queries`) avoids materializing a reweighted problem
    just for the pruning pass. The pruned state is rebuilt exactly (covered
    bitsets re-OR'd, `g_used` recomputed), so a solver can resume from it
    as if the kept clauses were its own selection prefix.

    On the problem's device: the exactly-once query mask is two OR/AND
    accumulator sweeps over the K selected rows, and the per-clause unique
    mass is one `f_gains` (bit-matvec) call over those rows with covered_q
    = ~once. The unique masses come back as f32 and are compared with
    `min_unique_mass` in f32, as the reference compares them.

    A state whose width does not match the problem's raises `ValueError`
    (`check_state_width`).
    """
    check_state_width(problem, state)
    idx = _selected(state)
    empty = np.empty(0, np.int64)
    if len(idx) == 0 or min_unique_mass <= 0:
        return state, idx, empty

    nq, dev = problem.n_queries, problem.device
    qrows = problem.clause_query_bits[torch.from_numpy(idx).to(dev)]  # [K, Wq]
    if weights is None:
        wpad = problem.query_weights
    else:
        weights = np.asarray(weights, np.float32)
        if weights.shape != (nq,):
            raise ValueError(
                f"weights must have shape ({nq},), got {weights.shape}")
        w = np.zeros(problem.wq * 32, np.float32)
        w[:nq] = weights
        wpad = torch.from_numpy(w).to(dev)
    seen_once = torch.zeros(problem.wq, dtype=torch.int32, device=dev)
    seen_multi = torch.zeros_like(seen_once)
    for r in qrows:
        seen_multi |= seen_once & r
        seen_once |= r
    once = seen_once & ~seen_multi            # queries covered exactly once
    # f_gains with covered_q = ~once zeroes every weight outside the mask,
    # so row j of the bit-matvec is exactly clause j's unique weighted mass
    unique_mass = problem.f_gains(~once, rows=qrows,
                                  weights=wpad).cpu().numpy()
    drop = unique_mass < min_unique_mass
    if not drop.any():
        return state, idx, empty

    kept = idx[~drop]
    return rebuild_state(problem, kept), kept, idx[drop]


def rebuild_state(problem: SCSKProblem, kept: np.ndarray) -> SolverState:
    """Exact `SolverState` for a clause subset, as if it were a solve prefix
    (covered bitsets re-OR'd, `g_used` recomputed)."""
    return problem.state_for(kept)


def prune_partitions(problem: SCSKProblem, state: SolverState,
                     bounds: tuple[int, ...], parts,
                     *, scope_frac: float = 0.5,
                     ) -> tuple[SolverState, np.ndarray, np.ndarray]:
    """Unfreeze the clauses living in drifted doc partitions.

    Drops every selected clause whose document mass inside the partitions
    `parts` (indices into the word-aligned `bounds` split) is at least
    `scope_frac` of its total mass; returns (state, kept, dropped) like
    `prune_state`. The kept clauses stay a frozen warm prefix, so a re-solve
    from the returned state only spends budget re-tiering the drifted
    shards. The per-partition doc counts are popcounts on the problem's
    device. Like `prune_state`, a stale-width state raises `ValueError`.
    """
    check_state_width(problem, state)
    idx = _selected(state)
    parts = sorted(set(int(p) for p in parts))
    empty = np.empty(0, np.int64)
    if len(idx) == 0 or not parts:
        return state, idx, empty
    rows = problem.clause_doc_bits[torch.from_numpy(idx).to(problem.device)]
    per_word = bitset.word_popcount(rows)                          # [K, Wd]
    total = per_word.sum(1).cpu().numpy().astype(np.float64)
    in_scope = np.zeros(len(idx), np.float64)
    for k in parts:
        lo, hi = bounds[k], bounds[k + 1]
        in_scope += per_word[:, lo:hi].sum(1).cpu().numpy()
    drop = in_scope >= scope_frac * np.maximum(total, 1.0)
    if not drop.any():
        return state, idx, empty
    kept = idx[~drop]
    return rebuild_state(problem, kept), kept, idx[drop]
