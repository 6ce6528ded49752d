"""Knapsack constraints: the budget side of SCSK as an object.

The port's counterpart of `repro.core.constraint`. The paper's single
constraint g(X) <= B (eq. 12) models one machine's index budget; a serving
fleet has per-shard capacity. The doc space is cut into word-aligned
ranges and partition k carries its own cap B_k over its own cost
g_k(X) = |m(X) ∩ D_k|:

  * `GlobalBudget`      — the scalar knapsack (P = 1).
  * `PartitionedBudget` — per-partition doc costs g_k and caps B_k; a
                          clause is feasible iff every partition it touches
                          still fits: ∀k. g_k(X) + g_k(j|X) <= B_k. All
                          per-partition cost gains come from one
                          `ops.partition_gain` launch.

Both implement `KnapsackConstraint`: `used`/`value` give f32 [P] fills,
`gains` the (total [C], per-part [C, P]) marginal costs, `feasible` the
candidates that fit every partition. Caps and budgets are rounded to f32
once, as the reference's `jnp.float32`, and feasibility is the same f32
comparison.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import bitset


def partition_bounds(n_docs: int, n_parts: int) -> tuple[int, ...]:
    """Word-aligned doc-space partition: P+1 word offsets, 0 first, W last.

    Words are spread as evenly as possible and the partition count is
    clamped to the number of postings words (the reference's
    `cluster.plan_shards` split).
    """
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    words = bitset.n_words(n_docs)
    n = min(n_parts, words)
    base, rem = divmod(words, n)
    bounds = [0]
    for i in range(n):
        bounds.append(bounds[-1] + base + (1 if i < rem else 0))
    return tuple(bounds)


class KnapsackConstraint:
    """The protocol every constraint implements (consumed by the solvers)."""

    n_parts: int

    @property
    def total(self) -> float:
        """Total budget across partitions (host-side reporting)."""
        raise NotImplementedError

    def used(self, problem, state) -> torch.Tensor:
        """f32 [P] fill of a SolverState (on the problem's device)."""
        return self.value(problem, state.covered_d)

    def value(self, problem, covered_d) -> torch.Tensor:
        """f32 [P] fill of a covered-doc bitset."""
        raise NotImplementedError

    def np_value(self, covered_d: np.ndarray) -> np.ndarray:
        """f64 [P] fill of a host (uint32) covered-doc bitset."""
        raise NotImplementedError

    def gains(self, problem, covered_d, *, rows=None):
        """(g_total f32 [C], g_part f32 [C, P]) marginal costs."""
        raise NotImplementedError

    def gain_counts(self, problem, covered_d, *, rows=None, out=None):
        """g_part as the kernel's int32 counts [C, P], from one launch and
        nothing else on the device; into `out` (int32 [C, P]) when given."""
        raise NotImplementedError

    def feasible(self, used, g_part) -> torch.Tensor:
        """bool [C]: used[k] + g_part[:, k] <= B_k for every partition k."""
        raise NotImplementedError


class GlobalBudget(KnapsackConstraint):
    """The paper's scalar knapsack g(X) <= B (P = 1): feasibility is the
    f32 comparison `g_used + g_gain <= budget`."""

    n_parts = 1

    def __init__(self, budget: float):
        self.budget = float(np.float32(budget))

    def __repr__(self) -> str:
        return f"GlobalBudget(budget={self.budget})"

    @property
    def total(self) -> float:
        return self.budget

    def used(self, problem, state) -> torch.Tensor:
        return state.g_used.reshape(1)

    def value(self, problem, covered_d) -> torch.Tensor:
        return problem.g_value(covered_d).reshape(1)

    def np_value(self, covered_d: np.ndarray) -> np.ndarray:
        return np.asarray([bitset.np_popcount(covered_d)], np.float64)

    def gains(self, problem, covered_d, *, rows=None):
        gg = problem.g_gains(covered_d, rows=rows)
        return gg, gg[..., None]

    def gain_counts(self, problem, covered_d, *, rows=None, out=None):
        got = problem.g_counts(covered_d, rows=rows,
                               out=None if out is None else out[:, 0])
        return got[:, None] if out is None else out

    def feasible(self, used, g_part) -> torch.Tensor:
        return used[0] + g_part[..., 0] <= self.budget


class PartitionedBudget(KnapsackConstraint):
    """Per-partition caps B_k over word-aligned doc ranges.

    bounds : P+1 word offsets; partition k is the words [bounds[k],
             bounds[k+1])
    caps   : f32 [P] per-partition doc budgets (numpy; a copy is moved to a
             device once, on first use there)

    Feasibility masks a clause the moment any partition it touches is out
    of headroom; the objective side (f and the greedy ratio's total g) is
    untouched.
    """

    def __init__(self, caps, bounds: Sequence[int]):
        bounds = tuple(int(b) for b in bounds)
        if len(bounds) < 2 or bounds[0] != 0 or \
                any(a >= b for a, b in zip(bounds, bounds[1:])):
            raise ValueError(f"bounds must be ascending word offsets "
                             f"starting at 0, got {bounds}")
        caps = np.array(caps, dtype=np.float32)
        if caps.shape != (len(bounds) - 1,):
            raise ValueError(f"caps must have shape ({len(bounds) - 1},), "
                             f"got {caps.shape}")
        caps.setflags(write=False)
        self.caps = caps
        self.bounds = bounds
        self._on: dict[torch.device, torch.Tensor] = {}

    def __repr__(self) -> str:
        return f"PartitionedBudget(caps={self.caps.tolist()}, bounds={self.bounds})"

    @classmethod
    def from_split(cls, n_docs: int,
                   split: Mapping[int, float] | Sequence[float],
                   ) -> "PartitionedBudget":
        """From a {partition: cap} mapping or a cap sequence; partitions are
        `partition_bounds(n_docs, P)` word ranges."""
        if isinstance(split, Mapping):
            keys = sorted(split)
            if keys != list(range(len(keys))):
                raise ValueError(
                    f"budget split keys must be 0..P-1, got {keys}")
            caps = [float(split[k]) for k in keys]
        else:
            caps = [float(b) for b in split]
        bounds = partition_bounds(n_docs, len(caps))
        if len(bounds) - 1 != len(caps):
            raise ValueError(
                f"{len(caps)} partitions need >= {len(caps)} postings words; "
                f"n_docs={n_docs} only has {bounds[-1]}")
        return cls(caps=caps, bounds=bounds)

    @property
    def n_parts(self) -> int:
        return len(self.bounds) - 1

    @property
    def total(self) -> float:
        return float(np.sum(self.caps, dtype=np.float32))

    def scaled(self, new_total: float) -> "PartitionedBudget":
        """Same split shares at a different total budget (budget sweeps);
        the ratio is rounded to f32 and multiplied in f32, as the
        reference's weakly typed scalar."""
        ratio = np.float32(float(new_total) / max(self.total, 1e-30))
        return PartitionedBudget(caps=self.caps * ratio, bounds=self.bounds)

    def caps_on(self, device: torch.device) -> torch.Tensor:
        """The caps as an f32 tensor on `device`."""
        if device not in self._on:
            self._on[device] = torch.from_numpy(self.caps.copy()).to(device)
        return self._on[device]

    def value(self, problem, covered_d) -> torch.Tensor:
        return problem.g_value(covered_d, bounds=self.bounds)

    def np_value(self, covered_d: np.ndarray) -> np.ndarray:
        covered_d = np.asarray(covered_d)
        return np.asarray(
            [bitset.np_popcount(covered_d[lo:hi])
             for lo, hi in zip(self.bounds, self.bounds[1:])], np.float64)

    def gains(self, problem, covered_d, *, rows=None):
        g_part = problem.g_gains(covered_d, rows=rows, bounds=self.bounds)
        return g_part.sum(-1), g_part

    def gain_counts(self, problem, covered_d, *, rows=None, out=None):
        return problem.g_counts(covered_d, rows=rows, bounds=self.bounds, out=out)

    def feasible(self, used, g_part) -> torch.Tensor:
        return torch.all(used + g_part <= self.caps_on(used.device), dim=-1)


def partition_capacities(n_docs: int, bounds: Sequence[int]) -> list[int]:
    """Physical doc capacity of each partition of a word-aligned split."""
    word = bitset.WORD
    return [min(n_docs, hi * word) - lo * word
            for lo, hi in zip(bounds, bounds[1:])]


def trim_state(problem, state, constraint):
    """Make a warm-start state feasible for (possibly shrunk) per-shard caps.

    Re-allocating a traffic split can hand a shard a cap below the fill its
    warm-prefix clauses already occupy; the solvers only mask new
    candidates, so the overflow would survive the solve. This drops every
    selected clause touching an over-cap partition and rebuilds the state
    exactly. Returns (state, dropped_indices); the same state object when
    every partition already fits.
    """
    if state is None or constraint.n_parts == 1:
        return state, np.empty(0, np.int64)
    fills = constraint.np_value(bitset.to_numpy(state.covered_d))
    over = np.nonzero(fills > constraint.caps.astype(np.float64))[0]
    if not len(over):
        return state, np.empty(0, np.int64)
    idx = torch.nonzero(state.selected)[:, 0]
    rows = problem.clause_doc_bits[idx]
    touches = torch.zeros(len(idx), dtype=torch.bool, device=idx.device)
    for k in over.tolist():
        lo, hi = constraint.bounds[k], constraint.bounds[k + 1]
        touches |= (rows[:, lo:hi] != 0).any(-1)
    idx, touches = idx.cpu().numpy(), touches.cpu().numpy()
    return problem.state_for(idx[~touches]), idx[touches]


def as_constraint(budget) -> KnapsackConstraint:
    """Normalize a scalar budget (or pass a constraint through)."""
    if isinstance(budget, KnapsackConstraint):
        return budget
    return GlobalBudget(float(budget))


def resolve_constraint(problem, config) -> KnapsackConstraint:
    """The constraint a SolveConfig implies for a given problem.

    An explicit `config.constraint` wins; a `budget_split` mapping or
    sequence builds a `PartitionedBudget` over the problem's doc space;
    otherwise the scalar `config.budget` is a `GlobalBudget`.
    `budget_split="traffic"` needs traffic data and is resolved by
    `TieringPipeline` before the solve reaches here.
    """
    if config.constraint is not None:
        return as_constraint(config.constraint)
    split = config.budget_split
    if split is None:
        return GlobalBudget(config.budget)
    if isinstance(split, str):
        raise ValueError(
            f"budget_split={split!r} must be resolved from traffic data by "
            "TieringPipeline (api layer); pass a mapping or a constraint "
            "object at this level")
    return PartitionedBudget.from_split(problem.n_docs, split)
