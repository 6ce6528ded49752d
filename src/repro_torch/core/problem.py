"""SCSKProblem: device-resident operands + batched marginal-gain oracles.

The port's counterpart of `repro.core.problem`. The paper's objective /
constraint pair (eq. 12):
    f(X) = P_{q~Qn}[∃c∈X: c ⊆ q]      (monotone submodular, Thm 3.3)
    g(X) = |∪_{c∈X} m(c)|             (set cover, monotone submodular, Thm 3.4)

State is two packed bitsets (covered queries, covered docs). Marginal gains
are one kernel call each:
    f(j|X) for all j = A_q  @ (w ⊙ uncovered_q)   (ops.bit_matvec)
    g(j|X) for all j = popcount(A_d & ~covered_d)  (ops.coverage_gain)
and, under per-shard budgets, g_k(j|X) for every partition k at once
(ops.partition_gain).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core.state import SolverState
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class SCSKProblem:
    clause_query_bits: torch.Tensor  # int32 words [C, Wq]
    clause_doc_bits: torch.Tensor    # int32 words [C, Wd]
    query_weights: torch.Tensor      # f32 [Wq*32] (zero-padded empirical probs)
    test_weights: torch.Tensor       # f32 [Wq*32] (test-split probs, eval only)
    n_queries: int
    n_docs: int

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_data(cls, data, device=None) -> "SCSKProblem":
        """From data.incidence.TieringData, on `device` (default CUDA).

        The f64 empirical weights become zero-padded f32, as the reference
        casts them."""
        dev = resolve_device(device)
        wq = data.clause_query_bits.shape[1]
        wtr = np.zeros(wq * 32, np.float32)
        wtr[:data.n_queries] = data.log.train_weights
        wte = np.zeros(wq * 32, np.float32)
        wte[:data.n_queries] = data.log.test_weights
        return cls(
            clause_query_bits=bitset.to_tensor(data.clause_query_bits, dev),
            clause_doc_bits=bitset.to_tensor(data.clause_doc_bits, dev),
            query_weights=torch.from_numpy(wtr).to(dev),
            test_weights=torch.from_numpy(wte).to(dev),
            n_queries=data.n_queries,
            n_docs=data.n_docs,
        )

    def with_weights(self, train_weights, test_weights=None) -> "SCSKProblem":
        """Reweighted copy for the same query universe (re-tiering).

        Swaps only the empirical distribution; the packed clause/query/doc
        bitsets are shared with `self`. Weights may be length `n_queries`
        (zero-padded here, like `from_data`) or already padded to `wq * 32`.
        """
        def pad(w) -> torch.Tensor:
            w = np.asarray(w, np.float32)
            if w.shape != (self.n_queries,) and w.shape != (self.wq * 32,):
                raise ValueError(
                    f"weights must have shape ({self.n_queries},) or "
                    f"({self.wq * 32},), got {w.shape}")
            padded = np.zeros(self.wq * 32, np.float32)
            padded[:w.shape[0]] = w
            return torch.from_numpy(padded).to(self.device)

        return dataclasses.replace(
            self,
            query_weights=pad(train_weights),
            test_weights=self.test_weights if test_weights is None
            else pad(test_weights),
        )

    # -- shapes ---------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.clause_query_bits.device

    @property
    def n_clauses(self) -> int:
        return self.clause_query_bits.shape[0]

    @property
    def wq(self) -> int:
        return self.clause_query_bits.shape[1]

    @property
    def wd(self) -> int:
        return self.clause_doc_bits.shape[1]

    def empty_state(self):
        z = dict(dtype=torch.int32, device=self.device)
        return torch.zeros(self.wq, **z), torch.zeros(self.wd, **z)

    # -- solver state ---------------------------------------------------------
    def init_state(self) -> SolverState:
        """Fresh (cold-start) solver state: nothing selected, nothing covered."""
        covered_q, covered_d = self.empty_state()
        return SolverState(
            covered_q=covered_q,
            covered_d=covered_d,
            selected=torch.zeros(self.n_clauses, dtype=torch.bool,
                                 device=self.device),
            g_used=torch.zeros((), dtype=torch.float32, device=self.device),
            step=0,
        )

    def state_for(self, kept) -> SolverState:
        """Exact `SolverState` for a clause subset, as if it were a solve
        prefix: covered bitsets OR-ed on the device, `g_used` recomputed."""
        idx = torch.as_tensor(np.asarray(kept, np.int64), device=self.device)
        selected = torch.zeros(self.n_clauses, dtype=torch.bool,
                               device=self.device)
        selected[idx] = True
        covered_d = bitset.or_rows(self.clause_doc_bits[idx])
        return SolverState(
            covered_q=bitset.or_rows(self.clause_query_bits[idx]),
            covered_d=covered_d,
            selected=selected,
            g_used=self.g_value(covered_d),
            step=len(idx),
        )

    def apply(self, state: SolverState, j: int) -> SolverState:
        """Select clause j: fold its coverage into a new state."""
        covered_q, covered_d = self.add_clause(state.covered_q,
                                               state.covered_d, j)
        selected = state.selected.clone()
        selected[j] = True
        return SolverState(
            covered_q=covered_q,
            covered_d=covered_d,
            selected=selected,
            g_used=self.g_value(covered_d),
            step=state.step + 1,
        )

    # -- oracles --------------------------------------------------------------
    def uncovered_weights(self, covered_q: torch.Tensor, *,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
        """x = w ⊙ (1 − unpack(covered_q)), the f-gains' right-hand side.

        Its length is that of `covered_q`'s bits, so `weights` may weigh
        any bit space of that width (ISK weighs the doc space)."""
        w = self.query_weights if weights is None else weights
        return w * (1.0 - bitset.unpack(covered_q).to(torch.float32))

    def f_gains(self, covered_q: torch.Tensor, *,
                rows: torch.Tensor | None = None,
                weights: torch.Tensor | None = None) -> torch.Tensor:
        """Weighted f(j|X) for all clauses (or a gathered row subset)."""
        x = self.uncovered_weights(covered_q, weights=weights)
        a = self.clause_query_bits if rows is None else rows
        return ops.bit_matvec(a, x[:, None])[:, 0]

    def g_gains(self, covered_d: torch.Tensor, *,
                rows: torch.Tensor | None = None,
                bounds: tuple[int, ...] | None = None) -> torch.Tensor:
        """g(j|X) for all clauses (or a gathered row subset), as f32 [C].

        With `bounds` (word offsets of a doc-space partition, see
        `core.constraint`), the per-partition cost gains g_k(j|X) as
        f32 [C, P] from one `ops.partition_gain` launch."""
        a = self.clause_doc_bits if rows is None else rows
        if bounds is None:
            return ops.coverage_gain(a, covered_d).to(torch.float32)
        return ops.partition_gain(a, covered_d, bounds).to(torch.float32)

    def f_value(self, covered_q: torch.Tensor, *,
                weights: torch.Tensor | None = None) -> torch.Tensor:
        w = self.query_weights if weights is None else weights
        return torch.sum(w * bitset.unpack(covered_q).to(torch.float32))

    def g_value(self, covered_d: torch.Tensor,
                bounds: tuple[int, ...] | None = None) -> torch.Tensor:
        """g(X) = |covered_d| as an f32 0-d tensor; with `bounds`, the
        per-partition fills g_k(X) as f32 [P]."""
        if bounds is None:
            return bitset.popcount(covered_d).to(torch.float32)
        per_word = bitset.word_popcount(covered_d)
        return torch.stack([per_word[lo:hi].sum()
                            for lo, hi in zip(bounds, bounds[1:])]
                           ).to(torch.float32)

    def add_clause(self, covered_q: torch.Tensor, covered_d: torch.Tensor, j):
        return (covered_q | self.clause_query_bits[j],
                covered_d | self.clause_doc_bits[j])


@dataclasses.dataclass
class SolverResult:
    """Common result record for every solver."""
    name: str
    selected: np.ndarray            # bool [C]
    order: list[int]                # selections made BY THIS CALL, in order
    f_final: float
    g_final: float
    f_history: np.ndarray
    g_history: np.ndarray
    time_history: np.ndarray        # cumulative wall seconds per recorded point
    n_exact_evals: int = 0          # marginal-gain evaluations (laziness metric)
    state: SolverState | None = None  # final state; resume via solve(..., state=)
    extra: dict = dataclasses.field(default_factory=dict)  # solver-specific

    def summary(self) -> str:
        return (f"{self.name}: f={self.f_final:.4f} g={self.g_final:.0f} "
                f"|X|={int(self.selected.sum())} evals={self.n_exact_evals}")
