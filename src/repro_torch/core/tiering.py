"""Clause tiering: the ψ/φ classifiers of paper §3.1 + coverage evaluation.

The port's counterpart of `repro.core.tiering`. A `ClauseTiering` is the
deployable artifact a solve produces: the selected clause set (packed over
the vocabulary for online subset tests), the materialized Tier-1 document
set, and host-side evaluation helpers. `verify_correctness` checks Theorem
3.1 exhaustively on a query set.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch.core import bitset

if typing.TYPE_CHECKING:
    from repro_torch.data.incidence import TieringData


@dataclasses.dataclass
class ClauseTiering:
    clauses: list[tuple[int, ...]]
    clause_vocab_bits: np.ndarray     # packed uint32 [K, Wv] (ψ: subset test)
    tier1_docs: np.ndarray            # bool [n_docs]  (φ materialized)
    vocab_size: int

    @classmethod
    def from_selection(cls, data: "TieringData",
                       selected: np.ndarray) -> "ClauseTiering":
        """From a solve's selection over `data`'s clauses.

        `data` needs `clauses`, `vocab_size`, `n_docs` and `clause_doc_bits`;
        the latter may be host uint32 words or device int32 words, and the
        Tier-1 union is then taken on the device.
        """
        idx = np.nonzero(np.asarray(selected))[0]
        clauses = [data.clauses[i] for i in idx]
        cbits = np.zeros((len(clauses), data.vocab_size), bool)
        for i, c in enumerate(clauses):
            cbits[i, list(c)] = True
        rows = data.clause_doc_bits
        if isinstance(rows, torch.Tensor):
            t1_bits = bitset.to_numpy(bitset.or_rows(
                rows[torch.as_tensor(idx, device=rows.device)]))
        else:
            t1_bits = np.bitwise_or.reduce(rows[idx], axis=0) if len(idx) \
                else np.zeros(rows.shape[1], np.uint32)
        return cls(clauses=clauses, clause_vocab_bits=bitset.np_pack(cbits),
                   tier1_docs=bitset.np_unpack(t1_bits, data.n_docs),
                   vocab_size=data.vocab_size)

    # ψ^clause (eq. 8): Tier 1 iff some selected clause ⊆ q
    def classify_queries(self, query_bits: np.ndarray, chunk: int = 4096) -> np.ndarray:
        out = np.zeros(query_bits.shape[0], bool)
        if len(self.clauses) == 0:
            return out
        for s in range(0, query_bits.shape[0], chunk):
            q = query_bits[s:s + chunk]                      # [b, Wv]
            sub = (q[:, None, :] & self.clause_vocab_bits[None]) == \
                self.clause_vocab_bits[None]
            out[s:s + chunk] = sub.all(axis=-1).any(axis=1)
        return out

    def coverage(self, data: "TieringData") -> dict[str, float]:
        elig = self.classify_queries(data.log.query_bits)
        return {
            "train": float(data.log.train_weights[elig].sum()),
            "test": float(data.log.test_weights[elig].sum()),
            "tier1_frac": float(self.tier1_docs.mean()),
        }

    def verify_correctness(self, data: "TieringData") -> bool:
        """Theorem 3.1: every eligible query's match set is inside Tier 1."""
        elig = self.classify_queries(data.log.query_bits)
        t1 = bitset.np_pack(self.tier1_docs)
        m_out = data.query_doc_bits & ~t1[None, :]
        ok = ~np.any(m_out, axis=1)
        return bool(np.all(ok[elig]))
