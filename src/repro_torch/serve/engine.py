"""Two-tier serving engine (paper Fig. 1) with clause query classification.

The port's counterpart of `repro.serve.engine`. Request path per batch, on
the engine's device:
  1. pack the batch's token ids into vocab bitsets;
  2. `ops.fused_match`: ψ^clause (`clause_match` kernel) then the
     tier-selected AND-match (`tier_match` kernel) — eligible queries match
     against Tier-1 postings, the rest against Tier-2 — two launches on one
     stream with no host sync between them;
  3. match words -> sorted doc ids, extracted on the device.
Theorem 3.1 guarantees step 2 returns the COMPLETE match set for eligible
queries; `serve_reference` is the single-tier oracle the tests compare to.

`ServeStats` counts word traffic exactly as the reference does: a Tier-1
match costs ceil(|D1|/32) words (a production Tier-1 re-indexes a compacted
doc space), a Tier-2 match the full postings width.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core.tiering import ClauseTiering
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.serve import matching


@dataclasses.dataclass
class ServeStats:
    n_queries: int = 0
    n_tier1: int = 0
    tier1_words: int = 0            # postings words scanned in tier 1
    tier2_words: int = 0
    full_words_per_query: int = 0   # untiered per-query traffic (denominator)
    cache_hits: int = 0             # front-end result-cache hits (none here)

    @property
    def tier1_fraction(self) -> float:
        return self.n_tier1 / max(1, self.n_queries)

    @property
    def cache_hit_rate(self) -> float:
        return self.cache_hits / max(1, self.n_queries)

    @property
    def cost_saving(self) -> float:
        """Word-traffic saving vs an untiered (Tier-2-only) system."""
        base = self.n_queries * self.full_words_per_query
        if base == 0:
            return 0.0
        return 1.0 - (self.tier1_words + self.tier2_words) / base

    def to_dict(self) -> dict:
        """JSON-ready dict: raw counters + the derived ratios."""
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["tier1_fraction"] = self.tier1_fraction
        d["cost_saving"] = self.cost_saving
        d["cache_hit_rate"] = self.cache_hit_rate
        return d


@dataclasses.dataclass(frozen=True)
class TieringBuffer:
    """An off-path-built Tier-1 generation, ready to swap in."""
    tiering: ClauseTiering
    clause_bits: torch.Tensor       # int32 words [K, Wv] of the clauses
    postings_t1: torch.Tensor       # int32 words [V, Wd], Tier-2 & Tier-1 mask
    tier1_words_per_query: int
    generation: int = 0


class TieredEngine:
    def __init__(self, postings, tiering: ClauseTiering, n_docs: int, *,
                 device=None):
        """`postings` are host uint32 words [V, Wd] or int32 words on a
        device; the engine runs on `device` (default: the tensor's device,
        else CUDA)."""
        if isinstance(postings, torch.Tensor):
            self.device = postings.device if device is None \
                else torch.device(device)
            self.postings_t2 = postings.to(self.device)
        else:
            self.device = resolve_device(device)
            self.postings_t2 = bitset.to_tensor(postings, self.device)
        self.n_docs = n_docs
        self._live = self.prepare_tiering(tiering)   # generation 0
        self.stats = ServeStats(full_words_per_query=self.postings_t2.shape[1])

    # the live generation is ONE reference: readers grab self._live once per
    # batch, so (ψ, Tier-1 index) always come from the same clause selection
    @property
    def tiering(self) -> ClauseTiering:
        return self._live.tiering

    @property
    def postings_t1(self) -> torch.Tensor:
        return self._live.postings_t1

    @property
    def tier1_words_per_query(self) -> int:
        return self._live.tier1_words_per_query

    @property
    def generation(self) -> int:
        return self._live.generation

    # -- zero-downtime re-tiering ---------------------------------------------
    def prepare_tiering(self, tiering: ClauseTiering) -> TieringBuffer:
        """Build the next Tier-1 generation off the request path.

        Tier-1 is masked on the device (`postings_t2 & tier1 mask`): the same
        words as the reference's host `tier_postings`, without a host round
        trip of the postings matrix.
        """
        mask = bitset.to_tensor(bitset.np_pack(tiering.tier1_docs), self.device)
        words = bitset.n_words(int(tiering.tier1_docs.sum()))
        return TieringBuffer(
            tiering=tiering,
            clause_bits=bitset.to_tensor(tiering.clause_vocab_bits, self.device),
            postings_t1=self.postings_t2 & mask,
            tier1_words_per_query=words)

    def swap_tiering(self, tiering: ClauseTiering | TieringBuffer) -> int:
        """Atomically route traffic to a new tiering; returns the generation.

        The commit is a single reference store of the whole generation, and
        `serve` reads that reference once per batch, so a batch sees either
        the old (ψ, Tier-1 index) pair or the new one, never a mix.
        """
        buf = tiering if isinstance(tiering, TieringBuffer) \
            else self.prepare_tiering(tiering)
        self._live = dataclasses.replace(
            buf, generation=self._live.generation + 1)
        return self._live.generation

    def _tokens(self, queries: list[tuple[int, ...]]) -> torch.Tensor:
        return torch.from_numpy(matching.pad_token_batch(queries)).to(self.device)

    def classify(self, queries: list[tuple[int, ...]]) -> np.ndarray:
        live = self._live
        return matching.classify_batch(
            live.clause_bits, self._tokens(queries),
            live.tiering.vocab_size).cpu().numpy()

    def serve(self, queries: list[tuple[int, ...]]) -> list[np.ndarray]:
        """Returns the match set (sorted int64 doc ids) per query."""
        live = self._live                    # one read: a consistent generation
        toks = self._tokens(queries)
        qbits = bitset.pack_tokens(toks, live.tiering.vocab_size)
        match, elig = ops.fused_match(qbits, live.clause_bits, toks,
                                      live.postings_t1, self.postings_t2)
        n1 = int(elig.sum())
        self.stats.n_tier1 += n1
        self.stats.tier1_words += n1 * live.tier1_words_per_query
        self.stats.tier2_words += (len(queries) - n1) * self.postings_t2.shape[1]
        self.stats.n_queries += len(queries)
        return bitset.rows_to_indices(match, self.n_docs)

    def serve_reference(self, queries: list[tuple[int, ...]]) -> list[np.ndarray]:
        """Single-tier oracle for correctness tests."""
        m = ops.match_batch(self.postings_t2, self._tokens(queries))
        return bitset.rows_to_indices(m, self.n_docs)
