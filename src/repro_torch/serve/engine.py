"""Two-tier serving engine (paper Fig. 1) with clause query classification.

The port's counterpart of `repro.serve.engine`. Request path per batch, on
the engine's device:
  1. pack the batch's token ids into vocab bitsets;
  2. ψ^clause (`ops.clause_match`) then the tier-selected AND-match
     (`ops.tier_match`) — eligible queries match against Tier-1 postings,
     the rest against Tier-2 — two launches on one stream with no host sync
     between them (`ops.fused_match`'s two steps);
  3. match words -> sorted doc ids, extracted on the device.
Theorem 3.1 guarantees step 2 returns the COMPLETE match set for eligible
queries; `serve_reference` is the single-tier oracle the tests compare to.

`ServeStats` counts word traffic exactly as the reference does: a Tier-1
match costs ceil(|D1|/32) words (a production Tier-1 re-indexes a compacted
doc space), a Tier-2 match the full postings width.

Telemetry (`repro_torch.obs`), as the reference's: the counters
`serve_queries_total`, `serve_tier1_hits_total`, `serve_words_total{tier}`,
the `tiering_swap` event, and per batch a `serve` span holding `classify`,
`t1_match` / `t2_match` (each with its tier's query count, for the tiers
that have queries) and `merge`. Both tiers are matched by one launch, made
right after `classify`'s; the tier spans follow the one host read of the
eligibility and carry each tier's word accounting. The counters are a view,
never an input: results and `ServeStats` are bit-identical with the plane
off.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import bitset
from repro_torch.core.tiering import ClauseTiering
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.serve import matching

# registry instruments the engine publishes into (no-ops with the plane off)
_QUERIES = obs.counter("serve_queries_total", "queries served")
_T1_HITS = obs.counter("serve_tier1_hits_total",
                       "queries answered entirely from Tier 1")
_WORDS = obs.counter("serve_words_total",
                     "postings words scanned", labels=("tier",))


@dataclasses.dataclass
class ServeStats:
    n_queries: int = 0
    n_tier1: int = 0
    tier1_words: int = 0            # postings words scanned in tier 1
    tier2_words: int = 0
    full_words_per_query: int = 0   # untiered per-query traffic (denominator)
    cache_hits: int = 0             # front-end result-cache hits (zero words
    #                                 scanned; cluster.frontend.ResultCache)

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

    def reset(self) -> None:
        """Zero the traffic counters (window boundary); the engine-constant
        `full_words_per_query` survives so ratios keep meaning."""
        self.n_queries = self.n_tier1 = 0
        self.tier1_words = self.tier2_words = 0
        self.cache_hits = 0

    def merge(self, other: "ServeStats") -> "ServeStats":
        """Fold another window's counters into this one, in place."""
        if self.full_words_per_query == 0:
            self.full_words_per_query = other.full_words_per_query
        elif other.full_words_per_query not in (0, self.full_words_per_query):
            raise ValueError(
                "merging stats from engines with different postings widths "
                f"({self.full_words_per_query} vs {other.full_words_per_query})")
        self.n_queries += other.n_queries
        self.n_tier1 += other.n_tier1
        self.tier1_words += other.tier1_words
        self.tier2_words += other.tier2_words
        self.cache_hits += other.cache_hits
        return self

    def snapshot(self) -> "ServeStats":
        """Detached copy (per-window reporting while counters keep running)."""
        return dataclasses.replace(self)

    def to_dict(self) -> dict:
        """JSON-ready dict: raw counters + the derived ratios (`from_dict`
        ignores the derived keys)."""
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["tier1_fraction"] = self.tier1_fraction
        d["cost_saving"] = self.cost_saving
        d["cache_hit_rate"] = self.cache_hit_rate
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServeStats":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


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
        self.corpus_version = 0          # corpus swaps are not ported yet
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

        Tier-1 is masked on the device (`matching.tier_postings`): the same
        words as the reference's host `tier_postings`, without a host round
        trip of the postings matrix.
        """
        words = bitset.n_words(int(tiering.tier1_docs.sum()))
        return TieringBuffer(
            tiering=tiering,
            clause_bits=bitset.to_tensor(tiering.clause_vocab_bits, self.device),
            postings_t1=matching.tier_postings(self.postings_t2,
                                               tiering.tier1_docs),
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
        obs.event("tiering_swap", generation=self._live.generation,
                  corpus_version=self.corpus_version)
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
        b = len(queries)
        with obs.span("serve", n=b, generation=live.generation):
            toks = self._tokens(queries)
            qbits = bitset.pack_tokens(toks, live.tiering.vocab_size)
            with obs.span("classify"):
                elig = ops.clause_match(qbits, live.clause_bits)
            match = ops.tier_match(live.postings_t1, self.postings_t2, elig,
                                   toks)
            n1 = int(elig.sum())             # waits for both launches
            w = self.postings_t2.shape[1]
            for tier, n in ((1, n1), (2, b - n1)):
                if n == 0:
                    continue
                with obs.span("t1_match" if tier == 1 else "t2_match", n=n):
                    if tier == 1:
                        self.stats.n_tier1 += n
                        self.stats.tier1_words += \
                            n * live.tier1_words_per_query
                        _WORDS.inc(n * live.tier1_words_per_query, tier="t1")
                    else:
                        self.stats.tier2_words += n * w
                        _WORDS.inc(n * w, tier="t2")
            with obs.span("merge"):
                out = bitset.rows_to_indices(match, self.n_docs)
            self.stats.n_queries += b
            _QUERIES.inc(b)
            _T1_HITS.inc(n1)
        return out

    def serve_reference(self, queries: list[tuple[int, ...]]) -> list[np.ndarray]:
        """Single-tier oracle for correctness tests."""
        m = ops.match_batch(self.postings_t2, self._tokens(queries))
        return bitset.rows_to_indices(m, self.n_docs)
