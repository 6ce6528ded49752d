"""Rolling swaps: drain → swap → undrain, one replica at a time — for
Tier-1 tierings AND (repro.ingest) for corpus-versioned postings.

A re-tiering changes BOTH halves of the serving contract — the ψ^clause
classifier at the router and the Tier-1 sub-indexes on the replicas — and
Theorem 3.1 only holds when a query classified by generation g's ψ is served
by generation g's Tier-1 *content*. A corpus append additionally changes the
Tier-2 postings slices, and exactness then needs a third leg: the (ψ, Tier-1,
Tier-2) triple a batch observes must all come from ONE corpus version. The
cluster therefore never hot-swaps the fleet at once: a `RollingSwap` walks
the replicas in REPLICA-MAJOR order (replica r of every changed Tier-1
shard, then every changed Tier-2 shard, then r+1, ...), so with ≥ 2 replicas
per group some complete (ψ, postings) cover exists at every instant and the
router always serves a batch entirely at one version.

Generations roll PER SHARD, independently: every buffer carries a per-shard
CONTENT id for each tier (`shard_content` for Tier-1, `t2_content` for the
Tier-2 slices), and a replica already holding a shard's target content — a
shard the change didn't touch, the common case for scoped refits and for
grow-mode corpus appends (only the LAST shard's word range grows) — is left
in place without ever draining. Only the shards whose sub-index actually
changed pay the drain→swap→undrain walk. Content, not the generation number,
is what correctness needs: the router picks replicas by content and
`BatchTrace` records served-vs-expected content per shard for both tiers.

With a single replica per (changed) shard there is a mid-rollout gap where
no generation covers every shard; the router then routes the batch to the
newest corpus version with full Tier-2 cover, which is exact for any query
at that version — correctness never depends on rollout timing.

Each replica swap is two-phase: `step()` first marks the replica draining
(the router stops sending it batches; in-flight work finishes), the next
`step()` commits the new (sub-index, words, generation, content) and
undrains.

The port's counterpart of `repro.cluster.rollout`: a buffer's sub-indexes
and pinned Tier-2 slices are int32 word tensors on the fleet's device, and
it carries its clause set as device words for ψ.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core.tiering import ClauseTiering


class StaleCorpusError(RuntimeError):
    """A swap was requested against an outdated corpus version.

    Raised (instead of the bare shape assert / KeyError it used to surface
    as) when a prepared `ClusterTieringBuffer` — or a raw `ClauseTiering`
    sized for the old document universe — is handed to the fleet after the
    corpus has rolled past the version it was built against. The fix is
    always the same: rebuild the tiering/buffer from the appended
    `TieringData` (current `n_docs`) and swap that.
    """


@dataclasses.dataclass(frozen=True)
class ClusterTieringBuffer:
    """An off-path-built per-shard generation, ready to roll out.

    Besides the Tier-1 sub-indexes, the buffer pins the ENTIRE corpus
    snapshot it was built against (repro.ingest): the shard plan, the
    per-shard Tier-2 postings slices with their content ids, and the
    (n_docs, w_total) extent. Serving a batch strictly from one buffer is
    what makes a mid-rollout batch exact — the router never mixes tiers
    from different corpus versions. Snapshot fields are shared references
    (append-only growth never rewrites a word), so carrying them is free.
    """
    tiering: ClauseTiering
    shard_postings: list[torch.Tensor]  # per-shard Tier-1 sub-indexes
    shard_words: list[int]              # compacted words/query per shard
    generation: int = 0
    # content id per shard: equal ids <=> bit-identical sub-index, so buffers
    # that share a shard's content are interchangeable on that shard
    shard_content: tuple[int, ...] = ()
    # corpus snapshot (defaults keep hand-built test buffers constructible)
    corpus_version: int = 0
    shards: tuple = ()                  # DocShard plan at this version
    t2_postings: tuple = ()             # per-shard Tier-2 column slices
    t2_content: tuple[int, ...] = ()    # content id per Tier-2 slice
    n_docs: int = 0
    w_total: int = 0                    # postings words at this version
    clause_bits: torch.Tensor | None = None   # ψ's clauses, int32 [K, Wv]

    def shard_nonempty(self, s: int) -> bool:
        return self.shard_words[s] > 0


class RollingSwap:
    """Walks the replica groups toward `buffer`, one replica phase at a time.

    Tier-1 replicas already holding their shard's target content commit
    instantly (metadata-only, no drain) at construction; Tier-2 replicas
    whose slice content is unchanged — every corpus-untouched shard — are
    not touched at all. The rest swap one at a time in replica-major order,
    Tier-1 shards before Tier-2 shards within each replica column, so one
    full (ψ, Tier-1, Tier-2) cover lands before the second column starts.
    """

    def __init__(self, buffer: ClusterTieringBuffer, t1_groups,
                 t2_groups=()):
        self.buffer = buffer
        self.n_swapped = 0
        self.n_carried = 0
        pending = []
        for g in t1_groups:
            for rep in g:
                if rep.content == buffer.shard_content[rep.shard.index]:
                    rep.commit(buffer.shard_postings[rep.shard.index],
                               buffer.shard_words[rep.shard.index],
                               buffer.generation,
                               buffer.shard_content[rep.shard.index],
                               shard=self._plan(rep))
                    self.n_carried += 1
                else:
                    pending.append(rep)
        if buffer.t2_content:
            for g in t2_groups:
                for rep in g:
                    if rep.content != buffer.t2_content[rep.shard.index]:
                        pending.append(rep)
        # replica-major: [:, 0] then [:, 1] ... so one full cover swaps first
        groups = list(t1_groups) + list(t2_groups)
        n_replicas = max((len(g) for g in groups), default=0)
        by_rep = {id(r): i for g in groups for i, r in enumerate(g)}
        self._pending = [r for i in range(n_replicas)
                         for r in pending if by_rep[id(r)] == i]
        self._draining = None
        obs.event("rollout_begin", generation=buffer.generation,
                  corpus_version=buffer.corpus_version,
                  carried=self.n_carried, pending=len(self._pending))
        if self.done:                    # all content carried: instant rollout
            obs.event("rollout_done", generation=buffer.generation,
                      corpus_version=buffer.corpus_version,
                      swapped=0, carried=self.n_carried)

    def _plan(self, rep):
        """The replica's DocShard under the buffer's plan (grow mode may
        have widened the last shard); None when the buffer predates plans."""
        if rep.shard.index < len(self.buffer.shards):
            return self.buffer.shards[rep.shard.index]
        return None

    def _commit(self, rep) -> None:
        s = rep.shard.index
        if rep.tier == 1:
            rep.commit(self.buffer.shard_postings[s],
                       self.buffer.shard_words[s], self.buffer.generation,
                       self.buffer.shard_content[s], shard=self._plan(rep))
        else:
            new_shard = self._plan(rep)
            rep.commit(self.buffer.t2_postings[s],
                       new_shard.n_words if new_shard is not None
                       else rep.words_per_query,
                       self.buffer.generation, self.buffer.t2_content[s],
                       shard=new_shard)

    @property
    def done(self) -> bool:
        return self._draining is None and not self._pending

    def step(self):
        """Advance one phase; returns the replica acted on (or None if done)."""
        if self._draining is not None:
            rep = self._draining
            self._commit(rep)
            self._draining = None
            self.n_swapped += 1
            obs.event("replica_swap", tier=rep.tier, shard=rep.shard.index,
                      generation=rep.generation, content=rep.content)
            if self.done:
                obs.event("rollout_done", generation=self.buffer.generation,
                          corpus_version=self.buffer.corpus_version,
                          swapped=self.n_swapped, carried=self.n_carried)
            return rep
        if not self._pending:
            return None
        rep = self._pending.pop(0)
        rep.draining = True
        self._draining = rep
        obs.event("replica_drain", tier=rep.tier, shard=rep.shard.index,
                  generation=rep.generation, content=rep.content)
        return rep

    def run_to_completion(self) -> int:
        """Swap every remaining replica (no traffic between steps)."""
        while not self.done:
            self.step()
        return self.n_swapped
