"""Scatter-gather routing over a sharded, replicated two-tier fleet.

Per batch, the `ClusterRouter`:

  1. picks the newest COMPLETE generation (every shard with a non-empty
     local D₁ has a live, non-draining Tier-1 replica at that generation's
     content, AND every shard has a Tier-2 replica at that generation's
     corpus version);
  2. runs ψ^clause ONCE for the whole batch through the packed
     clause-subset-test kernel (`kernels.ops.clause_match`) with that
     generation's clause set;
  3. scatters eligible queries to one Tier-1 replica per (non-empty) shard
     and the rest to one Tier-2 replica per shard, round-robin within each
     replica group — replicas are picked by CONTENT, so a batch is served
     entirely at one corpus version;
  4. gathers by OR-merging the per-shard packed match bitsets — shards own
     disjoint word ranges, so the merge is a word-slice placement and the
     result is bit-identical to single-tier matching at that version.

The (ψ, Tier-1, Tier-2) pairing invariant: classification and both serving
tiers always use the SAME generation's contents, per batch, by construction —
`BatchTrace` records all three (plus the corpus version) so tests can assert
no window ever observed a mixed triple. If a rolling swap leaves no complete
generation (single-replica groups mid-swap), the whole batch is served from
the newest corpus version with full Tier-2 cover, which is exact for any
query at that version.

The port's counterpart of `repro.cluster.router`, host path only: each
batch is classified on the fleet's device (tokens packed there, then
`ops.clause_match`), each shard replica matches with `ops.match_batch`
(the `tier_match` kernel) on its contiguous sub-index, and the per-shard
words are placed into one [B, W] device tensor whose rows become doc ids
on the device. Every `serve` span carries `fused=False`: the fused mesh
path and corpus swaps (ingest) are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.cluster import frontend
from repro_torch.cluster import shard as shard_mod
from repro_torch.cluster.rollout import (ClusterTieringBuffer, RollingSwap,
                                         StaleCorpusError)
from repro_torch.core import bitset
from repro_torch.core.tiering import ClauseTiering
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.serve import matching
from repro_torch.serve.engine import ServeStats

# BatchTrace history kept per router; a long run_stream/run_ingest session
# retains this many batches (explicit capacity=None restores full history
# for the parity tests that audit every batch ever served)
DEFAULT_TRACE_CAPACITY = 4096

# per-(tier, shard) word-traffic attribution for the whole fleet
_CWORDS = obs.counter("cluster_words_total",
                      "postings words scanned across the fleet",
                      labels=("tier", "shard"))
_CQUERIES = obs.counter("cluster_queries_total",
                        "queries served through the cluster router")
_FALLBACK = obs.counter("cluster_fallback_batches_total",
                        "batches served full-Tier-2 (no complete generation)")


class ShardReplica:
    """One serving unit: a (tier, shard) sub-index plus its own counters.

    `content` identifies the sub-index BITS the replica holds (see
    `ClusterTieringBuffer.shard_content` / `t2_content`); `generation` is
    the newest generation it has acknowledged. The two differ exactly when
    a rollout carried the replica's content forward (its shard didn't
    change), which is what lets per-shard generations roll independently.

    The sub-index is an int32 word tensor; the replica keeps it contiguous
    (the kernels take nothing else), copying a strided view once.
    """

    def __init__(self, tier: int, shard: shard_mod.DocShard,
                 postings, words_per_query: int, generation: int = 0,
                 content: int = 0):
        self.tier = tier
        self.shard = shard
        self.postings = postings.contiguous()
        self.words_per_query = words_per_query
        self.generation = generation
        self.content = content
        self.draining = False
        self.n_batches = 0
        self.n_queries = 0
        self.words_scanned = 0
        self.n_installs = 0          # real sub-index installs (not carries)

    def commit(self, postings, words_per_query: int, generation: int,
               content: int | None = None, shard=None) -> None:
        """Install a new generation and rejoin the rotation (rollout phase 2).

        When `content` matches what the replica already holds, the commit is
        metadata-only: no device buffer moves (a carried shard costs
        nothing). `shard` updates the replica's DocShard when a corpus
        append grew its word range (repro.ingest grow mode).
        """
        if content is None or content != self.content:
            self.postings = postings.contiguous()
            self.n_installs += 1
        self.words_per_query = words_per_query
        self.generation = generation
        if content is not None:
            self.content = content
        if shard is not None:
            self.shard = shard
        self.draining = False

    def match(self, tokens: torch.Tensor) -> torch.Tensor:
        """AND-match a padded token batch [B, L] (on the replica's device)
        against the local sub-index: int32 words [B, n_words]."""
        n = int(tokens.shape[0])
        self.n_batches += 1
        self.n_queries += n
        self.words_scanned += n * self.words_per_query
        return ops.match_batch(self.postings, tokens)

    def __repr__(self) -> str:  # debugging/observability
        return (f"ShardReplica(t{self.tier} s{self.shard.index} "
                f"gen={self.generation} c{self.content}"
                f"{' draining' if self.draining else ''})")


@dataclasses.dataclass(frozen=True)
class BatchTrace:
    """What one batch observed: the ψ generation it was classified with, the
    corpus version it was served at, and per served shard the CONTENT each
    replica held vs the content that generation prescribes — for BOTH
    tiers, so a mixed (ψ, Tier-1, Tier-2) triple is disprovable per batch."""
    psi_generation: int          # -1 = Tier-2 fallback (no ψ consulted)
    t1_generations: tuple[int, ...]
    n_tier1: int
    n_tier2: int
    t1_shards: tuple[int, ...] = ()         # shard index per Tier-1 server
    t1_contents: tuple[int, ...] = ()       # content each server held
    expected_contents: tuple[int, ...] = ()  # ψ generation's per-shard content
    corpus_version: int = 0                 # version the batch was served at
    t2_contents: tuple[int, ...] = ()       # Tier-2 content each server held
    expected_t2_contents: tuple[int, ...] = ()  # version's per-shard slices
    n_cached: int = 0    # front-end result-cache hits (n_tier1/n_tier2 count
    #                      only the fresh dispatches this batch paid for)

    @property
    def consistent(self) -> bool:
        """No mixed (ψ, Tier-1, Tier-2) triple, PER SHARD: every server held
        exactly the sub-index content the served generation prescribes for
        its shard and tier (generation numbers may differ across shards
        mid-roll — only content equality is what Theorem 3.1 needs)."""
        if self.t2_contents != self.expected_t2_contents:
            return False
        if self.t1_contents or self.expected_contents:
            return self.t1_contents == self.expected_contents
        return all(g == self.psi_generation for g in self.t1_generations)


class ClusterRouter:
    def __init__(self, shards: list[shard_mod.DocShard],
                 t1_groups: list[list[ShardReplica]],
                 t2_groups: list[list[ShardReplica]],
                 buffer0: ClusterTieringBuffer, n_docs: int, *,
                 trace_capacity: int | None = DEFAULT_TRACE_CAPACITY,
                 cache: frontend.ResultCache | None = None,
                 device=None):
        self.shards = shards            # current target plan
        self.t1 = t1_groups
        self.t2 = t2_groups
        self.cache = cache
        frontend.prime_counters()       # export zeroed series cache or not
        self.n_docs = n_docs
        # the fleet's device: where tokens are packed and results placed
        self.device = torch.device(device) if device is not None \
            else t2_groups[0][0].postings.device
        self._buffers: dict[int, ClusterTieringBuffer] = {
            buffer0.generation: buffer0}
        self.rollout: RollingSwap | None = None
        self._rr: dict[tuple[int, int], int] = {}
        self.trace: obs.Ring = obs.Ring(trace_capacity)
        self.stats = ServeStats(
            full_words_per_query=buffer0.w_total
            or sum(s.n_words for s in shards))

    # -- generations ----------------------------------------------------------
    @property
    def target_generation(self) -> int:
        return max(self._buffers)

    @property
    def target_tiering(self) -> ClauseTiering:
        return self._buffers[self.target_generation].tiering

    def live_generations(self) -> set[int]:
        return {r.generation for group in self.t1 for r in group}

    def _t2_covered(self, buf: ClusterTieringBuffer, *,
                    allow_draining: bool) -> bool:
        """Every shard has a Tier-2 replica at the buffer's corpus version.

        `allow_draining=True` is the fallback relaxation: a draining replica
        still physically holds its slice (drain only quiesces new batches
        ahead of an install), so reading it keeps the batch exact."""
        if not buf.t2_content:
            return True                  # hand-built buffer: unversioned
        return all(any(r.content == buf.t2_content[s.index]
                       and (allow_draining or not r.draining)
                       for r in self.t2[s.index])
                   for s in (buf.shards or self.shards))

    def complete_generations(self) -> list[int]:
        """Generations servable end to end, oldest first: a routable Tier-1
        replica on every shard whose local D₁ is non-empty under that
        generation, AND full Tier-2 cover at that generation's corpus
        version.

        Routable means holding the generation's CONTENT for that shard — a
        replica whose shard was carried across generations serves both, so
        scoped rollouts never open a fallback gap on untouched shards."""
        out = []
        for g, buf in sorted(self._buffers.items()):
            t1_ok = all(not buf.shard_nonempty(s.index)
                        or any(r.content == buf.shard_content[s.index]
                               and not r.draining
                               for r in self.t1[s.index])
                        for s in (buf.shards or self.shards))
            if t1_ok and self._t2_covered(buf, allow_draining=False):
                out.append(g)
        return out

    def _fallback_buffer(self) -> ClusterTieringBuffer:
        """Newest corpus snapshot with full (possibly draining) Tier-2 cover
        — the version the mid-rollout gap serves entirely from Tier 2."""
        for g in sorted(self._buffers, reverse=True):
            if self._t2_covered(self._buffers[g], allow_draining=True):
                return self._buffers[g]
        raise RuntimeError(            # unreachable: rollouts keep old buffers
            "no live corpus version has full Tier-2 cover")

    # -- rolling swaps --------------------------------------------------------
    def begin_rollout(self, buffer: ClusterTieringBuffer) -> None:
        cur = self._buffers[self.target_generation]
        if buffer.corpus_version < cur.corpus_version:
            raise StaleCorpusError(
                f"rollout buffer was prepared at corpus version "
                f"{buffer.corpus_version} but the fleet has rolled to "
                f"{cur.corpus_version}; rebuild it from the appended data "
                "(prepare_tiering after the corpus swap)")
        if self.rollout is not None:        # supersede: finish the old roll
            self.rollout.run_to_completion()
        self._buffers[buffer.generation] = buffer
        self.rollout = RollingSwap(buffer, self.t1, self.t2)

    def advance_rollout(self, steps: int = 1) -> None:
        if self.rollout is None:
            return
        for _ in range(steps):
            self.rollout.step()
        if self.rollout.done:
            self.rollout = None
            self._prune_buffers()

    def _prune_buffers(self) -> None:
        keep = self.live_generations() | {self.target_generation}
        self._buffers = {g: b for g, b in self._buffers.items() if g in keep}
        if self.cache is not None:
            # epoch bump: results computed under a now-dead generation can
            # never be served again — free them eagerly (memory hygiene;
            # lookup() would reject them anyway)
            self.cache.invalidate_below(
                min(self._buffers),
                min(b.corpus_version for b in self._buffers.values()))

    # -- routing --------------------------------------------------------------
    def _pick(self, group: list[ShardReplica], tier: int, shard_idx: int,
              content: int | None = None,
              draining_ok: bool = False) -> ShardReplica:
        ready = [r for r in group if (draining_ok or not r.draining)
                 and (content is None or r.content == content)]
        key = (tier, shard_idx)
        i = self._rr.get(key, 0)
        self._rr[key] = i + 1
        return ready[i % len(ready)]

    def _tokens(self, queries: list[tuple[int, ...]]) -> torch.Tensor:
        return torch.from_numpy(
            matching.pad_token_batch(queries)).to(self.device)

    def _psi(self, buf: ClusterTieringBuffer,
             tokens: torch.Tensor) -> torch.Tensor:
        """ψ^clause of a padded token batch under `buf`'s clause set: bool
        [B] on the fleet's device (`ops.clause_match`)."""
        return matching.classify_batch(buf.clause_bits, tokens,
                                       buf.tiering.vocab_size)

    def classify(self, queries: list[tuple[int, ...]]) -> np.ndarray:
        """ψ^clause of a batch under the target generation, on the host."""
        buf = self._buffers[self.target_generation]
        if len(queries) == 0:
            return np.zeros(0, bool)
        return self._psi(buf, self._tokens(queries)).cpu().numpy()

    def serve(self, queries: list[tuple[int, ...]]) -> list[np.ndarray]:
        """Exact global match sets (sorted int64 doc ids) per query, at the
        served buffer's corpus version: one `match_batch` per shard."""
        self.advance_rollout()              # one drain-or-swap phase per batch
        b = len(queries)
        if b == 0:
            return []
        complete = self.complete_generations()
        if complete:
            gen = complete[-1]              # newest fully-covered generation
            buf, use_t1 = self._buffers[gen], True
        else:                               # mid-rollout gap: Tier 2 is exact
            gen, buf, use_t1 = -1, self._fallback_buffer(), False
            _FALLBACK.inc()
            obs.event("t2_fallback", corpus_version=buf.corpus_version,
                      n_queries=b)
        if buf.w_total and self.stats.full_words_per_query != buf.w_total:
            self.stats.full_words_per_query = buf.w_total
        cache = self.cache
        dev = self.device
        with obs.span("serve", n=b, generation=gen,
                      corpus_version=buf.corpus_version, fused=False):
            # -- front-end result cache, before the tier match. The key is
            # the packed query vocab bitset (the reference's uint32 words):
            # equal keys => equal token sets => bit-identical match sets at
            # one epoch, and the epoch pins (generation, corpus version,
            # tier path) so rolling swaps invalidate by construction.
            keys = epoch = None
            hits: list[tuple[int, tuple]] = []
            miss_idx = np.arange(b)
            if cache is not None:
                epoch = (buf.generation, buf.corpus_version, use_t1)
                with obs.span("frontend", n=b):
                    qbits = matching.pack_query_bits(
                        queries, buf.tiering.vocab_size)
                    keys = [qbits[j].tobytes() for j in range(b)]
                    miss = []
                    for j, k in enumerate(keys):
                        ent = cache.lookup(epoch, k)
                        if ent is None:
                            miss.append(j)
                        else:
                            hits.append((j, ent))
                    miss_idx = np.asarray(miss, int)
            if len(miss_idx) == b:          # no cache, or every query missed
                out, elig = self._match_host(queries, buf, use_t1)
                m_out, m_elig = out, elig
            else:
                w_total = buf.w_total or self.stats.full_words_per_query
                out = torch.zeros((b, w_total), dtype=torch.int32, device=dev)
                elig = np.zeros(b, bool)
                m_out = out[:0]
                m_elig = np.zeros(0, bool)
                if len(miss_idx):           # fresh-match only the misses
                    sub = [queries[j] for j in miss_idx]
                    m_out, m_elig = self._match_host(sub, buf, use_t1)
                    out.index_copy_(0, torch.from_numpy(miss_idx).to(dev),
                                    m_out)
                    elig[miss_idx] = m_elig
                # hits cost zero postings words: their stored host rows go
                # to the device in one copy
                hit_idx = np.asarray([j for j, _ in hits], np.int64)
                rows = np.stack([row for _, (_e, row) in hits])
                out.index_copy_(0, torch.from_numpy(hit_idx).to(dev),
                                bitset.to_tensor(rows, dev))
                for j, (e, _row) in hits:
                    elig[j] = e
            if cache is not None and len(miss_idx):
                m_host = bitset.to_numpy(m_out)     # one transfer per batch
                for pos, j in enumerate(miss_idx):
                    cache.insert(epoch, keys[j], bool(m_elig[pos]),
                                 m_host[pos])
            self._account(buf, gen, m_elig, use_t1, n_cached=len(hits))
            if hits:
                self.stats.cache_hits += len(hits)
                # hits keep the traffic-mix metric (tier1_fraction) equal to
                # a cache-off run: the stored elig bit says which tier the
                # query BELONGS to, even though no replica was dispatched
                self.stats.n_tier1 += sum(1 for _, (e, _r) in hits if e)
            self.stats.n_queries += b
            _CQUERIES.inc(b)
            with obs.span("merge", n=b):
                return bitset.rows_to_indices(out, buf.n_docs or self.n_docs)

    def _match_host(self, queries, buf, use_t1
                    ) -> tuple[torch.Tensor, np.ndarray]:
        """Sequential per-shard dispatch; returns (int32 words [B, W] on the
        fleet's device, host bool eligibility [B])."""
        b = len(queries)
        dev = self.device
        shards = buf.shards or self.shards
        w_total = buf.w_total or self.stats.full_words_per_query
        out = torch.zeros((b, w_total), dtype=torch.int32, device=dev)
        toks = self._tokens(queries)
        if use_t1:
            with obs.span("classify", n=b):
                elig = self._psi(buf, toks).cpu().numpy()
        else:
            elig = np.zeros(b, bool)
        for tier, idx in ((1, np.nonzero(elig)[0]), (2, np.nonzero(~elig)[0])):
            if len(idx) == 0:
                continue
            rows = torch.from_numpy(idx).to(dev)
            sub = toks[rows]
            words = torch.zeros((len(idx), w_total), dtype=torch.int32,
                                device=dev)
            with obs.span("t1_match" if tier == 1 else "t2_match",
                          n=int(len(idx))) as sp:
                for s in shards:
                    if tier == 1 and not buf.shard_nonempty(s.index):
                        continue            # D₁ misses this shard: no matches
                    rep = self._served(tier, s.index, buf,
                                       draining_ok=tier == 2 and not use_t1)
                    words[:, s.word_lo:s.word_hi] = sp.sync(rep.match(sub))
            out.index_copy_(0, rows, words)
        return out, elig

    def _served(self, tier: int, shard_idx: int, buf,
                draining_ok: bool = False) -> ShardReplica:
        """Rotate the replica group and return the serving replica — picked
        by the BUFFER's content for that tier/shard, so every server this
        batch touches holds the same corpus version."""
        if tier == 1:
            return self._pick(self.t1[shard_idx], 1, shard_idx,
                              content=buf.shard_content[shard_idx])
        want = buf.t2_content[shard_idx] if buf.t2_content else None
        return self._pick(self.t2[shard_idx], 2, shard_idx, content=want,
                          draining_ok=draining_ok)

    def _account(self, buf, gen: int, elig: np.ndarray, use_t1: bool,
                 n_cached: int = 0) -> None:
        """Stats + BatchTrace from the replicas this batch was served by (or
        accounted against, on the fused path) — `_rr` already rotated, so
        `_pick` with a rewound rotation would misattribute; instead the
        counters were updated inside the match helpers and the trace reads
        the groups' current content directly."""
        n1 = int(elig.sum())
        n2 = len(elig) - n1
        shards = buf.shards or self.shards
        t1_gens, t1_shards, t1_contents, expected = [], [], [], []
        t2_contents, expected_t2 = [], []
        if n1:
            for s in shards:
                if not buf.shard_nonempty(s.index):
                    continue
                want = buf.shard_content[s.index]
                rep = next(r for r in self.t1[s.index]
                           if not r.draining and r.content == want)
                t1_gens.append(rep.generation)
                t1_shards.append(s.index)
                t1_contents.append(rep.content)
                expected.append(want)
                self.stats.tier1_words += n1 * rep.words_per_query
                _CWORDS.inc(n1 * rep.words_per_query, tier="t1",
                            shard=s.index)
            self.stats.n_tier1 += n1
        if n2:
            for s in shards:
                want = buf.t2_content[s.index] if buf.t2_content else None
                rep = next(r for r in self.t2[s.index]
                           if (want is None or r.content == want)
                           and (not use_t1 or not r.draining))
                self.stats.tier2_words += n2 * rep.words_per_query
                _CWORDS.inc(n2 * rep.words_per_query, tier="t2",
                            shard=s.index)
                t2_contents.append(rep.content)
                expected_t2.append(want if want is not None else rep.content)
        self.trace.append(BatchTrace(
            psi_generation=gen, t1_generations=tuple(t1_gens),
            n_tier1=n1, n_tier2=n2,
            t1_shards=tuple(t1_shards), t1_contents=tuple(t1_contents),
            expected_contents=tuple(expected),
            corpus_version=buf.corpus_version,
            t2_contents=tuple(t2_contents),
            expected_t2_contents=tuple(expected_t2),
            n_cached=n_cached))


class TieredCluster:
    """Engine-compatible facade over the sharded, replicated fleet.

    Duck-types the `serve.TieredEngine` surface (`serve`, `classify`,
    `serve_reference`, `stats`, `tiering`, `generation`, `prepare_tiering`,
    `swap_tiering`) so `stream.RetieringController` drives a whole cluster
    exactly as it drives one engine — except swaps here start ROLLING
    rollouts that progress one replica phase per served batch.

    `postings` are host uint32 words [V, Wd] or int32 words on a device;
    the fleet runs on `device` (default: the tensor's device, else CUDA).
    The shard slices and every generation's per-shard Tier-1 sub-indexes
    are built on that device from the postings tensor, with no host copy.
    """

    def __init__(self, postings, tiering: ClauseTiering,
                 n_docs: int, *, n_shards: int = 2, t1_replicas: int = 2,
                 t2_replicas: int = 1,
                 trace_capacity: int | None = DEFAULT_TRACE_CAPACITY,
                 cache: "bool | int | frontend.ResultCache | None" = None,
                 device=None):
        if t1_replicas < 1 or t2_replicas < 1:
            raise ValueError("each replica group needs >= 1 replica")
        # front-end result cache (cluster.frontend): False/None = off,
        # True = defaults, an int = capacity, or a configured ResultCache
        if cache is None or cache is False:
            cache_obj = None
        elif isinstance(cache, frontend.ResultCache):
            cache_obj = cache
        elif cache is True:
            cache_obj = frontend.ResultCache()
        else:
            cache_obj = frontend.ResultCache(capacity=int(cache))
        if isinstance(postings, torch.Tensor):
            self.device = postings.device if device is None \
                else torch.device(device)
            self.postings_t2 = postings.to(self.device)    # oracle index
        else:
            self.device = resolve_device(device)
            self.postings_t2 = bitset.to_tensor(postings, self.device)
        self.n_docs = n_docs
        self.corpus_version = 0          # corpus swaps are not ported yet
        self.shards, self._t2_dev = shard_mod.shard_postings(
            self.postings_t2, n_docs, n_shards)
        self._content_seq = 0
        self._t2_content = tuple(self._next_content() for _ in self.shards)
        buf0 = self._build_buffer(tiering, generation=0)
        t1 = [[ShardReplica(1, s, buf0.shard_postings[s.index],
                            buf0.shard_words[s.index],
                            content=buf0.shard_content[s.index])
               for _ in range(t1_replicas)] for s in self.shards]
        t2 = [[ShardReplica(2, s, self._t2_dev[s.index], s.n_words,
                            content=self._t2_content[s.index])
               for _ in range(t2_replicas)] for s in self.shards]
        self.router = ClusterRouter(self.shards, t1, t2, buf0, n_docs,
                                    trace_capacity=trace_capacity,
                                    cache=cache_obj, device=self.device)

    def _next_content(self) -> int:
        self._content_seq += 1
        return self._content_seq

    def _shard_t1(self, tiering: ClauseTiering, s) -> np.ndarray:
        return np.asarray(tiering.tier1_docs[s.doc_lo:s.doc_lo + s.n_docs],
                          bool)

    def _build_buffer(self, tiering: ClauseTiering,
                      generation: int) -> ClusterTieringBuffer:
        """Per-shard sub-indexes + content ids, on the fleet's device. A
        shard whose local D₁ slice equals the live target's carries that
        content id forward (its replicas won't drain during the rollout);
        changed shards get fresh ids. So a shard-scoped re-tiering builds a
        buffer that only rolls the shards it touched."""
        if len(tiering.tier1_docs) != self.n_docs:
            raise StaleCorpusError(
                f"tiering was built for {len(tiering.tier1_docs)} docs but "
                f"the corpus is at version {self.corpus_version} with "
                f"{self.n_docs}; rebuild it from the appended data")
        prev = None
        if hasattr(self, "router"):
            prev = self.router._buffers[self.router.target_generation]
        posts, words, contents = [], [], []
        for s in self.shards:
            p, w = shard_mod.shard_tier_postings(
                self._t2_dev[s.index], s, tiering.tier1_docs)
            posts.append(p)
            words.append(w)
            if prev is not None and np.array_equal(
                    self._shard_t1(tiering, s),
                    self._shard_t1(prev.tiering, s)):
                contents.append(prev.shard_content[s.index])
            else:
                contents.append(self._next_content())
        return ClusterTieringBuffer(
            tiering=tiering, shard_postings=posts, shard_words=words,
            generation=generation, shard_content=tuple(contents),
            corpus_version=self.corpus_version, shards=tuple(self.shards),
            t2_postings=tuple(self._t2_dev), t2_content=self._t2_content,
            n_docs=self.n_docs, w_total=int(self.postings_t2.shape[1]),
            clause_bits=bitset.to_tensor(tiering.clause_vocab_bits,
                                         self.device))

    # -- engine-compatible surface -------------------------------------------
    @property
    def stats(self) -> ServeStats:
        return self.router.stats

    @property
    def cache(self) -> frontend.ResultCache | None:
        """The front-end result cache, when serving with one (see
        `cluster.frontend.ResultCache`)."""
        return self.router.cache

    @property
    def tiering(self) -> ClauseTiering:
        return self.router.target_tiering

    @property
    def generation(self) -> int:
        return self.router.target_generation

    @property
    def tier1_words_per_query(self) -> int:
        buf = self.router._buffers[self.generation]
        return sum(buf.shard_words)

    def classify(self, queries: list[tuple[int, ...]]) -> np.ndarray:
        return self.router.classify(queries)

    def serve(self, queries: list[tuple[int, ...]]) -> list[np.ndarray]:
        return self.router.serve(queries)

    def serve_reference(self, queries: list[tuple[int, ...]]
                        ) -> list[np.ndarray]:
        """Single-tier, single-shard oracle for correctness tests: one
        `ops.match_batch` over the whole postings."""
        m = ops.match_batch(self.postings_t2, self.router._tokens(queries))
        return bitset.rows_to_indices(m, self.n_docs)

    def prepare_tiering(self, tiering: ClauseTiering) -> ClusterTieringBuffer:
        """Build every shard's next Tier-1 sub-index OFF the request path."""
        return self._build_buffer(tiering, generation=0)

    def swap_tiering(self, tiering: ClauseTiering | ClusterTieringBuffer,
                     *, immediate: bool = False) -> int:
        """Start a rolling swap to a new tiering; returns its generation.

        The rollout advances one drain/swap phase per served batch; pass
        `immediate=True` (or call `drain_rollout`) to complete it with no
        traffic in between. Serving stays exact throughout either way.
        Raises `StaleCorpusError` for a tiering or prepared buffer built
        against a different document count than the fleet's.
        """
        buf = tiering if isinstance(tiering, ClusterTieringBuffer) \
            else self.prepare_tiering(tiering)
        buf = dataclasses.replace(
            buf, generation=self.router.target_generation + 1)
        self.router.begin_rollout(buf)
        if immediate:
            self.drain_rollout()
        return buf.generation

    def drain_rollout(self) -> None:
        """Finish any in-progress rollout without serving traffic."""
        while self.router.rollout is not None:
            self.router.advance_rollout()

    # -- observability --------------------------------------------------------
    @property
    def trace(self) -> obs.Ring:
        """Retained `BatchTrace` history (bounded ring; see
        `trace_capacity`). List-like: iterate, index, `len`, truthiness."""
        return self.router.trace

    def consistency_ok(self) -> bool:
        """True iff no served batch ever saw a mixed (ψ, Tier-1, Tier-2)
        triple."""
        return all(t.consistent for t in self.router.trace)

    def describe(self) -> str:
        t1n = sum(len(g) for g in self.router.t1)
        t2n = sum(len(g) for g in self.router.t2)
        return (f"{len(self.shards)} shards x ({t1n} t1 + {t2n} t2 replicas)"
                f"  gen={self.generation}  v{self.corpus_version}"
                f"  live={sorted(self.router.live_generations())}")
