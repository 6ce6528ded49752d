"""Deterministic discrete-event load generator for the serving cluster.

A copy of `repro.cluster.loadgen` (numpy): the same seed gives the same
`LoadgenReport`.

Open-loop seeded Poisson arrivals hit the fleet topology (per-shard,
per-replica words-per-query from a `ClusterPlan` snapshot); each query
scatters one subquery to the least-loaded replica of every shard it must
touch (Tier-1 shards with local D₁ when eligible, every Tier-2 shard
otherwise), each replica is a single-server FIFO queue, and the query
completes when its slowest subquery gathers — so tail latency captures both
queueing and the straggler amplification of wide scatter fan-outs.

Service-time model (per subquery):
    service = t_fixed_us + words_per_query * t_word_us    [microseconds]
with a seeded heavy-tail straggler: with probability `straggler_p` the
subquery is stretched by `straggler_x`. Everything is derived from one
`numpy` Generator, so two runs with equal arguments are bit-identical.

Optionally, a rolling Tier-1 swap can be injected mid-run (`rollout_at_s`):
replicas go unavailable one at a time for `swap_ms` each, in the same
replica-major order the live `RollingSwap` uses; eligible queries fall back
to the Tier-2 scatter when no Tier-1 cover remains, exactly like the router.
With `rollout_mode="stw"` the same aggregate swap time is instead ONE global
outage window — the whole fleet is down and every query arriving inside it
waits for the rebuild — which is the stop-the-world comparison arm for the
rolling-ingest benchmarks.

Ingest traffic (repro.ingest): `ingest_qps` adds a seeded Poisson stream of
document-append events. Grow-mode appends land every new word in the LAST
shard (`shard.grow_shards`), so each event writes `ingest_words` words into
every Tier-2 replica of that shard — writes queue in the same FIFO as reads
and show up as read-latency pressure, which is exactly the interference the
ingest benchmarks measure. `ingest_qps=0` draws nothing extra from the rng,
so query-only runs stay bit-identical to the pre-ingest generator.

Front-end layers (repro.cluster.frontend), each default-off and each drawing
from a SEPARATE seeded generator so defaults-off runs stay bit-identical to
the pre-frontend generator:

  * `hedge_ms` — hedged dispatch: when a subquery's predicted completion
    (queue wait + service) exceeds the hedge delay, a backup fires on the
    second-least-loaded replica of the same group after the delay;
    first-response-wins, the loser is CANCELLED (its queue slot rolls back
    to the work actually done, the extra words it scanned are reported as
    `hedge_extra_words`) — the classic p99-straggler amputation;
  * `admission` (an `AdmissionPolicy`) — bounded per-shard queues +
    deadline-aware shedding: over-bound eligible queries demote to the
    Tier-2 scatter (`n_shed_to_t2`), and a query the Tier-2 queue can't
    serve in time gets a DEGRADED immediate answer priced at `t_fixed` only
    (`n_shed`) — no postings scanned, the load-shed counters tell on it;
  * `cache_keys` — the front-end result cache in sim form: per-arrival key
    ids (e.g. `frontend.zipf_keys`), an LRU of `cache_capacity` keys with
    optional `cache_ttl_s`; a hit costs `t_fixed` and zero words, which is
    exactly how `ResultCache` prices a hit on the real router.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from repro_torch import obs
from repro_torch.cluster.frontend import AdmissionPolicy

_HEDGES = obs.counter("loadgen_hedges_total",
                      "backup subqueries fired by hedged dispatch")
_SHEDS = obs.counter("loadgen_sheds_total",
                     "queries shed by overload admission",
                     labels=("kind",))     # degraded | to_t2

# fixed bucket upper bounds (ms) for every loadgen latency histogram — pinned
# so any two runs' histograms merge bucket-by-bucket in BENCH_cluster.json
LATENCY_BUCKETS_MS = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                      100.0, 200.0, 500.0, 1000.0)


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Static topology snapshot the simulator runs against.

    t1_words[s][r] / t2_words[s][r]: words-per-query of replica r of shard s
    (Tier-1 entries of 0 mean D₁ misses the shard — never contacted).
    """
    t1_words: tuple[tuple[int, ...], ...]
    t2_words: tuple[tuple[int, ...], ...]

    @classmethod
    def of_cluster(cls, cluster) -> "ClusterPlan":
        return cls(
            t1_words=tuple(tuple(r.words_per_query for r in g)
                           for g in cluster.router.t1),
            t2_words=tuple(tuple(r.words_per_query for r in g)
                           for g in cluster.router.t2))

    @property
    def n_shards(self) -> int:
        return len(self.t2_words)

    @property
    def t1_replicas(self) -> int:
        return max((len(g) for g in self.t1_words), default=0)

    @property
    def t2_replicas(self) -> int:
        return max((len(g) for g in self.t2_words), default=0)

    def resized(self, t1_replicas: int, t2_replicas: int) -> "ClusterPlan":
        """Same shard topology with each replica group resized (replicas in
        a group are homogeneous: they serve the same sub-index)."""
        if t1_replicas < 1 or t2_replicas < 1:
            raise ValueError("each replica group needs >= 1 replica")
        return ClusterPlan(
            t1_words=tuple((g[0],) * t1_replicas if g else ()
                           for g in self.t1_words),
            t2_words=tuple((g[0],) * t2_replicas if g else ()
                           for g in self.t2_words))


@dataclasses.dataclass
class LoadgenReport:
    n_queries: int
    offered_qps: float
    throughput_qps: float       # completed / makespan
    p50_ms: float
    p95_ms: float
    p99_ms: float
    mean_ms: float
    max_ms: float
    tier1_fraction: float
    fleet_words: int            # total postings words scanned fleet-wide
    per_shard_t2_words: tuple[int, ...]   # strong-scaling signal
    t2_fallback_queries: int    # eligible queries served by Tier 2 (rollout)
    # queueing observability (autoscaling inputs): busiest replica's busy
    # fraction of the makespan and worst queue backlog seen at dispatch, ms
    max_t1_util: float = 0.0
    max_t2_util: float = 0.0
    max_t1_backlog_ms: float = 0.0
    max_t2_backlog_ms: float = 0.0
    # ingest-under-load observability (repro.ingest)
    n_ingest_events: int = 0
    ingest_words_total: int = 0          # words written fleet-wide
    stw_delayed_queries: int = 0         # arrivals inside the stw outage
    # front-end layers (repro.cluster.frontend) — all zero when disabled
    n_hedges: int = 0                    # backup subqueries fired
    n_hedge_wins: int = 0                # hedges where the backup won
    n_hedge_cancels: int = 0             # losing legs cancelled mid-flight
    hedge_extra_words: int = 0           # words the cancelled legs scanned
    n_shed_to_t2: int = 0                # eligible queries demoted to Tier 2
    n_shed: int = 0                      # degraded immediate answers
    shed_frac: float = 0.0               # (n_shed + n_shed_to_t2) / queries
    n_cache_hits: int = 0                # result-cache hits (zero words)
    cache_hit_rate: float = 0.0
    # full latency distribution over LATENCY_BUCKETS_MS (an obs.Histogram
    # snapshot dict) — computed UNCONDITIONALLY, so the report is identical
    # whether or not the telemetry plane is on
    latency_hist: dict | None = None

    def line(self) -> str:
        extra = ""
        if self.n_hedges:
            extra += f"  hedges={self.n_hedges} ({self.n_hedge_wins} won)"
        if self.n_shed or self.n_shed_to_t2:
            extra += f"  shed={self.n_shed}+{self.n_shed_to_t2}->t2"
        if self.n_cache_hits:
            extra += f"  cache_hit={self.cache_hit_rate:.3f}"
        return (f"qps={self.throughput_qps:,.0f} (offered {self.offered_qps:,.0f})"
                f"  p50={self.p50_ms:.3f}ms p95={self.p95_ms:.3f}ms "
                f"p99={self.p99_ms:.3f}ms  t1={self.tier1_fraction:.3f}  "
                f"fleet_words={self.fleet_words:,}  "
                f"util={max(self.max_t1_util, self.max_t2_util):.2f}"
                f"{extra}")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["per_shard_t2_words"] = list(self.per_shard_t2_words)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LoadgenReport":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if "per_shard_t2_words" in kw:
            kw["per_shard_t2_words"] = tuple(kw["per_shard_t2_words"])
        return cls(**kw)


def run_loadgen(plan: ClusterPlan, eligible: np.ndarray, *,
                rate_qps: float = 20000.0, n_queries: int = 4000,
                seed: int = 0, t_fixed_us: float = 20.0,
                t_word_us: float = 4.0, straggler_p: float = 0.01,
                straggler_x: float = 8.0, rollout_at_s: float | None = None,
                swap_ms: float = 5.0, rollout_mode: str = "rolling",
                ingest_qps: float = 0.0,
                ingest_words: int = 64,
                hedge_ms: float | None = None,
                admission: AdmissionPolicy | None = None,
                cache_keys: np.ndarray | None = None,
                cache_capacity: int = 4096,
                cache_ttl_s: float | None = None) -> LoadgenReport:
    """Simulate `n_queries` open-loop arrivals; queries cycle through the
    `eligible` flags (a classified sample of real traffic)."""
    if rollout_mode not in ("rolling", "stw"):
        raise ValueError(f"rollout_mode must be 'rolling' or 'stw', "
                         f"got {rollout_mode!r}")
    rng = np.random.default_rng(seed)
    eligible = np.asarray(eligible, bool)
    if eligible.size == 0:
        eligible = np.zeros(1, bool)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_qps, size=n_queries))
    straggle = rng.random((n_queries, plan.n_shards)) < straggler_p
    # ingest arrivals draw AFTER the query stream, so ingest_qps=0 runs are
    # bit-identical to the pre-ingest generator
    ingest_times = np.empty(0)
    if ingest_qps > 0:
        n_ing = max(1, int(round(ingest_qps * float(arrivals[-1]))))
        ingest_times = np.cumsum(
            rng.exponential(1.0 / ingest_qps, size=n_ing))
    # front-end layers draw from SEPARATE seeded generators, and only when
    # enabled — defaults-off runs stay bit-identical to the pre-frontend
    # generator (the checked-in BENCH_cluster tiny baseline pins this)
    hedge_delay = hstraggle = None
    if hedge_ms is not None:
        hedge_delay = hedge_ms * 1e-3
        hrng = np.random.default_rng([seed, 0x6865646])
        hstraggle = hrng.random((n_queries, plan.n_shards)) < straggler_p
    qbound = dl = None
    if admission is not None:
        qbound = None if admission.queue_bound_ms is None \
            else admission.queue_bound_ms * 1e-3
        dl = None if admission.deadline_ms is None \
            else admission.deadline_ms * 1e-3
    admit = qbound is not None or dl is not None
    sim_cache: OrderedDict | None = None
    if cache_keys is not None:
        cache_keys = np.asarray(cache_keys, np.int64)
        if cache_keys.size == 0:
            raise ValueError("cache_keys must be non-empty when provided")
        if cache_capacity < 1:
            raise ValueError(f"cache_capacity must be >= 1, "
                             f"got {cache_capacity}")
        sim_cache = OrderedDict()

    # per-replica next-free times, flat-indexed [tier][shard][replica]
    free_t1 = [np.zeros(len(g)) for g in plan.t1_words]
    free_t2 = [np.zeros(len(g)) for g in plan.t2_words]
    busy_t1 = [np.zeros(len(g)) for g in plan.t1_words]
    busy_t2 = [np.zeros(len(g)) for g in plan.t2_words]
    backlog = [0.0, 0.0]         # worst queue wait seen at dispatch, per tier

    # replica-major rollout outage windows: (start, end) per t1 replica
    outages: dict[tuple[int, int], tuple[float, float]] = {}
    global_outage: tuple[float, float] | None = None
    if rollout_at_s is not None and rollout_mode == "stw":
        # stop-the-world: the SAME aggregate swap time (every replica of
        # both tiers), concentrated into one fleet-wide outage window
        n_reps = sum(len(g) for g in plan.t1_words) + \
            sum(len(g) for g in plan.t2_words)
        global_outage = (rollout_at_s,
                         rollout_at_s + swap_ms * 1e-3 * n_reps)
    elif rollout_at_s is not None:
        t = rollout_at_s
        n_reps = max((len(g) for g in plan.t1_words), default=0)
        for r in range(n_reps):
            for s in range(len(plan.t1_words)):
                if r < len(plan.t1_words[s]):
                    outages[(s, r)] = (t, t + swap_ms * 1e-3)
                    t += swap_ms * 1e-3

    def available(s: int, r: int, now: float) -> bool:
        lo_hi = outages.get((s, r))
        return lo_hi is None or not (lo_hi[0] <= now < lo_hi[1])

    latencies = np.empty(n_queries)
    fleet_words = 0
    n_t1 = 0
    fallbacks = 0
    per_shard_t2 = np.zeros(plan.n_shards, np.int64)
    n_ingest = 0
    ingest_total = 0
    stw_delayed = 0
    ing_ptr = 0
    n_hedges = n_hedge_wins = n_hedge_cancels = 0
    hedge_extra = 0.0
    n_shed = n_shed_to_t2 = 0
    n_cache_hits = 0
    last = plan.n_shards - 1       # grow-mode appends write the LAST shard

    def hedge_leg(free, busy, s, r1, start1, service1, words1, cand,
                  words_g, i, now):
        """Fire a backup on the least-loaded other replica of the group;
        first response wins, the LOSER is cancelled: its queue slot rolls
        back to the work it actually did and the words it scanned before
        cancellation are accounted as hedge waste, not shard traffic."""
        r2 = min(cand, key=lambda r: free[s][r])
        words2 = words_g[r2]
        service2 = (t_fixed_us + words2 * t_word_us) * 1e-6
        if hstraggle[i, s]:            # backup straggles independently
            service2 *= straggler_x
        start2 = max(now + hedge_delay, free[s][r2])
        c1, c2 = start1 + service1, start2 + service2
        win = min(c1, c2)
        for r, start, c in ((r1, start1, c1), (r2, start2, c2)):
            worked_to = min(c, win)    # the loser stops at the winner's done
            busy[s][r] += max(0.0, worked_to - start)
            free[s][r] = max(free[s][r], worked_to)
        backup_won = c2 < c1
        w_win, w_lose = (words2, words1) if backup_won else (words1, words2)
        st_l, sv_l, c_l = (start1, service1, c1) if backup_won \
            else (start2, service2, c2)
        frac = max(0.0, min(c_l, win) - st_l) / sv_l
        return win, backup_won, w_win, w_lose * frac

    def apply_ingest(until: float) -> None:
        """Queue every ingest write arriving before `until` on the last
        shard's Tier-2 replicas (all replicas apply every write)."""
        nonlocal ing_ptr, n_ingest, ingest_total
        while ing_ptr < len(ingest_times) and ingest_times[ing_ptr] <= until:
            it = float(ingest_times[ing_ptr])
            if global_outage and global_outage[0] <= it < global_outage[1]:
                it = global_outage[1]      # writes wait out the outage too
            service = (t_fixed_us + ingest_words * t_word_us) * 1e-6
            for r in range(len(plan.t2_words[last])):
                start = max(it, free_t2[last][r])
                free_t2[last][r] = start + service
                busy_t2[last][r] += service
            ingest_total += ingest_words * len(plan.t2_words[last])
            n_ingest += 1
            ing_ptr += 1

    for i in range(n_queries):
        t = arrivals[i]
        apply_ingest(t)
        if global_outage and global_outage[0] <= t < global_outage[1]:
            stw_delayed += 1
            t = global_outage[1]           # the fleet is down: wait it out
        if sim_cache is not None:
            # front-end result cache: a hit answers at the fixed cost with
            # ZERO postings words — no replica is ever contacted
            ck = int(cache_keys[i % cache_keys.size])
            ent = sim_cache.get(ck)
            if ent is not None and (cache_ttl_s is None
                                    or t - ent <= cache_ttl_s):
                sim_cache.move_to_end(ck)
                n_cache_hits += 1
                latencies[i] = (t - arrivals[i]) + t_fixed_us * 1e-6
                continue
            if ent is not None:            # TTL lapsed
                del sim_cache[ck]
        elig = bool(eligible[i % eligible.size])
        use_t1 = False
        if elig:
            # every shard with local D₁ needs an available replica
            picks = []
            for s, group in enumerate(plan.t1_words):
                words = [w for w in group]
                avail = [r for r in range(len(group))
                         if available(s, r, t) and words[r] > 0]
                if any(w > 0 for w in words) and not avail:
                    picks = None            # no Tier-1 cover: fall back
                    break
                if avail:
                    picks.append((s, min(avail, key=lambda r: free_t1[s][r])))
            if picks is not None:
                use_t1 = True
            else:
                fallbacks += 1
        if use_t1 and admit:
            # bounded per-shard queues: an over-bound (or deadline-hopeless)
            # eligible query demotes to the Tier-2-only scatter
            worst = pred = 0.0
            for s, r in picks:
                worst = max(worst, free_t1[s][r] - t)
                if dl is not None:
                    est = (t_fixed_us + plan.t1_words[s][r] * t_word_us) * 1e-6
                    pred = max(pred, max(t, free_t1[s][r]) + est)
            if (qbound is not None and worst > qbound) or \
                    (dl is not None and pred - t > dl):
                use_t1 = False
                n_shed_to_t2 += 1
        if use_t1:
            n_t1 += 1
            done = t
            for s, r in picks:
                words = plan.t1_words[s][r]
                service = (t_fixed_us + words * t_word_us) * 1e-6
                if straggle[i, s]:
                    service *= straggler_x
                start = max(t, free_t1[s][r])
                backlog[0] = max(backlog[0], start - t)
                comp = start + service
                cand = None
                if hedge_delay is not None and comp - t > hedge_delay:
                    group = plan.t1_words[s]
                    cand = [r2 for r2 in range(len(group))
                            if r2 != r and group[r2] > 0
                            and available(s, r2, t)]
                if cand:
                    comp, backup_won, w_win, w_extra = hedge_leg(
                        free_t1, busy_t1, s, r, start, service, words,
                        cand, plan.t1_words[s], i, t)
                    n_hedges += 1
                    n_hedge_wins += int(backup_won)
                    n_hedge_cancels += 1
                    hedge_extra += w_extra
                    fleet_words += w_win
                else:
                    free_t1[s][r] = comp
                    busy_t1[s][r] += service
                    fleet_words += words
                done = max(done, comp)
        else:
            t2_picks = [int(np.argmin(free_t2[s]))
                        for s in range(plan.n_shards)]
            if admit:
                # deadline-aware shedding: if even the Tier-2 scatter can't
                # make it, answer DEGRADED at the fixed cost (no scan)
                worst = pred = 0.0
                for s, r in enumerate(t2_picks):
                    worst = max(worst, free_t2[s][r] - t)
                    if dl is not None:
                        est = (t_fixed_us
                               + plan.t2_words[s][r] * t_word_us) * 1e-6
                        pred = max(pred, max(t, free_t2[s][r]) + est)
                if (qbound is not None and worst > qbound) or \
                        (dl is not None and pred - t > dl):
                    n_shed += 1
                    latencies[i] = (t - arrivals[i]) + t_fixed_us * 1e-6
                    continue               # degraded answers aren't cached
            done = t
            for s, group in enumerate(plan.t2_words):
                r = t2_picks[s]
                words = group[r]
                service = (t_fixed_us + words * t_word_us) * 1e-6
                if straggle[i, s]:
                    service *= straggler_x
                start = max(t, free_t2[s][r])
                backlog[1] = max(backlog[1], start - t)
                comp = start + service
                cand = None
                if hedge_delay is not None and comp - t > hedge_delay \
                        and len(group) > 1:
                    cand = [r2 for r2 in range(len(group)) if r2 != r]
                if cand:
                    comp, backup_won, w_win, w_extra = hedge_leg(
                        free_t2, busy_t2, s, r, start, service, words,
                        cand, group, i, t)
                    n_hedges += 1
                    n_hedge_wins += int(backup_won)
                    n_hedge_cancels += 1
                    hedge_extra += w_extra
                    fleet_words += w_win
                    per_shard_t2[s] += w_win
                else:
                    free_t2[s][r] = comp
                    busy_t2[s][r] += service
                    fleet_words += words
                    per_shard_t2[s] += words
                done = max(done, comp)
        latencies[i] = done - arrivals[i]  # from TRUE arrival (stw delays)
        if sim_cache is not None:          # full answers become cacheable
            sim_cache[ck] = t
            if len(sim_cache) > cache_capacity:
                sim_cache.popitem(last=False)

    apply_ingest(float("inf"))             # drain writes past the last read
    makespan = max(
        float(arrivals[-1] + latencies[-1]),
        max((float(f.max()) for f in free_t1 + free_t2 if f.size), default=0.0)
    ) - float(arrivals[0])
    lat_ms = latencies * 1e3
    # detached (always-on) histogram: the report's distribution never depends
    # on the REPRO_OBS switch; the registry copy is the gated fleet view
    hist = obs.Histogram("loadgen_latency_ms", always=True,
                         buckets=LATENCY_BUCKETS_MS)
    hist.observe_many(lat_ms)
    obs.histogram("loadgen_latency_ms", "end-to-end query latency",
                  buckets=LATENCY_BUCKETS_MS).observe_many(lat_ms)
    # registry-gated tail gauges for the SLO engine; the report percentiles
    # above stay the unconditional source of truth
    obs.gauge("loadgen_p95_ms", "last loadgen run's p95 latency").set(
        round(float(np.percentile(lat_ms, 95)), 6))
    obs.gauge("loadgen_p99_ms", "last loadgen run's p99 latency").set(
        round(float(np.percentile(lat_ms, 99)), 6))
    # front-end counters/gauges — inc(0) still creates the series, so the
    # telemetry check can require them from any loadgen-bearing run
    _HEDGES.inc(n_hedges)
    _SHEDS.inc(n_shed, kind="degraded")
    _SHEDS.inc(n_shed_to_t2, kind="to_t2")
    obs.gauge("loadgen_shed_frac",
              "last loadgen run's shed fraction (degraded + demoted)").set(
        round((n_shed + n_shed_to_t2) / n_queries, 6))
    if sim_cache is not None:
        obs.gauge("loadgen_cache_hit_rate",
                  "last loadgen run's result-cache hit rate").set(
            round(n_cache_hits / n_queries, 6))
    return LoadgenReport(
        n_queries=n_queries,
        offered_qps=rate_qps,
        throughput_qps=n_queries / max(makespan, 1e-12),
        p50_ms=float(np.percentile(lat_ms, 50)),
        p95_ms=float(np.percentile(lat_ms, 95)),
        p99_ms=float(np.percentile(lat_ms, 99)),
        mean_ms=float(lat_ms.mean()),
        max_ms=float(lat_ms.max()),
        tier1_fraction=n_t1 / n_queries,
        fleet_words=int(fleet_words),
        per_shard_t2_words=tuple(int(x) for x in per_shard_t2),
        t2_fallback_queries=fallbacks,
        max_t1_util=float(max((b.max() for b in busy_t1 if b.size),
                              default=0.0) / max(makespan, 1e-12)),
        max_t2_util=float(max((b.max() for b in busy_t2 if b.size),
                              default=0.0) / max(makespan, 1e-12)),
        max_t1_backlog_ms=float(backlog[0] * 1e3),
        max_t2_backlog_ms=float(backlog[1] * 1e3),
        n_ingest_events=n_ingest,
        ingest_words_total=int(ingest_total),
        stw_delayed_queries=stw_delayed,
        n_hedges=n_hedges,
        n_hedge_wins=n_hedge_wins,
        n_hedge_cancels=n_hedge_cancels,
        hedge_extra_words=int(round(hedge_extra)),
        n_shed_to_t2=n_shed_to_t2,
        n_shed=n_shed,
        shed_frac=(n_shed + n_shed_to_t2) / n_queries,
        n_cache_hits=n_cache_hits,
        cache_hit_rate=n_cache_hits / n_queries,
        latency_hist=hist.snapshot(),
    )


def fit_service_model(words: np.ndarray, us_per_query: np.ndarray) -> dict:
    """Least-squares fit of the service model `t = t_fixed + words * t_word`.

    `words`/`us_per_query` are paired measurements (e.g. `match_batch` wall
    time per query against sub-indexes of different packed widths). Returns
    {"t_fixed_us", "t_word_us", "r2", "n_points"} — the calibrated
    coefficients `run_loadgen` should be driven with, instead of its assumed
    defaults (ROADMAP "loadgen vs reality calibration").
    """
    w = np.asarray(words, np.float64)
    y = np.asarray(us_per_query, np.float64)
    if w.shape != y.shape or w.size < 2:
        raise ValueError("need >= 2 paired (words, us) measurements")
    a = np.stack([np.ones_like(w), w], axis=1)
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    pred = a @ coef
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    return {
        "t_fixed_us": float(coef[0]),
        "t_word_us": float(coef[1]),
        "r2": 1.0 - ss_res / max(ss_tot, 1e-30),
        "n_points": int(w.size),
    }


@dataclasses.dataclass(frozen=True)
class ReplicaSuggestion:
    """`suggest_replicas` output: the sizing plus the loadgen run proving it."""
    t1_replicas: int
    t2_replicas: int
    report: LoadgenReport        # loadgen at the suggested sizing
    iterations: int
    meets_slo: bool

    def line(self) -> str:
        return (f"t1_replicas={self.t1_replicas} t2_replicas="
                f"{self.t2_replicas}  p95={self.report.p95_ms:.3f}ms  "
                f"{'meets' if self.meets_slo else 'MISSES'} SLO "
                f"({self.iterations} loadgen runs)")


def suggest_replicas(plan: ClusterPlan, offered_load: float, slo_p95: float,
                     *, eligible: np.ndarray | None = None,
                     tier1_fraction: float = 0.5, n_queries: int = 3000,
                     seed: int = 0, max_replicas: int = 64,
                     target_util: float = 0.7,
                     **loadgen_kw) -> ReplicaSuggestion:
    """Close the autoscaling loop: size `t1_replicas`/`t2_replicas` so the
    fleet absorbs `offered_load` (qps) within the `slo_p95` (ms) tail.

    Seeds each tier's count analytically from the busiest replica's
    utilization at the current sizing (replicas needed ≈ current ×
    util / target_util), then walks upward, always growing the tier with the
    worse queue backlog, re-running the deterministic load generator until
    the p95 SLO holds or `max_replicas` is hit. `eligible` fixes the
    classified traffic mix (default: a `tier1_fraction` Bernoulli pattern).
    """
    if eligible is None:
        rng = np.random.default_rng(seed + 1)
        eligible = rng.random(256) < tier1_fraction
    t1_n, t2_n = max(plan.t1_replicas, 1), max(plan.t2_replicas, 1)

    def run(t1_n: int, t2_n: int) -> LoadgenReport:
        return run_loadgen(plan.resized(t1_n, t2_n), eligible,
                           rate_qps=offered_load, n_queries=n_queries,
                           seed=seed, **loadgen_kw)

    rep = run(t1_n, t2_n)
    iterations = 1
    # analytic jump from the utilization signal (no search below this point:
    # a replica group saturates once its busiest member exceeds target_util)
    t1_n = min(max_replicas,
               max(t1_n, int(np.ceil(t1_n * rep.max_t1_util / target_util))))
    t2_n = min(max_replicas,
               max(t2_n, int(np.ceil(t2_n * rep.max_t2_util / target_util))))
    rep = run(t1_n, t2_n)
    iterations += 1
    while rep.p95_ms > slo_p95 and max(t1_n, t2_n) < max_replicas:
        # grow the tier whose queueing is worse (backlog, then utilization)
        grow_t1 = (rep.max_t1_backlog_ms, rep.max_t1_util) >= \
                  (rep.max_t2_backlog_ms, rep.max_t2_util)
        if grow_t1 and t1_n < max_replicas:
            t1_n += 1
        elif t2_n < max_replicas:
            t2_n += 1
        else:
            t1_n += 1
        rep = run(t1_n, t2_n)
        iterations += 1
    return ReplicaSuggestion(t1_replicas=t1_n, t2_replicas=t2_n, report=rep,
                             iterations=iterations,
                             meets_slo=bool(rep.p95_ms <= slo_p95))
