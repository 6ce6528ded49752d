"""repro_torch.cluster — sharded, replicated two-tier serving (paper §2.2, Fig. 1).

The port's counterpart of `repro.cluster`, host path only (no mesh
serving and no corpus swaps yet), with the same names.

The paper's economics are fleet economics: a small Tier 1 matters because a
FLEET of small replicas absorbs eligible traffic that would otherwise need
full-index machines. This package models that fleet end to end:

  * `shard_postings` / `DocShard` — word-aligned doc-sharding of the packed
    postings; per-shard Tier-1 sub-indexes via `shard_tier_postings`;
  * `ShardReplica` / `ClusterRouter` — replica groups per (tier, shard) and
    the batch router: one batched ψ^clause kernel call
    (`kernels.ops.clause_match`), scatter to Tier-1/Tier-2 replicas,
    OR-merge of packed per-shard match bitsets — bit-identical to
    single-tier matching (Theorem 3.1 per shard);
  * `RollingSwap` / `ClusterTieringBuffer` — zero-downtime re-tiering with
    PER-SHARD generations: each buffer carries per-shard CONTENT ids, so
    shards a re-tiering didn't touch carry their replicas across
    generations metadata-only (no drain, no install) while changed shards
    drain and swap one replica at a time; no batch ever observes a mixed
    (ψ, Tier-1) content pair per shard (`BatchTrace` proves it);
  * `ClusterPlan` / `run_loadgen` — deterministic discrete-event load
    generator: open-loop Poisson arrivals, words-scanned service model
    (calibrate it with `fit_service_model` against measured `match_batch`
    walls), straggler tail, per-replica FIFO queueing; reports throughput,
    p50/p95/p99 latency, fleet word traffic and per-replica
    utilization/backlog — which `suggest_replicas(plan, offered_load,
    slo_p95)` closes into an autoscaling loop;
  * `TieredCluster` — engine-compatible facade, so
    `stream.RetieringController` re-tiers a whole cluster through rolling
    swaps exactly as it hot-swaps one engine.

Quickstart:

    from repro_torch import api, cluster

    pipe = (api.TieringPipeline.from_synthetic(seed=0, scale="tiny",
                                               device="cpu")
            .mine(min_support=1e-3).solve("greedy", budget_frac=0.5))
    fleet = pipe.deploy_cluster(n_shards=4, t1_replicas=2)
    results = fleet.serve(pipe.log.queries[:64])      # exact match sets
    rep = cluster.run_loadgen(cluster.ClusterPlan.of_cluster(fleet),
                              fleet.classify(pipe.log.queries[:512]))
    print(rep.line())

CLI: `python -m repro_torch.launch.cluster --shards 2 --replicas 2 --windows 2`
(`--device cpu` off the card)
"""
from repro_torch.cluster.frontend import (                   # noqa: F401
    AdmissionPolicy, CacheStats, ResultCache, keys_of, zipf_keys)
from repro_torch.cluster.loadgen import (                    # noqa: F401
    ClusterPlan, LoadgenReport, ReplicaSuggestion, fit_service_model,
    run_loadgen, suggest_replicas)
from repro_torch.cluster.rollout import (                    # noqa: F401
    ClusterTieringBuffer, RollingSwap, StaleCorpusError)
from repro_torch.cluster.router import (                     # noqa: F401
    BatchTrace, ClusterRouter, ShardReplica, TieredCluster)
from repro_torch.cluster.shard import (                      # noqa: F401
    DocShard, plan_shards, shard_postings,
    shard_tier_postings)

__all__ = [
    "AdmissionPolicy", "BatchTrace", "CacheStats", "ClusterPlan",
    "ClusterRouter", "ClusterTieringBuffer", "DocShard", "LoadgenReport",
    "ReplicaSuggestion", "ResultCache", "RollingSwap",
    "ShardReplica", "StaleCorpusError", "TieredCluster",
    "fit_service_model", "keys_of", "plan_shards",
    "run_loadgen", "shard_postings", "shard_tier_postings",
    "suggest_replicas", "zipf_keys",
]
