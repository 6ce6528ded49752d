"""Cluster serving launcher: sharded scatter-gather fleet, end to end.

`python -m repro_torch.launch.cluster --shards 2 --replicas 2 --windows 2 --scale tiny`
builds the offline pipeline once, then:

  1. strong-scaling loadgen: for each shard count in `--sweep` (default: just
     `--shards`) deploys a fleet and drives the discrete-event load generator
     (open-loop Poisson arrivals, straggler tail), reporting throughput,
     p50/p95/p99 latency and fleet word traffic;
  2. drift A/B on IDENTICAL traffic windows: a static single-engine baseline
     vs the cluster under the drift-aware re-tiering controller, whose swaps
     roll replica-by-replica (`--verify` asserts Theorem-3.1 parity after
     every swap AND that no batch saw a mixed (ψ, Tier-1) pair).

Every knob that shapes traffic is in the header line, so any run is
reproducible from its log alone.

The port's counterpart of `repro.launch.cluster`, with the same flags and
`--device` (default: the CUDA card; `--device cpu` runs every kernel's
plain version). `--mesh` runs everything under a 4-entry shard mesh on
the run's device type (`distributed.shard_mesh(4, device_type=...)`: one
entry per card on four cards, four entries on `cuda:0` on one, four CPU
entries with `--device cpu`), as the reference's launcher forces 4 host
devices: partitioned solves compute owner-local gains and every fleet
batch is served fused; `--verify` then also checks that the fused path
served.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--mesh", action="store_true",
                    help="serve (and solve) under a 4-entry shard mesh on "
                         "the run's device type: the fused data plane")
    ap.add_argument("--replicas", type=int, default=2,
                    help="Tier-1 replicas per shard")
    ap.add_argument("--t2-replicas", type=int, default=1)
    ap.add_argument("--sweep", default="",
                    help="comma-separated shard counts for the strong-scaling"
                         " loadgen sweep (default: just --shards)")
    ap.add_argument("--scale", default="tiny",
                    choices=["tiny", "small", "medium"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline and the fleet")
    ap.add_argument("--scenario", default="rotate")
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--queries-per-window", type=int, default=256)
    ap.add_argument("--strength", type=float, default=1.0)
    ap.add_argument("--solver", default="greedy")
    ap.add_argument("--budget-frac", type=float, default=0.5)
    ap.add_argument("--budget-split", default="",
                    help="shard-aware budgets: 'traffic' (size per-shard "
                         "caps from observed traffic shares; refits "
                         "re-allocate) or comma caps like '60,40'; empty = "
                         "one global budget")
    ap.add_argument("--min-support", type=float, default=1e-3)
    ap.add_argument("--rate", type=float, default=20000.0,
                    help="loadgen offered load, queries/s")
    ap.add_argument("--requests", type=int, default=4000,
                    help="loadgen arrivals per configuration")
    ap.add_argument("--cache", action="store_true",
                    help="serve through the classify-keyed front-end result "
                         "cache (and give the loadgen its sim twin)")
    ap.add_argument("--cache-capacity", type=int, default=8192)
    ap.add_argument("--cache-ttl", type=float, default=None,
                    help="result-cache TTL in seconds (default: no TTL)")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="loadgen hedged dispatch: fire a backup subquery "
                         "after this many ms (default: no hedging)")
    ap.add_argument("--admission", default="",
                    help="loadgen overload admission QUEUE_MS[,DEADLINE_MS] "
                         "('-' skips a bound; empty disables)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the single-engine A/B run")
    ap.add_argument("--verify", action="store_true",
                    help="parity after every swap + mixed-pair check")
    ap.add_argument("--obs-dir", default="artifacts/obs",
                    help="telemetry snapshot directory ('' disables export; "
                         "REPRO_OBS=0 disables the whole plane)")
    args = ap.parse_args()

    from repro_torch import api, cluster, distributed, obs, stream

    stack = contextlib.ExitStack()
    if args.mesh:
        mesh = stack.enter_context(distributed.use_mesh(distributed.shard_mesh(
            4, device_type=torch.device(args.device).type)))
        print(f"[cluster] mesh: {mesh.size} entries on axis 'shard' "
              f"({', '.join(str(d) for d in mesh.devices)}) — fused serve "
              f"{'ON' if distributed.current_plan().shard_fused else 'inert'}")

    if args.obs_dir and obs.enabled():
        obs.set_exporter(obs.JsonlExporter(args.obs_dir, run="cluster"))
    if obs.enabled():
        obs.SLO.set_rules(obs.default_slo_rules())

    print(f"[cluster] scale={args.scale} seed={args.seed} "
          f"device={args.device} "
          f"scenario={args.scenario} windows={args.windows} "
          f"qpw={args.queries_per_window} strength={args.strength} "
          f"solver={args.solver} budget_frac={args.budget_frac} "
          f"budget_split={args.budget_split or '-'} "
          f"shards={args.shards} t1_replicas={args.replicas} "
          f"t2_replicas={args.t2_replicas} cache={'on' if args.cache else '-'} "
          f"hedge_ms={args.hedge_ms if args.hedge_ms is not None else '-'} "
          f"admission={args.admission or '-'}")
    admission = cluster.AdmissionPolicy.parse(args.admission) \
        if args.admission else None
    budget_split = None
    if args.budget_split == "traffic":
        budget_split = "traffic"
    elif args.budget_split:
        budget_split = [float(c) for c in args.budget_split.split(",")]
    t0 = time.time()
    pipe = (api.TieringPipeline.from_synthetic(seed=args.seed,
                                               scale=args.scale,
                                               device=args.device)
            .mine(min_support=args.min_support)
            .solve(args.solver, budget_frac=args.budget_frac,
                   budget_split=budget_split, n_shards=args.shards))
    print(f"[cluster] offline solve: {pipe.result.summary()}  "
          f"({time.time() - t0:.1f}s)")
    if budget_split is not None:
        caps = pipe.result.extra["caps"]
        fill = pipe.result.extra["g_part"]
        print(f"[cluster] per-shard budgets B_k={[int(c) for c in caps]}  "
              f"fill g_k={[int(g) for g in fill]}")

    # -- 1. strong-scaling loadgen sweep -------------------------------------
    sweep = [int(s) for s in args.sweep.split(",") if s] or [args.shards]
    sample = pipe.log.queries[:min(2048, pipe.log.n_queries)]
    # the loadgen cache twin keys arrivals by the sample's token sets, in
    # the same i % size cycle the eligibility flags use — after one cycle
    # every repeat is a front-end hit, like the real ResultCache
    cache_keys = cluster.keys_of(sample) if args.cache else None
    elig = None     # eligibility depends only on ψ, not on the topology
    for n_shards in sweep:
        fleet = pipe.deploy_cluster(n_shards=n_shards,
                                    t1_replicas=args.replicas,
                                    t2_replicas=args.t2_replicas)
        if elig is None:
            elig = fleet.classify(sample)
        plan = cluster.ClusterPlan.of_cluster(fleet)
        rep = cluster.run_loadgen(plan, elig, rate_qps=args.rate,
                                  n_queries=args.requests, seed=args.seed,
                                  hedge_ms=args.hedge_ms,
                                  admission=admission,
                                  cache_keys=cache_keys,
                                  cache_capacity=args.cache_capacity,
                                  cache_ttl_s=args.cache_ttl)
        per_shard = max(rep.per_shard_t2_words) if rep.per_shard_t2_words \
            else 0
        print(f"[cluster] loadgen shards={len(fleet.shards)} "
              f"{rep.line()}  max_shard_t2_words={per_shard:,}")

    # -- 2. drift A/B: static single engine vs re-tiered cluster -------------
    run_kw = dict(scenario=args.scenario, n_windows=args.windows,
                  queries_per_window=args.queries_per_window, seed=args.seed,
                  strength=args.strength)
    static = None
    if not args.no_baseline:
        static = stream.run_stream(pipe, enable_refit=False, **run_kw)
        print(f"[cluster] single-engine static   {static.summary()}")

    fleet = pipe.deploy_cluster(
        n_shards=args.shards, t1_replicas=args.replicas,
        t2_replicas=args.t2_replicas,
        cache=cluster.ResultCache(capacity=args.cache_capacity,
                                  ttl_s=args.cache_ttl)
        if args.cache else None)
    report = stream.run_stream(pipe, engine=fleet,
                               verify_swaps=args.verify, **run_kw)
    for w in report.windows:
        print(f"[cluster] {w.line()}")
    print(f"[cluster] retiered cluster {report.summary()}  "
          f"[{fleet.describe()}]")

    if args.verify:
        if not fleet.consistency_ok():
            raise SystemExit("[cluster] CONSISTENCY FAILURE: a batch saw a "
                             "mixed (ψ, Tier-1) generation pair")
        if not report.parity_all_ok():
            raise SystemExit("[cluster] PARITY FAILURE: sharded serving "
                             "diverged from single-tier matching")
        if args.mesh and not fleet.router._mesh_tables:
            raise SystemExit("[cluster] MESH FAILURE: no batch was served "
                             "through the fused path")
        # never verify vacuously: if no refit triggered (so no swap parity
        # check ran), probe scatter-gather exactness directly
        direct_checks = 0
        if report.n_parity_checks == 0:
            import numpy as np
            probe = pipe.log.queries[:256]
            for a, b in zip(fleet.serve(probe), fleet.serve_reference(probe)):
                if not np.array_equal(a, b):
                    raise SystemExit("[cluster] PARITY FAILURE: sharded "
                                     "serving diverged from single-tier "
                                     "matching on the direct probe")
            direct_checks = len(probe)
        cache_checks = 0
        if args.cache:
            # the second pass serves FROM the cache; its answers must stay
            # bit-identical to the single-tier oracle (exactness of a hit)
            import numpy as np
            probe = pipe.log.queries[:128]
            fleet.serve(probe)                     # populate
            hits0 = fleet.cache.stats.hits
            for a, b in zip(fleet.serve(probe), fleet.serve_reference(probe)):
                if not np.array_equal(a, b):
                    raise SystemExit("[cluster] CACHE PARITY FAILURE: a "
                                     "cached answer diverged from "
                                     "single-tier matching")
            if fleet.cache.stats.hits <= hits0:
                raise SystemExit("[cluster] CACHE FAILURE: repeat traffic "
                                 "produced no front-end hits")
            cache_checks = len(probe)
        if budget_split is not None:
            # per-shard Tier-1 doc counts must respect every cap B_k
            caps = pipe.result.extra["caps"]
            t1 = pipe.tiering().tier1_docs
            for s, cap in zip(fleet.shards, caps):
                local = int(t1[s.doc_lo:s.doc_lo + s.n_docs].sum())
                if local > cap:
                    raise SystemExit(
                        f"[cluster] BUDGET FAILURE: shard {s.index} holds "
                        f"{local} Tier-1 docs > cap {cap:.0f}")
        print(f"[cluster] verified: {report.n_parity_checks} swap parity "
              f"checks + {direct_checks} direct probes ok, "
              f"{len(fleet.trace)} batches pair-consistent"
              + (f", {cache_checks} cached answers oracle-exact"
                 if cache_checks else "")
              + (", per-shard caps respected" if budget_split is not None
                 else "")
              + (", served fused on the mesh" if args.mesh else ""))
    if args.cache:
        c = fleet.cache.snapshot()
        print(f"[cluster] frontend cache: {c['hits']}/{c['lookups']} hits "
              f"(rate {c['hit_rate']:.3f}), {c['invalidations']} epoch "
              f"invalidations, size {c['size']}/{c['capacity']}")
    if static is not None:
        delta = report.mean_coverage - static.mean_coverage
        print(f"[cluster] mean windowed tier-1 coverage: "
              f"single-static={static.mean_coverage:.3f} "
              f"cluster-retiered={report.mean_coverage:.3f} ({delta:+.3f})")
    if obs.enabled():
        print(f"[cluster] {obs.dashboard()}")
        ex = obs.get_exporter()
        if ex is not None and ex.n_written:
            print(f"[cluster] obs: {ex.n_written} snapshots -> {ex.path}")
    stack.close()


if __name__ == "__main__":
    main()
