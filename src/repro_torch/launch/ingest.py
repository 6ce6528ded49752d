"""Live-ingest launcher: streaming admission + rolling corpus rebuilds.

`python -m repro_torch.launch.ingest --scale tiny --windows 2 --verify`
builds the offline pipeline once, deploys a sharded fleet, then drives the
serve → ingest → refit loop (`repro.ingest.IngestController`):

  1. every window appends a seeded, drift-correlated batch of new documents
     to the live corpus (word-aligned block append — existing postings words
     never move);
  2. docs matched by selected clauses enter Tier 1 MANDATORILY
     (Theorem 3.1); clauses the new block activates are offered one-pass to
     the secretary-style admission policy under live per-shard caps;
  3. the fleet rolls to the new corpus version replica-by-replica
     (`--rollout stw` jumps stop-the-world instead — the comparison arm);
  4. drift triggers warm refits against the grown problem, exactly as the
     static-corpus loop.

`--verify` checks, per window, that served match sets equal the single-tier
oracle AT THE CORPUS VERSION SERVED (mid-rollout batches legitimately serve
the previous version) and, at the end, that no batch ever observed a mixed
(ψ, Tier-1, Tier-2) triple. Failures are named `SystemExit`s, so CI smoke
runs fail loudly.

The port's counterpart of `repro.launch.ingest`, with the same flags and
`--device` (default: the CUDA card; `--device cpu` runs every kernel's
plain version).
"""
from __future__ import annotations

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
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
    ap.add_argument("--min-support", type=float, default=1e-3)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=2,
                    help="Tier-1 replicas per shard")
    ap.add_argument("--t2-replicas", type=int, default=2,
                    help="Tier-2 replicas per shard (2+ keeps rolling corpus "
                         "swaps gap-free)")
    ap.add_argument("--arrivals", type=float, default=32.0,
                    help="mean new documents per window (Poisson)")
    ap.add_argument("--correlation", type=float, default=0.6,
                    help="P[an arriving doc is seeded from live traffic]")
    ap.add_argument("--rollout", default="rolling",
                    choices=["rolling", "stw"])
    ap.add_argument("--budget-policy", default="track_corpus",
                    choices=["track_corpus", "fixed"])
    ap.add_argument("--no-admission", action="store_true",
                    help="mandatory Theorem-3.1 growth only (A/B baseline)")
    ap.add_argument("--single-engine", action="store_true",
                    help="drive one TieredEngine instead of a fleet "
                         "(corpus swaps are then stop-the-world by nature)")
    ap.add_argument("--verify", action="store_true",
                    help="per-window versioned parity + mixed-triple check")
    ap.add_argument("--obs-dir", default="artifacts/obs",
                    help="telemetry snapshot directory ('' disables export; "
                         "REPRO_OBS=0 disables the whole plane)")
    args = ap.parse_args()

    from repro_torch import api, ingest, obs

    if args.obs_dir and obs.enabled():
        obs.set_exporter(obs.JsonlExporter(args.obs_dir, run="ingest"))
    if obs.enabled():
        obs.SLO.set_rules(obs.default_slo_rules())

    print(f"[ingest] scale={args.scale} seed={args.seed} "
          f"scenario={args.scenario} windows={args.windows} "
          f"qpw={args.queries_per_window} arrivals={args.arrivals} "
          f"correlation={args.correlation} rollout={args.rollout} "
          f"budget_policy={args.budget_policy} "
          f"admission={'off' if args.no_admission else 'on'} "
          f"shards={args.shards} t1_replicas={args.replicas} "
          f"t2_replicas={args.t2_replicas} device={args.device}")
    t0 = time.time()
    pipe = (api.TieringPipeline.from_synthetic(seed=args.seed,
                                               scale=args.scale,
                                               device=args.device)
            .mine(min_support=args.min_support)
            .solve(args.solver, budget_frac=args.budget_frac,
                   budget_split="traffic", n_shards=args.shards))
    print(f"[ingest] offline solve: {pipe.result.summary()}  "
          f"({time.time() - t0:.1f}s)")

    engine = None
    if not args.single_engine:
        engine = pipe.deploy_cluster(n_shards=args.shards,
                                     t1_replicas=args.replicas,
                                     t2_replicas=args.t2_replicas)
        print(f"[ingest] fleet: {engine.describe()}")

    report = ingest.run_ingest(
        pipe, scenario=args.scenario, n_windows=args.windows,
        queries_per_window=args.queries_per_window, seed=args.seed,
        strength=args.strength, arrivals_per_window=args.arrivals,
        correlation=args.correlation, admission=not args.no_admission,
        engine=engine, rollout=args.rollout,
        budget_policy=args.budget_policy, verify=args.verify)
    for w in report.windows:
        print(f"[ingest] {w.line()}")
    print(f"[ingest] {report.summary()}  admission: "
          f"{report.admission_summary}")

    if args.verify:
        failed = report.failed_windows()
        if failed:
            raise SystemExit(f"[ingest] PARITY FAILURE: {failed} window(s) "
                             "diverged from the versioned single-tier oracle")
        if engine is not None and not engine.consistency_ok():
            raise SystemExit("[ingest] CONSISTENCY FAILURE: a batch saw a "
                             "mixed (ψ, Tier-1, Tier-2) triple")
        checks = sum(1 for w in report.windows if w.ingest_ok is not None)
        if checks == 0:
            raise SystemExit("[ingest] VERIFY FAILURE: no parity check ran")
        n_batches = len(engine.trace) if engine is not None else 0
        print(f"[ingest] verified: {checks} versioned parity checks ok"
              + (f", {n_batches} batches triple-consistent" if engine
                 is not None else ""))
    if obs.enabled():
        print(f"[ingest] {obs.dashboard()}")
        ex = obs.get_exporter()
        if ex is not None and ex.n_written:
            print(f"[ingest] obs: {ex.n_written} snapshots -> {ex.path}")


if __name__ == "__main__":
    main()
