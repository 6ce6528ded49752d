"""Streaming re-tiering launcher: replay a drift scenario end to end.

`python -m repro_torch.launch.stream --scenario burst --windows 3 --scale tiny`
builds the offline pipeline (mine -> solve -> deploy), then replays the
chosen nonstationary traffic scenario twice on IDENTICAL windows — once
with the tiering frozen (static baseline), once under the drift-aware
re-tiering controller (warm-started refits + atomic hot swaps) — and
prints per-window coverage/cost plus the A/B comparison.

The port's counterpart of `repro.launch.stream`, with the same flags and
`--device` (default: the CUDA card; `--device cpu` runs every kernel's
plain version).
"""
from __future__ import annotations

import argparse
import time


def main() -> None:
    from repro_torch import stream

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="rotate",
                    choices=stream.list_scenarios())
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--queries-per-window", type=int, default=512)
    ap.add_argument("--scale", default="tiny",
                    choices=["tiny", "small", "medium"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline and the engine")
    ap.add_argument("--strength", type=float, default=1.0,
                    help="drift intensity (scenario-specific)")
    ap.add_argument("--solver", default="greedy")
    ap.add_argument("--budget-frac", type=float, default=0.5)
    ap.add_argument("--min-support", type=float, default=1e-3)
    ap.add_argument("--cold", action="store_true",
                    help="disable warm starts (every refit solves cold)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the static-tiering A/B run")
    ap.add_argument("--verify", action="store_true",
                    help="Theorem-3.1 parity spot check after every swap")
    ap.add_argument("--obs-dir", default="artifacts/obs",
                    help="telemetry snapshot directory ('' disables export; "
                         "REPRO_OBS=0 disables the whole plane)")
    args = ap.parse_args()

    from repro_torch import api, obs

    if args.obs_dir and obs.enabled():
        obs.set_exporter(obs.JsonlExporter(args.obs_dir, run="stream"))
    if obs.enabled():
        obs.SLO.set_rules(obs.default_slo_rules())

    def offline_pipe():
        return (api.TieringPipeline.from_synthetic(seed=args.seed,
                                                   scale=args.scale,
                                                   device=args.device)
                .mine(min_support=args.min_support)
                .solve(args.solver, budget_frac=args.budget_frac))

    # every knob that shapes the traffic and the solve, in one header line,
    # so an A/B run is reproducible from the log alone
    print(f"[stream] scenario={args.scenario} windows={args.windows} "
          f"qpw={args.queries_per_window} scale={args.scale} "
          f"seed={args.seed} strength={args.strength} device={args.device} "
          f"solver={args.solver} budget_frac={args.budget_frac} "
          f"min_support={args.min_support} warm={not args.cold}")
    t0 = time.time()
    pipe = offline_pipe()
    print(f"[stream] offline solve: {pipe.result.summary()}  "
          f"({time.time() - t0:.1f}s)")

    # the simulator consumes the SAME --seed (window sampling) as the
    # offline dataset build above, so one flag pins the whole replay
    run_kw = dict(scenario=args.scenario, n_windows=args.windows,
                  queries_per_window=args.queries_per_window, seed=args.seed,
                  strength=args.strength)

    static = None
    if not args.no_baseline:
        # static baseline first: enable_refit=False never mutates the pipe,
        # so the re-tiering run below starts from the same offline solve
        static = stream.run_stream(pipe, enable_refit=False, **run_kw)
        print(f"[stream] static   {static.summary()}")

    report = stream.run_stream(pipe, warm=not args.cold,
                               verify_swaps=args.verify, **run_kw)
    for w in report.windows:
        print(f"[stream] {w.line()}")
    print(f"[stream] retiered {report.summary()}")

    if args.verify:
        if not report.parity_all_ok():
            raise SystemExit("[stream] PARITY FAILURE: a swapped tiering "
                             "broke Theorem 3.1 completeness")
        if report.n_parity_checks == 0:
            print("[stream] note: no refit/swap occurred, so no parity "
                  "checks ran (nothing to verify)")
        else:
            print(f"[stream] parity verified after "
                  f"{report.n_parity_checks} swaps")
    if static is not None:
        delta = report.mean_coverage - static.mean_coverage
        print(f"[stream] mean windowed tier-1 coverage: "
              f"static={static.mean_coverage:.3f} "
              f"retiered={report.mean_coverage:.3f} ({delta:+.3f})")
    if obs.enabled():
        print(f"[stream] {obs.dashboard()}")
        ex = obs.get_exporter()
        if ex is not None and ex.n_written:
            print(f"[stream] obs: {ex.n_written} snapshots -> {ex.path}")


if __name__ == "__main__":
    main()
