"""Serving launcher: two-tier engine demo over a synthetic corpus.

`python -m repro_torch.launch.serve --scale medium --budget-frac 0.5 --requests 2000`
builds the full offline pipeline (mine -> solve -> materialize Tier 1) on the
chosen device and then serves batched requests, reporting coverage and
word-traffic savings. `--device cpu` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="tiny",
                    choices=["tiny", "small", "medium"])
    ap.add_argument("--budget-frac", type=float, default=0.5)
    ap.add_argument("--min-support", type=float, default=1e-3)
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--solver", default="optpes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch import api

    t0 = time.time()
    pipe = (api.TieringPipeline.from_synthetic(seed=0, scale=args.scale,
                                               device=args.device)
            .mine(min_support=args.min_support)
            .solve(args.solver, budget_frac=args.budget_frac))
    log = pipe.log
    print(f"[serve] offline solve on {pipe.device}: {pipe.result.summary()}  "
          f"({time.time() - t0:.1f}s)")

    engine = pipe.deploy()
    rng = np.random.default_rng(1)
    # request stream drawn from the *test* distribution (future traffic)
    probs = log.test_weights / log.test_weights.sum()
    served = 0
    t1 = time.time()
    while served < args.requests:
        n = min(args.batch, args.requests - served)
        idx = rng.choice(log.n_queries, size=n, p=probs)
        engine.serve([log.queries[i] for i in idx])
        served += n
    dt = time.time() - t1
    s = engine.stats
    print(f"[serve] {served} requests in {dt:.1f}s "
          f"({1e3 * dt / served:.2f} ms/req host-side)")
    print(f"[serve] tier-1 coverage: {s.tier1_fraction:.3f}  "
          f"word-traffic saving vs untiered: {s.cost_saving:.3f}")


if __name__ == "__main__":
    main()
