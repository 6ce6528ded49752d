"""repro_torch.stream — online re-tiering: the tiering lifecycle over live traffic.

The port's counterpart of `repro.stream`, with the same names.

The offline pipeline (`repro_torch.api.TieringPipeline`) solves once against a
static log; this package closes the loop for nonstationary traffic:

  * `TrafficSimulator` / `SCENARIOS` — seeded drift scenarios (topic
    rotation, bursts, vocabulary churn, seasonal interpolation) yielding
    query batches per window;
  * `LogAccumulator` — exponentially-decayed empirical query weights, the
    online counterpart of the offline log;
  * `DriftDetector` — windowed coverage-regression + total-variation
    triggers deciding when to re-tier;
  * `prune_state` — drops stale clauses from a `SolverState` so warm
    restarts only pay for the drift delta;
  * `RetieringController` / `run_stream` — the serve → accumulate → detect
    → refit (`TieringPipeline.refit`, warm-started, cold fallback) →
    `TieredEngine.swap_tiering` control loop, Theorem-3.1-exact on every
    window.

Quickstart:

    from repro_torch import api, stream

    pipe = (api.TieringPipeline.from_synthetic(seed=0, scale="tiny",
                                               device="cpu")
            .mine(min_support=1e-3).solve("greedy", budget_frac=0.5))
    report = stream.run_stream(pipe, scenario="rotate", n_windows=8)
    print(report.summary())

CLI: `python -m repro_torch.launch.stream --scenario burst --windows 3 --scale tiny`
(`--device cpu` off the card)
"""
from repro_torch.stream.controller import (                       # noqa: F401
    RetieringController, StreamReport, WindowReport, run_stream)
from repro_torch.stream.detector import (                         # noqa: F401
    DriftDetector, DriftSignal, tv_distance)
from repro_torch.stream.drift import (                            # noqa: F401
    SCENARIOS, TrafficSimulator, TrafficWindow, list_scenarios)
from repro_torch.stream.window import (                            # noqa: F401
    LogAccumulator, check_state_width, prune_partitions, prune_state,
    rebuild_state)

__all__ = [
    "DriftDetector", "DriftSignal", "LogAccumulator", "RetieringController",
    "SCENARIOS", "StreamReport", "TrafficSimulator", "TrafficWindow",
    "WindowReport", "check_state_width", "list_scenarios",
    "prune_partitions", "prune_state", "rebuild_state", "run_stream",
    "tv_distance",
]
