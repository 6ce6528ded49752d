"""repro_torch.api — the solver surface of the port.

  * `SolverState`, `SolveConfig`, `solve`, `solve_sweep`, `register_solver`,
    `Trace` — as in `repro.api`, for every solver of the reference: greedy,
    lazy, optpes, isk1, isk2, agnostic, stochastic, and the flow baselines
    (flow-popularity, flow-max, flow-sgd; `needs_data=True`).
  * `GlobalBudget`, `KnapsackConstraint`, `PartitionedBudget`,
    `partition_bounds`, `partition_capacities`, `trim_state`,
    `partition_budgets`, `shard_traffic_shares` — per-shard budgets.
  * `TieringPipeline` — data -> mine -> solve -> tiering -> deploy, with
    shard-aware `solve(budget_split=..., n_shards=...)`, `sweep` and
    `refit`.
  * `ExecutionPlan`, `current_plan`, `shard_mesh`, `use_mesh` — the shard
    mesh: under `use_mesh(shard_mesh(n))` partitioned solves compute each
    partition's gains on the entry that owns it and deployed fleets serve
    each batch as one fused program.

Quickstart:

    from repro_torch import api

    pipe = (api.TieringPipeline.from_synthetic(seed=0, scale="tiny")
            .mine(min_support=1e-3)
            .solve("optpes", budget_frac=0.5))
    assert pipe.verify()                  # Theorem 3.1
    engine = pipe.deploy()                # serve.TieredEngine
"""
from repro_torch.core.config import SolveConfig                      # noqa: F401
from repro_torch.core.constraint import (                            # noqa: F401
    GlobalBudget, KnapsackConstraint, PartitionedBudget, partition_bounds,
    partition_capacities, trim_state)
from repro_torch.core.problem import SCSKProblem, SolverResult       # noqa: F401
from repro_torch.core.registry import (                              # noqa: F401
    SolverSpec, get_solver, list_solvers, register_solver, solve, solve_sweep)
from repro_torch.core.state import SolverState                       # noqa: F401
from repro_torch.core.trace import Trace                             # noqa: F401

# importing these populates the registry
import repro_torch.core  # noqa: F401,E402  (SCSK solvers self-register)
from repro_torch.api import flow_adapter  # noqa: F401,E402  (flow baselines)
from repro_torch.api.partition import (  # noqa: F401,E402
    partition_budgets, shard_traffic_shares)
from repro_torch.api.pipeline import TieringPipeline  # noqa: F401,E402
from repro_torch.distributed import (  # noqa: F401,E402
    ExecutionPlan, current_plan, shard_mesh, use_mesh)

__all__ = [
    "ExecutionPlan", "GlobalBudget", "KnapsackConstraint", "PartitionedBudget", "SCSKProblem",
    "SolveConfig", "SolverResult", "SolverSpec", "SolverState",
    "TieringPipeline", "Trace", "current_plan", "get_solver", "list_solvers",
    "partition_bounds", "partition_budgets", "partition_capacities",
    "register_solver", "shard_mesh", "shard_traffic_shares", "solve",
    "solve_sweep", "trim_state", "use_mesh",
]
