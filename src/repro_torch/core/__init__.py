"""SCSK core: problem oracles, solver state, and the ported solvers.

The canonical way to run a solver is the `repro_torch.api` layer, or one
level lower, the uniform registry entrypoint:

    cfg = SolveConfig(budget=100.0, solver="greedy")
    result = solve(problem, cfg)                # -> SolverResult
    more = solve(problem, cfg.replace(budget=200.0), state=result.state)

The port has greedy (eq. 13) and Opt/Pes (Alg. 2); both self-register
with `@register_solver(name)`, share `SolverState` and `Trace`, and take
per-shard budgets (`PartitionedBudget`). `sparse_greedy_step` is the
greedy round over -1-padded doc-id lists (production |D|).
"""
from repro_torch.core.config import SolveConfig                      # noqa: F401
from repro_torch.core.constraint import (                            # noqa: F401
    GlobalBudget, KnapsackConstraint, PartitionedBudget, partition_bounds,
    partition_capacities, trim_state)
from repro_torch.core.greedy import greedy_step, solve_greedy        # noqa: F401
from repro_torch.core.optpes import optpes_round, solve_optpes       # noqa: F401
from repro_torch.core.problem import SCSKProblem, SolverResult       # noqa: F401
from repro_torch.core.registry import (                              # noqa: F401
    get_solver, list_solvers, register_solver, solve, solve_sweep)
from repro_torch.core.sparse_step import sparse_greedy_step          # noqa: F401
from repro_torch.core.state import SolverState                       # noqa: F401
from repro_torch.core.tiering import ClauseTiering                   # noqa: F401
from repro_torch.core.trace import Trace                             # noqa: F401
