"""repro_torch.api — the solver surface of the port.

  * `SolverState`, `SolveConfig`, `solve`, `solve_sweep`, `register_solver`,
    `Trace` — as in `repro.api`, for the ported solvers (greedy, optpes).
  * `TieringPipeline` — data -> mine -> solve -> tiering -> deploy.

Quickstart:

    from repro_torch import api

    pipe = (api.TieringPipeline.from_synthetic(seed=0, scale="tiny")
            .mine(min_support=1e-3)
            .solve("optpes", budget_frac=0.5))
    assert pipe.verify()                  # Theorem 3.1
    engine = pipe.deploy()                # serve.TieredEngine
"""
from repro_torch.core.config import SolveConfig                      # noqa: F401
from repro_torch.core.constraint import GlobalBudget                 # noqa: F401
from repro_torch.core.problem import SCSKProblem, SolverResult       # noqa: F401
from repro_torch.core.registry import (                              # noqa: F401
    SolverSpec, get_solver, list_solvers, register_solver, solve, solve_sweep)
from repro_torch.core.state import SolverState                       # noqa: F401
from repro_torch.core.trace import Trace                             # noqa: F401

# importing the core package registers the solvers
import repro_torch.core  # noqa: F401,E402
from repro_torch.api.pipeline import TieringPipeline  # noqa: F401,E402

__all__ = [
    "GlobalBudget", "SCSKProblem", "SolveConfig",
    "SolverResult", "SolverSpec", "SolverState", "TieringPipeline", "Trace",
    "get_solver", "list_solvers", "register_solver", "solve", "solve_sweep",
]
