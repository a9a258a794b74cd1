"""repro_torch.core — the EES solve stack of the port (fixed grids).

  tableaux   — Butcher tableaux (Euler ... RK4, EES(2,5;x), EES(2,7))
  williamson — Williamson 2N coefficients + Bazavov conditions (numpy)
  prng       — threefry2x32 keys and draws, bit-exact to jax.random's
  pytree     — pytrees of tensors and their leafwise linear algebra
  brownian   — counter-based fixed-grid Brownian drivers
  grid       — the time grid (uniform / padded uniform)
  solvers    — SDETerm; 2N, Butcher, Reversible Heun, MCF, Milstein, SRA1
  adjoint    — solve(): the one solve loop (full and reversible adjoints)
  registry   — string-keyed solver registry ("ees25", "milstein", ...) and
               select_solver ("auto" specs)
  stability  — linear and mean-square stability of RK tableaux (numpy)
  sdeint     — batched Monte-Carlo integration and multi-tick dispatch
"""
from .adjoint import SolveResult, solve
from .brownian import BrownianPath, PaddedBrownianPath, brownian_path, padded_brownian_path
from .grid import TimeGrid
from .prng import PRNGKey, fold_in, normal, split
from .registry import (canonical_spec, get_solver, list_solvers, parse_solver_spec, register_solver,
                       select_solver, solver_kind)
from .sdeint import path_keys, sdeint, sdeint_ticks
from .solvers import (VALID_NOISE, ButcherSolver, LowStorageSolver, MCFSolver, Milstein,
                      ReversibleHeun, SDETerm, SRKAdditive, ees25_solver, ees27_solver)
from .tableaux import ees25, ees25_tableau, ees27_tableau, euler, heun, midpoint, rk3, rk4
from .williamson import EES25_2N, EES27_2N, bazavov_residuals, butcher_from_2n, ees25_2n

__all__ = [
    "solve",
    "SolveResult",
    "path_keys",
    "sdeint",
    "sdeint_ticks",
    "PRNGKey",
    "fold_in",
    "split",
    "normal",
    "get_solver",
    "list_solvers",
    "parse_solver_spec",
    "register_solver",
    "canonical_spec",
    "solver_kind",
    "select_solver",
    "BrownianPath",
    "brownian_path",
    "PaddedBrownianPath",
    "padded_brownian_path",
    "TimeGrid",
    "SDETerm",
    "VALID_NOISE",
    "LowStorageSolver",
    "ButcherSolver",
    "ReversibleHeun",
    "MCFSolver",
    "Milstein",
    "SRKAdditive",
    "ees25_solver",
    "ees27_solver",
    "ees25",
    "ees25_tableau",
    "ees27_tableau",
    "euler",
    "heun",
    "midpoint",
    "rk3",
    "rk4",
    "EES25_2N",
    "EES27_2N",
    "ees25_2n",
    "bazavov_residuals",
    "butcher_from_2n",
]
