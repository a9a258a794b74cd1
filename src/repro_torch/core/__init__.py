"""repro_torch.core — the EES solve stack of the port.

  tableaux   — Butcher tableaux (Euler ... RK4, EES(2,5;x), EES(2,7))
  williamson — Williamson 2N coefficients + Bazavov conditions (numpy)
  prng       — threefry2x32 keys and draws, bit-exact to jax.random's
  pytree     — pytrees of tensors and their leafwise linear algebra
  brownian   — counter-based Brownian drivers: fixed-grid paths and the
               Virtual Brownian Tree
  grid       — the time grid (uniform / padded uniform / realized) and the
               dense-output helpers
  solvers    — SDETerm; 2N, Butcher, Reversible Heun, MCF, Milstein, SRA1
  lie        — Lie groups and homogeneous spaces (Euclidean, Torus, SO3, SOn,
               SphereAction, Product) and ManifoldSDETerm
  cfees      — CF-EES(2,5)/(2,7) and the geometric baselines (GeoEM, CG2,
               RKMK2)
  adaptive   — PI-controlled grid realization and adaptive integration
  adjoint    — solve(): the one solve loop (full, recursive and reversible
               adjoints)
  registry   — string-keyed solver registry ("ees25", "milstein", ...) and
               select_solver ("auto" specs)
  stability  — linear and mean-square stability of RK tableaux (numpy)
  sdeint     — batched Monte-Carlo integration and multi-tick dispatch
"""
from .adaptive import AdaptiveResult, RealizedGrid, integrate_adaptive, realize_grid
from .adjoint import SolveResult, solve
from .brownian import (BrownianDriver, BrownianPath, PaddedBrownianPath, VirtualBrownianTree,
                       brownian_path, padded_brownian_path, virtual_brownian_tree)
from .cfees import (RKMK2, CFLowStorageSolver, CrouchGrossman2, GeoEulerMaruyama, cfees25_solver,
                    cfees27_solver)
from .grid import TimeGrid, fill_saves, save_mask
from .lie import SO3, Euclidean, Group, ManifoldSDETerm, Product, SOn, SphereAction, Torus
from .pytree import resolve_solver
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
    "realize_grid",
    "RealizedGrid",
    "integrate_adaptive",
    "AdaptiveResult",
    "resolve_solver",
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
    "VirtualBrownianTree",
    "virtual_brownian_tree",
    "BrownianDriver",
    "TimeGrid",
    "fill_saves",
    "save_mask",
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
    "Group",
    "Euclidean",
    "Torus",
    "SO3",
    "SOn",
    "SphereAction",
    "Product",
    "ManifoldSDETerm",
    "CFLowStorageSolver",
    "GeoEulerMaruyama",
    "CrouchGrossman2",
    "RKMK2",
    "cfees25_solver",
    "cfees27_solver",
]
