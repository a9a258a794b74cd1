"""The measured strong orders of ``tests/test_convergence_order.py``, in the
port: the same GBM cases on the same Virtual Brownian Tree paths (one
tree per key of ``split(PRNGKey(7), 32)``, float64) and the same SRA1 case
on the same fixed-grid paths with their Levy areas (``split(PRNGKey(9),
32)``), with the same exact references.

The port's per-level RMS errors are held to the reference's own (its test
module's ``_gbm_errors`` / ``_srk_errors``) within 1e-9 relative, and its
fitted slopes to the reference's within 1e-6: the draws agree to erfinv
ulps and the recurrences are the same.  They are not held to the
documented orders here: the reference's own test holds those, and fails
one case (``milstein`` on scalar noise, measured 0.70 against 1.0).
"""
import functools

import numpy as np
import pytest
import torch

import test_convergence_order as R
from repro_torch.core import SDETerm, TimeGrid, get_solver, prng, solve
from repro_torch.core.brownian import brownian_path, virtual_brownian_tree

F64 = torch.float64


def _keys(seed):
    return prng.split(prng.PRNGKey(seed, device="cpu"), R.N_PATHS)


@functools.lru_cache(maxsize=None)
def _port_gbm_errors(spec, form, noise):
    term = SDETerm(drift=lambda t, y, a: R.MU * y,
                   diffusion=lambda t, y, a: R.SIG * y, noise=noise)
    solver = get_solver(spec)
    shape = () if noise == "scalar" else (R.DIM,)
    mu_eff = (R.MU - 0.5 * R.SIG ** 2) if form == "ito" else R.MU
    y0 = torch.ones(R.N_PATHS, R.DIM, dtype=F64)
    errs = []
    for n in R.LEVELS:
        bm = virtual_brownian_tree(_keys(7), 0.0, R.T1, shape, dtype=F64)
        grid = TimeGrid.uniform(0.0, R.T1, n, bm, dtype=F64, device="cpu")
        y = solve(solver, term, y0, grid, batch_dims=1).y_final
        ws = bm.weval(R.T1)
        if noise == "scalar":
            ws = ws[..., None]  # ONE channel shared by every component
        ref = torch.exp(mu_eff * R.T1 + R.SIG * ws)
        errs.append(float(torch.sqrt(torch.mean((y - ref) ** 2))))
    return tuple(errs)


@functools.lru_cache(maxsize=None)
def _port_srk_errors():
    term = SDETerm(drift=lambda t, y, a: -R.THETA * y,
                   diffusion=lambda t, y, a: R.SIG_ADD * torch.ones_like(y),
                   noise="additive")
    solver = get_solver("srk:noise=additive")
    y0 = torch.ones(R.N_PATHS, R.DIM, dtype=F64)
    errs = []
    for n in R.LEVELS:
        h = R.T1 / n
        bm = brownian_path(_keys(9), 0.0, R.T1, n, (R.DIM,), dtype=F64)
        grid = TimeGrid.uniform(0.0, R.T1, n, bm, dtype=F64, device="cpu")
        y = solve(solver, term, y0, grid, batch_dims=1).y_final
        dWs, dHs = grid.levy_increments()
        yr = y0
        for dw, dh in zip(dWs, dHs):
            yr = (np.exp(-R.THETA * h) * yr
                  + R.SIG_ADD * (dw - R.THETA * h * (0.5 * dw + dh)))
        errs.append(float(torch.sqrt(torch.mean((y - yr) ** 2))))
    return tuple(errs)


CASES = [pytest.param(*c, id="-".join(c)) for c in R.GBM_CASES]


@pytest.mark.parametrize("spec,form,noise", CASES)
def test_gbm_errors_and_slope_match_the_reference(spec, form, noise):
    want = R._gbm_errors(spec, form, noise)
    got = _port_gbm_errors(spec, form, noise)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert abs(R._fit_slope(got) - R._fit_slope(want)) < 1e-6


def test_srk_errors_and_slope_match_the_reference():
    want, got = R._srk_errors(), _port_srk_errors()
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert abs(R._fit_slope(got) - R._fit_slope(want)) < 1e-6
