"""sdeint / sdeint_ticks of the port on the neural Langevin SDE, against the
reference and against the port's own invariants.

Parity runs in one dtype throughout (the reference's float64 time grid meets
float32 parameters inside the LSDE diffusion when x64 is on):

* float64, in this process: the reference's own increments handed to the
  port's solve (tolerance 1e-12 relative: same recurrence, last-bit
  differences of matmul/silu/softplus), and the port's own threefry draws
  from the same keys (1e-10: the float64 normals differ by erfinv ulps);
* float32, in a subprocess without x64 (the serving default): the port's
  sdeint against the reference's from the same keys and parameters, 1e-4
  relative to the largest state entry.

The port's invariants hold bitwise: bulk == per-step increments, guarded ==
unguarded, kernel route == plain route (the CPU twin), ticks == per-tick
sdeint, padded == exact; a batch equals a loop of single-key solves to 1e-12
(torch's CPU matmul may sum a batched product in another order).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import brownian as jbr
from repro.core import sdeint as jsdeint
from repro.core.sdeint import path_keys as jpath_keys
from repro.nsde import init_lsde as jinit, lsde_term as jterm
from repro_torch.core import PRNGKey, SDETerm, TimeGrid, get_solver, path_keys, sdeint, sdeint_ticks, solve
from repro_torch.nsde import lsde_params_from_jax, lsde_term

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_Z, WIDTH, N_PATHS, N_STEPS = 4, 8, 6, 8
SPECS = ["ees25", "ees25:use_kernels=True", "ees27", "ees27:use_kernels=True"]


@pytest.fixture(scope="module")
def lsde64():
    params = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64), jinit(jax.random.PRNGKey(0), 1, D_Z, WIDTH))
    params["encoder"]["b"] = jnp.linspace(-0.5, 0.5, D_Z)
    y0 = jnp.zeros(D_Z) + params["encoder"]["b"]
    return params, y0, lsde_params_from_jax(params, device="cpu"), torch.from_numpy(np.array(y0))


def _keys(seed, n):
    jk = jpath_keys(jax.random.PRNGKey(seed), n)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


class _FixedIncrements:
    """A driver that replays a given increment buffer (n_steps, *batch, ...)."""

    def __init__(self, buf):
        self.buf = buf

    def grid_increments(self, ts):
        return self.buf

    def grid_increment(self, ts, n):
        return self.buf[n]


@pytest.mark.parametrize("spec", SPECS)
def test_solve_with_reference_increments_float64(lsde64, spec):
    params, y0, tparams, ty0 = lsde64
    jk, _ = _keys(3, N_PATHS)
    want = jsdeint(jterm(), spec, 0.0, 1.0, N_STEPS, y0, None, args=params,
                   batch_keys=jk, save_every=2, guard=1e6)
    jts = np.asarray(jax.numpy.linspace(0.0, 1.0, N_STEPS + 1))
    bufs = [np.asarray(jbr.brownian_path(k, 0.0, 1.0, N_STEPS, shape=(D_Z,),
                                         dtype=jnp.float64).grid_increments(jts))
            for k in jk]
    buf = torch.from_numpy(np.stack(bufs, axis=1))            # (steps, paths, d)
    grid = TimeGrid.uniform(0.0, 1.0, N_STEPS, _FixedIncrements(buf),
                            dtype=torch.float64, device="cpu")
    y0b = ty0.expand(N_PATHS, D_Z).contiguous()
    with torch.no_grad():
        got = solve(get_solver(spec), lsde_term(), y0b, grid, tparams,
                    save_every=2, guard=1e6, batch_dims=1)
    assert _rel(got.y_final, want.y_final) < 1e-12
    assert _rel(got.ys.movedim(0, 1), want.ys) < 1e-12
    assert (got.diverged.numpy() == np.asarray(want.diverged)).all()


@pytest.mark.parametrize("spec", SPECS)
def test_sdeint_same_keys_float64(lsde64, spec):
    params, y0, tparams, ty0 = lsde64
    jk, tk = _keys(5, N_PATHS)
    want = jsdeint(jterm(), spec, 0.0, 1.5, N_STEPS, y0, None, args=params,
                   batch_keys=jk, save_every=4, guard=1e6)
    with torch.no_grad():
        got = sdeint(lsde_term(), spec, 0.0, 1.5, N_STEPS, ty0, args=tparams,
                     batch_keys=tk, save_every=4, guard=1e6, device="cpu")
    assert got.y_final.shape == want.y_final.shape and got.ys.shape == want.ys.shape
    assert _rel(got.y_final, want.y_final) < 1e-10
    assert _rel(got.ys, want.ys) < 1e-10
    assert (got.diverged.numpy() == np.asarray(want.diverged)).all()


_F32_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np, torch
from repro.core import sdeint as jsdeint
from repro.core.sdeint import path_keys as jpath_keys
from repro.nsde import init_lsde as jinit, lsde_term as jterm
from repro_torch.core import sdeint
from repro_torch.nsde import lsde_params_from_jax, lsde_term, init_lsde
assert not jax.config.jax_enable_x64
params = jinit(jax.random.PRNGKey(0), 1, 4, 8)
y0 = jnp.linspace(-0.5, 0.5, 4, dtype=jnp.float32)
tparams = lsde_params_from_jax(params, device="cpu")
out = {}
# the port's init_lsde draws the reference's initial weights
port_init = init_lsde(0, 1, 4, 8, device="cpu")
out["init"] = max(float(np.abs(p.detach().numpy() - np.asarray(q)).max())
                  for p, q in zip(port_init.parameters(), [
                      params["encoder"]["w"], params["encoder"]["b"],
                      *[x for l in params["drift"] for x in (l["w"], l["b"])],
                      *[x for l in params["diff"] for x in (l["w"], l["b"])],
                      params["readout"]["w"], params["readout"]["b"]]))
for spec in ["ees25", "ees25:use_kernels=True", "ees27:use_kernels=True"]:
    jk = jpath_keys(jax.random.PRNGKey(9), 6)
    want = jsdeint(jterm(), spec, 0.0, 2.0, 8, y0, None, args=params,
                   batch_keys=jk, save_every=4, guard=1e6)
    with torch.no_grad():
        got = sdeint(lsde_term(), spec, 0.0, 2.0, 8, torch.from_numpy(np.asarray(y0)),
                     args=tparams, batch_keys=torch.from_numpy(np.asarray(jk).astype(np.int64)),
                     save_every=4, guard=1e6, device="cpu")
    scale = max(1.0, float(np.abs(np.asarray(want.y_final)).max()))
    out[spec] = dict(
        dtype=str(got.y_final.dtype), ref_dtype=str(want.y_final.dtype),
        y_final=float(np.abs(got.y_final.numpy() - np.asarray(want.y_final)).max()) / scale,
        ys=float(np.abs(got.ys.numpy() - np.asarray(want.ys)).max()) / scale,
        diverged_equal=bool((got.diverged.numpy() == np.asarray(want.diverged)).all()))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def float32_parity():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, "-c", _F32_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("spec", ["ees25", "ees25:use_kernels=True",
                                  "ees27:use_kernels=True"])
def test_sdeint_same_keys_float32(float32_parity, spec):
    r = float32_parity[spec]
    assert r["dtype"] == "torch.float32" and r["ref_dtype"] == "float32"
    assert r["y_final"] < 1e-4 and r["ys"] < 1e-4
    assert r["diverged_equal"]


def test_init_lsde_draws_the_reference_weights(float32_parity):
    assert float32_parity["init"] < 1e-6


# -- the port's own invariants -------------------------------------------------

def _run(tparams, ty0, spec="ees25", **kw):
    kw.setdefault("device", "cpu")
    with torch.no_grad():
        return sdeint(lsde_term(), spec, 0.0, 1.0, N_STEPS, ty0, args=tparams, **kw)


@pytest.mark.parametrize("spec", SPECS)
def test_bulk_guard_and_kernel_routes_are_bitwise(lsde64, spec):
    _, _, tparams, ty0 = lsde64
    keys = path_keys(PRNGKey(2, device="cpu"), N_PATHS)
    base = _run(tparams, ty0, spec, batch_keys=keys, save_every=4)
    per_step = _run(tparams, ty0, spec, batch_keys=keys, save_every=4,
                    bulk_increments=False)
    guarded = _run(tparams, ty0, spec, batch_keys=keys, save_every=4, guard=1e6)
    plain = _run(tparams, ty0, spec.split(":")[0], batch_keys=keys, save_every=4)
    for other in (per_step, guarded, plain):
        assert torch.equal(base.y_final, other.y_final)
        assert torch.equal(base.ys, other.ys)
    assert base.diverged is None and guarded.diverged.shape == (N_PATHS,)
    assert not guarded.diverged.any()


def test_batch_equals_loop(lsde64):
    _, _, tparams, ty0 = lsde64
    keys = path_keys(PRNGKey(4, device="cpu"), N_PATHS)
    batch = _run(tparams, ty0, batch_keys=keys, save_every=2, guard=1e6)
    for i in range(N_PATHS):
        one = _run(tparams, ty0, key=keys[i], save_every=2, guard=1e6)
        torch.testing.assert_close(one.y_final, batch.y_final[i], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(one.ys, batch.ys[i], rtol=1e-12, atol=1e-12)
        assert one.diverged.dim() == 0 and bool(one.diverged) == bool(batch.diverged[i])


def test_ticks_equal_per_tick_sdeint(lsde64):
    _, _, tparams, ty0 = lsde64
    stack = path_keys(PRNGKey(6, device="cpu"), 3 * N_PATHS).reshape(3, N_PATHS, 2)
    with torch.no_grad():
        ticks = sdeint_ticks(lsde_term(), "ees25:use_kernels=True", 0.0, 1.0,
                             N_STEPS, ty0, stack, args=tparams, save_every=4,
                             guard=1e6, device="cpu")
    assert ticks.y_final.shape == (3, N_PATHS, D_Z)
    assert ticks.ys.shape == (3, N_PATHS, 2, D_Z) and ticks.diverged.shape == (3, N_PATHS)
    for t in range(3):
        one = _run(tparams, ty0, "ees25:use_kernels=True", batch_keys=stack[t],
                   save_every=4, guard=1e6)
        assert torch.equal(ticks.y_final[t], one.y_final)
        assert torch.equal(ticks.ys[t], one.ys)


def test_padded_ticks_equal_exact_horizons(lsde64):
    _, _, tparams, ty0 = lsde64
    stack = path_keys(PRNGKey(8, device="cpu"), 2 * N_PATHS).reshape(2, N_PATHS, 2)
    h, active = 0.125, (8, 5)
    with torch.no_grad():
        padded = sdeint_ticks(lsde_term(), "ees27", 0.0, 1.0, 8, ty0, stack,
                              args=tparams, active_steps=active, step_size=h,
                              guard=1e6, device="cpu")
        for t, k in enumerate(active):
            exact = sdeint(lsde_term(), "ees27", 0.0, k * h, k, ty0, args=tparams,
                           batch_keys=stack[t], guard=1e6, device="cpu")
            assert torch.equal(padded.y_final[t], exact.y_final)
            assert torch.equal(padded.diverged[t], exact.diverged)


@pytest.mark.parametrize("noise", ["none", "scalar", "additive"])
def test_other_noise_modes_batched(noise):
    drift = lambda t, y, a: -0.5 * y + 0.1 * t
    diff = (None if noise == "none" else
            (lambda t, y, a: 0.3 * torch.ones_like(y)) if noise == "additive"
            else (lambda t, y, a: 0.2 * torch.cos(y)))
    term = SDETerm(drift=drift, diffusion=diff, noise=noise)
    keys = path_keys(PRNGKey(1, device="cpu"), 4)
    y0 = torch.linspace(0.0, 1.0, 3, dtype=torch.float64)
    plain = sdeint(term, "ees25", 0.0, 1.0, 4, y0, batch_keys=keys, device="cpu")
    fused = sdeint(term, "ees25:use_kernels=True", 0.0, 1.0, 4, y0,
                   batch_keys=keys, device="cpu")
    assert torch.equal(plain.y_final, fused.y_final)
    for i in range(4):
        one = sdeint(term, "ees25", 0.0, 1.0, 4, y0, keys[i], device="cpu")
        torch.testing.assert_close(one.y_final, plain.y_final[i], rtol=1e-12, atol=1e-12)
    if noise == "none":  # ODE mode: every path is the same path
        assert torch.equal(plain.y_final[0], plain.y_final[3])


def test_guard_flags_blowups():
    term = SDETerm(drift=lambda t, y, a: y ** 3, diffusion=lambda t, y, a: 0.1 * y,
                   noise="diagonal")
    keys = path_keys(PRNGKey(0, device="cpu"), 3)
    y0 = torch.tensor([0.5, 3.0])
    with torch.no_grad():
        for guard in (1e6, float("inf")):  # finite threshold / non-finite only
            out = sdeint(term, "ees25", 0.0, 2.0, 8, y0, batch_keys=keys,
                         guard=guard, device="cpu")
            assert not torch.isfinite(out.y_final).all(-1).any()
            assert out.diverged.all()
        small = sdeint(SDETerm(drift=lambda t, y, a: -y,
                               diffusion=lambda t, y, a: 0.1 * y), "ees25",
                       0.0, 1.0, 4, y0, batch_keys=keys, guard=0.5, device="cpu")
    assert small.diverged.all()  # |y| stays above 0.5 for the 3.0 entry


@pytest.mark.parametrize("kwargs", [dict(rtol=1e-3), dict(bm_tol=0.1),
                                    dict(bounded=False), dict(save_at=[0.5]),
                                    dict(adjoint="bogus")])
def test_option_errors_match_reference(kwargs):
    jt = jterm()
    with pytest.raises(ValueError) as want:
        jsdeint(jt, "ees25", 0.0, 1.0, 4, jnp.zeros(2), jax.random.PRNGKey(0), **kwargs)
    with pytest.raises(ValueError) as got:
        sdeint(lsde_term(), "ees25", 0.0, 1.0, 4, torch.zeros(2),
               PRNGKey(0, device="cpu"), device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


def test_call_shape_errors():
    term = SDETerm(drift=lambda t, y, a: -y, diffusion=lambda t, y, a: y, noise="diagonal")
    y0 = torch.zeros(2)
    with pytest.raises(ValueError, match="pass key= for a single trajectory"):
        sdeint(term, "ees25", 0.0, 1.0, 2, y0, device="cpu")
    with pytest.raises(ValueError, match="mesh fan-out requires batch_keys"):
        sdeint(term, "ees25", 0.0, 1.0, 2, y0, PRNGKey(0, device="cpu"),
               mesh_axis="mc", device="cpu")
    keys = path_keys(PRNGKey(0, device="cpu"), 2)
    with pytest.raises(ValueError, match="tick_keys must stack per-tick key batches"):
        sdeint_ticks(term, "ees25", 0.0, 1.0, 2, y0, keys, device="cpu")
    with pytest.raises(ValueError, match="requires step_size"):
        sdeint_ticks(term, "ees25", 0.0, 1.0, 2, y0, keys[None], active_steps=[1],
                     device="cpu")
    with pytest.raises(ValueError, match=r"\(n_ticks,\) = \(1,\)"):
        sdeint_ticks(term, "ees25", 0.0, 1.0, 2, y0, keys[None], active_steps=[1, 2],
                     step_size=0.5, device="cpu")
    with pytest.raises(ValueError, match="step_size only applies"):
        sdeint_ticks(term, "ees25", 0.0, 1.0, 2, y0, keys[None], step_size=0.5,
                     device="cpu")
    with pytest.raises(ValueError, match="carries no saved trajectories"):
        sdeint_ticks(term, "ees25", 0.0, 1.0, 2, y0, keys[None], active_steps=[1],
                     step_size=0.5, save_every=1, device="cpu")
    with pytest.raises(ValueError, match="explicit noise_shape"):
        sdeint(SDETerm(drift=lambda t, y, a: -y, diffusion=lambda t, y, a: y,
                       noise="general"), "ees25", 0.0, 1.0, 2, y0,
               PRNGKey(0, device="cpu"), device="cpu")
