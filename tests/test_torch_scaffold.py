"""The port's package boundary: no jax at runtime, CUDA by default, and a loud
error for every reference feature still to port."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import (PRNGKey, SDETerm, TimeGrid, get_solver, path_keys, sdeint,
                              sdeint_ticks, solve)
from repro_torch.core.brownian import brownian_path
from repro_torch.device import NotYetPorted, resolve_device
from repro_torch.nsde import init_lsde
from repro_torch.optim import adamw
from repro_torch.serving import SDESampleConfig, SDESampleEngine
from repro_torch.train import make_sde_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.nsde, repro_torch.serving, repro_torch.train, "
            "repro_torch.optim, repro_torch.data, repro_torch.benchmarks.table1_ou, "
            "repro_torch.benchmarks.bench_training, "
            "repro_torch.benchmarks.table2_vol, repro_torch.benchmarks.table7_gbm, "
            "repro_torch.benchmarks.bench_stability, "
            "repro_torch.benchmarks.step_memory, repro_torch.benchmarks.table3_kuramoto, "
            "repro_torch.benchmarks.table4_sphere, repro_torch.benchmarks.fig_convergence, "
            "repro_torch.benchmarks.run; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), \
                f"{os.path.relpath(path, REPO)} imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolver_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _term():
    return SDETerm(drift=lambda t, y, a: -y, diffusion=lambda t, y, a: 0.1 * torch.ones_like(y))


def _train_step(**kw):
    return make_sde_train_step("ees25", _term(), adamw(1e-2), lambda p: torch.zeros(2),
                               lambda p, r: r.y_final.sum(), t0=0.0, t1=1.0,
                               n_steps=2, n_paths=4, **kw)


@pytest.mark.parametrize("entry", [
    "PRNGKey", "TimeGrid.uniform", "sdeint", "sdeint_ticks", "init_lsde",
    "SDESampleEngine", "make_sde_train_step"])
def test_entry_points_raise_without_cuda_unless_cpu(no_cuda, entry):
    key = PRNGKey(0, device="cpu")
    y0 = torch.zeros(2)
    calls = {
        "PRNGKey": lambda **d: PRNGKey(0, **d),
        "TimeGrid.uniform": lambda **d: TimeGrid.uniform(0.0, 1.0, 4, **d),
        "sdeint": lambda **d: sdeint(_term(), "ees25", 0.0, 1.0, 2, y0, key, **d),
        "sdeint_ticks": lambda **d: sdeint_ticks(
            _term(), "ees25", 0.0, 1.0, 2, y0,
            path_keys(key, 2)[None], **d),
        "init_lsde": lambda **d: init_lsde(0, 1, 2, 4, **d),
        "SDESampleEngine": lambda **d: SDESampleEngine(_term(), y0, **d),
        "make_sde_train_step": lambda **d: _train_step(**d),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    calls[entry](device="cpu")


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank on 127.0.0.1, destroyed after."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _same(a, b):
    from repro_torch.core.pytree import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("what", ["mesh", "trainer mesh", "engine mesh"])
def test_unported_features_raise_not_yet_ported(what, world_of_one):
    """Mesh data parallelism is ported (its gloo tests:
    ``tests/test_torch_mesh.py``): these cases, which held its
    ``NotYetPorted``, now hold the reference's validation and a mesh of
    one rank, bitwise the run without a mesh."""
    from repro_torch.launch.mesh import make_sample_mesh, make_train_mesh

    key = PRNGKey(0, device="cpu")
    y0 = torch.zeros(2)
    if what == "mesh":
        run = lambda **kw: sdeint(_term(), "ees25", 0.0, 1.0, 2, y0, device="cpu",  # noqa: E731
                                  batch_keys=path_keys(key, 2), **kw)
        with pytest.raises(ValueError, match="mesh_axis"):
            run(mesh=object())
        assert _same(run(mesh=make_sample_mesh(1, device="cpu"), mesh_axis="mc"), run())
    elif what == "trainer mesh":
        with pytest.raises(ValueError, match="mesh_axis"):
            _train_step(mesh_axis="dp", device="cpu")
        out = []
        for kw in ({}, {"mesh": make_train_mesh(1, device="cpu"), "mesh_axis": "dp"}):
            params = init_lsde(0, 1, 2, 4, device="cpu")
            opt = adamw(1e-2)
            step = make_sde_train_step(
                "ees25", _term(), opt, lambda p: torch.zeros(2),
                lambda p, r: (r.y_final ** 2).mean() + sum((w ** 2).sum() for w in
                                                          p.parameters()),
                t0=0.0, t1=1.0, n_steps=2, n_paths=4, device="cpu", **kw)
            _, state, metrics = step(params, opt.init(list(params.parameters())), key)
            out.append((list(params.parameters()), state, metrics["loss"]))
        assert _same(out[0], out[1])
    else:
        with pytest.raises(ValueError, match="mesh and mesh_axis together"):
            SDESampleEngine(_term(), y0, SDESampleConfig(mesh_axis="mc"), device="cpu")
        drains = []
        for kw in ({}, {"mesh": make_sample_mesh(1, device="cpu"), "mesh_axis": "mc"}):
            engine = SDESampleEngine(_term(), y0, SDESampleConfig(slots=4, **kw),
                                     device="cpu")
            rid = engine.submit("ees25", t1=1.0, n_steps=2, n_paths=6, seed=3)
            engine.run()
            drains.append(engine.done[rid])
        assert np.array_equal(drains[0].y_final, drains[1].y_final)
        assert np.array_equal(drains[0].diverged, drains[1].diverged)


@pytest.mark.parametrize("what", [
    "adjoint=recursive", "adaptive spec", "adaptive flag", "engine adaptive"])
def test_features_ported_since_now_run(what):
    """What these cases asserted NotYetPorted for runs now: save_at dense
    output under the recursive adjoint, ':adaptive' specs and the adaptive
    flag, and adaptive serving requests."""
    key = PRNGKey(0, device="cpu")
    y0 = torch.zeros(2)
    run = {
        "adjoint=recursive": lambda: solve(
            get_solver("ees25"), _term(), y0,
            brownian_path(key, 0.0, 1.0, 2, shape=(2,)), adjoint="recursive",
            save_at=torch.tensor([0.5])).ys,
        "adaptive spec": lambda: sdeint(_term(), "ees25:adaptive", 0.0, 1.0, 2,
                                        y0, key, device="cpu").y_final,
        "adaptive flag": lambda: sdeint(_term(), "ees25", 0.0, 1.0, 2, y0, key,
                                        adaptive=True, device="cpu").y_final,
        "engine adaptive": lambda: _serve_adaptive(y0),
    }
    out = run[what]()
    assert out.shape[-1] == 2 and bool(torch.isfinite(torch.as_tensor(out)).all())


def _serve_adaptive(y0):
    eng = SDESampleEngine(_term(), y0, device="cpu")
    rid = eng.submit("ees25:adaptive", t1=1.0, n_steps=2, n_paths=1)
    return eng.run()[rid].y_final


def test_engine_compile_cache_is_ported(tmp_path, monkeypatch):
    """``compile_cache_dir`` no longer raises: it names the directory the
    kernel libraries are built in and loaded from."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "_library_dir", _build.BUILD_DIR)
    SDESampleEngine(_term(), torch.zeros(2),
                    SDESampleConfig(compile_cache_dir=str(tmp_path)), device="cpu")
    assert _build._library_dir == tmp_path


def test_engine_rejected_submit_burns_no_id():
    eng = SDESampleEngine(_term(), torch.zeros(2), device="cpu")
    with pytest.raises(ValueError, match="adaptive"):
        eng.submit("ees25", t1=1.0, n_steps=2, n_paths=1, rtol=1e-3)
    assert eng.submit("ees25", t1=1.0, n_steps=2, n_paths=1) == 0


def test_package_exports():
    assert repro_torch.NotYetPorted is NotYetPorted
    assert issubclass(NotYetPorted, NotImplementedError)
