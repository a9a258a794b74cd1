"""The port's package boundary: no jax at runtime, CUDA by default, and a loud
error for every reference feature still to port."""
import ast
import os
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.core import PRNGKey, SDETerm, TimeGrid, path_keys, sdeint, sdeint_ticks
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
            "repro_torch.optim, repro_torch.benchmarks.table1_ou; "
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


@pytest.mark.parametrize("what", [
    "trainer microbatches", "adjoint=recursive", "adaptive spec", "adaptive flag",
    "mesh", "trainer mesh", "engine auto", "engine adaptive", "engine compile cache",
    "engine mesh"])
def test_unported_features_raise_not_yet_ported(what):
    key = PRNGKey(0, device="cpu")
    y0 = torch.zeros(2)
    run = {
        "trainer microbatches": lambda: _train_step(microbatches=2, device="cpu"),
        "trainer mesh": lambda: _train_step(mesh=object(), mesh_axis="dp",
                                            device="cpu"),
        "adjoint=recursive": lambda: sdeint(_term(), "ees25", 0.0, 1.0, 2, y0,
                                            key, adjoint="recursive", device="cpu"),
        "adaptive spec": lambda: sdeint(_term(), "ees25:adaptive", 0.0, 1.0, 2,
                                        y0, key, device="cpu"),
        "adaptive flag": lambda: sdeint(_term(), "ees25", 0.0, 1.0, 2, y0, key,
                                        adaptive=True, device="cpu"),
        "mesh": lambda: sdeint(_term(), "ees25", 0.0, 1.0, 2, y0, device="cpu",
                               batch_keys=path_keys(key, 2), mesh_axis="mc",
                               mesh=object()),
        "engine auto": lambda: SDESampleEngine(_term(), y0, device="cpu").submit(
            "auto", t1=1.0, n_steps=2, n_paths=1),
        "engine adaptive": lambda: SDESampleEngine(_term(), y0, device="cpu").submit(
            "ees25:adaptive", t1=1.0, n_steps=2, n_paths=1),
        "engine compile cache": lambda: SDESampleEngine(
            _term(), y0, SDESampleConfig(compile_cache_dir="x"), device="cpu"),
        "engine mesh": lambda: SDESampleEngine(
            _term(), y0, SDESampleConfig(mesh=object(), mesh_axis="mc"),
            device="cpu"),
    }
    with pytest.raises(NotYetPorted, match="not yet ported"):
        run[what]()


def test_engine_rejected_submit_burns_no_id():
    eng = SDESampleEngine(_term(), torch.zeros(2), device="cpu")
    with pytest.raises(NotYetPorted):
        eng.submit("ees25:adaptive", t1=1.0, n_steps=2, n_paths=1)
    assert eng.submit("ees25", t1=1.0, n_steps=2, n_paths=1) == 0


def test_package_exports():
    assert repro_torch.NotYetPorted is NotYetPorted
    assert issubclass(NotYetPorted, NotImplementedError)
