"""Mesh data parallelism of the port on gloo process groups (CPU).

Each world size (1, 2, 4) spawns its ranks once, as processes running this
file (``python tests/test_torch_mesh.py WORLD RANK PORT OUT``) on
127.0.0.1, one thread each; every rank runs every check of
:func:`_checks` on the same inputs and writes what it got.  The parent
holds each rank's results against the single-process run (computed here,
one thread too):

* ``sdeint`` / ``sdeint_ticks`` on the Langevin term (EES(2,5) plain and
  through the kernels' CPU twins, an adaptive solve with ``save_at``) and
  an ``SDESampleEngine`` drain of three requests with sharded slots, sync
  and through ``AsyncSDESampleEngine``: bitwise at every world size (a path
  is a function of its key), but for the adaptive solve in blocks of two
  (see :func:`test_sharded_sampling_matches_the_single_process`);
* ``make_sde_train_step`` (EES(2,5), reversible and full adjoints,
  ``microbatches=2``, an adaptive spec), its optimizer state the last
  gradient: the loss and the gradient bitwise at one rank; at 2 and 4
  ranks the gradient within a reorder bound of the one-device gradient
  (:func:`test_sharded_train_step_loss_and_gradient`), and bitwise the same
  W blocks run in turn in one process and summed in rank order (rank 0
  runs that emulation).

No group can hang the run: the ranks of all three groups, spawned side by
side, are joined with one timeout, and a rank still alive fails the test.  The tier-1 counterparts of the reference's
mesh tests run in this process on a gloo world of one.
"""
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
SRC = os.path.join(os.path.dirname(os.path.dirname(HERE)), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

D_Z, WIDTH, B, N_STEPS = 4, 8, 8, 8
N_PATHS, MICRO = 16, 2
SAVE_AT = torch.tensor((0.25, 0.5, 0.75, 1.0), dtype=torch.float64)
TRAIN_CASES = {  # name: (spec, adjoint, microbatches, adaptive options)
    "reversible": ("ees25", "reversible", 1, {}),
    "full": ("ees25", "full", 1, {}),
    "microbatches": ("ees25", "reversible", MICRO, {}),
    "adaptive": ("ees25:adaptive", "reversible", 1, {"rtol": 1e-3, "save_at": SAVE_AT}),
}
REQUESTS = (("ees25", 1.0, 8, 12, 4, 1), ("ees25:use_kernels=True", 2.0, 16, 8, None, 2),
            ("ees27", 1.0, 4, 5, None, 3))
JOIN_S = 120
WORLDS = (1, 2, 4)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _model():
    from repro_torch.nsde import init_lsde

    return init_lsde(0, 1, D_Z, WIDTH, dtype=torch.float64, device="cpu")


def _y0():
    return torch.zeros(D_Z, dtype=torch.float64)


class _LastGradient:
    """An optimizer whose state is the last gradient it was given, so a
    step returns its gradient (parameters move by 1e-2 of it)."""

    @staticmethod
    def init(params):
        return [torch.zeros_like(p) for p in params]

    @staticmethod
    def update(grads, state, params):
        return ([p - 1e-2 * g for p, g in zip(params, grads)],
                [g.clone() for g in grads], torch.zeros(()))


def _loss(p, r):
    from repro_torch.nsde import lsde_readout

    ys = lsde_readout(p, r.ys)[..., 0]
    return ((ys.mean(0) - 0.5) ** 2).sum() + (ys ** 2).mean(0).sum() * 1e-1


def _train(name, mesh=None):
    from repro_torch.core import PRNGKey
    from repro_torch.train import make_sde_train_step

    spec, adjoint, micro, extra = TRAIN_CASES[name]
    params = _model()
    opt = _LastGradient()
    kw = {} if mesh is None else {"mesh": mesh, "mesh_axis": "dp"}
    step = make_sde_train_step(
        spec, _lsde_term(), opt, lambda p: _y0() + p.encoder.b, _loss, t0=0.0, t1=1.0,
        n_steps=64 if extra else N_STEPS, n_paths=N_PATHS, adjoint=adjoint,
        save_every=None if extra else N_STEPS // 2, microbatches=micro, device="cpu",
        **extra, **kw)
    _, grads, metrics = step(params, opt.init(list(params.parameters())),
                             PRNGKey(5, device="cpu"))
    return {"loss": metrics["loss"], "grads": grads}


def _lsde_term():
    from repro_torch.nsde import lsde_term

    return lsde_term()


def _emulated(name, world):
    """The step's gradient with ``world`` blocks run in turn in this
    process, their partials summed in rank order, and per-rank partials."""
    from repro_torch.core import PRNGKey, path_keys, sdeint
    from repro_torch.core.pytree import tree_flatten, tree_unflatten

    spec, adjoint, micro, extra = TRAIN_CASES[name]
    params = _model()
    leaves = list(params.parameters())
    keys = path_keys(PRNGKey(5, device="cpu"), N_PATHS).reshape(micro, -1, 2)
    gsum, parts_all, losses = [torch.zeros_like(p) for p in leaves], [], []
    for kc in keys:
        b = kc.shape[0] // world
        flats = []
        for r in range(world):
            res = sdeint(_lsde_term(), spec, 0.0, 1.0, 64 if extra else N_STEPS,
                         _y0() + params.encoder.b, None, args=params, adjoint=adjoint,
                         save_every=None if extra else N_STEPS // 2,
                         batch_keys=kc[r * b:(r + 1) * b], device="cpu", **extra)
            flat, treedef = tree_flatten(res)
            flats.append(flat)
        whole = [torch.cat([f[i].detach() for f in flats]) for i in range(len(flats[0]))]
        floats = [i for i, x in enumerate(whole) if x.is_floating_point()]
        for i in floats:
            whole[i].requires_grad_()
        loss = _loss(params, tree_unflatten(treedef, whole))
        grads = torch.autograd.grad(loss, leaves + [whole[i] for i in floats],
                                    allow_unused=True)
        g_direct, f_bar = grads[:len(leaves)], grads[len(leaves):]
        parts = []
        for r, flat in enumerate(flats):
            pull = [(flat[i], fb[r * b:(r + 1) * b]) for i, fb in zip(floats, f_bar)
                    if fb is not None and flat[i].requires_grad]
            g = torch.autograd.grad([o for o, _ in pull], leaves, [c for _, c in pull],
                                    allow_unused=True)
            parts.append([torch.zeros_like(p) if x is None else x for p, x in zip(leaves, g)])
        total = parts[0]
        for part in parts[1:]:
            total = [a + c for a, c in zip(total, part)]
        g = [t if d is None else d + t for d, t in zip(g_direct, total)]
        gsum = [a + c for a, c in zip(gsum, g)]
        parts_all.append(parts)
        losses.append(loss.detach())
    return {"grads": [x / micro for x in gsum] if micro > 1 else gsum,
            "parts": parts_all, "loss": torch.stack(losses).mean() if micro > 1 else losses[0]}


def _engine_drains(mesh=None):
    import asyncio

    from repro_torch.serving import AsyncSDESampleEngine, SDESampleConfig, SDESampleEngine

    kw = {} if mesh is None else {"mesh": mesh, "mesh_axis": "mc"}
    cfg = SDESampleConfig(slots=8, dtype=torch.float64, **kw)
    engine = SDESampleEngine(_lsde_term(), _y0(), cfg, args=_model(), device="cpu")
    rids = [engine.submit(s, t1=t1, n_steps=n, n_paths=p, save_every=se, seed=seed)
            for s, t1, n, p, se, seed in REQUESTS]
    engine.run()
    sync = [engine.done[r] for r in rids]

    async def serve():
        async with AsyncSDESampleEngine(_lsde_term(), _y0(), cfg, args=_model(),
                                        device="cpu") as eng:
            # every rank submits the same requests before the serve loop runs
            ids = [await eng.submit(s, t1=t1, n_steps=n, n_paths=p, save_every=se,
                                    seed=seed) for s, t1, n, p, se, seed in REQUESTS]
            return [await eng.result(r, numpy=True) for r in ids]

    served = asyncio.run(asyncio.wait_for(serve(), 60))
    fields = ("y_final", "ys", "diverged")
    return {f"{kind} {i} {f}": getattr(res, f)
            for kind, results in (("sync", sync), ("async", served))
            for i, res in enumerate(results) for f in fields if getattr(res, f) is not None}


def _solves(mesh=None):
    from repro_torch.core import PRNGKey, path_keys, sdeint, sdeint_ticks

    kw = {} if mesh is None else {"mesh": mesh, "mesh_axis": "mc"}
    params, keys = _model(), path_keys(PRNGKey(3, device="cpu"), 2 * B)
    out = {}
    with torch.no_grad():
        for spec in ("ees25", "ees25:use_kernels=True"):
            out[spec] = sdeint(_lsde_term(), spec, 0.0, 1.0, N_STEPS, _y0(), args=params,
                               save_every=N_STEPS // 2, batch_keys=keys[:B], device="cpu",
                               **kw)
            out[f"{spec} ticks"] = sdeint_ticks(
                _lsde_term(), spec, 0.0, 1.0, N_STEPS, _y0(), keys.reshape(2, B, 2),
                args=params, device="cpu", **kw)
        out["adaptive"] = sdeint(_lsde_term(), "ees25:adaptive", 0.0, 1.0, 64, _y0(),
                                 args=params, rtol=1e-3, save_at=SAVE_AT,
                                 batch_keys=keys[:B], device="cpu", **kw)
    return out


def _checks(mesh_mc=None, mesh_dp=None):
    return {"solves": _solves(mesh_mc), "engine": _engine_drains(mesh_mc),
            "train": {name: _train(name, mesh_dp) for name in TRAIN_CASES}}


def _worker(world: int, rank: int, port: int, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_sample_mesh, make_train_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        got = _checks(make_sample_mesh(device="cpu"), make_train_mesh(device="cpu"))
        if rank == 0:
            got["emulated"] = {name: _emulated(name, world) for name in TRAIN_CASES}
        torch.save(got, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


# -- the parent ------------------------------------------------------------------

def _leaves(tree):
    from repro_torch.core.pytree import tree_leaves

    return [torch.as_tensor(x) for x in tree_leaves(tree)]


@pytest.fixture(scope="module")
def groups():
    """Every rank's results of each world size (the three groups spawned
    once, side by side), and, computed here while they run with one thread
    as the ranks: the single-process run and each fixed-grid training
    case's per-path gradient partials (blocks of one path)."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        procs = {}
        for world in WORLDS:
            port, out = _free_port(), os.path.join(tmp, f"world{world}")
            procs[world] = [subprocess.Popen(
                [sys.executable, HERE, str(world), str(r), str(port), out], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
        deadline = time.monotonic() + JOIN_S
        here = {"single": _one_thread(_checks),
                "per_path": {name: _one_thread(_emulated, name, N_PATHS // micro)
                             for name, (_, _, micro, extra) in TRAIN_CASES.items()
                             if not extra}}
        logs, alive = [], []
        for world, ranks in procs.items():
            for r, p in enumerate(ranks):
                try:
                    logs.append(p.communicate(timeout=max(deadline - time.monotonic(),
                                                          1))[0].decode()[-3000:])
                except subprocess.TimeoutExpired:
                    alive.append((world, r))
        for p in (p for ranks in procs.values() for p in ranks):
            if p.poll() is None:
                p.kill()
                p.wait()
        assert not alive, f"ranks (world, rank) {alive} still alive after {JOIN_S} s"
        assert all(p.returncode == 0 for ranks in procs.values() for p in ranks), \
            "\n".join(logs)
        here.update({world: [torch.load(os.path.join(tmp, f"world{world}.{r}"),
                                        weights_only=False) for r in range(world)]
                     for world in WORLDS})
        return here


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def group(request, groups):
    return request.param, groups[request.param]


def test_every_rank_returns_the_same_results(group):
    world, ranks = group
    for other in ranks[1:]:
        for part in ("solves", "engine", "train"):
            a, b = _leaves(ranks[0][part]), _leaves(other[part])
            assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), part


def _one_thread(fn, *args):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


def _adaptive_in_turn(world):
    """The adaptive solve of :func:`_solves` as ``world`` blocks in turn."""
    from repro_torch.core import PRNGKey, path_keys, sdeint

    keys = path_keys(PRNGKey(3, device="cpu"), 2 * B)[:B]
    b = B // world
    with torch.no_grad():
        parts = [sdeint(_lsde_term(), "ees25:adaptive", 0.0, 1.0, 64, _y0(), args=_model(),
                        rtol=1e-3, save_at=SAVE_AT, batch_keys=keys[r * b:(r + 1) * b],
                        device="cpu") for r in range(world)]
    return [torch.cat(xs) for xs in zip(*(_leaves(p) for p in parts))]


@pytest.mark.parametrize("part", ["solves", "engine"])
def test_sharded_sampling_matches_the_single_process(group, single, part):
    """sdeint, sdeint_ticks (EES(2,5) plain and on the kernels' twins, an
    adaptive solve with save_at) and three requests served sync and async
    with sharded slots: bitwise the single process, except the adaptive
    solve in blocks of two paths.  There the CPU's GEMM rounds a row of the
    diffusion's per-path-time product differently by the row count, and
    the controller carries that last bit into its step sizes: the states
    and step sizes move by up to 6.8e-7 of their max (measured), the
    counts not at all.  So that solve is held bitwise to its blocks run in
    turn in one process, and to 1e-5 of each leaf's max (counts exactly)
    against the whole batch."""
    world, ranks = group
    got, want = ranks[0][part], single[part]
    assert set(got) == set(want)
    for name in want:
        a, b = _leaves(got[name]), _leaves(want[name])
        assert len(a) == len(b), name
        if name == "adaptive" and world > 1:
            turn = _one_thread(_adaptive_in_turn, world)
            assert all(torch.equal(x, y) for x, y in zip(a, turn)), name
            for x, y in zip(a, b):
                if y.is_floating_point():
                    assert (x - y).abs().max() <= 1e-5 * y.abs().max(), name
                else:
                    assert torch.equal(x, y), name
        else:
            assert all(torch.equal(x, y) for x, y in zip(a, b)), name


@pytest.fixture(scope="module")
def single(groups):
    return groups["single"]


@pytest.fixture(scope="module")
def per_path(groups):
    return groups["per_path"]


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_sharded_train_step_loss_and_gradient(group, single, per_path, case):
    """One rank: the single-device step bitwise.  W ranks, fixed grids: the
    loss bitwise (within 1e-12 relative asked), the gradient within the
    reorder bound of the chunk's n per-path terms, ``(n - 1) eps sum_p
    |g_p|`` (measured at most 1.9 eps sum_p |g_p|; the bound ``(W - 1) eps
    sum_r |g_r|`` over the ranks' partials does not hold, up to 7.2 of it:
    each block's own products sum its paths in another order too).  The
    adaptive case: the loss within 1e-5 relative and the gradient within
    1e-5 of its max (measured 7.9e-7 and 1.0e-6, the sampling test's
    row-count rounding carried by the controller)."""
    world, ranks = group
    got, want = ranks[0]["train"][case], single["train"][case]
    if world == 1:  # a mesh of one rank is the single-device step
        assert torch.equal(got["loss"], want["loss"])
        assert all(torch.equal(a, b) for a, b in zip(got["grads"], want["grads"]))
        return
    if TRAIN_CASES[case][3]:
        assert abs(got["loss"].item() / want["loss"].item() - 1.0) <= 1e-5
        top = max(b.abs().max() for b in want["grads"])
        assert all((a - b).abs().max() <= 1e-5 * top
                   for a, b in zip(got["grads"], want["grads"]))
        return
    assert abs(got["loss"].item() - want["loss"].item()) <= 1e-12 * abs(want["loss"].item())
    eps = torch.finfo(torch.float64).eps
    parts = per_path[case]["parts"]
    n = len(parts[0])
    for i, (a, b) in enumerate(zip(got["grads"], want["grads"])):
        spread = sum(sum(p[i].abs() for p in chunk) for chunk in parts)
        assert bool(((a - b).abs() <= (n - 1) * eps * spread).all()), i


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_sharded_train_step_is_bitwise_the_blocks_in_turn(group, case):
    """A W-rank step equals the same W blocks solved in turn in one process,
    the partials summed in rank order."""
    world, ranks = group
    got, emu = ranks[0]["train"][case], ranks[0]["emulated"][case]
    assert torch.equal(got["loss"], emu["loss"])
    assert all(torch.equal(a, b) for a, b in zip(got["grads"], emu["grads"]))


# -- the reference's tier-1 mesh tests, on a gloo world of one -------------------

@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _plain_step(mesh=None, adaptive=False, optimizer=None):
    from repro_torch.optim import adamw
    from repro_torch.train import make_sde_train_step

    opt = optimizer or adamw(1e-2)
    kw = {} if mesh is None else {"mesh": mesh, "mesh_axis": "dp"}
    extra = ({"rtol": 1e-3, "atol": 1e-5, "save_at": np.linspace(0.0, 1.0, 5)}
             if adaptive else {"save_every": 4})
    loss = (lambda p, r: (r.ys ** 2).mean()) if adaptive else _loss  # noqa: E731
    step = make_sde_train_step("ees25:adaptive" if adaptive else "ees25", _lsde_term(), opt,
                               lambda p: _y0() + p.encoder.b, loss, t0=0.0, t1=1.0,
                               n_steps=64 if adaptive else 8, n_paths=8, device="cpu",
                               **extra, **kw)
    return step, opt


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_single_device_mesh_step_bitwise(world_of_one, adaptive):
    """The reference's ``test_single_device_mesh_bitwise`` and its adaptive
    variant: a train mesh of one rank gives the plain step's parameters,
    optimizer state and loss bitwise."""
    from repro_torch.core import PRNGKey
    from repro_torch.launch.mesh import make_train_mesh

    runs = []
    for mesh in (None, make_train_mesh(1, device="cpu")):
        step, opt = _plain_step(mesh, adaptive)
        params = _model()
        params, state, metrics = step(params, opt.init(list(params.parameters())),
                                      PRNGKey(0, device="cpu"))
        runs.append(_leaves((list(params.parameters()), state, metrics["loss"])))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_mesh_validation_matches_the_reference(world_of_one):
    """The reference's trainer, sdeint and serving checks, messages matched."""
    from repro_torch.core import PRNGKey, path_keys, sdeint
    from repro_torch.launch.mesh import make_sample_mesh, make_train_mesh
    from repro_torch.serving import SDESampleConfig, SDESampleEngine, TickExecutor
    from repro_torch.train import make_sde_train_step
    from repro_torch.optim import adamw

    def train(**kw):
        return make_sde_train_step("ees25", _lsde_term(), adamw(1e-2), lambda p: _y0(), _loss,
                                   t0=0.0, t1=1.0, n_steps=4, n_paths=8, device="cpu", **kw)

    with pytest.raises(ValueError, match="mesh_axis"):
        train(mesh_axis="dp")
    with pytest.raises(ValueError, match="mesh"):
        train(mesh=make_train_mesh(1, device="cpu"))
    key = PRNGKey(0, device="cpu")
    with pytest.raises(ValueError, match="batch_keys"):
        sdeint(_lsde_term(), "euler", 0.0, 1.0, 8, torch.ones(2), key, mesh_axis="data",
               device="cpu")
    with pytest.raises(ValueError, match="mesh_axis"):
        sdeint(_lsde_term(), "euler", 0.0, 1.0, 8, torch.ones(2), None, device="cpu",
               batch_keys=path_keys(key, 2), mesh=object())
    with pytest.raises(ValueError, match="mesh and mesh_axis together"):
        SDESampleEngine(_lsde_term(), torch.ones(3), SDESampleConfig(mesh_axis="mc"),
                        device="cpu")
    with pytest.raises(ValueError, match="mesh and mesh_axis together"):
        TickExecutor(_lsde_term(), torch.ones(3), mesh_axis="mc", device="cpu")

    class FourWide:  # the engine reads only the axis size at construction
        shape = {"mc": 4}

    with pytest.raises(ValueError, match="must be a multiple of mesh axis 'mc'"):
        SDESampleEngine(_lsde_term(), torch.ones(3),
                        SDESampleConfig(slots=6, mesh=FourWide(), mesh_axis="mc"),
                        device="cpu")
    # the port's own: an ambient mesh, an axis it lacks, a batch it does not divide
    mesh = make_sample_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="no mesh"):
        sdeint(_lsde_term(), "euler", 0.0, 1.0, 8, torch.ones(2), None, device="cpu",
               batch_keys=path_keys(key, 2), mesh_axis="mc")
    with mesh:
        res = sdeint(_lsde_term(), "euler", 0.0, 1.0, 8, _y0(), None, device="cpu",
                     batch_keys=path_keys(key, 2), mesh_axis="mc", args=_model())
    assert res.y_final.shape == (2, D_Z)
    with pytest.raises(ValueError, match="no axis 'dp'"):
        sdeint(_lsde_term(), "euler", 0.0, 1.0, 8, torch.ones(2), None, device="cpu",
               batch_keys=path_keys(key, 2), mesh=mesh, mesh_axis="dp")
    with pytest.raises(ValueError, match="n_devices=2 not in"):
        make_sample_mesh(2, device="cpu")


def test_single_device_mesh_step_matches_the_reference_float64(world_of_one):
    """The port's one-rank mesh step against the reference's
    ``make_train_mesh(1)`` step, float64, Table-1 loss, at the trainer
    parity tests' tolerances (``tests/test_torch_train.py``: the first loss
    1e-12 relative, parameters 1e-6 absolute after AdamW's float32
    moments)."""
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_train_mesh as jmesh
    from repro.nsde import init_lsde as jinit
    from repro.nsde import lsde_readout as jreadout
    from repro.nsde import lsde_term as jterm
    from repro.optim import optimizers as jopt
    from repro.train.trainer import make_sde_train_step as jmake
    from repro_torch.core import prng
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.nsde import lsde_params_from_jax, lsde_readout
    from repro_torch.optim import adamw
    from repro_torch.train import make_sde_train_step

    jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                     jinit(jax.random.PRNGKey(0), 1, D_Z, WIDTH))
    opt = jopt.adamw(1e-2)
    jstep = jax.jit(jmake("ees25", jterm(), opt, y0_fn=lambda p: jnp.zeros(D_Z) + p["encoder"]["b"],
                          loss_fn_result=lambda p, r: jnp.mean(jreadout(p, r.ys) ** 2),
                          t0=0.0, t1=1.0, n_steps=8, n_paths=8, save_every=4,
                          mesh=jmesh(1), mesh_axis="dp"))
    jp, _, jm = jstep(jparams, opt.init(jparams), jax.random.PRNGKey(0))

    params = lsde_params_from_jax(jparams, device="cpu")
    topt = adamw(1e-2)
    step = make_sde_train_step("ees25", _lsde_term(), topt,
                               lambda p: torch.zeros(D_Z, dtype=torch.float64) + p.encoder.b,
                               lambda p, r: (lsde_readout(p, r.ys) ** 2).mean(), t0=0.0,
                               t1=1.0, n_steps=8, n_paths=8, save_every=4, device="cpu",
                               mesh=make_train_mesh(1, device="cpu"), mesh_axis="dp")
    params, _, m = step(params, topt.init(list(params.parameters())),
                        prng.PRNGKey(0, device="cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-12)
    want = ([jp["encoder"]["w"], jp["encoder"]["b"]]
            + [x for name in ("drift", "diff") for l in jp[name] for x in (l["w"], l["b"])]
            + [jp["readout"]["w"], jp["readout"]["b"]])
    for a, b in zip(params.parameters(), want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6)


if __name__ == "__main__":
    _worker(*(int(a) for a in sys.argv[1:4]), sys.argv[4])
