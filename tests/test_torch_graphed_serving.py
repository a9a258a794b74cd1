"""Graphed serving: the ticks the executor captures into CUDA graphs and the
LM decode step the ``Engine`` captures, held on the CPU.

A capture fails on a host read of a tensor's value, a tensor made from host
data (a host-to-device copy on the card) or a data-dependent shape, so (a)
audits every tick kind the executor captures, and ``serve_step`` with a
tensor position for one smoke arch of each LM family, for those operators.
The executor's graphed dispatch (one replay per tick, each tick's outputs
copied out of the graph's pool before the next replay) runs here with an
eager stand-in for the graph whose static outputs are overwritten on every
replay as a graph's are: (b) it equals the eager dispatch and the
reference's engine, and (c) its capture bookkeeping is checked.  (d) holds
``serve_step`` with a 0-d tensor ``pos`` bitwise to the int.  (e) On the
card, graphed against eager: ``tests/test_torch_cuda.py -k graphed`` (the
card lane, a file without jax), skipped here.
"""
import collections
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.nsde as JN
from repro.nsde import init_lsde as jinit, lsde_term as jterm
from repro.serving.sde_engine import SDESampleConfig as JConfig, SDESampleEngine as JEngine
import repro_torch.core as T
import repro_torch.nsde as TN
from repro_torch.benchmarks import step_kernels as sk
from repro_torch.configs import get_arch
from repro_torch.core import PRNGKey, path_keys
from repro_torch.core.pytree import tree_flatten, tree_leaves
from repro_torch.core.registry import select_solver
from repro_torch.core.sdeint import tick_solve
from repro_torch.models import init_cache, init_params, serve_step
from repro_torch.nsde import lsde_params_from_jax, lsde_term
from repro_torch.serving import BucketKey, Engine, SDESampleConfig, SDESampleEngine, TickExecutor
from repro_torch.serving import engine as engine_mod, executor as executor_mod

D_Z, WIDTH, SLOTS = 4, 8, 8
LM_ARCHS = ("olmo-1b", "olmoe-1b-7b", "mamba2-130m", "zamba2-7b")  # dense, moe, ssm, hybrid


class _HostAudit(TorchDispatchMode):
    """Counts, by source line of the port, the operators a CUDA graph
    capture cannot take: host reads of a tensor's value
    (``_local_scalar_dense``), tensors made from host data (``lift_fresh``)
    and data-dependent shapes (``nonzero``, ``masked_select``); as in
    ``tests/test_torch_scanned_training.py``."""

    BAD = ("_local_scalar_dense", "lift_fresh", "nonzero", "masked_select")

    def __init__(self):
        super().__init__()
        self.hits = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if any(b in name for b in self.BAD):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "repro_torch" in f.filename]
            where = f"{frames[-1].filename}:{frames[-1].lineno}" if frames else "?"
            self.hits[(name, where)] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def lsde64():
    params = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64), jinit(jax.random.PRNGKey(1), 1, D_Z, WIDTH))
    y0 = jnp.linspace(-0.5, 0.5, D_Z)
    return params, y0, lsde_params_from_jax(params, device="cpu"), torch.from_numpy(np.array(y0))


def _keys(seed, n_ticks=1, slots=SLOTS):
    return path_keys(PRNGKey(seed, device="cpu"), n_ticks * slots).reshape(n_ticks, slots, 2)


# -- (a) what a capture cannot take -------------------------------------------

def _executor(kind, lsde64, guard=1e6):
    _, _, tparams, ty0 = lsde64
    if kind == "lsde":
        return TickExecutor(lsde_term(), ty0, args=tparams, dtype=torch.float64,
                            guard=guard, device="cpu")
    if kind == "torus":
        term = T.ManifoldSDETerm(group=T.Torus(), drift=lambda t, y, a: 1.5 + torch.sin(y),
                                 diffusion=lambda t, y, a: 0.8 + 0.2 * torch.cos(y))
        return TickExecutor(term, torch.linspace(-3.0, 3.0, 4, dtype=torch.float64),
                            dtype=torch.float64, guard=guard, device="cpu")
    if kind == "sphere":
        p = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                   JN.init_sphere_nsde(jax.random.PRNGKey(5), 4, width=16))
        y0 = torch.tensor([0.5, -0.5, 0.5, 0.5], dtype=torch.float64)
        return TickExecutor(TN.sphere_nsde_term(4), y0,
                            args=TN.sphere_params_from_jax(p, device="cpu"),
                            noise_shape=(6,), dtype=torch.float64, guard=guard,
                            device="cpu")
    term, ns = {"additive": (sk.make_term("prediffused"), None),
                "general": (sk.make_term("general"), (sk.N_CHANNELS,))}[kind]
    return TickExecutor(term, torch.ones(sk.DIM, dtype=torch.float64),
                        args=sk.term_args("cpu", torch.float64), noise_shape=ns,
                        dtype=torch.float64, guard=guard, device="cpu")


def _exact(spec, t1=1.0, n=8, save_every=None):
    return (spec, 0.0, t1, n, save_every, None, None, None)


def _bucket(spec, h=0.25):
    return BucketKey(spec, 0.0, h, 8)


# (executor kind, key, live steps of a bucketed tick, guard)
TICK_KINDS = {
    "ees25 kernels, bucket, 8 live": ("lsde", _bucket("ees25:use_kernels=True"), 8, 1e6),
    "ees25 kernels, bucket, 3 live": ("lsde", _bucket("ees25:use_kernels=True"), 3, 1e6),
    "ees25 plain, bucket, 5 live": ("lsde", _bucket("ees25"), 5, 1e6),
    "ees27 kernels, save_every": ("lsde", _exact("ees27:use_kernels=True", 2.0, 16, 4), None, 1e6),
    "ees25 kernels, no guard": ("lsde", _exact("ees25:use_kernels=True"), None, None),
    "ees25 kernels, additive": ("additive", _bucket("ees25:use_kernels=True", 1 / 64), 6, 1e6),
    "ees25 kernels, general": ("general", _exact("ees25:use_kernels=True"), None, 1e6),
    "reversible heun kernels": ("lsde", _exact("reversible-heun:use_kernels=True"), None, 1e6),
    "mcf-euler kernels": ("lsde", _bucket("mcf-euler:use_kernels=True"), 8, 1e6),
    "milstein": ("lsde", _exact("milstein"), None, 1e6),
    "auto (additive)": ("additive", _exact(select_solver("additive", 0.0, 1 / 64), 0.125),
                        None, 1e6),
    "cfees25, torus": ("torus", _exact("cfees25", 1.0, 10), None, 1e6),
    "cfees27, sphere, save_every": ("sphere", _exact("cfees27", 1.0, 4, 2), None, 1e6),
    "cg2, sphere, bucket": ("sphere", _bucket("cg2", 0.125), 6, 1e6),
}


@pytest.mark.parametrize("name", list(TICK_KINDS))
def test_captured_tick_reads_nothing_on_the_host(lsde64, name):
    """Every tick kind the executor captures is marked capturable and makes
    no host read, host-to-device copy or data-dependent shape: the one-tick
    stack a graph captures, run here with the kernels' twins."""
    kind, key, live, guard = TICK_KINDS[name]
    ex = _executor(kind, lsde64, guard)
    one = ex._stack_fn(key, 1)
    assert one.capturable
    keys = _keys(3)
    with torch.no_grad(), _HostAudit() as audit:
        out = one(keys, (live,)) if live is not None else one(keys)
    assert not audit.hits, dict(audit.hits)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(out.y_final))
    assert out.diverged is None if guard is None else out.diverged.shape == (1, SLOTS)


def test_adaptive_solve_is_not_capturable(lsde64):
    _, _, tparams, ty0 = lsde64
    assert tick_solve(lsde_term(), "ees25:adaptive", 0.0, 1.0, 64, ty0, args=tparams,
                      rtol=1e-3, device="cpu").capturable is False
    assert tick_solve(lsde_term(), "ees25", 0.0, 1.0, 8, ty0, args=tparams,
                      step_size=0.125, device="cpu").capturable is True
    ex = _executor("lsde", lsde64)
    adaptive = ("ees25:adaptive", 0.0, 1.0, 64, None, 1e-3, None, None)
    assert ex._stack_fn(adaptive, 1).capturable is False
    ex.graphed = True  # the card's setting: the adaptive key stays eager
    assert not ex._captures(ex._stack_fn(adaptive, 2))


def _smoke_lm(arch):
    cfg = get_arch(arch).smoke()
    return cfg, init_params(cfg, 0, device="cpu")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_step_with_tensor_pos_reads_nothing_on_the_host(arch):
    cfg, params = _smoke_lm(arch)
    cache = init_cache(cfg, 2, 16, device="cpu")
    toks = torch.tensor([3, 5])
    pos = torch.full((), 4, dtype=torch.int64)
    with torch.no_grad(), _HostAudit() as audit:
        logits, _ = serve_step(cfg, params, cache, toks, pos)
    assert not audit.hits, dict(audit.hits)
    assert bool(torch.isfinite(logits).all())


# -- the graphed dispatch, with an eager stand-in for the graph ----------------

class _EagerTick:
    """Stands in for ``executor._TickGraph`` on the CPU: ``replay`` runs the
    tick and writes its result into the same static output leaves every
    time, as a graph's replay overwrites its pool."""

    n_built = 0

    def __init__(self, run, keys, pool, stream):
        type(self).n_built += 1
        self.run, self.keys = run, keys.clone()
        self.capture_seconds, self.pool_bytes = 0.0, 0
        self.leaves, self.treedef = tree_flatten(run(self.keys))

    def replay(self, keys):
        self.keys.copy_(keys)
        for dst, src in zip(self.leaves, tree_flatten(self.run(self.keys))[0]):
            dst.copy_(src)
        return self.leaves


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(executor_mod, "_TickGraph", _EagerTick)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: "stream")
    _EagerTick.n_built = 0
    return _EagerTick


def _graphed(ex):
    ex.graphed = True
    return ex


def _same(a, b) -> bool:
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_graphed_bucketed_stack_equals_its_single_tick_dispatches(lsde64, stand_in):
    """(b) A dispatch of T bucketed ticks with mixed live counts (replayed,
    one graph per live count) equals its T single-tick dispatches and the
    eager stack, bitwise; the guard's ``diverged`` comes out like y_final."""
    bk = BucketKey("ees25:use_kernels=True", 0.0, 0.25, 8)
    live = (8, 3, 8, 5)
    keys = _keys(5, len(live))
    eager = _executor("lsde", lsde64)
    graphed = _graphed(_executor("lsde", lsde64))
    with torch.no_grad():
        want = eager.dispatch(bk, keys, live)
        got = graphed.dispatch(bk, keys, live)
        singles = [graphed.dispatch(bk, keys[t:t + 1], (n,)) for t, n in enumerate(live)]
    assert _same(got, want) and got.diverged is not None and got.ys is None
    for t, one in enumerate(singles):
        assert torch.equal(one.y_final[0], got.y_final[t])
        assert torch.equal(one.diverged[0], got.diverged[t])
    assert stand_in.n_built == 3 and graphed.graph_stats()["graphs"] == 3
    assert graphed.n_replays == len(live) * 2 and (graphed.n_dispatches, graphed.n_ticks) == (5, 8)


def test_graphed_exact_stack_with_saves_equals_eager(lsde64, stand_in):
    key = _exact("ees27:use_kernels=True", 2.0, 16, 4)
    keys = _keys(6, 2)
    with torch.no_grad():
        want = _executor("lsde", lsde64).dispatch(key, keys)
        got = _graphed(_executor("lsde", lsde64)).dispatch(key, keys)
    assert got.ys.shape == (2, SLOTS, 4, D_Z) and _same(got, want)
    assert stand_in.n_built == 1


def test_graphed_engine_equals_reference_engine(lsde64, stand_in):
    """The sync engine on a graphed executor serves the reference engine's
    samples (float64, 1e-10 relative) and its eager self's bitwise."""
    params, y0, tparams, ty0 = lsde64
    reqs = (("ees25", 2.0, 8, 12, None, 1), ("ees25", 1.5, 6, 8, None, 2),
            ("ees27", 2.0, 16, 8, 4, 3))

    def drain(eng):
        rids = [eng.submit(s, t1=t1, n_steps=n, n_paths=p, save_every=se, seed=seed)
                for s, t1, n, p, se, seed in reqs]
        done = eng.run()
        return [done[r] for r in rids]

    cfg = SDESampleConfig(slots=SLOTS, ticks_per_dispatch=2, dtype=torch.float64)
    graphed = SDESampleEngine(lsde_term(), ty0, cfg, args=tparams, device="cpu")
    _graphed(graphed.executor)
    got = drain(graphed)
    want = drain(SDESampleEngine(lsde_term(), ty0, cfg, args=tparams, device="cpu"))
    ref = drain(JEngine(jterm(), y0, JConfig(slots=SLOTS, ticks_per_dispatch=2,
                                             dtype=jnp.float64), args=params))
    assert graphed.executor.n_replays > 0
    for g, w, r in zip(got, want, ref):
        assert np.array_equal(g.y_final, w.y_final) and np.array_equal(g.diverged, w.diverged)
        assert (g.ys is None) == (w.ys is None) and (g.ys is None or np.array_equal(g.ys, w.ys))
        r_y = np.asarray(r.y_final)
        assert np.abs(g.y_final - r_y).max() <= 1e-10 * max(1.0, np.abs(r_y).max())


def test_has_compiled_and_warmup_bookkeeping(lsde64, stand_in):
    """(c) ``has_compiled`` without ``active_steps`` keeps its meaning (the
    callable); with it, a graphed executor also needs each live count's
    graph.  ``warmup`` captures the bucket's full-length tick and the
    signature's tick at ``slots``; a CPU executor captures nothing."""
    bk = BucketKey("ees25:use_kernels=True", 0.0, 0.25, 8)
    sig = _exact("ees25:use_kernels=True")
    cpu = _executor("lsde", lsde64)
    assert cpu.warmup(bk, 2, SLOTS) is True and cpu.has_compiled(bk, 2, (8, 3))
    assert stand_in.n_built == 0 and cpu.graph_stats()["graphs"] == 0

    ex = _graphed(_executor("lsde", lsde64))
    assert not ex.has_compiled(bk, 2) and not ex.has_compiled(bk, 2, (8, 8))
    assert ex.warmup(bk, 2, SLOTS) is True and ex.warmup(bk, 2, SLOTS) is False
    assert stand_in.n_built == 1
    assert ex.has_compiled(bk, 2) and ex.has_compiled(bk, 2, (8, 8))
    assert not ex.has_compiled(bk, 2, (8, 3)) and ex.has_compiled(bk, 1, (8,))
    with torch.no_grad():
        ex.dispatch(bk, _keys(1, 2), (8, 3))
    assert ex.has_compiled(bk, 2, (3, 8)) and stand_in.n_built == 2
    assert not ex.has_compiled(sig, 1)
    assert ex.warmup(sig, 1, SLOTS) is True and ex.has_compiled(sig, 1)
    assert stand_in.n_built == 3 and ex.n_dispatches == 1
    with pytest.raises(ValueError, match="one live-step count per tick"):
        ex.dispatch(bk, _keys(1, 2), (8,))


# -- (d) serve_step with a tensor position -------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_step_tensor_pos_is_bitwise_the_int(arch):
    """Three decode steps at positions 0, 1, 2 with int and with 0-d tensor
    positions: logits and every cache leaf bitwise equal."""
    cfg, params = _smoke_lm(arch)
    caches = [init_cache(cfg, 2, 8, device="cpu") for _ in range(2)]
    gen = np.random.default_rng(0)
    with torch.no_grad():
        for pos in range(3):
            toks = torch.from_numpy(gen.integers(2, cfg.vocab, size=2))
            a, _ = serve_step(cfg, params, caches[0], toks, pos)
            b, _ = serve_step(cfg, params, caches[1], toks,
                              torch.full((), pos, dtype=torch.int64))
            assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(caches[0]),
                                                 tree_leaves(caches[1])))


def test_gloo_meshes_stay_eager():
    """Collectives over a gloo group stage through the host, so neither an
    executor on a gloo mesh nor a decode step over DTensor parameters on
    one is captured; plain parameters are."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import graph_capturable, make_sample_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_sample_mesh(1, device="cpu")
        assert not graph_capturable(mesh)
        module = torch.nn.Linear(2, 2)
        assert engine_mod._graph_capturable(module)
        module.weight = torch.nn.Parameter(distribute_tensor(module.weight.detach(), mesh,
                                                             [Replicate()]))
        assert not engine_mod._graph_capturable(module)
    finally:
        dist.destroy_process_group()


def test_cpu_engine_runs_eager():
    cfg, params = _smoke_lm("olmo-1b")
    eng = Engine(cfg, params)
    assert not eng.graphed and not isinstance(eng._step, engine_mod._DecodeGraph)
