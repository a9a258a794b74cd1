"""The port's training pipeline against the reference's
(``tests/test_scanned_training.py``, ``tests/test_divergence_guard.py``):
scanned steps, microbatches, ``train_loop`` and ``resilient_train_loop``,
in one process, float64, on the reference tests' OU model and inputs.

Tolerances, and why:

* port against reference, the same steps from the same key: the first loss
  within 1e-12 relative, later losses 1e-6, parameters 1e-6 absolute (as
  ``test_torch_train.py``): the gradients agree to ~1e-15, but the
  optimizer updates in float32, so a last-bit flip of a float32 gradient
  moves a parameter by a float32 ulp and the next loss sees it;
* within the port, scanned against sequential, chunked against stepwise,
  resumed against unbroken: bitwise (the same calls in the same order);
* microbatches 4 against 1 within the port: the reference's own tolerance
  (loss 1e-12, parameters rtol 1e-9 / atol 1e-12): the slice gradients are
  summed in another association order;
* rollback counts, skip patterns and goodput: equal.

The launch bookkeeping of graph replays is held here with a stand-in C
entry; the graphs themselves run on the card
(``tests/test_torch_cuda.py::test_scanned_step_graph_equals_sequential_steps``).
"""
import collections
import math
import tempfile
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import SDETerm as JTerm
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine
from repro.train import trainer as jtrainer
from repro_torch.core import SDETerm, prng
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.kernels._build import CudaKernel, GraphLaunches
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import (ResilienceConfig, TrainLoopConfig, checkpoint_meta,
                               init_scan_counters, latest_step, make_scanned_step,
                               make_sde_train_step, resilient_train_loop, train_loop)

START = {"mu": 0.0, "nu": 0.5, "sigma": 0.5}
COMMON = dict(t0=0.0, t1=1.0, n_steps=16, n_paths=8)
KEY_SEED = 0


class OUParams(nn.Module):
    """The reference tests' parameter dict ``{mu, nu, sigma}`` as a module
    (``parameters()`` in the dict's sorted order)."""

    def __init__(self, dtype=torch.float64, values=START):
        super().__init__()
        for name in sorted(values):
            setattr(self, name, nn.Parameter(torch.tensor(values[name], dtype=dtype)))

    def __getitem__(self, name):
        return getattr(self, name)


TERM = SDETerm(drift=lambda t, y, p: p["nu"] * (p["mu"] - y),
               diffusion=lambda t, y, p: p["sigma"] * torch.ones_like(y),
               noise="diagonal")
JTERM = JTerm(drift=lambda t, y, p: p["nu"] * (p["mu"] - y),
              diffusion=lambda t, y, p: p["sigma"] * jnp.ones_like(y),
              noise="diagonal")


def jparams():
    """Fresh reference parameters (its scanned steps donate their inputs)."""
    return {k: jnp.float64(v) for k, v in START.items()}


def Y0(p):
    return torch.zeros(4, dtype=torch.float64)


def JY0(p):
    return jnp.zeros(4, jnp.float64)


def LOSS(p, r):
    return torch.mean(r.y_final ** 2) + 0.1 * torch.mean(torch.mean(r.y_final, 0) ** 2)


def JLOSS(p, r):
    return jnp.mean(r.y_final ** 2) + 0.1 * jnp.mean(jnp.mean(r.y_final, 0) ** 2)


def _opt(steps=64):
    return adamw(cosine_schedule(1e-3, 2, steps))


def _jopt(steps=64):
    return jadamw(jcosine(1e-3, 2, steps))


def _key():
    return prng.PRNGKey(KEY_SEED, device="cpu")


def _step(opt, loss=LOSS, **kw):
    return make_sde_train_step("ees25", TERM, opt, Y0, loss, device="cpu",
                               **{**COMMON, **kw})


def _jstep(opt, loss=JLOSS, **kw):
    return jtrainer.make_sde_train_step("ees25", JTERM, opt, JY0, loss,
                                        **{**COMMON, **kw})


def _fresh(opt):
    p = OUParams()
    return p, opt.init(list(p.parameters()))


def _values(params):
    return [p.detach().clone() for p in params.parameters()]


def _pair_equal(a, b):
    (pa, oa), (pb, ob) = a, b
    return (all(torch.equal(x, y) for x, y in zip(pa.parameters(), pb.parameters()))
            and all(torch.equal(x, y) for x, y in zip(tree_leaves(oa), tree_leaves(ob))))


def _ref_leaves(p):
    return [np.asarray(p[k]) for k in sorted(p)]


def _assert_close_to_reference(losses, params, ref_losses, ref_params):
    for i, (a, b) in enumerate(zip(losses, ref_losses)):
        np.testing.assert_allclose(a, b, rtol=1e-12 if i == 0 else 1e-6)
    for a, b in zip(params, ref_params):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)


# -- scanned steps -------------------------------------------------------------

@pytest.mark.parametrize("adjoint", ["full", "recursive", "reversible"])
def test_scanned_step_matches_reference(adjoint):
    opt, jopt = _opt(), _jopt()
    scanned = make_scanned_step(_step(opt, adjoint=adjoint), 4)
    p, s = _fresh(opt)
    p, s, c, hist = scanned(p, s, init_scan_counters("cpu"), _key(), 0)
    jscanned = jtrainer.make_scanned_step(_jstep(jopt, adjoint=adjoint), 4)
    jp, _, jc, jhist = jscanned(jparams(), jopt.init(jparams()),
                                jtrainer.init_scan_counters(),
                                jax.random.PRNGKey(KEY_SEED), jnp.asarray(0))
    _assert_close_to_reference(hist["loss"].tolist(), _values(p),
                               np.asarray(jhist["loss"]), _ref_leaves(jp))
    assert hist["skipped"].tolist() == np.asarray(jhist["skipped"]).tolist()
    assert {k: int(v) for k, v in c.items()} == {k: int(v) for k, v in jc.items()}


@pytest.mark.parametrize("adjoint", ["full", "recursive", "reversible"])
def test_scanned_step_equals_sequential_steps(adjoint):
    opt = _opt()
    step = _step(opt, adjoint=adjoint)
    p, s = _fresh(opt)
    losses = []
    for i in range(4):
        p, s, m = step(p, s, prng.fold_in(_key(), i))
        losses.append(m["loss"])
    p2, s2 = _fresh(opt)
    p2, s2, _, hist = make_scanned_step(step, 4)(p2, s2, init_scan_counters("cpu"),
                                                _key(), 0)
    assert _pair_equal((p, s), (p2, s2))
    assert torch.equal(hist["loss"], torch.stack(losses))
    assert hist["loss"].shape == hist["grad_norm"].shape == hist["skipped"].shape == (4,)


def test_counters_and_step0_offset():
    opt = _opt()
    step = _step(opt)
    scanned = make_scanned_step(step, 3)
    p, s = _fresh(opt)
    p, s, c, _ = scanned(p, s, init_scan_counters("cpu"), _key(), 0)
    p, s, c, _ = scanned(p, s, c, _key(), torch.tensor(3))
    pr, sr = _fresh(opt)
    for i in range(6):
        pr, sr, _ = step(pr, sr, prng.fold_in(_key(), i))
    assert _pair_equal((p, s), (pr, sr))
    assert int(c["steps"]) == 6 and int(c["skipped"]) == 0
    assert c["steps"].dtype == c["skipped"].dtype == torch.int32


def _faulty(base, faults):
    """The reference test's fault injector: steps in ``faults`` keep the
    incoming parameters and state and report a skip."""
    fault_t = torch.tensor(faults)

    def faulty(p, o, k, s):
        before = _values(p)
        p2, o2, m = base(p, o, k)
        hit = torch.isin(s, fault_t)
        with torch.no_grad():
            for q, b in zip(p2.parameters(), before):
                q.copy_(torch.where(hit, b, q))
        o2 = tree_map(lambda new, old: torch.where(hit, old, new), o2, o)
        return p2, o2, dict(m, skipped=m["skipped"] | hit)

    return faulty


def _jfaulty(base, faults):
    faults = jnp.asarray(faults)

    def faulty(p, o, k, s):
        p2, o2, m = base(p, o, k)
        hit = jnp.isin(s, faults)
        keep = lambda new, old: jnp.where(hit, old, new)  # noqa: E731
        p2, o2 = jax.tree_util.tree_map(keep, (p2, o2), (p, o))
        return p2, o2, dict(m, skipped=m["skipped"] | hit)

    return faulty


def test_four_arg_step_records_injected_faults():
    opt, jopt = _opt(), _jopt()
    scanned = make_scanned_step(_faulty(_step(opt), [1, 4]), 6)
    p, s = _fresh(opt)
    p, _, c, hist = scanned(p, s, init_scan_counters("cpu"), _key(), 0)
    assert hist["skipped"].tolist() == [False, True, False, False, True, False]
    assert int(c["skipped"]) == 2
    jscanned = jtrainer.make_scanned_step(_jfaulty(_jstep(jopt), [1, 4]), 6)
    jp, _, jc, jhist = jscanned(jparams(), jopt.init(jparams()),
                                jtrainer.init_scan_counters(),
                                jax.random.PRNGKey(KEY_SEED), jnp.asarray(0))
    assert np.asarray(jhist["skipped"]).tolist() == hist["skipped"].tolist()
    assert int(jc["skipped"]) == int(c["skipped"])
    _assert_close_to_reference(hist["loss"].tolist(), _values(p),
                               np.asarray(jhist["loss"]), _ref_leaves(jp))


def test_bad_steps_per_call_raises():
    with pytest.raises(ValueError, match="steps_per_call"):
        make_scanned_step(lambda p, o, k: (p, o, {}), 0)


def test_steps_are_marked_capturable_unless_adaptive():
    """Capture is decided up front: a fixed-grid step may be captured, an
    adaptive one (its controller reads the host) may not, and a step not
    marked runs eagerly; on the CPU nothing is graphed."""
    opt = _opt()
    fixed = _step(opt)
    adaptive = make_sde_train_step(
        "ees25:adaptive", TERM, opt, Y0, lambda p, r: torch.mean(r.ys ** 2),
        rtol=1e-3, atol=1e-5, save_at=np.linspace(0.0, 1.0, 5), device="cpu",
        **COMMON)
    assert fixed.capturable and not adaptive.capturable
    assert make_scanned_step(fixed, 2).capturable
    assert not make_scanned_step(fixed, 2, jit=False).capturable
    assert not make_scanned_step(adaptive, 2).capturable
    assert not make_scanned_step(lambda p, o, k: (p, o, {}), 2).capturable
    scanned = make_scanned_step(adaptive, 2)
    p, s = _fresh(opt)
    p, s, c, hist = scanned(p, s, init_scan_counters("cpu"), _key(), 0)
    assert not scanned.graphed and int(c["steps"]) == 2
    assert bool(torch.isfinite(hist["loss"]).all())


def test_scanned_adaptive_step_equals_sequential_steps():
    opt = _opt()
    step = make_sde_train_step(
        "ees25:adaptive", TERM, opt, Y0, lambda p, r: torch.mean(r.ys ** 2),
        rtol=1e-3, atol=1e-5, save_at=np.linspace(0.0, 1.0, 5), device="cpu",
        **COMMON)
    p, s = _fresh(opt)
    for i in range(3):
        p, s, _ = step(p, s, prng.fold_in(_key(), i))
    p2, s2 = _fresh(opt)
    p2, s2, _, _ = make_scanned_step(step, 3)(p2, s2, init_scan_counters("cpu"),
                                             _key(), 0)
    assert _pair_equal((p, s), (p2, s2))


# -- step audit: what a CUDA graph capture cannot take --------------------------

class _HostAudit(TorchDispatchMode):
    """Counts, by source line of the port, the operators that cannot run
    inside a CUDA graph capture: reads of a tensor's value by the host
    (``item``, ``float``, ``bool``: ``_local_scalar_dense``), tensors made
    from host data (``torch.tensor``/``as_tensor`` of Python or numpy
    values: ``lift_fresh``, a host-to-device copy on the card) and
    data-dependent shapes (``nonzero``, ``masked_select``).  The dispatch
    mode sees the backward pass too."""

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


@pytest.mark.parametrize("spec,adjoint,microbatches", [
    ("ees25:use_kernels=True", "reversible", 1),
    ("ees25:use_kernels=True", "full", 1),
    ("ees25:use_kernels=True", "recursive", 1),
    ("ees25:use_kernels=True", "reversible", 2),
    ("reversible_heun:use_kernels=True", "reversible", 1),
    ("mcf-euler:use_kernels=True", "reversible", 1),
    ("mcf-midpoint:use_kernels=True", "reversible", 1),
])
def test_capturable_table1_step_reads_nothing_on_the_host(spec, adjoint, microbatches):
    """A step marked capturable makes no host read and no host-to-device
    copy, forward or backward, so its capture cannot fail on one (the
    Table-1 model at a small width, the optimizer and the guard)."""
    from repro_torch.nsde import init_lsde, lsde_readout, lsde_term, moment_mse

    params = init_lsde(0, 1, 4, 8, dtype=torch.float64, device="cpu")
    tgt = torch.linspace(-1.0, 1.0, 32, dtype=torch.float64).reshape(16, 2)
    opt = adamw(1e-2)
    step = make_sde_train_step(
        spec, lsde_term(), opt,
        y0_fn=lambda p: torch.zeros(4, dtype=torch.float64) + p.encoder.b,
        loss_fn_result=lambda p, r: moment_mse(lsde_readout(p, r.ys)[..., 0], tgt),
        t0=0.0, t1=2.0, n_steps=4, n_paths=16, save_every=2, adjoint=adjoint,
        microbatches=microbatches, device="cpu")
    assert step.capturable
    state = opt.init(list(params.parameters()))
    s = torch.full((), 5, dtype=torch.int64)
    with _HostAudit() as audit:
        params, state, m = step(params, state, prng.fold_in(_key(), s))
    assert not audit.hits, dict(audit.hits)
    assert bool(torch.isfinite(m["loss"]))


def test_host_audit_sees_host_reads_in_the_backward_pass():
    class Reads(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            float(g.sum())
            return g * torch.as_tensor(2.0)

    x = torch.ones(3, requires_grad=True)
    with _HostAudit() as audit:
        torch.autograd.grad(Reads.apply(x).sum(), [x])
    names = {name for name, _ in audit.hits}
    assert {"aten._local_scalar_dense.default", "aten.lift_fresh.default"} <= names


# -- the launch bookkeeping of graph replays ----------------------------------

def test_graph_launch_record_counts_each_replay(monkeypatch):
    """A launch made while a graph is captured goes into the graph's record,
    not into the kernel's device count; each replay adds the record;
    ``host_launches`` counts the wrapper's calls, captured ones included."""
    kernel = CudaKernel("stand_in", "ws_stage_diag.cu", {"entry": []})
    kernel._bound["entry"] = lambda *args: 0
    kernel.launch("entry")
    assert (kernel.launches, kernel.host_launches, kernel.replayed_launches) == (1, 1, 0)
    record = GraphLaunches()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with record.capturing():
        kernel.launch("entry")
        kernel.launch("entry")
        with pytest.raises(RuntimeError, match="being captured"):
            with GraphLaunches().capturing():
                pass
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert (kernel.launches, kernel.host_launches) == (1, 3)
    assert record.by_kernel() == {"stand_in": 2}
    for _ in range(3):
        record.replay()
    assert (kernel.launches, kernel.host_launches, kernel.replayed_launches) == (7, 3, 6)
    assert kernel.entry_launches["entry"] == 7
    # outside a capture (or on a stream that is not capturing) launches count
    with record.capturing():
        kernel.launch("entry")
    assert kernel.launches == 8 and record.by_kernel() == {"stand_in": 2}


# -- microbatches ----------------------------------------------------------------

def _decomposable(p, r):
    return torch.mean(r.y_final ** 2)


def _jdecomposable(p, r):
    return jnp.mean(r.y_final ** 2)


def test_microbatches_match_full_batch_within_the_reference_tolerance():
    opt = _opt()
    p1, s1 = _fresh(opt)
    p1, _, m1 = _step(opt, loss=_decomposable)(p1, s1, _key())
    p4, s4 = _fresh(opt)
    p4, _, m4 = _step(opt, loss=_decomposable, microbatches=4)(p4, s4, _key())
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]), rtol=1e-12)
    for a, b in zip(p4.parameters(), p1.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatched_steps_match_reference(microbatches):
    opt, jopt = _opt(), _jopt()
    step = _step(opt, loss=LOSS, microbatches=microbatches)
    jstep = jax.jit(_jstep(jopt, loss=JLOSS, microbatches=microbatches))
    p, s = _fresh(opt)
    jp, js = jparams(), jopt.init(jparams())
    losses, jlosses = [], []
    for i in range(3):
        p, s, m = step(p, s, prng.fold_in(_key(), i))
        jp, js, jm = jstep(jp, js, jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), i))
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
    _assert_close_to_reference(losses, _values(p), jlosses, _ref_leaves(jp))


def test_microbatches_guard_skips_a_nan_batch():
    opt = _opt()
    p, s = _fresh(opt)
    before = _values(p)
    p, s2, m = _step(opt, loss=lambda p, r: LOSS(p, r) * float("nan"),
                     microbatches=2)(p, s, _key())
    assert bool(m["skipped"]) and not bool(torch.isfinite(m["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), before))
    assert int(s2.step) == 0


def test_non_dividing_microbatches_raises():
    with pytest.raises(ValueError, match="microbatches"):
        _step(_opt(), microbatches=3)


# -- train_loop ------------------------------------------------------------------

class _ToyData:
    """Step-pure data source: ``batch_at(step)`` is a pure function of step."""

    def __init__(self, dim=3, batch=4):
        self.dim, self.batch = dim, batch

    def batch_at(self, step):
        rng = np.random.default_rng(1000 + step)
        return rng.standard_normal((self.batch, self.dim))


def _toy_setup(steps):
    opt = adamw(cosine_schedule(1e-2, 2, steps))

    def params():
        return {"w": torch.tensor(np.linspace(0.3, 0.9, 3))}

    def step_fn(p, o, b):
        w = p["w"].detach().requires_grad_(True)
        loss = torch.mean((b @ w) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        p2, o2, gn = opt.update({"w": g}, o, {"w": p["w"]})
        return p2, o2, {"loss": loss.detach(), "grad_norm": gn}

    return opt, params, step_fn


def _jtoy_setup(steps):
    opt = jadamw(jcosine(1e-2, 2, steps))
    params = {"w": jnp.asarray(np.linspace(0.3, 0.9, 3))}

    def step_fn(p, o, b):
        l, g = jax.value_and_grad(lambda pp: jnp.mean((b @ pp["w"]) ** 2))(p)
        p2, o2, gn = opt.update(g, o, p)
        return p2, o2, {"loss": l, "grad_norm": gn}

    return opt, params, step_fn


def test_train_loop_chunked_bitwise_and_dispatch_count():
    steps = 10
    opt, params, step_fn = _toy_setup(steps)
    o1 = train_loop(None, params(), _ToyData(), optimizer=opt, step_fn=step_fn,
                    loop=TrainLoopConfig(steps=steps, log_every=2))
    o4 = train_loop(None, params(), _ToyData(), optimizer=opt, step_fn=step_fn,
                    loop=TrainLoopConfig(steps=steps, log_every=2, steps_per_call=4))
    assert o1["n_dispatches"] == steps
    assert o4["n_dispatches"] == 3  # ceil(10 / 4)
    assert torch.equal(o1["params"]["w"], o4["params"]["w"])
    assert o1["losses"] == o4["losses"]
    assert [s for s, _ in o1["losses"]] == [2, 4, 6, 8, 10]


@pytest.mark.parametrize("k", [1, 4])
def test_train_loop_matches_reference(k):
    steps = 10
    opt, params, step_fn = _toy_setup(steps)
    jopt, jparams, jstep_fn = _jtoy_setup(steps)
    got = train_loop(None, params(), _ToyData(), optimizer=opt, step_fn=step_fn,
                     loop=TrainLoopConfig(steps=steps, log_every=1, steps_per_call=k))
    want = jtrainer.train_loop(None, jparams, _ToyData(), optimizer=jopt,
                               step_fn=jstep_fn,
                               loop=jtrainer.TrainLoopConfig(steps=steps, log_every=1,
                                                             steps_per_call=k))
    assert got["n_dispatches"] == want["n_dispatches"]
    assert [s for s, _ in got["losses"]] == [s for s, _ in want["losses"]]
    _assert_close_to_reference([v for _, v in got["losses"]], [got["params"]["w"]],
                               [v for _, v in want["losses"]],
                               [np.asarray(want["params"]["w"])])


def test_train_loop_resume_from_chunk_boundary_bitwise(tmp_path):
    steps = 12
    opt, params, step_fn = _toy_setup(steps)
    loop = lambda n, d=None: TrainLoopConfig(  # noqa: E731
        steps=n, ckpt_every=4, ckpt_dir=d, log_every=100, steps_per_call=4)
    d = str(tmp_path / "ck")
    train_loop(None, params(), _ToyData(), optimizer=opt, step_fn=step_fn,
               loop=loop(8, d))
    assert latest_step(d) == 8
    resumed = train_loop(None, params(), _ToyData(), optimizer=opt, step_fn=step_fn,
                         loop=loop(steps, d))
    unbroken = train_loop(None, params(), _ToyData(), optimizer=opt, step_fn=step_fn,
                          loop=loop(steps))
    assert torch.equal(resumed["params"]["w"], unbroken["params"]["w"])
    assert resumed["n_dispatches"] == 1


def test_train_loop_resume_mid_chunk_bitwise(tmp_path):
    steps = 11
    opt, params, step_fn = _toy_setup(steps)
    d = str(tmp_path / "ck")
    train_loop(None, params(), _ToyData(), optimizer=opt, step_fn=step_fn,
               loop=TrainLoopConfig(steps=5, ckpt_every=5, ckpt_dir=d, log_every=100))
    assert latest_step(d) == 5
    resumed = train_loop(None, params(), _ToyData(), optimizer=opt, step_fn=step_fn,
                         loop=TrainLoopConfig(steps=steps, ckpt_every=100, ckpt_dir=d,
                                              log_every=100, steps_per_call=4))
    unbroken = train_loop(None, params(), _ToyData(), optimizer=opt, step_fn=step_fn,
                          loop=TrainLoopConfig(steps=steps, log_every=100,
                                               steps_per_call=4))
    assert torch.equal(resumed["params"]["w"], unbroken["params"]["w"])
    assert resumed["n_dispatches"] == 2  # 6 steps from step 5: chunks of 4 + 2


def test_train_loop_checkpoint_meta_records_chunking(tmp_path):
    opt, params, step_fn = _toy_setup(8)
    d = str(tmp_path / "ck")
    train_loop(None, params(), _ToyData(), optimizer=opt, step_fn=step_fn,
               loop=TrainLoopConfig(steps=8, ckpt_every=4, ckpt_dir=d,
                                    log_every=100, steps_per_call=4))
    assert checkpoint_meta(d, latest_step(d))["steps_per_call"] == 4


def test_train_loop_consumes_a_plain_iterator_and_a_module():
    """An iterator without ``batch_at`` and a module's parameters updated in
    place (the SDE step's convention)."""
    opt = _opt()
    step = _step(opt)

    def step_fn(p, o, batch):
        return step(p, o, prng.fold_in(_key(), batch[0]))

    keys = (np.array([i]) for i in range(6))
    params = OUParams()
    out = train_loop(None, params, keys, optimizer=opt, step_fn=step_fn,
                     loop=TrainLoopConfig(steps=6, log_every=3, steps_per_call=4))
    ref, rs = _fresh(opt)
    for i in range(6):
        ref, rs, _ = step(ref, rs, prng.fold_in(_key(), i))
    assert out["params"] is params and _pair_equal((params, out["opt_state"]), (ref, rs))
    assert [s for s, _ in out["losses"]] == [3, 6]


def test_train_loop_without_a_step_names_the_lm_item():
    """Without ``step_fn`` the loop trains the LM with its default step,
    ``make_accum_train_step`` (``tests/test_torch_lm_train_loop.py`` holds
    it to the reference's loop)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import init_params

    cfg = get_arch("olmo-1b").smoke()
    params = init_params(cfg, 0, device="cpu")
    before = [p.detach().clone() for p in params.parameters()]
    out = train_loop(cfg, params, SyntheticTokens(DataConfig(2, 8, cfg.vocab)),
                     loop=TrainLoopConfig(steps=2, log_every=1))
    assert out["params"] is params and out["n_dispatches"] == 2
    assert [s for s, _ in out["losses"]] == [1, 2]
    assert all(np.isfinite(v) for _, v in out["losses"])
    assert any(not torch.equal(a, b) for a, b in zip(before, params.parameters()))


# -- resilient_train_loop --------------------------------------------------------

def test_resilient_fault_free_chunked_matches_stepwise():
    opt = _opt()
    step = _step(opt)
    runs = []
    for k in (1, 4):
        p, s = _fresh(opt)
        with tempfile.TemporaryDirectory() as d:
            runs.append(resilient_train_loop(
                step, p, s, _key(),
                res=ResilienceConfig(steps=10, ckpt_every=4, ckpt_dir=d,
                                     steps_per_call=k)))
    r1, r2 = runs
    assert _pair_equal((r1["params"], r1["opt_state"]), (r2["params"], r2["opt_state"]))
    assert r1["losses"] == r2["losses"]
    assert r1["skipped"] == r2["skipped"]
    assert r1["goodput"] == r2["goodput"] == 1.0


@pytest.mark.parametrize("k", [1, 5])
def test_resilient_rollback_on_skip_streak_matches_reference(k):
    opt, jopt = _opt(), _jopt()
    faults = [2, 3, 4, 9]  # a streak of 3 -> rollback at 4
    p, s = _fresh(opt)
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as jd:
        got = resilient_train_loop(
            _faulty(_step(opt), faults), p, s, _key(),
            res=ResilienceConfig(steps=12, ckpt_every=2, ckpt_dir=d, skip_patience=3,
                                 steps_per_call=k))
        want = jtrainer.resilient_train_loop(
            _jfaulty(_jstep(jopt), faults), jparams(), jopt.init(jparams()),
            jax.random.PRNGKey(KEY_SEED),
            res=jtrainer.ResilienceConfig(steps=12, ckpt_every=2, ckpt_dir=jd,
                                          skip_patience=3, steps_per_call=k))
    assert got["skipped"] == want["skipped"]
    assert got["rollbacks"] == want["rollbacks"] == 1
    assert got["goodput"] == want["goodput"]
    assert len(got["losses"]) == 12
    _assert_close_to_reference(got["losses"], _values(got["params"]), want["losses"],
                               _ref_leaves(want["params"]))


def test_resilient_loop_rolls_back_after_skip_streak():
    """``test_divergence_guard.py``'s case: blown steps 3-5 (a dispatcher by
    call count), patience 3, checkpoints every 2 productive steps."""
    opt = adamw(cosine_schedule(1e-3, 2, 10))
    common = dict(n_steps=16, n_paths=4)
    clean = _step(opt, loss=_decomposable, **common)
    blown = _step(opt, loss=lambda p, r: _decomposable(p, r) * float("nan"), **common)
    calls = {"i": 0}

    def step_fn(p, s, k):
        i = calls["i"]
        calls["i"] += 1
        return (blown if i in {3, 4, 5} else clean)(p, s, k)

    p, s = _fresh(opt)
    with tempfile.TemporaryDirectory() as d:
        out = resilient_train_loop(step_fn, p, s, _key(),
                                   res=ResilienceConfig(steps=10, ckpt_every=2,
                                                        ckpt_dir=d, skip_patience=3))
    assert out["skipped"] == [False, False, False, True, True, True,
                              False, False, False, False]
    assert out["rollbacks"] == 1
    assert out["goodput"] == pytest.approx(0.7)
    assert all(torch.isfinite(q).all() for q in out["params"].parameters())


def test_resilient_rollback_restores_in_place():
    """A rollback writes the checkpoint into the module and the optimizer
    state the loop holds (a captured graph's static inputs stay valid)."""
    opt = _opt()
    p, s = _fresh(opt)
    ids = [id(q) for q in p.parameters()]
    with tempfile.TemporaryDirectory() as d:
        out = resilient_train_loop(
            _faulty(_step(opt), [0, 1, 2]), p, s, _key(),
            res=ResilienceConfig(steps=3, ckpt_every=2, ckpt_dir=d, skip_patience=3,
                                 steps_per_call=3))
    assert out["params"] is p and [id(q) for q in p.parameters()] == ids
    assert out["rollbacks"] == 1 and out["goodput"] == 0.0
    assert all(torch.equal(q, torch.tensor(START[n], dtype=torch.float64))
               for n, q in p.named_parameters())


def test_resilient_loop_records_fleet_health():
    from repro_torch.train import HeartbeatMonitor, StragglerTracker

    opt = _opt()
    monitor = HeartbeatMonitor(hosts=[], deadline_s=1e9)
    tracker = StragglerTracker(hosts=[])
    p, s = _fresh(opt)
    out = resilient_train_loop(_step(opt, n_paths=4), p, s, _key(),
                               res=ResilienceConfig(steps=3), monitor=monitor,
                               tracker=tracker, host=7)
    assert 7 in monitor._last and len(tracker._times[7]) == 3
    assert out["rollbacks"] == 0 and out["goodput"] == 1.0
    # chunked: one amortized sample a chunk; a dead host yields a plan
    dead = HeartbeatMonitor(hosts=[], deadline_s=60.0)
    dead.beat(0, now=time.monotonic() - 120.0)  # host 0 missed its deadline
    tracker = StragglerTracker(hosts=[])
    p, s = _fresh(opt)
    out = resilient_train_loop(_step(opt, n_paths=4), p, s, _key(),
                               res=ResilienceConfig(steps=4, steps_per_call=2,
                                                    mesh_shape=(2, 1, 1),
                                                    hosts_per_pod=2),
                               monitor=dead, tracker=tracker, host=3)
    assert len(tracker._times[3]) == 2
    plans = out["recovery_plans"]
    assert len(plans) == 2 and plans[0].new_mesh_shape == (1, 1, 1)
    assert math.isclose(out["goodput"], 1.0)


# -- the benchmarks' training sections ----------------------------------------------

def test_bench_resilience_trainer_section_matches_reference():
    """The trainer section's fault schedule gives the reference's skips,
    rollbacks and goodput (the port in float32 on the CPU)."""
    import benchmarks.bench_resilience as jbench
    from repro_torch.benchmarks import bench_resilience

    got = bench_resilience.run_trainer(device="cpu")
    want = jbench.run_trainer()
    for field in ("steps", "fault_steps", "skips", "rollbacks", "goodput"):
        assert got[field] == want[field], field
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-5)
    bench_resilience.check({"guard_overhead": {"guard_overhead_frac": 0.0},
                            "serving": {"goodput_clean": 1.0, "goodput_faulty": 0.5,
                                        "n_injected_nans": 1, "retries": 1},
                            "trainer": got})


def test_bench_training_records_and_mesh_note():
    """The records, and (since mesh data parallelism is ported) the mesh
    ladder over a world of one: one record per mesh config, the sharded
    step bitwise the single-device one."""
    from repro_torch.benchmarks import bench_training

    out = bench_training.run(device="cpu", configs=(("full", 8, 1), ("reversible", 8, 2)),
                             k_sweep=(2, 4), n_steps=4,
                             mesh_configs=(("reversible", 8, 1), ("full", 8, 2)))
    assert [(r["adjoint"], r["microbatches"], r["steps_per_call"]) for r in out["records"]] \
        == [("full", 1, 2), ("full", 1, 4), ("reversible", 2, 2), ("reversible", 2, 4)]
    assert all(r["graphed"] is False and r["us_per_step_scanned"] > 0
               for r in out["records"])
    assert [(r["adjoint"], r["microbatches"], r["world_size"]) for r in out["mesh_records"]] \
        == [("reversible", 1, 1), ("full", 2, 1)]
    assert all(r["grads_bitwise_vs_single"] and r["us_per_step_sharded"] > 0
               for r in out["mesh_records"])
    assert "A14b" not in out["mesh_note"] and "world of 1" in out["mesh_note"]
    assert out["device"] == {"platform": "cpu"}
