"""The port on the card: the CUDA kernels against their plain twins, the
served and trained paths through them, and dispatch without host syncs.

Every test needs a CUDA device and skips without one.  The file imports no
jax (the GPU machine has none), so it runs there without the suite's
conftest::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The kernels use explicitly rounded multiplies and adds, so they equal their
twins bitwise (tolerance 0), in float32 and float64, on aligned, ragged and
unaligned (offset view) inputs.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.core import PRNGKey, path_keys, prng, sdeint
from repro_torch.core.williamson import EES25_2N, EES27_2N
from repro_torch.kernels import (AXPY_CHAIN, INCREMENT_DIAG, INCREMENT_GENERAL, INCREMENT_PRE,
                                 WILLIAMSON2N, WS_STAGE_DIAG, WS_STAGE_DIAG_BWD, WS_STAGE_GENERAL,
                                 WS_STAGE_PRE, build_kernels)
from repro_torch.kernels.sde_step import ref as sref
from repro_torch.kernels.sde_step.ref import ws_stage_diag_ref
from repro_torch.kernels.sde_step.sde_step import (axpy_chain, increment_diag, increment_general,
                                                   increment_pre, ws_stage_diag, ws_stage_diag_bwd,
                                                   ws_stage_general, ws_stage_pre)
from repro_torch.kernels.williamson2n.ref import williamson2n_ref
from repro_torch.kernels.williamson2n.williamson2n import williamson2n
from repro_torch.nsde import init_lsde, lsde_readout, lsde_term, moment_mse
from repro_torch.optim import adamw
from repro_torch.serving import BucketKey, SDESampleConfig, SDESampleEngine
from repro_torch.train import make_sde_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    build_kernels()
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offset", [(1 << 20, 0), (1_000_003, 0), (4099, 1)])
@pytest.mark.parametrize("ab", [(EES25_2N.A[1], EES25_2N.B[1]),
                                (EES27_2N.A[3], EES27_2N.B[3])])
def test_kernels_equal_twins(cuda, dtype, n, offset, ab):
    a, b = ab
    gen = torch.Generator(device=cuda).manual_seed(n)
    xs = [torch.randn(n + offset, generator=gen, device=cuda, dtype=dtype)[offset:]
          for _ in range(5)]
    before = WS_STAGE_DIAG.launches
    got = ws_stage_diag(*xs, 0.25, a=a, b=b)
    assert WS_STAGE_DIAG.launches == before + 1
    for g, w in zip(got, ws_stage_diag_ref(*xs, 0.25, a, b)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    before = WILLIAMSON2N.launches
    got = williamson2n(*xs[:3], a=a, b=b)
    assert WILLIAMSON2N.launches == before + 1
    for g, w in zip(got, williamson2n_ref(*xs[:3], a, b)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offset", [(1 << 20, 0), (1_000_003, 0), (4099, 1)])
def test_training_kernels_equal_twins(cuda, dtype, n, offset):
    a, b = EES25_2N.A[2], EES25_2N.B[2]
    gen = torch.Generator(device=cuda).manual_seed(n + 1)
    xs = [torch.randn(n + offset, generator=gen, device=cuda, dtype=dtype)[offset:]
          for _ in range(12)]
    cases = [
        (WS_STAGE_DIAG_BWD, lambda: ws_stage_diag_bwd(*xs[:4], 0.25, a=a, b=b),
         lambda: sref.ws_stage_diag_bwd_ref(*xs[:4], 0.25, a, b)),
        (INCREMENT_DIAG, lambda: (increment_diag(*xs[:3], 0.25),),
         lambda: (sref.increment_diag_ref(*xs[:3], 0.25),)),
        (AXPY_CHAIN, lambda: (axpy_chain(xs[0], xs[1:2], [0.5]),),
         lambda: (sref.axpy_chain_ref(xs[0], xs[1:2], [0.5]),)),
        (AXPY_CHAIN, lambda: (axpy_chain(xs[0], xs[1:5], [1 / 6, 1 / 3, 1 / 3, 1 / 6]),),
         lambda: (sref.axpy_chain_ref(xs[0], xs[1:5], [1 / 6, 1 / 3, 1 / 3, 1 / 6]),)),
    ]
    for kernel, run, twin in cases:
        before = kernel.launches
        got = run()
        assert kernel.launches == before + 1
        for g, w in zip(got, twin()):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    # a chain longer than one launch takes keeps the accumulation order
    coeffs = [0.1 * i for i in range(1, 12)]
    before = AXPY_CHAIN.launches
    got = axpy_chain(xs[0], xs[1:12], coeffs)
    assert AXPY_CHAIN.launches == before + 2
    torch.testing.assert_close(got, sref.axpy_chain_ref(xs[0], xs[1:12], coeffs),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offset", [(1 << 20, 0), (1_000_003, 0), (4099, 1)])
def test_prediffused_kernels_equal_twins(cuda, dtype, n, offset):
    a, b = EES27_2N.A[3], EES27_2N.B[3]
    gen = torch.Generator(device=cuda).manual_seed(n + 2)
    xs = [torch.randn(n + offset, generator=gen, device=cuda, dtype=dtype)[offset:]
          for _ in range(4)]
    cases = [
        (INCREMENT_PRE, lambda: (increment_pre(*xs[:2], 0.25),),
         lambda: (sref.increment_pre_ref(*xs[:2], 0.25),)),
        (WS_STAGE_PRE, lambda: ws_stage_pre(*xs, 0.25, a=a, b=b),
         lambda: sref.ws_stage_pre_ref(*xs, 0.25, a, b)),
    ]
    for kernel, run, twin in cases:
        before = kernel.launches
        got = run()
        assert kernel.launches == before + 1
        for g, w in zip(got, twin()):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,d,m,offset", [(4096, 16, 4, 0), (512, 16, 128, 0),
                                             (1001, 5, 3, 0), (333, 16, 4, 1)])
def test_general_kernels_equal_twins(cuda, dtype, rows, d, m, offset):
    a, b = EES25_2N.A[1], EES25_2N.B[1]
    gen = torch.Generator(device=cuda).manual_seed(rows + m)

    def draw(*shape):
        n = int(np.prod(shape))
        return torch.randn(n + offset, generator=gen, device=cuda,
                           dtype=dtype)[offset:].view(shape)

    delta, y, f = draw(rows, d), draw(rows, d), draw(rows, d)
    g, dW = draw(rows, d, m), draw(rows, m)
    cases = [
        (INCREMENT_GENERAL, lambda: (increment_general(f, g, dW, 0.25),),
         lambda: (sref.increment_general_ref(f, g, dW, 0.25),)),
        (WS_STAGE_GENERAL, lambda: ws_stage_general(delta, y, f, g, dW, 0.25, a=a, b=b),
         lambda: sref.ws_stage_general_ref(delta, y, f, g, dW, 0.25, a, b)),
    ]
    for kernel, run, twin in cases:
        before = kernel.launches
        got = run()
        assert kernel.launches == before + 1
        for gg, w in zip(got, twin()):
            torch.testing.assert_close(gg, w, rtol=0, atol=0)
    # a diffusion broadcast over the paths and leading batch axes
    g_row = draw(d, m)
    got = increment_general(f.view(1, rows, d), g_row, dW.view(1, rows, m), 0.5)
    want = sref.increment_general_ref(f.view(1, rows, d), g_row, dW.view(1, rows, m), 0.5)
    assert got.shape == (1, rows, d)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_stage_backward_runs_the_kernel_on_a_broadcast_diffusion(cuda):
    from repro_torch.kernels.sde_step.ops import fused_ws_stage

    a, b = EES27_2N.A[2], EES27_2N.B[2]
    gen = torch.Generator(device=cuda).manual_seed(5)
    d, y, f, w = [torch.randn(256, 16, generator=gen, device=cuda).requires_grad_()
                  for _ in range(4)]
    g_row = torch.randn(1, 16, generator=gen, device=cuda).requires_grad_()
    before = WS_STAGE_DIAG_BWD.launches
    d2, y2 = fused_ws_stage(d, y, f, g_row.expand(256, 16), w, 0.3, a=a, b=b,
                            noise="diagonal")
    got = torch.autograd.grad((d2 * y2).sum(), [d, y, f, g_row, w])
    assert WS_STAGE_DIAG_BWD.launches == before + 1
    d2r, y2r = ws_stage_diag_ref(d, y, f, g_row, w, 0.3, a, b)
    want = torch.autograd.grad((d2r * y2r).sum(), [d, y, f, g_row, w])
    for g, ww in zip(got, want):
        assert g.shape == ww.shape
        torch.testing.assert_close(g, ww, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spec", ["ees25", "reversible_heun", "mcf-midpoint"])
def test_reversible_train_step_kernels_equal_plain(cuda, spec):
    """One Table-1 training step through the kernels against the same step on
    the plain path, from the same weights and key: the forward is bitwise;
    the backward may sum in another order (1e-6 relative)."""
    weights = init_lsde(0, 1, 16, 32, device=cuda)
    tgt = torch.randn(512, 2, generator=torch.Generator(device=cuda).manual_seed(0),
                      device=cuda)
    out = {}
    for use in (True, False):
        params = copy.deepcopy(weights)
        opt = adamw(1e-2)
        step = make_sde_train_step(
            spec + (":use_kernels=True" if use else ""), lsde_term(), opt,
            y0_fn=lambda p: torch.zeros(16, device=cuda) + p.encoder.b,
            loss_fn_result=lambda p, r: moment_mse(lsde_readout(p, r.ys)[..., 0], tgt),
            t0=0.0, t1=2.0, n_steps=8, n_paths=256, save_every=4, device=cuda)
        before = (WS_STAGE_DIAG_BWD.launches, INCREMENT_DIAG.launches,
                  AXPY_CHAIN.launches)
        params, _, m = step(params, opt.init(list(params.parameters())),
                            prng.PRNGKey(3, device=cuda))
        after = (WS_STAGE_DIAG_BWD.launches, INCREMENT_DIAG.launches,
                 AXPY_CHAIN.launches)
        out[use] = (m, [p.detach() for p in params.parameters()], after != before)
    assert out[True][2] and not out[False][2]
    assert not out[True][0]["skipped"] and torch.isfinite(out[True][0]["loss"])
    torch.testing.assert_close(out[True][0]["loss"], out[False][0]["loss"],
                               rtol=1e-6, atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_noise_specialised_routes_on_the_card(cuda):
    """The prediffused route (additive term, full adjoint) equals the
    diagonal relabel on the plain route bitwise, in float32 on the card;
    general noise through the kernels equals the plain route to 1e-5."""
    from repro_torch.benchmarks import step_kernels as sk
    from repro_torch.core import SDETerm

    args = sk.term_args(cuda)
    keys = path_keys(PRNGKey(3, device=cuda), 2048)
    y0 = torch.ones(sk.DIM, device=cuda)
    add = sk.make_term("prediffused")
    relabel = SDETerm(add.drift, add.diffusion, "diagonal")
    general = sk.make_term("general")

    def run(term, spec, ns=None):
        with torch.no_grad():
            return sdeint(term, spec, 0.0, 1.0, 16, y0, args=args, batch_keys=keys,
                          noise_shape=ns, device=cuda).y_final

    before = [k.launches for k in (WS_STAGE_PRE, INCREMENT_PRE, WS_STAGE_GENERAL,
                                   INCREMENT_GENERAL)]
    assert torch.equal(run(add, "ees25:use_kernels=True"), run(relabel, "ees25"))
    assert torch.equal(run(add, "reversible-heun:use_kernels=True"),
                       run(relabel, "reversible-heun"))
    for spec in ("ees25", "reversible-heun"):
        fused = run(general, spec + ":use_kernels=True", (sk.N_CHANNELS,))
        plain = run(general, spec, (sk.N_CHANNELS,))
        torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-5)
    after = [k.launches for k in (WS_STAGE_PRE, INCREMENT_PRE, WS_STAGE_GENERAL,
                                  INCREMENT_GENERAL)]
    assert all(a > b for a, b in zip(after, before))


def test_kernel_wrappers_reject_mixed_operands(cuda):
    x = torch.ones(8, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        ws_stage_diag(x, x, x, x, x.double(), 0.1, a=0.5, b=0.5)
    with pytest.raises(TypeError, match="float32 or float64"):
        williamson2n(x.half(), x.half(), x.half(), a=0.5, b=0.5)


@pytest.mark.parametrize("spec", ["ees25", "ees27"])
def test_served_kernel_route_equals_plain(cuda, spec):
    params = init_lsde(0, 1, 16, 32, device=cuda)
    keys = path_keys(PRNGKey(3, device=cuda), 1000)
    y0 = torch.linspace(-0.5, 0.5, 16, device=cuda)
    before = WS_STAGE_DIAG.launches
    with torch.no_grad():
        fused = sdeint(lsde_term(), spec + ":use_kernels=True", 0.0, 1.0, 8, y0,
                       args=params, batch_keys=keys, save_every=4, guard=1e6,
                       device=cuda)
        plain = sdeint(lsde_term(), spec, 0.0, 1.0, 8, y0, args=params,
                       batch_keys=keys, save_every=4, guard=1e6, device=cuda)
    assert WS_STAGE_DIAG.launches > before
    assert torch.equal(fused.y_final, plain.y_final) and torch.equal(fused.ys, plain.ys)
    assert not fused.diverged.any()


def test_engine_on_the_card_matches_the_cpu(cuda):
    # one set of weights for both devices (drawn once: CUDA's and the CPU's
    # float32 erfinv would give initial weights that differ in the last bits)
    weights = init_lsde(1, 1, 4, 8, dtype=torch.float64, device="cpu")

    def engine(device):
        params = copy.deepcopy(weights).to(device)
        y0 = torch.linspace(-0.5, 0.5, 4, dtype=torch.float64, device=device)
        eng = SDESampleEngine(lsde_term(), y0, SDESampleConfig(
            slots=8, ticks_per_dispatch=2, dtype=torch.float64), args=params,
            device=device)
        ids = [eng.submit("ees25:use_kernels=True", t1=2.0, n_steps=8, n_paths=20, seed=1),
               eng.submit("ees25:use_kernels=True", t1=1.5, n_steps=6, n_paths=8, seed=2),
               eng.submit("ees27:use_kernels=True", t1=2.0, n_steps=16, n_paths=8,
                          save_every=4, seed=3)]
        with torch.no_grad():
            return ids, eng.run()

    ids, gdone = engine(cuda)
    _, cdone = engine("cpu")
    for rid in ids:
        scale = max(1.0, np.abs(cdone[rid].y_final).max())
        # float64 normals from CUDA's and the CPU's erfinv differ in the last bits
        assert np.abs(gdone[rid].y_final - cdone[rid].y_final).max() / scale < 1e-10


def test_dispatch_does_not_sync_with_the_host(cuda):
    params = init_lsde(0, 1, 16, 32, device=cuda)
    eng = SDESampleEngine(lsde_term(), torch.zeros(16, device=cuda),
                          SDESampleConfig(slots=256), args=params, device=cuda)
    bucket = BucketKey("ees25:use_kernels=True", 0.0, 0.25, 8)
    keys = path_keys(PRNGKey(7, device=cuda), 256)[None]
    with torch.no_grad():
        eng.executor.dispatch(bucket, keys, (8,))  # warm-up outside the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.executor.dispatch(bucket, keys, (5,))
            path_keys(PRNGKey(11, device=cuda), 256)
        finally:
            torch.cuda.set_sync_debug_mode("default")
