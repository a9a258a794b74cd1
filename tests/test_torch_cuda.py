"""The port on the card: the CUDA kernels against their plain twins, the
served and trained paths through them, and dispatch without host syncs.

Every test needs a CUDA device and skips without one.  The file imports no
jax (the GPU machine has none), so it runs there without the suite's
conftest::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The SDE-step kernels use explicitly rounded multiplies and adds, so they
equal their twins bitwise (tolerance 0), in float32 and float64, on aligned,
ragged and unaligned (offset view) inputs.  The LM kernels (flash attention,
the SSD scan) sum in another order than their twins and are held at the
reference's kernel-vs-oracle tolerances.
"""
import collections
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import PRNGKey, path_keys, prng, sdeint
from repro_torch.core.williamson import EES25_2N, EES27_2N
from repro_torch.kernels import (AXPY_CHAIN, FLASH_ATTENTION, FLASH_ATTENTION_BWD,
                                 INCREMENT_DIAG, INCREMENT_GENERAL, INCREMENT_PRE, SSD_SCAN,
                                 SSD_SCAN_BWD, WILLIAMSON2N, WS_STAGE_DIAG, WS_STAGE_DIAG_BWD,
                                 WS_STAGE_GENERAL, WS_STAGE_PRE, build_kernels)
from repro_torch.kernels._build import CudaKernel, build_all, pointer, stream_handle
from repro_torch.kernels.flash_attention.flash_attention import (BWD_ROUTE_LAUNCHES,
                                                                 ROUTE_LAUNCHES, bwd_route,
                                                                 flash_attention,
                                                                 flash_attention_bwd, route)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
from repro_torch.kernels.sde_step import ref as sref
from repro_torch.kernels.sde_step.ref import ws_stage_diag_ref
from repro_torch.kernels.sde_step.sde_step import (MAX_INCS, ROW_ROUTE_MAX_BYTES, axpy_chain,
                                                   general_route, increment_diag,
                                                   increment_general,
                                                   increment_pre, route_launches, ws_stage_diag,
                                                   ws_stage_diag_bwd, ws_stage_general,
                                                   ws_stage_pre)
from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref, ssd_chunked_ref, ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_bwd
from repro_torch.kernels.williamson2n.ref import williamson2n_ref
from repro_torch.kernels.williamson2n.williamson2n import williamson2n
from repro_torch.models import (ModelOptions, forward, init_cache, init_params, loss_fn,
                                make_train_step, serve_step)
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


CHAIN_COEFFS = tuple((-1) ** k * (k + 1) / 7 for k in range(17))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offset", [(4096, 0), (1 << 20, 0), (1_000_003, 0), (4099, 1)])
def test_axpy_chain_every_length_equals_twin(cuda, dtype, n, offset):
    # Every chain length a kernel is built for, and two chains the wrapper
    # splits into consecutive launches: bitwise, through the entries the
    # wrapper's plan names.
    gen = torch.Generator(device=cuda).manual_seed(n + 3)
    xs = [torch.randn(n + offset, generator=gen, device=cuda, dtype=dtype)[offset:]
          for _ in range(18)]
    sfx = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    for s in list(range(1, MAX_INCS + 1)) + [9, 17]:
        before = AXPY_CHAIN.launches
        entries = dict(AXPY_CHAIN.entry_launches)
        got = axpy_chain(xs[0], xs[1:s + 1], CHAIN_COEFFS[:s])
        sizes = [min(MAX_INCS, s - lo) for lo in range(0, s, MAX_INCS)]
        assert AXPY_CHAIN.launches == before + len(sizes)
        for fn, count in collections.Counter(f"axpy_chain_{sfx}_s{k}" for k in sizes).items():
            assert AXPY_CHAIN.entry_launches[fn] - entries.get(fn, 0) == count
        torch.testing.assert_close(
            got, sref.axpy_chain_ref(xs[0], xs[1:s + 1], CHAIN_COEFFS[:s]), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stream_kernels_on_mixed_alignment(cuda, dtype):
    # One operand at an odd offset takes the whole launch to one-element
    # vectors; the results stay the twins'.
    n = (1 << 16) + 3
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(n, generator=gen, device=cuda, dtype=dtype)
    b = torch.randn(n + 1, generator=gen, device=cuda, dtype=dtype)[1:]
    for f, w in ((a, b), (b, a)):
        torch.testing.assert_close(increment_pre(f, w, 0.25),
                                   sref.increment_pre_ref(f, w, 0.25), rtol=0, atol=0)
        torch.testing.assert_close(axpy_chain(f, [w, a], [0.5, -0.25]),
                                   sref.axpy_chain_ref(f, [w, a], [0.5, -0.25]),
                                   rtol=0, atol=0)


# (rows, d, m, offset): the main path's m = 4 and the widths around the
# route threshold (8, 16, 32); m = 128 and 256 with N*d off the staged
# route's tile; m = 132 off its chunk; m = 3, a float32 row stride off 16
# bytes; an unaligned base at m = 4 and 128; d = 1; d wider than a tile.
GENERAL_CASES = [(4096, 16, 4, 0), (4096, 16, 8, 0), (4096, 16, 16, 0), (4096, 16, 32, 0),
                 (512, 16, 128, 0), (1001, 16, 128, 0), (1001, 16, 256, 0),
                 (257, 16, 132, 0), (1001, 5, 3, 0), (333, 16, 4, 1), (300, 16, 128, 1),
                 (5000, 1, 128, 0), (37, 200, 64, 0)]


def _general_operands(cuda, dtype, rows, d, m, offset):
    gen = torch.Generator(device=cuda).manual_seed(rows + m)

    def draw(*shape):
        n = int(np.prod(shape))
        return torch.randn(n + offset, generator=gen, device=cuda,
                           dtype=dtype)[offset:].view(shape)

    return draw, [draw(rows, d), draw(rows, d), draw(rows, d), draw(rows, d, m), draw(rows, m)]


def _run_on_route(kernel, route, run):
    """``run()``'s outputs, asserting it made one launch of ``kernel``, on
    ``route``."""
    before, by_route = kernel.launches, route_launches(kernel)
    got = run()
    after = route_launches(kernel)
    assert kernel.launches == before + 1
    assert {r: after[r] - by_route[r] for r in after} == {
        r: int(r == route) for r in after}
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,d,m,offset", GENERAL_CASES)
def test_general_kernels_equal_twins(cuda, dtype, rows, d, m, offset):
    a, b = EES25_2N.A[1], EES25_2N.B[1]
    draw, (delta, y, f, g, dW) = _general_operands(cuda, dtype, rows, d, m, offset)
    route = general_route(m, dtype, offset == 0)
    assert route == ("row" if offset or m * torch.finfo(dtype).bits // 8 <= ROW_ROUTE_MAX_BYTES
                     or m * torch.finfo(dtype).bits % 128 else "staged")
    cases = [
        (INCREMENT_GENERAL, lambda: (increment_general(f, g, dW, 0.25),),
         lambda: (sref.increment_general_ref(f, g, dW, 0.25),)),
        (WS_STAGE_GENERAL, lambda: ws_stage_general(delta, y, f, g, dW, 0.25, a=a, b=b),
         lambda: sref.ws_stage_general_ref(delta, y, f, g, dW, 0.25, a, b)),
    ]
    for kernel, run, twin in cases:
        got = _run_on_route(kernel, route, run)
        for gg, w in zip(got, twin()):
            torch.testing.assert_close(gg, w, rtol=0, atol=0)
    # a diffusion broadcast over the paths and leading batch axes (materialized,
    # so aligned; dW keeps the case's offset)
    g_row = draw(d, m)
    got = _run_on_route(INCREMENT_GENERAL, route,
                        lambda: increment_general(f.view(1, rows, d), g_row,
                                                  dW.view(1, rows, m), 0.5))
    want = sref.increment_general_ref(f.view(1, rows, d), g_row, dW.view(1, rows, m), 0.5)
    assert got.shape == (1, rows, d)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,d,m", [(4096, 16, 4), (4096, 16, 8), (4096, 16, 16),
                                      (4096, 16, 32), (1001, 16, 128), (257, 16, 132),
                                      (5000, 1, 128), (37, 200, 64)])
def test_general_routes_equal_twins_on_both_sides_of_the_threshold(cuda, dtype, rows, d, m):
    # Each route's C entry called directly, whichever the wrapper would pick:
    # the staged route at the main path's m = 4, the row route at m = 128.
    a, b = EES27_2N.A[2], EES27_2N.B[2]
    _, (delta, y, f, g, dW) = _general_operands(cuda, dtype, rows, d, m, 0)
    sfx = "f32" if dtype == torch.float32 else "f64"
    want_k = sref.increment_general_ref(f, g, dW, 0.25)
    want_d, want_y = sref.ws_stage_general_ref(delta, y, f, g, dW, 0.25, a, b)
    stream = torch.cuda.current_stream().cuda_stream
    for route in ("row", "staged"):
        entry = "" if route == "row" else "_staged"
        out, d_out, y_out = (torch.full_like(f, float("nan")) for _ in range(3))
        _run_on_route(INCREMENT_GENERAL, route, lambda: INCREMENT_GENERAL.launch(
            f"increment_general_{sfx}{entry}", f.data_ptr(), g.data_ptr(), dW.data_ptr(),
            out.data_ptr(), rows, d, m, 0.25, stream))
        _run_on_route(WS_STAGE_GENERAL, route, lambda: WS_STAGE_GENERAL.launch(
            f"ws_stage_general_{sfx}{entry}", delta.data_ptr(), y.data_ptr(), f.data_ptr(),
            g.data_ptr(), dW.data_ptr(), d_out.data_ptr(), y_out.data_ptr(), rows, d, m,
            0.25, a, b, stream))
        for got, want in ((out, want_k), (d_out, want_d), (y_out, want_y)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_general_staged_route_refuses_what_it_cannot_copy(cuda):
    # A row stride off 16 bytes or an unaligned operand is the row route's:
    # the staged entry raises rather than reading past its rows.
    gen = torch.Generator(device=cuda).manual_seed(3)
    f = torch.randn(64, 16, generator=gen, device=cuda)
    out = torch.empty_like(f)
    stream = torch.cuda.current_stream().cuda_stream
    for m, offset in ((3, 0), (128, 1)):
        g = torch.randn(64 * 16 * m + offset, generator=gen, device=cuda)[offset:]
        dW = torch.randn(64 * m, generator=gen, device=cuda)
        with pytest.raises(RuntimeError, match="increment_general kernel launch failed"):
            INCREMENT_GENERAL.launch("increment_general_f32_staged", f.data_ptr(),
                                     g.data_ptr(), dW.data_ptr(), out.data_ptr(), 64, 16,
                                     m, 0.25, stream)


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


# -- the LM kernels ---------------------------------------------------------------

# (b, hq, hkv, s, d, causal, sm_scale): the reference's test shapes
# (tests/test_kernels.py: MQA, GQA group 4, bidirectional, sm_scale 0.5),
# zamba2-7b's shared attention, qwen3-1.7b's GQA and a ragged length; then
# the edges of the wgmma route's 128-row tiles (s = 1, 64, 127, 129, 200)
# at zamba2-7b's and qwen3's head dims, GQA groups 1, 2, 4 and 8, causal
# and bidirectional; and a head dim off TMA's 8-column rule (36: bf16 on the
# SIMT route; float32 takes the mma_tf32 route at every d).
FLASH_CASES = [
    (2, 4, 2, 256, 64, True, None), (1, 8, 1, 128, 128, True, None),
    (2, 2, 2, 256, 64, False, None), (1, 4, 4, 384, 32, True, None),
    (1, 16, 4, 256, 64, True, None), (1, 2, 2, 128, 64, True, 0.5),
    (2, 32, 32, 2048, 112, True, None), (1, 16, 8, 2048, 128, True, None),
    (2, 4, 2, 200, 112, True, None), (2, 4, 2, 200, 16, False, None),
] + [(2, 8, 8 // group, s, d, causal, None)
     for s in (1, 64, 127, 129, 200) for d in (112, 128)
     for group, causal in ((1, True), (2, False), (4, True), (8, False))] + [
    (2, 4, 2, 200, 36, True, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,sm_scale", FLASH_CASES)
def test_flash_attention_matches_twin(cuda, dtype, b, hq, hkv, s, d, causal, sm_scale):
    gen = torch.Generator(device=cuda).manual_seed(s + hq + d)
    q = torch.randn(b, hq, s, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device=cuda).to(dtype) for _ in range(2))
    before = FLASH_ATTENTION.launches
    routes = dict(ROUTE_LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    assert FLASH_ATTENTION.launches == before + 1
    took = ("mma_tf32" if dtype == torch.float32
            else "wgmma" if d % 8 == 0 else "simt")
    assert route(dtype, d) == took
    routes[took] += 1
    assert ROUTE_LAUNCHES == routes
    want = attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    else:
        # both round a float32 result to bfloat16: one bf16 ulp (<= 2^-7 of
        # the value) apart at most, so held elementwise at 8e-3 |want| + 1e-3
        # as well as at the reference's atol 3e-2
        diff = (got.float() - want.float()).abs()
        assert diff.max().item() <= 3e-2
        assert (diff <= 8e-3 * want.float().abs() + 1e-3).all()


@pytest.mark.parametrize("d,offset", [(1, 0), (127, 0), (100, 0), (36, 1), (112, 1)])
def test_flash_attention_float32_odd_rows_and_offset_views(cuda, d, offset):
    """The mma_tf32 route's 4-byte copies: rows whose byte stride is not a
    multiple of 16 (odd d) and views one float past an aligned address."""
    gen = torch.Generator(device=cuda).manual_seed(d + offset)
    b, hq, hkv, s = 2, 4, 2, 129

    def draw(h):
        flat = torch.randn(b * h * s * d + offset, generator=gen, device=cuda)
        return flat[offset:].view(b, h, s, d)

    q, k, v = draw(hq), draw(hkv), draw(hkv)
    assert (q.data_ptr() % 16 != 0) == (offset == 1)
    for causal in (True, False):
        routes = dict(ROUTE_LAUNCHES)
        got = flash_attention(q, k, v, causal=causal)
        routes["mma_tf32"] += 1
        assert ROUTE_LAUNCHES == routes
        torch.testing.assert_close(got, attention_ref(q, k, v, causal=causal), rtol=0,
                                   atol=2e-5)


def _ssd_inputs(b, l, h, dh, ds, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    x = draw(b, l, h, dh)
    dt = torch.nn.functional.softplus(draw(b, l, h)) * 0.1
    A = -torch.exp(draw(h))
    return x, dt, A, draw(b, l, ds), draw(b, l, ds)


# (b, l, h, dh, ds, chunk): the reference's test shapes, zamba2-7b's and
# mamba2-130m's layers at 2048 tokens, then widths off the kernel's 32-wide
# tiles (zero-padded) and rows of 7 and 5 floats (4-byte copies).
SSD_CASES = [(2, 128, 3, 16, 32, 32), (1, 256, 2, 64, 128, 128), (2, 64, 4, 8, 16, 64),
             (1, 512, 1, 32, 64, 64), (2, 2048, 112, 64, 64, 128),
             (1, 2048, 24, 64, 128, 128), (1, 96, 5, 20, 12, 96), (1, 64, 3, 7, 5, 16)]


@pytest.mark.parametrize("b,l,h,dh,ds,chunk", SSD_CASES)
def test_ssd_scan_matches_twin(cuda, b, l, h, dh, ds, chunk):
    xs = _ssd_inputs(b, l, h, dh, ds, cuda, seed=l + h)
    before = SSD_SCAN.launches
    got = ssd_scan(*xs, chunk=chunk)
    assert SSD_SCAN.launches == before + 1
    want = ssd_chunked_ref(*xs, chunk=chunk)[0]
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale
    if l <= 512:  # the sequential recurrence, at the reference's tolerance
        torch.testing.assert_close(got, ssd_ref(*xs)[0], rtol=0, atol=5e-4)


def test_ssd_scan_decay_extremes(cuda):
    x, _, _, B, C = _ssd_inputs(1, 128, 2, 8, 16, cuda, seed=0)
    dt = torch.full((1, 128, 2), 5.0, device=cuda)
    A = torch.tensor([-8.0, -0.001], device=cuda)
    y = ssd_scan(x, dt, A, B, C, chunk=64)
    assert torch.isfinite(y).all()
    twin = ssd_chunked_ref(x, dt, A, B, C, chunk=64)[0]
    seq = ssd_ref(x, dt, A, B, C)[0]
    scale = twin.abs().max().item()  # hundreds: float32 rounds at ~1e-6 of it
    assert (y - twin).abs().max().item() <= 1e-5 * scale
    # The reference's 5e-4 holds its float64 test arrays.  In float32 at
    # |y| ~ 600 the two plain forms themselves part by more than that, so the
    # kernel is held to the chunked twin at 5e-4 and to the recurrence at 5e-4
    # beyond the twins' own spread.
    spread = (twin - seq).abs().max().item()
    assert spread > 5e-4
    torch.testing.assert_close(y, twin, rtol=0, atol=5e-4)
    torch.testing.assert_close(y, seq, rtol=0, atol=5e-4 + spread)


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m", "qwen3-1.7b", "olmo-1b"])
def test_lm_forward_kernels_equal_plain(cuda, arch):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch).smoke()
    params = init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 256), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(0))
    with torch.no_grad():
        before = (FLASH_ATTENTION.launches, SSD_SCAN.launches)
        got, _ = forward(cfg, params, {"tokens": toks})
        launched = (FLASH_ATTENTION.launches - before[0], SSD_SCAN.launches - before[1])
        want, _ = forward(cfg, params, {"tokens": toks}, ModelOptions(use_flash="never"))
    n_attn = {"hybrid": (cfg.n_layers + cfg.shared_attn_every - 1) // max(1, cfg.shared_attn_every),
              "ssm": 0, "dense": cfg.n_layers}[cfg.family]
    n_ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    assert launched == (n_attn, n_ssd)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# (b, hq, hkv, s, d, causal): the reference's test shapes, qwen3-1.7b's GQA,
# a ragged length, odd head dims and zamba2-7b's head dim
FLASH_BWD_CASES = [(2, 4, 2, 256, 64, True), (1, 8, 1, 128, 128, True),
                   (2, 2, 2, 256, 64, False), (1, 16, 8, 512, 128, True),
                   (2, 4, 2, 200, 112, True), (2, 4, 2, 200, 112, False),
                   (1, 4, 2, 130, 1, True), (1, 4, 2, 129, 127, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal", FLASH_BWD_CASES)
def test_flash_attention_bwd_matches_twin(cuda, dtype, b, hq, hkv, s, d, causal):
    """float32 within 1e-5 of each gradient's max|.| of the twin; bf16
    against the twin in float32 on the same bf16 inputs, within one bf16
    rounding (2^-8 |want|) plus 1e-5 of max|.|.  Two runs agree bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn(b, hq, s, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device=cuda).to(dtype) for _ in range(2))
    do = torch.randn(b, hq, s, d, generator=gen, device=cuda).to(dtype)
    out = flash_attention(q, k, v, causal=causal)
    before = FLASH_ATTENTION_BWD.launches
    got = flash_attention_bwd(q, k, v, out, do, causal=causal)
    again = flash_attention_bwd(q, k, v, out, do, causal=causal)
    assert FLASH_ATTENTION_BWD.launches == before + 2
    want = attention_bwd_ref(*(t.float() for t in (q, k, v, out, do)), causal=causal)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape and torch.equal(g, a)
        scale = w.abs().max().item()
        diff = (g.float() - w).abs()
        if dtype == torch.float32:
            assert diff.max().item() <= 1e-5 * scale
        else:
            assert (diff <= 2.0 ** -8 * w.abs() + 1e-5 * scale).all()


@pytest.mark.parametrize("b,l,h,dh,ds,chunk", SSD_CASES[:6] + [(1, 64, 3, 7, 5, 16)])
def test_ssd_scan_bwd_matches_twin(cuda, b, l, h, dh, ds, chunk):
    xs = _ssd_inputs(b, l, h, dh, ds, cuda, seed=l + h + 1)
    dy = torch.randn(b, l, h, dh, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(l))
    before = SSD_SCAN_BWD.launches
    got = ssd_scan_bwd(*xs, dy, chunk=chunk)
    again = ssd_scan_bwd(*xs, dy, chunk=chunk)
    assert SSD_SCAN_BWD.launches == before + 2
    want = ssd_bwd_ref(*xs, dy, chunk=chunk)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def test_ssd_scan_bwd_decay_extremes(cuda):
    x, _, _, B, C = _ssd_inputs(1, 128, 2, 8, 16, cuda, seed=0)
    dt = torch.full((1, 128, 2), 5.0, device=cuda)
    A = torch.tensor([-8.0, -0.001], device=cuda)
    dy = torch.randn_like(x)
    got = ssd_scan_bwd(x, dt, A, B, C, dy, chunk=64)
    want = ssd_bwd_ref(*(t.double() for t in (x, dt, A, B, C, dy)), chunk=64)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g.double() - w).abs().max().item() <= 1e-4 * w.abs().max().item()


# bf16 across the backward's routes (wgmma at d = 112 and 64, SIMT at
# d = 36) and its tiles: lengths off the 64- and 128-row tiles, GQA groups;
# then qwen3-moe-30b-a3b's group of 8 at 2048 tokens, where a whole group's
# sum in one tensor-core accumulator drifted past the gate
FLASH_BWD_ROUTE_CASES = [(2, 4, 2, 200, 112, True), (1, 4, 2, 333, 112, False),
                         (2, 4, 4, 65, 112, True), (1, 8, 2, 190, 64, True),
                         (1, 8, 2, 130, 36, True), (1, 2, 2, 97, 36, False),
                         (1, 32, 4, 2048, 128, True)]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", FLASH_BWD_ROUTE_CASES)
def test_flash_attention_bwd_routes_match_twin(cuda, b, hq, hkv, s, d, causal):
    """Each bf16 route against the float32 twin at phase 3's elementwise
    gate, two runs bitwise equal, the calls counted on the route."""
    gen = torch.Generator(device=cuda).manual_seed(7 * s + d)
    q = torch.randn(b, hq, s, d, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device=cuda).bfloat16() for _ in range(2))
    do = torch.randn(b, hq, s, d, generator=gen, device=cuda).bfloat16()
    out = flash_attention(q, k, v, causal=causal)
    path = bwd_route(torch.bfloat16, d)
    assert path == ("wgmma" if d % 8 == 0 else "simt")
    before = BWD_ROUTE_LAUNCHES[path]
    got = flash_attention_bwd(q, k, v, out, do, causal=causal)
    again = flash_attention_bwd(q, k, v, out, do, causal=causal)
    assert BWD_ROUTE_LAUNCHES[path] == before + 2
    want = attention_bwd_ref(*(t.float() for t in (q, k, v, out, do)), causal=causal)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, a)
        diff = (g.float() - w).abs()
        assert (diff <= 2.0 ** -8 * w.abs() + 1e-5 * w.abs().max()).all()


# (b, l, dh, ds, chunk): head groups that do not divide h (the last group
# short; h is chosen so on the card's SM count), a state dim off the 8-wide
# tiles
SSD_BWD_GROUP_CASES = [(2, 4096, 64, 64, 128), (2, 2048, 32, 44, 64), (4, 1024, 16, 64, 32)]


@pytest.mark.parametrize("b,l,dh,ds,chunk", SSD_BWD_GROUP_CASES)
def test_ssd_scan_bwd_head_groups_match_twin(cuda, b, l, dh, ds, chunk):
    from repro_torch.kernels.ssd_scan.ssd_scan import bwd_heads_per_block, sm_count

    sms = sm_count(cuda)
    h = next(h for h in range(3, 64)
             if h % bwd_heads_per_block(b * (l // chunk), h, ds, sms) > 0)
    xs = _ssd_inputs(b, l, h, dh, ds, cuda, seed=l + h)
    dy = torch.randn(b, l, h, dh, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(h))
    got = ssd_scan_bwd(*xs, dy, chunk=chunk)
    again = ssd_scan_bwd(*xs, dy, chunk=chunk)
    want = ssd_bwd_ref(*xs, dy, chunk=chunk)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


# The chunk states and adjoints as one thread per output forms them: the
# chunk's cum a serial sum, the weights exp(cum_L - cum_s) dt_s (states) or
# exp(cum_t) (adjoints), and sum_t fmaf(w_t v_t[d], m_t[k], acc) in t order;
# then the passes, multiplying by the decay.
_STATES_SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
namespace {
__global__ void outer(const float* dt, const float* A, const float* mat, const float* vec,
                      float* out, float* decay, int64_t blocks, int l, int h, int dh, int ds,
                      int L, bool inc) {
  const int64_t per = static_cast<int64_t>(dh) * ds;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t blk = e / per;  // (batch row, chunk, head)
  if (blk >= blocks) return;
  const int nc = l / L;
  const int d = static_cast<int>(e % per / ds), k = static_cast<int>(e % ds);
  const int hh = static_cast<int>(blk % h), n = static_cast<int>(blk / h % nc);
  const int64_t row0 = blk / (static_cast<int64_t>(h) * nc) * l + static_cast<int64_t>(n) * L;
  const float a = A[hh];
  float c = 0.f;
  for (int t = 0; t < L; ++t) c += a * dt[(row0 + t) * h + hh];
  const float cum_last = c;
  float acc = 0.f;
  c = 0.f;
  for (int t = 0; t < L; ++t) {
    const float dtv = dt[(row0 + t) * h + hh];
    c += a * dtv;
    const float w = inc ? expf(cum_last - c) * dtv : expf(c);
    acc = fmaf(w * vec[((row0 + t) * h + hh) * dh + d], mat[(row0 + t) * ds + k], acc);
  }
  out[e] = acc;
  if (d == 0 && k == 0) decay[blk] = expf(cum_last);
}
__global__ void pass(float* S, const float* decay, int b, int nc, int h, int hds,
                     bool backward) {
  const int64_t per_b = static_cast<int64_t>(h) * hds;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= b * per_b) return;
  const int64_t bi = e / per_b, rem = e % per_b;
  const int hh = static_cast<int>(rem / hds);
  float g = 0.f;
  for (int i = 0; i < nc; ++i) {
    const int n = backward ? nc - 1 - i : i;
    float* p = S + (bi * nc + n) * per_b + rem;
    const float cur = *p;
    *p = g;
    g = fmaf(decay[(bi * nc + n) * h + hh], g, cur);
  }
}
}  // namespace
extern "C" int states_f32(const void* x, const void* dt, const void* A, const void* B,
                          const void* C, const void* dy, void* S, void* G, void* decay, int b,
                          int l, int h, int dh, int ds, int L, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = l / L;
  const int64_t blocks = static_cast<int64_t>(b) * nc * h;
  const unsigned grid = static_cast<unsigned>((blocks * dh * ds + 255) / 256);
  const unsigned pass_grid = static_cast<unsigned>((static_cast<int64_t>(b) * h * dh * ds + 255) / 256);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* decf = static_cast<float*>(decay);
  outer<<<grid, 256, 0, s>>>(dtf, Af, static_cast<const float*>(B),
                             static_cast<const float*>(x), static_cast<float*>(S), decf,
                             blocks, l, h, dh, ds, L, true);
  pass<<<pass_grid, 256, 0, s>>>(static_cast<float*>(S), decf, b, nc, h, dh * ds, false);
  outer<<<grid, 256, 0, s>>>(dtf, Af, static_cast<const float*>(C),
                             static_cast<const float*>(dy), static_cast<float*>(G), decf,
                             blocks, l, h, dh, ds, L, false);
  pass<<<pass_grid, 256, 0, s>>>(static_cast<float*>(G), decf, b, nc, h, dh * ds, true);
  return static_cast<int>(cudaGetLastError());
}
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


@pytest.mark.parametrize("b,l,h,dh,ds,chunk", [(2, 2048, 112, 64, 64, 128),
                                               (1, 2048, 24, 64, 128, 128),
                                               (1, 96, 5, 20, 12, 96), (1, 64, 3, 7, 5, 16)])
def test_ssd_scan_bwd_states_bitwise_to_one_output_a_thread(cuda, tmp_path, b, l, h, dh, ds,
                                                            chunk):
    """The register-tiled outer launches and the passes that carry their
    sums give the chunk states and adjoints bit for bit as one thread per
    output, summing over t in order, gives them."""
    import ctypes

    from repro_torch.kernels.ssd_scan.ssd_scan import KERNEL_BWD, bwd_heads_per_block

    src = tmp_path / "ssd_states_reference.cu"
    src.write_text(_STATES_SOURCE)
    ref = CudaKernel("ssd_states_reference", src,
                     {"states_f32": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p]})
    build_all([ref, KERNEL_BWD])
    x, dt, A, B, C = _ssd_inputs(b, l, h, dh, ds, cuda, seed=b + l + dh)
    dy = torch.randn_like(x)
    nc = l // chunk
    S_ref, G_ref = x.new_empty(b, nc, h, dh, ds), x.new_empty(b, nc, h, dh, ds)
    dec_ref = x.new_empty(b, nc, h)
    ref.launch("states_f32", *(pointer(t) for t in (x, dt, A, B, C, dy, S_ref, G_ref, dec_ref)),
               b, l, h, dh, ds, chunk, stream_handle(x))
    heads = bwd_heads_per_block(b * nc, h, ds, 132)
    S, G, dec = torch.empty_like(S_ref), torch.empty_like(G_ref), torch.empty_like(dec_ref)
    grads = (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A),
             torch.empty_like(B), torch.empty_like(C))
    dBp = x.new_empty(b, l, -(-h // heads), ds)
    KERNEL_BWD.launch("ssd_scan_bwd_f32", *(pointer(t) for t in (
        x, dt, A, B, C, dy, *grads, S, G, dec, dBp, torch.empty_like(dBp),
        x.new_empty(b, nc, h))), b, l, h, dh, ds, chunk, heads, stream_handle(x))
    torch.cuda.synchronize()
    assert torch.equal(dec, dec_ref)
    assert torch.equal(S, S_ref) and torch.equal(G, G_ref)


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m", "qwen3-1.7b", "olmo-1b"])
def test_lm_train_step_kernels_equal_plain(cuda, arch):
    """The loss and its gradients through the kernels (both backward
    kernels launched where the family has the layer) against the plain
    path: loss within 1e-5 relative, each gradient leaf within 1e-4 of the
    larger of its own max|.| and 1% of the largest leaf's (a leaf whose
    gradients are small against the others', such as an SSM's D, sums terms
    far larger than itself); then one ``make_train_step`` on the kernel
    path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch).smoke()
    toks = torch.randint(0, cfg.vocab, (2, 129), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params = init_params(cfg, 0, device=cuda)
    leaves = list(params.parameters())
    runs = []
    for use_flash in ("auto", "never"):
        before = (FLASH_ATTENTION_BWD.launches, SSD_SCAN_BWD.launches)
        loss = loss_fn(cfg, params, batch, ModelOptions(use_flash=use_flash, remat=True))
        grads = torch.autograd.grad(loss, leaves)
        launched = (FLASH_ATTENTION_BWD.launches - before[0],
                    SSD_SCAN_BWD.launches - before[1])
        runs.append((loss.item(), grads, launched))
    (lk, gk, nk), (lp, gp, npl) = runs
    n_attn = {"hybrid": (cfg.n_layers + cfg.shared_attn_every - 1)
              // max(1, cfg.shared_attn_every), "ssm": 0, "dense": cfg.n_layers}[cfg.family]
    n_ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    assert nk == (n_attn, n_ssd) and npl == (0, 0)
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    top = max(b.abs().max().item() for b in gp)
    for a, b in zip(gk, gp):
        assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1e-2 * top)
    opt = adamw(1e-3)
    _, state, m = make_train_step(cfg, opt)(params, opt.init(leaves), batch)
    assert int(state.step) == 1 and bool(torch.isfinite(m["loss"]))


def test_lm_decode_matches_forward_on_the_card(cuda):
    cfg = get_arch("zamba2-7b").smoke()
    params = init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 32), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    with torch.no_grad():
        full, _ = forward(cfg, params, {"tokens": toks})
        cache = init_cache(cfg, 2, 32, device=cuda)
        steps = [serve_step(cfg, params, cache, toks[:, i], i)[0] for i in range(32)]
    torch.testing.assert_close(torch.stack(steps, dim=1), full, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,d,offset", [(65536, 16, 0), (1001, 3, 0), (1001, 3, 1)])
def test_rows_entries_equal_twins(cuda, dtype, rows, d, offset):
    """The per-path-h entries of ws_stage_diag and ws_stage_diag_bwd, h
    varying per row, bitwise to their twins (d = 3: float32 packs straddle
    two paths), one launch of each."""
    from repro_torch.kernels.sde_step.ref import ws_stage_diag_bwd_ref
    from repro_torch.kernels.sde_step.sde_step import rows_launches

    gen = torch.Generator(device=cuda).manual_seed(rows)
    xs = [torch.randn(rows * d + offset, generator=gen, device=cuda,
                      dtype=dtype)[offset:].reshape(rows, d) for _ in range(5)]
    h = torch.rand(rows, 1, generator=gen, device=cuda, dtype=dtype)
    a, b = EES25_2N.A[1], EES25_2N.B[1]
    before = (rows_launches(WS_STAGE_DIAG), rows_launches(WS_STAGE_DIAG_BWD))
    for g, w in zip(ws_stage_diag(*xs, h, a=a, b=b),
                    ws_stage_diag_ref(*xs, h, a, b)):
        assert torch.equal(g, w)
    for g, w in zip(ws_stage_diag_bwd(*xs[:4], h, a=a, b=b),
                    ws_stage_diag_bwd_ref(*xs[:4], h, a, b)):
        assert torch.equal(g, w)
    assert (rows_launches(WS_STAGE_DIAG), rows_launches(WS_STAGE_DIAG_BWD)) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,d,offset", [(65536, 16, 0), (1001, 3, 0), (1001, 3, 1)])
def test_diag_and_pre_rows_entries_equal_twins(cuda, dtype, rows, d, offset):
    """The per-path-h entries of increment_diag, increment_pre and
    ws_stage_pre, h varying per row, bitwise to their twins, one launch of
    each rows entry and none of a scalar one."""
    from repro_torch.kernels import INCREMENT_DIAG, INCREMENT_PRE, WS_STAGE_PRE
    from repro_torch.kernels.sde_step import ref as sref
    from repro_torch.kernels.sde_step.sde_step import (increment_diag, increment_pre,
                                                       rows_launches, ws_stage_pre)

    gen = torch.Generator(device=cuda).manual_seed(rows + 7)
    xs = [torch.randn(rows * d + offset, generator=gen, device=cuda,
                      dtype=dtype)[offset:].reshape(rows, d) for _ in range(4)]
    h = torch.rand(rows, 1, generator=gen, device=cuda, dtype=dtype)
    a, b = EES25_2N.A[1], EES25_2N.B[1]
    kernels = (INCREMENT_DIAG, INCREMENT_PRE, WS_STAGE_PRE)
    before = [(k.launches, rows_launches(k)) for k in kernels]
    cases = [(increment_diag(*xs[:3], h), (sref.increment_diag_ref(*xs[:3], h),)),
             (increment_pre(*xs[:2], h), (sref.increment_pre_ref(*xs[:2], h),)),
             (ws_stage_pre(*xs, h, a=a, b=b), sref.ws_stage_pre_ref(*xs, h, a, b))]
    for got, want in cases:
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert [(k.launches, rows_launches(k)) for k in kernels] == \
        [(n + 1, r + 1) for n, r in before]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,d,m,offset", GENERAL_CASES)
def test_general_rows_entries_equal_twins(cuda, dtype, rows, d, m, offset):
    """The general pair's per-path-h entries on the route general_route
    picks, h varying per path of two rows each (the state (paths, 2, d)),
    bitwise to their twins, one rows launch each."""
    from repro_torch.kernels.sde_step.sde_step import general_route, rows_launches

    _, (delta, y, f, g, dW) = _general_operands(cuda, dtype, rows, d, m, offset)
    paths = rows // 2
    rows = 2 * paths
    view = lambda x, *tail: x[:rows].reshape(paths, 2, *tail)  # noqa: E731
    delta, y, f = (view(x, d) for x in (delta, y, f))
    g, dW = view(g, d, m), view(dW, m)
    h = torch.rand(paths, 1, 1, generator=torch.Generator(device=cuda).manual_seed(m),
                   device=cuda, dtype=dtype)
    a, b = EES25_2N.A[1], EES25_2N.B[1]
    aligned = g.data_ptr() % 16 == 0 and dW.data_ptr() % 16 == 0
    route = general_route(m, dtype, aligned)
    for kern, run, twin in (
            (INCREMENT_GENERAL, lambda: (increment_general(f, g, dW, h),),
             lambda: (sref.increment_general_ref(f, g, dW, h),)),
            (WS_STAGE_GENERAL, lambda: ws_stage_general(delta, y, f, g, dW, h, a=a, b=b),
             lambda: sref.ws_stage_general_ref(delta, y, f, g, dW, h, a, b))):
        n_rows = rows_launches(kern)
        got = _run_on_route(kern, route, run)
        assert rows_launches(kern) == n_rows + 1
        for x, w in zip(got, twin()):
            assert torch.equal(x, w)


@pytest.mark.parametrize("spec,adjoint,donate", [
    ("ees25:use_kernels=True", "reversible", True),
    ("mcf-midpoint:use_kernels=True", "reversible", True),
    ("ees25:use_kernels=True", "full", True),
    ("ees25:use_kernels=True", "reversible", False)])
def test_scanned_step_graph_equals_sequential_steps(cuda, spec, adjoint, donate):
    """K = 4 steps captured into one CUDA graph and replayed twice equal 8
    sequential steps bitwise; the replays launch nothing from Python and
    count their captured launches.  The optimizer state returned is the
    graph's static buffer (donated), or a copy with ``donate=False``."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.train import init_scan_counters, make_scanned_step

    def make():
        params = init_lsde(0, 1, 4, 8, device=cuda)
        tgt = torch.linspace(-1.0, 1.0, 64, device=cuda).reshape(32, 2)
        opt = adamw(1e-2)
        step = make_sde_train_step(
            spec, lsde_term(), opt, y0_fn=lambda p: torch.zeros(4, device=cuda) + p.encoder.b,
            loss_fn_result=lambda p, r: moment_mse(lsde_readout(p, r.ys)[..., 0], tgt),
            t0=0.0, t1=2.0, n_steps=4, n_paths=32, save_every=2, adjoint=adjoint,
            device=cuda)
        return step, params, opt.init(list(params.parameters()))

    key = PRNGKey(3, device=cuda)
    step, params, state = make()
    losses = []
    for i in range(8):
        params, state, m = step(params, state, prng.fold_in(key, i))
        losses.append(m["loss"])
    step_g, params_g, state_g = make()
    scanned = make_scanned_step(step_g, 4, donate=donate)
    counters = init_scan_counters(cuda)
    params_g, state_g, counters, h1 = scanned(params_g, state_g, counters, key, 0)
    host = {k.name: k.host_launches for k in (WS_STAGE_DIAG, WS_STAGE_DIAG_BWD, INCREMENT_DIAG,
                                             AXPY_CHAIN)}
    device = {k.name: k.launches for k in (WS_STAGE_DIAG, WS_STAGE_DIAG_BWD, INCREMENT_DIAG,
                                          AXPY_CHAIN)}
    params_g, state_g, counters, h2 = scanned(params_g, state_g, counters, key, 4)
    torch.cuda.synchronize()
    assert scanned.graphed
    assert torch.equal(torch.stack(losses), torch.cat([h1["loss"], h2["loss"]]))
    for a, b in zip(list(params.parameters()) + tree_leaves(state),
                    list(params_g.parameters()) + tree_leaves(state_g)):
        assert torch.equal(a, b)
    assert int(counters["steps"]) == 8 and int(counters["skipped"]) == 0
    record = scanned.chunk.record.by_kernel()
    assert record
    static_step = scanned.chunk.state[1].step
    assert (state_g.step.data_ptr() == static_step.data_ptr()) == donate
    for k in (WS_STAGE_DIAG, WS_STAGE_DIAG_BWD, INCREMENT_DIAG, AXPY_CHAIN):
        assert k.host_launches == host[k.name]
        assert k.launches == device[k.name] + record.get(k.name, 0)


# -- graphed serving: tick graphs and the decode graph against eager -------------

def _leaves_equal(a, b) -> bool:
    from repro_torch.core.pytree import tree_flatten

    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_graphed_ticks_equal_eager_sdeint_ticks(cuda):
    """A bucketed stack with mixed live counts replayed from two tick graphs
    (the guard's flags among the outputs) is bitwise the eager stack."""
    from repro_torch.core import sdeint_ticks
    from repro_torch.serving import TickExecutor

    params = init_lsde(0, 1, 16, 32, device=cuda)
    y0 = torch.zeros(16, device=cuda)
    ex = TickExecutor(lsde_term(), y0, args=params, guard=1e6, device=cuda)
    bk = BucketKey("ees25:use_kernels=True", 0.0, 0.25, 8)
    live = (8, 6, 8)
    keys = path_keys(PRNGKey(7, device=cuda), 3 * 1024).reshape(3, 1024, 2)
    with torch.no_grad():
        got = ex.dispatch(bk, keys, live)
        want = sdeint_ticks(lsde_term(), bk.solver, 0.0, 2.0, 8, y0, keys, args=params,
                            active_steps=live, step_size=0.25, guard=1e6, device=cuda)
    assert ex.graphed and ex.graph_stats()["graphs"] == 2 and ex.n_replays == 3
    assert _leaves_equal(got, want)


def test_graphed_decode_engine_equals_eager_engine(cuda):
    """The Engine's captured serve_step drains the requests of an eager
    Engine token for token, twice (zamba2's smoke config: SSM states and
    the shared attention's KV rows updated in place by the replays)."""
    from repro_torch.models import make_serve_step
    from repro_torch.serving import Engine
    from repro_torch.serving.engine import _DecodeGraph

    cfg = get_arch("zamba2-7b").smoke()
    params = init_params(cfg, 0, device=cuda)
    prompts = np.random.default_rng(3).integers(2, cfg.vocab, size=(4, 5)).tolist()
    runs = []
    for graphed in (True, False, True):
        eng = Engine(cfg, params)
        if not graphed:
            eng._step = make_serve_step(cfg)
        for p in prompts:
            eng.submit(p)
        runs.append(eng.run(max_ticks=40))
        assert isinstance(eng._step, _DecodeGraph) == graphed
        assert not graphed or eng._step.replays > 0
    assert runs[0] == runs[1] == runs[2]

