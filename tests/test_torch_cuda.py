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
from repro_torch.kernels import (AXPY_CHAIN, FLASH_ATTENTION, INCREMENT_DIAG, INCREMENT_GENERAL,
                                 INCREMENT_PRE, SSD_SCAN, WILLIAMSON2N, WS_STAGE_DIAG,
                                 WS_STAGE_DIAG_BWD, WS_STAGE_GENERAL, WS_STAGE_PRE, build_kernels)
from repro_torch.kernels.flash_attention.flash_attention import (ROUTE_LAUNCHES,
                                                                 flash_attention, route)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.sde_step import ref as sref
from repro_torch.kernels.sde_step.ref import ws_stage_diag_ref
from repro_torch.kernels.sde_step.sde_step import (MAX_INCS, ROW_ROUTE_MAX_BYTES, axpy_chain,
                                                   general_route, increment_diag,
                                                   increment_general,
                                                   increment_pre, route_launches, ws_stage_diag,
                                                   ws_stage_diag_bwd, ws_stage_general,
                                                   ws_stage_pre)
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
from repro_torch.kernels.williamson2n.ref import williamson2n_ref
from repro_torch.kernels.williamson2n.williamson2n import williamson2n
from repro_torch.models import ModelOptions, forward, init_cache, init_params, serve_step
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
