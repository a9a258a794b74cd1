"""The port's kernel modules against the reference's kernels run as the
reference's own tests run them on the CPU (Pallas interpret mode).

On the CPU each wrapper is its plain torch twin, so these tests hold the twin
and the autograd layer to the reference; tolerances allow a few ulp because
XLA may contract the interpreted kernel body's multiply-adds into FMAs.  The
CUDA kernels themselves are checked against the same twins on the card
(``tests/test_torch_cuda.py`` and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sde_step import ops as jops
from repro.kernels.sde_step import ref as jref
from repro.kernels.sde_step import sde_step as jsk
from repro.kernels.williamson2n.ops import williamson2n_update as jw2n
from repro_torch.core.williamson import EES25_2N, EES27_2N
from repro_torch.kernels import (AXPY_CHAIN, INCREMENT_DIAG, KERNELS, WILLIAMSON2N,
                                 WS_STAGE_DIAG, WS_STAGE_DIAG_BWD)
from repro_torch.kernels.sde_step import ops as tops
from repro_torch.kernels.sde_step import ref as tref
from repro_torch.kernels.sde_step.ref import ws_stage_diag_ref
from repro_torch.kernels.sde_step.sde_step import (axpy_chain, increment_diag, ws_stage_diag,
                                                   ws_stage_diag_bwd)
from repro_torch.kernels.williamson2n.ops import williamson2n_update
from repro_torch.kernels.williamson2n.ref import williamson2n_ref
from repro_torch.kernels.williamson2n.williamson2n import williamson2n

TOL = {torch.float64: dict(rtol=1e-14, atol=1e-14),
       torch.float32: dict(rtol=2e-6, atol=2e-6)}
NP = {torch.float64: np.float64, torch.float32: np.float32}
COEFFS = [(EES25_2N.A[1], EES25_2N.B[1]), (EES27_2N.A[3], EES27_2N.B[3])]


def _inputs(n_in, shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(NP[dtype]) for _ in range(n_in)]


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(33,), (4, 5, 7), (1030,)])
@pytest.mark.parametrize("ab", COEFFS)
def test_ws_stage_matches_interpret_kernel(dtype, shape, ab):
    a, b = ab
    xs = _inputs(5, shape, dtype)
    want = jops.fused_ws_stage(*map(jnp.asarray, xs), 0.25, a=a, b=b,
                               noise="diagonal", interpret=True)
    txs = [torch.from_numpy(x) for x in xs]
    got_op = tops.fused_ws_stage(*txs, 0.25, a=a, b=b, noise="diagonal")
    got_twin = ws_stage_diag_ref(*txs, 0.25, a, b)
    for g, t, w in zip(got_op, got_twin, want):
        assert torch.equal(g, t)  # the CPU op *is* the twin
        _close(g.numpy(), w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(33,), (4, 5, 7)])
@pytest.mark.parametrize("ab", COEFFS)
def test_williamson2n_matches_interpret_kernel(dtype, shape, ab):
    a, b = ab
    xs = _inputs(3, shape, dtype, seed=1)
    want = jw2n(*map(jnp.asarray, xs), a, b, True)
    txs = [torch.from_numpy(x) for x in xs]
    got = williamson2n_update(*txs, a, b)
    for g, t, w in zip(got, williamson2n_ref(*txs, a, b), want):
        assert torch.equal(g, t)
        _close(g.numpy(), w, dtype)


def test_tree_ws_stage_on_tuple_state():
    a, b = COEFFS[0]
    parts = [_inputs(5, s, torch.float64, seed=i) for i, s in enumerate([(3,), (2, 2)])]
    jt = [tuple(jnp.asarray(p[i]) for p in parts) for i in range(5)]
    tt = [tuple(torch.from_numpy(p[i]) for p in parts) for i in range(5)]
    want = jops.tree_ws_stage(*jt, 0.1, a, b, noise="diagonal", interpret=True)
    got = tops.tree_ws_stage(*tt, 0.1, a, b, noise="diagonal")
    assert isinstance(got[0], tuple) and isinstance(got[1], tuple)
    for g_tree, w_tree in zip(got, want):
        for g, w in zip(g_tree, w_tree):
            _close(g.numpy(), w, torch.float64)


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape), rng.normal(size=shape)


@pytest.mark.parametrize("broadcast_g", [False, True])
def test_ws_stage_backward(broadcast_g):
    """Closed-form backward == autograd through the twin == the reference's
    VJP (Pallas backward kernel, interpret mode)."""
    a, b = COEFFS[0]
    shape = (6, 5)
    xs = _inputs(5, shape, torch.float64, seed=3)
    if broadcast_g:
        xs[3] = xs[3][:1]  # one diffusion row for every path
    w1, w2 = _weights(shape, 4)

    def loss(fn, tensors):
        d2, y2 = fn(*tensors)
        return (d2 * torch.from_numpy(w1)).sum() + (y2 * torch.from_numpy(w2)).sum()

    t_op = [torch.from_numpy(x).requires_grad_() for x in xs]
    g_op = torch.autograd.grad(loss(lambda *t: tops.fused_ws_stage(
        *t, 0.3, a=a, b=b, noise="diagonal"), t_op), t_op)
    t_twin = [torch.from_numpy(x).requires_grad_() for x in xs]
    g_twin = torch.autograd.grad(loss(lambda *t: ws_stage_diag_ref(
        *t, 0.3, a, b), t_twin), t_twin)
    for go, gt in zip(g_op, g_twin):
        torch.testing.assert_close(go, gt, rtol=1e-15, atol=1e-15)

    jx = [jnp.asarray(x) for x in xs]
    if broadcast_g:
        jx[3] = jnp.broadcast_to(jx[3], shape)
    _, vjp = jax.vjp(lambda *t: jops.fused_ws_stage(
        *t, 0.3, a=a, b=b, noise="diagonal", interpret=True), *jx)
    want = vjp((jnp.asarray(w1), jnp.asarray(w2)))
    for i, (go, w) in enumerate(zip(g_op, want)):
        w = np.asarray(w)
        if broadcast_g and i == 3:
            w = w.sum(axis=0, keepdims=True)
        _close(go.numpy(), w, torch.float64)


def test_williamson2n_backward():
    a, b = COEFFS[1]
    xs = _inputs(3, (9,), torch.float64, seed=5)
    w1, w2 = _weights((9,), 6)
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    d2, y2 = williamson2n_update(*ts, a, b)
    got = torch.autograd.grad((d2 * torch.from_numpy(w1)).sum()
                              + (y2 * torch.from_numpy(w2)).sum(), ts)
    _, vjp = jax.vjp(lambda *t: jw2n(*t, a, b, True), *map(jnp.asarray, xs))
    for g, w in zip(got, vjp((jnp.asarray(w1), jnp.asarray(w2)))):
        _close(g.numpy(), w, torch.float64)


@pytest.mark.parametrize("noise,kernel", [("general", "ws_stage_general_2d"),
                                          ("prediffused", "ws_stage_pre_2d")])
def test_unported_stage_variants_name_their_kernel(noise, kernel):
    x = torch.zeros(3)
    with pytest.raises(ValueError, match=kernel + ".*not yet ported"):
        tops.fused_ws_stage(x, x, x, x, x, 0.1, a=0.0, b=1.0, noise=noise)


def test_unknown_stage_noise_same_message_as_reference():
    x = torch.zeros(3)
    with pytest.raises(ValueError) as got:
        tops.fused_ws_stage(x, x, x, x, x, 0.1, a=0.0, b=1.0, noise="bogus")
    with pytest.raises(ValueError) as want:
        jops.fused_ws_stage(*[jnp.zeros(3)] * 5, 0.1, a=0.0, b=1.0, noise="bogus")
    assert str(got.value) == str(want.value)


def test_cpu_calls_are_twins_and_launch_nothing():
    before = [k.launches for k in KERNELS]
    x = torch.ones(8)
    ws_stage_diag(x, x, x, x, x, 0.5, a=0.5, b=0.5)
    williamson2n(x, x, x, a=0.5, b=0.5)
    ws_stage_diag_bwd(x, x, x, x, 0.5, a=0.5, b=0.5)
    increment_diag(x, x, x, 0.5)
    axpy_chain(x, [x] * 10, [0.5] * 10)
    assert [k.launches for k in KERNELS] == before
    meta = lambda n: [torch.ones(2, device="meta")] * n  # noqa: E731
    for call in (lambda: ws_stage_diag(*meta(5), 0.5, a=0.5, b=0.5),
                 lambda: williamson2n(*meta(3), a=0.5, b=0.5),
                 lambda: ws_stage_diag_bwd(*meta(4), 0.5, a=0.5, b=0.5),
                 lambda: increment_diag(*meta(3), 0.5),
                 lambda: axpy_chain(*meta(1), meta(2), [0.5, 0.5])):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()
    with pytest.raises(ValueError, match="2 increments for 1 coefficients"):
        axpy_chain(x, [x, x], [0.5])


def test_kernels_listed():
    assert {k.name for k in KERNELS} == {
        "ws_stage_diag", "williamson2n", "ws_stage_diag_bwd", "increment_diag",
        "axpy_chain"}
    for k in (WS_STAGE_DIAG, WILLIAMSON2N, WS_STAGE_DIAG_BWD, INCREMENT_DIAG,
              AXPY_CHAIN):
        assert k.source.name == f"{k.name}.cu"


def test_kernel_sources_and_build_names():
    for k in KERNELS:
        assert k.source.exists()
        text = k.source.read_text()
        assert "Replaces the TPU kernel" in text and "Bound: bytes" in text
        assert k.library_path().name.startswith(f"lib{k.name}-")


# -- increment_diag, ws_stage_diag_bwd, axpy_chain ------------------------------
#
# New twins at 1e-12 (float64) / 1e-6 (float32) relative: the axpy chain
# accumulates left to right where the reference's twin sums the products
# first, and XLA may contract the interpreted kernels' multiply-adds.

NEW_TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12),
           torch.float32: dict(rtol=1e-6, atol=1e-6)}


def _near(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **NEW_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(33,), (4, 5, 7), (1030,)])
def test_increment_matches_reference(dtype, shape):
    xs = _inputs(3, shape, dtype, seed=11)
    jx = list(map(jnp.asarray, xs))
    txs = [torch.from_numpy(x) for x in xs]
    got = tops.fused_increment(*txs, 0.25, noise="diagonal")
    assert torch.equal(got, increment_diag(*txs, 0.25))  # the CPU op is the twin
    assert torch.equal(got, tref.increment_diag_ref(*txs, 0.25))
    _near(got.numpy(), jref.increment_diag_ref(*jx, 0.25), dtype)
    _near(got.numpy(), jops.fused_increment(*jx, 0.25, noise="diagonal",
                                            interpret=True), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(33,), (4, 5, 7)])
@pytest.mark.parametrize("coeffs", [(0.5,), (1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6),
                                    tuple(0.1 * i for i in range(1, 11))])
def test_axpy_chain_matches_reference(dtype, shape, coeffs):
    xs = _inputs(1 + len(coeffs), shape, dtype, seed=12)
    jy, jincs = jnp.asarray(xs[0]), jnp.stack([jnp.asarray(x) for x in xs[1:]])
    ty, tincs = torch.from_numpy(xs[0]), [torch.from_numpy(x) for x in xs[1:]]
    got = tops.fused_axpy_chain(ty, tincs, coeffs)
    assert torch.equal(got, tref.axpy_chain_ref(ty, tincs, coeffs))
    plain = ty
    for c, k in zip(coeffs, tincs):  # the plain tree_axpy chain: c*k + y
        plain = c * k + plain
    assert torch.equal(got, plain)
    _near(got.numpy(), jref.axpy_chain_ref(jy, jincs, coeffs), dtype)
    _near(got.numpy(), jops.fused_axpy_chain(jy, jincs, coeffs, interpret=True), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ab", COEFFS)
def test_ws_stage_bwd_matches_interpret_kernel(dtype, ab):
    """The stage VJP twin against the reference's ws_stage_diag_bwd_2d run in
    interpret mode on (rows, 128) tiles."""
    a, b = ab
    xs = _inputs(4, (16, 128), dtype, seed=13)
    h = 0.25
    want = jsk.ws_stage_diag_bwd_2d(*map(jnp.asarray, xs),
                                    jnp.full((1, 1), h, NP[dtype]), a=a, b=b,
                                    interpret=True)
    txs = [torch.from_numpy(x) for x in xs]
    got = ws_stage_diag_bwd(*txs, h, a=a, b=b)
    for g, t, w in zip(got, tref.ws_stage_diag_bwd_ref(*txs, h, a, b), want):
        assert torch.equal(g, t)
        _near(g.numpy(), w, dtype)


def test_increment_backward_matches_reference():
    xs = _inputs(3, (6, 5), torch.float64, seed=14)
    w = _weights((6, 5), 15)[0]
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    got = torch.autograd.grad((tops.fused_increment(*ts, 0.3, noise="diagonal")
                               * torch.from_numpy(w)).sum(), ts)
    _, vjp = jax.vjp(lambda *t: jops.fused_increment(*t, 0.3, noise="diagonal",
                                                     interpret=True),
                     *map(jnp.asarray, xs))
    for g, want in zip(got, vjp(jnp.asarray(w))):
        _near(g.numpy(), want, torch.float64)


def test_axpy_chain_backward_matches_reference():
    coeffs = (0.5, -0.25, 2.0)
    xs = _inputs(4, (7,), torch.float64, seed=16)
    w = _weights((7,), 17)[0]
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    got = torch.autograd.grad((tops.fused_axpy_chain(ts[0], ts[1:], coeffs)
                               * torch.from_numpy(w)).sum(), ts)
    _, vjp = jax.vjp(lambda y, incs: jops.fused_axpy_chain(y, incs, coeffs,
                                                           interpret=True),
                     jnp.asarray(xs[0]), jnp.stack([jnp.asarray(x) for x in xs[1:]]))
    ct_y, ct_incs = vjp(jnp.asarray(w))
    _near(got[0].numpy(), ct_y, torch.float64)
    for i in range(3):
        _near(got[1 + i].numpy(), ct_incs[i], torch.float64)


@pytest.mark.parametrize("op", ["increment", "ws_stage", "axpy_chain"])
def test_autograd_functions_pass_gradcheck(op):
    """The closed-form backwards against finite differences (float64)."""
    a, b = COEFFS[1]
    xs = [torch.from_numpy(x).requires_grad_()
          for x in _inputs(5, (3, 4), torch.float64, seed=18)]
    fns = {
        "increment": lambda f, g, w: tops.fused_increment(f, g, w, 0.3, noise="diagonal"),
        "ws_stage": lambda d, y, f, g, w: tops.fused_ws_stage(
            d, y, f, g, w, 0.3, a=a, b=b, noise="diagonal"),
        "axpy_chain": lambda y, k1, k2: tops.fused_axpy_chain(y, [k1, k2], (0.5, -1.5)),
    }
    n_in = {"increment": 3, "ws_stage": 5, "axpy_chain": 3}[op]
    assert torch.autograd.gradcheck(fns[op], xs[:n_in])


@pytest.mark.parametrize("noise,kernel", [("general", "increment_general_2d"),
                                          ("prediffused", "increment_pre_2d")])
def test_unported_increment_variants_name_their_kernel(noise, kernel):
    x = torch.zeros(3)
    with pytest.raises(ValueError, match=kernel + ".*not yet ported"):
        tops.fused_increment(x, x, x, 0.1, noise=noise)
    with pytest.raises(ValueError, match=kernel):
        tops.tree_increment((x,), (x,), (x,), 0.1, noise=noise)


def test_tree_axpy_chain_on_tuple_state():
    parts = [_inputs(3, s, torch.float64, seed=20 + i) for i, s in enumerate([(3,), (2, 2)])]
    y = tuple(torch.from_numpy(p[0]) for p in parts)
    incs = [tuple(torch.from_numpy(p[j]) for p in parts) for j in (1, 2)]
    got = tops.tree_axpy_chain(y, incs, (0.5, 2.0))
    want = jops.tree_axpy_chain(tuple(jnp.asarray(p[0]) for p in parts),
                                [tuple(jnp.asarray(p[j]) for p in parts) for j in (1, 2)],
                                (0.5, 2.0), interpret=True)
    assert isinstance(got, tuple)
    for g, w in zip(got, want):
        _near(g.numpy(), w, torch.float64)
    assert tops.tree_axpy_chain(y, [], ()) is y
