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
from repro_torch.benchmarks import general_variants
from repro_torch.benchmarks.stream_variants import VARIANTS
from repro_torch.benchmarks.stream_variants import _edit as _edit_source
from repro_torch.core.williamson import EES25_2N, EES27_2N
from repro_torch.kernels import (AXPY_CHAIN, FLASH_ATTENTION, INCREMENT_DIAG, INCREMENT_GENERAL,
                                 INCREMENT_PRE, KERNELS, SSD_SCAN, WILLIAMSON2N, WS_STAGE_DIAG,
                                 WS_STAGE_DIAG_BWD, WS_STAGE_GENERAL, WS_STAGE_PRE)
from repro_torch.kernels.sde_step import ops as tops
from repro_torch.kernels.sde_step import ref as tref
from repro_torch.kernels.sde_step.ref import ws_stage_diag_ref
from repro_torch.kernels.sde_step import sde_step as sde_step_module
from repro_torch.kernels.sde_step.sde_step import (MAX_INCS, axpy_chain, increment_diag,
                                                   increment_general,
                                                   increment_pre, ws_stage_diag, ws_stage_diag_bwd,
                                                   ws_stage_general, ws_stage_pre)
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


# -- the prediffused and general-noise variants ---------------------------------
#
# Twins and ops against the reference's twins and its Pallas kernels in
# interpret mode.  Tolerance NEW_TOL (defined below): the port's general
# twins sum g@dW left to right where the reference's einsum / dot_general
# may sum in another order, and XLA may contract the interpreted bodies'
# multiply-adds into FMAs.

GENERAL_SHAPES = [((5,), 3), ((4, 8), 2), ((3, 2, 16), 128)]


def _variant_inputs(noise, n_state, batch_d, m, dtype, seed):
    """State operands (n_state of them), then g (None for prediffused) and
    dW (the pre-weighted w for prediffused), as numpy arrays."""
    rng = np.random.default_rng(seed)
    draw = lambda *s: rng.normal(size=s).astype(NP[dtype])  # noqa: E731
    states = [draw(*batch_d) for _ in range(n_state)]
    if noise == "prediffused":
        return states, None, draw(*batch_d)
    return states, draw(*batch_d, m), draw(*batch_d[:-1], m)


def _near_variant(got, want, g, w, dtype):
    """NEW_TOL, widened for general noise by the bound on reordering an
    m-term sum: ``2 m eps sum_j |g_j w_j|`` per output (scaled by the stage's
    ``|b| <= 1`` and ``|a| <= 1``), since the reference's dot_general may sum
    the channels in another order than the port's left-to-right twin."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = NEW_TOL[dtype]["atol"] + NEW_TOL[dtype]["rtol"] * np.abs(want)
    if g is not None:
        m = g.shape[-1]
        bound = np.einsum("...dm,...m->...d", np.abs(g.astype(np.float64)),
                          np.abs(w.astype(np.float64)))
        tol = tol + 2 * m * np.finfo(NP[dtype]).eps * bound
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want) - tol)


@pytest.mark.parametrize("noise", ["general", "prediffused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch_d,m", GENERAL_SHAPES)
def test_stage_variants_match_interpret_kernel(noise, dtype, batch_d, m):
    a, b = COEFFS[1]
    (d, y, f), g, w = _variant_inputs(noise, 3, batch_d, m, dtype, seed=31)
    jg = None if g is None else jnp.asarray(g)
    jx = [jnp.asarray(x) for x in (d, y, f)]
    want = jops.fused_ws_stage(*jx, jg, jnp.asarray(w), 0.25, a=a, b=b,
                               noise=noise, interpret=True)
    want_ref = (jref.ws_stage_pre_ref(*jx, jnp.asarray(w), 0.25, a, b)
                if noise == "prediffused" else
                jref.ws_stage_general_ref(*jx, jg, jnp.asarray(w), 0.25, a, b))
    tx = [torch.from_numpy(x) for x in (d, y, f)]
    tg = None if g is None else torch.from_numpy(g)
    got = tops.fused_ws_stage(*tx, tg, torch.from_numpy(w), 0.25, a=a, b=b,
                              noise=noise)
    twin = (tref.ws_stage_pre_ref(*tx, torch.from_numpy(w), 0.25, a, b)
            if noise == "prediffused" else
            tref.ws_stage_general_ref(*tx, tg, torch.from_numpy(w), 0.25, a, b))
    for gt, t, wk, wr in zip(got, twin, want, want_ref):
        assert torch.equal(gt, t)  # the CPU op is the twin
        _near_variant(gt.numpy(), wk, g, w, dtype)
        _near_variant(gt.numpy(), wr, g, w, dtype)


@pytest.mark.parametrize("noise", ["general", "prediffused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch_d,m", GENERAL_SHAPES)
def test_increment_variants_match_interpret_kernel(noise, dtype, batch_d, m):
    (f,), g, w = _variant_inputs(noise, 1, batch_d, m, dtype, seed=32)
    jg = None if g is None else jnp.asarray(g)
    want = jops.fused_increment(jnp.asarray(f), jg, jnp.asarray(w), 0.25,
                                noise=noise, interpret=True)
    want_ref = (jref.increment_pre_ref(jnp.asarray(f), jnp.asarray(w), 0.25)
                if noise == "prediffused" else
                jref.increment_general_ref(jnp.asarray(f), jg, jnp.asarray(w), 0.25))
    tf, tw = torch.from_numpy(f), torch.from_numpy(w)
    tg = None if g is None else torch.from_numpy(g)
    got = tops.fused_increment(tf, tg, tw, 0.25, noise=noise)
    twin = (increment_pre(tf, tw, 0.25) if noise == "prediffused"
            else increment_general(tf, tg, tw, 0.25))
    assert torch.equal(got, twin)
    _near_variant(got.numpy(), want, g, w, dtype)
    _near_variant(got.numpy(), want_ref, g, w, dtype)
    # the pytree layer: prediffused maps over (f, w) with g = None
    tree = tops.tree_increment((tf,), None if tg is None else (tg,), (tw,),
                               0.25, noise=noise)
    assert isinstance(tree, tuple) and torch.equal(tree[0], got)


def test_general_twin_sums_channels_left_to_right():
    """The general twins' g@dW is the explicit left-to-right channel sum the
    kernels repeat (bitwise), and einsum's result to rounding."""
    (f,), g, w = _variant_inputs("general", 1, (6, 5), 7, torch.float32, seed=33)
    tg, tw = torch.from_numpy(g), torch.from_numpy(w)
    acc = tg[..., 0] * tw[..., None, 0]
    for j in range(1, 7):
        acc = acc + tg[..., j] * tw[..., None, j]
    assert torch.equal(tref.gdw_ref(tg, tw), acc)
    torch.testing.assert_close(tref.gdw_ref(tg, tw),
                               torch.einsum("...dm,...m->...d", tg, tw),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("noise", ["general", "prediffused"])
def test_variant_backwards_match_reference(noise):
    """The closed-form VJPs (plain torch, the reference's einsums for general
    noise) against the reference's custom VJPs through its interpret
    kernels, for the increment and the stage (float64)."""
    a, b = COEFFS[0]
    batch_d, m = (4, 6), 3
    (d, y, f), g, w = _variant_inputs(noise, 3, batch_d, m, torch.float64, seed=34)
    rng = np.random.default_rng(35)
    c1, c2 = rng.normal(size=batch_d), rng.normal(size=batch_d)
    prims = [d, y, f] + ([] if g is None else [g]) + [w]

    def split(xs):
        *st, last = xs
        return (st[:3], None, last) if g is None else (st[:3], st[3], last)

    ts = [torch.from_numpy(x).requires_grad_() for x in prims]
    (td, ty, tf), tg, tw = split(ts)
    d2, y2 = tops.fused_ws_stage(td, ty, tf, tg, tw, 0.3, a=a, b=b, noise=noise)
    inc = tops.fused_increment(tf, tg, tw, 0.3, noise=noise)
    loss = ((d2 * torch.from_numpy(c1)).sum() + (y2 * torch.from_numpy(c2)).sum()
            + (inc * torch.from_numpy(c2)).sum())
    got = torch.autograd.grad(loss, ts)

    def jloss(*xs):
        (jd, jy, jf), jg, jw = split(xs)
        jd2, jy2 = jops.fused_ws_stage(jd, jy, jf, jg, jw, 0.3, a=a, b=b,
                                       noise=noise, interpret=True)
        jinc = jops.fused_increment(jf, jg, jw, 0.3, noise=noise, interpret=True)
        return (jnp.sum(jd2 * c1) + jnp.sum(jy2 * c2) + jnp.sum(jinc * c2))

    want = jax.grad(jloss, argnums=tuple(range(len(prims))))(
        *map(jnp.asarray, prims))
    for gt, wt in zip(got, want):
        _near(gt.numpy(), wt, torch.float64)


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
    increment_pre(x, x, 0.5)
    ws_stage_pre(x, x, x, x, 0.5, a=0.5, b=0.5)
    g, w = torch.ones(2, 4, 3), torch.ones(2, 3)
    increment_general(x.view(2, 4), g, w, 0.5)
    ws_stage_general(x.view(2, 4), x.view(2, 4), x.view(2, 4), g, w, 0.5,
                     a=0.5, b=0.5)
    assert [k.launches for k in KERNELS] == before
    meta = lambda n: [torch.ones(2, device="meta")] * n  # noqa: E731
    mg, mw = torch.ones(2, 2, 3, device="meta"), torch.ones(2, 3, device="meta")
    for call in (lambda: ws_stage_diag(*meta(5), 0.5, a=0.5, b=0.5),
                 lambda: williamson2n(*meta(3), a=0.5, b=0.5),
                 lambda: ws_stage_diag_bwd(*meta(4), 0.5, a=0.5, b=0.5),
                 lambda: increment_diag(*meta(3), 0.5),
                 lambda: axpy_chain(*meta(1), meta(2), [0.5, 0.5]),
                 lambda: increment_pre(*meta(2), 0.5),
                 lambda: ws_stage_pre(*meta(4), 0.5, a=0.5, b=0.5),
                 lambda: increment_general(*meta(1), mg, mw, 0.5),
                 lambda: ws_stage_general(*meta(3), mg, mw, 0.5, a=0.5, b=0.5)):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()
    with pytest.raises(ValueError, match="2 increments for 1 coefficients"):
        axpy_chain(x, [x, x], [0.5])


def test_kernels_listed():
    assert {k.name for k in KERNELS} == {
        "ws_stage_diag", "williamson2n", "ws_stage_diag_bwd", "increment_diag",
        "axpy_chain", "increment_pre", "ws_stage_pre", "increment_general",
        "ws_stage_general", "flash_attention", "ssd_scan"}
    for k in (WS_STAGE_DIAG, WILLIAMSON2N, WS_STAGE_DIAG_BWD, INCREMENT_DIAG,
              AXPY_CHAIN, INCREMENT_PRE, WS_STAGE_PRE, INCREMENT_GENERAL,
              WS_STAGE_GENERAL, FLASH_ATTENTION, SSD_SCAN):
        assert k.source.name == f"{k.name}.cu"


def test_kernel_sources_and_build_names():
    # The SDE-step kernels stream their operands (bytes bound them), and so,
    # by a hair, does the SSD scan on TF32 tensor cores (its three-pass
    # products take 69 us against 71 us of bytes at zamba2-7b's layer);
    # attention is bound by its operations.
    op_bound = {"flash_attention"}
    for k in KERNELS:
        assert k.source.exists()
        text = k.source.read_text()
        bound = "Bound: operations" if k.name in op_bound else "Bound: bytes"
        assert "Replaces the TPU kernel" in text and bound in text
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
                                    tuple(0.1 * i for i in range(1, 11))]
                         + [tuple((-1) ** k * (k + 1) / 7 for k in range(s))
                            for s in (2, 3, 5, 6, 7, 8, 9)])
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


@pytest.mark.parametrize("s", [1, 2, 7, 8, 9, 16, 17, 25])
def test_axpy_chain_launch_plan(monkeypatch, s):
    # The wrapper's host side, without a card: one launch per chunk of at
    # most MAX_INCS increments, in order, each through the entry built for
    # its chunk's length and starting from the last launch's output (what
    # keeps a long chain's accumulation order).
    calls = []
    monkeypatch.setattr(sde_step_module, "_on_cuda", lambda name, x: True)
    monkeypatch.setattr(sde_step_module, "is_current", lambda t: True)
    monkeypatch.setattr(sde_step_module, "stream_handle", lambda t: 0)
    monkeypatch.setattr(sde_step_module, "cuda_operands", lambda *ts: list(ts))
    monkeypatch.setattr(AXPY_CHAIN, "launch", lambda fn, *args: calls.append((fn, args)))
    y = torch.zeros(8)
    incs = [torch.full((8,), float(i)) for i in range(s)]
    coeffs = [0.1 * (i + 1) for i in range(s)]
    got = axpy_chain(y, incs, coeffs)
    sizes = [min(MAX_INCS, s - lo) for lo in range(0, s, MAX_INCS)]
    assert [fn for fn, _ in calls] == [f"axpy_chain_f32_s{k}" for k in sizes]
    acc, lo = y.data_ptr(), 0
    for (fn, (y_ptr, out_ptr, n, _, *rest)), k in zip(calls, sizes):
        assert (y_ptr, n) == (acc, 8)
        assert rest == [t.data_ptr() for t in incs[lo:lo + k]] + coeffs[lo:lo + k]
        assert len(AXPY_CHAIN.functions[fn]) == 4 + 2 * k  # y, out, n, stream, incs, coeffs
        acc, lo = out_ptr, lo + k
    assert got.data_ptr() == acc


def test_axpy_chain_entries_match_the_source():
    import re
    text = AXPY_CHAIN.source.read_text()
    assert f"constexpr int kMaxIncs = {MAX_INCS};" in text
    built = {int(k) for k in re.findall(r"^REPRO_AXPY_ENTRIES\((\d+)\)$", text, re.M)}
    assert built == set(range(1, MAX_INCS + 1))
    assert set(AXPY_CHAIN.functions) == {f"axpy_chain_{sfx}_s{k}" for sfx in ("f32", "f64")
                                         for k in built}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_stream_variants_edit_the_committed_header(variant):
    # Each design variant of the stream benchmark is one edit of the
    # committed csrc/stream.cuh; an edit that no longer applies raises.
    text = (AXPY_CHAIN.source.parent / "stream.cuh").read_text()
    edited = _edit_source(text, VARIANTS[variant], variant)
    assert (edited == text) == (variant == "committed")


# (m, dtype, aligned, route): rows of at most ROW_ROUTE_MAX_BYTES (64) bytes,
# the first widths past it, and the edges of the staged route's 16-byte
# copies (a row stride off 16 bytes, an unaligned operand).
GENERAL_ROUTE_CASES = [
    (1, torch.float32, True, "row"), (3, torch.float32, True, "row"),
    (4, torch.float32, True, "row"), (8, torch.float32, True, "row"),
    (16, torch.float32, True, "row"), (4, torch.float64, True, "row"),
    (8, torch.float64, True, "row"), (17, torch.float32, True, "row"),
    (20, torch.float32, True, "staged"), (32, torch.float32, True, "staged"),
    (10, torch.float64, True, "staged"), (16, torch.float64, True, "staged"),
    (128, torch.float32, True, "staged"), (128, torch.float64, True, "staged"),
    (132, torch.float32, True, "staged"), (131, torch.float32, True, "row"),
    (129, torch.float64, True, "row"), (128, torch.float32, False, "row"),
    (32, torch.float32, False, "row"), (256, torch.float64, False, "row"),
]


@pytest.mark.parametrize("m,dtype,aligned,route", GENERAL_ROUTE_CASES)
def test_general_route_choice(m, dtype, aligned, route):
    assert sde_step_module.ROW_ROUTE_MAX_BYTES == 64
    assert sde_step_module.general_route(m, dtype, aligned) == route


def test_general_kernels_have_an_entry_per_dtype_and_route():
    for kern, name in ((INCREMENT_GENERAL, "increment_general"),
                       (WS_STAGE_GENERAL, "ws_stage_general")):
        assert set(kern.functions) == {f"{name}_{sfx}{route}" for sfx in ("f32", "f64")
                                       for route in ("", "_staged")}
        assert len({tuple(a) for a in kern.functions.values()}) == 1  # one signature
        text = kern.source.read_text()
        for fn in kern.functions:
            assert f'extern "C" int {fn}(' in text


def test_route_launches_split_entry_counts():
    kern = sde_step_module._general_kernel("increment_general", [])
    kern.entry_launches.update({"increment_general_f32": 3, "increment_general_f64_staged": 2,
                                "increment_general_f32_staged": 4})
    assert sde_step_module.route_launches(kern) == {"row": 3, "staged": 6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 4, 33])
def test_general_sum_from_negative_zero_is_the_twins(dtype, m):
    # The staged route starts each sum at -0.0 and adds every product,
    # g[0]*dW[0] included; the twin starts at g[0]*dW[0].  -0.0 is the
    # additive identity, so the two agree bit for bit, signed zeros, infinities
    # and NaNs included.
    rng = np.random.default_rng(m)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-300])
    g = rng.choice(np.concatenate([special, rng.normal(size=64)]), size=(50, 3, m))
    w = rng.choice(np.concatenate([special, rng.normal(size=64)]), size=(50, m))
    g, w = torch.tensor(g, dtype=dtype), torch.tensor(w, dtype=dtype)
    acc = torch.full((50, 3), -0.0, dtype=dtype)
    for j in range(m):
        acc = acc + g[..., j] * w[..., None, j]
    want = tref.gdw_ref(g, w)
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(acc.view(bits), want.view(bits))


@pytest.mark.parametrize("variant", sorted(general_variants.VARIANTS))
def test_general_variants_edit_the_committed_header(variant):
    # Each design variant of the general-noise harness is one edit of the
    # committed csrc/row_matvec.cuh; an edit that no longer applies raises.
    text = (INCREMENT_GENERAL.source.parent / "row_matvec.cuh").read_text()
    edited = general_variants.edited_header(variant)
    assert (edited == text) == (variant == "committed")


def test_general_term_takes_its_channels():
    from repro_torch.benchmarks import step_kernels as sk
    y = torch.zeros(5, sk.DIM)
    args = sk.term_args("cpu")
    for channels in (sk.N_CHANNELS, 128):
        g = sk.make_term("general", channels=channels).diffusion(0.0, y, args)
        assert g.shape == (5, sk.DIM, channels)
    assert sk.make_term("general").diffusion(0.0, y, args).shape[-1] == sk.N_CHANNELS


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


@pytest.mark.parametrize("op", ["increment", "ws_stage", "axpy_chain", "increment_pre",
                                "ws_stage_pre", "increment_general", "ws_stage_general"])
def test_autograd_functions_pass_gradcheck(op):
    """The closed-form backwards against finite differences (float64)."""
    a, b = COEFFS[1]
    xs = [torch.from_numpy(x).requires_grad_()
          for x in _inputs(5, (3, 4), torch.float64, seed=18)]
    rng = np.random.default_rng(19)
    g3 = torch.from_numpy(rng.normal(size=(3, 4, 2))).requires_grad_()
    w2 = torch.from_numpy(rng.normal(size=(3, 2))).requires_grad_()
    fns = {
        "increment": lambda f, g, w: tops.fused_increment(f, g, w, 0.3, noise="diagonal"),
        "ws_stage": lambda d, y, f, g, w: tops.fused_ws_stage(
            d, y, f, g, w, 0.3, a=a, b=b, noise="diagonal"),
        "axpy_chain": lambda y, k1, k2: tops.fused_axpy_chain(y, [k1, k2], (0.5, -1.5)),
        "increment_pre": lambda f, w: tops.fused_increment(f, None, w, 0.3,
                                                           noise="prediffused"),
        "ws_stage_pre": lambda d, y, f, w: tops.fused_ws_stage(
            d, y, f, None, w, 0.3, a=a, b=b, noise="prediffused"),
        "increment_general": lambda f, g, w: tops.fused_increment(
            f, g, w, 0.3, noise="general"),
        "ws_stage_general": lambda d, y, f, g, w: tops.fused_ws_stage(
            d, y, f, g, w, 0.3, a=a, b=b, noise="general"),
    }
    inputs = {"increment": xs[:3], "ws_stage": xs, "axpy_chain": xs[:3],
              "increment_pre": xs[:2], "ws_stage_pre": xs[:4],
              "increment_general": [xs[0], g3, w2],
              "ws_stage_general": xs[:3] + [g3, w2]}[op]
    assert torch.autograd.gradcheck(fns[op], inputs)


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
