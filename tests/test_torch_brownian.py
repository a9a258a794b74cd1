"""Fixed-grid Brownian drivers and time grids of the port against the
reference (x64 on: float64 grids; float32 draws compared in float32).

Increments share the threefry words exactly; the normal transform differs
by erfinv's last bits (see test_torch_prng), hence the draw tolerances.
Within the port, bulk rows equal per-step draws bitwise, a batch of keys
equals per-key draws bitwise, and a padded path equals the unpadded one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import brownian as jbr
from repro.core.grid import TimeGrid as JGrid
from repro_torch.core import brownian as tbr
from repro_torch.core import prng
from repro_torch.core.grid import TimeGrid
from repro_torch.core.pytree import tree_leaves, tree_map

RTOL = {torch.float32: 1e-5, torch.float64: 1e-11}
JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _tkey(jkey):
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(), (4,), ((3,), (2,))],
                         ids=["scalar", "vector", "tuple"])
def test_bulk_increments_match_reference(dtype, shape):
    k = jax.random.PRNGKey(2)
    jbm = jbr.brownian_path(k, 0.0, 1.5, 6, shape=shape, dtype=JNP[dtype])
    tbm = tbr.brownian_path(_tkey(k), 0.0, 1.5, 6, shape=shape, dtype=dtype)
    jgrid = JGrid.from_path(jbm)
    want = jbm.grid_increments(jgrid.ts)
    got = tbm.grid_increments(torch.zeros(7))
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    [x.numpy() for x in tree_leaves(got)]):
        assert w.shape == g.shape and np.asarray(w).dtype == g.dtype
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("shape", [(5,), ((3,), (2,))], ids=["vector", "tuple"])
def test_bulk_rows_equal_per_step_draws(shape):
    bm = tbr.brownian_path(prng.PRNGKey(8, device="cpu"), 0.0, 1.0, 5, shape=shape)
    bulk = bm.grid_increments(torch.zeros(6))
    for n in range(5):
        row = tree_map(lambda x: x[n], bulk)
        for r, o in zip(tree_leaves(row), tree_leaves(bm.increment(n))):
            assert torch.equal(r, o)


def test_key_batch_equals_per_key_paths():
    keys = prng.split(prng.PRNGKey(4, device="cpu"), 3)
    bulk = tbr.brownian_path(keys, 0.0, 1.0, 4, shape=(2,)).grid_increments(torch.zeros(5))
    assert bulk.shape == (4, 3, 2)
    for i in range(3):
        one = tbr.brownian_path(keys[i], 0.0, 1.0, 4, shape=(2,)).grid_increments(torch.zeros(5))
        assert torch.equal(bulk[:, i], one)


def test_padded_path_equals_unpadded_live_steps():
    key = prng.PRNGKey(6, device="cpu")
    exact = tbr.brownian_path(key, 0.0, 1.25, 5, shape=(3,)).grid_increments(torch.zeros(6))
    padded = tbr.padded_brownian_path(key, 0.0, 0.25, 8, shape=(3,))
    assert torch.equal(padded.grid_increments(torch.zeros(9))[:5], exact)
    assert torch.equal(padded.grid_increments(torch.zeros(9), n_rows=5), exact)
    assert torch.equal(padded.increment(2), exact[2])


def test_grid_length_mismatch_messages():
    k = jax.random.PRNGKey(0)
    jbm = jbr.brownian_path(k, 0.0, 1.0, 4, shape=(2,))
    tbm = tbr.brownian_path(_tkey(k), 0.0, 1.0, 4, shape=(2,))
    with pytest.raises(ValueError) as want:
        jbm.grid_increments(jnp.zeros(6))
    with pytest.raises(ValueError) as got:
        tbm.grid_increments(torch.zeros(6))
    assert str(got.value) == str(want.value)
    jp = jbr.padded_brownian_path(k, 0.0, 0.25, 8, shape=(2,))
    tp_ = tbr.padded_brownian_path(_tkey(k), 0.0, 0.25, 8, shape=(2,))
    with pytest.raises(ValueError) as want:
        jp.grid_increments(jnp.zeros(4))
    with pytest.raises(ValueError) as got:
        tp_.grid_increments(torch.zeros(4))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("t0,t1,n", [(0.0, 1.0, 4), (0.3, 2.0, 7), (-1.0, 0.5, 16)])
def test_uniform_grid_times_equal_reference(t0, t1, n):
    want = np.asarray(JGrid.uniform(t0, t1, n).ts)
    got = TimeGrid.uniform(t0, t1, n, dtype=torch.float64, device="cpu")
    assert (got.ts.numpy() == want).all()
    assert got.uniform_h == (t1 - t0) / n and got.n_live == n


@pytest.mark.parametrize("n_active", [0, 3, 8])
def test_padded_grid_times_equal_reference(n_active):
    want = np.asarray(JGrid.padded_uniform(0.5, 0.25, n_active, 8).ts)
    got = TimeGrid.padded_uniform(0.5, 0.25, n_active, 8, dtype=torch.float64,
                                  device="cpu")
    assert (got.ts.numpy() == want).all()
    assert got.is_padded and got.n_live == n_active and got.t1 == 0.5 + 8 * 0.25
    live = TimeGrid.uniform(0.5, 0.5 + 0.25 * max(n_active, 1), max(n_active, 1),
                            dtype=torch.float64, device="cpu")
    assert torch.equal(got.ts[:n_active + 1], live.ts[:n_active + 1])


def test_grid_validation():
    with pytest.raises(ValueError, match="n_steps >= 1"):
        TimeGrid.uniform(0.0, 1.0, 0, device="cpu")
    with pytest.raises(ValueError, match="n_padded >= 1"):
        TimeGrid.padded_uniform(0.0, 0.1, 0, 0, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        TimeGrid.padded_uniform(0.0, 0.1, 9, 8, device="cpu")
    with pytest.raises(ValueError, match="scalar"):
        TimeGrid.padded_uniform(0.0, 0.1, torch.tensor([1, 2]), 8, device="cpu")


@pytest.mark.parametrize("shape", [(5,), ((3,), (2,))], ids=["vector", "tuple"])
@pytest.mark.parametrize("pass_elements", [1, 7, 40, 1 << 23])
def test_bulk_passes_give_the_same_rows(monkeypatch, shape, pass_elements):
    """The bulk buffer drawn in passes of any size is bitwise the one-pass
    draw (every row is a function of its own fold_in key)."""
    keys = prng.split(prng.PRNGKey(3, device="cpu"), 4)
    bm = tbr.brownian_path(keys, 0.0, 1.0, 9, shape=shape)
    pad = tbr.padded_brownian_path(keys, 0.0, 0.125, 16, shape=shape)
    ts, pts = TimeGrid.from_path(bm).ts, torch.zeros(17)
    whole = (bm.grid_increments(ts), pad.grid_increments(pts, n_rows=11))
    monkeypatch.setattr(tbr, "BULK_PASS_ELEMENTS", pass_elements)
    parts = (bm.grid_increments(ts), pad.grid_increments(pts, n_rows=11))
    for w, p in zip(whole, parts):
        for a, b in zip(tree_leaves(w), tree_leaves(p)):
            assert a.shape == b.shape and torch.equal(a, b)


def test_bulk_passes_are_freed_as_they_are_copied(monkeypatch):
    """Each pass of a bulk draw is released once copied into the buffer, so
    a long realization holds its buffer plus one pass (no pass waits for the
    cyclic collector)."""
    import gc
    import weakref

    passes = []
    draw = tbr._draw

    def spy(*args):
        out = draw(*args)
        passes.append(weakref.ref(out))
        return out

    monkeypatch.setattr(tbr, "_draw", spy)
    monkeypatch.setattr(tbr, "BULK_PASS_ELEMENTS", 2 * 4 * 5)
    keys = prng.split(prng.PRNGKey(3, device="cpu"), 4)
    bm = tbr.brownian_path(keys, 0.0, 1.0, 9, shape=(5,))
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        out = bm.grid_increments(TimeGrid.from_path(bm).ts)
        assert len(passes) == 5 and out.shape == (9, 4, 5)
        assert all(p() is None for p in passes)
    finally:
        if was_enabled:
            gc.enable()


# -- space-time Levy areas (SRA1's driver queries) --------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(), (4,), ((3,), (2,))],
                         ids=["scalar", "vector", "tuple"])
def test_levy_area_steps_match_reference(dtype, shape):
    """``levy_area_step`` draws from the reference's salted key family: the
    keys and bits are exact, the normals within erfinv's last bits."""
    k = jax.random.PRNGKey(5)
    jbm = jbr.brownian_path(k, 0.0, 1.5, 6, shape=shape, dtype=JNP[dtype])
    tbm = tbr.brownian_path(_tkey(k), 0.0, 1.5, 6, shape=shape, dtype=dtype)
    for n in (0, 3, 5):
        jkey = jax.random.fold_in(jax.random.fold_in(k, jbr._LEVY_SALT), n)
        tkey = prng.fold_in(prng.fold_in(_tkey(k), tbr._LEVY_SALT), n)
        assert (tkey.numpy() == np.asarray(jkey)).all()
        assert (prng.random_bits(tkey, (8,)).numpy().astype(np.uint32)
                == np.asarray(jax.random.bits(jkey, (8,), jnp.uint32))).all()
        for w, g in zip(jax.tree_util.tree_leaves(jbm.levy_area_step(n)),
                        tree_leaves(tbm.levy_area_step(n))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=RTOL[dtype], atol=0)
    want = jbm.grid_levy_increments(JGrid.from_path(jbm).ts)
    got = tbm.grid_levy_increments(torch.zeros(7))
    for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert w.shape == g.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL[dtype], atol=0)
    assert tbr._LEVY_SALT == jbr._LEVY_SALT


def test_levy_bulk_rows_equal_per_step_pairs_and_padding():
    keys = prng.split(prng.PRNGKey(9, device="cpu"), 3)
    bm = tbr.brownian_path(keys, 0.0, 1.25, 5, shape=(2,))
    ts = TimeGrid.from_path(bm).ts
    dws, dhs = bm.grid_levy_increments(ts)
    assert torch.equal(dws, bm.grid_increments(ts))  # W bits untouched
    for n in range(5):
        dw, dh = bm.grid_levy_increment(ts, n)
        assert torch.equal(dws[n], dw) and torch.equal(dhs[n], dh)
    pad = tbr.padded_brownian_path(keys, 0.0, 0.25, 8, shape=(2,))
    grid = TimeGrid.padded_uniform(0.0, 0.25, 5, 8, pad)
    pdw, pdh = grid.levy_increments()
    assert pdw.shape[0] == 5 and torch.equal(pdw, dws) and torch.equal(pdh, dhs)
    assert all(torch.equal(a, b) for a, b in zip(grid.levy_increment(2),
                                                 (dws[2], dhs[2])))


def test_levy_queries_on_grids_without_them_fail_like_the_reference():
    with pytest.raises(ValueError) as want:
        JGrid.uniform(0.0, 1.0, 4).levy_increments()
    with pytest.raises(ValueError) as got:
        TimeGrid.uniform(0.0, 1.0, 4, device="cpu").levy_increments()
    assert str(got.value) == str(want.value)

    class Plain:  # a driver with increments only
        def grid_increment(self, ts, n):
            return ts[n]

    with pytest.raises(ValueError) as want:
        JGrid.uniform(0.0, 1.0, 4, Plain()).levy_increment(0)
    with pytest.raises(ValueError) as got:
        TimeGrid.uniform(0.0, 1.0, 4, Plain(), device="cpu").levy_increment(0)
    assert str(got.value) == str(want.value)
