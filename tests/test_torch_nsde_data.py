"""The port's synthetic data generators (``repro_torch.nsde.fbm`` and
``repro_torch.nsde.data``) against the reference's, array for array.

Both packages draw from a numpy ``Generator`` in the same order and compute
with the same numpy calls, so the same seed gives the same arrays: held
exactly (``assert_array_equal``).  ``fbm_increments`` is held in each of its
three branches: Brownian motion at ``H = 1/2``, Davies-Harte circulant
embedding, and the Cholesky fallback where the circulant has a negative
eigenvalue.
"""
import numpy as np
import pytest
from numpy.testing import assert_array_equal

from repro.nsde import data as jdata
from repro.nsde import fbm as jfbm
from repro_torch.nsde import data, fbm


def _rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _circulant_min_eig(n, H):
    gamma = fbm._autocov(np.arange(n, dtype=np.float64), H)
    return np.fft.fft(np.concatenate([gamma, [0.0], gamma[-1:0:-1]])).real.min()


@pytest.mark.parametrize("n, H, branch", [
    (64, 0.5, "brownian"), (60, 0.25, "davies-harte"), (33, 0.7, "davies-harte"),
    (2, 0.9, "cholesky")])
def test_fbm_increments_equal_reference(n, H, branch):
    if branch == "cholesky":
        assert _circulant_min_eig(n, H) < -1e-8
    elif branch == "davies-harte":
        assert _circulant_min_eig(n, H) >= -1e-8
    a, b = _rngs(7)
    got = fbm.fbm_increments(a, n, H, T=2.0, batch=5)
    want = jfbm.fbm_increments(b, n, H, T=2.0, batch=5)
    assert got.shape == (5, n)
    assert_array_equal(got, want)
    # the generators were left in the same state
    assert_array_equal(a.standard_normal(3), b.standard_normal(3))


def test_fbm_paths_equal_reference():
    a, b = _rngs(3)
    got = fbm.fbm_paths(a, 40, 0.3, T=1.0, batch=4, dim=3)
    assert got.shape == (4, 41, 3) and not got[:, 0].any()
    assert_array_equal(got, jfbm.fbm_paths(b, 40, 0.3, T=1.0, batch=4, dim=3))


@pytest.mark.parametrize("d", [10, 25])
def test_stiff_gbm_matrix_equals_reference(d):
    a, b = _rngs(1)
    got = data.stiff_gbm_matrix(a, d)
    assert_array_equal(got, jdata.stiff_gbm_matrix(b, d))
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(got)),
                               np.sort(-20.0 * (1.0 + np.arange(d) / d)), rtol=1e-10)


def test_gbm_paths_equal_reference():
    A = data.stiff_gbm_matrix(np.random.default_rng(1), 6)
    a, b = _rngs(4)
    got = data.gbm_paths(a, A, 8, 20, T=1.0, sigma=0.1)
    assert got.shape == (8, 21, 6) and np.isfinite(got).all()
    assert_array_equal(got, jdata.gbm_paths(b, A, 8, 20, T=1.0, sigma=0.1))
    assert_array_equal(data._expm(A * 0.05), jdata._expm(A * 0.05))


def test_rough_vol_paths_equal_reference():
    """Table 2's target: ``rough_vol_paths(default_rng(2), 256, 60, H=0.25)``."""
    a, b = _rngs(2)
    S, v = data.rough_vol_paths(a, 256, 60, T=1.0, H=0.25)
    jS, jv = jdata.rough_vol_paths(b, 256, 60, T=1.0, H=0.25)
    assert S.shape == v.shape == (256, 61)
    assert_array_equal(S, jS)
    assert_array_equal(v, jv)


def test_ou_paths_equal_reference():
    a, b = _rngs(0)
    assert_array_equal(data.ou_paths(a, 16, 5, T=2.0), jdata.ou_paths(b, 16, 5, T=2.0))
