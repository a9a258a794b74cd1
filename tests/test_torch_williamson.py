"""The port's Williamson 2N coefficients equal the reference's exactly (the
same closed forms in the same float arithmetic)."""
import dataclasses

import numpy as np
import pytest

from repro.core import williamson as ref
from repro_torch.core import williamson as port


@pytest.mark.parametrize("name", ["EES25_2N", "EES27_2N"])
def test_canonical_schemes_equal(name):
    assert dataclasses.astuple(getattr(port, name)) == \
        dataclasses.astuple(getattr(ref, name))


@pytest.mark.parametrize("x", [0.1, 0.3, -0.2, 0.25])
def test_ees25_family_equal(x):
    assert dataclasses.astuple(port.ees25_2n(x)) == \
        dataclasses.astuple(ref.ees25_2n(x))


@pytest.mark.parametrize("x", [1.0, 0.5, -0.5])
def test_inadmissible_x_same_error(x):
    with pytest.raises(ValueError) as e_port:
        port.ees25_2n(x)
    with pytest.raises(ValueError) as e_ref:
        ref.ees25_2n(x)
    assert str(e_port.value) == str(e_ref.value)


@pytest.mark.parametrize("scheme", ["EES25_2N", "EES27_2N"])
def test_conversions_and_bazavov_equal(scheme):
    ls = getattr(ref, scheme)
    a_p, b_p = port.butcher_from_2n(ls.A, ls.B)
    a_r, b_r = ref.butcher_from_2n(ls.A, ls.B)
    assert (a_p, b_p) == (a_r, b_r)
    assert port.bazavov_residuals(a_p, b_p) == ref.bazavov_residuals(a_r, b_r)
    assert port.bazavov_residuals(a_p, b_p) < 1e-14
    assert (port.cf_weights(ls.A, ls.B) == ref.cf_weights(ls.A, ls.B)).all()
    assert port.two_n_from_butcher(np.array(a_p), np.array(b_p)) == \
        ref.two_n_from_butcher(np.array(a_r), np.array(b_r))
