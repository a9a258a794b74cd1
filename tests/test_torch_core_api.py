"""The public names of ``repro_torch.core``, ``repro_torch.serving``,
``repro_torch.nsde``, ``repro_torch.train`` and ``repro_torch.data``
against the reference's, and the port's tableaux helpers against the
reference's (float64, exact).

Every name the reference's modules export is exported by the port, except
those still to be ported, listed here with the queue item that brings them
(none now: A16 brought the LM's accumulating train step).  ``repro_torch.train`` re-exports the names of the reference's
``train/trainer.py``, ``checkpoint.py`` and ``fault_tolerance.py`` (the
reference has no ``train/__init__.py``).
"""
import numpy as np
import pytest

import repro.core as jcore
import repro.nsde as jnsde
import repro.serving as jserving
import repro_torch.data as tdata
import repro_torch.train as ttrain
import repro_torch.core as tcore
import repro_torch.nsde as tnsde
import repro_torch.serving as tserving
from repro.core import tableaux as jtab
from repro.data import pipeline as jpipeline
from repro.train import checkpoint as jcheckpoint
from repro.train import fault_tolerance as jfault_tolerance
from repro.train import trainer as jtrainer
from repro_torch.data import pipeline as tpipeline
from repro_torch.train import checkpoint as tcheckpoint
from repro_torch.train import fault_tolerance as tfault_tolerance
from repro_torch.train import trainer as ttrainer
from repro_torch.core import tableaux as ttab

WAITING = {}
# The manifold names ROADMAP A15 brought to core and nsde, held here by name.
A15_CORE = ("CFLowStorageSolver", "CrouchGrossman2", "Euclidean",
            "GeoEulerMaruyama", "Group", "ManifoldSDETerm", "Product", "RKMK2",
            "SO3", "SOn", "SphereAction", "Torus", "cfees25_solver",
            "cfees27_solver")
A15_NSDE = ("init_kuramoto_nsde", "kuramoto_nsde_term", "init_sphere_nsde",
            "sphere_nsde_term", "wrapped_energy_score")
# Names of the other modules still to be ported, by module and item.
MODULE_WAITING = {
    "serving": (jserving, tserving, {}),
    "nsde": (jnsde, tnsde, {}),
    "train.trainer": (jtrainer, ttrainer, {}),
    "train (package) / trainer": (jtrainer, ttrain, {}),
    "train.checkpoint": (jcheckpoint, tcheckpoint, {}),
    "train (package) / checkpoint": (jcheckpoint, ttrain, {}),
    "train.fault_tolerance": (jfault_tolerance, tfault_tolerance, {}),
    "train (package) / fault_tolerance": (jfault_tolerance, ttrain, {}),
    "data.pipeline": (jpipeline, tpipeline, {}),
    "data (package)": (jpipeline, tdata, {}),
}
# The names ROADMAP A14 brought to train, held here by name as well.
A14_NAMES = ("make_scanned_step", "init_scan_counters", "train_loop",
             "TrainLoopConfig", "resilient_train_loop", "ResilienceConfig")
TABLEAUX = ["euler", "heun", "midpoint", "rk3", "rk4", "ees25", "ees27_tableau"]


def _tableau(module, name):
    obj = getattr(module, name)
    return obj() if callable(obj) else obj


def test_core_exports_every_euclidean_name_of_the_reference():
    waiting = set().union(*WAITING.values())
    assert not waiting
    missing = set(jcore.__all__) - set(tcore.__all__)
    assert missing == waiting
    for name in set(jcore.__all__) - waiting:
        assert hasattr(tcore, name), name


def test_the_waiting_names_are_not_exported_yet():
    for names in WAITING.values():
        assert not names & set(tcore.__all__)


@pytest.mark.parametrize("module", sorted(MODULE_WAITING))
def test_module_exports_every_name_of_the_reference(module):
    ref, port, waiting = MODULE_WAITING[module]
    waiting = set().union(*waiting.values())
    assert set(ref.__all__) - set(port.__all__) == waiting
    assert not waiting & set(port.__all__)
    for name in set(ref.__all__) - waiting:
        assert hasattr(port, name), name


@pytest.mark.parametrize("module,name", [(tcore, n) for n in A15_CORE]
                         + [(tnsde, n) for n in A15_NSDE])
def test_the_manifold_names_are_exported(module, name):
    ref = jcore if module is tcore else jnsde
    assert name in module.__all__ and name in ref.__all__
    assert getattr(module, name).__name__ == getattr(ref, name).__name__


@pytest.mark.parametrize("name", A14_NAMES)
def test_train_exports_the_training_pipeline(name):
    assert name in ttrain.__all__ and name in jtrainer.__all__
    assert getattr(ttrain, name) is getattr(ttrainer, name)


def test_tableaux_import_from_core():
    from repro_torch.core import (ees25, ees25_tableau, ees27_tableau, euler,  # noqa: F401
                                  heun, midpoint, rk3, rk4)
    assert ees25 == ees25_tableau(0.1)


@pytest.mark.parametrize("name", TABLEAUX)
def test_tableau_arrays_equal_the_reference(name):
    got, want = _tableau(ttab, name), _tableau(jtab, name)
    for attr in ("a_np", "b_np", "c_np"):
        g, w = getattr(got, attr)(), getattr(want, attr)()
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    assert (got.name, got.order, got.sym_order) == (want.name, want.order, want.sym_order)


@pytest.mark.parametrize("up_to", [1, 2, 3, 4])
@pytest.mark.parametrize("name", TABLEAUX)
def test_order_residuals_equal_the_reference(name, up_to):
    got = ttab.order_residuals(_tableau(ttab, name), up_to)
    want = jtab.order_residuals(_tableau(jtab, name), up_to)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key


def test_ees25_order_two_conditions_hold():
    res = ttab.order_residuals(ttab.ees25, up_to=2)
    assert max(res.values()) < 1e-15
