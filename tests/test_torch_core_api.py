"""The public names of ``repro_torch.core``, ``repro_torch.serving``,
``repro_torch.nsde``, ``repro_torch.train`` and ``repro_torch.data``
against the reference's, the port's tableaux helpers against the
reference's (float64, exact), and the LM kernels' entry points against the
reference's signatures: every keyword of ``flash_attention`` and
``ssd_scan`` is the port's too, and a call written as the reference's own
tests write it (``interpret=True``) runs on the CPU and agrees with the
reference's interpret-mode kernel at ``tests/test_torch_lm_kernels.py``'s
tolerances.

Every name the reference's modules export is exported by the port, except
those still to be ported, listed here with the queue item that brings them
(none now: A16 brought the LM's accumulating train step).  ``repro_torch.train`` re-exports the names of the reference's
``train/trainer.py``, ``checkpoint.py`` and ``fault_tolerance.py`` (the
reference has no ``train/__init__.py``).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.nsde as jnsde
import repro.serving as jserving
import repro_torch.data as tdata
import repro_torch.train as ttrain
import repro_torch.core as tcore
import repro_torch.nsde as tnsde
import repro_torch.serving as tserving
from repro.core import tableaux as jtab
from repro.kernels.flash_attention import flash_attention as jflash_module
from repro.kernels.ssd_scan import ssd_scan as jssd_module
from repro.data import pipeline as jpipeline
from repro.train import checkpoint as jcheckpoint
from repro.train import fault_tolerance as jfault_tolerance
from repro.train import trainer as jtrainer
from repro_torch.data import pipeline as tpipeline
from repro_torch.train import checkpoint as tcheckpoint
from repro_torch.train import fault_tolerance as tfault_tolerance
from repro_torch.train import trainer as ttrainer
from repro_torch.core import tableaux as ttab
from repro_torch.kernels.flash_attention import flash_attention as tflash_module
from repro_torch.kernels.ssd_scan import ssd_scan as tssd_module

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


# -- the LM kernels' entry points (ROADMAP C4) ----------------------------------

KERNEL_ENTRIES = {
    "flash_attention": (jflash_module.flash_attention, tflash_module.flash_attention),
    "ssd_scan": (jssd_module.ssd_scan, tssd_module.ssd_scan),
}


@pytest.mark.parametrize("name", sorted(KERNEL_ENTRIES))
def test_kernel_entry_takes_every_keyword_of_the_reference(name):
    ref, port = KERNEL_ENTRIES[name]
    want = inspect.signature(ref).parameters
    got = inspect.signature(port).parameters
    for param in want.values():
        assert param.name in got, param.name
        assert got[param.name].kind == param.kind, param.name
        if param.kind is param.KEYWORD_ONLY:
            assert got[param.name].default == param.default, param.name


@pytest.mark.parametrize("fn", [tflash_module.flash_attention_bwd, tssd_module.ssd_scan_bwd],
                         ids=lambda f: f.__name__)
def test_backward_entries_take_interpret(fn):
    param = inspect.signature(fn).parameters["interpret"]
    assert param.kind is param.KEYWORD_ONLY and param.default is False


def test_interpret_runs_the_twin_on_any_device():
    """On a device the kernels do not run on (``meta``) the entries raise;
    with ``interpret=True`` they run the plain twins there."""
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tflash_module.flash_attention(q, q, q)
    assert tflash_module.flash_attention(q, q, q, interpret=True).shape == q.shape
    grads = tflash_module.flash_attention_bwd(q, q, q, q, q, interpret=True)
    assert [g.shape for g in grads] == [q.shape] * 3
    x = torch.empty(1, 16, 2, 4, device="meta")
    dt = torch.empty(1, 16, 2, device="meta")
    A = torch.empty(2, device="meta")
    B = torch.empty(1, 16, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tssd_module.ssd_scan(x, dt, A, B, B, chunk=8)
    assert tssd_module.ssd_scan(x, dt, A, B, B, chunk=8, interpret=True).shape == x.shape
    grads = tssd_module.ssd_scan_bwd(x, dt, A, B, B, x, chunk=8, interpret=True)
    assert [g.shape for g in grads] == [x.shape, dt.shape, A.shape, B.shape, B.shape]


@pytest.mark.parametrize("block_q,block_k", [(0, 128), (128, -1), (64.0, 64), (True, 64)])
def test_flash_attention_checks_its_block_sizes(block_q, block_k):
    q = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="positive int"):
        tflash_module.flash_attention(q, q, q, block_q=block_q, block_k=block_k)


def _draws(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in shapes]


# (b, hq, hk, s, d, causal): tests/test_kernels.py's TestFlashAttention shapes
REF_FLASH_CASES = [(2, 4, 2, 256, 64, True), (1, 8, 1, 128, 128, True),
                   (2, 2, 2, 256, 64, False), (1, 4, 4, 384, 32, True)]


@pytest.mark.parametrize("b,hq,hk,s,d,causal", REF_FLASH_CASES)
def test_flash_attention_call_written_for_the_reference(b, hq, hk, s, d, causal):
    q, k, v = _draws(s + d, (b, hq, s, d), (b, hk, s, d), (b, hk, s, d))
    got = tflash_module.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                        interpret=True)
    want = jflash_module.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_flash_attention_block_sizes_leave_the_result_bitwise():
    """tests/test_kernels.py's block sizes: the port's result is the same
    bits whichever the caller names, and within 2e-5 of the reference's
    interpret-mode kernel at its default blocks."""
    q, k, v = map(torch.from_numpy, _draws(30, (1, 2, 256, 64), (1, 2, 256, 64),
                                          (1, 2, 256, 64)))
    base = tflash_module.flash_attention(q, k, v, causal=True, interpret=True)
    for bq, bk in [(64, 64), (128, 64), (64, 128), (256, 256)]:
        got = tflash_module.flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk,
                                            interpret=True)
        assert torch.equal(got, base)
    want = jflash_module.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                         causal=True, interpret=True)
    np.testing.assert_allclose(base.numpy(), np.asarray(want), atol=2e-5)


# (b, l, h, dh, ds, chunk): tests/test_kernels.py's TestSSDScan shapes
REF_SSD_CASES = [(2, 128, 3, 16, 32, 32), (2, 64, 4, 8, 16, 64), (1, 512, 1, 32, 64, 64)]


@pytest.mark.parametrize("b,l,h,dh,ds,chunk", REF_SSD_CASES)
def test_ssd_scan_call_written_for_the_reference(b, l, h, dh, ds, chunk):
    x, dt, a, B, C = _draws(l + h, (b, l, h, dh), (b, l, h), (h,), (b, l, ds), (b, l, ds))
    dt = (np.log1p(np.exp(dt)) * 0.1).astype(np.float32)
    A = (-np.exp(a)).astype(np.float32)
    got = tssd_module.ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=chunk,
                               interpret=True)
    want = jssd_module.ssd_scan(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
