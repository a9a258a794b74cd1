"""The port's pytree helpers against repro.core.pytree on the same data
(float64: the same elementwise IEEE operations, so results agree exactly)."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pytree as jref
from repro_torch.core import pytree as tp

Pair = collections.namedtuple("Pair", ["u", "v"])


def _trees(seed):
    rng = np.random.default_rng(seed)
    a = {"x": rng.normal(size=(3,)), "yz": (rng.normal(size=(2, 2)),
                                           [rng.normal(size=(4,))])}
    b = {"x": rng.normal(size=(3,)), "yz": (rng.normal(size=(2, 2)),
                                           [rng.normal(size=(4,))])}
    return a, b


def _to(tree, conv):
    return jax.tree_util.tree_map(conv, tree)


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _tp_leaves(tree):
    return [x.numpy() for x in tp.tree_leaves(tree)]


@pytest.mark.parametrize("op", ["add", "sub", "scale", "axpy", "zeros_like",
                                "select_true", "select_false"])
def test_leafwise_ops_equal_reference(op):
    a, b = _trees(0)
    ja, jb = _to(a, jnp.asarray), _to(b, jnp.asarray)
    ta, tb = _to(a, torch.from_numpy), _to(b, torch.from_numpy)
    calls = {
        "add": (lambda: jref.tree_add(ja, jb), lambda: tp.tree_add(ta, tb)),
        "sub": (lambda: jref.tree_sub(ja, jb), lambda: tp.tree_sub(ta, tb)),
        "scale": (lambda: jref.tree_scale(0.3, ja), lambda: tp.tree_scale(0.3, ta)),
        "axpy": (lambda: jref.tree_axpy(-1.7, ja, jb),
                 lambda: tp.tree_axpy(-1.7, ta, tb)),
        "zeros_like": (lambda: jref.tree_zeros_like(ja),
                       lambda: tp.tree_zeros_like(ta)),
        "select_true": (lambda: jref.tree_select(True, ja, jb),
                        lambda: tp.tree_select(torch.tensor(True), ta, tb)),
        "select_false": (lambda: jref.tree_select(False, ja, jb),
                         lambda: tp.tree_select(torch.tensor(False), ta, tb)),
    }
    want, got = calls[op][0](), calls[op][1]()
    assert jax.tree_util.tree_structure(_to(got, lambda x: 0)) == \
        jax.tree_util.tree_structure(_to(want, lambda x: 0))
    for w, g in zip(_np_leaves(want), _tp_leaves(got)):
        assert (w == g).all()


def test_flatten_roundtrip_and_up_to():
    tree = {"b": (torch.ones(2), None, [torch.zeros(1)]), "a": Pair(torch.ones(1), 3)}
    leaves, treedef = tp.tree_flatten(tree)
    assert len(leaves) == 4  # None is an empty node, as in jax
    back = tp.tree_unflatten(treedef, leaves)
    assert isinstance(back["a"], Pair) and back["b"][1] is None
    assert back["a"].v == 3 and torch.equal(back["b"][0], torch.ones(2))
    # flatten_up_to keeps a whole subtree at a leaf position
    _, tdef = tp.tree_flatten((torch.zeros(2), torch.zeros(3)))
    parts = tp.flatten_up_to(tdef, ((1, 2), torch.ones(3)))
    assert parts[0] == (1, 2) and torch.equal(parts[1], torch.ones(3))
    with pytest.raises(ValueError, match="structure mismatch"):
        tp.flatten_up_to(tdef, (torch.zeros(1),))


@pytest.mark.parametrize("threshold", [None, float("inf"), 10.0])
@pytest.mark.parametrize("poison", ["clean", "nan", "inf", "large"])
def test_blowup_matches_reference(threshold, poison):
    y = np.linspace(-1.0, 1.0, 6)
    if poison != "clean":
        y[3] = {"nan": np.nan, "inf": -np.inf, "large": 50.0}[poison]
    tree = (y, {"k": np.arange(3)})  # integer leaves are skipped
    want = bool(jref.tree_blowup(_to(tree, jnp.asarray), threshold))
    got = tp.tree_blowup(_to(tree, torch.from_numpy), threshold)
    assert got.dim() == 0 and bool(got) == want


def test_blowup_keeps_the_batch_axes():
    y = torch.zeros(4, 3)
    y[1, 2] = float("nan")
    y[3, 0] = 1e9
    flags = tp.tree_blowup((y, y[:, :1] * 0), 1e6, batch_dims=1)
    assert flags.tolist() == [False, True, False, True]
    assert tp.tree_blowup(y, None, batch_dims=1).tolist() == [False, True, False, False]


@pytest.mark.parametrize("op", ["tree_flatten", "tree_unflatten", "flatten_up_to",
                                "tree_map", "tree_add"])
def test_helpers_release_their_leaves_without_the_cycle_collector(op):
    """A helper keeps no reference to the tensors it walked once it returns:
    with the cyclic collector off, a leaf dies with its last outside
    reference (a reference cycle would hold device buffers until a
    collection happened to run)."""
    import gc
    import weakref

    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    tree = {"a": (leaf,), "b": [None]}
    treedef = tp.tree_flatten(tree)[1]
    run = {
        "tree_flatten": lambda: tp.tree_flatten(tree),
        "tree_unflatten": lambda: tp.tree_unflatten(treedef, [leaf]),
        "flatten_up_to": lambda: tp.flatten_up_to(treedef, tree),
        "tree_map": lambda: tp.tree_map(lambda x: x, tree),
        "tree_add": lambda: tp.tree_add(tree, tree),
    }[op]
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        out = run()
        del out, tree, leaf, run
        assert ref() is None
    finally:
        if was_enabled:
            gc.enable()
