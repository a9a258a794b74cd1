"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
reference's (``repro.train.checkpoint``): the same on-disk layout and leaf
names, so a checkpoint written by either package restores in the other;
restores write in place; ``latest_step`` and ``checkpoint_meta``.

Every comparison is exact: a checkpoint stores the values' bits.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.nsde import init_lsde as jinit_lsde
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro.train import checkpoint as jck
from repro_torch.nsde import lsde_params_from_jax
from repro_torch.optim import adamw, sgd
from repro_torch.train import checkpoint_meta, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train import checkpoint as tck


class OUParams(nn.Module):
    def __init__(self, values):
        super().__init__()
        for name in sorted(values):
            setattr(self, name, nn.Parameter(torch.tensor(values[name])))


def _lsde_pair(seed=0):
    """The reference's LSDE parameters and a trained-looking AdamW state
    (random moments, step 7), and the port's copies of both."""
    jp = jinit_lsde(jax.random.PRNGKey(seed), 1, 4, 8)
    rng = np.random.default_rng(seed)
    jo = jadamw(1e-2).init(jp)
    jo = jo._replace(step=jnp.asarray(7, jnp.int32),
                     mu=jax.tree_util.tree_map(
                         lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), jo.mu),
                     nu=jax.tree_util.tree_map(
                         lambda x: jnp.asarray(rng.random(size=x.shape), jnp.float32), jo.nu))
    tp = lsde_params_from_jax(jp, device="cpu")
    to = adamw(1e-2).init(list(tp.parameters()))
    return (jp, jo), (tp, to)


def _port_leaves(pair):
    p, o = pair
    return [x.detach().numpy() for x in p.parameters()] + [o.step.numpy()] + [
        x.numpy() for x in o.mu + o.nu]


def _ref_leaves_in_port_order(pair):
    """The reference pair's leaves in the port's order: parameters as
    ``parameters()`` lists them, then step, mu, nu."""
    p, o = pair

    def order(tree):
        lay = lambda l: [l["w"], l["b"]]  # noqa: E731
        return (lay(tree["encoder"]) + [x for l in tree["drift"] for x in lay(l)]
                + [x for l in tree["diff"] for x in lay(l)] + lay(tree["readout"]))

    return [np.asarray(x) for x in order(p)] + [np.asarray(o.step)] + [
        np.asarray(x) for x in order(o.mu) + order(o.nu)]


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_leaf_names_and_manifest_equal_the_reference(tmp_path):
    (jp, jo), (tp, to) = _lsde_pair()
    jck.save_checkpoint(str(tmp_path / "ref"), 3, (jp, jo), extra={"steps_per_call": 4})
    save_checkpoint(str(tmp_path / "port"), 3, (tp, to), extra={"steps_per_call": 4})
    want, got = _manifest(str(tmp_path / "ref"), 3), _manifest(str(tmp_path / "port"), 3)
    key = lambda m: sorted((l["name"], tuple(l["shape"]), l["dtype"])  # noqa: E731
                           for l in m["leaves"])
    assert key(got) == key(want)
    assert got["step"] == want["step"] == 3 and got["extra"] == want["extra"]
    assert sorted(os.listdir(tmp_path / "port" / "step_00000003")) == \
        ["host_0.npz", "manifest.json"]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    (jp, jo), _ = _lsde_pair(1)
    jck.save_checkpoint(str(tmp_path), 5, (jp, jo))
    _, (tp, to) = _lsde_pair(2)  # other values, the same structure
    ids = [id(x) for x in list(tp.parameters()) + [to.step] + to.mu + to.nu]
    out = restore_checkpoint(str(tmp_path), 5, (tp, to))
    assert out[0] is tp and out[1] is to
    assert [id(x) for x in list(tp.parameters()) + [to.step] + to.mu + to.nu] == ids
    for a, b in zip(_port_leaves((tp, to)), _ref_leaves_in_port_order((jp, jo))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    (jp, jo), (tp, to) = _lsde_pair(3)
    with torch.no_grad():
        for i, x in enumerate(tp.parameters()):
            x.add_(0.125 * (i + 1))
        to = to._replace(step=torch.tensor(11, dtype=torch.int32))
    save_checkpoint(str(tmp_path), 9, (tp, to))
    assert jck.latest_step(str(tmp_path)) == 9
    restored = jck.restore_checkpoint(str(tmp_path), 9, (jp, jo))
    for a, b in zip(_ref_leaves_in_port_order(restored), _port_leaves((tp, to))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_dict_parameters_and_sgd_state_cross_read(tmp_path):
    """The reference tests' ``{mu, nu, sigma}`` dict against a module with
    those parameters; SGD with momentum (no ``nu``)."""
    values = {"mu": 0.25, "nu": -1.5, "sigma": 0.75}
    jp = {k: jnp.float64(v) for k, v in values.items()}
    jo = jsgd(0.1, momentum=0.9).init(jp)
    jck.save_checkpoint(str(tmp_path / "ref"), 1, (jp, jo))
    tp = OUParams({k: 0.0 for k in values}).double()
    to = sgd(0.1, momentum=0.9).init(list(tp.parameters()))
    restore_checkpoint(str(tmp_path / "ref"), 1, (tp, to))
    assert {n: float(x.detach()) for n, x in tp.named_parameters()} == values
    save_checkpoint(str(tmp_path / "port"), 1, (tp, to))
    back = jck.restore_checkpoint(str(tmp_path / "port"), 1,
                                  ({k: jnp.float64(0) for k in values}, jo))
    assert {k: float(v) for k, v in back[0].items()} == values


def test_round_trip_keeps_every_dtype_bf16_included(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
                  torch.tensor(7, dtype=torch.int32)],
            "c": torch.tensor([0.1], dtype=torch.float64)}
    save_checkpoint(str(tmp_path), 2, tree)
    npz = np.load(tmp_path / "step_00000002" / "host_0.npz")
    assert npz["['b']/[0]"].dtype == np.uint16  # bf16 stored as its bits
    like = {"a": torch.zeros(2, 3), "b": [torch.zeros(2, dtype=torch.bfloat16),
                                         torch.zeros((), dtype=torch.int32)],
            "c": torch.zeros(1, dtype=torch.float64)}
    restore_checkpoint(str(tmp_path), 2, like)
    for x, y in zip(tck._named_leaves(like), tck._named_leaves(tree)):
        assert x[0] == y[0] and x[1].dtype == y[1].dtype and torch.equal(x[1], y[1])
    # the reference reads the port's bf16 back as bf16
    ref = jck.restore_checkpoint(str(tmp_path), 2, {
        "a": jnp.zeros((2, 3), jnp.float32),
        "b": [jnp.zeros(2, jnp.bfloat16), jnp.zeros((), jnp.int32)],
        "c": jnp.zeros(1, jnp.float64)})
    assert ref["b"][0].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(ref["b"][0], np.float32), [1.5, -2.25])


def test_latest_step_and_meta(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    tree = {"w": torch.ones(2)}
    for step in (4, 12, 8):
        save_checkpoint(d, step, tree, extra={"steps_per_call": step // 4})
    os.makedirs(os.path.join(d, "step_00000099.tmp0"))  # a crashed write
    assert latest_step(d) == jck.latest_step(d) == 12
    assert checkpoint_meta(d, 12) == jck.checkpoint_meta(d, 12) == {"steps_per_call": 3}
    save_checkpoint(d, 16, tree)
    assert checkpoint_meta(d, 16) == {}
    # an existing step is kept, the new write discarded (the reference's rule)
    save_checkpoint(d, 16, {"w": torch.zeros(2)})
    like = {"w": torch.full((2,), 5.0)}
    restore_checkpoint(d, 16, like)
    assert torch.equal(like["w"], torch.ones(2))
    assert not any(n.endswith(".tmp0") and n != "step_00000099.tmp0" for n in os.listdir(d))


def test_restore_refuses_missing_leaves_and_non_tensors(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    with pytest.raises(KeyError, match="no leaf"):
        restore_checkpoint(str(tmp_path), 1, {"v": torch.ones(2)})
    with pytest.raises(TypeError, match="writes into tensors"):
        restore_checkpoint(str(tmp_path), 1, {"w": np.ones(2)})


def test_module_names_follow_the_reference_dict_layout():
    """An ``nn.Module`` is its dict of children and parameters; an MLP (a
    module holding only a ModuleList) is that list; an optimizer state's
    per-parameter lists take the parameters' names."""
    (jp, jo), (tp, to) = _lsde_pair()
    got = [n for n, _ in tck._named_leaves((tp, to))]
    assert "[0]/['drift']/[2]/['w']" in got and "[1]/.mu/['readout']/['b']" in got
    assert "[1]/.step" in got and len(got) == len(set(got))
    flat, _ = jax.tree_util.tree_flatten_with_path((jp, jo))
    want = ["/".join(str(k) for k in path) for path, _ in flat]
    assert sorted(got) == sorted(want)
