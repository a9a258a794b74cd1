"""The port's sharding rules (``repro_torch.launch.mesh``) against the
reference's (``repro.launch.mesh``): the same spec entries per leaf.

The rules read only ``mesh.shape[axis]``, so a mesh object whose ``shape``
is a dict drives both in this process, with no devices.  The reference's
abstract parameters, optimizer state and decode caches come from
``jax.eval_shape``; the port's are meta tensors of the port's own layout:
its ``init_params`` on the meta device (the weight draws stubbed to empty
tensors of their shapes, which is all a rule reads) through
``abstract_param_tree``, and its ``init_cache`` on the meta device.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import mesh as jmesh
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import init_params as jinit_params
from repro.optim import optimizers as jopt
from repro_torch.configs import get_arch
from repro_torch.core import prng
from repro_torch.launch import mesh as tmesh
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.optim import OptState

ARCHS = ("olmo-1b", "qwen3-1.7b", "zamba2-7b", "olmoe-1b-7b", "mamba2-130m")
MESHES = ({"data": 2, "model": 4}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16})
BATCH, SEQ, CACHE_LEN = 32, 2048, 4096


class _Mesh:
    """What the rules read of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _entries(spec):
    return tuple(spec)


def _flat_ref(tree):
    """(path, PartitionSpec entries) of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(getattr(k, "key", getattr(k, "name", str(k))) for k in path): _entries(s)
            for path, s in leaves}


def _flat_port(tree, path=()):
    if isinstance(tree, tmesh.PartitionSpec):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, path + (k,)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_flat_port(v, path + (k,)))
        return out
    assert tree is None, type(tree)
    return {}


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    cfg = jget_arch(arch)
    params = jax.eval_shape(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    opt_state = jax.eval_shape(jopt.adamw(1e-3).init, params)
    cache = jax.eval_shape(lambda: jinit_cache(cfg, BATCH, CACHE_LEN))
    return params, opt_state, cache


@functools.lru_cache(maxsize=None)
def _port_abstract(arch):
    cfg = get_arch(arch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prng, "normal", lambda key, shape, dtype=torch.float32:
                   torch.empty(shape, dtype=dtype, device=key.device))
        params = tmesh.abstract_param_tree(init_params(cfg, 0, device="meta"))
    meta = lambda x: torch.empty(x.shape, device="meta")  # noqa: E731
    opt_state = OptState(step=torch.empty((), device="meta"),
                         mu=jax.tree_util.tree_map(meta, params),
                         nu=jax.tree_util.tree_map(meta, params))
    return params, opt_state, init_cache(cfg, BATCH, CACHE_LEN, device="meta")


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _flat_leaves(tree).items()}


def _flat_leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(v, path + (k,)))
        return out
    return {} if tree is None else {path: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_have_the_references_layout(arch):
    """The port's meta parameters, in the reference's layout, have the
    reference's paths and shapes (so the rules below see the same leaves)."""
    ref = jax.tree_util.tree_flatten_with_path(_ref_abstract(arch)[0])[0]
    want = {tuple(k.key for k in path): tuple(x.shape) for path, x in ref}
    assert _shapes(_port_abstract(arch)[0]) == want


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m.values())))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_equal_the_references(arch, mesh):
    m = _Mesh(mesh)
    rp, ro, _ = _ref_abstract(arch)
    tp, to, _ = _port_abstract(arch)
    for fsdp in (False, True):
        want = jmesh.param_pspecs(m, rp, fsdp=fsdp)
        got = tmesh.param_pspecs(m, tp, fsdp=fsdp)
        assert _flat_port(got) == _flat_ref(want), fsdp
        for zero1 in (False, True):
            w = jmesh.opt_state_pspecs(m, ro, want, zero1=zero1)
            g = tmesh.opt_state_pspecs(m, to, got, zero1=zero1)
            assert _flat_port(g) == _flat_ref(w), (fsdp, zero1)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m.values())))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_references(arch, mesh):
    m = _Mesh(mesh)
    jbatch = {"tokens": jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32),
              "labels": jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32),
              "loss_mask": jax.ShapeDtypeStruct((BATCH, SEQ), jnp.float32)}
    tbatch = {k: torch.empty(v.shape, device="meta") for k, v in jbatch.items()}
    for seq_shard in (False, True):
        assert (_flat_port(tmesh.batch_pspecs(m, tbatch, seq_shard=seq_shard))
                == _flat_ref(jmesh.batch_pspecs(m, jbatch, seq_shard=seq_shard)))
    _, _, jc = _ref_abstract(arch)
    _, _, tc = _port_abstract(arch)
    for batch in (BATCH, 1):
        assert (_flat_port(tmesh.cache_pspecs(m, tc, batch=batch))
                == _flat_ref(jmesh.cache_pspecs(m, jc, batch=batch))), batch
    assert tmesh.batch_axes(m) == jmesh.batch_axes(m)
    for axis in (None, "model", ("data", "model"), tmesh.batch_axes(m)):
        assert tmesh.axis_size(m, axis) == jmesh.axis_size(m, axis)


def test_heads_that_do_not_divide_fall_back_to_replication():
    """mamba2-130m's 24 heads: on a 4-way model axis its per-head vectors
    (``A_log``, ``dt_bias``, ``D``) and ``wdt``'s head columns shard; on a
    16-way axis they stay replicated, as the reference's ``_safe`` leaves
    them (its vocab, padded to 50432, divides both)."""
    tp = _port_abstract("mamba2-130m")[0]["layers"]["mamba"]
    for model, want in ((4, "model"), (16, None)):
        specs = tmesh.param_pspecs(_Mesh({"data": 2, "model": model}),
                                   {"layers": {"mamba": tp}})["layers"]["mamba"]
        assert [specs[k][1] for k in ("A_log", "dt_bias", "D")] == [want] * 3
        assert specs["wdt"][2] == want
