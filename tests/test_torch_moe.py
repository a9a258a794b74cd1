"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the CPU, in float32.

The reference's weights (``init_moe``) are carried across leaf by leaf, and
``moe_block``'s output, its aux loss and the gradients of both (every
weight and the input) are held to the reference at atol 2e-5: grouped
routing (``s * k >= experts``), one global group (a decode tick's shape),
and capacity dropping (overflowing experts at ``capacity_factor`` 1.25 and
0.5).  The port's ``init_moe`` draws the reference's weights; one expert at
top-1 is a SwiGLU MLP; top-k ties resolve to the lower expert index, as
``jax.lax.top_k`` resolves them, in ``top_k`` and through the whole block.
The reference runs once per case, in a module fixture.
"""
import dataclasses
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import ModelOptions as JModelOptions
from repro.models.moe import init_moe as jinit_moe
from repro.models.moe import moe_block as jmoe_block
from repro_torch.configs import get_arch
from repro_torch.core import prng
from repro_torch.models import ModelOptions, moe
from repro_torch.models.layers import apply_norm, mlp_block, param_dict

ATOL = 2e-5
# (arch, batch, seq, capacity_factor): grouped routing, the global group of
# a decode tick (s * k < experts), and capacity dropping at two factors
CASES = {
    "grouped": ("olmoe-1b-7b", 2, 16, 64.0),
    "global": ("qwen3-moe-30b-a3b", 3, 1, 1.25),
    "dropping": ("olmoe-1b-7b", 3, 16, 1.25),
    "dropping_hard": ("qwen3-moe-30b-a3b", 2, 12, 0.5),
}


def _cfgs(arch, capacity_factor):
    return (dataclasses.replace(jget_arch(arch).smoke(), capacity_factor=capacity_factor),
            dataclasses.replace(get_arch(arch).smoke(), capacity_factor=capacity_factor))


def _tied_router(d, e):
    """Router columns built so that every token has a top-k tie at the
    boundary: expert 0 leads on v, experts 3 and 6 tie behind it; on -v the
    other five experts tie."""
    v = np.random.default_rng(5).normal(size=d).astype(np.float32)
    cols = np.tile(-v[:, None], (1, e))
    cols[:, 0] = v
    cols[:, 3] = cols[:, 6] = 0.5 * v
    return cols


def _case_inputs(name):
    arch, b, s, cf = CASES[name]
    jcfg, cfg = _cfgs(arch, cf)
    jp = jinit_moe(jcfg, jax.random.PRNGKey(3), jnp.float32)
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    return jcfg, cfg, jp, x, ct


def _reference(jcfg, jp, x, ct):
    """The reference's (out, aux) and the gradients of
    ``sum(out * ct) + 3 * aux`` with respect to the weights and ``x``."""
    def loss(p, xx):
        o, a = jmoe_block(jcfg, p, xx, JModelOptions())
        return jnp.sum(o * ct) + 3.0 * a, (o, a)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    return np.asarray(out), float(aux), {k: np.asarray(v) for k, v in gp.items()
                                         if v is not None}, np.asarray(gx)


@pytest.fixture(scope="module")
def reference():
    out = {}
    for name in CASES:
        jcfg, cfg, jp, x, ct = _case_inputs(name)
        out[name] = (cfg, jp, x, ct, _reference(jcfg, jp, x, ct))
    # the boundary-tie case: olmoe's smoke block with a tied router
    jcfg, cfg = _cfgs("olmoe-1b-7b", 64.0)
    jp = dict(jinit_moe(jcfg, jax.random.PRNGKey(4), jnp.float32))
    jp["router"] = jnp.asarray(_tied_router(cfg.d_model, cfg.n_experts))
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    out["tied"] = (cfg, jp, x, ct, _reference(jcfg, jp, x, ct))
    return out


def _port_params(jp):
    return param_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()
                       if v is not None})


@pytest.mark.parametrize("name", sorted(CASES) + ["tied"])
def test_moe_block_and_its_gradients_match_the_reference(reference, name):
    cfg, jp, x, ct, (want, want_aux, want_gp, want_gx) = reference[name]
    p = _port_params(jp)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_block(cfg, p, xt, ModelOptions())
    assert out.shape == x.shape and out.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(aux.detach()), want_aux, rtol=0, atol=ATOL)
    ((out * torch.from_numpy(ct)).sum() + 3.0 * aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, rtol=0, atol=ATOL)
    assert sorted(p) == sorted(want_gp)
    for k, g in want_gp.items():
        np.testing.assert_allclose(p[k].grad.numpy(), g, rtol=0, atol=ATOL, err_msg=k)


def test_cases_route_as_named(reference):
    """The cases exercise what they are named for: grouped and global
    routing, and tokens dropped at capacity."""
    for name, (cfg, jp, x, _, _) in reference.items():
        b, s, _ = x.shape
        grouped = s * cfg.moe_top_k >= cfg.n_experts
        assert grouped == (name != "global"), name
        n = s if grouped else b * s
        cap = moe._capacity(cfg, n)
        h = apply_norm(cfg.norm, torch.from_numpy(np.array(jp["ln"])),
                           torch.from_numpy(x)).reshape(b if grouped else 1, n, cfg.d_model)
        probs = torch.softmax(h @ torch.from_numpy(np.array(jp["router"])), -1)
        _, idx = moe.top_k(probs, cfg.moe_top_k)
        load = torch.nn.functional.one_hot(idx.reshape(h.shape[0], -1), cfg.n_experts).sum(1)
        assert bool((load > cap).any()) == name.startswith("dropping"), name


def test_init_moe_draws_the_reference_weights():
    jcfg, cfg = _cfgs("qwen3-moe-30b-a3b", 1.25)
    with jax.enable_x64(False):  # the reference's default: float32 normals
        jp = jinit_moe(jcfg, jax.random.PRNGKey(7), jnp.float32)
    tp = moe.init_moe(cfg, prng.PRNGKey(7, device="cpu"), torch.float32)
    assert sorted(tp) == sorted(k for k, v in jp.items() if v is not None)
    assert tp["router"].dtype == torch.float32
    for k, v in tp.items():
        want = np.asarray(jp[k])
        assert v.shape == want.shape
        # threefry bits are exact; torch's and XLA's erfinv differ by a few ulp
        assert np.abs(v.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max(), k
    bf16 = moe.init_moe(cfg, prng.PRNGKey(7, device="cpu"), torch.bfloat16)
    assert bf16["router"].dtype == torch.float32 and bf16["wg"].dtype == torch.bfloat16


def test_single_expert_is_a_swiglu_mlp():
    """E = 1, k = 1 and dropless capacity: the block is a SwiGLU MLP on the
    same weights (the reference's test_moe_matches_dense_single_expert)."""
    cfg = dataclasses.replace(get_arch("olmoe-1b-7b").smoke(), n_experts=1, moe_top_k=1,
                              capacity_factor=64.0, moe_d_ff=32)
    p = moe.init_moe(cfg, prng.PRNGKey(0, device="cpu"), torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    out, aux = moe.moe_block(cfg, p, x, ModelOptions())
    mlp = param_dict({"ln": p["ln"].detach(), "wg": p["wg"][0].detach(),
                      "wu": p["wu"][0].detach(), "wd": p["wd"][0].detach()})
    want = mlp_block(dataclasses.replace(cfg, mlp="swiglu"), mlp, x, ModelOptions())
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    assert torch.isfinite(aux)


def test_top_k_ties_resolve_to_the_lower_index():
    rows = np.array([[0.3, 0.2, 0.2, 0.3], [0.1, 0.1, 0.1, 0.1], [0.5, 0.0, 0.25, 0.25],
                     [0.2, 0.3, 0.3, 0.2]], np.float32)
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(rows), k)
        got_v, got_i = moe.top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # the block's own router: every token has a tie at the top-2 boundary
    cfg = get_arch("olmoe-1b-7b").smoke()
    router = torch.from_numpy(_tied_router(cfg.d_model, cfg.n_experts))
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(16, cfg.d_model)).astype(np.float32))
    _, idx = moe.top_k(torch.softmax(x @ router, -1), cfg.moe_top_k)
    lead = (x @ router[:, 0]) > 0
    assert torch.equal(idx[lead], torch.tensor([[0, 3]]).expand(int(lead.sum()), 2))
    assert torch.equal(idx[~lead], torch.tensor([[1, 2]]).expand(int((~lead).sum()), 2))


def test_capacity_keeps_each_experts_first_tokens():
    """An expert over capacity keeps its first ``cap`` assignments in token
    order and drops the rest (the stable sort)."""
    e, k, cap = 3, 2, 2
    # token t's choices: (0, 1), (0, 2), (0, 1), (1, 0)
    flat = torch.tensor([[0, 1, 0, 2, 0, 1, 1, 0]])
    slot, token, assignment = moe._route(flat, e, k, cap)
    drop = e * cap
    assert slot.tolist() == [[0, 2, 1, 4, drop, 3, drop, drop]]
    assert token.tolist() == [[0, 1, 0, 2, 1, 4]]
    assert assignment.tolist() == [[0, 2, 1, 5, 3, 8]]


def test_moe_block_has_no_float_atomics():
    """No scatter-add in the layer, forward or backward: the sums of a
    token's k contributions run over a k axis in order."""
    src = inspect.getsource(moe)
    code = "\n".join(line.split("#")[0] for line in src.splitlines())
    for call in ("index_add", "scatter_add", "scatter_reduce", "accumulate=True",
                 "index_put"):
        assert call not in code, call
    assert re.search(r"class _GatherRows\(torch\.autograd\.Function\)", src)
