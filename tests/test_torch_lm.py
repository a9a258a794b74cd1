"""The port's LM substrate (inference path) against the JAX reference.

Configs and their registry must equal the reference's field by field.  On
the six smoke configs whose families the port has (``zamba2-7b`` hybrid,
``mamba2-130m`` ssm, ``qwen3-1.7b``, ``olmo-1b``, ``qwen1.5-32b`` and
``yi-9b`` dense; qwen1.5-32b also with random nonzero q/k/v biases, which
the reference's ``init_params`` draws as zeros), the reference's
weights are carried across with ``lm_params_from_jax`` and ``forward``,
``serve_step`` and the decode ``Engine`` are held to the reference in
float32 at the reference's decode-vs-forward tolerance (atol 2e-5).  The
port's ``init_params`` is held to the reference's draws in a float32
subprocess (x64 off, the reference's default).  The moe family and the
``patch`` / ``frames`` frontends (``qwen3-moe-30b-a3b``, ``qwen2-vl-2b`` with
``vision_embeds``, ``hubert-xlarge`` on frames; ``olmoe-1b-7b`` through its
weights only, as the reference's tier-1 keeps its smoke run out) are held
to the reference the same way: ``forward``, ``loss_fn`` and its gradients,
``serve_step``, decode == forward, the decode ``Engine`` and checkpoints.
``attn_impl="stub"`` (the dry run's cost isolation) is held to the
reference's forward under it; training is held to the reference in
``tests/test_torch_lm_train.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ModelOptions as JModelOptions
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import make_serve_step as jmake_serve_step
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import configs
from repro_torch.kernels import FLASH_ATTENTION, SSD_SCAN
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (LMParams, ModelOptions, ShardingPolicy, forward, init_cache,
                                init_params, lm_params_from_jax, loss_fn, make_serve_step,
                                make_train_step, serve_step)
from repro_torch.optim import adamw
from repro_torch.serving import Engine, ServeConfig
from repro_torch.train import restore_checkpoint, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["zamba2-7b", "mamba2-130m", "qwen3-1.7b", "olmo-1b", "qwen1.5-32b", "yi-9b"]
# the moe family and the two frontends: held through forward, loss and decode
FRONTIER = ["qwen3-moe-30b-a3b", "qwen2-vl-2b", "hubert-xlarge"]
# and through their weights alone
FRONTIER_WEIGHTS = FRONTIER + ["olmoe-1b-7b"]
DERIVED = ["resolved_head_dim", "padded_vocab", "d_inner", "ssm_heads", "block_kind",
           "supports_decode", "subquadratic"]


# -- configs --------------------------------------------------------------------

def test_registry_lists_the_reference_archs():
    assert configs.list_archs() == jconfigs.list_archs()
    assert [dataclasses.astuple(s) for s in configs.ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in jconfigs.ALL_SHAPES]


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_fields_and_derived_properties(arch):
    for got, want in ((configs.get_arch(arch), jconfigs.get_arch(arch)),
                      (configs.get_arch(arch).smoke(), jconfigs.get_arch(arch).smoke())):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for name in DERIVED:
            assert getattr(got, name) == getattr(want, name), name
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        for shape in jconfigs.ALL_SHAPES:
            assert configs.cell_applicable(got, configs.get_shape(shape.name)) == \
                jconfigs.cell_applicable(want, shape)
    with pytest.raises(KeyError):
        configs.get_arch("no-such-arch")


# -- weights --------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """(cfg, reference params, port params) per smoke arch, from the
    reference's ``init_params(PRNGKey(0))``."""
    out = {}
    for arch in ARCHS:
        cfg = configs.get_arch(arch).smoke()
        jparams = jax.jit(jinit_params, static_argnums=0)(jconfigs.get_arch(arch).smoke(),
                                                          jax.random.PRNGKey(0))
        out[arch] = (cfg, jparams, lm_params_from_jax(jparams, device="cpu"))
    return out


def _leaves(jparams):
    """(port parameter name, numpy array) for every reference leaf, the
    stacked layer leaves split per layer."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [p.key for p in path]
        arr = np.asarray(leaf)
        if keys[0] == "layers":
            out += [(".".join(["layers", str(i)] + keys[1:]), arr[i]) for i in range(arr.shape[0])]
        else:
            out.append((".".join(keys), arr))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_jax_round_trip(models, arch):
    cfg, jparams, tparams = models[arch]
    assert isinstance(tparams, LMParams)
    named = dict(tparams.named_parameters())
    leaves = _leaves(jparams)
    assert sorted(named) == sorted(name for name, _ in leaves)
    for name, arr in leaves:
        assert named[name].dtype == torch.float32
        np.testing.assert_array_equal(named[name].detach().numpy(), arr)
    assert sum(p.numel() for p in named.values()) == sum(a.size for _, a in leaves)
    bf16 = lm_params_from_jax(jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jparams),
                              device="cpu")
    assert bf16.embed.dtype == torch.bfloat16
    torch.testing.assert_close(bf16.embed, tparams.embed.to(torch.bfloat16), rtol=0, atol=0)


_F32_INIT = r"""
import json
import jax, numpy as np, torch
from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro_torch.configs import get_arch
from repro_torch.models import init_params
assert not jax.config.jax_enable_x64
out = {}
for arch in %r:
    jp = jax.jit(jinit_params, static_argnums=0)(jget_arch(arch).smoke(), jax.random.PRNGKey(0))
    tp = dict(init_params(get_arch(arch).smoke(), 0, device="cpu").named_parameters())
    worst, names = 0.0, []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        arr = np.asarray(leaf)
        pairs = ([(".".join(["layers", str(i)] + keys[1:]), arr[i]) for i in range(arr.shape[0])]
                 if keys[0] == "layers" else [(".".join(keys), arr)])
        for name, a in pairs:
            t = tp[name].detach().numpy()
            assert t.dtype == a.dtype and t.shape == a.shape, name
            worst = max(worst, float(np.abs(t - a).max() / max(1e-30, np.abs(a).max())))
            names.append(name)
    out[arch] = dict(worst=worst, names=sorted(names), port=sorted(tp))
print(json.dumps(out))
""" % (ARCHS + FRONTIER_WEIGHTS,)


@pytest.fixture(scope="module")
def float32_init():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, "-c", _F32_INIT], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS + FRONTIER_WEIGHTS)
def test_init_params_draws_the_reference_weights(float32_init, arch):
    r = float32_init[arch]
    assert r["names"] == r["port"]
    # threefry bits are exact; torch's and XLA's erfinv differ by a few ulp
    # (~1e-5 relative in the far tails, tests/test_torch_prng.py), and
    # linspace in A_log by an ulp
    assert r["worst"] < 1e-5


# -- forward and decode against the reference -----------------------------------

def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("head_positions", ["all", "last"])
def test_forward_matches_reference(models, arch, head_positions):
    cfg, jparams, tparams = models[arch]
    toks = _tokens(cfg, 2, 32, seed=1)
    jopts = JModelOptions(attn_chunk=8, ssd_chunk=16)  # several q and SSD chunks
    want, _ = jforward(jconfigs.get_arch(arch).smoke(), jparams, {"tokens": jnp.asarray(toks)},
                       jopts, head_positions=head_positions)
    with torch.no_grad():
        got, aux = forward(cfg, tparams, {"tokens": torch.from_numpy(toks)},
                           ModelOptions(attn_chunk=8, ssd_chunk=16),
                           head_positions=head_positions)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.fixture(scope="module")
def biased_qwen():
    """qwen1.5-32b's smoke weights with random nonzero q/k/v biases (the
    ``qkv_bias`` path), in both packages."""
    cfg = configs.get_arch("qwen1.5-32b").smoke()
    jparams = jax.jit(jinit_params, static_argnums=0)(jconfigs.get_arch("qwen1.5-32b").smoke(),
                                                      jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    attn = dict(jparams["layers"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(rng.normal(size=attn[name].shape).astype(np.float32) * 0.5)
    jparams = dict(jparams, layers=dict(jparams["layers"], attn=attn))
    return cfg, jparams, lm_params_from_jax(jparams, device="cpu")


@pytest.mark.parametrize("head_positions", ["all", "last"])
def test_forward_with_qkv_biases_matches_reference(biased_qwen, head_positions):
    cfg, jparams, tparams = biased_qwen
    assert cfg.qkv_bias
    assert float(dict(tparams.named_parameters())["layers.0.attn.bq"].detach().abs().min()) > 0
    toks = _tokens(cfg, 2, 32, seed=5)
    want, _ = jforward(jconfigs.get_arch("qwen1.5-32b").smoke(), jparams,
                       {"tokens": jnp.asarray(toks)}, JModelOptions(attn_chunk=8),
                       head_positions=head_positions)
    with torch.no_grad():
        got, _ = forward(cfg, tparams, {"tokens": torch.from_numpy(toks)},
                         ModelOptions(attn_chunk=8), head_positions=head_positions)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_serve_step_with_qkv_biases_matches_reference(biased_qwen):
    cfg, jparams, tparams = biased_qwen
    jcfg = jconfigs.get_arch("qwen1.5-32b").smoke()
    B, S = 2, 16
    toks = _tokens(cfg, B, S, seed=6)
    jstep = jax.jit(jmake_serve_step(jcfg))
    jcache, cache = jinit_cache(jcfg, B, S), init_cache(cfg, B, S, device="cpu")
    for i in range(S):
        want, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, i]), jnp.int32(i))
        with torch.no_grad():
            got, cache = serve_step(cfg, tparams, cache, torch.from_numpy(toks[:, i]), i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("arch", ["zamba2-7b", "qwen3-1.7b"])
@pytest.mark.parametrize("opt", ["interpret", "never"])
def test_forward_options_match_reference(models, arch, opt):
    cfg, jparams, tparams = models[arch]
    toks = _tokens(cfg, 2, 16, seed=2)
    kw = {"use_flash": opt}
    want, _ = jforward(jconfigs.get_arch(arch).smoke(), jparams, {"tokens": jnp.asarray(toks)},
                       JModelOptions(**kw))
    with torch.no_grad():
        got, _ = forward(cfg, tparams, {"tokens": torch.from_numpy(toks)}, ModelOptions(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("impl", ["stub", "anything-else"])
def test_attn_impl_other_than_real_raises_not_yet_ported(models, impl):
    """Once ``NotYetPorted``: ``"stub"`` now takes the dry run's cost
    isolation (the reference's forward under it, at the forward tests'
    limit, and not the real forward); any other value but ``"real"``
    raises ``ValueError``, where the reference runs it as ``"real"``."""
    assert ModelOptions(attn_impl="real").attn_impl == "real"
    if impl != "stub":
        with pytest.raises(ValueError, match="attn_impl"):
            ModelOptions(attn_impl=impl)
        return
    cfg, jparams, tparams = models["qwen3-1.7b"]
    toks = _tokens(cfg, 2, 16, seed=2)
    want, _ = jforward(jconfigs.get_arch("qwen3-1.7b").smoke(), jparams,
                       {"tokens": jnp.asarray(toks)}, JModelOptions(attn_impl="stub"))
    with torch.no_grad():
        got, _ = forward(cfg, tparams, {"tokens": torch.from_numpy(toks)},
                         ModelOptions(attn_impl="stub"))
        real, _ = forward(cfg, tparams, {"tokens": torch.from_numpy(toks)}, ModelOptions())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert np.abs(real.numpy() - np.asarray(want)).max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_reference(models, arch):
    cfg, jparams, tparams = models[arch]
    jcfg = jconfigs.get_arch(arch).smoke()
    B, S = 2, 16
    toks = _tokens(cfg, B, S, seed=3)
    jstep = jax.jit(jmake_serve_step(jcfg))
    jcache = jinit_cache(jcfg, B, S)
    cache = init_cache(cfg, B, S, device="cpu")
    assert sorted(cache) == sorted(jcache)
    for i in range(S):
        want, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, i]), jnp.int32(i))
        with torch.no_grad():
            got, cache = serve_step(cfg, tparams, cache, torch.from_numpy(toks[:, i]), i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    for path, leaf in flat:
        node = cache
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.float().numpy(), np.asarray(leaf, np.float32), atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(models, arch):
    """Token-by-token decode equals the full forward (the KV-cache/SSM-state
    test of the reference, on the port alone)."""
    cfg, _, tparams = models[arch]
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=4))
    step = make_serve_step(cfg)
    with torch.no_grad():
        full, _ = forward(cfg, tparams, {"tokens": toks})
        cache = init_cache(cfg, B, S, device="cpu")
        outs = []
        for i in range(S):
            lg, cache = step(tparams, cache, toks[:, i], torch.tensor(i))
            outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=0, atol=2e-5)


def _drain(engine_cls, config_cls, cfg, params, **kw):
    eng = engine_cls(cfg, params, config_cls(slots=3, max_len=20, **kw))
    prompts = [[5, 9, 2], [7], [3, 3, 3, 3, 3], [11, 4], [8, 8, 1, 6]]
    for p in prompts:
        eng.submit(p)
    return eng.run()


@pytest.mark.parametrize("arch", ["zamba2-7b", "olmo-1b"])
@pytest.mark.parametrize("greedy", [True, False])
def test_engine_tokens_match_reference(models, arch, greedy):
    cfg, jparams, tparams = models[arch]
    kw = {} if greedy else {"greedy": False, "temperature": 0.7}
    want = _drain(JEngine, JServeConfig, jconfigs.get_arch(arch).smoke(), jparams, **kw)
    got = _drain(Engine, ServeConfig, cfg, tparams, **kw)
    assert got == want
    assert len(got) == 5


def test_engine_runs_under_no_grad_with_trainable_weights(models):
    cfg, _, tparams = models["zamba2-7b"]
    assert all(p.requires_grad for p in tparams.parameters())
    eng = Engine(cfg, tparams, ServeConfig(slots=2, max_len=6))
    eng.submit([4, 5])
    done = eng.run()
    assert len(done[0]) == 6 and not any(t.requires_grad for t in eng.cache["mamba"].values())


def test_launch_serve_on_cpu(capsys):
    launch_serve.main(["--arch", "mamba2-130m", "--device", "cpu", "--requests", "3",
                       "--max-len", "10"])
    assert "served 3 requests" in capsys.readouterr().out


# -- the port's boundary --------------------------------------------------------

def test_cpu_forward_launches_no_kernel(models):
    cfg, _, tparams = models["zamba2-7b"]
    before = (FLASH_ATTENTION.launches, SSD_SCAN.launches)
    with torch.no_grad():
        forward(cfg, tparams, {"tokens": torch.zeros(1, 8, dtype=torch.int64)})
    assert (FLASH_ATTENTION.launches, SSD_SCAN.launches) == before


def test_training_and_sharding_raise_not_yet_ported(models):
    """Training is ported (``tests/test_torch_lm_train.py`` holds it to the
    reference), and so is sharding the LM on a mesh (ROADMAP A14d:
    ``tests/test_torch_tensor_parallel.py``): a policy with axes and decode
    cache constraints construct, and a hook with axes asks for a mesh when
    called outside one.  The dry run's ``attn_impl="stub"`` still raises."""
    cfg, _, tparams = models["qwen3-1.7b"]
    toks = torch.zeros(1, 4, dtype=torch.int64)
    loss = loss_fn(cfg, tparams, {"tokens": toks, "labels": toks})
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert callable(make_train_step(cfg, None))
    policy = ShardingPolicy(batch_axes=("data",), model_axis="model")
    assert ShardingPolicy(model_axis="model").model_axis == "model"
    opts = ModelOptions(shard=policy, cache_constraints={"k": ("data", "model")})
    assert opts.constrain_cache("v", toks) is toks
    assert ShardingPolicy().hidden(toks) is toks
    with pytest.raises(ValueError, match="mesh"):
        policy.hidden(torch.zeros(1, 4, 8))
    assert ModelOptions(attn_impl="stub").attn_impl == "stub"
    with pytest.raises(ValueError, match="attn_impl"):
        ModelOptions(attn_impl="anything-else")
    assert ModelOptions(remat=True).remat


def test_lm_modules_leave_jax_out():
    code = ("import sys, repro_torch.models, repro_torch.configs, repro_torch.serving, "
            "repro_torch.launch.serve, repro_torch.models.reversible, "
            "repro_torch.models.moe, "
            "repro_torch.launch.train; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')); "
            "assert 'jax' not in sys.modules; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- the moe family and the patch / frames frontends ------------------------------

def _frontier_batch(cfg, seed, B=2, S=16):
    """The reference smoke test's batch layout: tokens and labels, plus
    ``vision_embeds`` (patch) or ``frames`` in place of tokens (frames)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)),
             "labels": rng.integers(0, cfg.vocab, size=(B, S))}
    if cfg.frontend == "patch":
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.n_vision_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "frames":
        batch = {"frames": rng.normal(size=(B, S, cfg.frontend_dim)).astype(np.float32),
                 "labels": batch["labels"]}
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _reference_tree(jcfg, tparams):
    """The port's weights as the reference's parameter tree: its structure
    from ``jax.eval_shape`` of its ``init_params`` (stacked layer leaves,
    the ``None`` leaves), every leaf from ``tparams`` (the draws themselves
    are held to the reference's in the float32 subprocess above)."""
    named = {k: v.detach().numpy() for k, v in tparams.named_parameters()}

    def fill(path, leaf):
        keys = [p.key for p in path]
        if keys[0] == "layers":
            arr = np.stack([named[".".join(["layers", str(i)] + keys[1:])]
                            for i in range(leaf.shape[0])])
        else:
            arr = named[".".join(keys)]
        assert arr.shape == leaf.shape and arr.dtype == leaf.dtype, keys
        return jnp.asarray(arr)

    shapes = jax.eval_shape(lambda k: jinit_params(jcfg, k), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def frontier():
    """Per arch: (cfg, reference params, port params, batch, the reference's
    logits (all / last), loss, gradients and serve_step logits), the
    reference run once, jitted."""
    out = {}
    for arch in FRONTIER_WEIGHTS:
        jcfg = jconfigs.get_arch(arch).smoke()
        cfg = configs.get_arch(arch).smoke()
        jparams = _reference_tree(jcfg, init_params(cfg, 0, device="cpu"))
        tparams = lm_params_from_jax(jparams, device="cpu")
        if arch not in FRONTIER:
            out[arch] = (cfg, jparams, tparams, None, None)
            continue
        batch = _frontier_batch(cfg, seed=len(arch))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def reference(p):  # one compile an arch
            logits, aux = jforward(jcfg, p, jbatch)
            last, _ = jforward(jcfg, p, jbatch, head_positions="last")
            loss, grads = jax.value_and_grad(lambda q: jloss_fn(jcfg, q, jbatch))(p)
            return logits, last, aux, loss, grads

        logits, last, aux, loss, grads = jax.jit(reference)(jparams)
        want = {"all": np.asarray(logits), "last": np.asarray(last), "aux": float(aux),
                "loss": float(loss), "grads": grads}
        if cfg.supports_decode:
            jstep = jax.jit(jmake_serve_step(jcfg))
            jcache = jinit_cache(jcfg, 2, 8)
            steps = []
            for i in range(8):
                lg, jcache = jstep(jparams, jcache, jnp.asarray(batch["tokens"][:, i]),
                                   jnp.int32(i))
                steps.append(np.asarray(lg))
            want["serve"] = steps
        out[arch] = (cfg, jparams, tparams, batch, want)
    return out


@pytest.mark.parametrize("arch", FRONTIER_WEIGHTS)
def test_frontier_params_round_trip(frontier, arch):
    """``lm_params_from_jax`` takes the reference's tree with the stacked moe
    leaves (``ln``, ``router``, ``wg``, ``wu``, ``wd``) and ``vision_proj`` /
    ``frame_proj``, leaf for leaf, under ``init_params``' names."""
    cfg, jparams, tparams, _, _ = frontier[arch]
    named = dict(tparams.named_parameters())
    leaves = _leaves(jparams)
    assert sorted(named) == sorted(name for name, _ in leaves)
    for name, arr in leaves:
        np.testing.assert_array_equal(named[name].detach().numpy(), arr)
    assert sorted(dict(init_params(cfg, 0, device="cpu").named_parameters())) == sorted(named)
    assert ("layers.0.moe.router" in named) == (cfg.family == "moe")
    assert ("vision_proj" in named) == (cfg.frontend == "patch")
    assert ("frame_proj" in named) == (cfg.frontend == "frames")
    assert sum(p.numel() for p in named.values()) == sum(a.size for _, a in leaves)


@pytest.mark.parametrize("arch", FRONTIER)
@pytest.mark.parametrize("head_positions", ["all", "last"])
def test_frontier_forward_matches_reference(frontier, arch, head_positions):
    cfg, _, tparams, batch, want = frontier[arch]
    with torch.no_grad():
        got, aux = forward(cfg, tparams, _torch_batch(batch), head_positions=head_positions)
    assert got.shape == want[head_positions].shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[head_positions], rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(aux), want["aux"], rtol=0, atol=2e-5)
    assert (float(aux) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("arch", FRONTIER)
def test_frontier_loss_and_gradients_match_reference(frontier, arch):
    """``loss_fn`` (with ``0.01 * aux / n_layers`` for moe) and the gradient
    of every leaf, against ``jax.value_and_grad`` of the reference's."""
    cfg, _, tparams, batch, want = frontier[arch]
    leaves = dict(tparams.named_parameters())
    loss = loss_fn(cfg, tparams, _torch_batch(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), want["loss"], rtol=0, atol=2e-5)
    jgrads = dict(_leaves(want["grads"]))
    for (name, p), g in zip(leaves.items(), grads):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=0, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen2-vl-2b"])
def test_frontier_serve_step_matches_reference(frontier, arch):
    cfg, _, tparams, batch, want = frontier[arch]
    toks = torch.from_numpy(batch["tokens"])
    cache = init_cache(cfg, 2, 8, device="cpu")
    with torch.no_grad():
        for i, w in enumerate(want["serve"]):
            got, cache = serve_step(cfg, tparams, cache, toks[:, i], i)
            np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen2-vl-2b"])
def test_frontier_decode_matches_forward(frontier, arch):
    """Token-by-token decode equals the full forward; moe with dropless
    capacity (``capacity_factor=64``), as the reference's test runs it."""
    cfg, _, tparams, _, _ = frontier[arch]
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=4))
    with torch.no_grad():
        full, _ = forward(cfg, tparams, {"tokens": toks})
        cache = init_cache(cfg, B, S, device="cpu")
        outs = [serve_step(cfg, tparams, cache, toks[:, i], i)[0] for i in range(S)]
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=0, atol=2e-5)


def test_moe_engine_tokens_match_reference(frontier):
    """A moe model decodes through ``serve_step`` in the ``Engine``: the
    reference engine's greedy tokens."""
    cfg, jparams, tparams, _, _ = frontier["qwen3-moe-30b-a3b"]
    want = _drain(JEngine, JServeConfig, jconfigs.get_arch("qwen3-moe-30b-a3b").smoke(),
                  jparams)
    assert _drain(Engine, ServeConfig, cfg, tparams) == want


def test_encoder_only_engine_is_refused(frontier):
    cfg, _, tparams, _, _ = frontier["hubert-xlarge"]
    with pytest.raises(ValueError, match="encoder-only"):
        Engine(cfg, tparams)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen2-vl-2b"])
def test_frontier_checkpoint_round_trip_is_bitwise(arch, tmp_path):
    """A moe or frontend model after one AdamW step, with its optimizer
    state, saved and restored into fresh weights bitwise (bf16 leaves
    included)."""
    cfg = dataclasses.replace(configs.get_arch(arch).smoke(), dtype="bfloat16")
    params = init_params(cfg, 1, device="cpu")
    opt = adamw(1e-3)
    state = opt.init(list(params.parameters()))
    batch = _torch_batch(_frontier_batch(cfg, seed=3))
    if cfg.frontend == "patch":
        batch["vision_embeds"] = batch["vision_embeds"].to(torch.bfloat16)
    params, state, _ = make_train_step(cfg, opt)(params, state, batch)
    save_checkpoint(str(tmp_path), 1, (params, state))
    fresh = init_params(cfg, 2, device="cpu")
    fresh_state = opt.init(list(fresh.parameters()))
    restore_checkpoint(str(tmp_path), 1, (fresh, fresh_state))
    # the router stays float32 under a bf16 model, as in the reference
    assert {p.dtype for p in params.parameters()} == (
        {torch.bfloat16, torch.float32} if cfg.family == "moe" else {torch.bfloat16})
    for (name, a), b in zip(params.named_parameters(), fresh.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for a, b in zip(_tensors(state), _tensors(fresh_state)):
        assert torch.equal(a, b)


def _tensors(tree):
    """The tensors of a tuple/list tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _tensors(item)]
    return []
