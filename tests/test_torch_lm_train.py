"""The port's LM training path against the JAX reference, on the CPU.

On the smoke configs of ``zamba2-7b`` (hybrid), ``mamba2-130m`` (ssm),
``qwen3-1.7b`` and ``olmo-1b`` (dense), the reference's weights are carried
across with ``lm_params_from_jax`` and inputs come from a numpy seed.
``loss_fn`` and its gradients are held to the reference's in float32 at
the reference's own limits (``tests/test_archs_smoke.py``: losses atol
2e-5, gradients rtol 2e-4 / atol 1e-6); two AdamW steps of
``make_train_step`` are held in ``tests/test_torch_lm_train_steps.py``,
``make_accum_train_step`` in ``tests/test_torch_lm_accum.py``, and
``train_loop`` and the launcher in ``tests/test_torch_lm_train_loop.py``.
Within the port, ``remat`` is bitwise neutral.  The CPU runs the LM
kernels' plain twins; the card's kernels are held to those twins by the
``cuda`` tests and ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import ModelOptions as JModelOptions
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine_schedule
from repro_torch.configs import get_arch
from repro_torch.models import (ModelOptions, constrain, lm_params_from_jax, loss_fn,
                                make_train_step)
from repro_torch.optim import adamw
from repro_torch.train import make_accum_train_step

ARCHS = ["zamba2-7b", "mamba2-130m", "qwen3-1.7b", "olmo-1b"]
LOSS_ATOL = 2e-5
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
# Parameters after AdamW steps.  AdamW divides each gradient element by its
# own running scale, so an element within float32 rounding of 0 moves its
# parameter by an ill-conditioned share of lr, up to a sign flip, in either
# framework.  So at most 1 in 1,000 elements of a leaf may lie outside the
# gradients' limit plus 1% of the summed learning rate, and those within
# twice the summed rate; the loss, gradients and gradient norm are held at
# the reference's limits beside them.
ADAM_SHARE, ADAM_OUTLIERS = 1e-2, 1e-3


@pytest.fixture(scope="module")
def jparams():
    """The reference's ``init_params(PRNGKey(0))`` per smoke arch (float32)."""
    return {arch: jax.jit(jinit_params, static_argnums=0)(jget_arch(arch).smoke(),
                                                          jax.random.PRNGKey(0))
            for arch in ARCHS}


def _cfgs(arch):
    return get_arch(arch).smoke(), jget_arch(arch).smoke()


@functools.lru_cache(maxsize=None)
def _jvalue_and_grad(arch):
    """The reference's loss and gradients, jitted once per arch: the body of
    its ``make_train_step``."""
    jcfg = jget_arch(arch).smoke()
    return jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(jcfg, p, b, JModelOptions())))


def _jbatch(batch):
    """``batch`` for the reference, with its default mask written out (its
    ``loss_fn`` takes a missing ``loss_mask`` as ones), so that one trace
    per arch serves both cases; the port gets ``batch`` as it is."""
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    out.setdefault("loss_mask", jnp.ones(batch["labels"].shape, jnp.float32))
    return out


# The reference's AdamW on the schedule the step tests use, its update
# jitted once (traced once per arch's parameter tree).
JOPT = jadamw(jcosine_schedule(1e-3, 1, 4))
JUPDATE = jax.jit(JOPT.update)


def _batch(cfg, b, s, seed, mask):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _named(jtree):
    """(port parameter name, numpy array) for every reference leaf, the
    stacked layer leaves split per layer."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [p.key for p in path]
        arr = np.asarray(leaf)
        if keys[0] == "layers":
            for i in range(arr.shape[0]):
                out[".".join(["layers", str(i)] + keys[1:])] = arr[i]
        else:
            out[".".join(keys)] = arr
    return out


def _assert_tree_close(tparams_or_grads, jtree, lr_sum=None):
    """Gradients (``lr_sum`` None) at the reference's limits; parameters
    after AdamW steps of summed rate ``lr_sum`` as ``ADAM_SHARE`` says."""
    want = _named(jtree)
    got = dict(tparams_or_grads)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        g = got[name].detach().numpy()
        if lr_sum is None:
            np.testing.assert_allclose(g, arr, err_msg=name, **GRAD_TOL)
            continue
        err = np.abs(g.astype(np.float64) - arr)
        limit = GRAD_TOL["atol"] + ADAM_SHARE * lr_sum + GRAD_TOL["rtol"] * np.abs(arr)
        outside = int((err > limit).sum())
        assert outside <= ADAM_OUTLIERS * err.size, (name, outside, err.size)
        assert err.max() <= 2 * lr_sum, (name, err.max(), lr_sum)


def _lr_sum(schedule, steps):
    return sum(float(schedule(torch.tensor(s))) for s in range(1, steps + 1))


def _grads(tparams, cfg, batch, opts=ModelOptions()):
    tparams.zero_grad(set_to_none=True)
    loss = loss_fn(cfg, tparams, _torch_batch(batch), opts)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in tparams.named_parameters()}


# -- loss_fn and its gradients ----------------------------------------------------

@pytest.mark.parametrize("mask", [False, True], ids=["no-mask", "loss-mask"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(jparams, arch, mask):
    cfg, jcfg = _cfgs(arch)
    batch = _batch(cfg, 2, 16, seed=1, mask=mask)
    jloss, jgrads = _jvalue_and_grad(arch)(jparams[arch], _jbatch(batch))
    tparams = lm_params_from_jax(jparams[arch], device="cpu")
    loss, grads = _grads(tparams, cfg, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=LOSS_ATOL)
    _assert_tree_close(grads.items(), jgrads)


def test_loss_mask_of_zeros_gives_zero_loss(jparams):
    cfg, _ = _cfgs("olmo-1b")
    batch = _batch(cfg, 1, 8, seed=2, mask=False)
    batch["loss_mask"] = np.zeros((1, 8), np.float32)
    tparams = lm_params_from_jax(jparams["olmo-1b"], device="cpu")
    assert loss_fn(cfg, tparams, _torch_batch(batch)).item() == 0.0


# -- remat ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_neutral(jparams, arch):
    cfg, _ = _cfgs(arch)
    batch = _batch(cfg, 2, 16, seed=3, mask=True)
    runs = []
    for remat in (False, True):
        tparams = lm_params_from_jax(jparams[arch], device="cpu")
        runs.append(_grads(tparams, cfg, batch, ModelOptions(remat=remat)))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    with torch.no_grad():  # an inference pass: nothing to rematerialise
        tparams = lm_params_from_jax(jparams[arch], device="cpu")
        a = loss_fn(cfg, tparams, _torch_batch(batch), ModelOptions(remat=True))
    assert torch.equal(a, l0)


def test_accum_with_one_microbatch_is_the_train_step_and_constraints_wait(jparams):
    """One microbatch is the train step; a ``grad_constraint`` (ported with
    ROADMAP A14d; its sharded buffers: ``tests/test_torch_tensor_parallel.py``)
    is applied to the buffers at the start and after each microbatch, so the
    identity leaves the step bitwise as it is; ``constrain`` with a spec
    asks for a mesh outside one."""
    cfg, _ = _cfgs("qwen3-1.7b")
    opt = adamw(1e-2)
    batch = _batch(cfg, 2, 8, seed=5, mask=False)
    runs = []
    for make in (lambda: make_accum_train_step(cfg, opt, ModelOptions(), microbatches=1),
                 lambda: make_train_step(cfg, opt, ModelOptions())):
        tparams = lm_params_from_jax(jparams["qwen3-1.7b"], device="cpu")
        make()(tparams, opt.init(list(tparams.parameters())), _torch_batch(batch))
        runs.append(tparams)
    for a, b in zip(runs[0].parameters(), runs[1].parameters()):
        assert torch.equal(a, b)
    two = {k: v.reshape(2, 1, *v.shape[1:]) for k, v in _torch_batch(batch).items()}
    seen, runs = [], []
    for constraint in (None, lambda bufs: seen.append(len(bufs)) or bufs):
        tparams = lm_params_from_jax(jparams["qwen3-1.7b"], device="cpu")
        make_accum_train_step(cfg, opt, ModelOptions(), microbatches=2,
                              grad_constraint=constraint)(
            tparams, opt.init(list(tparams.parameters())), two)
        runs.append(tparams)
    assert seen == [len(list(runs[1].parameters()))] * 3
    for a, b in zip(runs[0].parameters(), runs[1].parameters()):
        assert torch.equal(a, b)
    x = torch.ones(2)
    assert constrain(x, None) is x
    with pytest.raises(ValueError, match="mesh"):
        constrain(x, ("data",))


# -- graphed chunks (train_loop's CUDA graphs on the card) -------------------------

def test_lm_steps_are_capturable_and_chunks_are_bitwise_the_steps():
    """The LM steps carry ``capturable`` (so ``train_loop`` captures their
    chunks on the card); on the CPU, chunks of K = 2 of the accumulating
    step on olmoe's smoke config (moe: routing sorts on the device) give the
    parameters and losses of K = 1, bitwise."""
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import init_params
    from repro_torch.train import TrainLoopConfig, train_loop

    cfg, _ = _cfgs("olmoe-1b-7b")
    opt = adamw(1e-3)
    for mb in (1, 2):
        assert make_accum_train_step(cfg, opt, ModelOptions(), microbatches=mb).capturable
    assert make_train_step(cfg, opt, ModelOptions()).capturable

    class Data:  # two microbatches a step
        source = SyntheticTokens(DataConfig(4, 8, cfg.vocab))

        def batch_at(self, step):
            return {k: v.reshape(2, 2, *v.shape[1:])
                    for k, v in self.source.batch_at(step).items()}

    runs = [train_loop(cfg, init_params(cfg, 0, device="cpu"), Data(), optimizer=opt,
                       loop=TrainLoopConfig(steps=3, log_every=1, microbatches=2,
                                            steps_per_call=k))
            for k in (1, 2)]
    assert runs[0]["losses"] == runs[1]["losses"] and len(runs[0]["losses"]) == 3
    assert runs[1]["n_dispatches"] == 2 and runs[1]["graphs"] == {}
    for a, b in zip(runs[0]["params"].parameters(), runs[1]["params"].parameters()):
        assert torch.equal(a, b)
