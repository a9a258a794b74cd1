"""The LM's accumulating train step, ``make_accum_train_step`` at two
microbatches, against the reference's on the four smoke configs of
``tests/test_torch_lm_train.py``: loss at atol 2e-5, the gradient norm at
rtol 2e-4, the updated parameters as ``ADAM_SHARE`` there states."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.models import ModelOptions as JModelOptions
from repro.models import init_params as jinit_params
from repro.optim import adamw as jadamw
from repro.train.trainer import make_accum_train_step as jmake_accum_train_step
from repro_torch.models import ModelOptions, lm_params_from_jax
from repro_torch.optim import adamw
from repro_torch.train import make_accum_train_step
from test_torch_lm_train import (ARCHS, LOSS_ATOL, _assert_tree_close, _batch, _cfgs,
                                 _torch_batch)
from test_torch_lm_train_loop import _microbatched


@pytest.fixture(scope="module")
def jparams():
    """The reference's ``init_params(PRNGKey(0))`` per smoke arch (float32)."""
    return {arch: jax.jit(jinit_params, static_argnums=0)(jget_arch(arch).smoke(),
                                                          jax.random.PRNGKey(0))
            for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_accum_train_step_matches_reference(jparams, arch):
    cfg, jcfg = _cfgs(arch)
    batch = _microbatched(_batch(cfg, 4, 16, seed=4, mask=True), 2)
    jopt = jadamw(1e-3)
    jstep = jax.jit(jmake_accum_train_step(jcfg, jopt, JModelOptions(), microbatches=2))
    jp, _, jm = jstep(jparams[arch], jopt.init(jparams[arch]),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    opt = adamw(1e-3)
    tparams = lm_params_from_jax(jparams[arch], device="cpu")
    step = make_accum_train_step(cfg, opt, ModelOptions(), microbatches=2)
    _, _, m = step(tparams, opt.init(list(tparams.parameters())), _torch_batch(batch))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=2e-4)
    _assert_tree_close(tparams.named_parameters(), jp, 1e-3)


