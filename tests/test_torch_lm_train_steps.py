"""Two AdamW steps of the port's ``make_train_step`` against the
reference's step (its body: ``value_and_grad`` of ``loss_fn``, then
``optimizer.update``) on the four smoke configs of
``tests/test_torch_lm_train.py``, with and without ``loss_mask``: losses at
atol 2e-5, the gradient norm at rtol 2e-4, the updated parameters as
``ADAM_SHARE`` there states."""
import jax
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro_torch.models import ModelOptions, lm_params_from_jax, make_train_step
from repro_torch.optim import adamw, cosine_schedule
from test_torch_lm_train import (ARCHS, JOPT, JUPDATE, LOSS_ATOL, _assert_tree_close, _batch,
                                 _cfgs, _jbatch, _jvalue_and_grad, _lr_sum, _torch_batch)


@pytest.fixture(scope="module")
def jparams():
    """The reference's ``init_params(PRNGKey(0))`` per smoke arch (float32)."""
    return {arch: jax.jit(jinit_params, static_argnums=0)(jget_arch(arch).smoke(),
                                                          jax.random.PRNGKey(0))
            for arch in ARCHS}


@pytest.mark.parametrize("mask", [False, True], ids=["no-mask", "loss-mask"])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_adamw_steps_match_reference(jparams, arch, mask):
    """Two steps of ``make_train_step`` against the reference's step, its
    body (``value_and_grad`` of ``loss_fn``, then ``optimizer.update``)."""
    cfg, _ = _cfgs(arch)
    batches = [_batch(cfg, 2, 16, seed=10 + i, mask=mask) for i in range(2)]
    jp, js = jparams[arch], JOPT.init(jparams[arch])
    jlosses = []
    for b in batches:
        jloss, jg = _jvalue_and_grad(arch)(jp, _jbatch(b))
        jp, js, jnorm = JUPDATE(jg, js, jp)
        jlosses.append(float(jloss))

    opt = adamw(cosine_schedule(1e-3, 1, 4))
    tparams = lm_params_from_jax(jparams[arch], device="cpu")
    state = opt.init(list(tparams.parameters()))
    step = make_train_step(cfg, opt, ModelOptions())
    losses = []
    for b in batches:
        out, state, m = step(tparams, state, _torch_batch(b))
        assert out is tparams and set(m) == {"loss", "grad_norm"}
        losses.append(m["loss"].item())
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jnorm), rtol=2e-4)
    _assert_tree_close(tparams.named_parameters(), jp,
                       _lr_sum(cosine_schedule(1e-3, 1, 4), 2))
    assert int(state.step) == 2


