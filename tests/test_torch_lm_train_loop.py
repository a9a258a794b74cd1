"""``train_loop`` with its default step (the LM's ``make_accum_train_step``,
held alone in ``tests/test_torch_lm_accum.py``) and the training launcher,
on the CPU.

On ``olmo-1b``'s smoke config ``train_loop`` is held to the reference's
(logged losses at atol 2e-5, final parameters as
``tests/test_torch_lm_train_steps.py`` holds AdamW steps); a run resumed from a
checkpoint is bitwise an unbroken one (the reference's
``tests/test_substrate.py`` resume test, on the port), and chunked steps are
bitwise sequential ones.  ``python -m repro_torch.launch.train`` prints its
losses.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import init_params as jinit_params
from repro.optim import adamw as jadamw
from repro.train.trainer import TrainLoopConfig as JTrainLoopConfig
from repro.train.trainer import train_loop as jtrain_loop
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.models import ModelOptions, init_params, lm_params_from_jax
from repro_torch.optim import adamw
from repro_torch.train import TrainLoopConfig, train_loop
from test_torch_lm_train import LOSS_ATOL, _assert_tree_close, _cfgs


@pytest.fixture(scope="module")
def jparams():
    """The reference's ``init_params(PRNGKey(0))`` for olmo-1b's smoke config."""
    return {"olmo-1b": jax.jit(jinit_params, static_argnums=0)(
        jget_arch("olmo-1b").smoke(), jax.random.PRNGKey(0))}


def _microbatched(batch, mb):
    return {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:]) for k, v in batch.items()}



# -- train_loop with its default step ------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_loop_default_step_matches_reference(jparams, microbatches):
    arch = "olmo-1b"
    cfg, jcfg = _cfgs(arch)
    steps = 4

    class Data:  # the synthetic stream, split into microbatches
        def __init__(self, source):
            self.source = source

        def batch_at(self, step):
            b = self.source.batch_at(step)
            return b if microbatches == 1 else _microbatched(b, microbatches)

    # the reference's loop donates its parameters: hand it a copy
    jout = jtrain_loop(jcfg, jax.tree_util.tree_map(jnp.array, jparams[arch]),
                       Data(JSyntheticTokens(JDataConfig(4, 16, jcfg.vocab))),
                       optimizer=jadamw(1e-3),
                       loop=JTrainLoopConfig(steps=steps, log_every=1,
                                             microbatches=microbatches))
    tparams = lm_params_from_jax(jparams[arch], device="cpu")
    out = train_loop(cfg, tparams, Data(SyntheticTokens(DataConfig(4, 16, cfg.vocab))),
                     optimizer=adamw(1e-3),
                     loop=TrainLoopConfig(steps=steps, log_every=1,
                                          microbatches=microbatches))
    assert [s for s, _ in out["losses"]] == [s for s, _ in jout["losses"]] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in out["losses"]],
                               [v for _, v in jout["losses"]], rtol=0, atol=LOSS_ATOL)
    assert out["params"] is tparams and out["n_dispatches"] == steps
    _assert_tree_close(tparams.named_parameters(), jout["params"], steps * 1e-3)


def test_resume_exact_training():
    """``tests/test_substrate.py``'s resume test on the port: interrupted at
    3 of 6 steps and resumed from the checkpoint, bitwise the parameters of
    an unbroken run."""
    cfg = get_arch("olmo-1b").smoke()
    data = SyntheticTokens(DataConfig(global_batch=2, seq_len=16, vocab=cfg.vocab))
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        out_a = train_loop(cfg, init_params(cfg, 42, device="cpu"), data,
                           optimizer=adamw(1e-3),
                           loop=TrainLoopConfig(steps=6, ckpt_every=100, ckpt_dir=d1))
        train_loop(cfg, init_params(cfg, 42, device="cpu"), data, optimizer=adamw(1e-3),
                   loop=TrainLoopConfig(steps=3, ckpt_every=3, ckpt_dir=d2))
        out_b = train_loop(cfg, init_params(cfg, 42, device="cpu"), data,
                           optimizer=adamw(1e-3),
                           loop=TrainLoopConfig(steps=6, ckpt_every=100, ckpt_dir=d2))
    for a, b in zip(out_a["params"].parameters(), out_b["params"].parameters()):
        assert torch.equal(a, b)
    assert out_b["n_dispatches"] == 3


def test_chunked_loop_is_bitwise_the_stepwise_loop():
    cfg = get_arch("zamba2-7b").smoke()
    data = SyntheticTokens(DataConfig(2, 8, cfg.vocab))
    runs = []
    for k in (1, 2):
        runs.append(train_loop(cfg, init_params(cfg, 0, device="cpu"), data,
                               optimizer=adamw(1e-3), opts=ModelOptions(remat=True),
                               loop=TrainLoopConfig(steps=3, log_every=1,
                                                    steps_per_call=k)))
    assert runs[0]["losses"] == runs[1]["losses"]
    assert runs[1]["n_dispatches"] == 2
    for a, b in zip(runs[0]["params"].parameters(), runs[1]["params"].parameters()):
        assert torch.equal(a, b)


# -- the launcher --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-7b", "olmo-1b"])
def test_launch_train_prints_its_losses(capsys, arch):
    launch_train.main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={get_arch(arch).smoke().name}" in out
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "dispatches: 2" in out
