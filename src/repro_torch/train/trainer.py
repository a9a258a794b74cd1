"""The neural-SDE training step (port of ``repro.train.trainer.make_sde_train_step``,
the single-device path).

One Monte-Carlo batch of ``n_paths`` trajectories through
:func:`~repro_torch.core.sdeint.sdeint`, a loss on the result, gradients
with respect to the parameters of the ``nn.Module`` the vector field takes
as ``args``, one optimizer update.  Under the default
``adjoint="reversible"`` the gradients come from the O(1)-memory
reversible backward sweep.

The step never waits on the device: keys are derived on the device, the
guard's skip decision is a ``torch.where`` select, and the optimizer's step
counter is a device tensor.  Loss and metrics come back as device tensors.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.pytree import tree_blowup, tree_map
from ..core.registry import get_solver
from ..core.sdeint import path_keys, sdeint
from ..device import not_yet_ported, resolve_device

__all__ = ["make_sde_train_step"]


def make_sde_train_step(
    solver,
    term,
    optimizer,
    y0_fn: Callable,
    loss_fn_result: Callable,
    *,
    t0: float,
    t1: float,
    n_steps: int,
    n_paths: int,
    adjoint: str = "reversible",
    save_every: Optional[int] = None,
    save_at=None,
    rtol: Optional[float] = None,
    atol: Optional[float] = None,
    remat_chunk: Optional[int] = None,
    bulk_increments: bool = True,
    noise_shape=None,
    guard: bool = True,
    microbatches: int = 1,
    mesh=None,
    mesh_axis: Optional[str] = None,
    device=None,
):
    """Neural-SDE training step ``(params, opt_state, key) -> (params,
    opt_state, metrics)``, as the reference's.

    ``params`` is the ``nn.Module`` (e.g. :class:`~repro_torch.nsde.LSDE`)
    the term takes as ``args``; ``y0_fn(params)`` is the shared initial
    state and ``loss_fn_result(params, result)`` maps the batched
    :class:`~repro_torch.core.SolveResult` (leading axis ``n_paths``) to a
    scalar.  Path ``i`` draws its noise from ``path_keys(key, n_paths)[i]``.
    ``opt_state`` is ``optimizer.init(list(params.parameters()))``.

    The step writes the updated values into the module's parameters in
    place (the module is returned, so the loop reads as the reference's);
    ``opt_state`` is replaced, not changed.  ``metrics`` holds device
    tensors: ``loss``, ``grad_norm`` and, with ``guard`` (default), the
    bool ``skipped`` — a non-finite loss or gradient skips the update
    (parameters and optimizer state pass through unchanged).

    ``device`` (default ``"cuda"``, which raises without a GPU) is where the
    step runs; ``key``, ``params`` and the loss's data live there.
    ``microbatches > 1`` and ``mesh``/``mesh_axis`` are not ported yet.
    """
    device = resolve_device(device)
    solver = get_solver(solver)
    if int(microbatches) > 1:
        raise not_yet_ported("microbatched gradient accumulation (microbatches > 1)")
    if mesh is not None or mesh_axis is not None:
        raise not_yet_ported("mesh data parallelism (mesh/mesh_axis)")

    def step(params, opt_state, key):
        leaves = list(params.parameters())
        r = sdeint(term, solver, t0, t1, n_steps, y0_fn(params), None,
                   args=params, adjoint=adjoint, save_every=save_every,
                   save_at=save_at, rtol=rtol, atol=atol, remat_chunk=remat_chunk,
                   noise_shape=noise_shape, batch_keys=path_keys(key, n_paths),
                   bulk_increments=bulk_increments, device=device)
        loss = loss_fn_result(params, r)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        old = [p.detach() for p in leaves]
        new_p, new_s, gnorm = optimizer.update(grads, opt_state, old)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm}
        if guard:
            bad = tree_blowup(grads) | ~torch.isfinite(loss.detach())
            keep = lambda new, prev: torch.where(bad, prev, new)  # noqa: E731
            new_p, new_s = tree_map(keep, (new_p, new_s), (old, opt_state))
            metrics["skipped"] = bad
        with torch.no_grad():
            for p, v in zip(leaves, new_p):
                p.copy_(v)
        return params, new_s, metrics

    return step
