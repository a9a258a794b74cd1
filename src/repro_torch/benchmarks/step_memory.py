"""Peak tensor memory of one Table-1 training step, counted op by op.

:class:`LiveBytes` is a ``TorchDispatchMode`` that adds up the storage of
every tensor an operator creates and subtracts it when the storage is freed,
so it reads the peak of live tensor bytes on any device, the CPU included.
Tensors made before the mode is entered (the step's inputs) are not
counted, as ``torch.cuda.max_memory_allocated`` above a baseline does not
count them; the allocator adds its rounding on top.  So a count on the CPU
predicts the card's peak for the same step without a run on the card.

``python -m repro_torch.benchmarks.step_memory --device cpu --paths 2048``
counts one EES(2,5) step of Table 1 under the reversible adjoint (with bulk
and with per-step increments) and the full adjoint, at 8 and 64 steps, and
prints each peak and its value scaled linearly to 65,536 paths (every
tensor the step makes has a path axis; the parameters are inputs).  The
bulk draw's pass size is scaled by the same factor, so its passes hold the
rows they hold at 65,536 paths.
"""
from __future__ import annotations

import argparse
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["LiveBytes", "step_peak"]


class LiveBytes(TorchDispatchMode):
    """Live and peak bytes of the tensor storages created while active."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = set()

    def _release(self, nbytes: int, ptr: int) -> None:
        self.live -= nbytes
        self._seen.discard(ptr)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            ptr, nbytes = storage.data_ptr(), storage.nbytes()
            if nbytes == 0 or ptr in self._seen:  # a view, or an input
                continue
            self._seen.add(ptr)
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._release, nbytes, ptr)
        return out


def step_peak(n_paths: int, n_steps: int, *, device, **kw) -> int:
    """Peak live bytes of one ``ees25:use_kernels=True`` Table-1 training
    step of ``n_paths`` paths and ``n_steps`` steps (``save_every =
    n_steps / 2``); ``kw`` goes to ``make_sde_train_step``."""
    from ..core import prng
    from ..nsde import init_lsde, lsde_readout, lsde_term, moment_mse
    from ..optim import adamw
    from ..train import make_sde_train_step
    from . import table1_ou as t1

    params = init_lsde(0, t1.D_OBS, t1.D_Z, t1.WIDTH, device=device)
    tgt = torch.as_tensor(t1.target_paths(), dtype=torch.float32, device=device)
    opt = adamw(1e-2)
    step = make_sde_train_step(
        "ees25:use_kernels=True", lsde_term(), opt,
        y0_fn=lambda p: torch.zeros(t1.D_Z, device=device) + p.encoder.b,
        loss_fn_result=lambda p, r: moment_mse(lsde_readout(p, r.ys)[..., 0], tgt),
        t0=0.0, t1=t1.T, n_steps=n_steps, n_paths=n_paths,
        save_every=n_steps // 2, device=device, **kw)
    state = opt.init(list(params.parameters()))
    key = prng.PRNGKey(1, device=device)
    with LiveBytes() as live:
        step(params, state, key)
    return live.peak


def main(argv=None) -> None:
    from ..core import brownian

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--paths", type=int, default=2048)
    a = ap.parse_args(argv)
    scale = 65536 / a.paths
    brownian.BULK_PASS_ELEMENTS = int(brownian.BULK_PASS_ELEMENTS / scale)
    configs = (("reversible", dict(adjoint="reversible")),
               ("full", dict(adjoint="full")),
               ("reversible, per-step noise",
                dict(adjoint="reversible", bulk_increments=False)))
    for n_steps in (8, 64):
        for label, kw in configs:
            peak = step_peak(a.paths, n_steps, device=a.device, **kw) / 2**20
            print(f"{n_steps:3d} steps, adjoint={label}: peak {peak:.1f} MiB "
                  f"at {a.paths} paths, {peak * scale:.1f} MiB scaled to "
                  f"65536", flush=True)


if __name__ == "__main__":
    main()
