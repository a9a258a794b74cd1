"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper GPUs.

A package of its own beside the JAX reference ``repro``, mirroring its
layout and names; it imports ``torch``, ``numpy`` and the standard library
only.  Entry points run on ``device="cuda"`` by default and raise where no
GPU is found unless the caller asks for ``device="cpu"``.

Two paths are ported.  Serving EES(2,5)/EES(2,7) Monte-Carlo sampling
requests of the neural Langevin SDE: ``serving.SDESampleEngine`` →
``core.sdeint_ticks`` → ``core.solve`` → ``core.LowStorageSolver``.  And
training it as the paper's Table 1 does: ``train.make_sde_train_step`` →
``core.sdeint`` → ``core.solve(adjoint="reversible")`` (O(1) memory) →
``optim.adamw``, under EES(2,5), Reversible Heun and MCF.  With
``use_kernels=True`` both run through the hand-written CUDA kernels in
``kernels/`` (``sde_step``: the fused Williamson stage and its VJP, the
driver-weighted increment, the Butcher axpy chain; ``williamson2n``: the 2N
update).  What is not ported yet raises
:class:`~repro_torch.device.NotYetPorted`.
"""
from .device import NotYetPorted, resolve_device

__all__ = ["NotYetPorted", "resolve_device"]
