"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper GPUs.

A package of its own beside the JAX reference ``repro``, mirroring its
layout and names; it imports ``torch``, ``numpy`` and the standard library
only.  Entry points run on ``device="cuda"`` by default and raise where no
GPU is found unless the caller asks for ``device="cpu"``.

Three paths are ported.  Serving EES(2,5)/EES(2,7) Monte-Carlo sampling
requests of the neural Langevin SDE: ``serving.SDESampleEngine`` →
``core.sdeint_ticks`` → ``core.solve`` → ``core.LowStorageSolver``.
Training it as the paper's Table 1 does: ``train.make_sde_train_step`` →
``core.sdeint`` → ``core.solve(adjoint="reversible")`` (O(1) memory) →
``optim.adamw``, under EES(2,5), Reversible Heun and MCF.  With
``use_kernels=True`` both run through the hand-written CUDA kernels in
``kernels/`` (``sde_step``: the fused Williamson stage and its VJP, the
driver-weighted increment, the Butcher axpy chain, their prediffused and
general-noise forms; ``williamson2n``: the 2N update).  And the LM
substrate's inference path for the ``dense``, ``ssm`` and ``hybrid``
families (``configs``, ``models``): prefill through ``models.forward`` and
decode through ``serving.Engine`` → ``models.serve_step``, the full-sequence
pass running the ``flash_attention`` and ``ssd_scan`` CUDA kernels on the
card.  What is not ported yet raises
:class:`~repro_torch.device.NotYetPorted`.
"""
from .device import NotYetPorted, resolve_device

__all__ = ["NotYetPorted", "resolve_device"]
