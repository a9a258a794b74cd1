"""Device resolution for the port's entry points.

The port runs on the GPU.  Every entry point that creates tensors from
nothing (keys, grids, parameters, engines) takes ``device=`` and resolves it
here: the default is ``"cuda"``, and a machine without CUDA raises instead of
quietly running on the CPU.  Callers that mean the CPU say so with
``device="cpu"`` (the CPU tests do).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "NotYetPorted", "not_yet_ported"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a :class:`torch.device`, defaulting to ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


class NotYetPorted(NotImplementedError):
    """A feature of the JAX reference that this package does not have yet."""


def not_yet_ported(feature: str) -> NotYetPorted:
    """The error an entry point raises for a reference feature still to port."""
    return NotYetPorted(
        f"{feature} is not yet ported to repro_torch (see ROADMAP.md queue A); "
        "the JAX reference package repro has it"
    )
