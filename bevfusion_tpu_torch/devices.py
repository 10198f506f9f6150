"""The device an entry point runs on.

The port's entry points (``models.build_model``, ``runtime.flagship``'s
builders, ``runtime.train.make_train_step``) run on the card unless the
caller asks for the CPU: their ``device`` defaults to ``"cuda"``, and a
CUDA device where PyTorch sees none raises rather than falling back.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: torch.cuda.is_available() is false; "
                           "pass device='cpu' to run on the CPU")
    return dev
