"""Checkpoints: the port's weights on disk, and the reference's.

Counterpart of ``bevfusion_tpu/runtime/checkpoint.py`` (reference: mmcv
CheckpointHook, interval 1 epoch, max_keep_ckpts 1, configs/default.yaml:
4-6). A checkpoint is one ``torch.save`` of ``{"state_dict": ..., "meta":
...}``, the layout of the reference's released ``.pth`` files, whose keys
the port's modules carry: ``restore_checkpoint`` loads either with
``load_state_dict(strict=True)``. The JAX package's checkpoints are orbax
directories of flax variables; ``runtime/bridge.py:jax_to_torch_state_dict``
turns those variables into the port's state dict. No layout conversion
(the JAX module's ``convert_torch_state_dict``) is needed here.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

__all__ = ["save_checkpoint", "restore_checkpoint"]

# the names that ``keep`` prunes among (the JAX module's, :38), with the
# reference's ``.pth`` suffix allowed; any other name (``best``) is kept
_PRUNED = re.compile(r"^(step|epoch)_(\d+)(\.pth)?$")


def save_checkpoint(path: str, model: nn.Module, keep: int = 1,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Save ``model``'s state dict (on the CPU) and ``meta`` at ``path``, then
    prune the ``step_N`` / ``epoch_N`` checkpoints beside it to the newest
    ``keep`` by N. The file is written whole or not at all (a temporary
    file renamed into place)."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = path + ".tmp"
    torch.save({"state_dict": state, "meta": dict(meta or {})}, tmp)
    os.replace(tmp, path)
    ckpts = sorted((m for m in map(_PRUNED.match, os.listdir(parent)) if m),
                   key=lambda m: int(m.group(2)))
    for stale in ckpts[:max(len(ckpts) - keep, 0)]:
        os.remove(os.path.join(parent, stale.group(0)))


def restore_checkpoint(path: str, model: nn.Module) -> Dict[str, Any]:
    """Load the weights at ``path`` (the port's checkpoint, a reference
    ``.pth`` with its ``state_dict``, or a bare state dict) into ``model``,
    strictly: a missing or unexpected key raises. Returns the file's
    ``meta`` ({} where it has none). An orbax directory of the JAX package
    raises a ValueError that says how to carry it across."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint of the JAX package? Restore it there "
            "and carry its variables across with bevfusion_tpu_torch/runtime/bridge.py "
            "(jax_to_torch_state_dict), then save_checkpoint")
    # weights_only=False: the reference's .pth keeps mmcv's meta objects beside the tensors
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("state_dict", ckpt)
    model.load_state_dict(state, strict=True)
    return dict(ckpt.get("meta") or {}) if "state_dict" in ckpt else {}
