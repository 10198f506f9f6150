"""Checkpoints: the port's weights on disk, and the reference's.

Counterpart of ``bevfusion_tpu/runtime/checkpoint.py`` (reference: mmcv
CheckpointHook, interval 1 epoch, max_keep_ckpts 1, configs/default.yaml:
4-6; resume_from vs load_from, mmdet3d/apis/train.py:122-125). A
checkpoint is one ``torch.save`` of ``{"state_dict": ..., "meta": ...}``,
the layout of the reference's released ``.pth`` files, whose keys the
port's modules carry, and, for a run that may resume, ``"optimizer"`` (the
optimizer's ``state_dict``) beside them with ``meta`` holding ``epoch`` and
``iter``, as mmcv writes it. ``restore_checkpoint`` (resume) loads the
weights with ``load_state_dict(strict=True)`` and the optimizer's state;
``load_weights`` (load_from) loads the keys that are there, as mmcv's
``load_checkpoint(strict=False)`` does, and names the rest. The JAX
package's load_from replaces the whole parameter tree instead
(tools/train.py:107-110), so a fused run started from a LiDAR-only
checkpoint has no camera branch there (ROADMAP Queue 3). The JAX
package's checkpoints are orbax directories of flax variables;
``runtime/bridge.py:jax_to_torch_state_dict`` turns those variables into
the port's state dict. No layout conversion
(the JAX module's ``convert_torch_state_dict``) is needed here.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

__all__ = ["save_checkpoint", "restore_checkpoint", "load_weights"]

# the names that ``keep`` prunes among (the JAX module's, :38), with the
# reference's ``.pth`` suffix allowed; any other name (``best``) is kept
_PRUNED = re.compile(r"^(step|epoch)_(\d+)(\.pth)?$")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(path: str, model: nn.Module, keep: int = 1,
                    meta: Optional[Dict[str, Any]] = None, optimizer=None) -> None:
    """Save ``model``'s state dict (on the CPU), ``meta`` and, given an
    ``optimizer`` (``runtime/train.py:AdamW``), its state at ``path``, then
    prune the ``step_N`` / ``epoch_N`` checkpoints beside it to the newest
    ``keep`` by N. The file is written whole or not at all (a temporary
    file renamed into place)."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    ckpt = {"state_dict": _to_cpu(model.state_dict()), "meta": dict(meta or {})}
    if optimizer is not None:
        ckpt["optimizer"] = _to_cpu(optimizer.state_dict())
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    ckpts = sorted((m for m in map(_PRUNED.match, os.listdir(parent)) if m),
                   key=lambda m: int(m.group(2)))
    for stale in ckpts[:max(len(ckpts) - keep, 0)]:
        os.remove(os.path.join(parent, stale.group(0)))


def _load(path: str) -> Dict[str, Any]:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint of the JAX package? Restore it there "
            "and carry its variables across with bevfusion_tpu_torch/runtime/bridge.py "
            "(jax_to_torch_state_dict), then save_checkpoint")
    # weights_only=False: the reference's .pth keeps mmcv's meta objects beside the tensors
    return torch.load(path, map_location="cpu", weights_only=False)


def restore_checkpoint(path: str, model: nn.Module, optimizer=None) -> Dict[str, Any]:
    """Load the weights at ``path`` (the port's checkpoint, a reference
    ``.pth`` with its ``state_dict``, or a bare state dict) into ``model``,
    strictly: a missing or unexpected key raises; given an ``optimizer``,
    also its state, which the file must hold (resume). Returns the file's
    ``meta`` ({} where it has none). An orbax directory of the JAX package
    raises a ValueError that says how to carry it across."""
    ckpt = _load(path)
    state = ckpt.get("state_dict", ckpt)
    model.load_state_dict(state, strict=True)
    if optimizer is not None:
        if "optimizer" not in ckpt:
            raise KeyError(f"{path} holds no optimizer state: resume needs a checkpoint that "
                           "save_checkpoint wrote with its optimizer (load_weights loads the "
                           "weights alone)")
        optimizer.load_state_dict(ckpt["optimizer"])
    return dict(ckpt.get("meta") or {}) if "state_dict" in ckpt else {}


def load_weights(path: str, model: nn.Module) -> Tuple[List[str], List[str]]:
    """Load the weights at ``path`` (as ``restore_checkpoint`` reads it) into
    ``model`` where the names match, as mmcv's ``load_checkpoint(strict=
    False)`` does: returns (missing, unexpected), the model's keys that the
    file lacks and the file's keys that the model lacks. A key present in
    both with another shape raises."""
    ckpt = _load(path)
    state = ckpt.get("state_dict", ckpt)
    own = model.state_dict()
    wrong = [f"{k}: {tuple(v.shape)} in the file, {tuple(own[k].shape)} in the model"
             for k, v in state.items() if k in own and v.shape != own[k].shape]
    if wrong:
        raise ValueError(f"{path}: {len(wrong)} shape mismatches, e.g. " + "; ".join(wrong[:3]))
    result = model.load_state_dict(state, strict=False)
    return list(result.missing_keys), list(result.unexpected_keys)
