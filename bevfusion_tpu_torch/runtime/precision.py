"""The compute precision of a model, in one place.

Counterpart of the JAX package's ``dtype`` (``build_model(cfg, dtype)``,
every module's ``dtype`` field) and of ``tools/train.py:69-74``, which
reads a config's ``precision.compute_dtype`` (``configs/default.yaml``:
``bfloat16``). One compute dtype a model:

- ``float32``: every op in fp32. On the card cuDNN's convolutions run in
  TF32 and cuBLAS's matmuls do not (``TF32``, PyTorch's own defaults,
  set explicitly by ``apply_tf32_defaults``: the entry points call it, so
  their fp32 numbers do not move). Parity checks turn both off.
- ``bfloat16``: the parameters, their gradients and AdamW's moments stay
  fp32, so a state dict is the same at either dtype. The forward runs
  under ``autocast``: cuDNN's convolutions and cuBLAS's matmuls take bf16
  copies of their inputs and weights and return bf16 (flax's
  ``promote_dtype`` under ``dtype=bfloat16``); the sparse convs run the
  bf16 kernels on bf16 rows (``ops/sparse_conv.py:SparseConvFunction``
  casts the fp32 weight inside, so its gradient is K3's fp32 dW). fp32
  islands, where the JAX package upcasts: the geometry and camera
  matrices; the depth softmax, the context into the pool and the pool
  (K4 is fp32 at either dtype); BatchNorm moments and the folded
  scale/shift; LayerNorm's statistics; the attention logits and their
  softmax; the heatmap sigmoid, the query positions and the decoded
  boxes; every loss; the auction's costs. The BEV map is cast to the
  compute dtype after the pool. No loss scaling: the JAX package has
  none for bf16 (``bevfusion_tpu/runtime/train.py:12-14``).

Unlike the JAX package, the port adds the TransFusion query positions to
the centers in fp32 and decodes in fp32: the JAX package adds them in
bf16 (``heads/transfusion.py:139``) and decodes in bf16, which rounds a
center near 54 m to a 0.25 m lattice (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

__all__ = ["COMPUTE_DTYPES", "TF32", "parse_dtype", "dtype_name", "config_dtype",
           "apply_tf32_defaults", "autocast", "fp32_region", "to_compute", "upcast"]

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the fp32 runs' TF32 switches: cuDNN's convolutions on, cuBLAS's matmuls off
TF32 = {"cudnn": True, "matmul": False}


def parse_dtype(name) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` (or the torch dtype) -> the dtype;
    anything else raises."""
    if isinstance(name, torch.dtype) and name in COMPUTE_DTYPES.values():
        return name
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {name!r}: the port computes in "
                         f"{' or '.join(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def dtype_name(dtype: torch.dtype) -> str:
    return next(k for k, v in COMPUTE_DTYPES.items() if v == dtype)


def config_dtype(cfg: Mapping[str, Any]) -> torch.dtype:
    """A config's ``precision.compute_dtype`` (fp32 where it has none)."""
    return parse_dtype((cfg.get("precision") or {}).get("compute_dtype") or "float32")


def apply_tf32_defaults() -> None:
    """Set the TF32 switches of the fp32 runs (``TF32``)."""
    torch.backends.cudnn.allow_tf32 = TF32["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = TF32["matmul"]


def autocast(dtype: torch.dtype, device) -> torch.autocast:
    """The forward's autocast on ``device``'s type: on at bf16, off (a no-op
    context) at fp32."""
    device_type = torch.device(device).type
    return torch.autocast(device_type, dtype=torch.bfloat16, enabled=dtype == torch.bfloat16)


def fp32_region(x: torch.Tensor) -> torch.autocast:
    """Autocast off on ``x``'s device type: the matmuls of an fp32 island
    keep their inputs' dtype."""
    return torch.autocast(x.device.type, enabled=False)


def to_compute(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in the compute dtype: bf16 casts; fp32 leaves ``x`` as it is
    (so a model made float64 for a reference run stays float64)."""
    return x.to(dtype) if dtype == torch.bfloat16 and x.is_floating_point() else x


def upcast(tree):
    """Every bf16 / fp16 tensor of a (nested dict / list / tuple) tree in
    fp32, the rest as it is: the predictions into the decode and the
    losses."""
    if isinstance(tree, dict):
        return {k: upcast(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(upcast(v) for v in tree)
    if torch.is_tensor(tree) and tree.dtype in (torch.bfloat16, torch.float16):
        return tree.float()
    return tree
