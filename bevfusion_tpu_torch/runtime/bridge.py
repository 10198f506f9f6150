"""The JAX package's variables as the port's state dict.

Inverts the layout rules of the JAX package's checkpoint adapter (which
maps a reference torch checkpoint onto flax variables), through the
port's copy of its rule table (``runtime/adapter.py``): every flax path
is named with ``adapter.flax_to_torch_key`` and its array is brought back
to the torch layout:

  flax Conv HWIO               -> Conv2d OIHW
  flax ConvTranspose HWIO      -> ConvTranspose2d IOHW, flipped in space
  Dense [I, O]                 -> Linear [O, I] / Conv1d [O, I, 1]
  sparse conv [K, I, O]        -> spconv [kx, ky, kz, I, O]
  q/k/v Dense                  -> packed MultiheadAttention in_proj

The port's modules carry the reference checkpoint's names, so the
result loads with ``load_state_dict(strict=True)``; so would a released
``.pth``. Strict like ``load_reference_weights(strict=True)``: a flax
path without a rule, or two paths claiming one key, raise. Swin's
``relative_position_index`` buffers, constants with no flax counterpart,
are emitted beside each bias table from the window size it implies.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from ..models.swin import relative_position_index
from . import adapter

__all__ = ["jax_to_torch_state_dict"]

_QKV = ("q_proj", "k_proj", "v_proj")


def _walk(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v, np.float32)


def _spconv_shape(key: str, a: np.ndarray):
    """[K, I, O] -> [kx, ky, kz, I, O]: the encoder's conv_out is (1, 1, K),
    every other sparse conv a cube."""
    K = a.shape[0]
    if key.endswith("conv_out.0.weight"):
        return (1, 1, K) + a.shape[1:]
    k = round(K ** (1 / 3))
    if k ** 3 != K:
        raise ValueError(f"{key}: {K} offsets are not a cube")
    return (k, k, k) + a.shape[1:]


_INVERSE = {
    adapter._conv: lambda a, key: a.transpose(3, 2, 0, 1),
    adapter._deconv: lambda a, key: a[::-1, ::-1].transpose(2, 3, 0, 1),
    adapter._lin: lambda a, key: a.T,
    adapter._conv1d: lambda a, key: a.T[:, :, None],
    adapter._spconv: lambda a, key: a.reshape(_spconv_shape(key, a)),
    adapter._id: lambda a, key: a,
}


def jax_to_torch_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``variables``: {"params": ..., "batch_stats": ...} trees of arrays
    (flax layout, as ``model.init`` returns them) -> torch state dict."""
    paths = {col: dict(_walk(variables.get(col, {}))) for col in ("params", "batch_stats")}
    sd: Dict[str, np.ndarray] = {}
    packed: Dict[str, list] = {}
    unmapped = []

    def put(key, value, path):
        if key in sd:
            raise ValueError(f"{path} and another flax path both map to {key}")
        sd[key] = value

    for col, leaves in paths.items():
        for path, a in leaves.items():
            hit = adapter.flax_to_torch_key(path)
            if hit is None:
                unmapped.append(f"{col}:{path}")
                continue
            key, cv = hit
            if key.endswith(("in_proj_weight", "in_proj_bias")):
                parts = packed.setdefault(key, [None] * 3)
                parts[_QKV.index(path.split("/")[-2])] = a.T if a.ndim == 2 else a
                continue
            if ".last." in key:
                # a prediction branch's final conv follows its hidden layers:
                # TransFusion's flat (Conv1d, BN, ReLU) triples (``_fc``) or
                # CenterHead's ConvModules (``_conv``), one index each
                branch = re.escape(path.rsplit("_out/", 1)[0])
                n_fc = sum(bool(re.fullmatch(branch + r"_fc\d+/kernel", p)) for p in leaves)
                n_conv = sum(bool(re.fullmatch(branch + r"_conv\d+/Conv_0/conv/kernel", p))
                             for p in leaves)
                key = key.replace(".last.", f".{3 * n_fc + n_conv}.")
            put(key, np.array(_INVERSE[cv](a, key), order="C"), path)
            if key.endswith("running_mean"):
                put(key[:-len("running_mean")] + "num_batches_tracked", np.array(0), path)
            if key.endswith("relative_position_bias_table"):  # [(2*ws - 1)**2, heads]
                ws = (round(a.shape[0] ** 0.5) + 1) // 2
                put(key.replace("bias_table", "index"),
                    relative_position_index(ws).astype(np.int64), path)
    if unmapped:
        raise ValueError("flax paths without a torch key:\n" + "\n".join(unmapped[:20]))
    for key, parts in packed.items():
        if any(p is None for p in parts):
            raise ValueError(f"{key}: q/k/v projections incomplete")
        put(key, np.concatenate(parts, 0), key)
    return {k: torch.from_numpy(v) for k, v in sd.items()}
