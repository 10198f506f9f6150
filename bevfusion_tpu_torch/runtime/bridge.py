"""The JAX package's variables as the port's state dict.

Inverts the layout rules of the JAX package's checkpoint adapter (which
maps a reference torch checkpoint onto flax variables), through the
port's copy of its rule table (``runtime/adapter.py``): every flax path
is named with ``flax_to_torch_key`` and its array is brought back
to the torch layout:

  flax Conv HWIO               -> Conv2d OIHW
  flax ConvTranspose HWIO      -> ConvTranspose2d IOHW, flipped in space
  Dense [I, O]                 -> Linear [O, I] / Conv1d [O, I, 1]
  sparse conv [K, I, O]        -> spconv [kx, ky, kz, I, O]
  q/k/v Dense                  -> packed MultiheadAttention in_proj

The copied table covers the five BASELINE trees, as the JAX adapter
does; the rules for the trees it lacks (the ResNet camera backbone, the
SECONDFPN camera neck, BEVDepth's DepthNet, the pillar and radar feature
nets, a SECOND as the radar branch's ``pts_bev_encoder``,
AwareDBEVDepth's ``fuse_depth``) are the port's own, in
``PORT_RULES`` below, in the same form, tried after the copied table.
The feature nets' follow mmdet3d's module names (``pts_voxel_encoder.
pfn_layers.{i}``, ``pts_voxel_encoder.rfn_layers.{i}``, each ``.linear``
and ``.norm``); ``fuse_depth.{0,1}`` is a name of the port's own. The
reference is not in the repository, so none of these is checked against
a released checkpoint.

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

__all__ = ["PORT_RULES", "flax_to_torch_key", "jax_to_torch_state_dict"]

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


def _bn(flax: str, torch_: str):
    """A flax BatchNorm's four leaves (under ``flax``) -> torch's."""
    return [(f"{flax}/{f}", f"{torch_}.{t}", adapter._id) for f, t in (
        ("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var"))]


def _port_rules():
    cb, tb = "camera_backbone", "encoders.camera.backbone"
    cn, tn = "camera_neck", "encoders.camera.neck"
    dn, td = "camera_vtransform/depthnet", "encoders.camera.vtransform.depthnet"
    aspp = f"{td}.depth_conv.3"
    R = [  # ResNet camera backbone (bevfusion_tpu/models/resnet_full.py), torchvision names
        (rf"{cb}/stem_conv/conv/kernel", f"{tb}.conv1.weight", adapter._conv),
        *_bn(rf"{cb}/stem_bn/bn", f"{tb}.bn1"),
        (rf"{cb}/layer(\d+)_block(\d+)/conv([123])/conv/kernel",
         tb + ".layer{1}.{2}.conv{3}.weight", adapter._conv),
        *_bn(rf"{cb}/layer(\d+)_block(\d+)/bn([123])/bn", tb + ".layer{1}.{2}.bn{3}"),
        (rf"{cb}/layer(\d+)_block(\d+)/downsample_conv/conv/kernel",
         tb + ".layer{1}.{2}.downsample.0.weight", adapter._conv),
        *_bn(rf"{cb}/layer(\d+)_block(\d+)/downsample_bn/bn", tb + ".layer{1}.{2}.downsample.1"),
        # SECONDFPN as the camera neck (necks/second.py:48-99)
        (rf"{cn}/deblock(\d+)_conv/conv/kernel", tn + ".deblocks.{1}.0.weight", adapter._conv),
        (rf"{cn}/deblock(\d+)_deconv/kernel", tn + ".deblocks.{1}.0.weight", adapter._deconv),
        *_bn(rf"{cn}/deblock(\d+)_bn/bn", tn + ".deblocks.{1}.1"),
        # AwareBEVDepth's DepthNet (models/bevdepth.py), BEVDepth's names
        (rf"{dn}/reduce/Conv_0/conv/kernel", f"{td}.reduce_conv.0.weight", adapter._conv),
        (rf"{dn}/reduce/Conv_0/conv/bias", f"{td}.reduce_conv.0.bias", adapter._id),
        *_bn(rf"{dn}/reduce/Norm_0/bn", f"{td}.reduce_conv.1"),
        *_bn(rf"{dn}/mlp_bn/bn", f"{td}.bn"),
        (rf"{dn}/(depth|context)_mlp_fc([12])/kernel", td + ".{1}_mlp.fc{2}.weight", adapter._lin),
        (rf"{dn}/(depth|context)_mlp_fc([12])/bias", td + ".{1}_mlp.fc{2}.bias", adapter._id),
        (rf"{dn}/context_conv/conv/kernel", f"{td}.context_conv.weight", adapter._conv),
        (rf"{dn}/context_conv/conv/bias", f"{td}.context_conv.bias", adapter._id),
        (rf"{dn}/res(\d+)/conv([12])/conv/kernel", td + ".depth_conv.{1}.conv{2}.weight",
         adapter._conv),
        *_bn(rf"{dn}/res(\d+)/bn([12])/bn", td + ".depth_conv.{1}.bn{2}"),
        (rf"{dn}/aspp/aspp(\d)_conv/kernel", aspp + ".aspp{1+}.atrous_conv.weight", adapter._conv),
        *_bn(rf"{dn}/aspp/aspp(\d)_bn/bn", aspp + ".aspp{1+}.bn"),
        (rf"{dn}/aspp/gp_conv/conv/kernel", f"{aspp}.global_avg_pool.1.weight", adapter._conv),
        *_bn(rf"{dn}/aspp/gp_bn/bn", f"{aspp}.global_avg_pool.2"),
        (rf"{dn}/aspp/out_conv/conv/kernel", f"{aspp}.conv1.weight", adapter._conv),
        *_bn(rf"{dn}/aspp/out_bn/bn", f"{aspp}.bn1"),
    ]
    # the pillar and radar feature nets (models/{pillar,radar}_encoder.py), mmdet3d's names
    for branch, net, layer in (("lidar", "PillarFeatureNet_0/pfn", "pfn_layers"),
                               ("radar", "RadarFeatureNet_0/rfn", "rfn_layers")):
        fx, tx = f"{branch}_backbone/{net}", f"encoders.{branch}.backbone.pts_voxel_encoder.{layer}"
        R += [(rf"{fx}(\d+)/linear/kernel", tx + ".{1}.linear.weight", adapter._lin),
              *_bn(rf"{fx}(\d+)/norm/bn", tx + ".{1}.norm")]
    # a SECOND as RadarEncoder's optional pts_bev_encoder (no config sets one)
    fs, ts = "radar_backbone/SECOND_0", "encoders.radar.backbone.pts_bev_encoder"
    R += [(rf"{fs}/block(\d+)_conv(\d+)/conv/kernel", ts + ".blocks.{1}.{2*3}.weight",
           adapter._conv),
          *_bn(rf"{fs}/block(\d+)_bn(\d+)/bn", ts + ".blocks.{1}.{2*3+1}")]
    # AwareDBEVDepth's fuse_depth (models/bevdepth.py), a name of the port's own
    fd, tf = "camera_vtransform/fuse_depth", "encoders.camera.vtransform.fuse_depth"
    R += [(rf"{fd}/Conv_0/conv/kernel", f"{tf}.0.weight", adapter._conv),
          (rf"{fd}/Conv_0/conv/bias", f"{tf}.0.bias", adapter._id),
          *_bn(rf"{fd}/Norm_0/bn", f"{tf}.1")]
    for flax, i in (("post_conv", 4), ("depth_out", 6)):
        R += [(rf"{dn}/{flax}/conv/kernel", f"{td}.depth_conv.{i}.weight", adapter._conv),
              (rf"{dn}/{flax}/conv/bias", f"{td}.depth_conv.{i}.bias", adapter._id)]
    R += _bn(rf"{dn}/post_bn/bn", f"{td}.depth_conv.5") + _bn(rf"{dn}/depth_out_bn/bn",
                                                              f"{td}.depth_conv.7")
    return R


PORT_RULES = [(re.compile("^" + rx + "$"), tmpl, cv) for rx, tmpl, cv in _port_rules()]


def flax_to_torch_key(path: str):
    """flax 'a/b/c' path -> (torch key, converter) or None: the copied
    table first, then ``PORT_RULES``."""
    hit = adapter.flax_to_torch_key(path)
    if hit is not None:
        return hit
    for rx, tmpl, cv in PORT_RULES:
        m = rx.match(path)
        if m:
            return adapter._fill(tmpl, m), cv
    return None


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
            hit = flax_to_torch_key(path)
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
