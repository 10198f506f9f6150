"""The flax <-> torch naming and layout rule table of the JAX package.

A copy of the rule table of ``bevfusion_tpu/runtime/adapter.py`` (the
layout converters, ``_rules()`` with its helpers, and
``flax_to_torch_key``), so the port's weight bridge reads no module of
the JAX package. Numpy and ``re`` only. ``tests/test_torch_adapter.py``
holds it to the original: for every flax path of the five BASELINE
config trees both tables give the same torch key and the same converter.

Rules are (flax-path regex) -> (torch key template, converter); the
converters map a torch array to the flax layout.
"""
from __future__ import annotations

import re
from typing import Callable, List, Tuple

import numpy as np

__all__ = ["flax_to_torch_key"]


def _np(t):
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def _conv(w):  # torch Conv2d OIHW -> flax HWIO
    return _np(w).transpose(2, 3, 1, 0)


def _deconv(w):  # torch ConvTranspose2d IOHW -> flax ConvTranspose HWIO
    return np.ascontiguousarray(_np(w).transpose(2, 3, 0, 1)[::-1, ::-1])


def _lin(w):  # torch Linear [O, I] -> [I, O]
    return _np(w).T


def _conv1d(w):  # torch Conv1d [O, I, 1] -> Dense [I, O]
    return _np(w)[:, :, 0].T


def _spconv(w):  # spconv [k0, k1, k2, I, O] -> [K, I, O] (z-minor)
    a = _np(w)
    return a.reshape(-1, a.shape[-2], a.shape[-1])


def _id(w):
    return _np(w)


# ---------------------------------------------------------------------
# rule table: (flax regex, torch key template, converter)
# groups: \1.. from the regex; templates use {1}, {2}, ...
# ---------------------------------------------------------------------

def _mha_rules(flax_prefix: str, torch_prefix: str):
    """Vendored torch MultiheadAttention (models/utils/transformer.py:
    114-494): packed in_proj -> q/k/v Dense."""
    out = []
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out += [
            (rf"{flax_prefix}/{name}/kernel",
             f"{torch_prefix}.in_proj_weight",
             lambda w, i=i: _pack_slice(w, i).T),
            (rf"{flax_prefix}/{name}/bias",
             f"{torch_prefix}.in_proj_bias",
             lambda w, i=i: _pack_slice(w, i)),
        ]
    out += [
        (rf"{flax_prefix}/out_proj/kernel", f"{torch_prefix}.out_proj.weight", _lin),
        (rf"{flax_prefix}/out_proj/bias", f"{torch_prefix}.out_proj.bias", _id),
    ]
    return out


def _pack_slice(w, i):
    a = _np(w)
    E = a.shape[-1] if a.ndim == 2 else a.shape[0] // 3
    return a[i * E:(i + 1) * E]


def _posembed_rules(flax_prefix, torch_prefix):
    """PositionEmbeddingLearned (transformer.py:14-29): Sequential
    Conv1d/BN1d/ReLU/Conv1d under .position_embedding_head."""
    p = f"{torch_prefix}.position_embedding_head"
    return [
        (rf"{flax_prefix}/fc0/kernel", f"{p}.0.weight", _conv1d),
        (rf"{flax_prefix}/fc0/bias", f"{p}.0.bias", _id),
        (rf"{flax_prefix}/bn0/bn/scale", f"{p}.1.weight", _id),
        (rf"{flax_prefix}/bn0/bn/bias", f"{p}.1.bias", _id),
        (rf"{flax_prefix}/bn0/bn/mean", f"{p}.1.running_mean", _id),
        (rf"{flax_prefix}/bn0/bn/var", f"{p}.1.running_var", _id),
        (rf"{flax_prefix}/fc1/kernel", f"{p}.3.weight", _conv1d),
        (rf"{flax_prefix}/fc1/bias", f"{p}.3.bias", _id),
    ]


def _rules() -> List[Tuple[str, str, Callable]]:
    R: List[Tuple[str, str, Callable]] = []

    # ---------------- camera backbone: mmdet SwinTransformer ----------
    cb = "camera_backbone"
    tb = "encoders.camera.backbone"
    R += [
        (rf"{cb}/patch_embed/kernel", f"{tb}.patch_embed.projection.weight", _conv),
        (rf"{cb}/patch_embed/bias", f"{tb}.patch_embed.projection.bias", _id),
        (rf"{cb}/patch_norm/scale", f"{tb}.patch_embed.norm.weight", _id),
        (rf"{cb}/patch_norm/bias", f"{tb}.patch_embed.norm.bias", _id),
        (rf"{cb}/stage(\d+)_block(\d+)/norm([12])/scale",
         tb + ".stages.{1}.blocks.{2}.norm{3}.weight", _id),
        (rf"{cb}/stage(\d+)_block(\d+)/norm([12])/bias",
         tb + ".stages.{1}.blocks.{2}.norm{3}.bias", _id),
        (rf"{cb}/stage(\d+)_block(\d+)/attn/qkv/kernel",
         tb + ".stages.{1}.blocks.{2}.attn.w_msa.qkv.weight", _lin),
        (rf"{cb}/stage(\d+)_block(\d+)/attn/qkv/bias",
         tb + ".stages.{1}.blocks.{2}.attn.w_msa.qkv.bias", _id),
        (rf"{cb}/stage(\d+)_block(\d+)/attn/proj/kernel",
         tb + ".stages.{1}.blocks.{2}.attn.w_msa.proj.weight", _lin),
        (rf"{cb}/stage(\d+)_block(\d+)/attn/proj/bias",
         tb + ".stages.{1}.blocks.{2}.attn.w_msa.proj.bias", _id),
        (rf"{cb}/stage(\d+)_block(\d+)/attn/relative_position_bias_table",
         tb + ".stages.{1}.blocks.{2}.attn.w_msa.relative_position_bias_table", _id),
        (rf"{cb}/stage(\d+)_block(\d+)/mlp_fc1/kernel",
         tb + ".stages.{1}.blocks.{2}.ffn.layers.0.0.weight", _lin),
        (rf"{cb}/stage(\d+)_block(\d+)/mlp_fc1/bias",
         tb + ".stages.{1}.blocks.{2}.ffn.layers.0.0.bias", _id),
        (rf"{cb}/stage(\d+)_block(\d+)/mlp_fc2/kernel",
         tb + ".stages.{1}.blocks.{2}.ffn.layers.1.weight", _lin),
        (rf"{cb}/stage(\d+)_block(\d+)/mlp_fc2/bias",
         tb + ".stages.{1}.blocks.{2}.ffn.layers.1.bias", _id),
        (rf"{cb}/merge(\d+)/norm/scale", tb + ".stages.{1}.downsample.norm.weight", _id),
        (rf"{cb}/merge(\d+)/norm/bias", tb + ".stages.{1}.downsample.norm.bias", _id),
        (rf"{cb}/merge(\d+)/reduction/kernel",
         tb + ".stages.{1}.downsample.reduction.weight", _lin),
        (rf"{cb}/out_norm(\d+)/scale", tb + ".norm{1}.weight", _id),
        (rf"{cb}/out_norm(\d+)/bias", tb + ".norm{1}.bias", _id),
    ]

    # ---------------- camera neck: GeneralizedLSSFPN ------------------
    cn, tn = "camera_neck", "encoders.camera.neck"
    for fx, tx in (("lateral", "lateral_convs"), ("fpn", "fpn_convs")):
        R += [
            (rf"{cn}/{fx}(\d+)/Conv_0/conv/kernel", tn + "." + tx + ".{1}.conv.weight", _conv),
            (rf"{cn}/{fx}(\d+)/Norm_0/bn/scale", tn + "." + tx + ".{1}.bn.weight", _id),
            (rf"{cn}/{fx}(\d+)/Norm_0/bn/bias", tn + "." + tx + ".{1}.bn.bias", _id),
            (rf"{cn}/{fx}(\d+)/Norm_0/bn/mean", tn + "." + tx + ".{1}.bn.running_mean", _id),
            (rf"{cn}/{fx}(\d+)/Norm_0/bn/var", tn + "." + tx + ".{1}.bn.running_var", _id),
        ]

    # ---------------- camera vtransform: (Depth)LSSTransform ----------
    # sequential index maps (depth_lss.py:38-76, lss.py:40-57)
    cv, tv = "camera_vtransform", "encoders.camera.vtransform"
    for fx, tx, idx in (
        ("dt", "dtransform", (0, 3, 6)),
        ("dn", "depthnet", (0, 3, 6)),
        ("down", "downsample", (0, 3, 6)),
    ):
        for j, i0 in enumerate(idx):
            R += [
                (rf"{cv}/{fx}{j}/Conv_0/conv/kernel", f"{tv}.{tx}.{i0}.weight", _conv),
                (rf"{cv}/{fx}{j}/Conv_0/conv/bias", f"{tv}.{tx}.{i0}.bias", _id),
                (rf"{cv}/{fx}{j}/conv/kernel", f"{tv}.{tx}.{i0}.weight", _conv),
                (rf"{cv}/{fx}{j}/conv/bias", f"{tv}.{tx}.{i0}.bias", _id),
                (rf"{cv}/{fx}{j}/Norm_0/bn/scale", f"{tv}.{tx}.{i0 + 1}.weight", _id),
                (rf"{cv}/{fx}{j}/Norm_0/bn/bias", f"{tv}.{tx}.{i0 + 1}.bias", _id),
                (rf"{cv}/{fx}{j}/Norm_0/bn/mean", f"{tv}.{tx}.{i0 + 1}.running_mean", _id),
                (rf"{cv}/{fx}{j}/Norm_0/bn/var", f"{tv}.{tx}.{i0 + 1}.running_var", _id),
            ]

    # ---------------- lidar backbone: SparseEncoder -------------------
    lb, tl = "lidar_backbone", "encoders.lidar.backbone"
    R += [
        (rf"{lb}/conv_input/weight", f"{tl}.conv_input.0.weight", _spconv),
        (rf"{lb}/bn_input/scale", f"{tl}.conv_input.1.weight", _id),
        (rf"{lb}/bn_input/bias", f"{tl}.conv_input.1.bias", _id),
        (rf"{lb}/bn_input/mean", f"{tl}.conv_input.1.running_mean", _id),
        (rf"{lb}/bn_input/var", f"{tl}.conv_input.1.running_var", _id),
        (rf"{lb}/conv_out/weight", f"{tl}.conv_out.0.weight", _spconv),
        (rf"{lb}/bn_out/scale", f"{tl}.conv_out.1.weight", _id),
        (rf"{lb}/bn_out/bias", f"{tl}.conv_out.1.bias", _id),
        (rf"{lb}/bn_out/mean", f"{tl}.conv_out.1.running_mean", _id),
        (rf"{lb}/bn_out/var", f"{tl}.conv_out.1.running_var", _id),
        # basicblock stages (SparseBasicBlock: conv1/bn1/conv2/bn2,
        # ops/sparse_block.py:42-47); stage i -> encoder_layer{i+1}
        (rf"{lb}/stage(\d+)_block(\d+)_conv([12])/weight",
         tl + ".encoder_layers.encoder_layer{1+}.{2}.conv{3}.weight", _spconv),
        (rf"{lb}/stage(\d+)_block(\d+)_bn([12])/scale",
         tl + ".encoder_layers.encoder_layer{1+}.{2}.bn{3}.weight", _id),
        (rf"{lb}/stage(\d+)_block(\d+)_bn([12])/bias",
         tl + ".encoder_layers.encoder_layer{1+}.{2}.bn{3}.bias", _id),
        (rf"{lb}/stage(\d+)_block(\d+)_bn([12])/mean",
         tl + ".encoder_layers.encoder_layer{1+}.{2}.bn{3}.running_mean", _id),
        (rf"{lb}/stage(\d+)_block(\d+)_bn([12])/var",
         tl + ".encoder_layers.encoder_layer{1+}.{2}.bn{3}.running_var", _id),
        # strided transition: SparseSequential(conv, bn, relu)
        (rf"{lb}/stage(\d+)_block(\d+)_spconv/weight",
         tl + ".encoder_layers.encoder_layer{1+}.{2}.0.weight", _spconv),
        (rf"{lb}/stage(\d+)_block(\d+)_bn/scale",
         tl + ".encoder_layers.encoder_layer{1+}.{2}.1.weight", _id),
        (rf"{lb}/stage(\d+)_block(\d+)_bn/bias",
         tl + ".encoder_layers.encoder_layer{1+}.{2}.1.bias", _id),
        (rf"{lb}/stage(\d+)_block(\d+)_bn/mean",
         tl + ".encoder_layers.encoder_layer{1+}.{2}.1.running_mean", _id),
        (rf"{lb}/stage(\d+)_block(\d+)_bn/var",
         tl + ".encoder_layers.encoder_layer{1+}.{2}.1.running_var", _id),
        # conv_module stages (SparseSequential(conv, bn, relu) each)
        (rf"{lb}/stage(\d+)_block(\d+)_conv/weight",
         tl + ".encoder_layers.encoder_layer{1+}.{2}.0.weight", _spconv),
    ]

    # ---------------- fuser: ConvFuser (fusers/conv.py:12-23) ---------
    R += [
        (r"fuser_module/fuse/Conv_0/conv/kernel", "fuser.0.weight", _conv),
        (r"fuser_module/fuse/Norm_0/bn/scale", "fuser.1.weight", _id),
        (r"fuser_module/fuse/Norm_0/bn/bias", "fuser.1.bias", _id),
        (r"fuser_module/fuse/Norm_0/bn/mean", "fuser.1.running_mean", _id),
        (r"fuser_module/fuse/Norm_0/bn/var", "fuser.1.running_var", _id),
    ]

    # ---------------- decoder: SECOND + SECONDFPN ---------------------
    db, td = "decoder_backbone", "decoder.backbone"
    R += [
        (rf"{db}/block(\d+)_conv(\d+)/conv/kernel",
         td + ".blocks.{1}.{2*3}.weight", _conv),
        (rf"{db}/block(\d+)_bn(\d+)/bn/scale", td + ".blocks.{1}.{2*3+1}.weight", _id),
        (rf"{db}/block(\d+)_bn(\d+)/bn/bias", td + ".blocks.{1}.{2*3+1}.bias", _id),
        (rf"{db}/block(\d+)_bn(\d+)/bn/mean",
         td + ".blocks.{1}.{2*3+1}.running_mean", _id),
        (rf"{db}/block(\d+)_bn(\d+)/bn/var",
         td + ".blocks.{1}.{2*3+1}.running_var", _id),
    ]
    dn, tdn = "decoder_neck", "decoder.neck"
    R += [
        (rf"{dn}/deblock(\d+)_conv/conv/kernel", tdn + ".deblocks.{1}.0.weight", _conv),
        (rf"{dn}/deblock(\d+)_deconv/kernel", tdn + ".deblocks.{1}.0.weight", _deconv),
        (rf"{dn}/deblock(\d+)_bn/bn/scale", tdn + ".deblocks.{1}.1.weight", _id),
        (rf"{dn}/deblock(\d+)_bn/bn/bias", tdn + ".deblocks.{1}.1.bias", _id),
        (rf"{dn}/deblock(\d+)_bn/bn/mean", tdn + ".deblocks.{1}.1.running_mean", _id),
        (rf"{dn}/deblock(\d+)_bn/bn/var", tdn + ".deblocks.{1}.1.running_var", _id),
    ]

    # ---------------- heads.object: TransFusionHead -------------------
    ho, th = "head_modules_object", "heads.object"
    R += [
        (rf"{ho}/shared_conv/conv/kernel", f"{th}.shared_conv.weight", _conv),
        (rf"{ho}/shared_conv/conv/bias", f"{th}.shared_conv.bias", _id),
        (rf"{ho}/heatmap_conv0/Conv_0/conv/kernel",
         f"{th}.heatmap_head.0.conv.weight", _conv),
        (rf"{ho}/heatmap_conv0/Norm_0/bn/scale", f"{th}.heatmap_head.0.bn.weight", _id),
        (rf"{ho}/heatmap_conv0/Norm_0/bn/bias", f"{th}.heatmap_head.0.bn.bias", _id),
        (rf"{ho}/heatmap_conv0/Norm_0/bn/mean",
         f"{th}.heatmap_head.0.bn.running_mean", _id),
        (rf"{ho}/heatmap_conv0/Norm_0/bn/var",
         f"{th}.heatmap_head.0.bn.running_var", _id),
        (rf"{ho}/heatmap_conv1/conv/kernel", f"{th}.heatmap_head.1.weight", _conv),
        (rf"{ho}/heatmap_conv1/conv/bias", f"{th}.heatmap_head.1.bias", _id),
        (rf"{ho}/class_encoding/kernel", f"{th}.class_encoding.weight", _conv1d),
        (rf"{ho}/class_encoding/bias", f"{th}.class_encoding.bias", _id),
    ]
    for layer in range(4):  # decoder layers (1 for transfusion heads)
        fp = rf"{ho}/decoder{layer}"
        tp = f"{th}.decoder.{layer}"
        R += _mha_rules(fp + "/self_attn", tp + ".self_attn")
        R += _mha_rules(fp + "/cross_attn", tp + ".multihead_attn")
        R += [
            (fp + r"/linear([12])/kernel", tp + ".linear{1}.weight", _lin),
            (fp + r"/linear([12])/bias", tp + ".linear{1}.bias", _id),
            (fp + r"/norm([123])/scale", tp + ".norm{1}.weight", _id),
            (fp + r"/norm([123])/bias", tp + ".norm{1}.bias", _id),
        ]
        R += _posembed_rules(fp + "/self_posembed", tp + ".self_posembed")
        R += _posembed_rules(fp + "/cross_posembed", tp + ".cross_posembed")
    # FFN prediction branches (transfusion.py prediction_heads:
    # Sequential(Conv1d, BN1d, ReLU) x n + final Conv1d)
    R += [
        (rf"{ho}/pred(\d+)/(\w+)_fc(\d+)/kernel",
         th + ".prediction_heads.{1}.{2}.{3*3}.weight", _conv1d),
        (rf"{ho}/pred(\d+)/(\w+)_fc(\d+)/bias",
         th + ".prediction_heads.{1}.{2}.{3*3}.bias", _id),
        (rf"{ho}/pred(\d+)/(\w+)_bn(\d+)/bn/scale",
         th + ".prediction_heads.{1}.{2}.{3*3+1}.weight", _id),
        (rf"{ho}/pred(\d+)/(\w+)_bn(\d+)/bn/bias",
         th + ".prediction_heads.{1}.{2}.{3*3+1}.bias", _id),
        (rf"{ho}/pred(\d+)/(\w+)_bn(\d+)/bn/mean",
         th + ".prediction_heads.{1}.{2}.{3*3+1}.running_mean", _id),
        (rf"{ho}/pred(\d+)/(\w+)_bn(\d+)/bn/var",
         th + ".prediction_heads.{1}.{2}.{3*3+1}.running_var", _id),
        (rf"{ho}/pred(\d+)/(\w+)_out/kernel",
         th + ".prediction_heads.{1}.{2}.last.weight", _conv1d),
        (rf"{ho}/pred(\d+)/(\w+)_out/bias",
         th + ".prediction_heads.{1}.{2}.last.bias", _id),
    ]

    # ---------------- heads.object: CenterHead ------------------------
    # (centerpoint.py:248-354: shared ConvModule + task_heads ModuleList
    # of SeparateHead branch Sequentials, :19-127)
    R += [
        (rf"{ho}/shared_conv/Conv_0/conv/kernel",
         f"{th}.shared_conv.conv.weight", _conv),
        (rf"{ho}/shared_conv/Norm_0/bn/scale", f"{th}.shared_conv.bn.weight", _id),
        (rf"{ho}/shared_conv/Norm_0/bn/bias", f"{th}.shared_conv.bn.bias", _id),
        (rf"{ho}/shared_conv/Norm_0/bn/mean",
         f"{th}.shared_conv.bn.running_mean", _id),
        (rf"{ho}/shared_conv/Norm_0/bn/var",
         f"{th}.shared_conv.bn.running_var", _id),
        (rf"{ho}/task(\d+)/(\w+)_conv(\d+)/Conv_0/conv/kernel",
         th + ".task_heads.{1}.{2}.{3}.conv.weight", _conv),
        (rf"{ho}/task(\d+)/(\w+)_conv(\d+)/Norm_0/bn/scale",
         th + ".task_heads.{1}.{2}.{3}.bn.weight", _id),
        (rf"{ho}/task(\d+)/(\w+)_conv(\d+)/Norm_0/bn/bias",
         th + ".task_heads.{1}.{2}.{3}.bn.bias", _id),
        (rf"{ho}/task(\d+)/(\w+)_conv(\d+)/Norm_0/bn/mean",
         th + ".task_heads.{1}.{2}.{3}.bn.running_mean", _id),
        (rf"{ho}/task(\d+)/(\w+)_conv(\d+)/Norm_0/bn/var",
         th + ".task_heads.{1}.{2}.{3}.bn.running_var", _id),
        (rf"{ho}/task(\d+)/(\w+)_out/kernel",
         th + ".task_heads.{1}.{2}.last.weight", _conv),
        (rf"{ho}/task(\d+)/(\w+)_out/bias",
         th + ".task_heads.{1}.{2}.last.bias", _id),
    ]

    # ---------------- heads.map: BEVSegmentationHead ------------------
    # (segm/vanilla.py:102-111 classifier Sequential)
    hm, thm = "head_modules_map", "heads.map"
    R += [
        (rf"{hm}/cls([01])/Conv_0/conv/kernel",
         thm + ".classifier.{1*3}.weight", _conv),
        (rf"{hm}/cls([01])/Norm_0/bn/scale",
         thm + ".classifier.{1*3+1}.weight", _id),
        (rf"{hm}/cls([01])/Norm_0/bn/bias",
         thm + ".classifier.{1*3+1}.bias", _id),
        (rf"{hm}/cls([01])/Norm_0/bn/mean",
         thm + ".classifier.{1*3+1}.running_mean", _id),
        (rf"{hm}/cls([01])/Norm_0/bn/var",
         thm + ".classifier.{1*3+1}.running_var", _id),
        (rf"{hm}/cls2/conv/kernel", f"{thm}.classifier.6.weight", _conv),
        (rf"{hm}/cls2/conv/bias", f"{thm}.classifier.6.bias", _id),
    ]

    # ------- decoder.backbone: GeneralizedResNet (resnet.py:13-40) ----
    # mmcv BasicBlock naming conv1/bn1/conv2/bn2 + downsample.{0,1}
    R += [
        (rf"{db}/stage(\d+)_block(\d+)/conv([12])/conv/kernel",
         td + ".{1}.{2}.conv{3}.weight", _conv),
        (rf"{db}/stage(\d+)_block(\d+)/bn([12])/bn/scale",
         td + ".{1}.{2}.bn{3}.weight", _id),
        (rf"{db}/stage(\d+)_block(\d+)/bn([12])/bn/bias",
         td + ".{1}.{2}.bn{3}.bias", _id),
        (rf"{db}/stage(\d+)_block(\d+)/bn([12])/bn/mean",
         td + ".{1}.{2}.bn{3}.running_mean", _id),
        (rf"{db}/stage(\d+)_block(\d+)/bn([12])/bn/var",
         td + ".{1}.{2}.bn{3}.running_var", _id),
        (rf"{db}/stage(\d+)_block(\d+)/downsample_conv/conv/kernel",
         td + ".{1}.{2}.downsample.0.weight", _conv),
        (rf"{db}/stage(\d+)_block(\d+)/downsample_bn/bn/scale",
         td + ".{1}.{2}.downsample.1.weight", _id),
        (rf"{db}/stage(\d+)_block(\d+)/downsample_bn/bn/bias",
         td + ".{1}.{2}.downsample.1.bias", _id),
        (rf"{db}/stage(\d+)_block(\d+)/downsample_bn/bn/mean",
         td + ".{1}.{2}.downsample.1.running_mean", _id),
        (rf"{db}/stage(\d+)_block(\d+)/downsample_bn/bn/var",
         td + ".{1}.{2}.downsample.1.running_var", _id),
    ]

    # ------------- decoder.neck: LSSFPN (necks/lss.py:13-65) ----------
    R += [
        (rf"{dn}/fuse([01])/Conv_0/conv/kernel",
         tdn + ".fuse.{1*3}.weight", _conv),
        (rf"{dn}/fuse([01])/Norm_0/bn/scale",
         tdn + ".fuse.{1*3+1}.weight", _id),
        (rf"{dn}/fuse([01])/Norm_0/bn/bias", tdn + ".fuse.{1*3+1}.bias", _id),
        (rf"{dn}/fuse([01])/Norm_0/bn/mean",
         tdn + ".fuse.{1*3+1}.running_mean", _id),
        (rf"{dn}/fuse([01])/Norm_0/bn/var",
         tdn + ".fuse.{1*3+1}.running_var", _id),
        (rf"{dn}/up_conv/Conv_0/conv/kernel", f"{tdn}.upsample.1.weight", _conv),
        (rf"{dn}/up_conv/Norm_0/bn/scale", f"{tdn}.upsample.2.weight", _id),
        (rf"{dn}/up_conv/Norm_0/bn/bias", f"{tdn}.upsample.2.bias", _id),
        (rf"{dn}/up_conv/Norm_0/bn/mean", f"{tdn}.upsample.2.running_mean", _id),
        (rf"{dn}/up_conv/Norm_0/bn/var", f"{tdn}.upsample.2.running_var", _id),
    ]

    # --------- camera vtransform: plain LSSTransform depthnet ---------
    # (lss.py:37: a single 1x1 Conv2d, unlike DepthLSS's Sequential)
    R += [
        (rf"{cv}/depthnet/conv/kernel", f"{tv}.depthnet.weight", _conv),
        (rf"{cv}/depthnet/conv/bias", f"{tv}.depthnet.bias", _id),
    ]
    return R


_RULES = None


def _compiled_rules():
    global _RULES
    if _RULES is None:
        _RULES = [(re.compile("^" + rx + "$"), tmpl, cv)
                  for rx, tmpl, cv in _rules()]
    return _RULES


def _fill(template: str, m: "re.Match") -> str:
    """Substitute {N}, {N+} (1-based +1) and {N*3}/{N*3+1} group refs."""
    def sub(match):
        expr = match.group(1)
        mm = re.match(r"^(\d+)(\+|\*3(\+1)?)?$", expr)
        g = int(mm.group(1))
        raw = m.group(g)
        op = mm.group(2)
        if op is None and not raw.isdigit():
            return raw  # string group (e.g. prediction-branch name)
        v = int(raw)
        if op == "+":
            v += 1
        elif op == "*3":
            v *= 3
        elif op == "*3+1":
            v = v * 3 + 1
        return str(v)

    return re.sub(r"\{([^}]+)\}", sub, template)


def flax_to_torch_key(path: str):
    """flax 'a/b/c' path -> (torch key, converter) or None."""
    for rx, tmpl, cv in _compiled_rules():
        m = rx.match(path)
        if m:
            return _fill(tmpl, m), cv
    return None

