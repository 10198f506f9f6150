"""The weight bridge (bevfusion_tpu_torch/runtime/bridge.py): JAX variables
to the port's state dict, strict and exhaustive."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_ref.skeleton as skeleton
from bevfusion_tpu.config import load_config as jax_load_config
from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu.models.swin import _relative_position_index
from bevfusion_tpu.runtime.adapter import load_reference_weights
from bevfusion_tpu.runtime.flagship import FLAGSHIP_CONFIG, synthetic_batch
from bevfusion_tpu_torch.config import load_config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from bevfusion_tpu_torch.runtime.flagship import (DET_CAMERA_CONFIGS, LIDAR_SLICE_CONFIG,
                                                  PILLAR_CONFIGS)
from tests.torch_port_helpers import tiny_lidar_model

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINES = [  # the five baseline trees with their reference-checkpoint replicas
    (FLAGSHIP_CONFIG, "BEVFusionSkeleton"),
    ("configs/nuscenes/det/centerhead/lssfpn/camera/256x704/swint/default.yaml",
     "CameraOnlyDetSkeleton"),
    ("configs/nuscenes/seg/camera-bev256d2.yaml", "CameraOnlySegSkeleton"),
    (LIDAR_SLICE_CONFIG, "LidarOnlyDetSkeleton"),
    ("configs/nuscenes/seg/fusion-bev256d2-lss.yaml", "FusedSegSkeleton"),
]


def _zero_variables(model, batch):
    shapes = jax.eval_shape(lambda b: model.init(jax.random.PRNGKey(0), b), batch)
    return {col: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes[col])
            for col in ("params", "batch_stats")}


def test_bridge_round_trip_is_strict():
    """JAX variables -> torch state dict -> back through the reference
    adapter (strict: any unmapped or unused key raises) gives the same
    variables, and the port loads the state dict strictly."""
    cfg, _, _, variables = tiny_lidar_model()
    sd = jax_to_torch_state_dict(variables)
    back, report = load_reference_weights(variables, sd, strict=True)
    assert not any(report.values())
    for col in ("params", "batch_stats"):
        for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(variables[col]),
                                  jax.tree_util.tree_leaves_with_path(back[col])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    build_model(cfg, "cpu").load_state_dict(sd, strict=True)
    extra = dict(sd, **{"heads.object.unused.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError):
        build_model(cfg, "cpu").load_state_dict(extra, strict=True)
    with pytest.raises(ValueError):
        jax_to_torch_state_dict({"params": {"no_such_module": {"kernel": np.zeros((1, 1))}}})


@pytest.mark.parametrize("cfg_path,skel_name", BASELINES,
                         ids=[name for _, name in BASELINES])
def test_bridge_is_exhaustive_on_baseline_trees(cfg_path, skel_name):
    """Reference checkpoint replica -> flax (adapter, strict) -> torch
    (bridge) reproduces every learned tensor and running statistic, key
    for key. Swin's relative_position_index buffers have no flax
    counterpart: the bridge emits them from the window size (the replica
    holds zeros there), so they are held to the JAX package's constant."""
    cfg = jax_load_config(os.path.join(ROOT, cfg_path))
    model = jax_build_model(cfg.model, dtype=jnp.float32)
    variables = _zero_variables(model, synthetic_batch(cfg, B=1, num_points=1000))
    torch.manual_seed(0)
    sd = getattr(skeleton, skel_name)().state_dict()
    flax_vars, _ = load_reference_weights(variables, sd, strict=True)
    back = jax_to_torch_state_dict(flax_vars)
    assert set(back) == set(sd)
    for key, value in back.items():
        want = sd[key].numpy()
        if key.endswith("relative_position_index"):
            ws = round(want.shape[0] ** 0.5)
            assert value.dtype == torch.int64
            want = _relative_position_index(ws)
        np.testing.assert_array_equal(value.numpy(), want, err_msg=key)


@pytest.mark.parametrize("cfg_path,skel_name", [(LIDAR_SLICE_CONFIG, "LidarOnlyDetSkeleton"),
                                                  (FLAGSHIP_CONFIG, "BEVFusionSkeleton"),
                                                  (DET_CAMERA_CONFIGS["swint"],
                                                   "CameraOnlyDetSkeleton")],
                         ids=["voxelnet_0p075", "flagship", "centerhead_swint"])
def test_full_width_model_loads_bridge_and_reference_checkpoint(cfg_path, skel_name):
    """voxelnet_0p075, the fused flagship (swint_v0p075/convfuser) and the
    camera-only CenterHead detector (centerhead/.../swint/default.yaml) at
    full width: the bridged JAX variables and the reference checkpoint's
    key tree both load strictly into the port (key tree only, no forward)."""
    cfg = load_config(cfg_path)
    jm = jax_build_model(cfg.model)
    batch = synthetic_batch(jax_load_config(cfg_path), B=1, num_points=64)
    model = build_model(cfg.model, "cpu")
    model.load_state_dict(jax_to_torch_state_dict(_zero_variables(jm, batch)), strict=True)
    model.load_state_dict(getattr(skeleton, skel_name)().state_dict(), strict=True)


@pytest.mark.parametrize("name", ["resnet", "bevdepth"])
def test_bridge_is_exhaustive_on_the_resnet_camera_trees(name):
    """The ResNet-50 CenterHead configs at full width: every flax path of the
    JAX model gets a torch key through the copied table or the port's own
    rules (``PORT_RULES``: the ResNet, the SECONDFPN camera neck, BEVDepth's
    DepthNet), no key twice, and the result loads strictly. The JAX ResNet
    takes no ``num_stages`` or ``norm_cfg`` (it builds four BN stages), so
    its copy of the tree goes without them."""
    path = DET_CAMERA_CONFIGS[name]
    jcfg = jax_load_config(path)
    for key in ("num_stages", "norm_cfg"):
        jcfg.model.encoders.camera.backbone.pop(key)
    variables = _zero_variables(jax_build_model(jcfg.model), synthetic_batch(jcfg, B=1,
                                                                            num_points=64))
    sd = jax_to_torch_state_dict(variables)
    leaves = sum(len(jax.tree_util.tree_leaves(variables[c])) for c in ("params", "batch_stats"))
    bns = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) == leaves + bns
    ported = [k for k in sd if k.startswith(("encoders.camera.backbone.", "encoders.camera.neck.",
                                             "encoders.camera.vtransform.depthnet."))]
    assert any(k.startswith("encoders.camera.backbone.layer4.2.") for k in ported)
    assert any(k.startswith("encoders.camera.vtransform.depthnet.depth_conv.3.aspp4.")
               for k in ported) == (name == "bevdepth")
    build_model(load_config(path).model, "cpu").load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name", ["pointpillars", "camera+radar"])
def test_bridge_is_exhaustive_on_the_pillar_trees(name):
    """The two pillar configs at full width: every flax path of the JAX model
    (the pillar and radar feature nets: ``PORT_RULES``) gets a torch key, no
    key twice, and the result loads strictly (every key of the port's
    model, none else); the first Linear of each
    feature net is as wide as the reference's rule makes the port's."""
    path = PILLAR_CONFIGS[name]
    jcfg = jax_load_config(path)
    batch = synthetic_batch(jcfg, B=1, num_points=64)
    if name == "camera+radar":
        batch.update(radar=jnp.zeros((1, 300, 45)), radar_mask=jnp.ones((1, 300), bool))
    variables = _zero_variables(jax_build_model(jcfg.model), batch)
    sd = jax_to_torch_state_dict(variables)  # raises on a flax path without a key
    branch, layers, width = (("lidar", "pfn_layers", 5 + 5) if name == "pointpillars"
                             else ("radar", "rfn_layers", 45 + 2))
    first = f"encoders.{branch}.backbone.pts_voxel_encoder.{layers}.0.linear.weight"
    assert sd[first].shape[1] == width
    build_model(load_config(path).model, "cpu").load_state_dict(sd, strict=True)


def _long_tail_cases():
    """(JAX module, its inputs, the flax name it sits under, the port's
    module, the torch prefix) of each module no served config reaches."""
    from bevfusion_tpu.models import fusers as jf, necks as jn, second as js
    from bevfusion_tpu.models import pointnet_modules as jpm
    from bevfusion_tpu.models.dla import DLA as JDLA
    from bevfusion_tpu.models.heads.centerpoint import CenterHead as JCenterHead
    from bevfusion_tpu.models.pillar_encoder import PillarFeatureNet as JPFN
    from bevfusion_tpu.models.sparse_encoder import SparseEncoder as JSparseEncoder
    from bevfusion_tpu.models.vovnet import VoVNet as JVoVNet
    from bevfusion_tpu_torch.models import dla, fusers, necks, pillar_encoder, pointnet_modules
    from bevfusion_tpu_torch.models import second, sparse_encoder, vovnet
    from bevfusion_tpu_torch.models.heads.centerpoint import CenterHead
    from tests.test_torch_centerhead import _head_cfg
    from tests.test_torch_long_tail import CONV_MODULE

    img = np.zeros((1, 64, 64, 3), np.float32)
    fpn_in = [np.zeros((1, 16 // 2 ** i, 16 // 2 ** i, c), np.float32)
              for i, c in enumerate((6, 10, 12))]
    head = dict(_head_cfg((("car",), ("truck", "bus")), "circle", None),
                separate_head={"type": "DCNSeparateHead", "head_conv": 8})
    pfn = dict(in_channels=5, feat_channels=[64, 64], voxel_size=[2.0, 2.0, 8.0],
               point_cloud_range=[-16.0, -16.0, -4.0, 16.0, 16.0, 4.0],
               norm_cfg={"type": "GN", "eps": 1e-3})
    sa = dict(num_point=8, radii=(0.5, 1.0), sample_nums=(4, 8), mlp_channels=((8, 16), (8,)))
    xyz, pts = jnp.zeros((32, 3)), jnp.zeros((32, 6))
    vox = (np.zeros((1, 64, 5), np.float32), np.zeros((1, 64, 3), np.int32),
           np.zeros((1, 64), bool))
    return {
        "vovnet": (JVoVNet("V-19-slim-eSE"), (img,), "camera_backbone",
                   lambda: vovnet.VoVNet("V-19-slim-eSE"), "encoders.camera.backbone."),
        "dla": (JDLA(channels=(4, 8, 16, 16, 24, 32)), (img,), "camera_backbone",
                lambda: dla.DLA(channels=(4, 8, 16, 16, 24, 32)), "encoders.camera.backbone."),
        "detectron_fpn": (jn.DetectronFPN((0, 1, 2), (0, 1), (6, 10, 12), 8), (fpn_in,),
                          "camera_neck", lambda: necks.DetectronFPN((0, 1, 2), (0, 1),
                                                                    (6, 10, 12), 8),
                          "encoders.camera.neck."),
        "add_fuser": (jf.AddFuser((6, 10), 12), ([np.zeros((1, 8, 8, 6), np.float32),
                                                  np.zeros((1, 8, 8, 10), np.float32)],),
                      "fuser_module", lambda: fusers.AddFuser((6, 10), 12), "fuser."),
        "second_ln": (js.SECOND(8, (32, 64), (1, 1), (2, 2), {"type": "LN"}),
                      (np.zeros((1, 8, 8, 8), np.float32),), "decoder_backbone",
                      lambda: second.SECOND(8, (32, 64), (1, 1), (2, 2), {"type": "LN"}),
                      "decoder.backbone."),
        "second_gn": (js.SECOND(8, (32, 64), (1, 1), (2, 2), {"type": "GN"}),
                      (np.zeros((1, 8, 8, 8), np.float32),), "decoder_backbone",
                      lambda: second.SECOND(8, (32, 64), (1, 1), (2, 2), {"type": "GN"}),
                      "decoder.backbone."),
        "pfn_gn": (JPFN(**pfn), (np.zeros((4, 6, 5), np.float32), np.ones(4, np.int32),
                                 np.zeros((4, 3), np.int32)),
                   "lidar_backbone/PillarFeatureNet_0", lambda: pillar_encoder.PillarFeatureNet(
                       **pfn), "encoders.lidar.backbone.pts_voxel_encoder."),
        "conv_module": (JSparseEncoder(**CONV_MODULE, engine="gather"), vox, "lidar_backbone",
                        lambda: sparse_encoder.SparseEncoder(**CONV_MODULE),
                        "encoders.lidar.backbone."),
        "dcn_head": (JCenterHead(**head), (np.zeros((1, 16, 16, 12), np.float32),),
                     "head_modules_object", lambda: CenterHead(**head), "heads.object."),
        "pointnet_sa": (jpm.PointSAModuleMSG(**sa), (xyz, pts), "lidar_backbone",
                        lambda: pointnet_modules.PointSAModuleMSG(**sa, in_channels=6),
                        "encoders.lidar.backbone."),
        "pointnet_fp": (jpm.PointFPModule((12, 7)), (xyz, xyz[:8], pts, jnp.zeros((8, 24))),
                        "lidar_backbone", lambda: pointnet_modules.PointFPModule(
                            (12, 7), in_channels=30), "encoders.lidar.backbone."),
    }


@pytest.mark.parametrize("name", ["vovnet", "dla", "detectron_fpn", "add_fuser", "second_ln",
                                  "second_gn", "pfn_gn", "conv_module", "dcn_head",
                                  "pointnet_sa", "pointnet_fp"])
def test_bridge_is_exhaustive_on_the_long_tail_trees(name):
    """Every flax path of each module no served config reaches gets a torch
    key (``PORT_RULES``; a LayerNorm / GroupNorm the keys of the BatchNorm
    in its place), no key twice, and the result loads strictly into the
    port's module (every key of it, none else)."""
    jm, args, flax_name, build, prefix = _long_tail_cases()[name]
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a), *args)
    variables = {col: {flax_name.split("/")[-1]: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes[col])} if col in shapes else {}
        for col in ("params", "batch_stats")}
    for part in reversed(flax_name.split("/")[:-1]):  # a nested name: its parents
        variables = {col: {part: tree} if tree else {} for col, tree in variables.items()}
    sd = jax_to_torch_state_dict(variables)  # raises on a flax path without a key
    leaves = sum(len(jax.tree_util.tree_leaves(shapes[c])) for c in shapes)
    assert len(sd) == leaves + sum(k.endswith("num_batches_tracked") for k in sd)
    assert all(k.startswith(prefix) for k in sd)
    build().load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
