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
