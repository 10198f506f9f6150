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
from bevfusion_tpu_torch.runtime.flagship import LIDAR_SLICE_CONFIG
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
                                                  (FLAGSHIP_CONFIG, "BEVFusionSkeleton")],
                         ids=["voxelnet_0p075", "flagship"])
def test_full_width_model_loads_bridge_and_reference_checkpoint(cfg_path, skel_name):
    """voxelnet_0p075 and the fused flagship (swint_v0p075/convfuser) at
    full width: the bridged JAX variables and the reference checkpoint's
    key tree both load strictly into the port (key tree only, no forward)."""
    cfg = load_config(cfg_path)
    jm = jax_build_model(cfg.model)
    batch = synthetic_batch(jax_load_config(cfg_path), B=1, num_points=64)
    model = build_model(cfg.model, "cpu")
    model.load_state_dict(jax_to_torch_state_dict(_zero_variables(jm, batch)), strict=True)
    model.load_state_dict(getattr(skeleton, skel_name)().state_dict(), strict=True)
