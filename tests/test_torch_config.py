"""The port's config loader gives the JAX package's result on every config."""
import glob
import os

import pytest
import torch

from bevfusion_tpu.config import load_config as jax_load_config
from bevfusion_tpu_torch.config import load_config

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every file, default.yaml included: several are model configs themselves
# (e.g. camera/256x704/swint/default.yaml)
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs/**/*.yaml"), recursive=True))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_load_config_matches_jax_package(path):
    assert load_config(path) == jax_load_config(path)


def test_overrides_and_attribute_access():
    path = os.path.join(ROOT, "configs/nuscenes/det/transfusion/secfpn/lidar/voxelnet_0p075.yaml")
    over = {"voxel_size": [0.1, 0.1, 0.2], "model.heads.object.num_proposals": 50}
    cfg = load_config(path, overrides=over)
    assert cfg == jax_load_config(path, overrides=over)
    # ${voxel_size[:2]} re-resolves against the override
    assert cfg.model.heads.object.bbox_coder.voxel_size == [0.1, 0.1]
    assert cfg.model.heads.object.num_proposals == 50


@pytest.mark.parametrize("rel,drop_fuser,message", [
    ("configs/nuscenes/det/transfusion/secfpn/lidar/default.yaml", False, "no sensor branch"),
    ("configs/nuscenes/det/transfusion/secfpn/camera+lidar/swint_v0p075/convfuser.yaml", True,
     "several sensor branches need a fuser"),
], ids=["no-branch", "two-branches-no-fuser"])
def test_build_model_names_what_the_config_lacks(rel, drop_fuser, message):
    from bevfusion_tpu_torch.models import build_model

    model_cfg = dict(load_config(os.path.join(ROOT, rel)).model)
    if drop_fuser:
        model_cfg["fuser"] = None
    with pytest.raises(ValueError, match=message) as err:
        build_model(model_cfg, "cpu")
    if not drop_fuser:
        assert "fuser" not in str(err.value)


# the configs the port builds: the fused flagship, TransFusion-L at 0.1 and
# 0.075 m, the three map-segmentation configs, the three camera-only
# CenterHead detectors, PointPillars and camera + radar CenterHead
PORTED = [
    "configs/nuscenes/det/transfusion/secfpn/camera+lidar/swint_v0p075/convfuser.yaml",
    "configs/nuscenes/det/transfusion/secfpn/lidar/voxelnet.yaml",
    "configs/nuscenes/det/transfusion/secfpn/lidar/voxelnet_0p075.yaml",
    "configs/nuscenes/seg/fusion-bev256d2-lss.yaml",
    "configs/nuscenes/seg/lidar-centerpoint-bev128.yaml",
    "configs/nuscenes/seg/camera-bev256d2.yaml",
    "configs/nuscenes/det/centerhead/lssfpn/camera/256x704/swint/default.yaml",
    "configs/nuscenes/det/centerhead/lssfpn/camera/256x704/resnet/default.yaml",
    "configs/nuscenes/det/centerhead/lssfpn/camera/256x704/resnet/bevdepth.yaml",
    "configs/nuscenes/det/transfusion/secfpn/lidar/pointpillars.yaml",
    "configs/nuscenes/det/centerhead/lssfpn/camera+radar/resnet50/default.yaml",
]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_build_model_builds_the_ported_configs_and_no_other(path):
    """``build_model(load_config(p).model, "cpu")`` builds 11 of the 26 files;
    every other raises (a missing branch, fuser or decoder, no model at all,
    or dlss.yaml's depth branch at another stride than its image features).
    No file names a module type the port lacks."""
    from bevfusion_tpu_torch.models import build_model
    from bevfusion_tpu_torch.tools.benchmark import _unported_types

    rel = os.path.relpath(path, ROOT)
    assert _unported_types(load_config(path).get("model") or {}) == []
    try:
        model = build_model(load_config(path).model, "cpu")
    except (AttributeError, KeyError, NotImplementedError, TypeError, ValueError):
        assert rel not in PORTED
    else:
        assert rel in PORTED and not model.training
    assert len(CONFIGS) == 26 and len(PORTED) == 11


@pytest.mark.parametrize("name", ["swint", "resnet", "bevdepth"])
def test_camera_det_configs_build(name):
    from bevfusion_tpu_torch.models import build_model
    from bevfusion_tpu_torch.runtime.flagship import DET_CAMERA_CONFIGS
    from bevfusion_tpu_torch.tools.benchmark import _unported_types

    cfg = load_config(DET_CAMERA_CONFIGS[name])
    assert _unported_types(cfg.model) == []
    model = build_model(cfg.model, "cpu")
    head = model.heads["object"]
    assert type(head).__name__ == "CenterHead" and len(head.task_heads) == 6
    assert type(model.encoders["camera"]["vtransform"]).__name__ == (
        "AwareBEVDepth" if name == "bevdepth" else "LSSTransform")
    assert model.encoders["camera"]["vtransform"].nx == ((256, 256, 1) if name == "swint"
                                                         else (128, 128, 1))
    if torch.cuda.is_available():  # no device given: the card
        assert next(build_model(cfg.model).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            build_model(cfg.model)
