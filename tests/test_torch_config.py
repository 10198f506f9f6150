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
