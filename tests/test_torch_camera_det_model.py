"""Port parity of whole tiny camera-only CenterHead detectors against the JAX
package: the three configs of configs/nuscenes/det/centerhead/lssfpn/camera/
256x704/ (``swint``: Swin-T + GeneralizedLSSFPN + LSSTransform; ``resnet``:
ResNet-50 + SECONDFPN + LSSTransform; ``bevdepth``: the same with
AwareBEVDepth), each with the GeneralizedResNet + LSSFPN decoder and the
config's own CenterHead (six task groups, the circle / rotated NMS mix with
``nms_scale``), cut to tiny widths.

Both packages build each model, the JAX variables (seeded, random) are
carried across by the bridge, and the eval forward runs on the tiny batch
of tests/test_bevfusion_model.py on a jittered rig (no frustum point within
1e-4 m of a cell boundary): JAX with its in-graph pool, the port with its
host LUT. Held: every task's raw head maps (heatmap, reg, height, dim, rot,
vel) at max|d| <= 1e-5 * max(|want|, 1); the decoded boxes: keep masks and
labels equal, scores and kept boxes at the same tolerance. A training
forward raises NotImplementedError naming the loss still to port.
"""
import copy
import functools

import jax
import numpy as np
import pytest
import torch

from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu_torch.config import Config, load_config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.models.vtransforms import lss_constants
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from tests.test_bevfusion_model import make_batch
from tests.test_torch_seg_model import tiny_seg_config
from tests.torch_port_helpers import boundary_margin, jittered_rig, random_variables, rel_err

torch.set_num_threads(2)

RIG_SEED = 9  # a jitter whose frustum points all keep >= 1e-4 m from cell boundaries
RTOL = 1e-5
KINDS = tuple(flagship.DET_CAMERA_CONFIGS)  # swint, resnet, bevdepth


def tiny_det_config(kind):
    """The config's model tree cut to tiny widths: the camera branch of the
    tiny camera seg model (tests/test_torch_seg_model.py) or, for the ResNet
    configs, a ResNet-50 of base width 8 and a SECONDFPN to 4 x 8 channels at
    stride 16; the tiny GeneralizedResNet + LSSFPN decoder; the config's
    CenterHead on 16 x 16 cells of 2 m, 24 boxes a task, 10 kept a task."""
    cfg = tiny_seg_config("camera")
    real = load_config(flagship.DET_CAMERA_CONFIGS[kind]).model
    cam = cfg["encoders"]["camera"]
    if kind != "swint":
        cam["backbone"] = {"type": "ResNet", "depth": 50, "base_channels": 8,
                           "out_indices": [0, 1, 2, 3]}
        cam["neck"] = {"type": "SECONDFPN", "in_channels": [32, 64, 128, 256],
                       "out_channels": [8, 8, 8, 8], "upsample_strides": [0.25, 0.5, 1, 2]}
        cam["vtransform"] = dict(cam["vtransform"], in_channels=32, feature_size=[2, 4],
                                 xbound=[-16.0, 16.0, 2.0], ybound=[-16.0, 16.0, 2.0],
                                 downsample=1)
    if kind == "bevdepth":
        cam["vtransform"] = dict(cam["vtransform"], type="AwareBEVDepth", bevdepth_downsample=16,
                                 bevdepth_refine=False, depth_loss_factor=3.0)
    head = copy.deepcopy(dict(real["heads"]["object"]))
    assert head["type"] == "CenterHead" and len(head["tasks"]) == 6
    head.update(in_channels=24, share_conv_channel=8,
                separate_head=dict(head["separate_head"], head_conv=8))
    head["bbox_coder"] = dict(head["bbox_coder"], pc_range=[-16.0, -16.0, -5.0, 16.0, 16.0, 3.0],
                              voxel_size=[0.25, 0.25], max_num=24,
                              post_center_range=[-20.0, -20.0, -10.0, 20.0, 20.0, 10.0])
    head["test_cfg"] = dict(head["test_cfg"], post_max_size=10)
    cfg["heads"] = {"object": head}
    return cfg


def _is_head(module, method):
    return module.name == "head_modules_object" and method == "__call__"


def _moderate(variables, preds):
    """``variables`` with each branch's last conv scaled and shifted per
    channel so that its maps in ``preds`` (NHWC) take ``DET_HEAD_MODERATE``'s mean and
    std: the same model up to an affine map of each output channel."""
    params = variables["params"]["head_modules_object"]
    for t, pred in enumerate(preds):
        for name, (mean, std) in flagship.DET_HEAD_MODERATE.items():
            out = params[f"task{t}"][f"{name}_out"]
            a = std / pred[name].std(axis=(0, 1, 2))
            out["kernel"] = (out["kernel"] * a).astype(np.float32)
            out["bias"] = (a * (out["bias"] - pred[name].mean(axis=(0, 1, 2))) + mean).astype(
                np.float32)
    return variables


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    """(numpy batch, variables, raw head maps NCHW per task, boxes) of the
    JAX model's eval forward."""
    cfg = tiny_det_config(kind)
    batch = {k: np.asarray(v) for k, v in make_batch().items() if not k.startswith("gt_")}
    batch.update(jittered_rig(batch, RIG_SEED))
    vt = cfg["encoders"]["camera"]["vtransform"]
    dx, bx, nx, frustum = lss_constants(vt["image_size"], vt["feature_size"], vt["xbound"],
                                        vt["ybound"], vt["zbound"], vt["dbound"])
    assert boundary_margin(frustum, dx, bx, nx, batch) > 1e-4
    jm = jax_build_model(cfg)

    @jax.jit
    def evaluate(v, b):
        out, inter = jm.apply(v, b, capture_intermediates=_is_head, mutable=["intermediates"])
        return out["boxes"], inter["intermediates"]["head_modules_object"]["__call__"][0]

    variables = random_variables(jm.init, batch, seed=21)
    _, preds = jax.tree_util.tree_map(np.asarray, evaluate(variables, batch))
    variables = _moderate(variables, preds)
    boxes, preds = jax.tree_util.tree_map(np.asarray, evaluate(variables, batch))
    preds = [{k: v.transpose(0, 3, 1, 2) for k, v in p.items()} for p in preds]
    return batch, variables, preds, boxes


def _port(kind):
    batch, variables, *_ = _jax_run(kind)
    cfg = tiny_det_config(kind)
    model = build_model(cfg, "cpu")
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 1, 4, 2, 3).contiguous()  # NHWC -> [B, N, 3, H, W]
    return model, flagship.add_pool_lut(Config.from_dict({"model": cfg}), tb)


@pytest.mark.parametrize("kind", KINDS)
def test_camera_det_model_head_maps_match_jax(kind):
    _, _, want, _ = _jax_run(kind)
    model, tb = _port(kind)
    with torch.no_grad():
        preds = model.predict(tb)
    assert len(preds) == len(want) == 6
    for t, (p, w) in enumerate(zip(preds, want)):
        assert set(p) == set(w) == {"heatmap", "reg", "height", "dim", "rot", "vel"}
        for k in w:
            assert p[k].shape == w[k].shape == (1, w[k].shape[1], 16, 16)
            assert rel_err(p[k].numpy(), w[k]) <= RTOL, (t, k)
    assert np.std(want[0]["heatmap"]) > 0.1  # real maps, not a bias plateau


@pytest.mark.parametrize("kind", KINDS)
def test_camera_det_model_boxes_match_jax(kind):
    *_, want = _jax_run(kind)
    model, tb = _port(kind)
    with torch.no_grad():
        got = model(tb)["boxes"]
    mask = want["mask"]
    assert got["bboxes"].shape == (1, 6 * 24, 9) and 6 < mask.sum() <= 60
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    assert rel_err(got["scores"].numpy(), want["scores"]) <= RTOL
    assert rel_err(got["bboxes"].numpy()[mask], want["bboxes"][mask]) <= RTOL
    assert np.isfinite(want["bboxes"][mask]).all()


@pytest.mark.parametrize("kind", KINDS)
def test_camera_det_model_training_names_the_missing_loss(kind):
    model = build_model(tiny_det_config(kind), "cpu").train()
    with pytest.raises(NotImplementedError, match="CenterHead.loss") as err:
        model({})
    assert ("depth loss" in str(err.value)) == (kind == "bevdepth")
