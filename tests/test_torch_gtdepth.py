"""The depth target and the depth loss of BEVDepth against the JAX package.

- ``data/transforms.py:GTDepth``, the port's copy, bit for bit against
  ``bevfusion_tpu/data/transforms.py:GTDepth`` on a ``LiDARPoints`` scan
  (``synthetic_lidar_scan``: ten sweeps, the fifth column the time lag)
  through the six-camera rig at 256 x 704, jittered, with and without
  image and LiDAR augmentation, keyframe only or every sweep; the port
  takes the bare array as well;
- ``models/bevdepth.py``: ``downsampled_gt_depth``'s one-hot labels equal to
  the JAX ones, and ``bce_depth_loss`` within 1e-6 relative, at the
  strides and depth bins of the configs (16 and 59 bins of 1 m, bevdepth.yaml;
  8 and 118 of 0.5 m) on those depth images;
- ``runtime/flagship.py:add_train_targets`` leaves ``synthetic_batch``'s
  arrays byte-equal to the JAX package's and adds the JAX ``GTDepth`` of the
  batch (keyframe only, as the nuScenes pipelines set it) and, for a map
  head, seeded masks on its output grid.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from bevfusion_tpu.config import load_config as jax_load_config
from bevfusion_tpu.data.points import LiDARPoints
from bevfusion_tpu.data.transforms import GTDepth as JaxGTDepth
from bevfusion_tpu.models import bevdepth as jax_bevdepth
from bevfusion_tpu.runtime.flagship import synthetic_batch as jax_synthetic_batch
from bevfusion_tpu_torch.config import load_config
from bevfusion_tpu_torch.data.transforms import GTDepth
from bevfusion_tpu_torch.models import bevdepth
from bevfusion_tpu_torch.runtime import flagship
from tests.torch_port_helpers import jittered_rig

torch.set_num_threads(2)

IMAGE = (256, 704)
PCR = [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0]


def _augs(rng):
    """An image augmentation per camera (a resize by 0.9-1.1, a crop, a
    small rotation) and a LiDAR one (rotation about z, scale, translation)."""
    img_aug = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    for n in range(6):
        a = rng.uniform(-0.1, 0.1)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        img_aug[n, :2, :2] = rng.uniform(0.9, 1.1) * rot
        img_aug[n, :2, 3] = [rng.uniform(-35, 35), rng.uniform(-30, 0)]
    la = np.eye(4, dtype=np.float32)
    a = rng.uniform(-0.4, 0.4)
    la[:2, :2] = 1.03 * np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    la[2, 2] = 1.03
    la[:3, 3] = rng.normal(0, 0.5, 3)
    return img_aug, la


@functools.lru_cache(maxsize=None)
def _sample(aug, seed=3):
    """(points [P, 5] in range, the data dict's matrices) of one sample."""
    points, mask = flagship.synthetic_lidar_scan(60000, PCR, seed=seed)
    mats = flagship.synthetic_calibration(1, 6, IMAGE)
    mats.update(jittered_rig(mats, seed))
    mats = {k: v[0] for k, v in mats.items()}
    if aug:
        mats["img_aug_matrix"], mats["lidar_aug_matrix"] = _augs(np.random.RandomState(seed))
    return points[mask], mats


def _data(points, mats):
    return {"points": points, "img": [np.zeros(IMAGE + (3,), np.float32)] * 6,
            "lidar2image": mats["lidar2image"], "img_aug_matrix": mats["img_aug_matrix"],
            "lidar_aug_matrix": mats["lidar_aug_matrix"]}


@functools.lru_cache(maxsize=None)
def _jax_depths(aug, keyframe_only):
    points, mats = _sample(aug)
    return JaxGTDepth(keyframe_only)(_data(LiDARPoints(points), mats))["depths"]


@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("keyframe_only", [True, False])
def test_gtdepth_is_bit_equal_to_jax(aug, keyframe_only):
    points, mats = _sample(aug)
    want = _jax_depths(aug, keyframe_only)
    got = GTDepth(keyframe_only)(_data(LiDARPoints(points), mats))["depths"]
    bare = GTDepth(keyframe_only)(_data(points, mats))["depths"]
    assert got.dtype == want.dtype == np.float32 and got.shape == (6,) + IMAGE
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bare, want)
    hit = (want > 0).sum(axis=(1, 2))
    assert (hit > 20).all() and want.max() < 60  # every camera sees returns
    if keyframe_only:  # a tenth of the scan: the keyframe's sweep
        assert (want > 0).sum() < 0.6 * (_jax_depths(aug, False) > 0).sum()


@pytest.mark.parametrize("factor,dbound", [(16, (1.0, 60.0, 1.0)), (8, (1.0, 60.0, 0.5))])
@pytest.mark.parametrize("aug", [False, True])
def test_depth_loss_matches_jax(factor, dbound, aug):
    gt = np.stack([_jax_depths(aug, False), _jax_depths(not aug, True)])  # [B = 2, 6, H, W]
    D = int(round((dbound[1] - dbound[0]) / dbound[2]))
    fH, fW = IMAGE[0] // factor, IMAGE[1] // factor
    logits = np.random.RandomState(factor).randn(2 * 6, fH, fW, D).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    want_labels = np.asarray(jax_bevdepth.downsampled_gt_depth(gt, factor, dbound, D))
    want = float(jax_bevdepth.bce_depth_loss(probs, gt, factor, dbound, D, 3.0))
    labels = bevdepth.downsampled_gt_depth(torch.from_numpy(gt), factor, dbound, D)
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    fg = want_labels.max(1) > 0
    assert 200 < fg.sum() < 0.5 * fg.size  # foreground blocks, and background ones
    depth = torch.from_numpy(probs.reshape(2, 6, fH, fW, D).transpose(0, 1, 4, 2, 3).copy())
    got = bevdepth.bce_depth_loss(depth, torch.from_numpy(gt), factor, dbound, D, 3.0).item()
    assert abs(got - want) <= 1e-6 * want, (got, want)


@pytest.mark.parametrize("config", [flagship.SEG_CONFIGS["fusion-bev256d2-lss"],
                                    flagship.DET_CAMERA_CONFIGS["bevdepth"]],
                         ids=["seg-fused", "bevdepth"])
def test_add_train_targets_keeps_the_synthetic_batch_byte_equal_to_jax(config):
    want = {k: np.asarray(v) for k, v in jax_synthetic_batch(
        jax_load_config(config), B=1, num_points=6000, seed=2, training=True).items()}
    cfg = load_config(config)
    got = flagship.add_train_targets(
        cfg, flagship.synthetic_batch(cfg, B=1, num_points=6000, seed=2, training=True), seed=2)
    got = {k: v.numpy() for k, v in got.items()}
    got["img"] = got["img"].transpose(0, 1, 3, 4, 2)  # NCHW -> the JAX package's NHWC
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    depths = JaxGTDepth(keyframe_only=True)({
        "points": LiDARPoints(want["points"][0][want["points_mask"][0]]),
        "img": list(want["img"][0]),
        **{k: want[k][0] for k in ("lidar2image", "img_aug_matrix", "lidar_aug_matrix")}})["depths"]
    np.testing.assert_array_equal(got["depths"][0], depths)
    assert (depths > 0).sum() > 100
    extra = {"depths"} | ({"gt_masks_bev"} if cfg.model.heads.get("map") else set())
    assert set(got) == set(want) | extra
    if "gt_masks_bev" in got:
        masks = got["gt_masks_bev"]
        assert masks.shape == (1, 6, 200, 200) and set(np.unique(masks)) == {0.0, 1.0}
        assert 0.25 < masks.mean() < 0.35
