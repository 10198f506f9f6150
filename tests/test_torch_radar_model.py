"""Port parity of the radar branch and AwareDBEVDepth against the JAX
package: ``RadarFeatureNet`` and ``RadarEncoder`` (``models/radar_encoder.py``; the
latter with and without a SECOND as its ``pts_bev_encoder``),
``AwareDBEVDepth`` (``models/bevdepth.py``) at stride 8 and its refusal at
stride 16, and a tiny camera + radar CenterHead detector: the tiny ResNet
camera model of tests/test_torch_camera_det_model.py beside a radar pillar
branch on the same 16 x 16 grid of 2 m, fused by a ConvFuser.

Radar scans are seeded numpy, asymmetric (clusters off both diagonals, so
an X / Y swap of either BEV map changes the fused map), with feature
channels that hold NaN where a test says so. Weights are the JAX package's
random variables carried across by the bridge. Held at max|d| <= 1e-5 *
max(|want|, 1): the modules, every task's raw head maps and the decoded
boxes (keep masks and labels equal; the maps moderated per branch as that
file does), and AwareDBEVDepth's depth loss at stride 8 (eval). A NaN in a
radar feature channel reaches neither package's Linear (``nan_to_num``
after the decoration).

The tiny camera + radar model's training (16 random boxes) is held as
tests/test_torch_camera_det_model.py holds the camera detectors: the port
in float64 to 1e-4 (losses; all gradients together in norm; each
parameter's to 1e-3; measured 1.5e-6 and 5.9e-6) and in fp32 (losses to
1e-3; its gradients move 7.8% in norm from float64 there), against the JAX
model built in float64, its gradient taken eagerly: XLA's jitted gradient
of a pillar net in training mode is wrong on the CPU backend (ROADMAP
Queue 3, tests/test_torch_pillar.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models import bevdepth as jax_bevdepth
from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu.models import radar_encoder as jax_radar
from bevfusion_tpu.ops import voxelize as jvox
from bevfusion_tpu_torch.config import Config, load_config
from bevfusion_tpu_torch.data.transforms import GTDepth
from bevfusion_tpu_torch.models import bevdepth, build_model, radar_encoder
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from tests.test_bevfusion_model import make_batch
from tests.test_torch_camera_det_model import (RIG_SEED, _is_head, _moderate,
                                               assert_training_matches, jax_value_and_grad,
                                               tiny_det_config, train_batch)
from tests.torch_port_helpers import jittered_rig, load_bridged, random_variables, rel_err

torch.set_num_threads(2)

RTOL = 1e-5
PCR = [-16.0, -16.0, -4.0, 16.0, 16.0, 4.0]
VS = [2.0, 2.0, 8.0]  # 16 x 16 pillars, the camera grid's cells
CHANNELS = 13  # xyz, RCS, velocity, compensated velocity, time lag, 4 one-hot
RFN = {"type": "RadarFeatureNet", "in_channels": CHANNELS, "feat_channels": [16, 16, 16],
       "with_distance": False, "point_cloud_range": PCR, "voxel_size": VS,
       "norm_cfg": {"type": "BN1d", "eps": 1e-3, "momentum": 0.01}}
SCATTER = {"type": "PointPillarsScatter", "in_channels": 16, "output_shape": [16, 16]}
DBEV = dict(in_channels=16, out_channels=8, image_size=(32, 64), feature_size=(4, 8),
            xbound=(-8.0, 8.0, 0.5), ybound=(-8.0, 8.0, 0.5), zbound=(-10.0, 10.0, 20.0),
            dbound=(1.0, 9.0, 1.0), downsample=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def radar_scan(seed, n=200, nan_rows=0):
    """An asymmetric radar scan [n, CHANNELS]: 80% of the points in five
    clusters off both diagonals, the rest clutter, z near the ground; 10%
    padding (mask False). ``nan_rows`` valid points hold NaN in the RCS and
    a velocity channel."""
    rng = np.random.RandomState(seed)
    centres = np.array([[11.0, -5.0], [5.0, 10.0], [-3.0, -12.0], [-12.0, 2.0], [8.0, 4.0]])
    on = rng.rand(n) < 0.8
    xy = np.where(on[:, None], centres[rng.randint(0, 5, n)] + rng.normal(0, 1.0, (n, 2)),
                  rng.uniform(-15, 15, (n, 2)))
    onehot = np.eye(4)[rng.randint(0, 4, n)]
    pts = np.concatenate([np.clip(xy, -15.9, 15.9), rng.normal(-1.3, 0.3, (n, 1)),
                          rng.normal(5, 8, (n, 1)), rng.normal(0, 3, (n, 4)),
                          rng.randint(0, 3, (n, 1)) * 0.065, onehot], -1).astype(np.float32)
    mask = np.arange(n) < int(0.9 * n)
    pts[~mask] = 0.0
    pts[:nan_rows, 3] = np.nan
    pts[:nan_rows, 5] = np.nan
    return pts, mask


def _tables(seeds, nan_rows=0, max_points=4, max_voxels=48):
    out = [jvox.voxelize(*map(jnp.asarray, radar_scan(s, nan_rows=nan_rows)), VS, PCR,
                         max_points, max_voxels, reduce=None) for s in seeds]
    return tuple(jnp.stack([getattr(o, k) for o in out])
                 for k in ("feats", "coords", "mask", "num_points"))


@pytest.mark.parametrize("nan_rows", [0, 12])
def test_radar_feature_net_matches_jax(nan_rows):
    feats, coords, mask, num = (a[0] for a in _tables([3], nan_rows))
    assert np.isnan(np.asarray(feats)).any() == (nan_rows > 0)
    cfg = {k: v for k, v in RFN.items() if k != "type"}
    jm = jax_radar.RadarFeatureNet(**cfg)
    variables = random_variables(jm.init, feats, num, coords, seed=4)
    want = np.asarray(jax.jit(jm.apply)(variables, feats, num, coords))
    net = radar_encoder.RadarFeatureNet(**cfg)
    assert net.rfn_layers[0].linear.in_features == CHANNELS + 2 == \
        variables["params"]["rfn0"]["linear"]["kernel"].shape[0]
    load_bridged(net, variables, "radar_backbone/RadarFeatureNet_0",
                 "encoders.radar.backbone.pts_voxel_encoder.")
    with torch.no_grad():
        got = net(_t(feats), _t(num), _t(coords))
    assert got.shape == (48, 16) and np.isfinite(want).all() and np.abs(want).max() > 0.1
    assert torch.isfinite(got).all() and rel_err(got.numpy(), want) <= RTOL
    assert np.all(want[~np.asarray(mask)] == 0)  # an empty pillar's max is 0


# the optional pts_bev_encoder: a two-stage SECOND, its first map kept
SECOND_BEV = {"type": "SECOND", "in_channels": 16, "out_channels": [8, 12], "layer_nums": [1, 1],
              "layer_strides": [1, 2]}


@pytest.mark.parametrize("bev_encoder", [None, SECOND_BEV], ids=["none", "second"])
def test_radar_encoder_matches_jax(bev_encoder):
    args = _tables([5, 6])
    kw = dict(pts_voxel_encoder=RFN, pts_middle_encoder=SCATTER, pts_bev_encoder=bev_encoder)
    jm = jax_radar.RadarEncoder(**kw)
    variables = random_variables(jm.init, *args, seed=7)
    want = np.asarray(jax.jit(jm.apply)(variables, *args)).transpose(0, 3, 1, 2)
    enc = radar_encoder.RadarEncoder(**kw)
    load_bridged(enc, variables, "radar_backbone", "encoders.radar.backbone.")
    with torch.no_grad():
        got = enc(*(_t(a) for a in args))
    width = 8 if bev_encoder else 16
    assert got.shape == (2, width, 16, 16) and np.abs(want).max() > 0.1
    assert rel_err(got.numpy(), want) <= RTOL
    # asymmetric: a map swapped in X and Y would not pass for this one
    assert rel_err(got.transpose(2, 3).numpy(), want) > 0.1


def _dbev_inputs():
    """Image features [1, 2, 4, 8, 16] (NHWC), the tiny batch's points and a
    jittered rig with the image intrinsics of tests/test_bevfusion_model.py."""
    batch = {k: np.asarray(v) for k, v in make_batch().items() if not k.startswith("gt_")}
    batch.update(jittered_rig(batch, RIG_SEED))
    mats = {k: batch[k] for k in ("camera_intrinsics", "img_aug_matrix", "lidar_aug_matrix",
                                  "camera2ego", "camera2lidar", "lidar2image")}
    feats = np.random.RandomState(15).randn(1, 2, 4, 8, 16).astype(np.float32)
    return feats, batch["points"], batch["points_mask"], mats


def test_aware_dbevdepth_matches_jax_at_stride_8():
    feats, pts, pmask, mats = _dbev_inputs()
    jm = jax_bevdepth.AwareDBEVDepth(**DBEV)
    variables = random_variables(jm.init, feats, pts, pmask, mats, seed=16)
    want = np.asarray(jax.jit(jm.apply)(variables, feats, pts, pmask, mats)).transpose(0, 3, 1, 2)
    vt = load_bridged(bevdepth.AwareDBEVDepth(**DBEV), variables, "camera_vtransform",
                      "encoders.camera.vtransform.")
    assert [k for k in vt.state_dict() if k.startswith("fuse_depth")][:2] == [
        "fuse_depth.0.weight", "fuse_depth.0.bias"]
    with torch.no_grad():
        got = vt(_t(feats.transpose(0, 1, 4, 2, 3)), _t(pts), _t(pmask),
                 {k: _t(v) for k, v in mats.items()})
        without = vt(_t(feats.transpose(0, 1, 4, 2, 3)), _t(pts), _t(np.zeros_like(pmask)),
                     {k: _t(v) for k, v in mats.items()})
    assert got.shape == (1, 8, 32, 32) and np.abs(want).max() > 0.1
    assert rel_err(got.numpy(), want) <= RTOL
    assert rel_err(without.numpy(), want) > 1e-3  # the points' depth takes part


def test_aware_dbevdepth_depth_loss_matches_jax_at_stride_8():
    """The depth loss of the stride-8 module against the JAX one's, on the
    depth images ``GTDepth`` makes of the points through the same rig (4 x 8
    blocks of 8 x 8 pixels a camera, 8 bins of 1 m)."""
    feats, pts, pmask, mats = _dbev_inputs()
    data = {"points": pts[0][pmask[0]], "img": [np.zeros((32, 64, 3))] * 2,
            **{k: mats[k][0] for k in ("lidar2image", "img_aug_matrix", "lidar_aug_matrix")}}
    depths = GTDepth()(data)["depths"][None]
    jm = jax_bevdepth.AwareDBEVDepth(**DBEV)
    variables = random_variables(jm.init, feats, pts, pmask, mats, seed=16)
    want_bev, want = jax.jit(lambda v: jm.apply(v, feats, pts, pmask, mats, gt_depths=depths,
                                                depth_loss=True))(variables)
    vt = load_bridged(bevdepth.AwareDBEVDepth(**DBEV), variables, "camera_vtransform",
                      "encoders.camera.vtransform.")
    with torch.no_grad():
        bev, got = vt(_t(feats.transpose(0, 1, 4, 2, 3)), _t(pts), _t(pmask),
                      {k: _t(v) for k, v in mats.items()}, gt_depths=_t(depths))
    assert vt.bevdepth_downsample == 8 and (depths > 0).sum() > 50
    assert rel_err(bev.numpy(), np.asarray(want_bev).transpose(0, 3, 1, 2)) <= RTOL
    assert float(want) > 0.1 and abs(got.item() - float(want)) <= RTOL * float(want)


def test_aware_dbevdepth_refuses_stride_16_as_jax_fails_there():
    """At stride 16 the depth branch (stride 8) and the image features differ
    in size: the JAX module fails at the concatenation, the port at build."""
    kw = dict(DBEV, feature_size=(2, 4))
    feats, pts, pmask, mats = _dbev_inputs()
    with pytest.raises(TypeError, match="[Cc]oncatenat"):
        jax.eval_shape(jax_bevdepth.AwareDBEVDepth(**kw).init, jax.random.PRNGKey(0),
                       feats[:, :, :2, :4], pts, pmask, mats)
    with pytest.raises(ValueError, match=r"4 x 8 .* 2 x 4"):
        bevdepth.AwareDBEVDepth(**kw)
    with pytest.raises(ValueError, match=r"32 x 88 .* 16 x 44"):
        build_model(load_config(flagship.DLSS_CONFIG).model, "cpu")


# -- the tiny camera + radar CenterHead detector ------------------------------

def tiny_radar_config():
    """tests/test_torch_camera_det_model.py's tiny ``resnet`` detector (ResNet-50
    of base width 8, SECONDFPN, LSSTransform to 16 channels on 16 x 16 cells
    of 2 m, GeneralizedResNet + LSSFPN, the config's CenterHead) with the
    radar branch of camera+radar/resnet50/default.yaml cut to the same grid
    (three RFN layers to 16 channels, 4 points a pillar, 48 pillars) and the
    ConvFuser to 16 channels."""
    cfg = tiny_det_config("resnet")
    real = load_config(flagship.PILLAR_CONFIGS["camera+radar"]).model
    assert real["encoders"]["radar"]["backbone"]["type"] == "RadarEncoder"
    cfg["encoders"]["radar"] = {
        "voxelize_reduce": False,
        "voxelize": {"max_num_points": 4, "point_cloud_range": PCR, "voxel_size": VS,
                     "max_voxels": [48, 48]},
        "backbone": {"type": "RadarEncoder", "pts_voxel_encoder": RFN,
                     "pts_middle_encoder": SCATTER, "pts_bev_encoder": None}}
    cfg["fuser"] = {"type": "ConvFuser", "in_channels": [16, 16], "out_channels": 16}
    return cfg


def _batch(nan_rows=0):
    batch = {k: np.asarray(v) for k, v in make_batch().items() if not k.startswith("gt_")}
    batch.update(jittered_rig(batch, RIG_SEED))
    radar, mask = radar_scan(21, nan_rows=nan_rows)
    batch.update(radar=radar[None], radar_mask=mask[None])
    return batch


@functools.lru_cache(maxsize=None)
def _jax_run():
    """(variables, {nan_rows: (numpy batch, raw head maps NCHW per task,
    boxes)}) of the JAX model's eval forward, moderated on the clean batch."""
    jm = jax_build_model(tiny_radar_config())

    @jax.jit
    def evaluate(v, b):
        out, inter = jm.apply(v, b, capture_intermediates=_is_head, mutable=["intermediates"])
        return out["boxes"], inter["intermediates"]["head_modules_object"]["__call__"][0]

    variables = random_variables(jm.init, _batch(), seed=22)
    _, preds = jax.tree_util.tree_map(np.asarray, evaluate(variables, _batch()))
    variables = _moderate(variables, preds)
    runs = {}
    for nan_rows in (0, 12):
        batch = _batch(nan_rows)
        boxes, preds = jax.tree_util.tree_map(np.asarray, evaluate(variables, batch))
        runs[nan_rows] = batch, [{k: v.transpose(0, 3, 1, 2) for k, v in p.items()}
                                 for p in preds], boxes
    return variables, runs


def _port(nan_rows):
    variables, runs = _jax_run()
    cfg = tiny_radar_config()
    model = build_model(cfg, "cpu")
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    tb = {k: _t(v) for k, v in runs[nan_rows][0].items()}
    tb["img"] = tb["img"].permute(0, 1, 4, 2, 3).contiguous()  # NHWC -> [B, N, 3, H, W]
    return model, flagship.add_pool_lut(Config.from_dict({"model": cfg}), tb)


@pytest.mark.parametrize("nan_rows", [0, 12])
def test_camera_radar_model_head_maps_match_jax(nan_rows):
    _, runs = _jax_run()
    _, want, _ = runs[nan_rows]
    model, tb = _port(nan_rows)
    assert np.isnan(tb["radar"].numpy()).any() == (nan_rows > 0)
    with torch.no_grad():
        preds = model.predict(tb)
    assert len(preds) == len(want) == 6
    for t, (p, w) in enumerate(zip(preds, want)):
        for k in w:
            assert p[k].shape == w[k].shape == (1, w[k].shape[1], 16, 16)
            assert torch.isfinite(p[k]).all() and rel_err(p[k].numpy(), w[k]) <= RTOL, (t, k)
    assert np.std(want[0]["heatmap"]) > 0.1  # real maps, not a bias plateau


@pytest.mark.parametrize("nan_rows", [0, 12])
def test_camera_radar_model_boxes_match_jax(nan_rows):
    _, runs = _jax_run()
    *_, want = runs[nan_rows]
    model, tb = _port(nan_rows)
    with torch.no_grad():
        got = model(tb)["boxes"]
    mask = want["mask"]
    assert got["bboxes"].shape == (1, 6 * 24, 9) and 6 < mask.sum() <= 60
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    assert rel_err(got["scores"].numpy(), want["scores"]) <= RTOL
    assert rel_err(got["bboxes"].numpy()[mask], want["bboxes"][mask]) <= RTOL
    assert np.isfinite(want["bboxes"][mask]).all()


def test_camera_radar_model_fuses_the_radar_map():
    """The radar branch's map reaches the fuser in (camera, radar) order:
    zeroing the radar scan changes the head maps."""
    model, tb = _port(0)
    with torch.no_grad():
        full = model.predict(tb)[0]["heatmap"]
        blind = model.predict(dict(tb, radar_mask=torch.zeros_like(tb["radar_mask"])))[0]["heatmap"]
    assert list(model.encoders) == ["camera", "radar"]
    assert model.fuser[0].in_channels == 32
    assert rel_err(blind.numpy(), full.numpy()) > 1e-3


def test_camera_radar_model_training_matches_jax_float64():
    variables, runs = _jax_run()
    cfg, batch = tiny_radar_config(), train_batch(runs[0][0])
    want = jax_value_and_grad(cfg, variables, batch, jit=False)  # eager: see the docstring
    assert {k for k in want[0] if "bbox" in k and float(want[0][k]) > 0}
    assert_training_matches(cfg, variables, batch, want)
