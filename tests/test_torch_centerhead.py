"""Port parity of the CenterPoint family's modules against the JAX package:
rotated BEV IoU, the greedy pass of NMS and the circle / rotated NMS masks
(``ops/nms.py``), ``CenterPointBBoxCoder.decode``, ``SeparateHead`` and
``CenterHead`` (forward and ``get_bboxes``), the ResNet camera backbone
(``models/resnet.py``) and BEVDepth's ``ASPP``, ``DepthNet``,
``calib_mlp_input`` and ``AwareBEVDepth`` (``models/bevdepth.py``).

Inputs are made from numpy seeds; weights are the JAX package's random
variables carried across by the bridge (``runtime/bridge.py``). Numbers are
held at max|d| <= 1e-5 * max(|want|, 1) (fp32, the same operations in
another order); keep masks, labels and tie orders are held equal. The
decode is tried on random maps and on heatmaps with flat regions, where
equal scores must be taken in index order as ``jax.lax.top_k`` takes them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.core.coders import CenterPointBBoxCoder as JaxCoder
from bevfusion_tpu.models import bevdepth as jax_bevdepth
from bevfusion_tpu.models.heads.centerpoint import CenterHead as JaxCenterHead
from bevfusion_tpu.models.heads.centerpoint import SeparateHead as JaxSeparateHead
from bevfusion_tpu.models.resnet_full import ResNet as JaxResNet
from bevfusion_tpu.ops import iou3d as jax_iou3d
from bevfusion_tpu.ops import nms as jax_nms
from bevfusion_tpu_torch.core.coders import CenterPointBBoxCoder
from bevfusion_tpu_torch.models import bevdepth
from bevfusion_tpu_torch.models.heads.centerpoint import CenterHead, SeparateHead
from bevfusion_tpu_torch.models.resnet import ResNet
from bevfusion_tpu_torch.ops import nms
from bevfusion_tpu_torch.ops.iou3d import iou_bev
from tests.torch_port_helpers import load_bridged, random_variables, rel_err

torch.set_num_threads(2)

RTOL = 1e-5
COMMON_HEADS = {"reg": (2, 2), "height": (1, 2), "dim": (3, 2), "rot": (2, 2), "vel": (2, 2)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_boxes(rng, P, N, spread=6.0):
    """[P, N, 5] (cx, cy, dx, dy, yaw), clustered so that many overlap."""
    return np.concatenate([rng.uniform(-spread, spread, (P, N, 2)),
                           rng.uniform(0.5, 4.0, (P, N, 2)),
                           rng.uniform(-np.pi, np.pi, (P, N, 1))], -1).astype(np.float32)


def test_iou_bev_matches_jax():
    rng = np.random.RandomState(0)
    a, b = _random_boxes(rng, 1, 40)[0], _random_boxes(rng, 1, 30)[0]
    b[:5] = a[:5]  # identical boxes: IoU 1
    want = np.asarray(jax.jit(jax_iou3d.iou_bev)(a, b))
    got = iou_bev(_t(a), _t(b)).numpy()
    assert (want > 0.05).sum() > 20 and np.allclose(np.diag(want[:5, :5]), 1.0, atol=1e-5)
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 1.0])
def test_greedy_suppress_plain_matches_jax(density):
    rng = np.random.RandomState(int(density * 100))
    P, N = 3, 50
    sup = rng.rand(P, N, N) < density
    order = np.stack([rng.permutation(N) for _ in range(P)])
    want = np.asarray(jax.jit(jax.vmap(jax_nms._greedy_suppress))(order, sup))
    got = nms.greedy_suppress_plain(_t(sup), _t(order.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert nms.greedy_suppress(_t(sup), _t(order.astype(np.int64))).numpy().tolist() == \
        want.tolist()


def test_greedy_suppress_on_the_cpu_takes_the_plain_version():
    before = nms.greedy_suppress.launches
    sup = torch.ones(1, 4, 4, dtype=torch.bool)
    keep = nms.greedy_suppress(sup, torch.tensor([[2, 0, 3, 1]]))
    assert keep.tolist() == [[False, False, True, False]]  # the top-scoring one alone
    assert nms.greedy_suppress.launches == before


def _nms_inputs(case, P=2, N=60):
    rng = np.random.RandomState(3)
    boxes = _random_boxes(rng, P, N)
    scores = rng.rand(P, N).astype(np.float32)
    valid = rng.rand(P, N) < 0.8
    if case == "tied":  # blocks of equal scores: the stable order decides
        scores = np.round(scores * 4) / 4
    if case == "invalid":
        valid[:] = False
    return boxes, scores, valid


NMS_ARG = {"circle": 4.0, "rotate": 0.2}  # the squared radius, the IoU threshold


@functools.lru_cache(maxsize=None)
def _jax_nms(kind):
    """The JAX mask function over a batch of problems, compiled once."""
    fn = jax_nms.circle_nms_mask if kind == "circle" else jax_nms.nms_bev_mask
    return jax.jit(jax.vmap(lambda b, s, v: fn(b, s, v, NMS_ARG[kind])))


@pytest.mark.parametrize("kind", ["circle", "rotate"])
@pytest.mark.parametrize("case", ["random", "tied", "invalid"])
def test_nms_masks_match_jax(kind, case):
    boxes, scores, valid = _nms_inputs(case)
    if kind == "circle":
        boxes = boxes[..., :2]
        got = nms.circle_nms_mask(_t(boxes), _t(scores), _t(valid), NMS_ARG[kind])
    else:
        got = nms.nms_bev_mask(_t(boxes), _t(scores), _t(valid), NMS_ARG[kind])
    want = np.asarray(_jax_nms(kind)(boxes, scores, valid))
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "invalid":
        assert not want.any()
    else:  # suppression happened, and not everywhere
        assert 0 < want.sum() < valid.sum()


CODER = {"pc_range": [-51.2, -51.2], "post_center_range": [-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
         "max_num": 30, "score_threshold": 0.1, "out_size_factor": 8, "voxel_size": [0.8, 0.8],
         "code_size": 9}


def _maps(rng, B, C, H, W, flat=False):
    heat = rng.rand(B, C, H, W).astype(np.float32)
    if flat:  # plateaus of equal scores, as where no frustum point lands at random init
        heat[:, :, 2:, 3:] = 0.96875
        heat[:, 0, :2] = 0.9921875
    maps = {"rot_sine": rng.randn(B, 1, H, W), "rot_cosine": rng.randn(B, 1, H, W),
            "hei": rng.randn(B, 1, H, W), "dim": rng.uniform(0.5, 3, (B, 3, H, W)),
            "vel": rng.randn(B, 2, H, W), "reg": rng.rand(B, 2, H, W)}
    return heat, {k: v.astype(np.float32) for k, v in maps.items()}


@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
def test_centerpoint_decode_matches_jax(flat):
    heat, maps = _maps(np.random.RandomState(5), 2, 3, 12, 10, flat)
    want = JaxCoder(**CODER).decode(jnp.asarray(heat),
                                    **{k: jnp.asarray(v) for k, v in maps.items()})
    got = CenterPointBBoxCoder(**CODER).decode(_t(heat), **{k: _t(v) for k, v in maps.items()})
    for key in ("labels", "mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("bboxes", "scores"):
        assert rel_err(got[key].numpy(), np.asarray(want[key])) <= RTOL
    if flat:  # the top 30 reach into the plateaus: their order is the index order
        assert (np.asarray(want["scores"]) == 0.9921875).sum() > 20


def _head_cfg(tasks, nms_type, nms_scale, max_num=16):
    return dict(
        in_channels=12, tasks=tasks, share_conv_channel=8, norm_bbox=True,
        common_heads=COMMON_HEADS,
        separate_head={"type": "SeparateHead", "init_bias": -2.19, "final_kernel": 3,
                       "head_conv": 8},
        bbox_coder=dict(CODER, type="CenterPointBBoxCoder", max_num=max_num,
                        pc_range=[-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]),
        test_cfg={"post_center_limit_range": [-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
                  "min_radius": [4, 12, 0.85][:len(tasks)], "score_threshold": 0.1,
                  "out_size_factor": 8, "voxel_size": [0.8, 0.8], "nms_type": nms_type,
                  "nms_scale": nms_scale, "pre_max_size": 1000, "post_max_size": 6,
                  "nms_thr": 0.2})


HEAD_CASES = {  # the camera configs' mix of circle and rotated NMS, with nms_scale
    "mixed": (
        (("car",), ("truck", "construction_vehicle"), ("pedestrian", "traffic_cone")),
        ["circle", "rotate", "rotate"], [[1.0], [1.0, 1.0], [2.5, 4.0]]),
    "rotate": ((("car",), ("bus", "trailer")), "rotate", None),
}


@functools.lru_cache(maxsize=None)
def _jax_head_fn(case):
    """(config, JAX head, its forward + get_bboxes compiled once)."""
    cfg = _head_cfg(*HEAD_CASES[case])
    jm = JaxCenterHead(**cfg)

    def run(v, f):
        preds = jm.apply(v, f)
        return preds, jm.get_bboxes(preds)

    return cfg, jm, jax.jit(run)


def _jax_head(case, flat):
    cfg, jm, run = _jax_head_fn(case)
    rng = np.random.RandomState(7)
    feats = rng.randn(2, 16, 16, 12).astype(np.float32)
    if flat:  # zero features over a block: flat maps there, ties in the decode
        feats[:, 4:12, 4:12] = 0.0
    variables = random_variables(jm.init, feats, seed=8)
    for t in range(len(cfg["tasks"])):  # moderate logits: scores spread over (0, 1)
        variables["params"][f"task{t}"]["heatmap_out"]["kernel"] *= 0.3
    out = jax.tree_util.tree_map(np.asarray, run(variables, feats))
    return cfg, variables, feats, out


@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_centerhead_matches_jax(case, flat):
    cfg, variables, feats, (want_preds, want) = _jax_head(case, flat)
    head = load_bridged(CenterHead(**cfg), variables, "head_modules_object", "heads.object.")
    with torch.no_grad():
        preds = head(_t(feats.transpose(0, 3, 1, 2)))
        got = head.get_bboxes(preds)
    for t, (p, w) in enumerate(zip(preds, want_preds)):
        assert set(p) == set(w) == set(COMMON_HEADS) | {"heatmap"}
        for k in w:
            assert rel_err(p[k].numpy(), w[k].transpose(0, 3, 1, 2)) <= RTOL, (t, k)
    mask = want["mask"]
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    assert rel_err(got["scores"].numpy(), want["scores"]) <= RTOL
    assert rel_err(got["bboxes"].numpy()[mask], want["bboxes"][mask]) <= RTOL
    assert got["bboxes"].shape == (2, 16 * len(cfg["tasks"]), 9)
    assert mask.sum() > 4 and np.isfinite(want["bboxes"][mask]).all()


def test_separate_head_matches_jax():
    heads = {"reg": (2, 3), "heatmap": (3, 2), "dim": (3, 1)}
    jm = JaxSeparateHead(heads, head_conv=6, final_kernel=1)
    x = np.random.RandomState(9).randn(1, 8, 8, 5).astype(np.float32)
    variables = random_variables(jm.init, x, seed=10)
    want = jm.apply(variables, x)
    # the bridge names a SeparateHead under a CenterHead's task_heads
    wrapped = {col: {"task0": tree} for col, tree in variables.items()}
    head = load_bridged(torch.nn.ModuleDict({"0": SeparateHead(5, heads, 6, 1)}), wrapped,
                        "head_modules_object", "heads.object.task_heads.")["0"]
    with torch.no_grad():
        got = head(_t(x.transpose(0, 3, 1, 2)))
    for k in heads:
        assert rel_err(got[k].numpy(), np.asarray(want[k]).transpose(0, 3, 1, 2)) <= RTOL, k


def test_centerhead_raises_for_what_is_not_ported():
    cfg = _head_cfg((("car",),), "circle", None)
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        CenterHead(**dict(cfg, separate_head={"type": "DCNSeparateHead"}))
    # the loss is ported: no marker is left for BEVFusion's training forward
    assert not hasattr(CenterHead(**cfg), "unported_loss")


@pytest.mark.parametrize("depth,out_indices", [(50, (0, 1, 2, 3)), (18, (1, 3))])
def test_resnet_matches_jax(depth, out_indices):
    jm = JaxResNet(depth=depth, base_channels=8, out_indices=out_indices)
    x = np.random.RandomState(depth).rand(2, 64, 64, 3).astype(np.float32)
    variables = random_variables(jm.init, x, seed=depth)
    want = jax.jit(jm.apply)(variables, x)
    model = load_bridged(ResNet(depth=depth, base_channels=8, out_indices=out_indices), variables,
                         "camera_backbone", "encoders.camera.backbone.")
    with torch.no_grad():
        got = model(_t(x.transpose(0, 3, 1, 2)))
    assert len(got) == len(want) == len(out_indices)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape and rel_err(g.numpy(), w) <= RTOL



def test_aspp_matches_jax():
    jm = jax_bevdepth.ASPP(6)
    x = np.random.RandomState(11).randn(2, 20, 24, 6).astype(np.float32)
    variables = random_variables(jm.init, x, seed=11)
    want = np.asarray(jm.apply(variables, x)).transpose(0, 3, 1, 2)
    wrapped = {col: {"depthnet": {"aspp": tree}} for col, tree in variables.items()}
    aspp = load_bridged(bevdepth.ASPP(6, 6), wrapped, "camera_vtransform",
                        "encoders.camera.vtransform.depthnet.depth_conv.3.")
    with torch.no_grad():
        assert rel_err(aspp(_t(x.transpose(0, 3, 1, 2))).numpy(), want) <= RTOL


def _calib(rng, B, N):
    mats = {k: np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1)) + 0.1 * rng.randn(B, N, 4, 4)
            for k in ("camera_intrinsics", "img_aug_matrix", "camera2ego")}
    mats["lidar_aug_matrix"] = np.eye(4, dtype=np.float32) + 0.1 * rng.randn(B, 4, 4)
    return {k: v.astype(np.float32) for k, v in mats.items()}


def test_calib_mlp_input_matches_jax():
    m = _calib(np.random.RandomState(12), 2, 3)
    args = (m["camera_intrinsics"][..., :3, :3], m["img_aug_matrix"], m["lidar_aug_matrix"],
            m["camera2ego"])
    want = np.asarray(jax_bevdepth.calib_mlp_input(*map(jnp.asarray, args)))
    got = bevdepth.calib_mlp_input(*map(_t, args)).numpy()
    assert got.shape == (6, 27)
    np.testing.assert_array_equal(got, want)


def test_depthnet_matches_jax():
    rng = np.random.RandomState(13)
    jm = jax_bevdepth.DepthNet(8, 5, 7)
    x = rng.randn(3, 6, 10, 4).astype(np.float32)
    mlp_in = rng.randn(3, 27).astype(np.float32)
    variables = random_variables(jm.init, x, mlp_in, seed=13)
    want = np.asarray(jax.jit(jm.apply)(variables, x, mlp_in)).transpose(0, 3, 1, 2)
    wrapped = {col: {"depthnet": tree} for col, tree in variables.items()}
    net = load_bridged(torch.nn.ModuleDict({"depthnet": bevdepth.DepthNet(4, 8, 5, 7)}), wrapped,
                       "camera_vtransform", "encoders.camera.vtransform.")["depthnet"]
    with torch.no_grad():
        got = net(_t(x.transpose(0, 3, 1, 2)), _t(mlp_in)).numpy()
    assert got.shape == (3, 7 + 5, 6, 10) and rel_err(got, want) <= RTOL


def test_aware_bevdepth_matches_jax():
    """The tiny AwareBEVDepth of tests/test_models_extra.py (4x8 features,
    8 depth bins, a 32 x 32 grid of 0.5 m) on random features and a random
    calibration, through the in-graph pool."""
    kw = dict(in_channels=16, out_channels=8, image_size=(32, 64), feature_size=(4, 8),
              xbound=(-8.0, 8.0, 0.5), ybound=(-8.0, 8.0, 0.5), zbound=(-10.0, 10.0, 20.0),
              dbound=(1.0, 9.0, 1.0), downsample=1)
    jm = jax_bevdepth.AwareBEVDepth(**kw)
    rng = np.random.RandomState(14)
    B, N = 1, 2
    feats = rng.randn(B, N, 4, 8, 16).astype(np.float32)
    mats = _calib(rng, B, N)
    intr = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = 30.0
    intr[..., 0, 2], intr[..., 1, 2] = 32.0, 16.0
    mats.update(camera_intrinsics=intr, img_aug_matrix=np.tile(np.eye(4, dtype=np.float32),
                                                               (B, N, 1, 1)),
                camera2lidar=np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1)))
    variables = random_variables(jm.init, feats, None, None, mats, seed=14)
    want = np.asarray(jax.jit(lambda v, f, m: jm.apply(v, f, None, None, m))(
        variables, feats, mats)).transpose(0, 3, 1, 2)
    vt = load_bridged(bevdepth.AwareBEVDepth(**kw), variables, "camera_vtransform",
                      "encoders.camera.vtransform.")
    with torch.no_grad():
        got = vt(_t(feats.transpose(0, 1, 4, 2, 3)), None, None,
                 {k: _t(v) for k, v in mats.items()})
    assert got.shape == (B, 8, 32, 32) and np.abs(want).max() > 0.1
    assert rel_err(got.numpy(), want) <= RTOL
