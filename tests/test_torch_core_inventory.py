"""The port's core inventory that no config reaches, held to the JAX package.

- ``core/{box_np_ops,box_modes,anchors}.py``: numpy copies, bit for bit
  against ``bevfusion_tpu/core/`` on random inputs, and the oracles of
  tests/test_box_np_ops.py run on the port's module;
- ``core/assign_sample.py`` (torch IoU calculators and assigners, the
  samplers' numpy contract) and the coders of ``core/coders.py`` the
  configs do not name: against the JAX ones at 1e-6 (fp32 elementwise
  arithmetic in another order), equal where the result is discrete, and
  the oracles of tests/test_inventory_extras.py (anchors, box modes, the
  pseudo sampler and IoU, the delta coder's torch formula and round trips,
  the bin coders, NMS-free decode, the piecewise sampler);
- every class registers in the port's registries under its JAX name.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_box_np_ops as box_np_ops_oracles
from bevfusion_tpu.core import anchors as jax_anchors
from bevfusion_tpu.core import assign_sample as jax_as
from bevfusion_tpu.core import box_modes as jax_modes
from bevfusion_tpu.core import box_np_ops as jax_ops
from bevfusion_tpu.core import coders as jax_coders
from bevfusion_tpu_torch.core import anchors, assign_sample, box_modes, box_np_ops, coders
from bevfusion_tpu_torch.core.box_np import points_in_rbbox
from bevfusion_tpu_torch.registry import BBOX_ASSIGNERS, BBOX_CODERS

torch.set_num_threads(2)

RTOL = 1e-6


def _boxes(rng, n, extra=0):
    return np.concatenate([rng.uniform(-20, 20, (n, 3)), rng.uniform(1, 4, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1)), rng.randn(n, extra)],
                          -1).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max(initial=0.0) <= rtol * max(np.abs(want).max(initial=0.0), 1.0)


# ----------------------------------------------------------------------
# the numpy copies, bit for bit
# ----------------------------------------------------------------------

def _np_cases(rng):
    pts = rng.uniform(-10, 10, (40, 5))
    boxes = _boxes(rng, 6).astype(np.float64)
    corners = jax_ops.center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6], boxes[:, 6],
                                             (0.5, 0.5, 0.0), axis=2)
    K = np.array([[700.0, 0, 320, 0], [0, 700, 240, 0], [0, 0, 1, 0]])
    r_rect, velo2cam = np.eye(4), np.eye(4)
    velo2cam[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
    square = np.array([[[0, 0], [0, 2], [2, 2], [2, 0]]], np.float64)
    return {
        "limit_period": (rng.uniform(-9, 9, 50),),
        "corners_nd": (rng.uniform(1, 3, (5, 3)), (0.5, 1.0, 0.5)),
        "rotation_2d_points": (rng.randn(4, 4, 2), rng.randn(4)),
        "rotation_3d_in_axis": (rng.randn(4, 8, 3), rng.randn(4), 2),
        "rotation_points_single_angle": (rng.randn(7, 3), 0.3, 1),
        "center_to_corner_box2d": (boxes[:, :2], boxes[:, 3:5], boxes[:, 6]),
        "center_to_corner_box3d": (boxes[:, :3], boxes[:, 3:6], boxes[:, 6]),
        "corner_to_standup_nd": (corners,),
        "corner_to_surfaces_3d": (corners,),
        "surface_equ_3d": (jax_ops.corner_to_surfaces_3d(corners),),
        "points_in_convex_polygon_3d": (pts[:, :3], jax_ops.corner_to_surfaces_3d(corners)),
        "points_in_convex_polygon": (rng.uniform(-1, 3, (30, 2)), square),
        "points_cam2img": (rng.uniform(1, 9, (10, 3)), K, True),
        "camera_to_lidar": (pts[:, :3], r_rect, velo2cam),
        "lidar_to_camera": (pts[:, :3], r_rect, velo2cam),
        "box_camera_to_lidar": (boxes, r_rect, velo2cam),
        "box3d_to_bbox": (boxes + [0, 0, 30, 0, 0, 0, 0], K),
        "points_in_rbbox": (pts, boxes),
        "minmax_to_corner_2d": (np.sort(rng.uniform(-5, 5, (6, 4)), -1),),
        "center_to_minmax_2d": (boxes[:, :2], boxes[:, 3:5]),
        "rbbox2d_to_near_bbox": (boxes[:, [0, 1, 3, 4, 6]],),
        "iou_2d": (np.sort(rng.uniform(0, 9, (5, 4)), -1), np.sort(rng.uniform(0, 9, (4, 4)), -1)),
        "projection_matrix_to_CRT_kitti": (K + [[0, 0, 0, 1.0]],),
        "get_frustum": ([0, 0, 100, 60], K[:3, :3]),
        "remove_outside_points": (rng.uniform(-20, 20, (50, 4)), r_rect, velo2cam, K,
                                  (60, 100)),
        "depth_to_points": (rng.uniform(0, 5, (6, 8)), 1),
        "depth_to_lidar_points": (rng.uniform(0, 5, (6, 8)), 1, np.eye(4), r_rect, velo2cam),
        "boxes3d_to_corners3d_lidar": (boxes,),
    }


def test_box_np_ops_is_the_jax_modules_bit_for_bit():
    cases = _np_cases(np.random.RandomState(0))
    assert set(cases) == set(jax_ops.__all__) - {"LiDARBoxes3D"}  # every exported function
    for name, args in cases.items():
        got, want = getattr(box_np_ops, name)(*args), getattr(jax_ops, name)(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert np.asarray(g).dtype == np.asarray(w).dtype, name
            assert np.array_equal(g, w, equal_nan=True), name


@pytest.mark.parametrize("name", sorted(n for n in dir(box_np_ops_oracles)
                                        if n.startswith("test_")))
def test_box_np_ops_passes_the_jax_oracles(monkeypatch, name):
    monkeypatch.setattr(box_np_ops_oracles, "ops", box_np_ops)
    monkeypatch.setattr(box_np_ops_oracles, "pir_lidar", points_in_rbbox)
    getattr(box_np_ops_oracles, name)()


def test_box_modes_are_the_jax_modules_bit_for_bit():
    rng = np.random.RandomState(1)
    boxes, pts = _boxes(rng, 5, extra=2), rng.randn(7, 5).astype(np.float32)
    rt = np.eye(4, dtype=np.float32)
    rt[:3, 3] = [1, 2, 3]
    M, JM = box_modes.Box3DMode, jax_modes.Box3DMode
    for src in M:
        for dst in M:
            for mat in (None, rt):
                pairs = [(box_modes.convert_boxes(boxes, src, dst, mat),
                          jax_modes.convert_boxes(boxes, JM(src), JM(dst), mat)),
                         (box_modes.convert_points(pts, src, dst, mat),
                          jax_modes.convert_points(pts, JM(src), JM(dst), mat))]
                for got, want in pairs:
                    assert got.dtype == want.dtype and np.array_equal(got, want)
    # the oracle of tests/test_inventory_extras.py:34: LiDAR -> CAM -> LiDAR
    back = box_modes.convert_boxes(box_modes.convert_boxes(boxes, M.LIDAR, M.CAM), M.CAM,
                                   M.LIDAR)
    np.testing.assert_allclose(back[:, :6], boxes[:, :6], atol=1e-5)


@pytest.mark.parametrize("cls", ["Anchor3DRangeGenerator", "AlignedAnchor3DRangeGenerator"])
@pytest.mark.parametrize("custom", [(), (0.0, 0.5)])
def test_anchor_generators_are_the_jax_modules_bit_for_bit(cls, custom):
    kw = dict(ranges=[[-10, -10, -1, 10, 10, -1], [-5, -5, -2, 5, 5, 0]],
              sizes=[[1.6, 3.9, 1.56], [0.6, 0.8, 1.7]], rotations=[0.0, 1.5707963],
              scales=[1, 2], custom_values=custom)
    got = anchors.ANCHOR_GENERATORS.build(dict(kw, type=cls))
    want = jax_anchors.ANCHOR_GENERATORS.build(dict(kw, type=cls))
    for size in ((1, 4, 4), (2, 3, 5)):
        g, w = got.grid_anchors(size), want.grid_anchors(size)
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got.num_base_anchors == want.num_base_anchors == 8
    if cls == "Anchor3DRangeGenerator" and not custom:  # tests/test_inventory_extras.py:22
        a = anchors.Anchor3DRangeGenerator(ranges=[[-10, -10, -1, 10, 10, -1]],
                                           sizes=[[1.6, 3.9, 1.56]],
                                           rotations=[0.0, 1.5707963]).grid_anchors((1, 4, 4))
        assert a.shape == (1, 4, 4, 2, 7) and np.allclose(a[0, 0, 0, 0, 3:6], [1.6, 3.9, 1.56])
        assert a[0, 0, 0, 1, 6] != a[0, 0, 0, 0, 6]


# ----------------------------------------------------------------------
# assigners, samplers, IoU calculators
# ----------------------------------------------------------------------

def _same_result(got, want):
    assert got.num_gts == want.num_gts
    np.testing.assert_array_equal(got.gt_inds, want.gt_inds)
    np.testing.assert_array_equal(got.labels, want.labels)
    _close(got.max_overlaps, want.max_overlaps)


@pytest.mark.parametrize("name", ["BboxOverlaps3D", "BboxOverlapsNearest3D"])
def test_iou_calculators_match_jax(name):
    rng = np.random.RandomState(2)
    b1, b2 = _boxes(rng, 8), _boxes(rng, 6)
    b2[:3] = b1[:3] + rng.uniform(-0.5, 0.5, (3, 7)).astype(np.float32)  # real overlaps
    got = getattr(assign_sample, name)("lidar")(b1, b2)
    want = np.asarray(getattr(jax_as, name)("lidar")(b1, b2))
    assert (want > 0.1).sum() >= 3
    _close(got.numpy(), want)
    # tests/test_inventory_extras.py:49: a box with itself 1, disjoint boxes 0
    gt = np.array([[0, 0, 0, 2, 2, 2, 0.0], [5, 5, 0, 2, 2, 2, 0.0]], np.float32)
    iou = getattr(assign_sample, name)("lidar")(gt, gt).numpy()
    np.testing.assert_allclose(np.diag(iou), [1.0, 1.0], atol=1e-4)
    assert iou[0, 1] < 1e-5


def test_pseudo_sampler_matches_jax():
    gt_inds = np.array([0, 2, 0, 1])
    gt = np.array([[0, 0, 0, 2, 2, 2, 0.0], [5, 5, 0, 2, 2, 2, 0.0]], np.float32)
    got = assign_sample.PseudoSampler().sample(
        assign_sample.AssignResult(2, gt_inds, np.zeros(4), np.array([-1, 1, -1, 0])),
        np.zeros((4, 7)), gt)
    want = jax_as.PseudoSampler().sample(
        jax_as.AssignResult(2, gt_inds, np.zeros(4), np.array([-1, 1, -1, 0])),
        np.zeros((4, 7)), gt)
    assert list(got.pos_inds) == [1, 3] and list(got.pos_assigned_gt_inds) == [1, 0]
    for key in ("pos_inds", "neg_inds", "pos_assigned_gt_inds", "pos_gt_bboxes"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))


@pytest.mark.parametrize("neg_pos_ub", [-1, 1])
def test_iou_neg_piecewise_sampler_matches_jax(neg_pos_ub):
    n_pred = 200
    rng = np.random.RandomState(0)
    gt_inds = np.zeros(n_pred, np.int64)
    gt_inds[:20] = rng.randint(1, 3, 20)
    overlaps = rng.uniform(0, 0.6, n_pred).astype(np.float32)
    kw = dict(num=128, pos_fraction=0.5, neg_piece_fractions=[0.8, 0.2],
              neg_iou_piece_thrs=[0.55, 0.1], neg_pos_ub=neg_pos_ub, return_iou=True, seed=0)
    args = (np.zeros((n_pred, 7), np.float32), np.zeros((2, 7), np.float32))
    got = assign_sample.IoUNegPiecewiseSampler(**kw).sample(
        assign_sample.AssignResult(2, gt_inds, overlaps, np.zeros(n_pred, np.int64)), *args)
    want = jax_as.IoUNegPiecewiseSampler(**kw).sample(
        jax_as.AssignResult(2, gt_inds, overlaps, np.zeros(n_pred, np.int64)), *args)
    for key in ("pos_inds", "neg_inds", "pos_assigned_gt_inds", "iou"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    # the oracle of tests/test_inventory_extras.py:282
    assert len(got.pos_inds) <= 64 and len(got.pos_inds) + len(got.neg_inds) <= 128
    assert np.all(gt_inds[got.neg_inds] == 0) and np.all(gt_inds[got.pos_inds] > 0)
    assert np.all(overlaps[got.neg_inds] < 0.55)


def test_hungarian_assigner_matches_jax():
    rng = np.random.RandomState(4)
    P, G = 24, 5
    gt = _boxes(rng, G)
    preds = np.concatenate([gt + rng.normal(0, 0.3, gt.shape).astype(np.float32),
                            _boxes(rng, P - G)]).astype(np.float32)
    labels = rng.randint(0, 10, G).astype(np.int64)
    cls_pred = rng.randn(P, 10).astype(np.float32)
    train_cfg = {"point_cloud_range": [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0]}
    assigner = BBOX_ASSIGNERS.build({"type": "HungarianAssigner3D"})
    got = assigner.assign(preds, gt, labels, cls_pred, train_cfg)
    want = jax_as.HungarianAssigner3D().assign(preds, gt, labels, cls_pred, train_cfg)
    assert (got.gt_inds > 0).sum() == G
    _same_result(got, want)


def test_heuristic_assigner_matches_jax():
    rng = np.random.RandomState(5)
    gt = _boxes(rng, 6)
    preds = np.concatenate([gt[:4] + rng.normal(0, 0.5, (4, 7)).astype(np.float32),
                            _boxes(rng, 10)]).astype(np.float32)
    gt_labels, q_labels = rng.randint(0, 3, 6), rng.randint(0, 3, 14)
    for kw in ({}, {"gt_labels": gt_labels, "query_labels": q_labels}):
        got = assign_sample.HeuristicAssigner3D(dist_thre=10.0).assign(preds, gt, **kw)
        want = jax_as.HeuristicAssigner3D(dist_thre=10.0).assign(preds, gt, **kw)
        assert (got.gt_inds > 0).any()
        _same_result(got, want)


# ----------------------------------------------------------------------
# the coders no config names
# ----------------------------------------------------------------------

def test_delta_coder_matches_jax_and_the_torch_oracle():
    rng = np.random.RandomState(3)
    for extra in (0, 2):  # 7 dims, and with velocity as plain residuals
        a, g = _boxes(rng, 6, extra), _boxes(rng, 6, extra)
        coder = coders.DeltaXYZWLHRBBoxCoder
        deltas = coder.encode(a, g)
        _close(deltas.numpy(), jax_coders.DeltaXYZWLHRBBoxCoder.encode(a, g))
        back = coder.decode(a, deltas)
        _close(back.numpy(), jax_coders.DeltaXYZWLHRBBoxCoder.decode(a, deltas.numpy()))
        np.testing.assert_allclose(back.numpy(), g, atol=1e-4)
    # delta_xyzwhlr_bbox_coder.py:36-52, as tests/test_inventory_extras.py:149 writes it
    a, g = torch.from_numpy(_boxes(rng, 6)), torch.from_numpy(_boxes(rng, 6))
    za, zg = a[:, 2] + a[:, 5] / 2, g[:, 2] + g[:, 5] / 2
    diag = torch.sqrt(a[:, 4] ** 2 + a[:, 3] ** 2)
    ref = torch.stack([(g[:, 0] - a[:, 0]) / diag, (g[:, 1] - a[:, 1]) / diag,
                       (zg - za) / a[:, 5], torch.log(g[:, 3] / a[:, 3]),
                       torch.log(g[:, 4] / a[:, 4]), torch.log(g[:, 5] / a[:, 5]),
                       g[:, 6] - a[:, 6]], -1)
    np.testing.assert_allclose(coders.DeltaXYZWLHRBBoxCoder.encode(a, g).numpy(), ref.numpy(),
                               atol=1e-5)


def _jax_tree(d):
    return {k: jnp.asarray(v.numpy()) for k, v in d.items()}


def _torch_tree(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


MEAN_SIZES = [[2.0, 4.0, 1.5], [0.6, 0.8, 1.7], [1.0, 1.0, 1.0]]


@pytest.mark.parametrize("with_rot", [True, False])
def test_partial_bin_coder_matches_jax(with_rot):
    coder = coders.PartialBinBasedBBoxCoder(12, 3, MEAN_SIZES, with_rot=with_rot)
    jcoder = jax_coders.PartialBinBasedBBoxCoder(12, 3, MEAN_SIZES, with_rot=with_rot)
    rng = np.random.RandomState(0)
    yaw = rng.uniform(-np.pi, np.pi, (32,)).astype(np.float32)
    cls, res = coder.angle2class(torch.from_numpy(yaw))
    jcls, jres = jcoder.angle2class(jnp.asarray(yaw))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(jcls))
    _close(res.numpy(), jres)
    d = np.abs(coder.class2angle(cls, res).numpy() - yaw) % (2 * np.pi)  # round trip
    assert np.all(np.minimum(d, 2 * np.pi - d) < 1e-5)

    boxes = _boxes(rng, 4)
    boxes[:, 6] *= 0.9
    labels = np.array([0, 1, 2, 1])
    got, want = coder.encode(boxes, labels), jcoder.encode(jnp.asarray(boxes), jnp.asarray(labels))
    for g, w in zip(got, want):
        assert g.dtype == {jnp.int32: torch.int32}.get(w.dtype.type, torch.float32)
        _close(g.numpy(), w)
    center, size_cls, size_res, dir_cls, dir_res = got
    out = {"center": center[None],
           "dir_class": torch.nn.functional.one_hot(dir_cls.long(), 12)[None].float() * 10,
           "dir_res": dir_res[:, None].repeat(1, 12)[None],
           "size_class": torch.nn.functional.one_hot(size_cls.long(), 3)[None].float() * 10,
           "size_res": size_res[:, None, :].repeat(1, 3, 1)[None]}
    dec = coder.decode(out)
    _close(dec.numpy(), jcoder.decode(_jax_tree(out)))
    # tests/test_inventory_extras.py:188: the decode gives the boxes back
    dec = dec.numpy()[0]
    np.testing.assert_allclose(dec[:, :2], boxes[:, :2], atol=1e-4)
    np.testing.assert_allclose(dec[:, 2], boxes[:, 2] + boxes[:, 5] / 2, atol=1e-4)
    np.testing.assert_allclose(dec[:, 3:6], boxes[:, 3:6], atol=1e-4)
    if with_rot:
        dy = np.abs(dec[:, 6] - boxes[:, 6]) % (2 * np.pi)
        assert np.all(np.minimum(dy, 2 * np.pi - dy) < 1e-4)

    cls_p, reg_p = rng.randn(2, 5, 16), rng.randn(2, 3 + 24 + 3 + 9, 16)
    base = rng.randn(2, 16, 3)
    split = coder.split_pred(*(torch.from_numpy(x.astype(np.float32)) for x in (cls_p, reg_p,
                                                                                 base)))
    jsplit = jcoder.split_pred(*(jnp.asarray(x, jnp.float32) for x in (cls_p, reg_p, base)))
    assert set(split) == set(jsplit)
    for k in split:
        _close(split[k].numpy(), jsplit[k])
    _close(coder.decode(split).numpy(), jcoder.decode(jsplit))


@pytest.mark.parametrize("with_rot", [True, False])
def test_anchor_free_coder_matches_jax(with_rot):
    coder = BBOX_CODERS.build({"type": "AnchorFreeBBoxCoder", "num_dir_bins": 12,
                               "with_rot": with_rot})
    jcoder = jax_coders.AnchorFreeBBoxCoder(num_dir_bins=12, with_rot=with_rot)
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 5)
    for g, w in zip(coder.encode(boxes, None), jcoder.encode(jnp.asarray(boxes), None)):
        _close(g.numpy(), w)
    cls_p, reg_p, base = rng.randn(2, 5, 16), rng.randn(2, 6 + 24, 16), rng.randn(2, 16, 3)
    split = coder.split_pred(*(torch.from_numpy(x.astype(np.float32)) for x in (cls_p, reg_p,
                                                                                 base)))
    jsplit = jcoder.split_pred(*(jnp.asarray(x, jnp.float32) for x in (cls_p, reg_p, base)))
    assert set(split) == set(jsplit)
    for k in split:
        _close(split[k].numpy(), jsplit[k])
    dec = coder.decode(split)
    _close(dec.numpy(), jcoder.decode(jsplit))
    # tests/test_inventory_extras.py:228: shapes and the 0.1 floor on sizes
    assert dec.shape == (2, 16, 7) and bool((dec[..., 3:6] >= 0.1 - 1e-6).all())


@pytest.mark.parametrize("agnostic", [True, False])
def test_groupfree_coder_matches_jax(agnostic):
    sizes = [[2, 4, 1.5]] * 3
    coder = coders.GroupFree3DBBoxCoder(12, 3, sizes, size_cls_agnostic=agnostic)
    jcoder = jax_coders.GroupFree3DBBoxCoder(12, 3, sizes, size_cls_agnostic=agnostic)
    rng = np.random.RandomState(2)
    boxes, labels = _boxes(rng, 4), np.array([0, 2, 1, 1])
    for g, w in zip(coder.encode(boxes, labels), jcoder.encode(jnp.asarray(boxes),
                                                               jnp.asarray(labels))):
        _close(g.numpy(), w)
    R = 3 + 24 + (3 if agnostic else 3 + 9)
    cls_p, reg_p, base = rng.randn(2, 5, 16), rng.randn(2, R, 16), rng.randn(2, 16, 3)
    split = coder.split_pred(*(torch.from_numpy(x.astype(np.float32)) for x in (cls_p, reg_p,
                                                                                 base)), "p.")
    jsplit = jcoder.split_pred(*(jnp.asarray(x, jnp.float32) for x in (cls_p, reg_p, base)),
                               prefix="p.")
    assert set(split) == set(jsplit)
    for k in split:
        _close(split[k].numpy(), jsplit[k])
    dec = coder.decode(split, prefix="p.")
    assert dec.shape == (2, 16, 7)
    _close(dec.numpy(), jcoder.decode(jsplit, prefix="p."))


def test_nms_free_coder_matches_jax():
    rng = np.random.RandomState(2)
    boxes = np.concatenate([rng.uniform(-40, 40, (8, 3)), rng.uniform(1, 4, (8, 3)),
                            rng.uniform(-np.pi, np.pi, (8, 1)), rng.randn(8, 2)],
                           -1).astype(np.float32)
    norm = coders.normalize_bbox(boxes)
    _close(norm.numpy(), jax_coders.normalize_bbox(jnp.asarray(boxes)))
    back = coders.denormalize_bbox(norm)
    _close(back.numpy(), jax_coders.denormalize_bbox(jnp.asarray(norm.numpy())))
    np.testing.assert_allclose(back.numpy()[:, :6], boxes[:, :6], atol=1e-4)  # :250
    np.testing.assert_allclose(back.numpy()[:, 7:], boxes[:, 7:], atol=1e-5)
    kw = dict(pc_range=[-50, -50, -5, 50, 50, 3], post_center_range=[-30, -30, -10, 30, 30, 10],
              max_num=6, num_classes=4, score_threshold=0.2)
    cls = rng.randn(2, 1, 20, 4).astype(np.float32)
    reg = np.asarray(norm)[rng.randint(0, 8, (2, 1, 20))]
    got = BBOX_CODERS.build(dict(kw, type="NMSFreeCoder")).decode(
        {"all_cls_scores": torch.from_numpy(cls), "all_bbox_preds": torch.from_numpy(reg)})
    want = jax_coders.NMSFreeCoder(**kw).decode(
        {"all_cls_scores": jnp.asarray(cls), "all_bbox_preds": jnp.asarray(reg)})
    assert len(got) == 1
    for k in ("labels", "mask"):
        np.testing.assert_array_equal(got[0][k].numpy(), np.asarray(want[0][k]))
    for k in ("bboxes", "scores"):
        _close(got[0][k].numpy(), want[0][k])
    assert got[0]["bboxes"].shape == (6, 9) and not bool(got[0]["mask"].all())
    assert bool((got[0]["scores"][1:] <= got[0]["scores"][:-1]).all())


def test_registries_hold_the_jax_names():
    assert set(BBOX_CODERS._registry) == {
        "TransFusionBBoxCoder", "CenterPointBBoxCoder", "DeltaXYZWLHRBBoxCoder",
        "PartialBinBasedBBoxCoder", "AnchorFreeBBoxCoder", "GroupFree3DBBoxCoder",
        "NMSFreeCoder"}
    assert {"HungarianAssigner3D", "HeuristicAssigner3D"} <= set(BBOX_ASSIGNERS._registry)
    assert set(assign_sample.IOU_CALCULATORS._registry) == set(jax_as.IOU_CALCULATORS.keys())
    assert set(assign_sample.SAMPLERS._registry) == set(jax_as.SAMPLERS.keys())
    assert set(anchors.ANCHOR_GENERATORS._registry) == set(jax_anchors.ANCHOR_GENERATORS.keys())
