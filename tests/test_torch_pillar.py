"""Port parity of the PointPillars path against the JAX package: the
unreduced voxel table (``ops/voxelize.py``, ``reduce=None``),
``PillarFeatureNet``, ``PointPillarsScatter`` and ``PointPillarsEncoder``
(``models/pillar_encoder.py``), and a tiny PointPillars TransFusion model
(the tiny LiDAR model of tests/test_bevfusion_model.py with its sparse
encoder replaced by the pillar encoder at 2 m on a 16 x 16 grid).

Inputs are clustered points made from numpy seeds, with points out of range,
masked points, pillars past the per-pillar cap and more pillars than the
voxel cap; weights are the JAX package's random variables carried across by
the bridge (``runtime/bridge.py``). Held:

- the table, its coords, counts and mask bit for bit;
- the modules at max|d| <= 1e-5 * max(|want|, 1) (fp32, the same operations
  in another order); the scatter's canvas bit for bit;
- the tiny model's eval heatmap at 1e-5 and its decoded boxes (labels equal,
  boxes and scores at 1e-5);
- its training forward against ``jax.value_and_grad`` of the JAX model built
  in float64 (as tests/test_torch_seg_model.py does: flax's fast variance,
  ROADMAP Queue 3), taken eagerly: the jitted gradient of the JAX pillar net
  in training mode is wrong on XLA's CPU backend (pinned below). Held: the
  Hungarian assignments equal, every loss to 1e-4 relative, all gradients
  together to 1e-4 relative in norm and each parameter's to 1e-3 (measured
  at most 3.5e-5, the first PFN layer's Linear), gradients that are zero
  but for rounding (biases that feed a BatchNorm) to 1e-7 of the global
  norm. The BN1d batch statistics take every (pillar, point) row, padded
  ones included, in both packages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.core import matching as jax_matching
from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu.models import pillar_encoder as jax_pillar
from bevfusion_tpu.ops import iou3d as jax_iou3d
from bevfusion_tpu.ops import voxelize as jvox
from bevfusion_tpu_torch.core import matching
from bevfusion_tpu_torch.models import build_model, pillar_encoder
from bevfusion_tpu_torch.ops import iou3d
from bevfusion_tpu_torch.ops import voxelize as tvox
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from tests.test_bevfusion_model import make_batch, tiny_fused_config
from tests.test_torch_train_grad import _assignments, cfg_coder
from tests.torch_port_helpers import load_bridged, random_variables, rel_err

torch.set_num_threads(2)

RTOL = 1e-5
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3  # per parameter tensor
ZERO_GRAD = 1e-7  # of the global gradient norm: a gradient that is zero but for rounding
PCR = [-16.0, -16.0, -4.0, 16.0, 16.0, 4.0]
VS = [2.0, 2.0, 8.0]  # 16 x 16 pillars
PFN = {"type": "PillarFeatureNet", "in_channels": 5, "feat_channels": [16, 16],
       "with_distance": False, "point_cloud_range": PCR, "voxel_size": VS,
       "norm_cfg": {"type": "BN1d", "eps": 1e-3, "momentum": 0.01}}
SCATTER = {"type": "PointPillarsScatter", "in_channels": 16, "output_shape": [16, 16]}


def _t(a):
    return torch.from_numpy(np.array(a))


def _points(seed, n=1024):
    """Clustered points (several to a pillar, some past the cap of 6), 40
    out of range and ~5% masked off: [n, 5], mask [n]."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-13, 13, (60, 2))
    xy = centres[rng.randint(0, 60, n)] + rng.normal(0, 1.2, (n, 2))
    pts = np.concatenate([xy, rng.uniform(-3, 3, (n, 1)), rng.rand(n, 2)], 1).astype(np.float32)
    pts[:40, 0] += 40.0
    return pts, rng.rand(n) > 0.05


def _table(seed, max_points=6, max_voxels=96):
    pts, mask = _points(seed)
    return jvox.voxelize(jnp.asarray(pts), jnp.asarray(mask), VS, PCR, max_points, max_voxels,
                         reduce=None)


@pytest.mark.parametrize("max_points,max_voxels", [
    (6, 256),    # per-pillar cap binds, every pillar kept
    (6, 96),     # more pillars than the cap
    (1024, 64),  # every point of a pillar (dynamic), heavy overflow
])
def test_unreduced_voxel_table_is_bit_equal_to_jax(max_points, max_voxels):
    pts, mask = _points(max_points + max_voxels)
    want = jvox.voxelize(jnp.asarray(pts), jnp.asarray(mask), VS, PCR, max_points, max_voxels,
                         reduce=None)
    got = tvox.voxelize(_t(pts), _t(mask), VS, PCR, max_points, max_voxels, reduce=None)
    assert got.feats.shape == (max_voxels, max_points, 5)
    occupied = int(np.asarray(want.mask).sum())
    if max_voxels < 200:
        assert occupied == max_voxels  # the overflow case really overflows
    assert max_points > 100 or int(np.asarray(want.num_points).max()) == max_points
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_voxelization_table_batch_matches_jax():
    pts, mask = zip(*(_points(s) for s in (1, 2)))
    pts, mask = np.stack(pts), np.stack(mask)
    vox = tvox.Voxelization(VS, PCR, max_num_points=6, max_voxels=(50, 96), reduce=None)
    out = vox(_t(pts), _t(mask))
    feats, coords4, sizes, vmask = jvox.Voxelization(VS, PCR, 6, (50, 96), reduce=None)(
        jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(out.feats.reshape(-1, 6, 5).numpy(), np.asarray(feats))
    np.testing.assert_array_equal(out.coords.reshape(-1, 3).numpy(), np.asarray(coords4)[:, 1:])
    np.testing.assert_array_equal(out.num_points.reshape(-1).numpy(), np.asarray(sizes))
    np.testing.assert_array_equal(out.mask.reshape(-1).numpy(), np.asarray(vmask))
    assert vox(_t(pts), _t(mask), training=True).feats.shape == (2, 50, 6, 5)


@pytest.mark.parametrize("with_distance", [False, True])
def test_pillar_feature_net_matches_jax(with_distance):
    table = _table(3)
    cfg = dict(PFN, with_distance=with_distance)
    jm = jax_pillar.PillarFeatureNet(**{k: v for k, v in cfg.items() if k != "type"})
    args = (table.feats, table.num_points, table.coords)
    variables = random_variables(jm.init, *args, seed=5)
    want = np.asarray(jax.jit(jm.apply)(variables, *args))
    net = pillar_encoder.PillarFeatureNet(**{k: v for k, v in cfg.items() if k != "type"})
    # the first Linear's width is the reference's rule; the flax Dense infers it
    assert net.pfn_layers[0].linear.in_features == 5 + 5 + with_distance == \
        variables["params"]["pfn0"]["linear"]["kernel"].shape[0]
    load_bridged(net, variables, "lidar_backbone/PillarFeatureNet_0",
                 "encoders.lidar.backbone.pts_voxel_encoder.")
    with torch.no_grad():
        got = net(*(_t(np.asarray(a)) for a in args))
    assert got.shape == (96, 16) and np.abs(want).max() > 0.1
    assert rel_err(got.numpy(), want) <= RTOL
    # padded pillars give the last layer's empty max, 0, in both packages
    assert np.all(want[~np.asarray(table.mask)] == 0)


def test_pillar_max_of_an_empty_pillar_is_zero():
    y = torch.tensor([[[1.0, -2.0], [3.0, 4.0]], [[5.0, 6.0], [7.0, 8.0]]])
    pm = torch.tensor([[True, False], [False, False]])
    np.testing.assert_array_equal(pillar_encoder.masked_max(y, pm).numpy(),
                                  [[[1.0, -2.0]], [[0.0, 0.0]]])


def test_pillar_scatter_is_bit_equal_to_jax():
    table = _table(4)
    rng = np.random.RandomState(6)
    feats = rng.randn(96, 16).astype(np.float32)
    want = np.asarray(jax_pillar.PointPillarsScatter(16, (16, 16)).apply(
        {}, jnp.asarray(feats), table.coords, table.mask))
    got = pillar_encoder.PointPillarsScatter(16, (16, 16))(
        _t(feats), _t(np.asarray(table.coords)), _t(np.asarray(table.mask)))
    assert got.shape == (16, 16, 16) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want.transpose(2, 0, 1))  # [X, Y, C] -> [C, X, Y]
    assert (got.abs().sum(0) > 0).sum() == int(np.asarray(table.mask).sum())


def test_pointpillars_encoder_matches_jax():
    tables = [_table(s) for s in (7, 8)]
    args = tuple(jnp.stack([getattr(t, k) for t in tables])
                 for k in ("feats", "coords", "mask", "num_points"))
    jm = jax_pillar.PointPillarsEncoder(pts_voxel_encoder=PFN, pts_middle_encoder=SCATTER)
    variables = random_variables(jm.init, *args, seed=9)
    want = np.asarray(jax.jit(jm.apply)(variables, *args)).transpose(0, 3, 1, 2)
    enc = pillar_encoder.PointPillarsEncoder(pts_voxel_encoder=PFN, pts_middle_encoder=SCATTER)
    load_bridged(enc, variables, "lidar_backbone", "encoders.lidar.backbone.")
    with torch.no_grad():
        got = enc(*(_t(np.asarray(a)) for a in args))
    assert got.shape == (2, 16, 16, 16) and np.abs(want).max() > 0.1
    assert rel_err(got.numpy(), want) <= RTOL


# -- the tiny PointPillars TransFusion model ---------------------------------

def tiny_pillar_config():
    """The tiny LiDAR-only TransFusion detector with the pillar path:
    ``voxelize_reduce: false``, at most 6 points a pillar and 96 pillars,
    then PillarFeatureNet (16, 16) and the scatter to 16 x 16."""
    cfg = tiny_fused_config(with_camera=False)
    cfg["encoders"]["lidar"] = {
        "voxelize_reduce": False,
        "voxelize": {"max_num_points": 6, "point_cloud_range": PCR, "voxel_size": VS,
                     "max_voxels": [96, 96]},
        "backbone": {"type": "PointPillarsEncoder", "pts_voxel_encoder": PFN,
                     "pts_middle_encoder": SCATTER}}
    return cfg


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


def _preds_and_boxes(model, batch):
    x = model.extract_lidar_features(batch, False)
    x = model.decoder_neck(model.decoder_backbone(x, training=False), training=False)
    head = model.head_modules["object"]
    preds = head(x[0], training=False)
    return preds, head.get_bboxes(preds)


def _train_outputs(model, batch):
    x = model.extract_lidar_features(batch, True)
    x = model.decoder_neck(model.decoder_backbone(x, training=True), training=True)
    head = model.head_modules["object"]
    preds = head(x[0], training=True)
    losses = head.loss(preds, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    out = {f"stats/object/{k}" if k == "matched_ious" else f"loss/object/{k}": v
           for k, v in losses.items()}
    return out, preds


@functools.lru_cache(maxsize=None)
def _jax_run():
    """(batch, variables, eval preds, eval boxes, losses, total, train preds,
    grads), all numpy: eval in fp32, training in float64."""
    cfg = tiny_pillar_config()
    pts, mask = _points(10)
    batch = {k: np.asarray(v) for k, v in make_batch(G=6).items()
             if k.startswith("gt_")}
    batch.update(points=pts[None], points_mask=mask[None])
    eval_batch = {k: v for k, v in batch.items() if not k.startswith("gt_")}
    jm = jax_build_model(cfg)
    variables = random_variables(jm.init, eval_batch, seed=13)
    variables["params"]["head_modules_object"]["heatmap_conv1"]["conv"]["kernel"] *= 0.2
    preds, boxes = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: jm.apply(v, b, method=_preds_and_boxes))(variables, eval_batch))

    with jax.enable_x64(True):
        jm64, v64, b64 = jax_build_model(cfg, dtype=jnp.float64), _float64(variables), \
            _float64(batch)

        def loss_fn(params):
            (losses, tpreds), _ = jm64.apply(
                {"params": params, "batch_stats": v64["batch_stats"]}, b64,
                method=_train_outputs, mutable=["batch_stats", "intermediates"])
            return sum(v for k, v in losses.items() if k.startswith("loss/")), (losses, tpreds)

        # eager: XLA's jitted gradient of this masked max after a training-mode
        # BatchNorm is wrong (ROADMAP Queue 3; test_jitted_gradient_fault_is_pinned)
        (total, (losses, tpreds)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v64["params"])
        to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
        return (cfg, batch, variables, preds, boxes, to_np(losses), float(total), to_np(tpreds),
                to_np(grads))


def _port_model():
    cfg, _, variables, *_ = _jax_run()
    model = build_model(cfg, "cpu")
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    return model


def test_pointpillars_model_builds_the_pillar_path():
    model = _port_model()
    assert model.lidar_voxelize.reduce is None
    assert type(model.encoders["lidar"]["backbone"]).__name__ == "PointPillarsEncoder"


def test_pointpillars_model_heatmap_and_boxes_match_jax():
    _, batch, _, want, want_boxes, *_ = _jax_run()
    model = _port_model()
    tb = {k: _t(v) for k, v in batch.items() if k.startswith("points")}
    with torch.no_grad():
        got = model.predict(tb)
        got_boxes = model(tb)["boxes"]
    heat = want["dense_heatmap"].transpose(0, 3, 1, 2)
    assert np.std(heat) > 0.1  # a real heatmap, not a bias plateau
    assert rel_err(got["dense_heatmap"].numpy(), heat) <= RTOL
    np.testing.assert_array_equal(got_boxes["labels"].numpy(), want_boxes["labels"])
    for key in ("bboxes", "scores"):
        assert rel_err(got_boxes[key].numpy(), want_boxes[key]) <= RTOL, key
    assert np.isfinite(want_boxes["bboxes"]).all()


@functools.lru_cache(maxsize=None)
def _port_train():
    _, batch, *_ = _jax_run()
    model = _port_model().train()
    captured = {}
    hook = model.heads["object"].register_forward_hook(
        lambda mod, args, out: captured.update({k: v.detach() for k, v in out.items()}))
    losses = model({k: _t(v) for k, v in batch.items()})
    hook.remove()
    total = sum(v for k, v in losses.items() if k.startswith("loss/"))
    total.backward()
    return model, {k: float(v.detach()) for k, v in losses.items()}, float(total.detach()), \
        {k: v.numpy() for k, v in captured.items()}


def test_pointpillars_model_losses_match_jax_float64():
    cfg, batch, _, _, _, want_losses, want_total, want_preds, _ = _jax_run()
    _, losses, total, preds = _port_train()
    want_asg = _assignments(want_preds, batch, cfg, cfg_coder(cfg, "jax"), jax_iou3d.iou_3d,
                            jax_matching.hungarian_costs, jax_matching.auction_assignment, jnp)
    got_asg = _assignments(preds, batch, cfg, cfg_coder(cfg, "torch"), iou3d.iou_3d,
                           matching.hungarian_costs, matching.auction_assignment, torch)
    np.testing.assert_array_equal(got_asg, want_asg)
    assert (want_asg >= 0).sum() >= 3  # real matches
    assert set(losses) == set(want_losses)
    for k, v in want_losses.items():
        assert abs(losses[k] - float(v)) <= LOSS_RTOL * max(abs(float(v)), 1e-6), (k, losses[k], v)
    assert abs(total - want_total) <= LOSS_RTOL * abs(want_total)


def test_pointpillars_model_gradients_match_jax_float64():
    *_, grads = _jax_run()
    model, *_ = _port_train()
    want = {k: v.double() for k, v in jax_to_torch_state_dict({"params": grads}).items()}
    params = dict(model.named_parameters())
    assert set(params) == set(want)
    assert {k for k in params if "pfn_layers" in k} == {
        f"encoders.lidar.backbone.pts_voxel_encoder.pfn_layers.{i}.{n}"
        for i in (0, 1) for n in ("linear.weight", "norm.weight", "norm.bias")}
    missing = [k for k, p in params.items() if p.grad is None]
    assert not missing, missing[:5]
    diff = {k: float((p.grad.double() - want[k]).norm()) for k, p in params.items()}
    norm = {k: float(want[k].norm()) for k in params}
    global_norm = float(np.sqrt(sum(n ** 2 for n in norm.values())))
    assert float(np.sqrt(sum(d ** 2 for d in diff.values()))) <= LOSS_RTOL * global_norm
    zero = [k for k in params if norm[k] <= ZERO_GRAD * global_norm]
    bad = {k: diff[k] / norm[k] for k in params if k not in zero and diff[k] > GRAD_RTOL * norm[k]}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]
    assert all(diff[k] <= ZERO_GRAD * global_norm for k in zero), zero
    assert not any("pfn_layers" in k for k in zero) and len(zero) <= 10, zero


def test_jitted_gradient_fault_is_pinned():
    """Why the float64 reference above is eager: on XLA's CPU backend the
    jitted gradient of the JAX ``PillarFeatureNet`` in training mode (a
    masked max after a training-mode BatchNorm) is tens of percent off its
    eager gradient, which equals finite differences and the port's
    (ROADMAP Queue 3). If this starts failing, the fault is fixed and the
    reference may be jitted again."""
    table = _table(3)
    cfg = {k: v for k, v in PFN.items() if k != "type"}
    jm = jax_pillar.PillarFeatureNet(**cfg)
    args = (table.feats, table.num_points, table.coords)
    variables = random_variables(jm.init, *args, seed=5)
    g = np.random.RandomState(0).randn(96, 16).astype(np.float32)

    def loss(params):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, *args,
                          True, mutable=["batch_stats"])
        return (out * g).sum()

    eager = jax.grad(loss)(variables["params"])
    jitted = jax.jit(jax.grad(loss))(variables["params"])
    net = pillar_encoder.PillarFeatureNet(**cfg)
    load_bridged(net, variables, "lidar_backbone/PillarFeatureNet_0",
                 "encoders.lidar.backbone.pts_voxel_encoder.").train()
    (net(*(_t(np.asarray(a)) for a in args)) * _t(g)).sum().backward()
    for i, layer in enumerate(net.pfn_layers):
        want = np.asarray(eager[f"pfn{i}"]["linear"]["kernel"]).T
        assert rel_err(layer.linear.weight.grad.numpy(), want) <= RTOL
        assert rel_err(np.asarray(jitted[f"pfn{i}"]["linear"]["kernel"]).T, want) > 0.05
