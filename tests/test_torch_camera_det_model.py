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
labels equal, scores and kept boxes at the same tolerance.

Training (the same weights, 16 random boxes, for ``bevdepth`` the depth
images ``GTDepth`` makes of the batch's points), against
``jax.value_and_grad`` of the summed losses with the JAX model built in
float64, as tests/test_torch_seg_model.py holds the seg models:

- the port in float64 (``model.double()`` and a float64 batch: the same
  code, its losses and depth softmax ``at_least_fp32``): every loss
  (``heatmap/task{t}``, ``bbox/task{t}``, ``loss/depth``) to 1e-4 relative,
  all gradients together to 1e-4 relative in norm, each parameter's to
  1e-3, and those that are zero but for rounding to 1e-7 of the global norm
  (measured: all gradients 2.3e-5 / 1.4e-5 / 4.7e-6 swint / resnet /
  bevdepth, each parameter's at most 3.8e-5, the losses 1.5e-5);
- the port in fp32: every loss to 1e-3 relative, every parameter with a
  finite gradient. The gradients are not held in fp32: on these tiny models
  training is ill-conditioned in fp32 (train-mode BatchNorms over 4-16
  values a channel whose mean dwarfs their spread: the camera ResNet's
  deepest map is 1 x 2 a camera), so fp32 rounding moves the gradients by
  2.3% (swint), 5.9% (resnet) and 9.5% (bevdepth) in norm from float64, and
  the JAX package's own fp32 ones by 2.3%, 7.0% and 64.5%; the losses by at
  most 8.4e-4 (the depth loss; JAX's fp32 5.4e-3).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu_torch.config import Config, load_config
from bevfusion_tpu_torch.data.transforms import GTDepth
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.models.vtransforms import lss_constants
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from tests.test_bevfusion_model import make_batch
from tests.test_torch_seg_model import _float64, tiny_seg_config
from tests.torch_port_helpers import boundary_margin, jittered_rig, random_variables, rel_err

torch.set_num_threads(2)

RIG_SEED = 9  # a jitter whose frustum points all keep >= 1e-4 m from cell boundaries
RTOL = 1e-5
TRAIN_RTOL = 1e-4  # float64: losses, and all gradients together in norm
GRAD_RTOL = 1e-3  # float64: each parameter's gradient in norm
FP32_LOSS_RTOL = 1e-3  # fp32 losses against float64 (measured at most 8.4e-4, bevdepth)
ZERO_GRAD = 1e-7  # of the global gradient norm: a gradient that is zero but for rounding
KINDS = tuple(flagship.DET_CAMERA_CONFIGS)  # swint, resnet, bevdepth


def tiny_det_config(kind):
    """The config's model tree cut to tiny widths: the camera branch of the
    tiny camera seg model (tests/test_torch_seg_model.py) or, for the ResNet
    configs, a ResNet-50 of base width 8 and a SECONDFPN to 4 x 8 channels at
    stride 16; the tiny GeneralizedResNet + LSSFPN decoder; the config's
    CenterHead on 16 x 16 cells of 2 m (its training targets on the same
    grid), 24 boxes a task, 10 kept a task."""
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
    head["train_cfg"] = dict(head["train_cfg"], grid_size=[128, 128, 1],
                             point_cloud_range=[-16.0, -16.0, -5.0, 16.0, 16.0, 3.0],
                             voxel_size=[0.25, 0.25, 0.2])
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


def train_batch(batch):
    """The numpy eval batch with 16 random boxes (tests/test_bevfusion_model.py's)
    and the depth images of its points (every point: its fifth column is
    no time lag)."""
    batch = dict(batch, **{k: np.asarray(v) for k, v in make_batch(G=16).items()
                           if k.startswith("gt_")})
    depths = [GTDepth()({"points": batch["points"][b][batch["points_mask"][b]],
                         "img": list(batch["img"][b]),
                         **{k: batch[k][b] for k in ("lidar2image", "img_aug_matrix",
                                                     "lidar_aug_matrix")}})["depths"]
              for b in range(len(batch["img"]))]
    return dict(batch, depths=np.stack(depths))


def jax_value_and_grad(cfg, variables, batch, jit=True):
    """(losses, total, gradients), numpy, of the JAX model built in float64
    on float64 copies of ``variables`` and ``batch``, training mode."""
    with jax.enable_x64(True):
        jm64, v64, b64 = jax_build_model(cfg, dtype=jnp.float64), _float64(variables), \
            _float64(batch)

        def loss_fn(params):
            losses, _ = jm64.apply({"params": params, "batch_stats": v64["batch_stats"]}, b64,
                                   training=True, mutable=["batch_stats"])
            return sum(v for k, v in losses.items() if k.startswith("loss/")), losses

        fn = jax.value_and_grad(loss_fn, has_aux=True)
        (total, losses), grads = (jax.jit(fn) if jit else fn)(v64["params"])
        to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
        return to_np(losses), float(total), to_np(grads)


def port_value_and_grad(cfg, variables, batch, dtype=torch.float32):
    """(model, losses, total) of the port's training forward + backward on the
    same weights and batch, the model and the batch's floats in ``dtype``."""
    model = build_model(cfg, "cpu")
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    model.to(dtype).train()
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tb = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tb.items()}
    tb["img"] = tb["img"].permute(0, 1, 4, 2, 3).contiguous()  # NHWC -> [B, N, 3, H, W]
    losses = model(flagship.add_pool_lut(Config.from_dict({"model": cfg}), tb))
    total = sum(v for k, v in losses.items() if k.startswith("loss/"))
    total.backward()
    return model, {k: float(v.detach()) for k, v in losses.items()}, float(total.detach())


def assert_training_matches(cfg, variables, batch, want):
    """The port's training in float64 and in fp32 against the JAX (losses,
    total, gradients): the tolerances of the module docstring."""
    want_losses, want_total, grads = want
    model, losses, total = port_value_and_grad(cfg, variables, batch, torch.float64)
    assert set(losses) == set(want_losses)
    for k, v in want_losses.items():
        assert abs(losses[k] - float(v)) <= TRAIN_RTOL * abs(float(v)), (k, losses[k], v)
    assert abs(total - want_total) <= TRAIN_RTOL * abs(want_total)
    ref = {k: v.double() for k, v in jax_to_torch_state_dict({"params": grads}).items()}
    params = dict(model.named_parameters())
    assert set(params) <= set(ref)  # the bridge adds Swin's relative_position_index buffers
    missing = [k for k, p in params.items() if p.grad is None]
    assert not missing, missing[:5]
    diff = {k: float((p.grad - ref[k]).norm()) for k, p in params.items()}
    norm = {k: float(ref[k].norm()) for k in params}
    global_norm = float(np.sqrt(sum(n ** 2 for n in norm.values())))
    assert float(np.sqrt(sum(d ** 2 for d in diff.values()))) <= TRAIN_RTOL * global_norm
    zero = [k for k in params if norm[k] <= ZERO_GRAD * global_norm]
    bad = {k: diff[k] / norm[k] for k in params if k not in zero and diff[k] > GRAD_RTOL * norm[k]}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]
    assert all(diff[k] <= ZERO_GRAD * global_norm for k in zero), zero

    model, losses, total = port_value_and_grad(cfg, variables, batch)
    for k, v in want_losses.items():
        assert abs(losses[k] - float(v)) <= FP32_LOSS_RTOL * abs(float(v)), (k, losses[k], v)
    grads32 = {k: p.grad for k, p in model.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all() for g in grads32.values())


@pytest.mark.parametrize("kind", KINDS)
def test_camera_det_model_training_matches_jax(kind):
    batch, variables, *_ = _jax_run(kind)
    cfg, batch = tiny_det_config(kind), train_batch(batch)
    want = jax_value_and_grad(cfg, variables, batch)
    keys = {f"loss/object/{t}/task{i}" for t in ("heatmap", "bbox") for i in range(6)}
    assert set(want[0]) == keys | ({"loss/depth"} if kind == "bevdepth" else set())
    assert sum(float(want[0][f"loss/object/bbox/task{i}"]) > 0 for i in range(6)) >= 4
    assert_training_matches(cfg, variables, batch, want)


def precision_gaps(cfg, variables, batch, want, jit=True):
    """How far the training of a tiny model moves from the JAX model's float64
    (``want``: losses, total, gradients) in each precision: the port in
    float64 and in fp32 and the JAX package's own fp32, as (the largest
    relative loss gap, all gradients' gap relative in norm)."""
    want_losses, _, grads = want
    ref = {k: v.double() for k, v in jax_to_torch_state_dict({"params": grads}).items()}

    def gaps(losses, got):
        global_norm = np.sqrt(sum(float(ref[k].norm()) ** 2 for k in got))
        diff = np.sqrt(sum(float((g.double() - ref[k]).norm()) ** 2 for k, g in got.items()))
        return (max(abs(float(losses[k]) - float(v)) / abs(float(v)) for k, v in
                    want_losses.items()), float(diff / global_norm))

    out = {}
    for dtype in (torch.float64, torch.float32):
        model, losses, _ = port_value_and_grad(cfg, variables, batch, dtype)
        out[f"port {dtype}"] = gaps(losses, {k: p.grad for k, p in model.named_parameters()})
    jm = jax_build_model(cfg)

    def loss_fn(params):
        losses, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, batch,
                             training=True, mutable=["batch_stats"])
        return sum(v for k, v in losses.items() if k.startswith("loss/")), losses

    fn = jax.value_and_grad(loss_fn, has_aux=True)
    (_, losses), jgrads = (jax.jit(fn) if jit else fn)(variables["params"])
    params = {k for k, _ in port_value_and_grad(cfg, variables, batch)[0].named_parameters()}
    got = {k: v for k, v in jax_to_torch_state_dict({"params": jgrads}).items() if k in params}
    out["jax fp32"] = gaps(losses, got)
    return out


if __name__ == "__main__":
    # python -m tests.test_torch_camera_det_model: the precision report behind
    # the module docstring's numbers (a few minutes on a CPU)
    from tests.test_torch_radar_model import _jax_run as radar_run, tiny_radar_config

    for kind in KINDS:
        batch, variables, *_ = _jax_run(kind)
        cfg, batch = tiny_det_config(kind), train_batch(batch)
        print(kind, precision_gaps(cfg, variables, batch, jax_value_and_grad(cfg, variables, batch)))
    variables, runs = radar_run()
    cfg, batch = tiny_radar_config(), train_batch(runs[0][0])
    print("camera+radar", precision_gaps(cfg, variables, batch,
                                         jax_value_and_grad(cfg, variables, batch, jit=False),
                                         jit=False))
