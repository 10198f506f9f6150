"""Port parity of one training forward and backward of the whole fused
detector against ``jax.value_and_grad`` of the JAX model.

The tiny fused model of tests/test_bevfusion_model.py (every dropout and
drop-path rate 0, so no random draw is made) runs in both packages with the
same random weights (JAX variables carried across by the bridge) on a
jittered rig and the batch's ground-truth boxes. JAX runs ``training=True``
with ``mutable=["batch_stats", "intermediates"]``, its gather sparse engine
and its fp32 in-graph pool; the port runs both of its pool routes. Checked:

- the Hungarian assignments of both packages' predictions are equal (decode
  ties at random init would change the targets, ROADMAP Queue 3), before
  anything is compared that depends on them;
- the loss dict, to 1e-4 relative (ceiling 1e-3; measured 9.9e-6: the
  forward agrees to 2.5e-3 through the sparse encoder at worst, and the
  losses average it);
- every parameter's gradient, ``||g_port - g_jax|| <= 2e-3 ||g_jax||`` per
  tensor (ceiling 5e-3; measured 6.7e-4), and every parameter has one. The
  biases that feed a BatchNorm (and LayerNorm biases whose output feeds
  one) have gradients that are zero but for rounding: below 1e-7 of the
  global gradient norm in JAX, and the two packages' rounding differs by as
  much again. Those (at most 20 tensors) are held to
  ``||g_port - g_jax|| <= 1e-7 * ||g_jax||_global`` instead;
- the BatchNorm running statistics after the forward, to 1e-4 relative of
  max(|want|, 1) (ceiling 1e-3; measured 1.3e-5).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.core import matching as jax_matching
from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu.ops import iou3d as jax_iou3d
from bevfusion_tpu_torch.config import Config
from bevfusion_tpu_torch.core import matching
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.models.layers import set_dropout_generator
from bevfusion_tpu_torch.models.vtransforms import lss_constants
from bevfusion_tpu_torch.ops import iou3d
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from tests.test_bevfusion_model import make_batch, tiny_fused_config
from tests.torch_port_helpers import boundary_margin, jittered_rig, random_variables, rel_err

torch.set_num_threads(2)

RIG_SEED = 9  # a jitter whose frustum points all keep >= 1e-4 m from cell boundaries
LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-3
ZERO_GRAD = 1e-7  # of the global gradient norm: a gradient that is zero but for rounding
STATS_RTOL = 1e-4


def _train_outputs(model, batch):
    """The JAX model's training forward (``BEVFusion.__call__`` with
    training=True and no loss_scale) and the object head's predictions."""
    feats = [model.extract_camera_features(batch, True),
             model.extract_lidar_features(batch, True)]
    x = model.fuser_module(feats, training=True)
    x = model.decoder_neck(model.decoder_backbone(x, training=True), training=True)
    head = model.head_modules["object"]
    preds = head(x[0], training=True)
    losses = head.loss(preds, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    out = {f"stats/object/{k}" if k == "matched_ious" else f"loss/object/{k}": v
           for k, v in losses.items()}
    return out, preds


@functools.lru_cache(maxsize=None)
def _jax_run():
    cfg = tiny_fused_config()
    batch = {k: np.asarray(v) for k, v in make_batch(G=6).items()}
    batch.update(jittered_rig(batch, RIG_SEED))
    vt = cfg["encoders"]["camera"]["vtransform"]
    dx, bx, nx, frustum = lss_constants(vt["image_size"], vt["feature_size"], vt["xbound"],
                                        vt["ybound"], vt["zbound"], vt["dbound"])
    assert boundary_margin(frustum, dx, bx, nx, batch) > 1e-4
    jm = jax_build_model(cfg)
    eval_batch = {k: v for k, v in batch.items() if not k.startswith("gt_")}
    variables = random_variables(jm.init, eval_batch, seed=12)
    variables["params"]["head_modules_object"]["heatmap_conv1"]["conv"]["kernel"] *= 0.2

    def loss_fn(params):
        (losses, preds), new_vars = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, batch,
            method=_train_outputs, mutable=["batch_stats", "intermediates"])
        total = sum(v for k, v in losses.items() if k.startswith("loss/"))
        return total, (losses, preds, new_vars["batch_stats"])

    (total, (losses, preds, stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return cfg, batch, variables, float(total), to_np(losses), to_np(preds), to_np(stats), \
        to_np(grads)


def cfg_coder(cfg, package):
    """The head's box coder of one package."""
    coder_cfg = dict(cfg["heads"]["object"]["bbox_coder"])
    coder_cfg.pop("type")
    if package == "jax":
        from bevfusion_tpu.core.coders import TransFusionBBoxCoder
    else:
        from bevfusion_tpu_torch.core.coders import TransFusionBBoxCoder
    return TransFusionBBoxCoder(**coder_cfg)


def _assignments(preds, batch, cfg, coder, iou_3d, hungarian_costs, auction, xp):
    """Per sample, the head's Hungarian assignment [G] of the last decoder
    layer's proposals, recomputed from ``preds`` ([B, P, c] branches) with
    one package's functions (``xp`` its array module)."""
    train_cfg = cfg["heads"]["object"]["train_cfg"]
    P = cfg["heads"]["object"]["num_proposals"]
    pcr = train_cfg["point_cloud_range"]
    asg = train_cfg["assigner"]
    out = []
    for b in range(batch["gt_boxes"].shape[0]):
        def br(k):
            return xp.asarray(np.ascontiguousarray(np.asarray(preds[k])[b, -P:].T))[None]

        boxes = coder.decode(br("heatmap"), br("rot"), br("dim"), br("center"), br("height"),
                             br("vel"))["bboxes"][0]
        gt = xp.asarray(np.array(batch["gt_boxes"][b]))
        valid = xp.asarray(np.array(batch["gt_valid"][b]))
        iou = iou_3d(boxes[:, :7], gt[:, :7])
        p0, span = np.array(pcr[:2], np.float32), np.array(pcr[3:5], np.float32) - pcr[:2]
        p0, span = xp.asarray(p0), xp.asarray(span)
        cost = hungarian_costs(
            1 / (1 + xp.exp(-br("heatmap")[0].T)), (boxes[:, :2] - p0) / span,
            (gt[:, :2] - p0) / span, iou,
            xp.asarray(np.array(batch["gt_labels"][b])), cls_weight=asg["cls_cost"]["weight"],
            reg_weight=asg["reg_cost"]["weight"], iou_weight=asg["iou_cost"]["weight"],
            alpha=asg["cls_cost"]["alpha"], gamma=asg["cls_cost"]["gamma"])
        out.append(np.asarray(auction(cost, valid, xp.asarray(np.ones(P, bool)))))
    return np.stack(out)


@functools.lru_cache(maxsize=None)
def _port_run(route):
    cfg, batch, variables, *_ = _jax_run()
    model = build_model(cfg, "cpu")
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    model.train()
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tbatch["img"] = tbatch["img"].permute(0, 1, 4, 2, 3).contiguous()  # NHWC -> [B, N, 3, H, W]
    if route == "lut":
        tbatch = flagship.add_pool_lut(Config.from_dict({"model": cfg}), tbatch)
    captured = {}
    hook = model.heads["object"].register_forward_hook(
        lambda mod, args, out: captured.update({k: v.detach() for k, v in out.items()}))
    losses = model(tbatch)
    hook.remove()
    total = sum(v for k, v in losses.items() if k.startswith("loss/"))
    total.backward()
    preds = {k: v.numpy() for k, v in captured.items()}
    return model, {k: float(v.detach()) for k, v in losses.items()}, float(total.detach()), preds


@pytest.mark.parametrize("route", ["lut", "in_graph"])
def test_assignments_and_losses_match_jax(route):
    cfg, batch, _, want_total, want_losses, want_preds, _, _ = _jax_run()
    _, losses, total, preds = _port_run(route)
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
    assert want_losses["stats/object/matched_ious"] > 0


@pytest.mark.parametrize("route", ["lut", "in_graph"])
def test_every_gradient_matches_jax(route):
    *_, grads = _jax_run()
    model, *_ = _port_run(route)
    want = jax_to_torch_state_dict({"params": grads})
    params = dict(model.named_parameters())
    assert set(params) == {k for k in want if k in params} and len(params) > 100
    missing = [k for k, p in params.items() if p.grad is None]
    assert not missing, missing[:5]
    global_norm = np.sqrt(sum(float(np.sum(w.numpy() ** 2)) for w in want.values()))
    bad, zero = {}, []
    for k, p in params.items():
        g, w = p.grad.numpy(), want[k].numpy()
        assert g.shape == w.shape, k
        diff = float(np.linalg.norm(g - w))
        if np.linalg.norm(w) <= ZERO_GRAD * global_norm:
            zero.append(k)
            ok = diff <= ZERO_GRAD * global_norm
        else:
            ok = diff <= GRAD_RTOL * float(np.linalg.norm(w))
        if not ok:
            bad[k] = diff / float(np.linalg.norm(w))
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:8]
    assert len(zero) <= 20, zero


def test_batchnorm_running_statistics_match_jax():
    *_, stats, _ = _jax_run()
    model, *_ = _port_run("in_graph")
    want = jax_to_torch_state_dict({"batch_stats": stats})
    sd = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 40
    for k in keys:
        assert rel_err(sd[k].numpy(), want[k].numpy()) <= STATS_RTOL, k
