"""Port parity of whole tiny BEV map-segmentation models against the JAX
package: camera-only (LSSTransform -> GeneralizedResNet -> LSSFPN), LiDAR-only
(SparseEncoder -> SECOND -> SECONDFPN) and fused (DepthLSS + SparseEncoder ->
ConvFuser -> SECOND -> SECONDFPN), each with the map head.

The tiny models of tests/test_bevfusion_model.py (every dropout and
drop-path rate 0) run in both packages with the same random weights (JAX
variables carried across by the bridge) on a jittered rig (no frustum point
within 1e-4 m of a cell boundary); JAX runs its fp32 in-graph pool, the port
its host LUT (and, at eval, its in-graph route too). Checked:

- eval: ``masks_bev`` and the classifier's logits before the sigmoid, max|d|
  <= 1e-4 * max(|want|, 1);
- training, against ``jax.value_and_grad`` of the summed losses with the JAX
  model built in float64 (``dtype=jnp.float64`` under ``jax.enable_x64``):
  every loss to 1e-4 relative; all gradients together to 1e-4 relative in
  norm, and each parameter's to 1e-3 (measured at most 2.4e-5 LiDAR-only,
  2.0e-5 fused, 9.8e-5 camera-only: the port's fp32 rounding through ~15
  BatchNorms in training). Gradients that are zero but for rounding (biases
  that feed a BatchNorm) are held to 1e-7 of the global norm instead. The
  reference is float64 because the JAX package's own fp32 gradients are
  2.2% (camera-only) and 5.4% (fused) off it here: flax's BatchNorm and
  LayerNorm take the variance as E[x^2] - E[x]^2, which cancels where a
  channel's mean is large against its spread (the port's, torch's, is
  two-pass);
- a decoder neck that returns one map (LSSFPN) at B = 2: every sample's
  masks equal those of the sample run alone.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu_torch.config import Config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.models.vtransforms import lss_constants
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from tests.test_bevfusion_model import make_batch, tiny_fused_config
from tests.torch_port_helpers import boundary_margin, jittered_rig, random_variables, rel_err

torch.set_num_threads(2)

RIG_SEED = 9  # a jitter whose frustum points all keep >= 1e-4 m from cell boundaries
RTOL = 1e-4
GRAD_RTOL = 1e-3  # per parameter tensor (measured at most 9.8e-5, camera-only)
ZERO_GRAD = 1e-7  # of the global gradient norm: a gradient that is zero but for rounding
KINDS = ("camera", "lidar", "fused")


def tiny_seg_config(kind):
    """The tiny model of tests/test_bevfusion_model.py with the map head:
    camera-only as the camera seg config is built (LSSTransform, then a
    GeneralizedResNet + LSSFPN decoder), LiDAR-only, or fused."""
    if kind != "camera":
        return tiny_fused_config(with_camera=kind == "fused", head="map")
    cfg = tiny_fused_config(with_lidar=False, head="map")
    cam = cfg["encoders"]["camera"]
    cam["vtransform"] = dict(cam["vtransform"], type="LSSTransform")
    cfg["decoder"] = {  # the 16 x 16 BEV map -> 8, 4, 4 -> back to 16 x 16
        "backbone": {"type": "GeneralizedResNet", "in_channels": 16,
                     "blocks": [[2, 16, 2], [1, 32, 2], [1, 48, 1]]},
        "neck": {"type": "LSSFPN", "in_indices": [-1, 0], "in_channels": [48, 16],
                 "out_channels": 24, "scale_factor": 2}}
    cfg["heads"]["map"]["in_channels"] = 24
    return cfg


def _batch(kind, B=1, seed=0):
    """The numpy batch of the tiny models on the jittered rig, with random
    map targets [B, 2, 16, 16]."""
    batch = {k: np.asarray(v) for k, v in make_batch(B=B, seed=seed).items()
             if not k.startswith("gt_")}
    batch.update(jittered_rig(batch, RIG_SEED))
    rng = np.random.RandomState(seed + 1)
    batch["gt_masks_bev"] = (rng.rand(B, 2, 16, 16) < 0.3).astype(np.float32)
    return batch


def _torch_batch(kind, batch):
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 1, 4, 2, 3).contiguous()  # NHWC -> [B, N, 3, H, W]
    return flagship.add_pool_lut(Config.from_dict({"model": tiny_seg_config(kind)}), tb)


def _is_logits(module, method):
    return module.name == "cls2"  # the map head's last conv: the logits


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    """(batch, variables, eval masks, eval logits, losses, total, grads) of the
    JAX model, all numpy: eval in fp32, the training losses and gradients of
    the same model and variables in float64."""
    cfg = tiny_seg_config(kind)
    batch = _batch(kind)
    if kind != "lidar":
        vt = cfg["encoders"]["camera"]["vtransform"]
        dx, bx, nx, frustum = lss_constants(vt["image_size"], vt["feature_size"], vt["xbound"],
                                            vt["ybound"], vt["zbound"], vt["dbound"])
        assert boundary_margin(frustum, dx, bx, nx, batch) > 1e-4
    eval_batch = {k: v for k, v in batch.items() if k != "gt_masks_bev"}
    jm = jax_build_model(cfg)
    variables = random_variables(jm.init, eval_batch, seed=12)

    def evaluate(v, b):
        out, inter = jm.apply(v, b, capture_intermediates=_is_logits, mutable=["intermediates"])
        return out["masks_bev"], inter["intermediates"]["head_modules_map"]["cls2"]["__call__"][0]

    masks, logits = jax.jit(evaluate)(variables, eval_batch)

    with jax.enable_x64(True):
        jm64, v64, b64 = jax_build_model(cfg, dtype=jnp.float64), _float64(variables), _float64(batch)

        def loss_fn(params):
            losses, _ = jm64.apply({"params": params, "batch_stats": v64["batch_stats"]}, b64,
                                   training=True, mutable=["batch_stats"])
            return sum(v for k, v in losses.items() if k.startswith("loss/")), losses

        (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"])
        to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
        return (batch, variables, np.asarray(masks).transpose(0, 3, 1, 2),
                np.asarray(logits).transpose(0, 3, 1, 2), to_np(losses), float(total),
                to_np(grads))


def _port_model(kind):
    _, variables, *_ = _jax_run(kind)
    model = build_model(tiny_seg_config(kind), "cpu")
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    return model


def _eval(model, tb):
    logits = []
    hook = model.heads["map"].classifier.register_forward_hook(
        lambda mod, args, out: logits.append(out))
    with torch.no_grad():
        out = model(tb)
    hook.remove()
    return out, logits[0]


@pytest.mark.parametrize("kind,route", [("camera", "lut"), ("camera", "in_graph"),
                                        ("lidar", None), ("fused", "lut"), ("fused", "in_graph")])
def test_seg_model_eval_matches_jax(kind, route):
    batch, _, want_masks, want_logits, *_ = _jax_run(kind)
    model = _port_model(kind)
    tb = _torch_batch(kind, {k: v for k, v in batch.items() if k != "gt_masks_bev"})
    if route == "in_graph":
        del tb["pool_lut"]
    out, logits = _eval(model, tb)
    assert set(out) == {"masks_bev"} and out["masks_bev"].shape == (1, 2, 16, 16)
    assert np.std(want_logits) > 0.1  # real logits, not a bias plateau
    assert rel_err(logits.numpy(), want_logits) <= RTOL
    assert rel_err(out["masks_bev"].numpy(), want_masks) <= RTOL


@functools.lru_cache(maxsize=None)
def _port_train(kind):
    batch, *_ = _jax_run(kind)
    model = _port_model(kind).train()
    losses = model(_torch_batch(kind, batch))
    total = sum(v for k, v in losses.items() if k.startswith("loss/"))
    total.backward()
    return model, {k: float(v.detach()) for k, v in losses.items()}, float(total.detach())


@pytest.mark.parametrize("kind", KINDS)
def test_seg_model_losses_match_jax(kind):
    *_, want_losses, want_total, _ = _jax_run(kind)
    _, losses, total = _port_train(kind)
    assert set(losses) == set(want_losses) == {"loss/map/drivable_area/focal",
                                               "loss/map/divider/focal"}
    for k, v in want_losses.items():
        assert abs(losses[k] - float(v)) <= RTOL * abs(float(v)), (k, losses[k], v)
    assert abs(total - want_total) <= RTOL * abs(want_total)


@pytest.mark.parametrize("kind", KINDS)
def test_seg_model_gradients_match_jax(kind):
    *_, grads = _jax_run(kind)
    model, *_ = _port_train(kind)
    want = {k: v.double() for k, v in jax_to_torch_state_dict({"params": grads}).items()}
    params = dict(model.named_parameters())
    assert set(params) <= set(want)  # the bridge adds Swin's relative_position_index buffers
    missing = [k for k, p in params.items() if p.grad is None]
    assert not missing, missing[:5]
    diff = {k: float((p.grad.double() - want[k]).norm()) for k, p in params.items()}
    norm = {k: float(want[k].norm()) for k in params}
    global_norm = float(np.sqrt(sum(n ** 2 for n in norm.values())))
    assert float(np.sqrt(sum(d ** 2 for d in diff.values()))) <= RTOL * global_norm
    zero = [k for k in params if norm[k] <= ZERO_GRAD * global_norm]
    bad = {k: diff[k] / norm[k] for k in params if k not in zero and diff[k] > GRAD_RTOL * norm[k]}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]
    assert all(diff[k] <= ZERO_GRAD * global_norm for k in zero), zero
    assert len(zero) <= 10, zero


def test_single_map_neck_keeps_the_batch():
    """LSSFPN returns one tensor, not a list: at B = 2 each sample's masks
    are those of the sample run alone (taking ``x[0]`` of the tensor would
    hand the head sample 0's channels)."""
    model = _port_model("camera")
    batch = _batch("camera", B=2, seed=4)
    out, _ = _eval(model, _torch_batch("camera", batch))
    assert out["masks_bev"].shape == (2, 2, 16, 16)
    for b in range(2):
        alone = {k: v[b:b + 1] for k, v in batch.items()}
        got, _ = _eval(model, _torch_batch("camera", alone))
        assert rel_err(out["masks_bev"][b:b + 1].numpy(), got["masks_bev"].numpy()) <= 1e-5
