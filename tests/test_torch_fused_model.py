"""Port parity of the whole fused camera+LiDAR detector, and of the
flagship's synthetic inputs.

The tiny fused model of tests/test_bevfusion_model.py runs in both
packages with the same random weights (JAX variables carried across by
the bridge) on a jittered rig (no frustum point within 1e-4 m of a cell
boundary). JAX runs its in-graph pool, which is fp32 (its LUT route
rounds ctx to bf16 even on the CPU); the port runs both of its routes,
the host LUT and the in-graph intervals. The heatmap logits agree to
2.5e-3 relative (the sparse encoder's bound, as for the LiDAR slice), and
boxes agree where the ranked scores are not tied.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from bevfusion_tpu.config import load_config as jax_load_config
from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu.runtime import flagship as jax_flagship
from bevfusion_tpu_torch.config import Config, load_config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.models.vtransforms import lss_constants
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from tests.test_bevfusion_model import make_batch, tiny_fused_config
from tests.torch_port_helpers import boundary_margin, jittered_rig, random_variables, rel_err

torch.set_num_threads(2)

RIG_SEED = 9  # a jitter whose frustum points all keep >= 1e-4 m from cell boundaries


def _preds_and_boxes(model, batch):
    """The JAX model's raw head predictions and its eval boxes."""
    feats = [model.extract_camera_features(batch, False),
             model.extract_lidar_features(batch, False)]
    x = model.fuser_module(feats, training=False)
    x = model.decoder_neck(model.decoder_backbone(x, training=False), training=False)
    head = model.head_modules["object"]
    preds = head(x[0], training=False)
    return preds, head.get_bboxes(preds)


@functools.lru_cache(maxsize=None)
def _jax_run():
    cfg = tiny_fused_config()
    batch = {k: np.asarray(v) for k, v in make_batch().items() if not k.startswith("gt_")}
    batch.update(jittered_rig(batch, RIG_SEED))
    vt = cfg["encoders"]["camera"]["vtransform"]
    dx, bx, nx, frustum = lss_constants(vt["image_size"], vt["feature_size"], vt["xbound"],
                                        vt["ybound"], vt["zbound"], vt["dbound"])
    assert boundary_margin(frustum, dx, bx, nx, batch) > 1e-4
    jm = jax_build_model(cfg)
    variables = random_variables(jm.init, batch, seed=12)
    variables["params"]["head_modules_object"]["heatmap_conv1"]["conv"]["kernel"] *= 0.2
    want, want_boxes = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: jm.apply(v, b, method=_preds_and_boxes))(variables, batch))
    return cfg, batch, variables, want, want_boxes


@pytest.mark.parametrize("route", ["lut", "in_graph"])
def test_fused_model_matches_jax(route):
    cfg, batch, variables, want, want_boxes = _jax_run()
    model = build_model(cfg, "cpu")
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tbatch["img"] = tbatch["img"].permute(0, 1, 4, 2, 3).contiguous()  # NHWC -> [B, N, 3, H, W]
    if route == "lut":
        tbatch = flagship.add_pool_lut(Config.from_dict({"model": cfg}), tbatch)
    with torch.no_grad():
        got = model.predict(tbatch)
        got_boxes = model(tbatch)["boxes"]

    heat = np.asarray(want["dense_heatmap"]).transpose(0, 3, 1, 2)
    assert np.std(heat) > 0.1  # a real heatmap, not a bias plateau
    assert rel_err(got["dense_heatmap"].numpy(), heat) <= 2.5e-3

    s = want_boxes["scores"][0]
    gaps = np.abs(s[:, None] - s[None, :]) + np.eye(len(s))
    apart = gaps.min(1) > 1e-3
    assert apart.sum() >= len(s) // 2
    np.testing.assert_array_equal(got_boxes["labels"][0].numpy()[apart],
                                  want_boxes["labels"][0][apart])
    for key in ("bboxes", "scores"):
        assert rel_err(got_boxes[key][0].numpy()[apart], want_boxes[key][0][apart]) <= 2.5e-3


@pytest.mark.parametrize("B,num_points,seed", [(1, 6000, 0), (2, 3000, 3)])
def test_synthetic_batch_is_byte_equal(B, num_points, seed):
    """synthetic_batch (with synthetic_calibration) at the flagship config:
    the same bytes as the JAX package's, ``img`` after the NHWC -> NCHW
    transpose."""
    cfg = load_config(flagship.FLAGSHIP_CONFIG)
    got = flagship.synthetic_batch(cfg, B=B, num_points=num_points, seed=seed)
    want = jax_flagship.synthetic_batch(jax_load_config(flagship.FLAGSHIP_CONFIG), B=B,
                                        num_points=num_points, seed=seed)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        if k == "img":
            v = np.ascontiguousarray(v.transpose(0, 1, 4, 2, 3))
        assert got[k].numpy().dtype == v.dtype, k
        assert got[k].numpy().tobytes() == v.tobytes(), k
    cal = flagship.synthetic_calibration(B, 6, cfg.image_size)
    want_cal = jax_flagship.synthetic_calibration(B, 6, cfg.image_size, seed)
    assert all(cal[k].tobytes() == want_cal[k].tobytes() for k in want_cal)
