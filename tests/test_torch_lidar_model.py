"""Port parity of the whole LiDAR slice (voxelize -> SparseEncoder -> SECOND
-> SECONDFPN -> TransFusion head -> get_bboxes) and of the synthetic scan.

The tiny LiDAR-only model of tests/test_bevfusion_model.py runs in both
packages with the same random weights (JAX variables carried across by
the bridge). fp32; the heatmap logits agree to 2.5e-3 relative (the
encoder's bound), and boxes agree where the ranked scores are not tied.
"""
import jax
import numpy as np
import pytest
import torch

from bevfusion_tpu.runtime.flagship import synthetic_lidar_scan as jax_scan
from bevfusion_tpu_torch.config import load_config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from bevfusion_tpu_torch.runtime.flagship import LIDAR_SLICE_CONFIG, synthetic_lidar_scan
from tests.torch_port_helpers import rel_err, tiny_lidar_model

torch.set_num_threads(2)


def _preds_and_boxes(model, batch):
    """The JAX model's raw head predictions and its eval boxes."""
    x = model.extract_lidar_features(batch, False)
    x = model.decoder_neck(model.decoder_backbone(x, training=False), training=False)
    head = model.head_modules["object"]
    preds = head(x[0], training=False)
    return preds, head.get_bboxes(preds)


def test_lidar_slice_matches_jax():
    cfg, jm, batch, variables = tiny_lidar_model()
    want, want_boxes = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: jm.apply(v, b, method=_preds_and_boxes))(variables, batch))

    model = build_model(cfg)
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    with torch.no_grad():
        got = model.predict(tbatch)
        got_boxes = model(tbatch)["boxes"]

    heat = np.asarray(want["dense_heatmap"]).transpose(0, 3, 1, 2)
    assert np.std(heat) > 0.1  # a real heatmap, not a bias plateau
    assert rel_err(got["dense_heatmap"].numpy(), heat) <= 2.5e-3

    # boxes of ranked queries whose score is apart from its neighbours'
    s = want_boxes["scores"][0]
    gaps = np.abs(s[:, None] - s[None, :]) + np.eye(len(s))
    apart = gaps.min(1) > 1e-3
    assert apart.sum() >= len(s) // 2
    np.testing.assert_array_equal(got_boxes["labels"][0].numpy()[apart],
                                  want_boxes["labels"][0][apart])
    for key in ("bboxes", "scores"):
        assert rel_err(got_boxes[key][0].numpy()[apart], want_boxes[key][0][apart]) <= 2.5e-3


@pytest.mark.parametrize("num_points,seed", [(120000, 0), (5000, 3)])
def test_synthetic_scan_is_byte_equal(num_points, seed):
    pcr = load_config(LIDAR_SLICE_CONFIG).point_cloud_range
    got_p, got_m = synthetic_lidar_scan(num_points, pcr, seed=seed)
    want_p, want_m = jax_scan(num_points, pcr, seed=seed)
    assert got_p.tobytes() == want_p.tobytes() and got_m.tobytes() == want_m.tobytes()
