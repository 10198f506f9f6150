"""Port parity of the TransFusion training targets and losses against the
JAX package: the losses (focal, gaussian focal, L1 with their
weight / avg_factor reductions), the gaussian heatmap targets, the rotated
3D IoU, the Hungarian cost with the auction matcher, and the box encoder.
The same numpy inputs go to both; fp32, so max|d| <= 1e-5 * max(|want|, 1)
(exact equality for integer results and assignments).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.core import coders as jax_coders
from bevfusion_tpu.core import matching as jax_matching
from bevfusion_tpu.models import losses as jax_losses
from bevfusion_tpu.ops import gaussian as jax_gaussian
from bevfusion_tpu.ops import iou3d as jax_iou3d
from bevfusion_tpu_torch.core import matching
from bevfusion_tpu_torch.core.coders import TransFusionBBoxCoder
from bevfusion_tpu_torch.models import losses
from bevfusion_tpu_torch.ops import gaussian, iou3d

torch.set_num_threads(2)

TOL = 1e-5


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) <= TOL * max(float(np.max(np.abs(want))), 1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("weighted,avg_factor", [(False, None), (True, 7.0), (True, 0.5)])
def test_losses_match_jax(weighted, avg_factor):
    rng = np.random.RandomState(0)
    logits = (rng.randn(40, 10) * 3).astype(np.float32)
    labels = rng.randint(0, 11, 40).astype(np.int32)  # 10 = background
    w = rng.rand(40).astype(np.float32) if weighted else None
    pred = rng.rand(3, 10, 12).astype(np.float32)
    target = np.maximum(rng.rand(3, 10, 12).astype(np.float32) * 1.2 - 0.1, 0)
    target[0, 2, 3] = 1.0
    target = np.minimum(target, 1.0)
    hw = rng.rand(3, 10, 12).astype(np.float32) if weighted else None
    a, b = rng.randn(20, 10).astype(np.float32), rng.randn(20, 10).astype(np.float32)
    bw = rng.rand(20, 10).astype(np.float32) if weighted else None
    jw = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    tw = lambda x: None if x is None else _t(x)  # noqa: E731
    cases = [
        (jax_losses.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(labels), jw(w),
                                       avg_factor),
         losses.sigmoid_focal_loss(_t(logits), _t(labels), tw(w), avg_factor)),
        (jax_losses.gaussian_focal_loss(jax_losses.clip_sigmoid(jnp.asarray(pred * 8 - 4)),
                                        jnp.asarray(target), jw(hw), avg_factor),
         losses.gaussian_focal_loss(losses.clip_sigmoid(_t(pred * 8 - 4)), _t(target), tw(hw),
                                    avg_factor)),
        (jax_losses.l1_loss(jnp.asarray(a), jnp.asarray(b), jw(bw), avg_factor),
         losses.l1_loss(_t(a), _t(b), tw(bw), avg_factor)),
    ]
    for want, got in cases:
        assert _close(got.numpy(), want)


def test_gaussian_targets_match_jax():
    rng = np.random.RandomState(1)
    N, ncls, H, W = 12, 4, 30, 26
    lw = rng.uniform(0.2, 6, (2, N)).astype(np.float32)
    r_want = np.asarray(jax_gaussian.gaussian_radius((jnp.asarray(lw[0]), jnp.asarray(lw[1])),
                                                     0.1))
    r_got = gaussian.gaussian_radius((_t(lw[0]), _t(lw[1])), 0.1)
    assert _close(r_got.numpy(), r_want)
    radii = np.maximum(r_want.astype(np.int32), 2)
    centers = np.stack([rng.randint(-3, W + 3, N), rng.randint(-3, H + 3, N)], -1).astype(np.int32)
    cls = rng.randint(0, ncls, N).astype(np.int32)
    valid = rng.rand(N) > 0.2
    hm0 = np.zeros((ncls, H, W), np.float32)
    want = np.asarray(jax_gaussian.draw_heatmap_gaussians(
        jnp.asarray(hm0), jnp.asarray(centers), jnp.asarray(radii), jnp.asarray(cls),
        jnp.asarray(valid)))
    got = gaussian.draw_heatmap_gaussians(_t(hm0), _t(centers), _t(radii), _t(cls), _t(valid))
    assert (want == 1.0).sum() >= 3 and (want > 0).mean() > 0.02
    assert _close(got.numpy(), want)


def _boxes(rng, n, spread=6.0):
    """[n, 7] (x, y, z bottom, dx, dy, dz, yaw) boxes that overlap often."""
    return np.concatenate([rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1, 1, (n, 1)),
                           rng.uniform(0.5, 4, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
                          -1).astype(np.float32)


def test_iou_3d_matches_jax():
    rng = np.random.RandomState(2)
    b1, b2 = _boxes(rng, 30), _boxes(rng, 20)
    b2[:3] = b1[:3]  # identical boxes: IoU 1
    b2[3] = b1[3] + np.array([0, 0, 0, 0, 0, 0, np.pi / 2], np.float32)  # rotated copy
    want = np.asarray(jax_iou3d.iou_3d(jnp.asarray(b1), jnp.asarray(b2)))
    got = iou3d.iou_3d(_t(b1), _t(b2)).numpy()
    assert (want > 0.05).sum() > 10 and np.allclose(np.diag(want[:3, :3]), 1.0, atol=1e-5)
    assert _close(got, want)


@pytest.mark.parametrize("G,P,n_invalid", [(6, 20, 0), (12, 30, 3), (9, 9, 1)])
def test_matcher_matches_jax(G, P, n_invalid):
    """Hungarian costs of the reference's form, with clear margins (a
    planted optimal assignment), give equal auction assignments."""
    rng = np.random.RandomState(G + P)
    scores = (rng.rand(P, 10) * 0.3).astype(np.float32)
    pred_xy = rng.rand(P, 2).astype(np.float32)
    gt_xy = rng.rand(G, 2).astype(np.float32)
    truth = rng.permutation(P)[:G]
    labels = rng.randint(0, 10, G).astype(np.int32)
    pred_xy[truth] = gt_xy + rng.normal(0, 0.002, (G, 2)).astype(np.float32)
    scores[truth, labels] = 0.9
    iou = np.where(rng.rand(P, G) > 0.7, rng.rand(P, G) * 0.3, 0).astype(np.float32)
    iou[truth, np.arange(G)] = 0.9
    want_cost = np.asarray(jax_matching.hungarian_costs(
        jnp.asarray(scores), jnp.asarray(pred_xy), jnp.asarray(gt_xy), jnp.asarray(iou),
        jnp.asarray(labels)))
    cost = matching.hungarian_costs(_t(scores), _t(pred_xy), _t(gt_xy), _t(iou), _t(labels))
    assert _close(cost.numpy(), want_cost)
    row_valid = np.ones(G, bool)
    row_valid[:n_invalid] = False
    col_valid = np.ones(P, bool)
    want = np.asarray(jax_matching.auction_assignment(jnp.asarray(want_cost),
                                                      jnp.asarray(row_valid),
                                                      jnp.asarray(col_valid)))
    got = matching.auction_assignment(_t(want_cost), _t(row_valid), _t(col_valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[row_valid] == truth[row_valid]).all()  # the planted optimum
    assert (want[~row_valid] == -1).all()


@pytest.mark.parametrize("code_size", [8, 10])
def test_encode_matches_jax(code_size):
    rng = np.random.RandomState(3)
    boxes = np.concatenate([_boxes(rng, 16, 50.0), rng.uniform(-2, 2, (16, 2))], -1)
    boxes = boxes.astype(np.float32)
    kw = dict(pc_range=[-54.0, -54.0], out_size_factor=8, voxel_size=[0.075, 0.075],
              code_size=code_size)
    want = np.asarray(jax_coders.TransFusionBBoxCoder(**kw).encode(jnp.asarray(boxes)))
    got = TransFusionBBoxCoder(**kw).encode(_t(boxes)).numpy()
    assert got.shape == (16, code_size)
    assert _close(got, want)
