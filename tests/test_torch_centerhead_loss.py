"""Port parity of ``CenterHead.loss`` (``models/heads/centerpoint.py``)
against the JAX package's (``bevfusion_tpu/models/heads/centerpoint.py:166-237``).

The head of the CenterHead configs (six task groups, ``code_weights``,
``gaussian_overlap`` 0.1, ``min_radius`` 2) on a 16 x 12 map of 2 m cells
(not square, so an X / Y swap of the targets or the gather shows), two
samples of boxes made from a numpy seed: boxes on the map, off it, with
centers less than a cell below the range's lower edge (the integer center
truncates toward zero, so they land in cell 0 and count), with labels
outside the class table (clipped into it), of zero size and marked invalid,
and two boxes sharing a cell. The same random maps go through both packages
(NCHW in the port, NHWC in JAX). Held: every task's ``heatmap/task{t}`` and
``bbox/task{t}`` at 1e-5 relative, and the gradient of their sum with
respect to every map at max|d| <= 1e-5 * max(|want|, 1).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models.heads.centerpoint import CenterHead as JaxCenterHead
from bevfusion_tpu_torch.config import load_config
from bevfusion_tpu_torch.models.heads.centerpoint import CenterHead
from bevfusion_tpu_torch.runtime import flagship
from tests.torch_port_helpers import rel_err

torch.set_num_threads(2)

RTOL = 1e-5
PCR = [-16.0, -12.0, -5.0, 16.0, 12.0, 3.0]
FX, FY = 16, 12  # map cells along X and Y (2 m: voxel 0.25 x out_size_factor 8)
BRANCHES = {"reg": 2, "height": 1, "dim": 3, "rot": 2, "vel": 2}


def head_cfg(norm_bbox=True):
    """The resnet camera config's CenterHead with its train_cfg on the small map."""
    head = dict(load_config(flagship.DET_CAMERA_CONFIGS["resnet"]).model["heads"]["object"])
    head.pop("type")
    head["train_cfg"] = dict(head["train_cfg"], point_cloud_range=PCR,
                             grid_size=[FX * 8, FY * 8, 1], voxel_size=[0.25, 0.25, 0.2])
    head["bbox_coder"] = dict(head["bbox_coder"], pc_range=PCR, voxel_size=[0.25, 0.25])
    head.update(in_channels=8, share_conv_channel=8, norm_bbox=norm_bbox)
    return head


def gt(seed=0, B=2, G=20):
    """(boxes [B, G, 9], labels [B, G], valid [B, G]) covering the cases of
    the module docstring."""
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([
        rng.uniform(PCR[:2], PCR[3:5], (B, G, 2)), rng.uniform(-2, 0, (B, G, 1)),
        rng.uniform(0.5, 5, (B, G, 3)), rng.uniform(-np.pi, np.pi, (B, G, 1)),
        rng.uniform(-3, 3, (B, G, 2))], -1).astype(np.float32)
    labels = rng.randint(0, 10, (B, G)).astype(np.int32)
    valid = np.ones((B, G), bool)
    boxes[:, 0, :2] = [PCR[0] - 0.6, 1.1]  # 0.3 of a cell below x's edge: ix 0, counted
    boxes[:, 1, :2] = [3.3, PCR[1] - 1.5]  # three quarters below y's edge: iy 0, counted
    boxes[:, 2, :2] = [PCR[0] - 2.5, 0.0]  # over a cell below: ix -1, off the map
    boxes[:, 3, :2] = [PCR[3] + 0.5, 4.0]  # past the upper edge
    boxes[:, 4, :2] = [7.9, -3.2]
    boxes[:, 5, :2] = [7.1, -3.9]  # shares box 4's cell
    boxes[:, 5, 3] = 0.0  # no width: not a target
    boxes[:, 6, :2] = [7.5, -3.5]  # the same cell again
    labels[:, :4] = [0, 3, 5, 8]
    labels[:, 7], labels[:, 8] = -3, 14  # clipped to class 0 and 9
    labels[:, 4:7] = 0
    valid[:, 9] = False
    return boxes, labels, valid


def _maps(seed, head):
    """Random head maps, NCHW [B, c, FX, FY], per task."""
    rng = np.random.RandomState(seed)
    return [{name: rng.randn(2, c, FX, FY).astype(np.float32)
             for name, c in dict(BRANCHES, heatmap=len(task)).items()} for task in head["tasks"]]


@functools.lru_cache(maxsize=None)
def _jax_loss(norm_bbox, seed):
    head = head_cfg(norm_bbox)
    maps = _maps(seed, head)
    jm = JaxCenterHead(**head)
    boxes, labels, valid = gt(seed)

    def total(preds):
        losses = jm.loss(preds, boxes, labels, valid)
        return sum(losses.values()), losses

    nhwc = [{k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in m.items()} for m in maps]
    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(nhwc)
    return maps, {k: float(v) for k, v in losses.items()}, \
        [{k: np.asarray(v).transpose(0, 3, 1, 2) for k, v in g.items()} for g in grads]


@pytest.mark.parametrize("norm_bbox", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_centerhead_loss_matches_jax(norm_bbox, seed):
    maps, want, want_grads = _jax_loss(norm_bbox, seed)
    head = CenterHead(**head_cfg(norm_bbox))
    preds = [{k: torch.from_numpy(v).requires_grad_() for k, v in m.items()} for m in maps]
    boxes, labels, valid = (torch.from_numpy(a) for a in gt(seed))
    losses = head.loss(preds, boxes, labels, valid)
    assert set(losses) == set(want) == {f"{kind}/task{t}" for t in range(6)
                                        for kind in ("heatmap", "bbox")}
    for k, v in want.items():
        assert v > 0 and abs(losses[k].item() - v) <= RTOL * v, (k, losses[k].item(), v)
    sum(losses.values()).backward()
    for t, (p, g) in enumerate(zip(preds, want_grads)):
        for k in g:
            assert rel_err(p[k].grad.numpy(), g[k]) <= RTOL, (t, k)
    assert np.abs(want_grads[0]["reg"]).max() > 0  # the gather reaches the maps


def _port_losses(boxes, labels, valid, seed=0):
    head = CenterHead(**head_cfg())
    maps = [{k: torch.from_numpy(v) for k, v in m.items()} for m in _maps(seed, head_cfg())]
    return {k: v.item() for k, v in head.loss(maps, *(torch.from_numpy(a) for a in
                                                       (boxes, labels, valid))).items()}


def test_centerhead_targets_count_truncated_centers_and_clip_labels():
    """Which of ``gt``'s boxes count, seen in the losses: dropping a box
    changes its task's two terms exactly where it is a target. Box 0, 0.3
    of a cell below x's edge, lands in cell 0 (truncation toward zero,
    not ``floor``) and counts; box 2, more than a cell below, and box 3,
    past the upper edge, do not; label -3 is clipped into task 0 (car) and
    label 14 into task 5 (its tenth class, traffic_cone)."""
    boxes, labels, valid = gt(0)
    base = _port_losses(boxes, labels, valid)

    def changed(box):
        drop = valid.copy()
        drop[:, box] = False
        other = _port_losses(boxes, labels, drop)
        return {k for k in base if other[k] != base[k]}

    def task(box):
        return [0, 1, 1, 2, 2, 3, 4, 4, 5, 5][int(np.clip(labels[0, box], 0, 9))]

    for box in (0, 1, 7, 8):
        assert changed(box) == {f"heatmap/task{task(box)}", f"bbox/task{task(box)}"}, box
    assert task(7) == 0 and task(8) == 5
    for box in (2, 3, 5, 9):  # off the map, no width, already invalid
        assert changed(box) == set(), box
