"""The NMS as suppression words on the CPU: N1's plain version
(``ops/nms.py:suppression_words_plain``) against words packed from the JAX
package's ``iou3d.iou_bev(b, b) > thr`` and circle ``d2 <= r^2`` (upper
triangle, score order), N2's plain version against the JAX
``_greedy_suppress``, and ``CenterHead.get_bboxes`` (the tasks as the
problems of one N1 and one N2) against the JAX head and against a loop of
one problem a task over the same plain functions.

Small N (at most 130); the JAX functions are compiled once, at 130 boxes:
a case of fewer boxes is padded with boxes that come after it in score
order, which leaves its own block of the IoU and its greedy pass unchanged.
A word bit may differ from the JAX one only where the JAX IoU lies within
2^-20 of the threshold (the two packages sum the shoelace terms in another
order); on these seeds none does.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models.heads.centerpoint import CenterHead as JaxCenterHead
from bevfusion_tpu.ops import iou3d as jax_iou3d
from bevfusion_tpu.ops import nms as jax_nms
from bevfusion_tpu_torch.models.heads.centerpoint import CenterHead, _rank
from bevfusion_tpu_torch.ops import nms
from tests.torch_port_helpers import load_bridged, random_variables, rel_err

torch.set_num_threads(2)

PAD = 130  # the boxes every JAX function is compiled at
NEAR = 2.0 ** -20
THR = {"rotate": 0.2, "circle": 4.0}  # the IoU threshold, the squared radius
CASES = [("random", 130), ("tied", 130), ("random", 1), ("random", 63), ("random", 64),
         ("random", 65), ("identical", 64), ("edges", 100)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(case, n, seed=11):
    """(boxes [n, 5] (cx, cy, dx, dy, yaw), scores [n], valid [n]) in index
    order: random boxes in a 12 m square; ``tied``: scores in steps of 1/4;
    ``identical``: one box n times; ``edges``: unit squares on a grid,
    sharing edges, every other turned by pi / 2."""
    rng = np.random.RandomState(seed + n)
    boxes = np.concatenate([rng.uniform(-6, 6, (n, 2)), rng.uniform(0.5, 4, (n, 2)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], -1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) < 0.9
    if case == "tied":
        scores = np.round(scores * 4) / 4
    elif case == "identical":
        boxes[:] = boxes[0]
    elif case == "edges":
        k = np.arange(n)
        boxes = np.stack([k % 10, k // 10, np.ones(n), np.ones(n), (k % 2) * np.pi / 2],
                         -1).astype(np.float32)
    return boxes, scores, valid


@functools.lru_cache(maxsize=None)
def _jax_fns():
    """The JAX functions at PAD boxes, compiled once: the score order, the
    IoU matrix, the squared center distances, the greedy pass."""
    order = jax.jit(lambda s, v: jnp.argsort(-jnp.where(v, s, -jnp.inf)))
    iou = jax.jit(lambda b: jax_iou3d.iou_bev(b, b))
    d2 = jax.jit(lambda c: jnp.sum((c[:, None] - c[None]) ** 2, axis=-1))
    return order, iou, d2, jax.jit(jax_nms._greedy_suppress)


def _pad(a, fill):
    """``a`` padded along its first axis to PAD rows of ``fill``."""
    return np.concatenate([a, np.full((PAD - len(a),) + a.shape[1:], fill, a.dtype)])


def _jax_problem(kind, boxes, scores, valid):
    """The JAX package's (score order [n], suppression matrix [n, n] in that
    order, its IoU or distances) of one problem."""
    n = len(scores)
    order_fn, iou_fn, d2_fn, _ = _jax_fns()
    # the padding is invalid and after the problem's invalid ones (a stable sort)
    order = np.asarray(order_fn(_pad(scores, 0.0), _pad(valid, False)))
    order = order[order < n]
    b = _pad(boxes[order], 1.0)
    if kind == "rotate":
        value = np.asarray(iou_fn(b))[:n, :n]
        return order, value > THR[kind], value
    value = np.asarray(d2_fn(b[:, :2]))[:n, :n]
    return order, value <= THR[kind], value


def _np_words(sup):
    """``[n, n]`` bool -> ``[n, ceil(n / 64)]`` int64 words, bit j % 64 of
    word j // 64 (``np.packbits``, little bit order), upper triangle only."""
    n = sup.shape[0]
    w = -(-n // 64)
    bits = np.zeros((n, w * 64), bool)
    bits[:, :n] = np.triu(sup, 1)
    return np.packbits(bits.reshape(n, w, 64), axis=-1, bitorder="little").view("<i8")[..., 0]


def _port_problem(kind, boxes, scores, valid):
    """The port's (N1's words [1, n, W], the score order [1, n]) through
    ``circle_suppression`` / ``bev_suppression`` (the plain N1 on the CPU)."""
    if kind == "rotate":
        return nms.bev_suppression(_t(boxes)[None], _t(scores)[None], _t(valid)[None], THR[kind])
    return nms.circle_suppression(_t(boxes[:, :2])[None], _t(scores)[None], _t(valid)[None],
                                  THR[kind])


@pytest.mark.parametrize("kind", ["rotate", "circle"])
@pytest.mark.parametrize("case,n", CASES)
def test_plain_words_match_jax(kind, case, n):
    boxes, scores, valid = _case(case, n)
    order, sup, value = _jax_problem(kind, boxes, scores, valid)
    words, got_order = _port_problem(kind, boxes, scores, valid)
    np.testing.assert_array_equal(got_order[0].numpy(), order)
    want = _np_words(sup)
    assert words.shape == (1, n, -(-n // 64)) and words.dtype == torch.int64
    diff = nms.unpack_words(words ^ _t(want)[None], n)[0].numpy()
    near = np.abs(value - THR[kind]) <= NEAR if kind == "rotate" else np.zeros_like(diff)
    assert not (diff & ~near).any() and not diff.any(), np.argwhere(diff)
    if case == "identical":  # every later copy suppressed by the first
        assert np.triu(sup, 1)[0, 1:].all()
    if case in ("random", "tied") and n == PAD:
        assert 0 < np.triu(sup, 1).sum() < n * (n - 1) // 2


@pytest.mark.parametrize("kind", ["rotate", "circle"])
@pytest.mark.parametrize("case,n", CASES)
def test_plain_greedy_on_words_matches_jax(kind, case, n):
    boxes, scores, valid = _case(case, n)
    order, sup, _ = _jax_problem(kind, boxes, scores, valid)
    greedy = _jax_fns()[3]
    padded = np.zeros((PAD, PAD), bool)
    padded[:n, :n] = sup
    want = np.asarray(greedy(np.concatenate([order, np.arange(n, PAD)]), padded))[:n]
    words, got_order = _port_problem(kind, boxes, scores, valid)
    got = nms.greedy_suppress_words(words, got_order)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(nms.greedy_suppress_words_plain(_t(_np_words(sup))[None],
                                                                  got_order)[0].numpy(), want)


def _head_cfg():
    """Three task groups with the camera configs' circle / rotated mix and
    ``nms_scale``, 64 boxes a task, so that NMS suppresses."""
    return dict(
        in_channels=12, share_conv_channel=8, norm_bbox=True,
        tasks=(("car",), ("truck", "construction_vehicle"), ("pedestrian", "traffic_cone")),
        common_heads={"reg": (2, 2), "height": (1, 2), "dim": (3, 2), "rot": (2, 2),
                      "vel": (2, 2)},
        separate_head={"type": "SeparateHead", "init_bias": -2.19, "final_kernel": 3,
                       "head_conv": 8},
        bbox_coder={"type": "CenterPointBBoxCoder", "pc_range": [-51.2, -51.2, -5.0, 51.2,
                                                                  51.2, 3.0],
                    "post_center_range": [-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
                    "max_num": 64, "score_threshold": 0.1, "out_size_factor": 8,
                    "voxel_size": [0.8, 0.8], "code_size": 9},
        test_cfg={"post_center_limit_range": [-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
                  "min_radius": [4, 12, 0.85], "score_threshold": 0.1, "out_size_factor": 8,
                  "voxel_size": [0.8, 0.8], "nms_type": ["circle", "rotate", "rotate"],
                  "nms_scale": [[1.0], [1.0, 1.0], [2.5, 4.0]], "pre_max_size": 1000,
                  "post_max_size": 20, "nms_thr": 0.2})


@functools.lru_cache(maxsize=None)
def _heads():
    """(the port's head, its predictions on moderate maps, the JAX head's
    get_bboxes on the same): the JAX head's random weights carried across,
    its heatmap convs scaled by 0.3 so the scores spread over (0, 1)."""
    cfg = _head_cfg()
    jm = JaxCenterHead(**cfg)
    feats = np.random.RandomState(7).randn(2, 16, 16, 12).astype(np.float32)
    variables = random_variables(jm.init, feats, seed=8)
    for t in range(3):
        variables["params"][f"task{t}"]["heatmap_out"]["kernel"] *= 0.3
    want = jax.tree_util.tree_map(np.asarray,
                                  jax.jit(lambda v, f: jm.get_bboxes(jm.apply(v, f)))(variables,
                                                                                      feats))
    head = load_bridged(CenterHead(**cfg), variables, "head_modules_object", "heads.object.")
    with torch.no_grad():
        preds = head(_t(feats.transpose(0, 3, 1, 2)))
    return head, preds, want


def test_batched_get_bboxes_matches_jax():
    head, preds, want = _heads()
    with torch.no_grad():
        got = head.get_bboxes(preds)
    mask = want["mask"]
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    assert rel_err(got["scores"].numpy(), want["scores"]) <= 1e-5
    assert rel_err(got["bboxes"].numpy()[mask], want["bboxes"][mask]) <= 1e-5
    assert mask.sum() > 10


def test_batched_get_bboxes_equals_a_loop_of_one_problem_a_task():
    head, preds, _ = _heads()
    post_max = head.test_cfg["post_max_size"]
    with torch.no_grad():
        got = head.get_bboxes(preds)["mask"].view(2, 3, 64)
        geom, rotated, thr, order = head.nms_inputs(preds)
        for t, pred in enumerate(preds):
            _, scores, _, valid, rows, rot, th = head._decode_task(t, pred)
            o = nms.score_order(scores, valid)
            rows = torch.gather(rows, 1, o[..., None].expand(-1, -1, nms.GEOM))
            words = nms.suppression_words_plain(rows, torch.tensor([rot, rot]),
                                                torch.tensor([th, th], dtype=torch.float32))
            keep = nms.greedy_suppress_words_plain(words, o) & valid
            assert (keep.sum(1) < valid.sum(1)).all()  # NMS suppressed in every problem
            np.testing.assert_array_equal(got[:, t].numpy(),
                                          (keep & (_rank(keep, scores) < post_max)).numpy())
            assert torch.equal(geom[2 * t:2 * t + 2], rows)
            assert torch.equal(order[2 * t:2 * t + 2], o)
            assert rotated[2 * t].item() == rot and thr[2 * t].item() == np.float32(th)
    assert rotated.tolist() == [False, False, True, True, True, True]
    words, o = head.suppressions(preds)  # what get_bboxes hands N2
    assert torch.equal(o, order) and torch.equal(words,
                                                 nms.suppression_words_plain(geom, rotated, thr))


def test_get_bboxes_exports_with_one_node_of_each_nms_kernel():
    """``torch.export`` of the head's decode: one ``bevfusion::`` node of
    N1 and one of N2 for the three tasks' six problems, and the exported
    program's boxes equal to eager's bit for bit."""
    from bevfusion_tpu_torch.ops import library

    head, preds, _ = _heads()

    class Decode(torch.nn.Module):
        def forward(self, maps):
            return head.get_bboxes(maps)

    with torch.no_grad():
        ep = torch.export.export(Decode(), (preds,), strict=False)
        want, got = head.get_bboxes(preds), ep.module()(preds)
    assert library.op_counts(ep.graph_module) == dict(
        {name: 0 for name in library.OPS}, suppression_words=1, greedy_suppress_words=1)
    assert all(torch.equal(got[k], want[k]) for k in want)
