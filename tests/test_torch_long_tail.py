"""Port parity of the modules no served config reaches, against the JAX
package: LayerNorm / GroupNorm (``models/layers.py:Norm``), ``AddFuser``,
``DetectronFPN``, ``VoVNet``, ``DLA``, the voxelizer's sum / max reductions,
``voxelize_batch`` and ``dynamic_scatter`` (``ops/voxelize.py``), the inverse
sparse conv and the sparse max pool (``ops/sparse_conv.py``), the
SparseEncoder's ``conv_module`` blocks, the multi-class and axis-aligned 3D
NMS masks (``ops/nms.py``), TransFusion's ``test_cfg`` NMS, and the
deformable conv (``ops/deform_conv.py``) with ``DCNSeparateHead``.

Inputs are made from numpy seeds; weights are the JAX package's random
variables carried across by the bridge (``runtime/bridge.py``). fp32 tensors
are held at max|d| <= 1e-5 * max(|want|, 1) (``RTOL``: the same operations in
another order) unless a test says otherwise; coordinates, ids, masks and NMS
keep masks are held equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models import fusers as jax_fusers
from bevfusion_tpu.models import layers as jax_layers
from bevfusion_tpu.models import necks as jax_necks
from bevfusion_tpu.models import second as jax_second
from bevfusion_tpu.models.dla import DLA as JaxDLA
from bevfusion_tpu.models.heads.centerpoint import CenterHead as JaxCenterHead
from bevfusion_tpu.models.heads.transfusion import TransFusionHead as JaxTransFusionHead
from bevfusion_tpu.models.pillar_encoder import PillarFeatureNet as JaxPillarFeatureNet
from bevfusion_tpu.models.sparse_encoder import SparseEncoder as JaxSparseEncoder
from bevfusion_tpu.models.vovnet import VoVNet as JaxVoVNet
from bevfusion_tpu.ops import deform_conv as jax_dc
from bevfusion_tpu.ops import nms as jax_nms
from bevfusion_tpu.ops import sparse_conv as jsp
from bevfusion_tpu.ops import voxelize as jvox
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.models.dla import DLA
from bevfusion_tpu_torch.models.fusers import AddFuser
from bevfusion_tpu_torch.models.heads.centerpoint import CenterHead, DCNSeparateHead
from bevfusion_tpu_torch.models.heads.transfusion import TransFusionHead
from bevfusion_tpu_torch.models.layers import Norm, set_dropout_generator
from bevfusion_tpu_torch.models.necks import DetectronFPN
from bevfusion_tpu_torch.models.pillar_encoder import PillarFeatureNet
from bevfusion_tpu_torch.models.second import SECOND
from bevfusion_tpu_torch.models.sparse_encoder import SparseEncoder
from bevfusion_tpu_torch.models.vovnet import VoVNet
from bevfusion_tpu_torch.ops import deform_conv as dc
from bevfusion_tpu_torch.ops import nms
from bevfusion_tpu_torch.ops import sparse_conv as sp
from bevfusion_tpu_torch.ops import voxelize as tvox
from bevfusion_tpu_torch.tools.benchmark import _unported_types
from tests.test_bevfusion_model import tiny_fused_config
from tests.test_torch_centerhead import COMMON_HEADS, _head_cfg
from tests.test_torch_sparse_encoder import _voxels
from tests.torch_port_helpers import load_bridged, random_variables, rel_err

torch.set_num_threads(2)

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


# ---------------------------------------------------------------- norms

@pytest.mark.parametrize("norm_type", ["LN", "GN"])
def test_norm_matches_flax(norm_type):
    """flax's LayerNorm over the channels, GroupNorm with its 32 groups. The
    inputs (mean 0.5, spread 1) keep flax's E[x^2] - E[x]^2 variance within
    rounding of torch's two-pass one, so the port is held to the JAX fp32
    result itself."""
    x = (np.random.RandomState(1).randn(2, 5, 6, 64) + 0.5).astype(np.float32)
    jm = jax_layers.Norm(norm_type, 1e-5)
    variables = random_variables(jm.init, x, seed=2)
    want = np.asarray(jm.apply(variables, x))
    norm = Norm(norm_type, 64, 1e-5)
    inner = variables["params"][norm_type.lower()]
    norm.load_state_dict({"weight": _t(inner["scale"]), "bias": _t(inner["bias"])})
    with torch.no_grad():
        got = norm(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("norm_type", ["LN", "GN"])
def test_second_with_layer_and_group_norms_matches_jax(norm_type):
    """SECOND's ``norm_cfg`` in LN / GN: the bridge gives each norm the keys
    of the BatchNorm in its place."""
    cfg = dict(in_channels=8, out_channels=(32, 64), layer_nums=(1, 1), layer_strides=(2, 2),
               norm_cfg={"type": norm_type, "eps": 1e-3, "momentum": 0.01})
    jm = jax_second.SECOND(**cfg)
    x = np.random.RandomState(3).randn(1, 12, 12, 8).astype(np.float32)
    variables = random_variables(jm.init, x, seed=4)
    want = jm.apply(variables, x)
    model = load_bridged(SECOND(**cfg), variables, "decoder_backbone", "decoder.backbone.")
    with torch.no_grad():
        got = model(_nchw(x))
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) <= RTOL


def test_pillar_feature_net_with_group_norm_matches_jax():
    """PFN's GroupNorm on [pillars, points, C]: each pillar's rows together.
    The points' coordinates (tens of metres) give the Linear's outputs a mean
    far above their spread within a pillar, where flax's fp32 E[x^2] - E[x]^2
    loses digits (4e-5 off the two-pass variance here): both packages run in
    float64."""
    from tests.test_torch_pillar import PFN, _table

    table = _table(3)
    cfg = {k: v for k, v in PFN.items() if k != "type"}
    cfg.update(feat_channels=[64, 64], norm_cfg={"type": "GN", "eps": 1e-3})
    args = (table.feats, table.num_points, table.coords)
    variables = random_variables(JaxPillarFeatureNet(**cfg).init, *args, seed=6)
    f64 = [np.asarray(a, np.float64 if np.asarray(a).dtype == np.float32 else None)
           for a in args]
    with jax.enable_x64(True):
        jm = JaxPillarFeatureNet(**cfg, dtype=jnp.float64)
        want = np.asarray(jax.jit(jm.apply)(jax.tree_util.tree_map(
            lambda a: a.astype(np.float64), variables), *f64))
    net = load_bridged(PillarFeatureNet(**cfg), variables, "lidar_backbone/PillarFeatureNet_0",
                       "encoders.lidar.backbone.pts_voxel_encoder.").double()
    with torch.no_grad():
        got = net(*(_t(a) for a in f64)).numpy()
    assert np.abs(want).max() > 0.1 and rel_err(got, want) <= RTOL


# ---------------------------------------------------------------- fuser, neck, backbones

def test_add_fuser_matches_jax_at_dropout_zero():
    """Eval (running statistics) and training (batch statistics), dropout 0."""
    rng = np.random.RandomState(5)
    xs = [rng.randn(2, 8, 8, 6).astype(np.float32), rng.randn(2, 8, 8, 10).astype(np.float32)]
    jm = jax_fusers.AddFuser(in_channels=(6, 10), out_channels=12, dropout=0.0)
    variables = random_variables(jm.init, xs, seed=7)
    want = np.asarray(jm.apply(variables, xs))
    want_train, _ = jm.apply(variables, xs, training=True, mutable=["batch_stats"])
    fuser = load_bridged(AddFuser((6, 10), 12, 0.0), variables, "fuser_module", "fuser.")
    with torch.no_grad():
        got = fuser([_nchw(x) for x in xs]).numpy().transpose(0, 2, 3, 1)
        got_train = fuser.train()([_nchw(x) for x in xs]).numpy().transpose(0, 2, 3, 1)
    assert rel_err(got, want) <= RTOL
    assert rel_err(got_train, np.asarray(want_train)) <= RTOL


def test_add_fuser_drops_one_whole_sensor_from_its_generator():
    """The port's drop rule: in training with probability ``dropout`` one
    sensor, drawn uniformly, gets weight 0 and the mean is over the rest;
    never at eval, never with one sensor; the draws come from the explicit
    generator, so a reseeded one repeats them."""
    fuser = AddFuser((3, 3, 3), 4, dropout=0.5).train()
    with pytest.raises(RuntimeError, match="generator"):
        fuser.weights(3, "cpu")
    set_dropout_generator(fuser, torch.Generator().manual_seed(0))
    draws = [tuple(fuser.weights(3, "cpu").tolist()) for _ in range(400)]
    set_dropout_generator(fuser, torch.Generator().manual_seed(0))
    assert draws == [tuple(fuser.weights(3, "cpu").tolist()) for _ in range(400)]
    kept = draws.count((1.0, 1.0, 1.0))
    assert 0.4 < kept / 400 < 0.6
    assert all(sorted(d) == [0.0, 1.0, 1.0] for d in draws if d != (1.0, 1.0, 1.0))
    assert all(sum(d[k] == 0 for d in draws) > 40 for k in range(3))
    assert fuser.weights(1, "cpu").tolist() == [1.0]
    assert fuser.eval().weights(3, "cpu").tolist() == [1.0, 1.0, 1.0]
    # the fused map is the mean of the kept sensors' transforms (a seed whose draw drops one)
    fuser.train()
    seed = next(i for i in range(100) if 0.0 in AddFuser.weights(
        set_dropout_generator(fuser, torch.Generator().manual_seed(i)), 3, "cpu").tolist())
    xs = [torch.randn(1, 3, 4, 4) for _ in range(3)]
    with torch.no_grad():
        set_dropout_generator(fuser, torch.Generator().manual_seed(seed))
        got = fuser(xs)
        set_dropout_generator(fuser, torch.Generator().manual_seed(seed))
        w = fuser.weights(3, "cpu")
        parts = [t(x) for t, x in zip(fuser.transforms, xs)]  # batch statistics, as above
    assert w.sum() == 2.0
    want = sum(wk * p for wk, p in zip(w, parts)) / 2.0
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)


def test_add_fuser_config_builds():
    """The tiny fused model with AddFuser in place of ConvFuser names no type
    the port lacks and builds."""
    cfg = tiny_fused_config()
    cfg["fuser"] = {"type": "AddFuser", "in_channels": [16, 16], "out_channels": 16,
                    "dropout": 0.1}
    assert _unported_types(cfg) == []
    model = build_model(cfg, "cpu")
    assert type(model.fuser).__name__ == "AddFuser" and len(model.fuser.transforms) == 2


@pytest.mark.parametrize("fuse_type", ["sum", "avg"])
def test_detectron_fpn_matches_jax(fuse_type):
    """Sizes that halve unevenly (15 -> 8 -> 4): the nearest resize's
    half-pixel rule shows."""
    rng = np.random.RandomState(8)
    shapes = [(1, 15, 17, 6), (1, 8, 9, 10), (1, 4, 5, 12), (1, 2, 3, 4)]
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    cfg = dict(in_indices=(0, 1, 2), out_indices=(2, 0), in_channels=(6, 10, 12),
               out_channels=8, fuse_type=fuse_type)
    jm = jax_necks.DetectronFPN(**cfg)
    variables = random_variables(jm.init, xs, seed=9)
    want = jm.apply(variables, xs)
    neck = load_bridged(DetectronFPN(**cfg), variables, "camera_neck", "encoders.camera.neck.")
    with torch.no_grad():
        got = neck([_nchw(x) for x in xs])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) <= RTOL


def test_vovnet_matches_jax():
    """VoVNet-19-slim-eSE (every stage, the eSE, the ceil-mode pools at odd sizes)."""
    x = np.random.RandomState(10).rand(1, 70, 54, 3).astype(np.float32)
    cfg = dict(spec_name="V-19-slim-eSE", out_features=("stage2", "stage3", "stage4", "stage5"))
    jm = JaxVoVNet(**cfg)
    variables = random_variables(jm.init, x, seed=11)
    want = jax.jit(jm.apply)(variables, x)
    model = load_bridged(VoVNet(**cfg), variables, "camera_backbone",
                         "encoders.camera.backbone.")
    with torch.no_grad():
        got = model(_nchw(x))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) <= RTOL


@pytest.mark.parametrize("levels,residual_root", [((1, 1, 1, 2, 2, 1), False),
                                                  ((1, 2, 2, 1, 3, 1), True)])
def test_dla_matches_jax(levels, residual_root):
    """DLA-34's levels and a deeper tree (level_root children threaded three
    deep, the root's residual)."""
    x = np.random.RandomState(12).rand(1, 64, 64, 3).astype(np.float32)
    cfg = dict(levels=levels, channels=(4, 8, 16, 16, 24, 32), residual_root=residual_root,
               out_features=("level2", "level3", "level5"))
    jm = JaxDLA(**cfg)
    variables = random_variables(jm.init, x, seed=13)
    want = jax.jit(jm.apply)(variables, x)
    model = load_bridged(DLA(**cfg), variables, "camera_backbone", "encoders.camera.backbone.")
    with torch.no_grad():
        got = model(_nchw(x))
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) <= RTOL


# ---------------------------------------------------------------- voxels

PCR = [-4.0, -4.0, -2.0, 4.0, 4.0, 2.0]
VS = [1.0, 1.0, 1.0]


def _cloud(seed, n=300):
    """Clustered points, some outside the range, a masked tail."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.randn(n, 3) * 2.5, rng.randn(n, 2)], 1).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-20:] = False
    return pts, mask


@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("max_voxels", [64, 20])  # 20: the cap is reached
def test_voxelize_reductions_match_jax(reduce, max_voxels):
    pts, mask = _cloud(14)
    want = jvox.voxelize(jnp.asarray(pts), jnp.asarray(mask), VS, PCR, 3, max_voxels, reduce)
    got = tvox.voxelize(_t(pts), _t(mask), VS, PCR, 3, max_voxels, reduce)
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.num_points.numpy(), np.asarray(want.num_points))
    assert rel_err(got.feats.numpy(), np.asarray(want.feats)) <= RTOL


def test_voxelize_batch_matches_jax():
    clouds = [_cloud(15), _cloud(16)]
    pts, mask = np.stack([c[0] for c in clouds]), np.stack([c[1] for c in clouds])
    want = jvox.voxelize_batch(jnp.asarray(pts), jnp.asarray(mask), VS, PCR, 4, 40, "mean")
    got = tvox.voxelize_batch(_t(pts), _t(mask), VS, PCR, 4, 40, "mean")
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert rel_err(got[0].numpy(), np.asarray(want[0])) <= RTOL


@pytest.mark.parametrize("average_points,max_voxels", [(True, 128), (False, 128), (True, 12)])
def test_dynamic_scatter_matches_jax(average_points, max_voxels):
    """Points out of range and masked ones ignored; at 12 the cap is reached
    (the smallest ids kept); ``max`` over present points only."""
    pts, mask = _cloud(17)
    want = jvox.DynamicScatter(VS, PCR, average_points, max_voxels)(jnp.asarray(pts),
                                                                     jnp.asarray(mask))
    got = tvox.DynamicScatter(VS, PCR, average_points, max_voxels)(_t(pts), _t(mask))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert rel_err(got[0].numpy(), np.asarray(want[0])) <= RTOL
    assert int(got[2].sum()) == min(max_voxels, int(got[2].sum()))
    if max_voxels == 12:
        assert bool(got[2].all())  # more voxels occupied than the cap


def test_dynamic_scatter_sum_of_features_matches_jax():
    rng = np.random.RandomState(18)
    feats = rng.randn(200, 4).astype(np.float32)
    coords = rng.randint(-1, 5, (200, 3)).astype(np.int32)  # -1: out of the grid
    valid = rng.rand(200) < 0.9
    want = jvox.dynamic_scatter(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid),
                                (4, 4, 4), 50, "sum")
    got = tvox.dynamic_scatter(_t(feats), _t(coords), _t(valid), (4, 4, 4), 50, "sum")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert rel_err(got[0].numpy(), np.asarray(want[0])) <= RTOL


# ---------------------------------------------------------------- sparse ops

@functools.lru_cache(maxsize=None)
def _sites():
    """The sites of tests/test_sparse_conv.py's inverse-conv oracle, a strided
    conv's tables by the port's builders (tests/test_torch_sparse_conv.py
    holds them to the JAX package's bit for bit): (in sites' mask, out
    sites' mask, nbr [K, cap_out], nbr_t [K, cap_in])."""
    rng = np.random.RandomState(11)
    grid = sp.SparseGrid(8, 8, 6)
    og = sp.conv_out_shape(grid, 3, 2, 1)
    ids0 = np.unique(rng.choice(grid.size, 60)).astype(np.int32)
    in_ids = np.full(64, grid.size, np.int32)
    in_ids[:len(ids0)] = ids0
    out_ids, out_mask = sp.downsample_sites(_t(in_ids), grid, 3, 2, 1, 64)
    nbr = sp.build_conv_rulebook(_t(in_ids), out_ids, grid, og, 3, 2, 1)
    nbr_t = sp.build_conv_transpose_rulebook(_t(in_ids), out_ids, grid, og, 3, 2, 1)
    return out_mask.numpy(), nbr, nbr_t


def test_sparse_inverse_conv_matches_jax():
    out_mask, _, nbr_t = _sites()
    rng = np.random.RandomState(19)
    feats = rng.randn(64, 4).astype(np.float32) * out_mask[:, None]
    w = (rng.randn(27, 4, 5) * 0.1).astype(np.float32)
    want = np.asarray(jsp.sparse_inverse_conv_gemm(jnp.asarray(feats), nbr_t.numpy().T,
                                                   jnp.asarray(w)))
    got = sp.sparse_inverse_conv_gemm(_t(feats), nbr_t, _t(w)).numpy()
    assert rel_err(got, want) <= RTOL and np.abs(want).max() > 0.1


def test_sparse_maxpool_matches_jax():
    out_mask, nbr, _ = _sites()
    feats = np.random.RandomState(20).randn(64, 7).astype(np.float32)
    want = np.asarray(jsp.sparse_maxpool(jnp.asarray(feats), nbr.numpy().T))
    got = sp.sparse_maxpool(_t(feats), nbr).numpy()
    np.testing.assert_array_equal(got, want)  # a max picks values: exact
    assert (got[~out_mask] == 0).all() and (np.abs(got[out_mask]) > 0).any()


CONV_MODULE = dict(  # three stages: stage 2 dense at the split below, sparse without it
    in_channels=5, sparse_shape=(128, 128, 33), base_channels=4, output_channels=16,
    encoder_channels=((4, 8), (8, 16), (16, 16)), encoder_paddings=((1, 1), (0, 1), ((1, 1, 0), 1)),
    block_type="conv_module")


def test_sparse_encoder_conv_module_matches_jax():
    """``block_type="conv_module"``: the strided conv first in every stage but
    the first, plain submanifold conv-BN-ReLU blocks (widths changing) in
    sparse and dense stages; the tolerance of tests/test_torch_sparse_encoder.py
    (fp32 through ~8 convs). The JAX encoder dense from stage 2; the port at
    that split and all sparse (stage 2's blocks and ``conv_out`` on the
    kernel's rulebooks: the same function, exactly). The eval forward's
    sparse convs: the input conv and the 4 blocks of stages 0-1, then 3 more
    all sparse."""
    feats, coords, mask = _voxels()
    jenc = JaxSparseEncoder(**CONV_MODULE, dense_from_stage=2, engine="gather")
    variables = random_variables(jenc.init, feats, coords, mask, seed=21)
    want = np.asarray(jax.jit(jenc.apply)(variables, feats, coords, mask)).transpose(0, 3, 1, 2)
    scale = max(float(np.max(np.abs(want))), 1.0)
    assert np.max(np.abs(want)) > 0.1
    for dense_from_stage, launches in ((2, 5), (-1, 8)):
        enc = SparseEncoder(**CONV_MODULE, dense_from_stage=dense_from_stage)
        load_bridged(enc, variables, "lidar_backbone", "encoders.lidar.backbone.")
        calls = []
        real = sp.sparse_conv

        def counted(*a, **k):
            calls.append(a[2].shape)
            return real(*a, **k)

        sp.sparse_conv = counted
        try:
            with torch.no_grad():
                got = enc(*map(torch.from_numpy, (feats, coords, mask))).numpy()
        finally:
            sp.sparse_conv = real
        assert len(calls) == launches
        assert got.shape == want.shape == (1, 48, 32, 32)
        assert np.max(np.abs(got - want)) <= 2.5e-3 * scale
        assert np.mean(np.abs(got - want)) <= 2e-4 * scale


def test_sparse_encoder_conv_module_sites_and_raises():
    enc = SparseEncoder(**CONV_MODULE, dense_from_stage=-1)
    feats, coords, mask = _voxels()
    stages = enc.sparse_sites(torch.from_numpy(coords[0]), torch.from_numpy(mask[0]))
    assert [s["channels"] for s in stages] == [4, 8, 16]
    assert [s["down"] for s in stages] == [(0, 2048), ((1, 1, 0), 2048), None]
    with pytest.raises(NotImplementedError, match="order"):
        SparseEncoder(**dict(CONV_MODULE, order=("norm", "conv", "act")))


# ---------------------------------------------------------------- NMS

def _boxes(rng, N, spread=3.0):
    return np.concatenate([rng.uniform(-spread, spread, (N, 2)), rng.uniform(0.5, 3.0, (N, 2)),
                           rng.uniform(-np.pi, np.pi, (N, 1))], -1).astype(np.float32)


def test_box3d_multiclass_nms_mask_matches_jax():
    """Without and with ``max_num``; ties in the scores: equal ones keep the
    flat order under ``max_num``."""
    rng = np.random.RandomState(22)
    boxes = _boxes(rng, 40)
    scores = np.round(rng.rand(40, 3), 1).astype(np.float32)
    valid = rng.rand(40) < 0.9
    both = jax.jit(lambda *a: [jax_nms.box3d_multiclass_nms_mask(*a, 0.15, 0.2, m)
                               for m in (None, 7)])
    for max_num, want in zip((None, 7), both(boxes, scores, valid)):
        got = nms.box3d_multiclass_nms_mask(_t(boxes), _t(scores), _t(valid), 0.15, 0.2,
                                            max_num)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < np.asarray(want).sum() < (valid[:, None] & (scores > 0.15)).sum()
    assert np.asarray(want).sum() == 7


def test_aligned_3d_nms_mask_matches_jax():
    rng = np.random.RandomState(23)
    lo = rng.uniform(-2, 2, (50, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.5, 2.0, (50, 3))], 1).astype(np.float32)
    scores = np.round(rng.rand(50), 1).astype(np.float32)
    classes = rng.randint(0, 3, 50).astype(np.int32)
    valid = rng.rand(50) < 0.9
    want = np.asarray(jax.jit(functools.partial(jax_nms.aligned_3d_nms_mask, thresh=0.25))(
        boxes, scores, classes, valid))
    got = nms.aligned_3d_nms_mask(_t(boxes), _t(scores), _t(classes), _t(valid), 0.25)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()


def _transfusion(nms_type, dataset):
    cfg = dict(tiny_fused_config()["heads"]["object"])
    cfg.pop("type")
    cfg["num_proposals"] = 48
    cfg["test_cfg"] = dict(cfg.get("test_cfg") or {}, nms_type=nms_type, dataset=dataset)
    rng = np.random.RandomState(24)
    B, P, n = 2, 48, cfg["num_classes"]
    labels = rng.choice([0, 1, 2, 8, 9], (B, P)) if dataset == "nuScenes" else \
        rng.choice([0, 1, 2], (B, P))
    preds = {"heatmap": rng.randn(B, P, n), "query_labels": labels.astype(np.int32),
             "query_heatmap_score": rng.rand(B, P, n), "rot": rng.randn(B, P, 2),
             "dim": rng.randn(B, P, 3) * 0.3,
             "center": rng.rand(B, P, 2) * 0.6 + 7.7,  # a cluster: groups suppress
             "height": rng.randn(B, P, 1), "vel": rng.randn(B, P, 2)}
    preds = {k: v.astype(np.int32 if k == "query_labels" else np.float32)
             for k, v in preds.items()}
    return cfg, preds


@pytest.mark.parametrize("nms_type,dataset", [("circle", "nuScenes"), ("rotate", "nuScenes"),
                                              ("circle", "Waymo")])
def test_transfusion_nms_matches_jax(nms_type, dataset):
    """``test_cfg.nms_type``: the dataset's class groups, circle NMS on the
    unsquared radius, rotated NMS on (x, y, w, l, yaw), radius <= 0 keeping
    the group (nuScenes' first group); keep masks equal."""
    cfg, preds = _transfusion(nms_type, dataset)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(JaxTransFusionHead(**cfg).get_bboxes)(preds))
    head = TransFusionHead(**cfg).eval()
    got = head.get_bboxes({k: _t(v).long() if k == "query_labels" else _t(v)
                           for k, v in preds.items()})
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    assert rel_err(got["bboxes"].numpy(), want["bboxes"]) <= RTOL
    cfg["test_cfg"] = dict(cfg["test_cfg"], nms_type=None)
    decoded = np.asarray(JaxTransFusionHead(**cfg).get_bboxes(preds)["mask"])
    assert 0 < want["mask"].sum() < decoded.sum()  # NMS suppressed some, kept some


# ---------------------------------------------------------------- deformable conv

def _offsets(rng, shape, integer_share=0.3):
    """Offsets of a few pixels, some taps on integers, some far outside."""
    off = rng.uniform(-3.0, 3.0, shape)
    on_int = rng.rand(*shape) < integer_share
    off[on_int] = np.round(off[on_int])
    off[rng.rand(*shape) < 0.05] = 40.0  # wholly outside the image
    return off.astype(np.float32)


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_conv2d_matches_jax(modulated):
    rng = np.random.RandomState(25)
    x = rng.randn(2, 9, 11, 5).astype(np.float32)
    off = _offsets(rng, (2, 9, 11, 18))
    w = (rng.randn(9, 5, 6) * 0.3).astype(np.float32)
    mask = rng.rand(2, 9, 11, 9).astype(np.float32) if modulated else None
    want = np.asarray(jax_dc.deform_conv2d(x, off, w, mask))
    got = dc.deform_conv2d(_t(x), _t(off), _t(w), None if mask is None else _t(mask))
    assert rel_err(got.numpy(), want) <= RTOL


def test_deform_conv2d_gradient_matches_jax():
    """The op's gradient (autograd of the plain version) against
    ``jax.grad`` of the JAX function, for the input, offsets, weight and mask."""
    rng = np.random.RandomState(26)
    x = rng.randn(1, 6, 7, 3).astype(np.float32)
    off = rng.uniform(-2.0, 2.0, (1, 6, 7, 18)).astype(np.float32)  # off the integers
    w = (rng.randn(9, 3, 4) * 0.3).astype(np.float32)
    mask = rng.rand(1, 6, 7, 9).astype(np.float32)
    g = rng.randn(1, 6, 7, 4).astype(np.float32)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(jax_dc.deform_conv2d(*a) * g),
                            argnums=(0, 1, 2, 3)))(x, off, w, mask)
    args = [_t(a).requires_grad_() for a in (x, off, w, mask)]
    (dc.deform_conv2d(*args) * _t(g)).sum().backward()
    for a, wg in zip(args, want):
        assert rel_err(a.grad.numpy(), np.asarray(wg)) <= 1e-4


def test_centerhead_with_dcn_separate_head_matches_jax():
    """CenterHead built from a config whose ``separate_head`` names
    DCNSeparateHead, two tasks, eval forward: every branch of each task's
    DCNSeparateHead. The random ``conv_offset`` kernels move the taps off the
    integers (at init they are zero, every tap on one)."""
    cfg = _head_cfg((("car",), ("truck", "bus")), "circle", None)
    cfg["separate_head"] = {"type": "DCNSeparateHead", "init_bias": -2.19, "final_kernel": 3,
                            "head_conv": 8}
    jm = JaxCenterHead(**cfg)
    x = np.random.RandomState(29).randn(1, 16, 16, 12).astype(np.float32)
    variables = random_variables(jm.init, x, seed=30)
    want = jax.jit(jm.apply)(variables, x)
    head = load_bridged(CenterHead(**cfg), variables, "head_modules_object",
                        "heads.object.")
    assert all(isinstance(t, DCNSeparateHead) for t in head.task_heads)
    with torch.no_grad():
        got = head(_nchw(x))
        shared = head.shared_conv(_nchw(x))
        offsets = [t.feature_adapt_cls.conv_offset(shared) for t in head.task_heads]
    assert all(float((o - o.round()).abs().max()) > 0.1 for o in offsets)
    for g, w in zip(got, want):
        for k in COMMON_HEADS:
            assert rel_err(g[k].numpy(), np.asarray(w[k]).transpose(0, 3, 1, 2)) <= RTOL, k
        assert rel_err(g["heatmap"].numpy(),
                       np.asarray(w["heatmap"]).transpose(0, 3, 1, 2)) <= RTOL
