"""Port parity of the BEV map-segmentation task: the map head, the camera-only
configs' decoder (GeneralizedResNet, LSSFPN) and LSSTransform, each against
the JAX module with the same random weights (carried across by the bridge),
and the three seg configs' builds.

Modules in fp32, max|d| <= 1e-5 * max(|want|, 1) per output (losses: 1e-5
relative). The grid transform runs on non-square scopes, so a swapped X / Y
axis would show; LSSTransform on a jittered rig (no frustum point within
1e-4 m of a cell boundary), JAX on its fp32 in-graph pool, the port on both
of its routes. Whole tiny models: ``tests/test_torch_seg_model.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevfusion_tpu.models  # noqa: F401  (registers the JAX modules)
import bevfusion_tpu_torch.models  # noqa: F401  (registers the port's modules)
from bevfusion_tpu import registry as jreg
from bevfusion_tpu.models.heads import segm as jsegm
from bevfusion_tpu.models.layers import BasicBlock as JaxBasicBlock
from bevfusion_tpu_torch import registry as treg
from bevfusion_tpu_torch.config import Config, load_config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.models.heads import segm
from bevfusion_tpu_torch.models.layers import BasicBlock
from bevfusion_tpu_torch.runtime.flagship import SEG_CONFIGS, add_pool_lut
from bevfusion_tpu_torch.tools.benchmark import _unported_types
from tests.test_bevfusion_model import make_batch, tiny_fused_config
from tests.torch_port_helpers import (boundary_margin, jittered_rig, load_bridged,
                                      random_variables, rel_err)

torch.set_num_threads(2)

RTOL = 1e-5
# non-square on both sides; the output reaches past the input on three edges
GRID = {"input_scope": [[-12.0, 12.0, 1.5], [-10.0, 10.0, 1.0]],
        "output_scope": [[-15.0, 11.0, 0.8], [-6.0, 11.0, 0.5]]}
OUT = tuple(len(np.arange(lo + step / 2, hi, step, dtype=np.float32))
            for lo, hi, step in GRID["output_scope"])


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (JAX arrays are read-only)


def _bev(seed, shape=(2, 16, 20, 8)):
    """A random BEV map [B, X, Y, C] (JAX layout) and its port layout."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return x, _t(_nchw(x))


@pytest.mark.parametrize("prescale", [1.0, 2.0])
def test_bev_grid_transform_matches_jax(prescale):
    x, tx = _bev(0)
    want = jsegm.BEVGridTransform(**GRID, prescale_factor=prescale).apply({}, x)
    got = segm.BEVGridTransform(**GRID, prescale_factor=prescale)(tx)
    assert got.shape == (2, 8) + OUT and want.shape == (2,) + OUT + (8,)
    want = _nchw(want)
    assert np.abs(want[:, :, 0]).max() == 0 and np.abs(want[:, :, :, -1]).max() == 0  # outside
    assert rel_err(got.numpy(), want) <= RTOL


def _head(loss="focal", seed=1):
    cfg = dict(type="BEVSegmentationHead", in_channels=8, grid_transform=GRID,
               classes=["drivable_area", "divider", "walkway"], loss=loss)
    x, tx = _bev(seed)
    jm = jreg.HEADS.build(cfg)
    variables = random_variables(jm.init, x, seed=seed)
    tm = load_bridged(treg.HEADS.build(cfg), variables, "head_modules_map", "heads.map.")
    return jm, variables, tm, x, tx


def test_seg_head_eval_matches_jax():
    jm, variables, tm, x, tx = _head()
    want = _nchw(jm.apply(variables, x))
    with torch.no_grad():
        logits = tm.classifier(tm.transform(tx))
        got = tm(tx)
    assert got.dtype == torch.float32 and got.shape == (2, 3) + OUT
    assert logits.std() > 0.5  # real logits, not a bias plateau
    assert rel_err(got.numpy(), want) <= RTOL
    assert torch.equal(got, torch.sigmoid(logits))


@pytest.mark.parametrize("loss", ["focal", "xent"])
def test_seg_head_losses_match_jax(loss):
    jm, variables, tm, x, tx = _head(loss, seed=2)
    target = (np.random.RandomState(3).rand(2, 3, *OUT) < 0.3).astype(np.float32)
    want, _ = jm.apply(variables, x, target, training=True, mutable=["batch_stats"])
    got = tm.train()(tx, _t(target))
    assert set(got) == set(want) == {f"{c}/{loss}" for c in tm.classes}
    for k, v in want.items():
        assert abs(got[k].item() - float(v)) <= RTOL * abs(float(v)), (k, got[k].item(), v)


@pytest.mark.parametrize("alpha,gamma", [(-1.0, 2.0), (0.25, 2.0), (0.5, 1.5)])
def test_sigmoid_losses_match_jax(alpha, gamma):
    rng = np.random.RandomState(4)
    logits = (rng.randn(3, 40) * 4).astype(np.float32)
    target = (rng.rand(3, 40) < 0.4).astype(np.float32)
    want = float(jsegm.sigmoid_focal_loss(logits, target, alpha, gamma))
    got = segm.sigmoid_focal_loss(_t(logits), _t(target), alpha, gamma).item()
    assert abs(got - want) <= RTOL * want
    want = float(jsegm.sigmoid_xent_loss(logits, target))
    assert abs(segm.sigmoid_xent_loss(_t(logits), _t(target)).item() - want) <= RTOL * want


@pytest.mark.parametrize("cin,cout,stride", [(8, 8, 1), (8, 16, 1), (8, 16, 2), (8, 8, 2)])
def test_basic_block_matches_jax(cin, cout, stride):
    x, tx = _bev(5, (2, 10, 12, cin))
    jm = JaxBasicBlock(cout, stride)
    variables = random_variables(jm.init, x, seed=6)
    want = _nchw(jm.apply(variables, x))
    tm = load_bridged(BasicBlock(cin, cout, stride),
                      {col: {"stage0_block0": tree} for col, tree in variables.items()},
                      "decoder_backbone", "decoder.backbone.0.0.")
    assert (tm.downsample is None) == (stride == 1 and cin == cout)
    with torch.no_grad():
        got = tm(tx)
    assert got.shape == (2, cout) + want.shape[2:]
    assert rel_err(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("blocks", [[[2, 8, 2], [1, 12, 2], [2, 16, 1]], [[1, 6, 1], [2, 10, 1]]])
def test_generalized_resnet_matches_jax(blocks):
    cfg = dict(type="GeneralizedResNet", in_channels=6, blocks=blocks)
    x, tx = _bev(7, (2, 12, 10, 6))
    jm = jreg.BACKBONES.build(cfg)
    variables = random_variables(jm.init, x, seed=8)
    want = jm.apply(variables, x)
    tm = load_bridged(treg.BACKBONES.build(cfg), variables, "decoder_backbone",
                      "decoder.backbone.")
    with torch.no_grad():
        got = tm(tx)
    assert len(got) == len(want) == len(blocks)
    for g, w in zip(got, want):
        assert g.shape == _nchw(w).shape
        assert rel_err(g.numpy(), _nchw(w)) <= RTOL


@pytest.mark.parametrize("scale_factor", [1, 2])
def test_lss_fpn_matches_jax(scale_factor):
    cfg = dict(type="LSSFPN", in_indices=[-1, 0], in_channels=[16, 8], out_channels=12,
               scale_factor=scale_factor)
    rng = np.random.RandomState(9)
    xs = [rng.randn(2, 10, 12, 8).astype(np.float32), rng.randn(2, 5, 6, 12).astype(np.float32),
          rng.randn(2, 3, 3, 16).astype(np.float32)]
    jm = jreg.NECKS.build(cfg)
    variables = random_variables(jm.init, xs, seed=10)
    want = _nchw(jm.apply(variables, xs))
    tm = load_bridged(treg.NECKS.build(cfg), variables, "decoder_neck", "decoder.neck.")
    with torch.no_grad():
        got = tm([_t(_nchw(x)) for x in xs])
    assert torch.is_tensor(got) and got.shape == (2, 12, 10 * scale_factor, 12 * scale_factor)
    assert rel_err(got.numpy(), want) <= RTOL


def lss_config():
    """The tiny fused config's camera vtransform as a plain LSSTransform."""
    return dict(tiny_fused_config()["encoders"]["camera"]["vtransform"], type="LSSTransform")


@pytest.mark.parametrize("route", ["in_graph", "lut"])
def test_lss_transform_matches_jax(route):
    """A two-camera jittered rig, B = 2; JAX on its in-graph (fp32) route."""
    cfg = lss_config()
    batch = {k: np.asarray(v) for k, v in make_batch(B=2, seed=3).items()}
    batch.update(jittered_rig(batch, seed=6))
    vt = jreg.VTRANSFORMS.build(cfg)
    dx, bx, nx, frustum, _ = vt.setup_constants()
    assert boundary_margin(frustum, dx, bx, nx, batch) > 1e-4
    mats = {k: jnp.asarray(v) for k, v in batch.items() if k not in ("img", "points")}
    feats = np.random.RandomState(4).randn(2, 2, 4, 8, 24).astype(np.float32)  # [B, N, fH, fW, C]
    pts, msk = jnp.asarray(batch["points"]), jnp.asarray(batch["points_mask"])
    variables = random_variables(vt.init, feats, pts, msk, mats, seed=7)
    want = _nchw(vt.apply(variables, feats, pts, msk, mats))

    tm = load_bridged(treg.VTRANSFORMS.build(cfg), variables, "camera_vtransform",
                      "encoders.camera.vtransform.")
    assert isinstance(tm.depthnet, torch.nn.Conv2d)
    tb = {k: _t(v) for k, v in batch.items() if k != "img"}
    if route == "lut":
        model_cfg = {"encoders": {"camera": {"vtransform": cfg}}}
        tb = add_pool_lut(Config.from_dict({"model": model_cfg}), tb)
    with torch.no_grad():
        got = tm(_t(feats.transpose(0, 1, 4, 2, 3)), tb["points"], tb["points_mask"], tb)
    assert got.shape == (2, 16, 16, 16)
    assert np.std(want) > 0.1
    assert rel_err(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("name", sorted(SEG_CONFIGS))
def test_seg_configs_build(name):
    cfg = load_config(SEG_CONFIGS[name])
    assert _unported_types(cfg.model) == []
    model = build_model(cfg.model, "cpu")
    assert set(model.heads) == {"map"} and len(model.heads["map"].classes) == 6
    assert model.heads["map"].transform.grid.shape == (1, 200, 200, 2)
    keys = model.state_dict().keys()
    assert {"heads.map.classifier.0.weight", "heads.map.classifier.6.bias"} <= set(keys)
    assert ("encoders.camera.vtransform.depthnet.weight" in keys) == (name != "lidar-centerpoint-bev128")
