"""Port parity of the camera branch's modules: Swin (with window padding
and shifted windows), GeneralizedLSSFPN, DepthLSSTransform (both pool
routes) and ConvFuser, each against the JAX module with the same random
weights (carried across by the bridge). fp32 on both sides:
max|d| <= 1e-4 * max(|want|, 1) per output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevfusion_tpu.models  # noqa: F401  (registers the JAX modules)
import bevfusion_tpu_torch.models  # noqa: F401  (registers the port's modules)
from bevfusion_tpu import registry as jreg
from bevfusion_tpu.models.swin import _relative_position_index
from bevfusion_tpu_torch import registry as treg
from bevfusion_tpu_torch.config import Config
from bevfusion_tpu_torch.runtime.flagship import add_pool_lut
from tests.test_bevfusion_model import make_batch, tiny_fused_config
from tests.torch_port_helpers import (boundary_margin, jittered_rig, load_bridged,
                                      random_variables, rel_err)

torch.set_num_threads(2)


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def test_swin_with_padding_and_shift_matches_jax():
    """36 x 60 images give 9 x 15 tokens: window 4 pads them to 12 x 16 and
    every second block shifts; merging pads the odd 9 to 10."""
    cfg = dict(type="SwinTransformer", embed_dims=16, depths=[2, 2, 2], num_heads=[1, 2, 4],
               window_size=4, out_indices=[0, 1, 2], drop_path_rate=0.0)
    x = np.random.RandomState(0).rand(2, 36, 60, 3).astype(np.float32)
    jm = jreg.BACKBONES.build(cfg)
    variables = random_variables(jm.init, x, seed=4)
    want = jm.apply(variables, x)
    tm = load_bridged(treg.BACKBONES.build(cfg), variables, "camera_backbone",
                      "encoders.camera.backbone.")
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous())
    assert [tuple(g.shape) for g in got] == [(2, 16, 9, 15), (2, 32, 5, 8), (2, 64, 3, 4)]
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), _nchw(w)) <= 1e-4
    rpi = tm.stages[0].blocks[1].attn.w_msa.relative_position_index
    assert rpi.dtype == torch.int64 and np.array_equal(rpi.numpy(), _relative_position_index(4))


@pytest.mark.parametrize("align", [False, True])
def test_generalized_lss_fpn_matches_jax(align):
    cfg = dict(type="GeneralizedLSSFPN", in_channels=[8, 16, 32], out_channels=12, num_outs=3,
               upsample_cfg={"mode": "bilinear", "align_corners": align})
    rng = np.random.RandomState(1)
    xs = [rng.randn(2, h, w, c).astype(np.float32)
          for (h, w), c in zip([(9, 15), (5, 8), (3, 4)], cfg["in_channels"])]
    jm = jreg.NECKS.build(cfg)
    variables = random_variables(jm.init, xs, seed=5)
    want = jm.apply(variables, xs)
    tm = load_bridged(treg.NECKS.build(cfg), variables, "camera_neck", "encoders.camera.neck.")
    with torch.no_grad():
        got = tm([torch.from_numpy(_nchw(x)).contiguous() for x in xs])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (2, 12) + w.shape[1:3]
        assert rel_err(g.numpy(), _nchw(w)) <= 1e-4


def test_conv_fuser_matches_jax():
    cfg = dict(type="ConvFuser", in_channels=[6, 10], out_channels=8)
    rng = np.random.RandomState(2)
    xs = [rng.randn(1, 12, 12, c).astype(np.float32) for c in cfg["in_channels"]]
    jm = jreg.FUSERS.build(cfg)
    variables = random_variables(jm.init, xs, seed=6)
    want = jm.apply(variables, xs)
    tm = load_bridged(treg.FUSERS.build(cfg), variables, "fuser_module", "fuser.")
    with torch.no_grad():
        got = tm([torch.from_numpy(_nchw(x)).contiguous() for x in xs])
    assert rel_err(got.numpy(), _nchw(want)) <= 1e-4


@pytest.mark.parametrize("route", ["in_graph", "lut"])
def test_depth_lss_transform_matches_jax(route):
    """The tiny fused config's DepthLSS on a jittered two-camera rig, JAX on
    its in-graph (fp32) route; the port on either route."""
    cfg = tiny_fused_config()["encoders"]["camera"]["vtransform"]
    batch = {k: np.asarray(v) for k, v in make_batch(B=2, seed=3).items()}
    batch.update(jittered_rig(batch, seed=6))
    vt = jreg.VTRANSFORMS.build(cfg)
    dx, bx, nx, frustum, _ = vt.setup_constants()
    assert boundary_margin(frustum, dx, bx, nx, batch) > 1e-4
    mats = {k: jnp.asarray(v) for k, v in batch.items() if k not in ("img", "points")}
    feats = np.random.RandomState(4).randn(2, 2, 4, 8, 24).astype(np.float32)  # [B, N, fH, fW, C]
    pts, msk = jnp.asarray(batch["points"]), jnp.asarray(batch["points_mask"])
    variables = random_variables(vt.init, feats, pts, msk, mats, seed=7)
    want = vt.apply(variables, feats, pts, msk, mats)

    tm = load_bridged(treg.VTRANSFORMS.build(cfg), variables, "camera_vtransform",
                      "encoders.camera.vtransform.")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items() if k != "img"}
    if route == "lut":
        tb = add_pool_lut(Config.from_dict({"model": tiny_fused_config()}), tb)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats.transpose(0, 1, 4, 2, 3)).contiguous(), tb["points"],
                 tb["points_mask"], tb)
    assert got.shape == (2, 16, 16, 16)
    assert np.std(np.asarray(want)) > 0.1
    assert rel_err(got.numpy(), _nchw(want)) <= 1e-4
