"""The bf16 compute policy (``runtime/precision.py``) against the JAX
package's ``dtype=bfloat16``, op by op on the CPU.

- The bf16 sparse conv's plain version (the bf16 kernels' contract: bf16
  rows and weights, the product and the epilogue in fp32, one rounding to
  bf16) against ``subm_gather_gemm`` on the same bf16 operands, which also
  sums in fp32 and rounds once: within one bf16 rounding (2^-7 of the
  value) plus the fp32 summation-order gate (1e-5 of the scale). With the
  eval epilogue, against the JAX gather route + ``MaskedBatchNorm(dtype=
  bfloat16)`` + a bf16 residual + ReLU, which rounds three times (the conv,
  the BatchNorm, the residual sum) where the port rounds once: within four
  half-ulps (4 x 2^-8) of the magnitudes rounded along the way.
- The bf16 weight gradient's plain version (fp32 dW of bf16 rows: the
  products exact, fp32 sums) against ``jax.grad`` of the gather route at
  bf16. On the CPU the JAX route rounds dW to bf16 (the dot's transpose
  writes the weight's dtype); the TPU kernel does not
  (``sparse_conv_windowed.py:628``: fp32 dW), nor does the port. So: within
  one bf16 rounding. ``SparseConvFunction`` at bf16 returns that fp32 dW as
  the fp32 weight's gradient, not a bf16-rounded one.
- The JAX package's bf16 decode fault, pinned: its TransFusion coder
  decodes bf16 centers in bf16 arithmetic, so at the flagship's grid (0.6 m
  a cell, the range from -54 m) a center near 54 m lands on a 0.25 m
  lattice. The port decodes in fp32 at either compute dtype.
- The policy's pieces: ``precision.compute_dtype`` of the configs, the
  norms' and dropout's dtypes, and every served config built at bf16 with
  fp32 parameters and the fp32 model's state dict, key for key and dtype
  for dtype.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.core.coders import TransFusionBBoxCoder as JaxTransFusionCoder
from bevfusion_tpu.models.sparse_encoder import MaskedBatchNorm as JaxMaskedBN
from bevfusion_tpu.ops import sparse_conv as jsp
from bevfusion_tpu_torch.config import load_config
from bevfusion_tpu_torch.core.coders import TransFusionBBoxCoder
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.models.layers import Dropout, LayerNorm, set_dropout_generator
from bevfusion_tpu_torch.models.sparse_encoder import MaskedBatchNorm
from bevfusion_tpu_torch.ops import sparse_conv as sp
from bevfusion_tpu_torch.runtime import flagship, precision

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7  # one bf16 rounding, relative (8 significant bits)
HALF_ULP = 2.0 ** -8
FP32_ORDER = 1e-5  # of the scale: two fp32 sums of the same products in another order


def _bf16(a):
    """numpy fp32 -> (torch bf16, jax bf16) of the same values."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def _operands(cin, cout, strided, seed=0):
    """Sites on a 24 x 24 x 10 grid (half occupied), the gather table
    (offset-major for the port, site-major for JAX), bf16 feats, a weight
    and an output gradient."""
    rng = np.random.RandomState(seed + cin * cout)
    grid = sp.SparseGrid(24, 24, 10)
    n = grid.size // 2
    ids = torch.from_numpy(np.sort(rng.choice(grid.size, n, replace=False)).astype(np.int32))
    ids = torch.cat([ids, torch.full((40,), grid.size, dtype=torch.int32)])
    if strided:
        og = sp.conv_out_shape(grid, 3, 2, 1)
        out_ids, _ = sp.downsample_sites(ids, grid, 3, 2, 1, n // 3)
        nbr = sp.build_conv_rulebook(ids, out_ids, grid, og, 3, 2, 1)
    else:
        nbr = sp.build_subm_rulebook(ids, grid)
    feats = rng.randn(ids.shape[0], cin).astype(np.float32)
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    dout = rng.randn(nbr.shape[1], cout).astype(np.float32)
    return nbr, feats, w, dout


SHAPES = [(5, 16, False), (16, 16, False), (16, 32, True), (32, 32, False)]


@pytest.mark.parametrize("cin,cout,strided", SHAPES)
def test_bf16_sparse_conv_plain_matches_jax_gather(cin, cout, strided):
    nbr, feats, w, _ = _operands(cin, cout, strided)
    (tf, jf), (tw, jw) = _bf16(feats), _bf16(w)
    got = sp.sparse_conv_plain(tf, nbr, tw)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax.jit(jsp.subm_gather_gemm)(jf, jnp.asarray(nbr.t().numpy()), jw))
    assert want.dtype == jnp.bfloat16
    got, want = got.float().numpy(), want.astype(np.float32)
    scale = max(np.abs(want).max(), 1.0)
    assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + FP32_ORDER * scale)
    assert np.abs(want).max() > 0.5


@pytest.mark.parametrize("cin,cout,strided", SHAPES[1:])
def test_bf16_sparse_conv_epilogue_matches_jax_batchnorm(cin, cout, strided):
    """The fused eval epilogue at bf16: relu(conv * scale + shift + residual)
    in fp32 with one rounding, against JAX's conv (bf16), MaskedBatchNorm at
    bf16 from its running statistics and the bf16 residual sum."""
    nbr, feats, w, _ = _operands(cin, cout, strided, seed=1)
    rng = np.random.RandomState(cin + cout)
    mean, var = rng.randn(cout).astype(np.float32) * 0.3, rng.rand(cout).astype(np.float32) + 0.5
    gamma, beta = rng.rand(cout).astype(np.float32) + 0.5, rng.randn(cout).astype(np.float32)
    (tf, jf), (tw, jw) = _bf16(feats), _bf16(w)
    tr, jr = _bf16(rng.randn(nbr.shape[1], cout))
    bn = MaskedBatchNorm(cout, eps=1e-3).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
    with torch.no_grad():
        scale, shift = bn.fold()
        got = sp.sparse_conv_plain(tf, nbr, tw, scale, shift, tr, relu=True)
    assert got.dtype == torch.bfloat16

    jbn = JaxMaskedBN(eps=1e-3, dtype=jnp.bfloat16)
    variables = {"params": {"scale": gamma, "bias": beta},
                 "batch_stats": {"mean": mean, "var": var}}

    @jax.jit
    def jax_path(f, table, wt, res):
        y = jsp.subm_gather_gemm(f, table, wt)  # bf16, one rounding
        y = jbn.apply(variables, y, jnp.ones(y.shape[:1], bool), False)  # bf16, the second
        return y, jnp.maximum(y + res, 0)  # the residual sum in bf16, the third

    conv = np.asarray(jax.jit(jsp.subm_gather_gemm)(jf, jnp.asarray(nbr.t().numpy()), jw),
                      np.float32)
    bn_out, want = (np.asarray(a, np.float32) for a in jax_path(
        jf, jnp.asarray(nbr.t().numpy()), jw, jr))
    got = got.float().numpy()
    sc = scale.numpy()
    res = tr.float().numpy()
    tol = 4 * HALF_ULP * (np.abs(conv * sc) + np.abs(bn_out) + np.abs(bn_out + res)) + 1e-6
    assert np.all(np.abs(got - want) <= tol)
    assert (got > 0).mean() > 0.2


@pytest.mark.parametrize("cin,cout,strided", SHAPES)
def test_bf16_weight_gradient_plain_matches_jax_grad(cin, cout, strided):
    nbr, feats, w, dout = _operands(cin, cout, strided, seed=2)
    (tf, jf), (td, jd) = _bf16(feats), _bf16(dout)
    got = sp.sparse_conv_dw_plain(tf, nbr, td)
    assert got.dtype == torch.float32

    def loss(wt):
        y = jsp.subm_gather_gemm(jf, jnp.asarray(nbr.t().numpy()), wt.astype(jnp.bfloat16))
        return jnp.sum(y.astype(jnp.float32) * jd.astype(jnp.float32))

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(w)))  # fp32 of a bf16 dW
    assert np.array_equal(want, want.astype(jnp.bfloat16).astype(np.float32))  # rounded
    got = got.numpy()
    scale = max(np.abs(want).max(), 1.0)
    assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + FP32_ORDER * scale)
    assert not np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))  # fp32


def test_sparse_conv_function_bf16_keeps_the_fp32_weight_gradient():
    """bf16 features, the fp32 weight parameter: the Function casts the
    weight inside, so the weight's gradient is the plain dW in fp32 (a cast
    outside would round it to bf16), and the feature gradient is bf16."""
    nbr, feats, w, dout = _operands(16, 16, False, seed=3)
    x = torch.from_numpy(feats).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = sp.SparseConvFunction.apply(x, wt, nbr, None)
    assert y.dtype == torch.bfloat16
    y.backward(torch.from_numpy(dout).bfloat16())
    assert wt.grad.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    want = sp.sparse_conv_dw_plain(x.detach(), nbr, torch.from_numpy(dout).bfloat16())
    assert torch.equal(wt.grad, want)
    assert not torch.equal(wt.grad, wt.grad.bfloat16().float())


def _flagship_coder_cfg():
    cfg = dict(load_config(flagship.FLAGSHIP_CONFIG).model["heads"]["object"]["bbox_coder"])
    cfg.pop("type")
    return cfg


def test_jax_bf16_decode_rounds_centers_to_a_lattice():
    """The JAX fault the port does not copy: bf16 centers (the head adds the
    query positions in bf16, heads/transfusion.py:139) decoded in bf16 at
    the flagship's grid come out bf16, a center near 54 m on a 0.25 m
    lattice (bf16 keeps 8 significant bits; 0.6 m a cell); the port's
    decode of the same values in fp32 is 0.6 m x center - 54 m to fp32."""
    cfg = _flagship_coder_cfg()
    assert cfg["out_size_factor"] * cfg["voxel_size"][0] == pytest.approx(0.6)
    P = 64
    rng = np.random.RandomState(0)
    center = np.stack([175 + 4 * rng.rand(P), 90 * rng.rand(P)]).astype(np.float32)[None]
    heat = rng.rand(1, 10, P).astype(np.float32)
    rot, dim = rng.randn(1, 2, P).astype(np.float32), rng.randn(1, 3, P).astype(np.float32)
    height, vel = rng.randn(1, 1, P).astype(np.float32), rng.randn(1, 2, P).astype(np.float32)
    args = (heat, rot, dim, center, height, vel)
    out = JaxTransFusionCoder(**cfg).decode(*(jnp.asarray(a).astype(jnp.bfloat16) for a in args))
    assert out["bboxes"].dtype == jnp.bfloat16
    cx = np.asarray(out["bboxes"][0, :, 0], np.float64)
    assert np.all((cx > 50) & (cx < 56))
    np.testing.assert_array_equal(cx * 4, np.round(cx * 4))  # a 0.25 m lattice
    c_bf16 = np.asarray(jnp.asarray(center[0, 0]).astype(jnp.bfloat16), np.float64)
    np.testing.assert_array_equal(c_bf16, np.round(c_bf16))  # whole cells from 128 on
    got = TransFusionBBoxCoder(**cfg).decode(*(torch.from_numpy(a) for a in args))["bboxes"]
    assert got.dtype == torch.float32
    want = center[0, 0].astype(np.float64) * 0.6 - 54.0
    np.testing.assert_allclose(got[0, :, 0].numpy(), want, atol=1e-5)
    assert np.abs(got[0, :, 0].numpy() - cx).max() > 0.1  # the lattice moved them


def test_compute_dtype_of_the_configs():
    assert precision.config_dtype(load_config(flagship.FLAGSHIP_CONFIG)) == torch.bfloat16
    cfg = load_config(flagship.FLAGSHIP_CONFIG, overrides={"precision.compute_dtype": "float32"})
    assert precision.config_dtype(cfg) == torch.float32
    assert precision.config_dtype({}) == torch.float32
    assert precision.parse_dtype("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError):
        precision.parse_dtype("float16")
    assert precision.dtype_name(torch.bfloat16) == "bfloat16"


def test_norms_and_dropout_at_bf16():
    """LayerNorm and the masked BatchNorm return their input's dtype with
    fp32 statistics (within one bf16 rounding of the fp32 result); a bf16
    dropout draws the fp32 run's mask."""
    x = torch.randn(4, 6, 32, generator=torch.Generator().manual_seed(0)) * 3 + 1
    ln = LayerNorm(32, eps=1e-6)
    got, want = ln(x.bfloat16()), ln(x.bfloat16().float())
    assert got.dtype == torch.bfloat16
    assert torch.all((got.float() - want).abs() <= HALF_ULP * want.abs() + 1e-7)
    bn = MaskedBatchNorm(32).train()
    mask = torch.rand(24, generator=torch.Generator().manual_seed(1)) < 0.7
    rows = x.reshape(24, 32).bfloat16()
    y = bn.sparse(rows, mask)
    assert y.dtype == torch.bfloat16 and bn.running_mean.dtype == torch.float32
    ref = MaskedBatchNorm(32).train().sparse(rows.float(), mask)
    assert torch.all((y.float() - ref).abs() <= HALF_ULP * ref.abs() + 1e-7)
    assert not y[~mask].any()
    drop = Dropout(0.5).train()
    masks = []
    for dtype in (torch.float32, torch.bfloat16):
        set_dropout_generator(drop, torch.Generator().manual_seed(2))
        masks.append(drop(torch.ones(64, 16, dtype=dtype)) != 0)
    assert torch.equal(*masks)


SERVED = [flagship.FLAGSHIP_CONFIG, flagship.LIDAR_SLICE_CONFIG,
          "configs/nuscenes/det/transfusion/secfpn/lidar/voxelnet.yaml",
          *flagship.SEG_CONFIGS.values(), *flagship.DET_CAMERA_CONFIGS.values(),
          *flagship.PILLAR_CONFIGS.values()]


def test_served_configs_are_eleven():
    assert len(set(SERVED)) == 11


@pytest.mark.parametrize("path", SERVED,
                         ids=[os.path.relpath(p, flagship.REPO_ROOT) for p in SERVED])
def test_served_config_builds_at_bf16_with_the_fp32_state_dict(path):
    cfg = load_config(path)
    torch.manual_seed(0)
    m16 = build_model(cfg.model, "cpu", torch.bfloat16)
    torch.manual_seed(0)
    m32 = build_model(cfg.model, "cpu")
    assert m16.compute_dtype == torch.bfloat16 and m32.compute_dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    s16, s32 = m16.state_dict(), m32.state_dict()
    assert list(s16) == list(s32)
    assert all(s16[k].dtype == s32[k].dtype and torch.equal(s16[k], s32[k]) for k in s32)
