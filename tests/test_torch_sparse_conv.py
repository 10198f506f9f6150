"""Port parity: bevfusion_tpu_torch.ops.sparse_conv against the JAX rulebooks
and gather-GEMM (the CUDA kernel is held to the plain version in
test_torch_cuda.py).

Rulebooks, site lists and dense scatters must be bit-equal. The gather-GEMM
(fp32, only the summation order differs) must agree to
max|d| <= 1e-5 * max(|ref|, 1).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models.sparse_encoder import MaskedBatchNorm as JaxMaskedBN
from bevfusion_tpu.ops import sparse_conv as jsp
from bevfusion_tpu.ops import voxelize as jvox
from bevfusion_tpu.runtime.flagship import synthetic_lidar_scan
from bevfusion_tpu_torch.models.sparse_encoder import MaskedBatchNorm
from bevfusion_tpu_torch.ops import sparse_conv as sp

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _ring_sites():
    """A beam-model lidar scan voxelized on a small grid: sorted ids with
    sentinel padding, the encoder's real input layout."""
    pcr = (-12.0, -12.0, -3.0, 12.0, 12.0, 3.0)
    vs = (0.3, 0.3, 0.25)
    pts, mask = synthetic_lidar_scan(40000, pcr, seed=3)
    out = jvox.voxelize(jnp.asarray(pts), jnp.asarray(mask), vs, pcr, 10, 3000)
    grid = jsp.SparseGrid(80, 80, 25)
    ids = np.array(jsp.lin_ids(out.coords, grid, out.mask))
    assert 1000 < int(np.asarray(out.mask).sum()) < 3000
    return ids, grid


@functools.lru_cache(maxsize=None)
def _corner_sites():
    """A fully occupied corner block: dense neighborhoods and grid edges."""
    grid = jsp.SparseGrid(10, 9, 7)
    xs, ys, zs = np.meshgrid(np.arange(5), np.arange(4), np.arange(7), indexing="ij")
    ids = np.sort(((xs * grid.Y + ys) * grid.Z + zs).reshape(-1)).astype(np.int32)
    return np.concatenate([ids, np.full(20, grid.size, np.int32)]), grid


SITES = {"ring": _ring_sites, "corner": _corner_sites}
GEOMETRIES = [  # (kernel, stride, padding, cap_out as a fraction of the input cap)
    (3, 2, 1, 1.0),
    (3, 2, (1, 1, 0), 1.0),
    ((1, 1, 3), (1, 1, 2), 0, 1.0),
    (3, 2, 1, 0.2),  # truncation: the smallest output ids survive
]


@pytest.mark.parametrize("name", sorted(SITES))
def test_subm_rulebook_bit_equal(name):
    ids, grid = SITES[name]()
    want = np.asarray(jsp.build_subm_rulebook(jnp.asarray(ids), grid, 3, offset_major=True))
    got = sp.build_subm_rulebook(torch.from_numpy(ids), sp.SparseGrid(*grid), 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > ids.shape[0]  # real neighbors found


@pytest.mark.parametrize("name", sorted(SITES))
@pytest.mark.parametrize("k,s,p,frac", GEOMETRIES)
def test_downsample_and_conv_rulebook_bit_equal(name, k, s, p, frac):
    ids, grid = SITES[name]()
    cap_out = max(1, int(ids.shape[0] * frac))
    og = jsp.conv_out_shape(grid, k, s, p)
    assert tuple(sp.conv_out_shape(sp.SparseGrid(*grid), k, s, p)) == tuple(og)
    w_ids, w_mask = jsp.downsample_sites(jnp.asarray(ids), grid, k, s, p, cap_out)
    w_nbr = jsp.build_conv_rulebook(jnp.asarray(ids), w_ids, grid, og, k, s, p,
                                    offset_major=True)
    tg, tog = sp.SparseGrid(*grid), sp.SparseGrid(*og)
    g_ids, g_mask = sp.downsample_sites(torch.from_numpy(ids), tg, k, s, p, cap_out)
    g_nbr = sp.build_conv_rulebook(torch.from_numpy(ids), g_ids, tg, tog, k, s, p)
    np.testing.assert_array_equal(g_ids.numpy(), np.asarray(w_ids))
    np.testing.assert_array_equal(g_mask.numpy(), np.asarray(w_mask))
    np.testing.assert_array_equal(g_nbr.numpy(), np.asarray(w_nbr))
    assert bool(np.asarray(w_mask).any())


@pytest.mark.parametrize("name", sorted(SITES))
def test_dense_scatters_bit_equal(name):
    ids, grid = SITES[name]()
    rng = np.random.RandomState(0)
    mask = ids < grid.size
    feats = rng.randn(ids.shape[0], 3).astype(np.float32)
    tg = sp.SparseGrid(*grid)
    t_ids, t_feats, t_mask = map(torch.from_numpy, (ids, feats, mask))
    for jfn, tfn in ((jsp.to_dense, sp.to_dense), (jsp.to_dense_zmajor, sp.to_dense_zmajor)):
        want = np.asarray(jfn(jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(mask), grid))
        np.testing.assert_array_equal(tfn(t_feats, t_ids, t_mask, tg).numpy(), want)
    want = np.asarray(jsp.occupancy_zmajor(jnp.asarray(ids), jnp.asarray(mask), grid))
    np.testing.assert_array_equal(sp.occupancy_zmajor(t_ids, t_mask, tg).numpy(), want)
    coords = np.stack([np.asarray(a) for a in jsp.unlin_ids(jnp.asarray(ids), grid)], -1)
    np.testing.assert_array_equal(
        sp.lin_ids(torch.from_numpy(coords), tg, t_mask).numpy(),
        np.asarray(jsp.lin_ids(jnp.asarray(coords), grid, jnp.asarray(mask))))


def _conv_case(cin, cout, strided, seed=0):
    """Ring-scan rulebook + random features/weights for one conv shape."""
    ids, grid = _ring_sites()
    rng = np.random.RandomState(seed)
    feats = (rng.randn(ids.shape[0], cin) * (ids < grid.size)[:, None]).astype(np.float32)
    if strided:
        og = jsp.conv_out_shape(grid, 3, 2, 1)
        out_ids, _ = jsp.downsample_sites(jnp.asarray(ids), grid, 3, 2, 1, ids.shape[0] // 2)
        nbr = jsp.build_conv_rulebook(jnp.asarray(ids), out_ids, grid, og, 3, 2, 1,
                                      offset_major=True)
        valid = np.asarray(out_ids) < og.size
    else:
        nbr = jsp.build_subm_rulebook(jnp.asarray(ids), grid, 3, offset_major=True)
        valid = ids < grid.size
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    return feats, np.array(nbr), w, valid  # a writable copy for torch.from_numpy


@pytest.mark.parametrize("cin,cout,strided", [(16, 16, False), (16, 32, True),
                                              (5, 16, False)])
def test_plain_gather_gemm_matches_jax(cin, cout, strided):
    feats, nbr, w, _ = _conv_case(cin, cout, strided)
    want = np.asarray(jsp.subm_gather_gemm(jnp.asarray(feats), jnp.asarray(nbr.T),
                                           jnp.asarray(w)))
    got = sp.sparse_conv_plain(torch.from_numpy(feats), torch.from_numpy(nbr),
                               torch.from_numpy(w)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * max(np.max(np.abs(want)), 1.0)
    # the wrapper takes the plain version for CPU tensors (no launch)
    launches = sp.sparse_conv.launches
    via = sp.sparse_conv(torch.from_numpy(feats), torch.from_numpy(nbr), torch.from_numpy(w))
    np.testing.assert_array_equal(via.numpy(), got)
    assert sp.sparse_conv.launches == launches


def test_epilogue_matches_unfused_masked_bn_residual_relu():
    """Folded BN + residual + ReLU against JAX MaskedBatchNorm -> add ->
    ReLU, on valid rows (padded rows of the fused path hold relu(shift))."""
    C = 16
    feats, nbr, w, valid = _conv_case(C, C, False, seed=1)
    rng = np.random.RandomState(2)
    gamma, beta = rng.normal(1, 0.2, C), rng.normal(0, 0.2, C)
    mean, var = rng.normal(0, 0.2, C), rng.uniform(0.5, 1.5, C)
    residual = rng.randn(*feats.shape).astype(np.float32)

    y = jsp.subm_gather_gemm(jnp.asarray(feats), jnp.asarray(nbr.T), jnp.asarray(w))
    bn_vars = {"params": {"scale": jnp.asarray(gamma, jnp.float32),
                          "bias": jnp.asarray(beta, jnp.float32)},
               "batch_stats": {"mean": jnp.asarray(mean, jnp.float32),
                               "var": jnp.asarray(var, jnp.float32)}}
    y = JaxMaskedBN(eps=1e-3).apply(bn_vars, y, jnp.asarray(valid), training=False)
    want = np.maximum(np.asarray(y) + residual, 0.0)

    bn = MaskedBatchNorm(C, eps=1e-3).eval()
    with torch.no_grad():
        for t, v in ((bn.weight, gamma), (bn.bias, beta), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.as_tensor(v))
        scale, shift = bn.fold()
        got = sp.sparse_conv_plain(torch.from_numpy(feats), torch.from_numpy(nbr),
                                   torch.from_numpy(w), scale, shift,
                                   torch.from_numpy(residual), relu=True).numpy()
    ref = want[valid]
    assert np.max(np.abs(got[valid] - ref)) <= 1e-5 * max(np.max(np.abs(ref)), 1.0)
