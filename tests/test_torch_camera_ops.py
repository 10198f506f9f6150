"""Port parity of the camera branch's ops: the grid copies,
``resize_bilinear``, cell ids from ``get_geometry``, the pool's intervals
against the JAX host LUT, the plain pool and ``rasterize_depth``.

Cell assignments are compared across routes and packages bit for bit on
a jittered rig whose frustum points all lie more than 1e-4 m from a cell
boundary (an axis-aligned rig puts points exactly on boundaries, where two
fp32 routes may pick adjacent cells). The pool sums are fp32 in both
packages in different orders: max|d| <= 1e-4 * max(|want|, 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models.layers import resize_bilinear as jax_resize
from bevfusion_tpu.models.vtransforms import get_geometry as jax_geometry
from bevfusion_tpu.models.vtransforms import rasterize_depth as jax_rasterize
from bevfusion_tpu.ops import bev_pool as jax_pool
from bevfusion_tpu.ops import bev_pool_lut as jax_lut
from bevfusion_tpu.ops import grid as jax_grid
from bevfusion_tpu_torch.models.layers import resize_bilinear
from bevfusion_tpu_torch.models.vtransforms import (DepthLSSTransform, build_pool_lut,
                                                     get_geometry, rasterize_depth)
from bevfusion_tpu_torch.ops import bev_pool as pool
from bevfusion_tpu_torch.ops import grid
from bevfusion_tpu_torch.runtime.flagship import synthetic_calibration
from tests.torch_port_helpers import boundary_margin, jittered_rig, rel_err

torch.set_num_threads(2)

IMAGE, FEATURE, DBOUND = (32, 48), (4, 6), (1.0, 20.0, 1.0)
BOUNDS = ((-20.0, 20.0, 0.5), (-20.0, 20.0, 0.5), (-10.0, 10.0, 20.0))
RIG_SEED = 16  # a jitter whose frustum points all keep >= 1e-4 m from cell boundaries


def _rig(B=2, N=3):
    """Grid constants, frustum and the jittered ring rig of B samples."""
    dx, bx, nx = grid.gen_dx_bx(*BOUNDS)
    frustum = grid.create_frustum(IMAGE, FEATURE, DBOUND)
    mats = jittered_rig(synthetic_calibration(B, N, IMAGE), RIG_SEED)
    assert boundary_margin(frustum, dx, bx, nx, mats) > 1e-4
    return dx, bx, nx, frustum, mats


def _geometry_args(mats):
    return (mats["camera2lidar"], mats["camera_intrinsics"][..., :3, :3],
            mats["img_aug_matrix"], mats["lidar_aug_matrix"])


@pytest.mark.parametrize("bounds,image,feature,dbound", [
    (BOUNDS, IMAGE, FEATURE, DBOUND),
    (((-54.0, 54.0, 0.3), (-54.0, 54.0, 0.3), (-10.0, 10.0, 20.0)), (256, 704), (32, 88),
     (1.0, 60.0, 0.5)),
])
def test_grid_copy_equals_jax(bounds, image, feature, dbound):
    for got, want in zip(grid.gen_dx_bx(*bounds), jax_grid.gen_dx_bx(*bounds)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got = grid.create_frustum(image, feature, dbound)
    want = jax_grid.create_frustum(image, feature, dbound)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _port_lut(dx, bx, nx, frustum, mats):
    return build_pool_lut(torch.from_numpy(frustum), dx, bx, nx,
                          {k: torch.from_numpy(v) for k, v in mats.items()})


def _jax_host_cell_ids(dx, bx, nx, frustum, mats):
    return jax_lut.build_pool_lut_np(frustum, dx, bx, nx, *_geometry_args(mats))["cell_ids"]


def test_pool_lut_cell_ids_match_jax_host_lut():
    dx, bx, nx, frustum, mats = _rig()
    got = _port_lut(dx, bx, nx, frustum, mats)["cell_ids"]
    want = _jax_host_cell_ids(dx, bx, nx, frustum, mats)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    num_cells = int(np.prod(nx))
    assert 0 < (want == num_cells).mean() < 0.8  # in and out of the grid both occur


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("src,dst", [((5, 7), (10, 14)), ((5, 7), (8, 11)), ((9, 15), (5, 8))])
def test_resize_bilinear_matches_jax(align, src, dst):
    x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)  # NHWC
    want = np.asarray(jax_resize(jnp.asarray(x), dst, align_corners=align))
    got = resize_bilinear(torch.from_numpy(x.transpose(0, 3, 1, 2)), dst, align)
    assert rel_err(got.numpy().transpose(0, 2, 3, 1), want) <= 1e-6


def _port_cells(dx, bx, nx, frustum, mats):
    geom = get_geometry(torch.from_numpy(frustum),
                        *(torch.from_numpy(a) for a in _geometry_args(mats)))
    return geom, pool.cell_ids_from_geometry(geom, dx, bx, nx)


def test_cell_ids_match_jax():
    dx, bx, nx, frustum, mats = _rig()
    want_geom = jax_geometry(jnp.asarray(frustum), *(jnp.asarray(a) for a in _geometry_args(mats)))
    want_ids, want_valid = jax_pool.cell_ids_from_geometry(want_geom, jnp.asarray(dx),
                                                           jnp.asarray(bx), nx)
    geom, (ids, valid) = _port_cells(dx, bx, nx, frustum, mats)
    assert float(np.abs(geom.numpy() - np.asarray(want_geom)).max()) <= 1e-4
    assert np.array_equal(valid.numpy(), np.asarray(want_valid))
    assert 0.2 < valid.float().mean() < 1.0  # in and out of the grid both occur
    assert np.array_equal(ids.numpy()[valid.numpy()], np.asarray(want_ids)[valid.numpy()])


def test_in_graph_and_lut_intervals_are_bit_equal():
    """The port's LUT (its fp32 torch geometry) against ``build_intervals``
    on the cell ids of the JAX package's host (numpy) LUT."""
    dx, bx, nx, frustum, mats = _rig()
    num_cells = int(np.prod(nx))
    lut = _port_lut(dx, bx, nx, frustum, mats)
    ids = torch.from_numpy(_jax_host_cell_ids(dx, bx, nx, frustum, mats))
    D, fH, fW = frustum.shape[:3]
    ids = ids.view(ids.shape[0], -1, D, fH, fW)
    got = pool.build_intervals(ids, ids < num_cells, num_cells)
    for name, t in got._asdict().items():
        assert t.dtype == lut[name].dtype == torch.int32 and torch.equal(t, lut[name]), name
    assert (got.interval_lengths > 1).any() and (got.interval_lengths == 1).any()
    # intervals are the runs of the sorted ids, cells ascending over both samples
    assert int(got.interval_lengths.sum()) == got.ranks_depth.numel() == int((ids < num_cells).sum())
    assert (got.interval_cells[1:] > got.interval_cells[:-1]).all()
    assert int(got.interval_cells.max()) >= num_cells  # sample 1 lands in its own block


def test_pool_rejects_a_lut_of_another_batch():
    """A LUT built for two samples does not pool a batch of one: the plain
    pool and the kernel would read past the inputs."""
    vt = DepthLSSTransform(in_channels=8, out_channels=4, image_size=IMAGE, feature_size=FEATURE,
                           xbound=BOUNDS[0], ybound=BOUNDS[1], zbound=BOUNDS[2], dbound=DBOUND)
    dx, bx, nx, frustum, mats = _rig(B=2)
    tmats = {k: torch.from_numpy(v) for k, v in mats.items()}
    lut = build_pool_lut(vt.frustum, vt.dx, vt.bx, vt.nx, tmats)
    depth = torch.rand(2, 3, vt.D, *FEATURE).softmax(2)
    ctx = torch.randn(2, 3, *FEATURE, 4)
    want = vt.pool(depth, ctx, tmats)  # in-graph route
    assert torch.equal(vt.pool(depth, ctx, dict(tmats, pool_lut=lut)), want)
    with pytest.raises(ValueError, match="pool_lut"):
        vt.pool(depth[:1], ctx[:1], dict(tmats, pool_lut=lut))


@pytest.mark.parametrize("B,Z", [(2, 1), (2, 2)])
def test_plain_pool_matches_jax(B, Z):
    rng = np.random.RandomState(Z)
    N, D, fH, fW, C, X, Y = 3, 7, 4, 6, 5, 9, 8
    depth = rng.rand(B, N, D, fH, fW).astype(np.float32)
    depth /= depth.sum(2, keepdims=True)
    ctx = rng.randn(B, N, fH, fW, C).astype(np.float32)
    ids = rng.randint(0, Z * X * Y, (B, N, D, fH, fW)).astype(np.int32)
    valid = rng.rand(B, N, D, fH, fW) < 0.8
    want = jax_pool.lss_bev_pool(jnp.asarray(depth), jnp.asarray(ctx), jnp.asarray(ids),
                                 jnp.asarray(valid), Z, X, Y)
    want = np.asarray(want).transpose(0, 3, 1, 2)  # [B, X, Y, Z*C] -> [B, Z*C, X, Y]
    iv = pool.build_intervals(torch.from_numpy(ids), torch.from_numpy(valid), Z * X * Y)
    launches = pool.bev_pool.launches
    got = pool.bev_pool(torch.from_numpy(depth), torch.from_numpy(ctx), iv, Z, X, Y)
    assert pool.bev_pool.launches == launches  # a CPU tensor takes the plain version
    assert got.shape == (B, Z * C, X, Y)
    assert (want == 0).any() and (want != 0).mean() > 0.5  # empty cells and filled ones
    assert rel_err(got.numpy(), want) <= 1e-4


def test_rasterize_depth_matches_jax_exactly():
    """Points on a 1/64 m lattice and integer-valued camera matrices keep
    every product and sum exact, so both packages must give the same bits:
    the test pins the scatter-min, the truncation and the masks."""
    rng = np.random.RandomState(0)
    B, N, P, image = 2, 2, 600, (32, 64)
    intr = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = 30.0
    intr[..., 0, 2], intr[..., 1, 2] = 32.0, 16.0
    cam2lidar = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    cam2lidar[:, 1, :3, :3] = np.diag([-1.0, 1.0, -1.0])  # camera 1 looks backwards
    l2i = np.einsum("bnij,bnjk->bnik", intr, np.linalg.inv(cam2lidar)).astype(np.float32)
    points = np.round(rng.uniform(-15, 15, (B, P, 5)) * 64).astype(np.float32) / 64
    points[:, P // 2:, :3] = points[:, :P // 2, :3] * 2  # same pixels, farther: min wins
    mask = rng.rand(B, P) < 0.9
    eye = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    la = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    want = np.asarray(jax_rasterize(*(jnp.asarray(a) for a in (points, mask, l2i, eye, la)),
                                    image))[..., 0]
    got = rasterize_depth(*(torch.from_numpy(a) for a in (points, mask, l2i, eye, la)), image)
    assert got.shape == (B, N, *image)
    assert (want > 0).sum() > 100
    assert np.array_equal(got.numpy(), want)
