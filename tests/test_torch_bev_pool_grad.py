"""Port parity of the BEV pool's gradient against the JAX package.

``BEVPoolFunction`` (plain pool forward on the CPU, ``bev_pool_backward``
torch ops backward) through ``DepthLSSTransform.pool`` on both of its
routes, the host LUT and the in-graph intervals, against ``jax.grad`` of
``bevfusion_tpu/ops/bev_pool.py:lss_bev_pool`` (the XLA in-graph pool,
fp32; the JAX LUT route rounds ctx to bf16 even on the CPU) on a jittered
rig whose frustum points keep off cell boundaries, so both packages pool
every point into the same cell. fp32, summation order only:
max|d| <= 1e-5 * max(|want|, 1), except d_ctx against JAX at 2e-5: the JAX
pool sums each cell as a difference of prefix sums over all sorted points,
and on these inputs its own d_ctx is 1.07e-5 of max|d_ctx| away from a
float64 evaluation (the port's 1.1e-7). So the port's gradients are also
held to a float64 evaluation of the same pool at 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models.vtransforms import get_geometry as jax_geometry
from bevfusion_tpu.ops import bev_pool as jax_pool
from bevfusion_tpu_torch.models.vtransforms import DepthLSSTransform, build_pool_lut
from bevfusion_tpu_torch.ops import bev_pool as pool
from tests.test_torch_camera_ops import BOUNDS, DBOUND, FEATURE, IMAGE, _geometry_args, _rig

torch.set_num_threads(2)

TOL = 1e-5
TOL_CTX_VS_JAX = 2e-5  # the JAX d_ctx's own error from float64 is 1.07e-5 here
TOL_F64 = 1e-6


def _close(got, want, tol=TOL):
    return float(np.max(np.abs(got - want))) <= tol * max(float(np.max(np.abs(want))), 1.0)


@functools.lru_cache(maxsize=None)
def _case():
    """Jittered rig (B=2, N=3), random depth / ctx / cotangent, and the JAX
    gradients of sum(lss_bev_pool(depth, ctx) * g)."""
    dx, bx, nx, frustum, mats = _rig()
    B, N = mats["camera2lidar"].shape[:2]
    D, fH, fW = frustum.shape[:3]
    X, Y, Z = (int(v) for v in nx)
    C = 5
    rng = np.random.RandomState(4)
    depth = rng.rand(B, N, D, fH, fW).astype(np.float32)
    depth /= depth.sum(2, keepdims=True)
    ctx = rng.randn(B, N, fH, fW, C).astype(np.float32)
    g = rng.randn(B, X, Y, Z * C).astype(np.float32)
    geom = jax_geometry(jnp.asarray(frustum), *(jnp.asarray(a) for a in _geometry_args(mats)))
    ids, valid = jax_pool.cell_ids_from_geometry(geom, jnp.asarray(dx), jnp.asarray(bx), nx)

    def f(d, c):
        return jnp.sum(jax_pool.lss_bev_pool(d, c, ids, valid, Z, X, Y) * g)

    d_depth, d_ctx = jax.grad(f, argnums=(0, 1))(jnp.asarray(depth), jnp.asarray(ctx))
    return mats, depth, ctx, g, np.asarray(d_depth), np.asarray(d_ctx)


@pytest.mark.parametrize("route", ["lut", "in_graph"])
def test_pool_gradient_matches_jax(route):
    mats, depth, ctx, g, want_depth, want_ctx = _case()
    vt = DepthLSSTransform(in_channels=8, out_channels=ctx.shape[-1], image_size=IMAGE,
                           feature_size=FEATURE, xbound=BOUNDS[0], ybound=BOUNDS[1],
                           zbound=BOUNDS[2], dbound=DBOUND)
    tmats = {k: torch.from_numpy(v) for k, v in mats.items()}
    if route == "lut":
        tmats["pool_lut"] = build_pool_lut(vt.frustum, vt.dx, vt.bx, vt.nx, tmats)
    d = torch.from_numpy(depth).requires_grad_()
    c = torch.from_numpy(ctx).requires_grad_()
    out = vt.pool(d, c, tmats)  # [B, Z*C, X, Y]
    (out * torch.from_numpy(g.transpose(0, 3, 1, 2))).sum().backward()
    assert (want_depth != 0).mean() > 0.2 and (want_ctx != 0).mean() > 0.5
    assert _close(d.grad.numpy(), want_depth)
    assert _close(c.grad.numpy(), want_ctx, TOL_CTX_VS_JAX)

    # the same pool in float64
    lut = build_pool_lut(vt.frustum, vt.dx, vt.bx, vt.nx, tmats)
    iv = pool.PoolIntervals(*(lut[k] for k in pool.PoolIntervals._fields))
    d64 = torch.from_numpy(depth).double().requires_grad_()
    c64 = torch.from_numpy(ctx).double().requires_grad_()
    X, Y, Z = vt.nx
    (pool.bev_pool_plain(d64, c64, iv, Z, X, Y)
     * torch.from_numpy(g.transpose(0, 3, 1, 2)).double()).sum().backward()
    assert _close(d.grad.numpy(), d64.grad.numpy(), TOL_F64)
    assert _close(c.grad.numpy(), c64.grad.numpy(), TOL_F64)


def test_pool_backward_chunks_agree():
    """The backward's chunking of points does not change its result (Z = 2,
    two samples, random cell ids)."""
    rng = np.random.RandomState(1)
    B, N, D, fH, fW, C, X, Y, Z = 2, 3, 7, 4, 6, 5, 9, 8, 2
    depth = torch.from_numpy(rng.rand(B, N, D, fH, fW).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(B, N, fH, fW, C).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, Z * X * Y, (B, N, D, fH, fW)).astype(np.int32))
    iv = pool.build_intervals(ids, torch.from_numpy(rng.rand(B, N, D, fH, fW) < 0.8), Z * X * Y)
    grad = torch.randn(B, Z * C, X, Y, generator=torch.Generator().manual_seed(0))
    whole = pool.bev_pool_backward(depth, ctx, iv, grad, Z, X, Y)
    chunked = pool.bev_pool_backward(depth, ctx, iv, grad, Z, X, Y, chunk=37)
    assert iv.ranks_depth.numel() > 10 * 37
    for a, b in zip(whole, chunked):
        assert a.shape == b.shape and torch.allclose(a, b, rtol=0, atol=1e-6)
    d = depth.clone().requires_grad_()
    c = ctx.clone().requires_grad_()
    (pool.BEVPoolFunction.apply(d, c, iv, Z, X, Y) * grad).sum().backward()
    assert torch.equal(d.grad, whole[0]) and torch.equal(c.grad, whole[1])
