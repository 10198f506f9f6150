"""Port parity: bevfusion_tpu_torch.ops.voxelize against the JAX voxelizer.

Integer outputs (coords, counts, mask) must be equal; the fp32 means may
differ only by summation order (atol 1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.ops import voxelize as jvox
from bevfusion_tpu_torch.ops import voxelize as tvox

torch.set_num_threads(2)

PCR = (-8.0, -8.0, -3.0, 8.0, 8.0, 3.0)
VS = (0.5, 0.5, 0.75)


def _points(seed, n=3000):
    """Clustered points (so voxels hold several points) plus some outside
    the range and some masked off."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-7, 7, (40, 3)) * np.array([1, 1, 0.35])
    pts = centers[rng.randint(0, 40, n)] + rng.normal(0, 0.6, (n, 3))
    pts = np.concatenate([pts, rng.rand(n, 2)], 1).astype(np.float32)
    pts[:50, 0] += 20.0  # out of range
    mask = rng.rand(n) > 0.05
    return pts, mask


@pytest.mark.parametrize("max_points,max_voxels", [
    (4, 4096),   # per-voxel cap binds, every voxel kept
    (10, 300),   # overflow: more occupied voxels than max_voxels
    (3000, 64),  # dynamic-style cap (all points) with heavy overflow
])
def test_voxelize_matches_jax(max_points, max_voxels):
    pts, mask = _points(max_points + max_voxels)
    want = jvox.voxelize(jnp.asarray(pts), jnp.asarray(mask), VS, PCR, max_points,
                         max_voxels)
    got = tvox.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), VS, PCR, max_points,
                        max_voxels)
    n_occ = int(np.asarray(want.mask).sum())
    assert n_occ > 0
    if max_voxels < 1000:
        assert n_occ == max_voxels  # the overflow case really overflows
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_array_equal(got.num_points.numpy(), np.asarray(want.num_points))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats), rtol=0, atol=1e-6)


def test_voxelization_batch_picks_test_cap():
    pts = np.stack([_points(1)[0], _points(2)[0]])
    mask = np.stack([_points(1)[1], _points(2)[1]])
    vox = tvox.Voxelization(VS, PCR, max_num_points=5, max_voxels=(50, 200))
    out = vox(torch.from_numpy(pts), torch.from_numpy(mask))
    assert out.feats.shape == (2, 200, 5) and out.coords.shape == (2, 200, 3)
    jv = jvox.Voxelization(VS, PCR, max_num_points=5, max_voxels=(50, 200))
    feats, coords4, sizes, vmask = jv(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(out.coords.reshape(-1, 3).numpy(),
                                  np.asarray(coords4)[:, 1:])
    np.testing.assert_array_equal(out.mask.reshape(-1).numpy(), np.asarray(vmask))
    np.testing.assert_allclose(out.feats.reshape(-1, 5).numpy(), np.asarray(feats),
                               rtol=0, atol=1e-6)
    assert vox(torch.from_numpy(pts), torch.from_numpy(mask), training=True).mask.shape == (2, 50)
