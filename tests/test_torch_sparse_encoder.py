"""Port parity: SparseEncoder against the JAX SparseEncoder(engine="gather").

The tiny encoder of tests/test_bevfusion_model.py (basicblock, channel
order c*Z + z), once with its hybrid split (dense from stage 3) and once
all sparse. fp32 through ~20 convs: max|d| <= 2.5e-3 * max(scale, 1) and
mean|d| <= 2e-4 * max(scale, 1), as in tests/test_golden_parity.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models.sparse_encoder import SparseEncoder as JaxSparseEncoder
from bevfusion_tpu.ops import voxelize as jvox
from bevfusion_tpu.runtime.flagship import synthetic_lidar_scan
from bevfusion_tpu_torch.models.sparse_encoder import SparseEncoder
from tests.torch_port_helpers import load_bridged, random_variables

torch.set_num_threads(2)

PCR = (-16.0, -16.0, -4.0, 16.0, 16.0, 4.0)
ENCODER = dict(
    in_channels=5, sparse_shape=(128, 128, 33), base_channels=4, output_channels=16,
    encoder_channels=((4, 4, 8), (8, 8, 16), (16, 16, 16), (16, 16)),
    encoder_paddings=((0, 0, 1), (0, 0, 1), (0, 0, (1, 1, 0)), (0, 0)),
    block_type="basicblock")


@functools.lru_cache(maxsize=None)
def _voxels():
    pts, mask = synthetic_lidar_scan(20000, PCR, seed=5)
    out = jvox.voxelize(jnp.asarray(pts), jnp.asarray(mask), (0.25, 0.25, 0.5), PCR, 4, 2048)
    assert 1000 < int(np.asarray(out.mask).sum()) <= 2048
    return tuple(np.array(a)[None] for a in (out.feats, out.coords, out.mask))


@pytest.mark.parametrize("dense_from_stage", [3, -1])
def test_sparse_encoder_matches_jax(dense_from_stage):
    feats, coords, mask = _voxels()
    jenc = JaxSparseEncoder(**ENCODER, dense_from_stage=dense_from_stage, engine="gather")
    variables = random_variables(jenc.init, feats, coords, mask, seed=dense_from_stage + 2)
    want = np.asarray(jax.jit(jenc.apply)(variables, feats, coords, mask))  # [B, X, Y, C*Z]

    enc = SparseEncoder(**ENCODER, dense_from_stage=dense_from_stage)
    load_bridged(enc, variables, "lidar_backbone", "encoders.lidar.backbone.")
    with torch.no_grad():
        got = enc(*map(torch.from_numpy, (feats, coords, mask))).numpy()

    want = want.transpose(0, 3, 1, 2)
    assert got.shape == want.shape == (1, 16, 16, 16)
    scale = max(float(np.max(np.abs(want))), 1.0)
    assert np.max(np.abs(want)) > 0.1  # a real signal reached the output
    assert np.max(np.abs(got - want)) <= 2.5e-3 * scale
    assert np.mean(np.abs(got - want)) <= 2e-4 * scale
