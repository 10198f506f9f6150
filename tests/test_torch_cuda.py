"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On a machine with an NVIDIA GPU run
``python -m pytest tests/test_torch_cuda.py -q --noconftest``. This file
imports no JAX, so it runs where only PyTorch is installed (``--noconftest``
skips tests/conftest.py, which imports jax). fp32 with TF32 off; kernel and
plain version differ only in summation order: max|d| <= 1e-5 * max(|ref|, 1).
"""
import numpy as np
import pytest
import torch

from bevfusion_tpu_torch.config import Config
from bevfusion_tpu_torch.models.sparse_encoder import SparseEncoder
from bevfusion_tpu_torch.models.vtransforms import DepthLSSTransform
from bevfusion_tpu_torch.ops import bev_pool as bp
from bevfusion_tpu_torch.ops import sparse_conv as sp
from bevfusion_tpu_torch.runtime.flagship import (add_pool_lut, batch_to, init_weights,
                                                  synthetic_calibration)

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sites(seed, grid, n, cap):
    """n random sorted site ids on ``grid``, sentinel-padded to ``cap``."""
    rng = np.random.RandomState(seed)
    ids = np.full(cap, grid.size, np.int32)
    ids[:n] = np.sort(rng.choice(grid.size, n, replace=False))
    return torch.from_numpy(ids)


def _close(got, want):
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(want.abs().max().item(), 1.0), err


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,strided,epilogue", [
    (5, 16, False, True), (16, 16, False, True), (16, 32, True, True),
    (32, 32, False, False), (64, 64, False, True), (64, 128, True, False),
    (128, 128, False, True),
])
def test_sparse_conv_kernel_matches_plain(cuda, cin, cout, strided, epilogue):
    grid = sp.SparseGrid(40, 40, 12)
    ids = _sites(cin + cout, grid, 6000, 6500)
    if strided:
        og = sp.conv_out_shape(grid, 3, 2, 1)
        out_ids, _ = sp.downsample_sites(ids, grid, 3, 2, 1, 3000)
        nbr = sp.build_conv_rulebook(ids, out_ids, grid, og, 3, 2, 1)
    else:
        nbr = sp.build_subm_rulebook(ids, grid)
    g = torch.Generator().manual_seed(cin * cout)
    feats = torch.randn(ids.shape[0], cin, generator=g)
    w = torch.randn(27, cin, cout, generator=g) / (27 * cin) ** 0.5
    kw = {}
    if epilogue:
        kw = dict(scale=torch.rand(cout, generator=g) + 0.5,
                  shift=torch.randn(cout, generator=g),
                  residual=torch.randn(nbr.shape[1], cout, generator=g), relu=True)
    args = [t.to(cuda) for t in (feats, nbr, w)]
    kw = {k: v.to(cuda) if torch.is_tensor(v) else v for k, v in kw.items()}
    launches = sp.sparse_conv.launches
    got = sp.sparse_conv(*args, **kw)
    torch.cuda.synchronize()
    assert sp.sparse_conv.launches == launches + 1
    _close(got, sp.sparse_conv_plain(*args, **kw))


@pytest.mark.cuda
def test_sparse_conv_kernel_rejects_what_it_does_not_take(cuda):
    feats = torch.randn(10, 16, device=cuda)
    nbr = torch.zeros(27, 10, dtype=torch.int32, device=cuda)
    w = torch.randn(27, 16, 16, device=cuda)
    with pytest.raises(TypeError):
        sp.sparse_conv(feats.double(), nbr, w.double())
    with pytest.raises(TypeError):
        sp.sparse_conv(feats, nbr.long(), w)
    with pytest.raises(ValueError):
        sp.sparse_conv(feats.t().contiguous().t(), nbr, w)  # not contiguous
    with pytest.raises(ValueError):
        sp.sparse_conv(torch.randn(10, 200, device=cuda), nbr,
                       torch.randn(27, 200, 16, device=cuda))
    with pytest.raises(ValueError):
        sp.sparse_conv(feats, nbr, w, residual=torch.randn(9, 16, device=cuda))


@pytest.mark.cuda
def test_sparse_encoder_on_card_matches_cpu(cuda):
    """All-sparse tiny encoder (every conv through the kernel) on the card
    against the same module on the CPU (plain path)."""
    enc = SparseEncoder(
        in_channels=5, sparse_shape=(48, 48, 41), base_channels=8, output_channels=16,
        encoder_channels=((8, 8, 16), (16, 16, 32), (32, 32, 32), (32, 32)),
        encoder_paddings=((0, 0, 1), (0, 0, 1), (0, 0, (1, 1, 0)), (0, 0)),
        block_type="basicblock", dense_from_stage=-1).eval()
    grid = sp.SparseGrid(48, 48, 41)
    ids = _sites(0, grid, 8000, 8500)
    mask = ids < grid.size
    coords = torch.stack(sp.unlin_ids(ids, grid), -1).int()
    feats = torch.randn(ids.shape[0], 5, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = enc(feats[None], coords[None], mask[None])
        launches = sp.sparse_conv.launches
        got = enc.to(cuda)(feats[None].to(cuda), coords[None].to(cuda), mask[None].to(cuda))
        torch.cuda.synchronize()
    # conv_input + 4 subm per stage x 4 stages + 3 strided + conv_out
    assert sp.sparse_conv.launches - launches == 1 + 16 + 3 + 1
    _close(got.cpu(), want)


def _pool_inputs(Z, seed=0, B=2, N=2, D=30, fH=8, fW=16, C=80, X=40, Y=40):
    """Random depth / ctx and cell ids over a grid with empty cells, 1-point
    cells and one cell of 1200 points (sample 0's first 1200 points)."""
    rng = np.random.RandomState(seed)
    depth = rng.rand(B, N, D, fH, fW).astype(np.float32)
    depth /= depth.sum(2, keepdims=True)
    ctx = rng.randn(B, N, fH, fW, C).astype(np.float32)
    ids = rng.randint(0, Z * X * Y, (B, N * D * fH * fW))
    ids[0, :1200] = 7
    valid = rng.rand(*ids.shape) < 0.9
    valid[0, :1200] = True
    shape = (B, N, D, fH, fW)
    iv = bp.build_intervals(torch.from_numpy(ids.reshape(shape)),
                            torch.from_numpy(valid.reshape(shape)), Z * X * Y)
    return torch.from_numpy(depth), torch.from_numpy(ctx), iv, (Z, X, Y)


@pytest.mark.cuda
@pytest.mark.parametrize("Z", [1, 2])
def test_bev_pool_kernel_matches_plain(cuda, Z):
    depth, ctx, iv, zxy = _pool_inputs(Z)
    lengths = iv.interval_lengths
    assert lengths.max() > 1000 and (lengths == 1).any()
    assert iv.interval_cells.numel() < 2 * zxy[0] * zxy[1] * zxy[2]  # some cells are empty
    depth, ctx = depth.to(cuda), ctx.to(cuda)
    iv = bp.PoolIntervals(*(t.to(cuda) for t in iv))
    launches = bp.bev_pool.launches
    got = bp.bev_pool(depth, ctx, iv, *zxy)
    torch.cuda.synchronize()
    assert bp.bev_pool.launches == launches + 1
    assert got.shape == (2, Z * 80, zxy[1], zxy[2])
    _close(got, bp.bev_pool_plain(depth, ctx, iv, *zxy))


@pytest.mark.cuda
def test_build_intervals_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, 500, (2, 3, 10, 4, 6)))
    valid = torch.from_numpy(rng.rand(2, 3, 10, 4, 6) < 0.7)
    want = bp.build_intervals(ids, valid, 500)
    got = bp.build_intervals(ids.to(cuda), valid.to(cuda), 500)
    for name, w in want._asdict().items():
        assert torch.equal(getattr(got, name).cpu(), w), name


@pytest.mark.cuda
def test_bev_pool_kernel_rejects_what_it_does_not_take(cuda):
    depth, ctx, iv, zxy = _pool_inputs(1, B=1, N=1, D=4, fH=2, fW=3, C=8, X=4, Y=4)
    depth, ctx = depth.to(cuda), ctx.to(cuda)
    iv = bp.PoolIntervals(*(t.to(cuda) for t in iv))
    with pytest.raises(TypeError):
        bp.bev_pool(depth.double(), ctx, iv, *zxy)
    with pytest.raises(TypeError):
        bp.bev_pool(depth, ctx, iv._replace(ranks_feat=iv.ranks_feat.long()), *zxy)
    with pytest.raises(ValueError):
        bp.bev_pool(depth, ctx.transpose(2, 3).contiguous().transpose(2, 3), iv, *zxy)
    with pytest.raises(ValueError):
        bp.bev_pool(depth, ctx[..., :1, :], iv, *zxy)
    with pytest.raises(ValueError):
        bp.bev_pool(depth, ctx, iv._replace(ranks_feat=iv.ranks_feat[:-1]), *zxy)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["lut", "in_graph"])
def test_depth_lss_on_card_matches_cpu(cuda, route):
    """A small DepthLSSTransform on the card (its pool through the kernel,
    one launch per forward) against the same module on the CPU."""
    vt = dict(in_channels=24, out_channels=16, image_size=[32, 64], feature_size=[4, 8],
              xbound=[-16.0, 16.0, 0.5], ybound=[-16.0, 16.0, 0.5], zbound=[-10.0, 10.0, 20.0],
              dbound=[1.0, 20.0, 1.0], downsample=2)
    model = init_weights(DepthLSSTransform(**vt), seed=3).eval()
    rng = np.random.RandomState(2)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_calibration(2, 3, (32, 64)).items()}
    batch["points"] = torch.from_numpy(rng.uniform(-15, 15, (2, 800, 5)).astype(np.float32))
    batch["points_mask"] = torch.ones(2, 800, dtype=torch.bool)
    if route == "lut":
        cfg = Config.from_dict({"model": {"encoders": {"camera": {"vtransform": vt}}}})
        batch = add_pool_lut(cfg, batch)
    feats = torch.randn(2, 3, 24, 4, 8, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = model(feats, batch["points"], batch["points_mask"], batch)
        launches = bp.bev_pool.launches
        card = batch_to(batch, cuda)
        got = model.to(cuda)(feats.to(cuda), card["points"], card["points_mask"], card)
        torch.cuda.synchronize()
    assert bp.bev_pool.launches - launches == 1
    _close(got.cpu(), want)
