"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On a machine with an NVIDIA GPU run
``python -m pytest tests/test_torch_cuda.py -q --noconftest``. This file
imports no JAX, so it runs where only PyTorch is installed (``--noconftest``
skips tests/conftest.py, which imports jax). fp32 with TF32 off; kernel and
plain version differ only in summation order (the sparse conv multiplies on
the tensor cores in the 3xTF32 split, fp32-accurate): max|d| <= 1e-5 *
max(|ref|, 1).
"""
import copy

import numpy as np
import pytest
import torch

from bevfusion_tpu_torch.config import Config
from bevfusion_tpu_torch.models.sparse_encoder import SparseEncoder
from bevfusion_tpu_torch.models.heads.segm import BEVSegmentationHead
from bevfusion_tpu_torch.models.vtransforms import DepthLSSTransform, LSSTransform
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


def _close(got, want, tol=1e-5):
    err = (got - want).abs().max().item()
    assert err <= tol * max(want.abs().max().item(), 1.0), err


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


def _epilogue_kw(cout, rows, g, scale=True, shift=True, residual=True, relu=True):
    kw = {"relu": relu}
    if scale:
        kw["scale"] = torch.rand(cout, generator=g) + 0.5
    if shift:
        kw["shift"] = torch.randn(cout, generator=g)
    if residual:
        kw["residual"] = torch.randn(rows, cout, generator=g)
    return kw


def _to(kw, device):
    return {k: v.to(device) if torch.is_tensor(v) else v for k, v in kw.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [16, 32, 64, 128])
@pytest.mark.parametrize("cin", [5, 8, 16, 32, 64])
def test_sparse_conv_kernel_channels_match_plain(cuda, cin, cout):
    """Every padding of the tensor-core tiles (Cin to a multiple of 8, with
    4-byte copies for Cin = 5; Cout 16 to 128) with the whole epilogue, on
    6,500 output sites (a ragged last tile of 36, and tiles of padding
    sites that every offset misses); two calls give equal bits."""
    grid = sp.SparseGrid(40, 40, 12)
    ids = _sites(cin * cout, grid, 6000, 6500)
    nbr = sp.build_subm_rulebook(ids, grid)
    g = torch.Generator().manual_seed(cin + cout)
    feats = torch.randn(ids.shape[0], cin, generator=g)
    w = torch.randn(27, cin, cout, generator=g) / (27 * cin) ** 0.5
    kw = _to(_epilogue_kw(cout, nbr.shape[1], g), cuda)
    args = [t.to(cuda) for t in (feats, nbr, w)]
    got = sp.sparse_conv(*args, **kw)
    torch.cuda.synchronize()
    _close(got, sp.sparse_conv_plain(*args, **kw))
    assert torch.equal(sp.sparse_conv(*args, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("scale", [False, True])
def test_sparse_conv_kernel_epilogues_match_plain(cuda, scale, shift, residual, relu):
    grid = sp.SparseGrid(30, 30, 10)
    ids = _sites(3, grid, 3000, 3100)
    nbr = sp.build_subm_rulebook(ids, grid)
    g = torch.Generator().manual_seed(4)
    feats, w = torch.randn(ids.shape[0], 32, generator=g), torch.randn(27, 32, 32, generator=g)
    kw = _to(_epilogue_kw(32, nbr.shape[1], g, scale, shift, residual, relu), cuda)
    args = [t.to(cuda) for t in (feats, nbr, w / (27 * 32) ** 0.5)]
    got = sp.sparse_conv(*args, **kw)
    torch.cuda.synchronize()
    _close(got, sp.sparse_conv_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(5, 16), (16, 16), (64, 64)])
def test_sparse_conv_kernel_misses(cuda, cin, cout):
    """Table entries >= cap_in count as misses, as -1 does; a tile that
    every offset misses writes epilogue(0) = relu(shift + residual); an odd
    Cout writes unpaired columns."""
    grid = sp.SparseGrid(30, 30, 10)
    ids = _sites(5, grid, 2000, 2100)
    nbr = sp.build_subm_rulebook(ids, grid)
    rng = np.random.RandomState(cin)
    wild = torch.from_numpy(rng.rand(*nbr.shape) < 0.1) & (nbr >= 0)
    nbr_wild = torch.where(wild, nbr.shape[1] + torch.from_numpy(
        rng.randint(0, 1000, nbr.shape)).int(), nbr)
    nbr_wild[:, 128:192] = torch.where(torch.arange(27)[:, None] % 2 == 0, -1, 10 ** 6)
    want_nbr = torch.where(nbr_wild >= nbr.shape[1], -1, nbr_wild).int()
    for co in (cout, cout - 1):
        g = torch.Generator().manual_seed(co)
        feats = torch.randn(ids.shape[0], cin, generator=g)
        w = torch.randn(27, cin, co, generator=g) / (27 * cin) ** 0.5
        kw = _to(_epilogue_kw(co, nbr.shape[1], g), cuda)
        feats, w = feats.to(cuda), w.to(cuda)
        got = sp.sparse_conv(feats, nbr_wild.to(cuda), w, **kw)
        torch.cuda.synchronize()
        _close(got, sp.sparse_conv_plain(feats, want_nbr.to(cuda), w, **kw))
        empty = torch.relu(kw["shift"] + kw["residual"][128:192])
        assert torch.equal(got[128:192], empty)


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


def _conv_operands(cin, cout, strided, seed=0):
    """A random site set, its gather table (and transposed table if
    strided), features, weight and an output gradient, on the CPU."""
    grid = sp.SparseGrid(40, 40, 12)
    ids = _sites(seed + cin + cout, grid, 6000, 6500)
    nbr_t = None
    if strided:
        og = sp.conv_out_shape(grid, 3, 2, 1)
        out_ids, _ = sp.downsample_sites(ids, grid, 3, 2, 1, 3000)
        nbr = sp.build_conv_rulebook(ids, out_ids, grid, og, 3, 2, 1)
        nbr_t = sp.build_conv_transpose_rulebook(ids, out_ids, grid, og, 3, 2, 1)
    else:
        nbr = sp.build_subm_rulebook(ids, grid)
    g = torch.Generator().manual_seed(seed + cin * cout)
    feats = torch.randn(ids.shape[0], cin, generator=g) * (ids < grid.size)[:, None]
    w = torch.randn(27, cin, cout, generator=g) / (27 * cin) ** 0.5
    dout = torch.randn(nbr.shape[1], cout, generator=g)
    return feats, nbr, nbr_t, w, dout


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,strided", [
    (5, 16, False), (16, 16, False), (16, 32, True), (32, 32, False), (64, 64, False),
    (64, 128, True), (128, 128, False), (3, 70, False),
])
def test_weight_gradient_kernel_matches_plain(cuda, cin, cout, strided):
    feats, nbr, _, _, dout = (t if t is None else t.to(cuda)
                              for t in _conv_operands(cin, cout, strided))
    launches = sp.sparse_conv_dw.launches
    got = sp.sparse_conv_dw(feats, nbr, dout)
    torch.cuda.synchronize()
    assert sp.sparse_conv_dw.launches == launches + 1
    assert got.shape == (27, cin, cout)
    _close(got, sp.sparse_conv_dw_plain(feats, nbr, dout))
    assert torch.equal(sp.sparse_conv_dw(feats, nbr, dout), got)  # the same from run to run


@pytest.mark.cuda
def test_weight_gradient_kernel_rejects_what_it_does_not_take(cuda):
    feats = torch.randn(10, 16, device=cuda)
    nbr = torch.zeros(27, 10, dtype=torch.int32, device=cuda)
    dout = torch.randn(10, 16, device=cuda)
    with pytest.raises(TypeError):
        sp.sparse_conv_dw(feats.double(), nbr, dout)
    with pytest.raises(TypeError):
        sp.sparse_conv_dw(feats, nbr.long(), dout)
    with pytest.raises(ValueError):
        sp.sparse_conv_dw(feats, nbr, dout.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        sp.sparse_conv_dw(feats, nbr, torch.randn(9, 16, device=cuda))
    with pytest.raises(ValueError):
        sp.sparse_conv_dw(torch.randn(10, 200, device=cuda), nbr, dout)


@pytest.mark.cuda
def test_weight_gradient_kernel_input_width_every_cout(cuda):
    """Cin = 5 (4-byte copies, N padded to 8) against every Cout up to 128,
    each with its own padding of the mma's M; equal bits across two calls."""
    feats, nbr, _, _, _ = (t if t is None else t.to(cuda) for t in _conv_operands(5, 16, False))
    g = torch.Generator(device=cuda).manual_seed(0)
    for cout in range(1, 129):
        dout = torch.randn(nbr.shape[1], cout, generator=g, device=cuda)
        got = sp.sparse_conv_dw(feats, nbr, dout)
        torch.cuda.synchronize()
        assert got.shape == (27, 5, cout)
        _close(got, sp.sparse_conv_dw_plain(feats, nbr, dout))
        assert torch.equal(sp.sparse_conv_dw(feats, nbr, dout), got), cout


def _dw_table(cap_in, cap_out, seed):
    """A [27, cap_out] table over ``cap_in`` rows in which: chunk 0 (the
    kernel's first DW_CHUNK sites) misses at every offset; offset 3 misses
    everywhere; offset 5 hits 13 sites of chunk 1 (not a multiple of the
    mma's 8 sites) and nothing else; offset 7 points past ``cap_in`` (a
    miss) on every other site and hits on the rest. Returns (table, the
    same table with every miss as -1)."""
    rng = np.random.RandomState(seed)
    nbr = rng.randint(-1, cap_in, (27, cap_out)).astype(np.int32)
    nbr[nbr % 3 == 0] = -1  # about 40% of the slots miss
    chunk = sp.DW_CHUNK
    nbr[7, ::2] = cap_in + rng.randint(0, 5, nbr[7, ::2].shape)
    nbr[7, 1::2] = rng.randint(0, cap_in, nbr[7, 1::2].shape)
    nbr[:, :chunk] = -1
    nbr[3] = -1
    nbr[5] = -1
    nbr[5, chunk + rng.choice(chunk, 13, replace=False)] = rng.randint(0, cap_in, 13)
    clean = np.where(nbr >= cap_in, -1, nbr)
    return torch.from_numpy(nbr), torch.from_numpy(clean)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(5, 16), (16, 16), (32, 64), (64, 32), (128, 128)])
def test_weight_gradient_kernel_misses(cuda, cin, cout):
    """An all-miss chunk, an offset that misses everywhere, entries >=
    cap_in (misses), and a chunk of 13 hits: as the plain version on the
    table with every miss written as -1; the missed offset exactly zero;
    equal bits across two calls."""
    cap_in, cap_out = 3000, 3 * sp.DW_CHUNK + 100
    nbr, clean = (t.to(cuda) for t in _dw_table(cap_in, cap_out, seed=cin + cout))
    g = torch.Generator(device=cuda).manual_seed(cin * cout)
    feats = torch.randn(cap_in, cin, generator=g, device=cuda)
    dout = torch.randn(cap_out, cout, generator=g, device=cuda)
    got = sp.sparse_conv_dw(feats, nbr, dout)
    torch.cuda.synchronize()
    want = sp.sparse_conv_dw_plain(feats, clean, dout)
    _close(got, want)
    assert not got[3].any()
    assert got[5].abs().max() > 0  # the 13 hits were summed, not dropped
    assert torch.equal(sp.sparse_conv_dw(feats, nbr, dout), got)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,strided", [(16, 16, False), (16, 32, True), (64, 64, False)])
def test_sparse_conv_function_on_card_matches_plain_autograd(cuda, cin, cout, strided):
    """Forward, backward-data (mirrored or transposed weights) and the
    weight gradient through the kernels, against autograd of
    ``sparse_conv_plain`` on the same CUDA tensors; every launch counted."""
    feats, nbr, nbr_t, w, dout = (t if t is None else t.to(cuda)
                                  for t in _conv_operands(cin, cout, strided, seed=1))
    x, wt = feats.clone().requires_grad_(), w.clone().requires_grad_()
    before = sp.sparse_conv.launches, sp.sparse_conv_dw.launches
    y = sp.SparseConvFunction.apply(x, wt, nbr, nbr_t)
    assert y.grad_fn is not None
    (y * dout).sum().backward()
    torch.cuda.synchronize()
    assert (sp.sparse_conv.launches - before[0], sp.sparse_conv_dw.launches - before[1]) == (2, 1)
    x0, w0 = feats.clone().requires_grad_(), w.clone().requires_grad_()
    y0 = sp.sparse_conv_plain(x0, nbr, w0)
    (y0 * dout).sum().backward()
    _close(y.detach(), y0.detach())
    _close(x.grad, x0.grad)
    _close(wt.grad, w0.grad)


def training_encoder(sites: int, cap: int):
    """The tiny all-sparse encoder in training mode, two samples of ``sites``
    random sites (padded to ``cap``) on a 48 x 48 x 41 grid, and an output
    gradient: (encoder, (feats, coords, mask), gout), on the CPU."""
    enc = SparseEncoder(
        in_channels=5, sparse_shape=(48, 48, 41), base_channels=8, output_channels=16,
        encoder_channels=((8, 8, 16), (16, 16, 32), (32, 32, 32), (32, 32)),
        encoder_paddings=((0, 0, 1), (0, 0, 1), (0, 0, (1, 1, 0)), (0, 0)),
        block_type="basicblock", dense_from_stage=-1)
    init_weights(enc, seed=2).train()
    grid = sp.SparseGrid(48, 48, 41)
    ids = torch.stack([_sites(s, grid, sites, cap) for s in (0, 1)])
    mask = ids < grid.size
    coords = torch.stack(sp.unlin_ids(ids, grid), -1).int()
    feats = torch.randn(2, ids.shape[1], 5, generator=torch.Generator().manual_seed(1))
    gout = torch.randn(2, 16 * 2, 6, 6, generator=torch.Generator().manual_seed(2))
    return enc, (feats, coords, mask), gout


def gradient_shift(enc, inputs, gout, conv, monkeypatch):
    """One training forward + backward of ``enc`` on the CPU (its output is
    returned, its gradients stay), and how far those gradients move when
    ``conv`` takes the place of every sparse conv (forward and
    backward-data): max over parameters of max|d| / max(|grad|, 1)."""
    other = copy.deepcopy(enc)
    out = enc(*inputs)
    (out * gout).sum().backward()
    with monkeypatch.context() as m:
        m.setattr(sp, "sparse_conv", conv)
        (other(*inputs) * gout).sum().backward()
    return max((q.grad - p.grad).abs().max().item() / max(p.grad.abs().max().item(), 1.0)
               for p, q in zip(enc.parameters(), other.parameters())), out


def rounding_sensitivity(enc, inputs, gout, rel: float, monkeypatch):
    """``gradient_shift`` under ``rel`` relative noise (seeded) on every
    sparse conv's output."""
    g = torch.Generator().manual_seed(0)

    def perturbed(f, nbr, w, *args, **kw):
        y = sp.sparse_conv_plain(f, nbr, w, *args, **kw)
        return y * (1 + rel * torch.randn(y.shape, generator=g))

    return gradient_shift(enc, inputs, gout, perturbed, monkeypatch)


@pytest.mark.cuda
def test_sparse_encoder_training_on_card_matches_cpu(cuda, monkeypatch):
    """The tiny all-sparse encoder in training mode (BN over the active
    sites of both samples): output, every parameter's gradient and the
    running statistics on the card against the same module on the CPU, and
    the kernel launches of one forward + backward.

    A gradient through 21 ReLUs jumps wherever a rounding difference moves
    a ReLU input across zero. At 8,000 sites a sample such an input exists:
    1e-6 relative noise on the CPU's own sparse convs moves a weight
    gradient beyond 1e-4 of its largest entry, so only a conv that rounds
    exactly like the CPU's could pass there
    (tests/test_torch_tf32_split.py pins it). At 2,500 sites the reference
    holds this test's 1e-4 with 1e-6 noise on every sparse conv (checked
    first), so the comparison measures the kernels."""
    enc, inputs, gout = training_encoder(2500, 2700)
    card = copy.deepcopy(enc).to(cuda)
    moved, want = rounding_sensitivity(enc, inputs, gout, 1e-6, monkeypatch)
    assert moved <= 1e-4  # the reference is well posed at this test's bound
    feats, coords, mask = inputs

    before = sp.sparse_conv.launches, sp.sparse_conv_dw.launches
    out = card(feats.to(cuda), coords.to(cuda), mask.to(cuda))
    (out * gout.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    # per sample: 21 convs forward, backward-data for all but conv_input, a
    # weight gradient each
    assert (sp.sparse_conv.launches - before[0], sp.sparse_conv_dw.launches - before[1]) == \
        (2 * (21 + 20), 2 * 21)
    # 21 convs and 21 batch normalisations deep: 1e-4 (chip_smoke's bound)
    _close(out.detach().cpu(), want.detach(), 1e-4)
    for (name, p), q in zip(enc.named_parameters(), card.parameters()):
        assert q.grad is not None, name
        _close(q.grad.cpu(), p.grad, 1e-4)
    for (name, b), c in zip(enc.named_buffers(), card.buffers()):
        if b.dtype.is_floating_point:
            _close(c.cpu(), b, 1e-4)


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
@pytest.mark.parametrize("C", [80, 6, 37, 130])
def test_bev_pool_kernel_channels_and_empty_cells(cuda, C):
    """C = 80 (16-byte rows) and widths not divisible by 4 (one channel a
    lane; 37 and 130 run in several channel blocks); intervals of 1 point
    and of more than 32; every cell that no interval covers stays zero."""
    depth, ctx, iv, zxy = _pool_inputs(1, seed=C, C=C)
    lengths = iv.interval_lengths
    assert (lengths == 1).any() and (lengths > 32).any()
    depth, ctx = depth.to(cuda), ctx.to(cuda)
    iv = bp.PoolIntervals(*(t.to(cuda) for t in iv))
    got = bp.bev_pool(depth, ctx, iv, *zxy)
    torch.cuda.synchronize()
    _close(got, bp.bev_pool_plain(depth, ctx, iv, *zxy))
    cells = got.permute(0, 2, 3, 1).reshape(-1, C)  # Z = 1: [B*X*Y, C]
    empty = torch.ones(cells.shape[0], dtype=torch.bool, device=cuda)
    empty[iv.interval_cells.long()] = False
    assert empty.any() and not cells[empty].any()


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


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["lut", "in_graph"])
def test_lss_on_card_matches_cpu(cuda, route):
    """A small LSSTransform (the map configs' camera vtransform) on the card,
    its pool through the kernel (one launch per forward), against the same
    module on the CPU."""
    vt = dict(type="LSSTransform", in_channels=24, out_channels=16, image_size=[32, 64],
              feature_size=[4, 8], xbound=[-16.0, 16.0, 0.5], ybound=[-16.0, 16.0, 0.5],
              zbound=[-10.0, 10.0, 20.0], dbound=[1.0, 20.0, 1.0], downsample=2)
    model = init_weights(LSSTransform(**{k: v for k, v in vt.items() if k != "type"}), seed=3)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_calibration(2, 3, (32, 64)).items()}
    if route == "lut":
        cfg = Config.from_dict({"model": {"encoders": {"camera": {"vtransform": vt}}}})
        batch = add_pool_lut(cfg, batch)
    feats = torch.randn(2, 3, 24, 4, 8, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = model.eval()(feats, None, None, batch)
        launches = bp.bev_pool.launches
        got = model.to(cuda)(feats.to(cuda), None, None, batch_to(batch, cuda))
        torch.cuda.synchronize()
    assert bp.bev_pool.launches - launches == 1
    _close(got.cpu(), want)


@pytest.mark.cuda
def test_seg_head_on_card_matches_cpu(cuda):
    """The map head on the card (grid_sample re-gridding, the classifier's
    cuDNN convs, the losses) against the same module on the CPU: eval
    probabilities and, in training, each class's focal loss."""
    grid = {"input_scope": [[-12.0, 12.0, 1.5], [-10.0, 10.0, 1.0]],
            "output_scope": [[-15.0, 11.0, 0.8], [-6.0, 11.0, 0.5]]}
    head = init_weights(BEVSegmentationHead(16, grid, ["drivable_area", "divider"]), seed=4)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 16, 16, 20, generator=g)
    with torch.no_grad():
        want = head.eval()(x)
        got = copy.deepcopy(head).to(cuda)(x.to(cuda))
    assert got.shape == want.shape == (2, 2, 32, 34)
    _close(got.cpu(), want)
    target = (torch.rand(want.shape, generator=g) < 0.3).float()
    want = head.train()(x, target)
    got = copy.deepcopy(head).to(cuda)(x.to(cuda), target.to(cuda))
    assert set(got) == set(want) == {"drivable_area/focal", "divider/focal"}
    for k in want:
        _close(got[k].cpu(), want[k])


@pytest.mark.cuda
def test_time_fn_queue_ahead_gives_the_cards_time(cuda):
    """A call whose host side takes 2 ms and whose kernel takes microseconds:
    events between back-to-back calls give the host's 2 ms; with
    ``queue_ahead`` the card waits until all calls are queued, and the
    interval is the kernel's."""
    import time

    from bevfusion_tpu_torch.utils.profiler import time_fn

    x = torch.zeros(1024, device=cuda)

    def call():
        time.sleep(0.002)
        x.add_(1)

    assert time_fn(call, iters=10, warmup=2)["median_ms"] >= 1.5
    assert time_fn(call, iters=10, warmup=2, queue_ahead=True)["median_ms"] < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 64, 1000])
def test_copy_kernel_equals_plain(cuda, M):
    from bevfusion_tpu_torch.tools import bench_tile_micro as tm

    x = (torch.randn(M, 1024, generator=torch.Generator().manual_seed(M)) * 5).to(torch.bfloat16)
    x = x.to(cuda)
    launches = tm.copy_add_one.launches
    got = tm.copy_add_one(x)
    torch.cuda.synchronize()
    assert tm.copy_add_one.launches == launches + 1
    assert torch.equal(got.view(torch.int16), tm.copy_add_one_plain(x).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["tma", "cp_async"])
@pytest.mark.parametrize("T,R,G,steps", [(16, 8, 2, 3), (16, 8, 3, 5), (40, 1, 8, 64),
                                         (12, 40, 4, 7), (6, 70, 8, 2), (64, 2, 1200, 700),
                                         (8, 130, 2, 900), (300, 1, 8, 2000), (64, 32, 8, 600),
                                         (8, 130, 3, 300)])
def test_gather_kernel_equals_plain(cuda, engine, T, R, G, steps):
    """Both engines bit for bit: tiles of 1 to 130 rows (units of 32 rows or
    stages of whole tiles: one, several, and split tiles of 17.5 and 32.5
    KB with a ragged last chunk), G from 2 to 1200 (a run of steps longer
    than one batch of slots a TMA block stages), more steps than the TMA
    engine's persistent blocks, and runs of many rounds of its ring; each
    launch counted under its engine."""
    from bevfusion_tpu_torch.tools import bench_tile_micro as tm

    pool, slots = tm.gather_inputs(T, R, G, steps, cuda, seed=R + G)
    launches = tm.gather_tiles.launches, tm.gather_tiles.launches_by_engine[engine]
    got = tm.gather_tiles(pool, slots, R, G, engine)
    torch.cuda.synchronize()
    assert (tm.gather_tiles.launches, tm.gather_tiles.launches_by_engine[engine]) == (
        launches[0] + 1, launches[1] + 1)
    assert torch.equal(got.view(torch.int16),
                       tm.gather_tiles_plain(pool, slots, R, G).view(torch.int16))


@pytest.mark.cuda
def test_gather_kernel_rejects_what_it_does_not_take(cuda):
    from bevfusion_tpu_torch.tools import bench_tile_micro as tm

    pool, slots = tm.gather_inputs(8, 4, 4, 2, cuda)
    launches = tm.gather_tiles.launches
    with pytest.raises(ValueError):
        tm.gather_tiles(pool, slots, 4, 1)  # G < 2
    with pytest.raises(TypeError):
        tm.gather_tiles(pool.float(), slots, 4, 4)
    with pytest.raises(TypeError):
        tm.gather_tiles(pool, slots.long(), 4, 4)
    with pytest.raises(ValueError):
        tm.gather_tiles(pool, slots[:-1], 4, 4)
    assert tm.gather_tiles.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,strided", [(16, 16, False), (32, 32, False), (16, 32, True),
                                              (5, 16, False), (64, 128, False)])
@pytest.mark.parametrize("tile", [64, 128])
def test_variant_kernel_modes_match_plain(cuda, cin, cout, strided, tile):
    from bevfusion_tpu_torch.tools import bench_kernel_variants as kv

    feats, nbr, _, w, _ = (t if t is None else t.to(cuda)
                           for t in _conv_operands(cin, cout, strided, seed=2))
    for mode in kv.MODES:
        launches = kv.sparse_conv_variant.launches
        got = kv.sparse_conv_variant(feats, nbr, w, mode, tile)
        torch.cuda.synchronize()
        assert kv.sparse_conv_variant.launches == launches + 1
        _close(got, kv.sparse_conv_variant_plain(feats, nbr, w, mode))
    current = kv.sparse_conv_variant(feats, nbr, w, "current", tile)
    assert torch.equal(kv.sparse_conv_variant(feats, nbr, w, "noskip", tile), current)
    if tile == 64:  # K7 keeps the scalar loop; sparse_conv is now the tensor-core kernel
        _close(current, sp.sparse_conv(feats, nbr, w), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [5, 16, 32, 64])
def test_tc_variant_modes_match_plain(cuda, c):
    """K7's tensor-core family (K1/K2's loop): each mode within 1e-5 of its
    plain version, ``tc`` equal to ``sparse_conv`` without epilogue (at the
    encoder's widths) and ``tc_noskip`` to ``tc`` bit for bit, and ``tc_1xtf32`` (one TF32
    product) visibly off the fp32 conv; each launch counted under its
    family."""
    from bevfusion_tpu_torch.tools import bench_kernel_variants as kv

    feats, nbr, _, w, _ = (t if t is None else t.to(cuda)
                           for t in _conv_operands(c, c, False, seed=3))
    for mode in kv.TC_MODES:
        launches = kv.sparse_conv_variant.launches, kv.sparse_conv_variant.launches_by_family["tc"]
        got = kv.sparse_conv_variant(feats, nbr, w, mode)
        torch.cuda.synchronize()
        assert (kv.sparse_conv_variant.launches,
                kv.sparse_conv_variant.launches_by_family["tc"]) == (launches[0] + 1,
                                                                     launches[1] + 1)
        _close(got, kv.sparse_conv_variant_plain(feats, nbr, w, mode))
    tc = kv.sparse_conv_variant(feats, nbr, w, "tc")
    if c >= 16:  # padded as sparse_conv pads it (c = 5: 16 columns here, 8 there)
        assert torch.equal(tc, sp.sparse_conv(feats, nbr, w))
    _close(tc, sp.sparse_conv(feats, nbr, w))
    assert torch.equal(kv.sparse_conv_variant(feats, nbr, w, "tc_noskip"), tc)
    one = kv.sparse_conv_variant(feats, nbr, w, "tc_1xtf32")
    assert (one - tc).abs().max().item() > 1e-5 * tc.abs().max().item()


@pytest.mark.cuda
def test_tc_variant_rejects_what_it_does_not_take(cuda):
    from bevfusion_tpu_torch.tools import bench_kernel_variants as kv

    feats, nbr, _, w, _ = (t if t is None else t.to(cuda)
                           for t in _conv_operands(16, 32, True, seed=1))
    launches = kv.sparse_conv_variant.launches
    with pytest.raises(ValueError):
        kv.sparse_conv_variant(feats, nbr, w, "tc")  # Cin != Cout
    with pytest.raises(ValueError):
        kv.sparse_conv_variant(feats, nbr, w[:, :, :16].contiguous(), "tc", 128)
    assert kv.sparse_conv_variant.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("n,density", [(1, 0.5), (37, 0.1), (500, 0.0), (500, 0.02), (500, 1.0),
                                       (1000, 0.005), (1300, 0.3)])
def test_nms_kernel_equals_plain(cuda, n, density):
    """The greedy pass of NMS (``csrc/nms.cu``) equal to its plain version
    bit for bit: P = 3 problems, every row density from nothing suppressed
    to everything, N below and above the block's 256 threads."""
    from bevfusion_tpu_torch.ops import nms

    g = torch.Generator().manual_seed(n)
    sup = torch.rand(3, n, n, generator=g) < density
    order = torch.stack([torch.randperm(n, generator=g) for _ in range(3)])
    want = nms.greedy_suppress_plain(sup, order)
    launches = nms.greedy_suppress.launches
    got = nms.greedy_suppress(sup.to(cuda), order.to(cuda))
    torch.cuda.synchronize()
    assert nms.greedy_suppress.launches == launches + 1
    assert got.dtype == torch.bool and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_nms_kernel_rejects_what_it_does_not_take(cuda):
    from bevfusion_tpu_torch.ops import nms

    sup = torch.zeros(2, 8, 8, dtype=torch.bool, device=cuda)
    order = torch.arange(8, device=cuda).repeat(2, 1)
    launches = nms.greedy_suppress.launches
    with pytest.raises(TypeError):
        nms.greedy_suppress(sup.float(), order)
    with pytest.raises(TypeError):
        nms.greedy_suppress(sup, order.int())
    with pytest.raises(ValueError):
        nms.greedy_suppress(sup[:, :4], order)
    with pytest.raises(ValueError):
        nms.greedy_suppress(sup.transpose(1, 2), order)
    assert nms.greedy_suppress.launches == launches


@pytest.mark.cuda
def test_centerhead_decode_on_card_matches_cpu(cuda):
    """CenterHead's ``get_bboxes`` (the camera configs' circle / rotated NMS
    mix) on the card and on the CPU, on the same maps: the same keep masks
    and labels, boxes and scores within 1e-5."""
    from bevfusion_tpu_torch.config import load_config
    from bevfusion_tpu_torch.models.heads.centerpoint import CenterHead
    from bevfusion_tpu_torch.ops import nms
    from bevfusion_tpu_torch.runtime.flagship import DET_CAMERA_CONFIGS, DET_HEAD_MODERATE

    cfg = dict(load_config(DET_CAMERA_CONFIGS["resnet"]).model.heads.object)
    cfg.pop("type")
    head = CenterHead(**dict(cfg, in_channels=8, share_conv_channel=8))
    g = torch.Generator().manual_seed(0)
    preds = []
    for task in head.task_heads:  # 128 x 128 cells, scores over (0, 1), boxes of 0.5-3 m
        preds.append({k: torch.randn(2, getattr(task, k)[-1].out_channels, 128, 128,
                                     generator=g) * s + m
                      for k, (m, s) in DET_HEAD_MODERATE.items()})
    want = head.get_bboxes(preds)
    launches = nms.greedy_suppress.launches
    got = head.get_bboxes([{k: v.to(cuda) for k, v in p.items()} for p in preds])
    torch.cuda.synchronize()
    assert nms.greedy_suppress.launches == launches + 6
    assert torch.equal(got["mask"].cpu(), want["mask"]) and want["mask"].sum() > 100
    assert torch.equal(got["labels"].cpu(), want["labels"])
    _close(got["scores"].cpu(), want["scores"])
    _close(got["bboxes"].cpu()[want["mask"]], want["bboxes"][want["mask"]])


@pytest.mark.cuda
@pytest.mark.parametrize("name,want", [("pointpillars", (0, 0, 0)), ("camera+radar", (0, 1, 6))])
def test_pillar_config_frame_launches(cuda, name, want):
    """One eval frame of each pillar config at full width on the card: its
    launches of the sparse-conv, BEV-pool and NMS kernels (PointPillars runs
    no hand kernel; camera + radar pools once and runs one NMS pass a task);
    PointPillars' box fields finite (CenterHead's maps at random init run
    to where ``exp(dim)`` overflows: chip_smoke.py moderates them first)."""
    from bevfusion_tpu_torch.ops import nms
    from bevfusion_tpu_torch.runtime.flagship import PILLAR_CONFIGS, build_flagship

    _, model, batch = build_flagship(cuda, config_path=PILLAR_CONFIGS[name])
    kernels = (sp.sparse_conv, bp.bev_pool, nms.greedy_suppress)
    before = [k.launches for k in kernels]
    with torch.no_grad():
        boxes = model(batch)["boxes"]
    torch.cuda.synchronize()
    assert tuple(k.launches - b for k, b in zip(kernels, before)) == want
    assert name != "pointpillars" or all(torch.isfinite(v.float()).all() for v in boxes.values())
