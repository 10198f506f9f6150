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


def _nms_boxes(n, seed, spread=20.0):
    """[n, 5] BEV boxes (cx, cy, dx, dy, yaw) in a 2 * spread square, sizes
    0.5-5 m, any yaw; made on the CPU from a seed."""
    g = torch.Generator().manual_seed(seed)
    return torch.cat([torch.rand(n, 2, generator=g) * 2 * spread - spread,
                      torch.rand(n, 2, generator=g) * 4.5 + 0.5,
                      (torch.rand(n, 1, generator=g) * 2 - 1) * np.pi], -1)


def _words_case(kind, n, seed):
    """N1's operands for one problem: ``kind`` random, identical, nested,
    edges (unit squares sharing edges, every other turned by pi / 2),
    zero (a third with a zero dim) or yaw (yaw at +-pi and within 1e-6)."""
    from bevfusion_tpu_torch.ops import nms

    b = _nms_boxes(n, seed, spread=20.0 if kind == "random" else 2.0)
    thr = 0.2
    if kind == "identical":
        b[:] = b[0]
    elif kind == "nested":
        b[:, :2], b[:, 4] = b[0, :2], b[0, 4]
    elif kind == "edges":
        k = torch.arange(n)
        b = torch.stack([(k % 10).float(), (k // 10).float(), torch.ones(n), torch.ones(n),
                         (k % 2).float() * np.pi / 2], -1)
        thr = 0.0
    elif kind == "zero":
        b[: n // 3, 2] = 0.0
        b[n // 6: n // 2, 3] = 0.0
    elif kind == "yaw":
        b[:, 4] = torch.tensor([np.pi, -np.pi, np.pi - 1e-6, -np.pi + 1e-6]).repeat(n)[:n]
    return nms.box_geometry(b[None]), torch.tensor([True]), torch.tensor([thr])


def _assert_words(got, want, geom, rotated, thr):
    """N1's words equal the plain version's but where the plain IoU lies
    within 2^-20 of the threshold (``nms.near_threshold``)."""
    from bevfusion_tpu_torch.ops import nms

    diff = nms.unpack_words(got.cpu() ^ want.cpu(), geom.shape[1])
    assert not (diff & ~nms.near_threshold(geom.cpu(), rotated.cpu(), thr.cpu())).any(), \
        diff.nonzero().tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n", [("random", 1), ("random", 63), ("random", 64), ("random", 65),
                                    ("random", 500), ("random", 1300), ("identical", 100),
                                    ("nested", 100), ("edges", 100), ("zero", 100),
                                    ("yaw", 100)])
def test_nms_words_kernel_matches_plain(cuda, kind, n):
    """N1 (``csrc/nms.cu``) against ``suppression_words_plain`` on the same
    CUDA tensors, one launch for one problem."""
    from bevfusion_tpu_torch.ops import nms

    args = [t.to(cuda) for t in _words_case(kind, n, seed=n)]
    want = nms.suppression_words_plain(*args)
    launches = nms.suppression_words.launches
    got = nms.suppression_words(*args)
    torch.cuda.synchronize()
    assert nms.suppression_words.launches == launches + 1
    assert got.dtype == torch.int64 and got.shape == want.shape
    _assert_words(got, want, *args)
    assert kind != "identical" or nms.unpack_words(want, n)[0, 0, 1:].all()


@pytest.mark.cuda
def test_nms_words_kernel_mixes_problems_in_one_launch(cuda):
    """Six problems in one launch, circle and rotated mixed with their own
    thresholds (a camera CenterHead frame's shape at N = 200), and each
    problem's IoU bits exact: with the threshold set to a pair's plain IoU,
    and to the float below it, the kernel's bit for that pair is the plain
    version's both times."""
    from bevfusion_tpu_torch.ops import nms
    from bevfusion_tpu_torch.ops.iou3d import iou_corners

    b = torch.stack([_nms_boxes(200, seed, spread=8.0) for seed in range(6)]).to(cuda)
    rotated = torch.tensor([False, True, True, False, True, True], device=cuda)
    geom = torch.where(rotated[:, None, None], nms.box_geometry(b),
                       nms.center_geometry(b[..., :2]))
    thr = torch.tensor([4.0, 0.2, 0.1, 1.0, 0.3, 0.2], device=cuda)
    got = nms.suppression_words(geom, rotated, thr)
    _assert_words(got, nms.suppression_words_plain(geom, rotated, thr), geom, rotated, thr)
    corners, area = geom[1, :, :8].view(200, 4, 2), geom[1, :, 8]
    iou = iou_corners(corners, area, corners, area).triu(1)
    pairs = (iou > 0.05).nonzero()[:16]
    assert len(pairs) == 16
    at = iou[pairs[:, 0], pairs[:, 1]]
    thr = torch.cat([at, torch.nextafter(at, torch.zeros_like(at))]).contiguous()
    P = len(thr)
    g = geom[1:2].expand(P, -1, -1).contiguous()
    r = torch.ones(P, dtype=torch.bool, device=cuda)
    got = nms.unpack_words(nms.suppression_words(g, r, thr), 200)
    want = nms.unpack_words(nms.suppression_words_plain(g, r, thr), 200)
    i, j = pairs.repeat(2, 1).unbind(-1)
    p = torch.arange(P, device=cuda)
    assert torch.equal(got[p, i, j], want[p, i, j])
    assert not want[p[:16], i[:16], j[:16]].any() and want[p[16:], i[16:], j[16:]].all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,density", [(1, 0.5), (37, 0.1), (500, 0.0), (500, 0.02), (500, 1.0),
                                       (1000, 0.005), (1300, 0.3)])
def test_nms_kernel_equals_plain(cuda, n, density):
    """N2, the greedy pass on words (``csrc/nms.cu``), equal to its plain
    version bit for bit: P = 3 problems, every row density from nothing
    suppressed to everything, N from one word to 21 (1300: not a multiple of
    64); the lower triangle's bits set too, which the pass ignores."""
    from bevfusion_tpu_torch.ops import nms

    g = torch.Generator().manual_seed(n)
    sup = torch.rand(3, n, n, generator=g) < density
    order = torch.stack([torch.randperm(n, generator=g) for _ in range(3)])
    want = nms.greedy_suppress_plain(sup, order)
    launches = nms.greedy_suppress_words.launches
    got = nms.greedy_suppress(sup.to(cuda), order.to(cuda))
    torch.cuda.synchronize()
    assert nms.greedy_suppress_words.launches == launches + 1
    assert got.dtype == torch.bool and torch.equal(got.cpu(), want)


def _greedy_words_np(words, order):
    """The greedy pass on one problem's words in numpy, a row at a time
    (bits at or below the diagonal masked off): keep in index order."""
    w = words.view(np.uint64)
    n = w.shape[0]
    removed, kept = np.zeros(w.shape[1], np.uint64), np.zeros(n, bool)
    for i in range(n):
        b, s = divmod(i, 64)
        if (int(removed[b]) >> s) & 1:
            continue
        kept[i] = True
        row = w[i].copy()
        row[:b] = 0
        row[b] &= np.uint64(~((1 << (s + 1)) - 1) & (2**64 - 1))
        removed |= row
    keep = np.zeros(n, bool)
    keep[order] = kept
    return keep


@pytest.mark.cuda
def test_nms_greedy_kernel_streams_large_n(cuda):
    """N2 at N = 20,000 (313 words a row: 32-row chunks of words) and at the
    largest N, 49,152 (768 words: 16-row chunks), on words of three random
    bits a row (below the diagonal too), against the pass in numpy; above
    the largest N the wrapper raises."""
    from bevfusion_tpu_torch.ops import nms

    for n in (20000, nms.MAX_N):
        g = torch.Generator(device=cuda).manual_seed(n)
        words = torch.zeros(1, n, nms.words_count(n), dtype=torch.int64, device=cuda)
        cols = torch.randint(0, n, (n, 3), generator=g, device=cuda)
        words[0].scatter_(1, cols // 64, torch.ones_like(cols) << (cols % 64))
        order = torch.randperm(n, generator=g, device=cuda)[None]
        got = nms.greedy_suppress_words(words, order)
        torch.cuda.synchronize()
        want = _greedy_words_np(words[0].cpu().numpy(), order[0].cpu().numpy())
        assert 0 < want.sum() < n and np.array_equal(got[0].cpu().numpy(), want)
    with pytest.raises(ValueError):
        nms.greedy_suppress_words(torch.zeros(1, nms.MAX_N + 1, nms.words_count(nms.MAX_N + 1),
                                              dtype=torch.int64, device=cuda),
                                  torch.arange(nms.MAX_N + 1, device=cuda)[None])


@pytest.mark.cuda
def test_nms_kernel_rejects_what_it_does_not_take(cuda):
    """N1's and N2's wrappers refuse wrong dtypes, shapes, devices and
    non-contiguous operands, and launch nothing."""
    from bevfusion_tpu_torch.ops import nms

    words = torch.zeros(2, 8, 1, dtype=torch.int64, device=cuda)
    order = torch.arange(8, device=cuda).repeat(2, 1)
    geom = torch.zeros(2, 8, nms.GEOM, device=cuda)
    rotated, thr = torch.ones(2, dtype=torch.bool, device=cuda), torch.zeros(2, device=cuda)
    launches = nms.suppression_words.launches, nms.greedy_suppress_words.launches
    for bad in ((words.int(), order), (words, order.int()), (words[:, :4], order),
                (torch.zeros(2, 8, 2, dtype=torch.int64, device=cuda), order),
                (torch.zeros(2, 8, 2, dtype=torch.int64, device=cuda)[..., :1], order),
                (words, order.cpu())):
        with pytest.raises(ValueError):
            nms.greedy_suppress_words(*bad)
    for bad in ((geom.double(), rotated, thr), (geom, rotated.to(torch.uint8), thr),
                (geom, rotated, thr[:1]), (geom[..., :8], rotated, thr),
                (geom.transpose(0, 1).contiguous().transpose(0, 1), rotated, thr),
                (geom, rotated, thr.cpu()), (geom, rotated, thr.double())):
        with pytest.raises(ValueError):
            nms.suppression_words(*bad)
    assert (nms.suppression_words.launches, nms.greedy_suppress_words.launches) == launches


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
    launches = nms.suppression_words.launches, nms.greedy_suppress_words.launches
    got = head.get_bboxes([{k: v.to(cuda) for k, v in p.items()} for p in preds])
    torch.cuda.synchronize()
    # the six tasks' two samples: twelve problems, one launch of each kernel
    assert (nms.suppression_words.launches, nms.greedy_suppress_words.launches) == \
        (launches[0] + 1, launches[1] + 1)
    assert torch.equal(got["mask"].cpu(), want["mask"]) and want["mask"].sum() > 100
    assert torch.equal(got["labels"].cpu(), want["labels"])
    _close(got["scores"].cpu(), want["scores"])
    _close(got["bboxes"].cpu()[want["mask"]], want["bboxes"][want["mask"]])


@pytest.mark.cuda
@pytest.mark.parametrize("name,want", [("pointpillars", (0, 0, 0, 0)),
                                       ("camera+radar", (0, 1, 1, 1))])
def test_pillar_config_frame_launches(cuda, name, want):
    """One eval frame of each pillar config at full width on the card: its
    launches of the sparse-conv, BEV-pool and NMS kernels N1 and N2
    (PointPillars runs no hand kernel; camera + radar pools once and runs its
    six tasks' NMS as one launch of each);
    PointPillars' box fields finite (CenterHead's maps at random init run
    to where ``exp(dim)`` overflows: chip_smoke.py moderates them first)."""
    from bevfusion_tpu_torch.ops import nms
    from bevfusion_tpu_torch.runtime.flagship import PILLAR_CONFIGS, build_flagship

    _, model, batch = build_flagship(cuda, config_path=PILLAR_CONFIGS[name])
    kernels = (sp.sparse_conv, bp.bev_pool, nms.suppression_words, nms.greedy_suppress_words)
    before = [k.launches for k in kernels]
    with torch.no_grad():
        boxes = model(batch)["boxes"]
    torch.cuda.synchronize()
    assert tuple(k.launches - b for k, b in zip(kernels, before)) == want
    assert name != "pointpillars" or all(torch.isfinite(v.float()).all() for v in boxes.values())


# ----------------------------------------------------------------------
# the bf16 forms: bf16 rows, one bf16 tensor-core product a step, fp32 sums
# ----------------------------------------------------------------------

BF16_EPS = 2.0 ** -7  # one bf16 rounding, relative (8 significant bits)


def _close_bf16(got, want, fp32_tol=1e-4):
    """Each element of a bf16 result within one bf16 rounding of its plain
    version, plus the fp32 summation-order gate on the scale (the two fp32
    sums differ in order, then each rounds once)."""
    got, want = got.float(), want.float()
    scale = max(want.abs().max().item(), 1.0)
    bad = (got - want).abs() > BF16_EPS * want.abs() + fp32_tol * scale
    assert not bad.any(), (int(bad.sum()), (got - want).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,strided", [
    (5, 16, False), (8, 16, False), (16, 16, False), (16, 32, True), (32, 32, False),
    (32, 64, True), (64, 64, False), (64, 128, True), (128, 128, False), (5, 7, False),
    (12, 20, False),
])
@pytest.mark.parametrize("epilogue", [False, True])
def test_sparse_conv_bf16_kernel_matches_plain(cuda, cin, cout, strided, epilogue):
    """The bf16 form at every channel padding (Cin 5 and 12: synchronous
    2-byte row loads; odd Cout: unpaired columns) with and without the
    fp32 epilogue, against the bf16 plain version (fp32 product and
    epilogue, one rounding); counted on its own; equal bits across two
    calls; the fp32 kernel is not launched."""
    feats, nbr, _, w, _ = _conv_operands(cin, cout, strided, seed=2)
    g = torch.Generator().manual_seed(cin + cout)
    kw = _to(_epilogue_kw(cout, nbr.shape[1], g), cuda) if epilogue else {}
    if "residual" in kw:
        kw["residual"] = kw["residual"].bfloat16()
    args = (feats.to(cuda).bfloat16(), nbr.to(cuda), w.to(cuda).bfloat16())
    before = sp.sparse_conv.launches, sp.sparse_conv_bf16.launches
    got = sp.sparse_conv(*args, **kw)
    torch.cuda.synchronize()
    assert (sp.sparse_conv.launches, sp.sparse_conv_bf16.launches) == (before[0], before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == (nbr.shape[1], cout)
    _close_bf16(got, sp.sparse_conv_plain(*args, **kw))
    assert torch.equal(sp.sparse_conv(*args, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 64])
def test_sparse_conv_bf16_kernel_misses(cuda, c):
    """Entries >= cap_in are misses; a tile every offset misses writes
    epilogue(0) rounded to bf16 (padded rows hold relu(shift + residual)),
    with W resident (C = 16) and in the ring (C = 64)."""
    grid = sp.SparseGrid(30, 30, 10)
    ids = _sites(5, grid, 2000, 2100)
    nbr = sp.build_subm_rulebook(ids, grid)
    nbr[:, 128:192] = torch.where(torch.arange(27)[:, None] % 2 == 0, -1, 10 ** 6).int()
    want_nbr = torch.where(nbr >= nbr.shape[1], -1, nbr).int()
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(ids.shape[0], c, generator=g).bfloat16().to(cuda)
    w = (torch.randn(27, c, c, generator=g) / (20 if c == 16 else 4 * c)).bfloat16().to(cuda)
    kw = _to(_epilogue_kw(c, nbr.shape[1], g), cuda)
    kw["residual"] = kw["residual"].bfloat16()
    got = sp.sparse_conv(feats, nbr.to(cuda), w, **kw)
    torch.cuda.synchronize()
    _close_bf16(got, sp.sparse_conv_plain(feats, want_nbr.to(cuda), w, **kw))
    empty = torch.relu(kw["shift"] + kw["residual"][128:192].float()).bfloat16()
    assert torch.equal(got[128:192], empty)
    no_shift = sp.sparse_conv(feats, nbr.to(cuda), w, shift=kw["shift"], relu=True)
    assert torch.equal(no_shift[128:192], torch.relu(kw["shift"]).bfloat16().expand(64, c))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,sites", [(16, 16, 40), (64, 64, 40), (32, 32, 2000),
                                             (5, 16, 900)])
def test_sparse_conv_bf16_kernel_small_grids(cuda, cin, cout, sites):
    """A single tile (40 sites) and caps that are not a multiple of the
    tile (64 sites a 16-row slab a warp): the kernel against its plain
    version, equal bits across two calls, and its plan's grid one block a
    tile."""
    grid = sp.SparseGrid(20, 20, 10)
    cap = sites + 23
    ids = _sites(cin + sites, grid, sites, cap)
    nbr = sp.build_subm_rulebook(ids, grid).to(cuda)
    g = torch.Generator().manual_seed(sites)
    feats = torch.randn(cap, cin, generator=g).bfloat16().to(cuda)
    w = (torch.randn(27, cin, cout, generator=g) / (27 * cin) ** 0.5).bfloat16().to(cuda)
    kw = _to(_epilogue_kw(cout, cap, g), cuda)
    kw["residual"] = kw["residual"].bfloat16()
    got = sp.sparse_conv(feats, nbr, w, **kw)
    torch.cuda.synchronize()
    _close_bf16(got, sp.sparse_conv_plain(feats, nbr, w, **kw))
    assert torch.equal(sp.sparse_conv(feats, nbr, w, **kw), got)
    plan = sp.sparse_conv_bf16_plan(cap, 27, cin, cout)
    assert plan["grid"] == -(-cap // (64 * plan["slabs"]))
    assert plan["blocks_per_sm"] >= 1 and plan["stages"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("c", [5, 16, 32, 64])
def test_bf16_variant_modes_match_plain_and_every_plan_the_same_bits(cuda, c):
    """K7's bf16 family (K1/K2 bf16's loop): each mode within one bf16
    rounding of its plain version, ``bf16`` equal to ``sparse_conv`` on the
    bf16 operands without epilogue and ``bf16_noskip`` to ``bf16`` bit for
    bit; and ``bf16`` at every depth of its ring (3-8 stages, 1-6 offsets
    ahead) equal to ``sparse_conv`` bit for bit: the order of summation does
    not depend on the plan."""
    from bevfusion_tpu_torch.tools import bench_kernel_variants as kv

    feats, nbr, _, w, _ = (t if t is None else t.to(cuda)
                           for t in _conv_operands(c, c, False, seed=3))
    x, w16 = feats.bfloat16(), w.bfloat16()
    for mode in kv.BF16_MODES:
        before = kv.sparse_conv_variant.launches_by_family["bf16"]
        got = kv.sparse_conv_variant(x, nbr, w16, mode)
        torch.cuda.synchronize()
        assert kv.sparse_conv_variant.launches_by_family["bf16"] == before + 1
        assert got.dtype == torch.bfloat16
        _close_bf16(got, kv.sparse_conv_variant_plain(x, nbr, w16, mode))
    want = sp.sparse_conv(x, nbr, w16)
    assert torch.equal(kv.sparse_conv_variant(x, nbr, w16, "bf16"), want)
    assert torch.equal(kv.sparse_conv_variant(x, nbr, w16, "bf16_noskip"), want)
    plans = 0
    for stages in range(3, 9):
        try:
            kv.bf16_plan(c, 27, nbr.shape[1], stages=stages)
        except RuntimeError:
            continue
        plans += 1
        assert torch.equal(kv.sparse_conv_variant(x, nbr, w16, "bf16", stages=stages), want), stages
    assert plans >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,strided", [
    (5, 16, False), (16, 16, False), (16, 32, True), (32, 32, False), (32, 64, True),
    (64, 64, False), (64, 128, True), (128, 128, False), (3, 70, False), (12, 8, False),
])
def test_weight_gradient_bf16_kernel_matches_plain(cuda, cin, cout, strided):
    """The bf16 form of the weight gradient: bf16 feats and dout, fp32 dW
    within the fp32 summation-order gate of the plain version (the bf16
    products are exact in fp32); counted on its own; equal bits across two
    calls."""
    feats, nbr, _, _, dout = _conv_operands(cin, cout, strided, seed=3)
    feats, nbr, dout = feats.to(cuda).bfloat16(), nbr.to(cuda), dout.to(cuda).bfloat16()
    before = sp.sparse_conv_dw.launches, sp.sparse_conv_dw_bf16.launches
    got = sp.sparse_conv_dw(feats, nbr, dout)
    torch.cuda.synchronize()
    assert (sp.sparse_conv_dw.launches, sp.sparse_conv_dw_bf16.launches) == (before[0],
                                                                              before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (27, cin, cout)
    _close(got, sp.sparse_conv_dw_plain(feats, nbr, dout), tol=1e-4)
    assert torch.equal(sp.sparse_conv_dw(feats, nbr, dout), got)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,sites", [(16, 16, 40), (64, 64, 300), (5, 16, 900),
                                             (32, 32, 1000), (3, 5, 700)])
def test_weight_gradient_bf16_kernel_small_caps(cuda, cin, cout, sites):
    """Caps of one chunk (DW_CHUNK sites) and not a multiple of the chunk,
    fewer hit pairs than a block's teams' first stages; P too by 4-byte
    words (3 -> 5): the kernel against its plain version, equal bits across
    two calls."""
    grid = sp.SparseGrid(20, 20, 10)
    cap = sites + 23
    ids = _sites(cin + sites, grid, sites, cap)
    nbr = sp.build_subm_rulebook(ids, grid).to(cuda)
    g = torch.Generator().manual_seed(sites)
    feats = torch.randn(cap, cin, generator=g).bfloat16().to(cuda)
    dout = torch.randn(cap, cout, generator=g).bfloat16().to(cuda)
    got = sp.sparse_conv_dw(feats, nbr, dout)
    torch.cuda.synchronize()
    _close(got, sp.sparse_conv_dw_plain(feats, nbr, dout), tol=1e-4)
    assert torch.equal(sp.sparse_conv_dw(feats, nbr, dout), got)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,team,teams", [
    (5, 16, 1, 4), (16, 16, 1, 4), (16, 32, 1, 4), (32, 32, 1, 4), (32, 64, 2, 2),
    (64, 64, 4, 2), (3, 70, 4, 2), (128, 128, 8, 1),
])
def test_weight_gradient_bf16_kernel_plan(cuda, cin, cout, team, teams):
    """What pass 1 runs at each width: a block a chunk of DW_CHUNK output
    sites and offset, teams of 1-8 warps (``sparse_conv_dw_bf16.cuh``'s
    Layout: 16-row slabs of the wider operand, two a warp where the
    narrower is 8-32 wide), two teams a block of 4 to 8 warps, at least 2
    stages, two blocks an SM at the encoder's widths; no spills."""
    plan = sp.sparse_conv_dw_bf16_plan(60000, 27, cin, cout)
    assert plan["grid"] == -(-60000 // sp.DW_CHUNK) * 27
    assert (plan["team_warps"], plan["teams"]) == (team, teams)
    assert plan["threads"] == 32 * team * teams and plan["stages"] >= 2
    assert plan["spill_bytes"] == 0 and plan["blocks_per_sm"] >= 1
    if max(cin, cout) <= 64:
        assert plan["blocks_per_sm"] >= 2


@pytest.mark.cuda
def test_weight_gradient_bf16_kernel_equal_bits_across_streams(cuda):
    """Two calls on two streams at once, each with its own output and
    scratch: equal bits to a call on the default stream."""
    feats, nbr, _, _, dout = _conv_operands(64, 64, False, seed=5)
    feats, nbr, dout = feats.to(cuda).bfloat16(), nbr.to(cuda), dout.to(cuda).bfloat16()
    want = sp.sparse_conv_dw(feats, nbr, dout)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    got = []
    for st in streams:
        with torch.cuda.stream(st):
            got.append(sp.sparse_conv_dw(feats, nbr, dout))
    torch.cuda.synchronize()
    for g in got:
        assert torch.equal(g, want)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 32, 64])
def test_dw_bf16_variant_modes_match_plain(cuda, c):
    """K7's dw_bf16 family (K3 bf16's kernel): ``dw_bf16`` equal to
    ``sparse_conv_dw`` bit for bit and within 1e-4 of its plain version,
    ``dw_bf16_nogather`` within 1e-4 of its own, the two counting modes
    equal to the hit counts; each launch counted."""
    from bevfusion_tpu_torch.tools import bench_kernel_variants as kv

    feats, nbr, _, _, dout = _conv_operands(c, c, False, seed=6)
    x, nbr, d = feats.to(cuda).bfloat16(), nbr.to(cuda), dout.to(cuda).bfloat16()
    for mode in kv.DW_BF16_MODES:
        before = kv.sparse_conv_dw_variant.launches
        got = kv.sparse_conv_dw_variant(x, nbr, d, mode)
        torch.cuda.synchronize()
        assert kv.sparse_conv_dw_variant.launches == before + 1
        want = kv.sparse_conv_dw_variant_plain(x, nbr, d, mode)
        if mode in ("dw_bf16", "dw_bf16_nogather"):
            _close(got, want, tol=1e-4)
        else:
            assert torch.equal(got, want)
    assert torch.equal(kv.sparse_conv_dw_variant(x, nbr, d), sp.sparse_conv_dw(x, nbr, d))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(5, 16), (32, 64), (128, 128)])
def test_weight_gradient_bf16_kernel_misses(cuda, cin, cout):
    cap_in, cap_out = 3000, 3 * sp.DW_CHUNK + 100
    nbr, clean = (t.to(cuda) for t in _dw_table(cap_in, cap_out, seed=cin + cout))
    g = torch.Generator(device=cuda).manual_seed(cin * cout)
    feats = torch.randn(cap_in, cin, generator=g, device=cuda).bfloat16()
    dout = torch.randn(cap_out, cout, generator=g, device=cuda).bfloat16()
    got = sp.sparse_conv_dw(feats, nbr, dout)
    torch.cuda.synchronize()
    _close(got, sp.sparse_conv_dw_plain(feats, clean, dout), tol=1e-4)
    assert not got[3].any()
    assert got[5].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,strided", [(16, 16, False), (16, 32, True), (64, 64, False)])
def test_sparse_conv_function_bf16_on_card(cuda, cin, cout, strided):
    """bf16 features, the fp32 weight parameter: the forward and backward-data
    through the bf16 kernel, the weight gradient the bf16 K3's fp32 dW (not
    rounded to bf16), against autograd of the bf16 plain version."""
    feats, nbr, nbr_t, w, dout = (t if t is None else t.to(cuda)
                                  for t in _conv_operands(cin, cout, strided, seed=4))
    x = feats.bfloat16().requires_grad_()
    wt = w.clone().requires_grad_()
    before = sp.sparse_conv_bf16.launches, sp.sparse_conv_dw_bf16.launches
    y = sp.SparseConvFunction.apply(x, wt, nbr, nbr_t)
    y.backward(dout.bfloat16())
    torch.cuda.synchronize()
    assert (sp.sparse_conv_bf16.launches - before[0], sp.sparse_conv_dw_bf16.launches
            - before[1]) == (2, 1)
    assert y.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16
    assert wt.grad.dtype == torch.float32
    want_dw = sp.sparse_conv_dw_plain(x.detach(), nbr, dout.bfloat16())
    _close(wt.grad, want_dw, tol=1e-4)
    assert not torch.equal(wt.grad, wt.grad.bfloat16().float())  # fp32, not rounded to bf16
    x0 = feats.bfloat16().requires_grad_()
    sp.sparse_conv_plain(x0, nbr, w.bfloat16()).backward(dout.bfloat16())
    _close_bf16(x.grad, x0.grad)


@pytest.mark.cuda
def test_sparse_conv_bf16_rejects_mixed_dtypes(cuda):
    feats = torch.randn(10, 16, device=cuda).bfloat16()
    nbr = torch.zeros(27, 10, dtype=torch.int32, device=cuda)
    w = torch.randn(27, 16, 16, device=cuda)
    with pytest.raises(TypeError):
        sp.sparse_conv(feats, nbr, w)  # fp32 weight with bf16 rows
    with pytest.raises(TypeError):
        sp.sparse_conv(feats, nbr, w.bfloat16(), scale=torch.ones(16, device=cuda).bfloat16())
    with pytest.raises(TypeError):
        sp.sparse_conv(feats, nbr, w.bfloat16(), residual=torch.zeros(10, 16, device=cuda))
    with pytest.raises(TypeError):
        sp.sparse_conv(feats.float(), nbr, w.bfloat16())
    with pytest.raises(TypeError):
        sp.sparse_conv_dw(feats, nbr, torch.randn(10, 16, device=cuda))
    with pytest.raises(ValueError):
        sp.sparse_conv_bf16(feats.cpu(), nbr.cpu(), w.bfloat16().cpu())


@pytest.mark.cuda
def test_custom_ops_fake_is_the_cuda_implementations_meta_and_counts_its_launches(cuda):
    """Each ``bevfusion::`` op on CUDA tensors: its fake (shape-only) form
    gives the CUDA implementation's shape, dtype and strides, and the call
    adds one to its wrapper's launch count (``ops/library.py``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from bevfusion_tpu_torch.ops import library, nms

    grid = sp.SparseGrid(12, 10, 6)
    ids = _sites(0, grid, 80, 96).to(cuda)
    nbr = sp.build_subm_rulebook(ids, grid)
    feats, w = torch.randn(96, 8, device=cuda), torch.randn(27, 8, 16, device=cuda) * 0.2
    dout = torch.randn(96, 16, device=cuda)
    depth, ctx = torch.rand(1, 2, 4, 3, 5, device=cuda), torch.randn(1, 2, 3, 5, 6, device=cuda)
    cells = torch.randint(0, 20, (1, 2, 4, 3, 5), device=cuda)
    iv = bp.build_intervals(cells, torch.ones_like(cells, dtype=torch.bool), 20)
    words = torch.randint(-2**62, 2**62, (3, 40, 1), device=cuda)
    order = torch.stack([torch.randperm(40, device=cuda) for _ in range(3)])
    geom = torch.randn(3, 40, 9, device=cuda)
    cases = {"sparse_conv": (feats, nbr, w, None, None, None, False),
             "sparse_conv_bf16": (feats.bfloat16(), nbr, w.bfloat16(), None, None, None, True),
             "sparse_conv_dw": (feats, nbr, dout),
             "sparse_conv_dw_bf16": (feats.bfloat16(), nbr, dout.bfloat16()),
             "bev_pool": (depth, ctx, *iv, 1, 4, 5),
             "suppression_words": (geom, torch.tensor([True, False, True], device=cuda),
                                   torch.tensor([0.2, 4.0, 0.5], device=cuda)),
             "greedy_suppress_words": (words, order),
             "deform_im2col": (torch.randn(1, 5, 6, 4, device=cuda),
                               torch.randn(1, 5, 6, 18, device=cuda), None, 3, 1, 1),
             "furthest_point_sample": (torch.randn(2, 50, 3, device=cuda), 10, None),
             "auction": (torch.rand(6, 9, device=cuda), torch.ones(6, dtype=torch.bool,
                                                                    device=cuda),
                         torch.tensor(0.01, device=cuda), 50)}
    assert set(cases) == set(library.OPS)
    for name, args in cases.items():
        op = getattr(torch.ops.bevfusion, name)
        before = library.COUNTERS[name].launches
        real = op(*args)
        torch.cuda.synchronize()
        assert library.COUNTERS[name].launches == before + 1, name
        with FakeTensorMode() as mode:
            fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
        real, fake = ((x,) if isinstance(x, torch.Tensor) else x for x in (real, fake))
        assert [(f.shape, f.dtype, f.stride(), f.device.type) for f in fake] == [
            (r.shape, r.dtype, r.stride(), r.device.type) for r in real], name
    assert library.COUNTERS["suppression_words"] is nms.suppression_words
    assert library.COUNTERS["greedy_suppress_words"] is nms.greedy_suppress_words


def _deform_inputs(cuda, B, H, W, C, stride, modulated):
    """Offsets of a few pixels, some taps on integers, some wholly outside."""
    g = torch.Generator(device=cuda).manual_seed(B * H + C)
    Ho, Wo = (H + 2 - 3) // stride + 1, (W + 2 - 3) // stride + 1
    x = torch.randn(B, H, W, C, generator=g, device=cuda)
    off = torch.rand(B, Ho, Wo, 18, generator=g, device=cuda) * 6 - 3
    on_int = torch.rand(off.shape, generator=g, device=cuda) < 0.3
    off = torch.where(on_int, off.round(), off)
    off = torch.where(torch.rand(off.shape, generator=g, device=cuda) < 0.05, 40.0, off)
    mask = torch.rand(B, Ho, Wo, 9, generator=g, device=cuda) if modulated else None
    return x, off, mask


@pytest.mark.cuda
@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("B,H,W,C,stride", [
    (1, 32, 40, 64, 1), (2, 9, 11, 5, 2), (1, 7, 7, 33, 1), (1, 9, 17, 4, 1), (2, 20, 45, 64, 2),
    (1, 5, 32, 5, 1), (1, 128, 128, 64, 1)])
def test_deform_im2col_kernel_matches_plain(cuda, B, H, W, C, stride, modulated):
    """D1 against its plain version on the same CUDA tensors, every form of
    ``deform_im2col_plan`` reached by the shape: channel vectors (C 64, 4) and
    scalars (C 5, 33); rows shorter than a block's 16 positions (7, 6 at
    stride 2), of exactly two blocks (32), of one more than a block (17),
    ragged (40, 23 at stride 2);
    B = 2; the DCN head's input. The kernel keeps the plain version's
    operations in its order, so the columns are equal bit for bit."""
    from bevfusion_tpu_torch.ops import deform_conv as dc

    x, off, mask = _deform_inputs(cuda, B, H, W, C, stride, modulated)
    Ho, Wo = off.shape[1:3]
    plan = dc.deform_im2col_plan(B, Ho, Wo, C, 9)
    assert plan["vec"] == (4 if C % 4 == 0 else 1)
    before = dc.deform_im2col.launches
    got = dc.deform_im2col(x, off, mask, 3, stride, 1)
    torch.cuda.synchronize()
    assert dc.deform_im2col.launches == before + 1
    want = dc.deform_im2col_plain(x, off, mask, 3, stride, 1)
    assert got.shape == want.shape == (B * Ho * Wo, 9 * C)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        dc.deform_im2col(x.double(), off.double(), None, 3, stride, 1)


@pytest.mark.cuda
def test_deform_im2col_kernel_scalar_form_on_an_unaligned_input(cuda):
    """x contiguous but 4 bytes past a 16-byte boundary: the plan takes the
    scalar form at C % 4 == 0, still equal to plain bit for bit."""
    from bevfusion_tpu_torch.ops import deform_conv as dc

    _, off, mask = _deform_inputs(cuda, 1, 9, 21, 8, 1, True)
    x = torch.randn(1 + 9 * 21 * 8, device=cuda)[1:].view(1, 9, 21, 8)
    assert x.data_ptr() % 16 and x.is_contiguous()
    before = dc.deform_im2col.launches
    got = dc.deform_im2col(x, off, mask, 3, 1, 1)
    torch.cuda.synchronize()
    assert dc.deform_im2col.launches == before + 1
    assert torch.equal(got, dc.deform_im2col_plain(x, off, mask, 3, 1, 1))


@pytest.mark.cuda
def test_deform_im2col_kernel_refuses_sizes_past_int32(cuda):
    """x [1, 1024, 1024, 16] with 13 x 13 taps: a 2.8 G-element column, past
    the kernel's 32-bit indices; the wrapper raises before allocating it and
    launches nothing."""
    from bevfusion_tpu_torch.ops import deform_conv as dc

    x = torch.zeros(1, 1024, 1024, 16, device=cuda)
    before = dc.deform_im2col.launches
    with pytest.raises(ValueError, match="32-bit"):
        dc.deform_im2col(x, torch.zeros(1, device=cuda), None, 13, 1, 6)
    assert dc.deform_im2col.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("N,npoint,masked", [
    (20000, 2048, False), (2048, 1024, True), (700, 256, False), (9000, 64, True),
    (30000, 16, False), (256, 255, True), (8192, 64, False), (8193, 64, True),
    (4096, 64, False), (4097, 64, True), (32768, 24, False), (20000, 48, True),
    (1, 3, False), (33, 33, True)])
def test_furthest_point_sample_kernel_matches_plain(cuda, N, npoint, masked):
    """D2 against its plain version: the same indices bit for bit, at the
    edges of its forms (``fps_plan``: one block up to 8,192 points, 8 a
    thread past 4,096, four blocks a sample past 8,192; one point past
    each), VoteNet's 20,000 and the largest N, with ties (points
    on a lattice) and masked points; one launch a batch."""
    from bevfusion_tpu_torch.ops import pointnet as pn

    g = torch.Generator(device=cuda).manual_seed(N)
    xyz = torch.randint(-20, 21, (2, N, 3), generator=g, device=cuda).float() * 0.25
    mask = torch.rand(2, N, generator=g, device=cuda) > 0.3 if masked else None
    before = pn.furthest_point_sample.launches
    got = pn.furthest_point_sample(xyz, npoint, mask)
    torch.cuda.synchronize()
    assert pn.furthest_point_sample.launches == before + 1
    want = pn.furthest_point_sample_plain(xyz, npoint, mask)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        pn.furthest_point_sample(torch.randn(1, 40000, 3, device=cuda), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("N,points,cluster", [
    (20, 1, 1), (512, 1, 1), (1000, 2, 1), (1300, 3, 1), (2048, 4, 1), (2049, 5, 1),
    (3000, 6, 1), (3500, 7, 1), (8192, 8, 1), (8193, 5, 4), (12000, 6, 4), (20000, 8, 4)])
def test_furthest_point_sample_forms_agree(cuda, N, points, cluster):
    """Every form the plan launches (1-8 points a thread, chosen by N; one
    or four blocks a sample) gives plain's indices, on two samples."""
    from bevfusion_tpu_torch.ops import pointnet as pn

    plan = pn.fps_plan(N)
    assert (plan["points"], plan["cluster"]) == (points, cluster)
    g = torch.Generator(device=cuda).manual_seed(N)
    xyz = torch.randint(-10, 11, (2, N, 3), generator=g, device=cuda).float() * 0.5
    want = pn.furthest_point_sample_plain(xyz, min(N, 300))
    got, launched = pn._launch_fps(xyz, min(N, 300), None)
    torch.cuda.synchronize()
    assert launched and torch.equal(got, want)


def _auction_problem(kind, R, C, seed):
    """A made matcher problem on the CPU: (cost [R, C], row_valid, col_valid)."""
    g = torch.Generator().manual_seed(seed)
    cost = torch.rand(R, C, generator=g)
    row_valid, col_valid = torch.ones(R, dtype=torch.bool), torch.ones(C, dtype=torch.bool)
    if kind == "ties":  # integer costs, rows copies of three, columns of C // 2
        base = torch.randint(0, 4, (3, C // 2), generator=g).float()
        cost = base[torch.randint(0, 3, (R,), generator=g)][
            :, torch.randint(0, C // 2, (C,), generator=g)]
    elif kind == "contested":  # every row wants the same three near-equal columns
        cost = cost * 1e-3 + (torch.arange(C) >= 3).float() * 0.5
    elif kind == "invalid":
        row_valid = torch.rand(R, generator=g) > 0.3
        col_valid = torch.rand(C, generator=g) > 0.3
    elif kind == "from files":
        row_valid[15:] = False
    return cost, row_valid, col_valid


@pytest.mark.cuda
@pytest.mark.parametrize("kind,R,C,iters", [
    ("random", 64, 200, 2000), ("ties", 64, 200, 2000), ("contested", 64, 200, 300),
    ("invalid", 40, 90, 2000), ("random", 9, 5, 100), ("random", 1, 33, 2000),
    ("random", 2, 1, 30), ("from files", 140, 200, 2000), ("contested", 300, 400, 200),
    *[(kind, R, C, 400) for kind in ("random", "contested") for R in (1, 63, 64, 65, 140)
      for C in (1, 31, 32, 33, 200)]])
def test_auction_kernel_equals_plain(cuda, kind, R, C, iters):
    """The auction kernel (``csrc/auction.cu``) against its plain version on
    the card, at the edges of its row groups (R 1 / 63 / 64 / 65 / 140: 32,
    16, 16, 8 and 4 lanes a row) and of a lane's columns (C 1 / 31 / 32 /
    33 / 200), on random and near-equal costs: assign, price (bits) and
    rounds equal, with value in shared memory and read from global memory;
    one launch a call through the op; two problems in one launch."""
    from bevfusion_tpu_torch.ops import auction as au

    cost, row_valid, col_valid = (t.to(cuda) for t in _auction_problem(kind, R, C, R * C))
    value, eps = au.auction_value(cost, row_valid, col_valid)
    want = au.auction_rounds_plain(value, row_valid, eps, iters)
    before = au.auction_assignment.launches
    got = au.auction_rounds(value, row_valid, eps, iters)
    assert au.auction_assignment.launches == before + 1
    forms = [au._launch_auction(value[None], row_valid[None], eps[None], iters, staged)[0]
             for staged in (True, False)]
    torch.cuda.synchronize()
    for a, p, r in [got] + [(f[0][0], f[1][0], f[2][0]) for f in forms]:
        assert torch.equal(a, want[0]) and torch.equal(r, want[2])
        assert torch.equal(p.view(torch.int32), want[1].view(torch.int32))
    two = au._launch_auction(torch.stack([value, value.flip(0)]),
                             torch.stack([row_valid, row_valid.flip(0)]), eps.repeat(2), iters)[0]
    flipped = au.auction_rounds_plain(value.flip(0), row_valid.flip(0), eps, iters)
    for k, w in enumerate((want, flipped)):
        assert torch.equal(two[0][k], w[0]) and torch.equal(two[2][k], w[2])
        assert torch.equal(two[1][k].view(torch.int32), w[1].view(torch.int32))
    assert torch.equal(au.auction_assignment(cost, row_valid, col_valid, max_iters=iters),
                       want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,lanes", [(1, 200, 32), (63, 200, 16), (65, 200, 8),
                                       (140, 200, 4), (300, 400, 2), (600, 40, 1),
                                       (1100, 36, 1)])
def test_auction_kernel_at_every_width(cuda, R, C, lanes):
    """Every lanes-a-row form the plan launches, chosen by R (rows strided
    over the groups past 1024), equals plain on near-equal costs in both
    forms, as does its probe form, whose cycles and bidders cover each
    round."""
    from bevfusion_tpu_torch.ops import auction as au

    assert au.auction_plan(R, C)["lanes"] == lanes
    cost, row_valid, col_valid = (t.to(cuda) for t in _auction_problem("contested", R, C, 7))
    value, eps = au.auction_value(cost, row_valid, col_valid)
    want = au.auction_rounds_plain(value, row_valid, eps, 300)
    forms = [au._launch_auction(value[None], row_valid[None], eps[None], 300, staged)[0]
             for staged in (True, False)]
    (pa, pp, pr), cycles, warps, rows = au.auction_probe(value, row_valid, eps, 300)
    torch.cuda.synchronize()
    for aa, ppp, rr in [(a[0], p[0], r[0]) for a, p, r in forms] + [(pa, pp, pr)]:
        assert torch.equal(aa, want[0]) and torch.equal(rr, want[2])
        assert torch.equal(ppp.view(torch.int32), want[1].view(torch.int32))
    assert cycles.shape == (int(want[2]), len(au.PROBE_PHASES)) and (cycles >= 0).all()
    bidders = (rows[..., 0] >= 0).sum(1)
    assert ((bidders >= 1) & (bidders <= R)).all() and (warps.amax((1, 2)) > 0).all()
    assert rows.shape == (int(want[2]), R, len(au.PROBE_ROW))
    bid = rows[..., 0] >= 0  # a bidding row's moments in order
    assert (rows[..., 1:] >= rows[..., :-1])[bid].all()
