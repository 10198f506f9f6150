"""The hand kernels as ``bevfusion::`` custom ops (``ops/library.py``) on
the CPU.

- each op's CPU implementation, and each wrapper that now calls it, equals
  the plain function bit for bit (fp32, bf16, float64);
- each op's fake implementation gives the shapes and dtypes of the real
  one (the CUDA implementation allocates the same: tests/test_torch_cuda.py
  holds fake against it on the card);
- ``torch.library.opcheck`` on each op (schema, fake tensors, AOT dispatch);
- the tiny fused model's training losses and every gradient are bit-equal
  through the ops and through the plain functions called directly, as the
  wrappers called them before the ops existed;
- ``op_counts`` counts the ops of a traced graph, in its submodules too;
- a wrapper on a CPU tensor never counts a launch.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from bevfusion_tpu_torch.config import Config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.ops import auction as au
from bevfusion_tpu_torch.ops import bev_pool as bp
from bevfusion_tpu_torch.ops import library
from bevfusion_tpu_torch.ops import nms
from bevfusion_tpu_torch.ops import sparse_conv as sp
from bevfusion_tpu_torch.runtime import flagship
from tests.test_bevfusion_model import make_batch, tiny_fused_config

torch.set_num_threads(2)

GRID = sp.SparseGrid(12, 10, 6)


def _conv_args(dtype=torch.float32, epilogue=True, seed=0, cin=8, cout=16):
    g = torch.Generator().manual_seed(seed)
    ids = torch.full((96,), GRID.size, dtype=torch.int32)
    ids[:80] = torch.randperm(GRID.size, generator=g)[:80].sort().values.int()
    nbr = sp.build_subm_rulebook(ids, GRID)
    feats = torch.randn(96, cin, generator=g).to(dtype)
    weight = (torch.randn(27, cin, cout, generator=g) * 0.2).to(dtype)
    if not epilogue:
        return feats, nbr, weight, None, None, None, False
    scale, shift = torch.rand(cout, generator=g) + 0.5, torch.randn(cout, generator=g)
    if dtype == torch.float64:
        scale, shift = scale.double(), shift.double()
    residual = torch.randn(96, cout, generator=g).to(dtype)
    return feats, nbr, weight, scale, shift, residual, True


def _pool_args(seed=0, B=1, N=2, D=4, fH=3, fW=5, C=6, Z=1, X=4, Y=5):
    g = torch.Generator().manual_seed(seed)
    depth = torch.rand(B, N, D, fH, fW, generator=g)
    ctx = torch.randn(B, N, fH, fW, C, generator=g)
    cells = torch.randint(0, Z * X * Y, (B, N, D, fH, fW), generator=g)
    valid = torch.rand(B, N, D, fH, fW, generator=g) > 0.3
    iv = bp.build_intervals(cells, valid, Z * X * Y)
    return depth, ctx, iv, Z, X, Y


def _suppress_args(seed=0, P=3, N=40):
    g = torch.Generator().manual_seed(seed)
    sup = torch.rand(P, N, N, generator=g) > 0.7
    order = torch.stack([torch.randperm(N, generator=g) for _ in range(P)])
    return sup, order


def _words_args(seed=0, P=3, N=40):
    """N1's operands: P problems of N boxes in a 12 m square (score order is
    theirs), rotated and circle problems mixed."""
    g = torch.Generator().manual_seed(seed)
    boxes = torch.cat([torch.rand(P, N, 2, generator=g) * 12 - 6,
                       torch.rand(P, N, 2, generator=g) * 3.5 + 0.5,
                       torch.rand(P, N, 1, generator=g) * 6.3 - 3.15], -1)
    rotated = torch.arange(P) % 2 == 0
    geom = torch.where(rotated[:, None, None], nms.box_geometry(boxes),
                       nms.center_geometry(boxes[..., :2]))
    return geom, rotated, torch.where(rotated, 0.2, 4.0).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("epilogue", [True, False])
def test_sparse_conv_op_is_the_plain_function(dtype, epilogue):
    args = _conv_args(dtype, epilogue)
    want = sp.sparse_conv_plain(*args)
    op = library.sparse_conv_bf16 if dtype == torch.bfloat16 else library.sparse_conv
    for got in (op(*args), sp.sparse_conv(*args)):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_sparse_conv_dw_op_is_the_plain_function(dtype):
    feats, nbr, weight, *_ = _conv_args(dtype, False)
    dout = torch.randn(nbr.shape[1], weight.shape[2], generator=torch.Generator().manual_seed(1))
    dout = dout.to(dtype)
    want = sp.sparse_conv_dw_plain(feats, nbr, dout)
    op = library.sparse_conv_dw_bf16 if dtype == torch.bfloat16 else library.sparse_conv_dw
    for got in (op(feats, nbr, dout), sp.sparse_conv_dw(feats, nbr, dout)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_deform_im2col_and_fps_ops_are_the_plain_functions():
    """Bit for bit, and the im2col op's gradient is autograd of the plain
    version (the op registers it)."""
    from bevfusion_tpu_torch.ops import deform_conv as dc
    from bevfusion_tpu_torch.ops import pointnet as pn

    args = _im2col_args()
    got = library.deform_im2col(*args)
    want = dc.deform_im2col_plain(*args)
    assert torch.equal(got, want)
    g = torch.randn(want.shape)
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(got, args[:3], g),
                                                 torch.autograd.grad(want, args[:3], g)))
    xyz, npoint, mask = _fps_args()
    want = pn.furthest_point_sample_plain(xyz, npoint, mask)
    assert torch.equal(library.furthest_point_sample(xyz, npoint, mask), want)
    assert torch.equal(pn.furthest_point_sample(xyz, npoint, mask), want)


def test_bev_pool_and_suppress_ops_are_the_plain_functions():
    depth, ctx, iv, Z, X, Y = _pool_args()
    want = bp.bev_pool_plain(depth, ctx, iv, Z, X, Y)
    flat = library.bev_pool(depth, ctx, *iv, Z, X, Y)  # the op's own layout, [B*Z*X*Y, C]
    assert flat.is_contiguous() and flat.shape == (depth.shape[0] * Z * X * Y, ctx.shape[-1])
    assert torch.equal(flat, bp.bev_pool_flat_plain(depth, ctx, iv, flat.shape[0]))
    got = bp.bev_pool(depth, ctx, iv, Z, X, Y)  # the NCHW view of it, no copy
    assert got.stride() == want.stride() and torch.equal(got, want)
    sup, order = _suppress_args()
    want = nms.greedy_suppress_plain(sup, order)
    words = nms.pack_words(sup)
    for got in (library.greedy_suppress_words(words, order), nms.greedy_suppress(sup, order)):
        assert torch.equal(got, want)
    args = _words_args()
    want = nms.suppression_words_plain(*args)
    assert want.any() and torch.equal(library.suppression_words(*args), want)
    assert torch.equal(nms.suppression_words(*args), want)


def _im2col_args(seed=0, B=2, H=5, W=6, C=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, C, generator=g, requires_grad=True)
    offset = (torch.rand(B, H, W, 18, generator=g) * 4 - 2).requires_grad_()
    mask = torch.rand(B, H, W, 9, generator=g).requires_grad_()
    return x, offset, mask, 3, 1, 1


def _fps_args(seed=0, B=2, N=50):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, N, 3, generator=g), 12, torch.rand(B, N, generator=g) > 0.2


def _auction_args(seed=0, R=6, C=9):
    g = torch.Generator().manual_seed(seed)
    row_valid = torch.rand(R, generator=g) > 0.2
    value, eps = au.auction_value(torch.rand(R, C, generator=g), row_valid,
                                  torch.ones(C, dtype=torch.bool))
    return value, row_valid, eps, 50


def _all_cases():
    feats, nbr, weight, scale, shift, residual, relu = _conv_args()
    bf = _conv_args(torch.bfloat16)
    dout = torch.randn(nbr.shape[1], weight.shape[2])
    depth, ctx, iv, Z, X, Y = _pool_args()
    return {
        "sparse_conv": (feats, nbr, weight, scale, shift, residual, relu),
        "sparse_conv_bf16": bf,
        "sparse_conv_dw": (feats, nbr, dout),
        "sparse_conv_dw_bf16": (bf[0], bf[1], dout.bfloat16()),
        "bev_pool": (depth, ctx, *iv, Z, X, Y),
        "suppression_words": _words_args(),
        "greedy_suppress_words": (nms.pack_words(_suppress_args()[0]), _suppress_args()[1]),
        "deform_im2col": _im2col_args(),
        "furthest_point_sample": _fps_args(),
        "auction": _auction_args(),
    }


@pytest.mark.parametrize("name", library.OPS)
def test_fake_gives_the_real_shapes_and_dtypes(name):
    args = _all_cases()[name]
    op = getattr(torch.ops.bevfusion, name)
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    real, fake = ((x,) if isinstance(x, torch.Tensor) else x for x in (real, fake))
    assert [(f.shape, f.dtype, f.stride()) for f in fake] == \
        [(r.shape, r.dtype, r.stride()) for r in real]


@pytest.mark.parametrize("name", library.OPS)
def test_opcheck(name):
    torch.library.opcheck(getattr(torch.ops.bevfusion, name).default, _all_cases()[name])


def test_tiny_model_training_is_bit_equal_through_the_ops_and_the_plain_functions(monkeypatch):
    cfg = tiny_fused_config()
    batch = {k: torch.from_numpy(np.array(v)) for k, v in make_batch(B=1, N=2, P=256).items()}
    batch["img"] = batch["img"].permute(0, 1, 4, 2, 3).contiguous()
    batch = flagship.add_pool_lut(Config.from_dict({"model": cfg}), batch)
    model = flagship.init_weights(build_model(cfg, "cpu"), 0).train()

    def step():
        from bevfusion_tpu_torch.models.layers import set_dropout_generator

        set_dropout_generator(model, torch.Generator().manual_seed(0))
        model.zero_grad(set_to_none=True)
        losses = model(batch)
        sum(v for k, v in losses.items() if k.startswith("loss/")).backward()
        return ({k: v.detach() for k, v in losses.items()},
                {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})

    calls = {name: 0 for name in library.OPS}
    got_losses, got_grads = step()
    # before the ops: the wrappers called the plain functions on CPU tensors
    monkeypatch.setattr(sp, "sparse_conv", lambda *a, **k: calls.update(
        sparse_conv=calls["sparse_conv"] + 1) or sp.sparse_conv_plain(*a, **k))
    monkeypatch.setattr(sp, "sparse_conv_dw", lambda *a: calls.update(
        sparse_conv_dw=calls["sparse_conv_dw"] + 1) or sp.sparse_conv_dw_plain(*a))
    monkeypatch.setattr(bp, "bev_pool", lambda *a: calls.update(
        bev_pool=calls["bev_pool"] + 1) or bp.bev_pool_plain(*a))
    want_losses, want_grads = step()
    assert calls["sparse_conv"] == 15 + 14 and calls["sparse_conv_dw"] == 15
    assert calls["bev_pool"] == 1
    assert got_losses.keys() == want_losses.keys() and got_grads.keys() == want_grads.keys()
    assert all(torch.equal(got_losses[k], want_losses[k]) for k in want_losses)
    assert all(torch.equal(got_grads[k], want_grads[k]) for k in want_grads)


def test_op_counts_walks_submodules():
    class Conv(torch.nn.Module):
        def forward(self, feats, nbr, weight):
            with torch.autocast("cpu", dtype=torch.bfloat16):
                y = sp.sparse_conv(feats.bfloat16(), nbr, weight.bfloat16())
            return sp.sparse_conv(y.float(), nbr, weight)

    feats, nbr, weight, *_ = _conv_args(cin=8, cout=8, epilogue=False)
    ep = torch.export.export(Conv(), (feats, nbr, weight), strict=False)
    assert library.op_counts(ep.graph_module) == dict(
        {name: 0 for name in library.OPS}, sparse_conv=1, sparse_conv_bf16=1)
    assert any(m is not ep.graph_module for m in ep.graph_module.modules())  # autocast region


def test_cpu_calls_count_no_launch():
    before = {name: c.launches for name, c in library.COUNTERS.items()}
    for name, args in _all_cases().items():
        getattr(torch.ops.bevfusion, name)(*args)
    assert {name: c.launches for name, c in library.COUNTERS.items()} == before
    with pytest.raises(ValueError):  # the bf16 entry points take CUDA tensors only
        sp.sparse_conv_bf16(*_conv_args(torch.bfloat16))
