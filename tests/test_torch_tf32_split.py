"""The numerics of the sparse-conv kernel's 3xTF32 product, on the CPU.

``csrc/sparse_conv.cu`` multiplies on the tensor cores with TF32 inputs
(10 explicit mantissa bits). It splits each fp32 operand into two TF32
values, ``big = rna(a)`` and ``small = rna(a - big)`` (``cvt.rna.tf32.f32``:
round to nearest, ties away from zero), and sums ``small*big' + big*small'
+ big*big'``. Here that rounding is emulated with integer bit operations
and the split is applied to ``sparse_conv_plain``'s gather-GEMM (the
gather commutes with the elementwise split), on seeded rulebooks at the
encoder's channel widths, against the float64 product. Last, why a
training comparison through many ReLUs must use data where rounding
differences of that size move no ReLU input across zero, and that such a
comparison still tells a single TF32 pass from three.
"""
import numpy as np
import pytest
import torch

from bevfusion_tpu_torch.ops import sparse_conv as sp
from tests.test_torch_cuda import gradient_shift, rounding_sensitivity, training_encoder

torch.set_num_threads(2)

GATE = 1e-5  # of max(|float64 product|, 1)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (low 13 mantissa bits zero), ties
    away from zero, as ``cvt.rna.tf32.f32``: add half of the dropped unit to
    the magnitude bits and truncate (a carry moves into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


@pytest.mark.parametrize("value,want", [
    (0x3F800000, 0x3F800000),  # 1.0 is a TF32 value
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie: away from zero
    (0xBF801000, 0xBF802000),  # -(1 + 2^-11): away from zero too
    (0x3F800FFF, 0x3F800000),  # just below the tie: down
    (0x3F801001, 0x3F802000),  # just above: up
    (0x3FFFF000, 0x40000000),  # a tie at the top of the mantissa: carry into the exponent
    (0x3DCCCCCD, 0x3DCCC000),  # 0.1f
    (0x402DF854, 0x402E0000),  # e, rounds up
    (0x40490FDB, 0x40490000),  # pi, rounds down
    (0x00001000, 0x00002000),  # a subnormal tie
])
def test_tf32_rounding_bit_patterns(value, want):
    x = torch.tensor([value], dtype=torch.int64).to(torch.int32).view(torch.float32)
    got = tf32_rna(x).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want, f"{value:#010x} -> {got:#010x}, want {want:#010x}"


def test_split_is_exact_to_fp32():
    """big and small are TF32 values, and big + small is x to within about
    2^-21 of |x| (the dropped small*small' term is below that squared)."""
    x = torch.from_numpy(np.random.RandomState(0).randn(10000).astype(np.float32) * 100)
    big, small = split_tf32(x)
    for t in (big, small):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    rest = (x.double() - big.double() - small.double()).abs()
    assert (rest <= 2.0 ** -21 * x.double().abs()).all()


def tf32_conv(passes: int):
    """``sparse_conv_plain`` with its gather-GEMM in emulated TF32: the
    3xTF32 split (``passes`` 3, the kernel's product) or one TF32 product of
    the rounded operands (``passes`` 1); the epilogue in fp32 after."""
    def conv(feats, nbr, weight, scale=None, shift=None, residual=None, relu=False):
        (fb, fs), (wb, ws) = split_tf32(feats), split_tf32(weight)
        y = sp.sparse_conv_plain(fb, nbr, wb)
        if passes == 3:
            y = sp.sparse_conv_plain(fs, nbr, wb) + sp.sparse_conv_plain(fb, nbr, ws) + y
        return sp._epilogue(y, scale, shift, residual, relu)
    return conv


def _case(cin, cout, strided, seed):
    rng = np.random.RandomState(seed)
    grid = sp.SparseGrid(24, 24, 10)
    ids = np.full(1280, grid.size, np.int32)
    ids[:1200] = np.sort(rng.choice(grid.size, 1200, replace=False))
    ids = torch.from_numpy(ids)
    if strided:
        og = sp.conv_out_shape(grid, 3, 2, 1)
        out_ids, _ = sp.downsample_sites(ids, grid, 3, 2, 1, 640)
        nbr = sp.build_conv_rulebook(ids, out_ids, grid, og, 3, 2, 1)
    else:
        nbr = sp.build_subm_rulebook(ids, grid)
    feats = torch.from_numpy(rng.randn(ids.shape[0], cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32))
    return feats, nbr, w


@pytest.mark.parametrize("cin,cout,strided", [
    (5, 16, False), (16, 16, False), (16, 32, True), (32, 32, False), (64, 64, False)])
def test_3xtf32_gather_gemm_holds_fp32_accuracy(cin, cout, strided):
    feats, nbr, w = _case(cin, cout, strided, seed=cin + cout)
    assert (nbr >= 0).sum() > 0.05 * nbr.numel()
    ref = sp.sparse_conv_plain(feats.double(), nbr, w.double())
    scale = max(ref.abs().max().item(), 1.0)
    (fb, fs), (wb, ws) = split_tf32(feats), split_tf32(w)
    three = (sp.sparse_conv_plain(fs, nbr, wb) + sp.sparse_conv_plain(fb, nbr, ws)
             + sp.sparse_conv_plain(fb, nbr, wb))
    one = sp.sparse_conv_plain(fb, nbr, wb)
    fp32 = sp.sparse_conv_plain(feats, nbr, w)
    errs = {name: (y.double() - ref).abs().max().item() / scale
            for name, y in (("3xTF32", three), ("1xTF32", one), ("fp32", fp32))}
    print(f"Cin {cin} Cout {cout}{' strided' if strided else ''}: max|d| / max(|ref|, 1) "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert errs["3xTF32"] <= GATE


@pytest.mark.parametrize("sites,cap,well_posed", [(8000, 8500, False), (2500, 2700, True)])
def test_training_gradients_under_sparse_conv_rounding(sites, cap, well_posed, monkeypatch):
    """Why the card's training test (tests/test_torch_cuda.py) compares the
    tiny encoder at 2,500 sites a sample: with 1e-6 relative noise on every
    sparse conv's output (about the kernel's distance from cuBLAS in fp32),
    the CPU's own training gradients move beyond that test's 1e-4 at 8,000
    sites (a ReLU input within rounding of zero flips), and stay inside it
    at 2,500."""
    moved, _ = rounding_sensitivity(*training_encoder(sites, cap), 1e-6, monkeypatch)
    print(f"{sites} sites a sample: the gradients move by {moved:.3e} of their largest entry")
    assert (moved <= 1e-4) == well_posed


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)])
def test_training_comparison_tells_one_tf32_pass_from_three(passes, within, monkeypatch):
    """The card's training test at 2,500 sites a sample still rejects a
    kernel that multiplies in a single TF32 pass: with every sparse conv
    (forward and backward-data) in emulated single-pass TF32 the tiny
    encoder's CPU gradients move beyond that test's 1e-4, and in the
    kernel's 3xTF32 split they stay inside it."""
    moved, _ = gradient_shift(*training_encoder(2500, 2700), tf32_conv(passes), monkeypatch)
    print(f"{passes}xTF32 sparse convs at 2,500 sites a sample: the gradients move by "
          f"{moved:.3e} of their largest entry")
    assert (moved <= 1e-4) == within
