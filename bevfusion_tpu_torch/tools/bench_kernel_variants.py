"""Where the sparse-conv kernel's time goes: its loop in four modes.

Counterpart of ``tools/bench_kernel_variants.py``, with the hand-written
kernel of ``csrc/sparse_conv_variants.cu`` (K7) in place of its Pallas
kernel. The JAX tool split the windowed Pallas conv into its lane
alignment, one-hot matmul and DMAs; this one splits the first, scalar-FMA
form of the sparse-conv kernel (``csrc/sparse_conv.cu`` before its
tensor-core redesign, which K7 keeps; no epilogue) into

- the gather:          ``current - nogather``
- the product:         ``current - noproduct``
- what the skip saves: ``noskip - current``

at the stage-0 (C = 16) and stage-1 (C = 32) submanifold convs of the
voxelized 120k-point ring scan, at tiles of 64 (the scalar kernel's tile) and 128
output sites, fp32. ``current`` at tile 64 is the yardstick that
``chip_smoke.py`` times beside today's tensor-core kernel.

Run: ``python -m bevfusion_tpu_torch.tools.bench_kernel_variants`` (on the card).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import sys

import torch

from .. import native
from ..devices import resolve_device
from ..ops import sparse_conv as sp
from ..utils.profiler import bound, nbytes, time_fn

MODES = ("current", "noskip", "nogather", "noproduct")
TILES = (64, 128)


def sparse_conv_variant_plain(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                              mode: str = "current") -> torch.Tensor:
    """Plain PyTorch version of each mode (fp32):

    - ``current``, ``noskip``: ``sparse_conv_plain`` without epilogue;
    - ``nogather``: ``out[i] = sum_k [nbr[k, i] >= 0] feats[i] @ W[k]`` (0
      for rows past ``feats``);
    - ``noproduct``: ``out[i] = sum_k feats[nbr[k, i]]`` ([cap_out, Cin])."""
    K, Cin, Cout = weight.shape
    cap_out = nbr.shape[1]
    if mode in ("current", "noskip"):
        return sp.sparse_conv_plain(feats, nbr, weight)
    if mode == "nogather":
        own = feats.new_zeros((cap_out, Cin))
        n = min(cap_out, feats.shape[0])
        own[:n] = feats[:n]
        g = torch.where((nbr >= 0).t()[:, :, None], own[:, None, :], 0.0)
        return g.reshape(cap_out, K * Cin) @ weight.reshape(K * Cin, Cout)
    if mode == "noproduct":
        nbr_sm = nbr.t().reshape(-1)
        g = feats.index_select(0, nbr_sm.clamp(min=0))
        return torch.where((nbr_sm >= 0)[:, None], g, 0.0).view(cap_out, K, Cin).sum(1)
    raise ValueError(f"sparse_conv_variant: mode {mode!r}, want one of {MODES}")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = native.load_library("sparse_conv_variants").bevf_sparse_conv_variant_f32
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 4 + [i32] * 7 + [vp]
    fn.restype = i32
    return fn


def build_kernels() -> None:
    """Compile and load the kernel library (done anyway at first launch)."""
    _kernel_fn()


def sparse_conv_variant(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                        mode: str = "current", tile: int = 64) -> torch.Tensor:
    """The scalar sparse-conv loop in ``mode`` (``MODES``) with
    ``tile`` output sites a block (64 or 128); see
    ``sparse_conv_variant_plain`` for what each mode computes. CUDA tensors
    launch the hand-written kernel (fp32, contiguous, 1..128 channels) on
    the current stream; CPU tensors take the plain version.
    ``sparse_conv_variant.launches`` counts kernel launches."""
    if mode not in MODES or tile not in TILES:
        raise ValueError(f"sparse_conv_variant: mode {mode!r}, tile {tile}; want one of "
                         f"{MODES} and {TILES}")
    if feats.device.type == "cpu":
        return sparse_conv_variant_plain(feats, nbr, weight, mode)
    if feats.device.type != "cuda":
        raise ValueError(f"sparse_conv_variant: unsupported device {feats.device}")
    if weight.dim() != 3:
        raise ValueError(f"sparse_conv_variant: weight must be [K, Cin, Cout], got "
                         f"{tuple(weight.shape)}")
    K, Cin, Cout = weight.shape
    sp._check_cuda_args("sparse_conv_variant", feats, nbr, K, Cin, Cout,
                        weight=(weight, (K, Cin, Cout)))
    cap_out = nbr.shape[1]
    out = torch.empty((cap_out, Cin if mode == "noproduct" else Cout), dtype=torch.float32,
                      device=feats.device)
    if cap_out == 0:
        return out
    with torch.cuda.device(feats.device):
        rc = _kernel_fn()(feats.data_ptr(), nbr.data_ptr(), weight.data_ptr(), out.data_ptr(),
                          feats.shape[0], cap_out, K, Cin, Cout, MODES.index(mode), tile,
                          torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sparse_conv_variant: kernel launch failed with cudaError {rc}")
    sparse_conv_variant.launches += 1
    return out


sparse_conv_variant.launches = 0


def mode_bound(feats, nbr, weight, out, mode: str):
    """The least time (ms) of one mode on these inputs and what bounds it:
    2*Cin*Cout flops per hit pair (Cin adds per hit pair for
    ``noproduct``), each input byte read once and the output written once
    (the weight unread by ``noproduct``)."""
    K, Cin, Cout = weight.shape
    hits = int((nbr >= 0).sum())
    if mode == "noproduct":
        return bound(hits * Cin, nbytes(feats, nbr, out))
    return bound(2 * hits * Cin * Cout, nbytes(feats, nbr, weight, out))


def stage_cases(enc, coords: torch.Tensor, mask: torch.Tensor, seed: int = 0):
    """The stage-0 and stage-1 submanifold convs of ``enc`` (a
    ``SparseEncoder``) on one voxelized sample: [(label, feats, nbr,
    weight)], seeded random fp32 operands at the stage's site cap and
    width, the tables built as the encoder builds them."""
    stages = enc.sparse_sites(coords, mask)[:2]
    g = torch.Generator(device=coords.device).manual_seed(seed)
    cases = []
    for s, st in enumerate(stages):
        C = st["channels"]
        nbr = sp.build_subm_rulebook(st["ids"], st["grid"])
        feats = torch.randn(st["ids"].shape[0], C, generator=g, device=coords.device)
        w = torch.randn(27, C, C, generator=g, device=coords.device) * (2 / (27 * C)) ** 0.5
        cases.append((f"stage{s} subm {C}->{C}, {st['ids'].shape[0]} sites", feats, nbr, w))
    return cases


def breakdown(cases, device="cuda", tiles=TILES, iters: int = 20, warmup: int = 5):
    """For each case and tile: every mode's median ms and bound, the split
    (``gather_ms``, ``product_ms``, ``skip_saves_ms``) and ``noskip``'s
    max|d| from ``current``, the tool's check that the two routes agree."""
    dev = resolve_device(device)
    rows = []
    for label, feats, nbr, w in cases:
        for tile in tiles:
            modes = {}
            for mode in MODES:
                out = sparse_conv_variant(feats, nbr, w, mode, tile)
                b_ms, b_by = mode_bound(feats, nbr, w, out, mode)
                ms = time_fn(lambda: sparse_conv_variant(feats, nbr, w, mode, tile), iters=iters,
                             warmup=warmup, device=dev)["median_ms"]
                modes[mode] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by}
            d = (sparse_conv_variant(feats, nbr, w, "noskip", tile)
                 - sparse_conv_variant(feats, nbr, w, "current", tile)).abs().max().item()
            ms = {m: v["ms"] for m, v in modes.items()}
            rows.append({"shape": label, "tile": tile, "modes": modes,
                         "gather_ms": ms["current"] - ms["nogather"],
                         "product_ms": ms["current"] - ms["noproduct"],
                         "skip_saves_ms": ms["noskip"] - ms["current"],
                         "noskip_vs_current": d})
    return rows


def print_breakdown(rows) -> None:
    for r in rows:
        ms = {m: v["ms"] for m, v in r["modes"].items()}
        print(f"{r['shape']} tile {r['tile']}: "
              + ", ".join(f"{m} {v:.4f}" for m, v in ms.items())
              + f" ms; gather {r['gather_ms']:.4f}, product {r['product_ms']:.4f}, skip saves "
              f"{r['skip_saves_ms']:.4f} ms; noskip vs current max|d| {r['noskip_vs_current']:.3e}")


def main(argv=None) -> int:
    from ..runtime.flagship import build_flagship

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=120000)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _, model, batch = build_flagship(dev, num_points=args.points)
    with torch.no_grad():
        vox = model.lidar_voxelize(batch["points"], batch["points_mask"])
        cases = stage_cases(model.encoders["lidar"]["backbone"], vox.coords[0], vox.mask[0])
        print_breakdown(breakdown(cases, dev, iters=args.iters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
