"""Where the sparse-conv kernel's time goes: its loops in three families of modes.

Counterpart of ``tools/bench_kernel_variants.py``, with the hand-written
kernel of ``csrc/sparse_conv_variants.cu`` (K7) in place of its Pallas
kernel. The JAX tool split the windowed Pallas conv into its lane
alignment, one-hot matmul and DMAs (in bf16, its production precision);
this one splits the port's sparse-conv loops, no epilogue:

- the scalar family (``MODES``, tiles of 64 and 128 output sites): the
  first, scalar-FMA form of ``csrc/sparse_conv.cu`` (before its tensor-core
  redesign), kept as the yardstick that ``chip_smoke.py`` times today's
  kernel against; ``current`` at tile 64 is that loop;
- the tensor-core family (``TC_MODES``, 64 sites a block): today's K1/K2
  loop itself (``csrc/sparse_conv_tile.cuh``: the ``cp.async`` ring feeding
  3xTF32 ``mma.sync`` tiles); ``tc`` equals ``ops.sparse_conv.sparse_conv``
  without epilogue bit for bit (fp32);
- the bf16 family (``BF16_MODES``, 64 sites a block, 128 at C = 16): the
  loop of K1/K2's bf16 form (``csrc/sparse_conv_bf16_tile.cuh``) on bf16
  rows and weights,
  bf16 out rounded once from fp32 sums; ``bf16`` equals
  ``ops.sparse_conv.sparse_conv`` on bf16 operands without epilogue bit for
  bit.

Each family's split: the gather (``current - nogather``, ``tc -
tc_nogather``, ``bf16 - bf16_nogather``), the product (``current -
noproduct``, ``tc - tc_noproduct``, ``bf16 - bf16_noproduct``), what the
skip saves (``noskip - current``, ``tc_noskip - tc``, ``bf16_noskip -
bf16``), for the fp32 tensor cores the 3xTF32 split's cost over one TF32
product (``tc - tc_1xtf32``), and for both tensor-core families the slab
fill (``slab_fill``: the share of the rows the kernel multiplies that some
site hits). At the stage-0 (C = 16), stage-1 (C = 32) and stage-2 (C = 64)
submanifold convs of the voxelized 120k-point ring scan.

Run: ``python -m bevfusion_tpu_torch.tools.bench_kernel_variants`` (on the card).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import itertools
import sys

import torch
import torch.nn.functional as F

from .. import native
from ..devices import resolve_device
from ..ops import sparse_conv as sp
from ..utils.profiler import BF16_FLOPS, TF32_FLOPS, bound, card_line, nbytes, time_fn

MODES = ("current", "noskip", "nogather", "noproduct")  # the scalar family
TILES = (64, 128)
TC_MODES = ("tc", "tc_noskip", "tc_nogather", "tc_noproduct", "tc_1xtf32")  # K1/K2's loop
TC_TILE = 64  # K1/K2's only tile
BF16_MODES = ("bf16", "bf16_noskip", "bf16_nogather", "bf16_noproduct")  # K1/K2 bf16's loop
FAMILIES = {"scalar": MODES, "tc": TC_MODES, "bf16": BF16_MODES}
ALL_MODES = MODES + TC_MODES + BF16_MODES
# the keys of the bf16 loop's launch plan (csrc/sparse_conv_bf16_tile.cuh:run_bf16)
PLAN_KEYS = sp.BF16_PLAN_KEYS
SLAB = 16  # rows of one warp's mma slab in K1/K2


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (low 13 mantissa bits zero), ties away
    from zero, as the kernels' ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _nogather_plain(feats, nbr, weight):
    K, Cin, Cout = weight.shape
    cap_out = nbr.shape[1]
    own = feats.new_zeros((cap_out, Cin))
    n = min(cap_out, feats.shape[0])
    own[:n] = feats[:n]
    g = torch.where((nbr >= 0).t()[:, :, None], own[:, None, :], 0.0)
    return g.reshape(cap_out, K * Cin) @ weight.reshape(K * Cin, Cout)


def _noproduct_plain(feats, nbr, weight):
    K, Cin, _ = weight.shape
    nbr_sm = nbr.t().reshape(-1)
    g = feats.index_select(0, nbr_sm.clamp(min=0))
    return torch.where((nbr_sm >= 0)[:, None], g, 0.0).view(nbr.shape[1], K, Cin).sum(1)


def sparse_conv_variant_plain(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                              mode: str = "current") -> torch.Tensor:
    """Plain PyTorch version of each mode (fp32; the bf16 family on bf16
    operands, the sums in fp32, rounded once to bf16):

    - ``current``, ``noskip``, ``tc``, ``tc_noskip``: ``sparse_conv_plain``
      without epilogue;
    - ``nogather``, ``tc_nogather``: ``out[i] = sum_k [nbr[k, i] >= 0]
      feats[i] @ W[k]`` (0 for rows past ``feats``);
    - ``noproduct``, ``tc_noproduct``: ``out[i] = sum_k feats[nbr[k, i]]``
      ([cap_out, Cin]);
    - ``tc_1xtf32``: ``sparse_conv_plain`` of both operands rounded to TF32
      (``tf32_rna``), multiplied in fp32;
    - ``bf16``, ``bf16_noskip``, ``bf16_nogather``, ``bf16_noproduct``: as
      ``tc``, ``tc_noskip``, ``tc_nogather``, ``tc_noproduct``."""
    if mode in BF16_MODES:
        plain = sparse_conv_variant_plain(feats.float(), nbr, weight.float(),
                                          mode.replace("bf16", "tc"))
        return plain.bfloat16()
    if mode in ("current", "noskip", "tc", "tc_noskip"):
        return sp.sparse_conv_plain(feats, nbr, weight)
    if mode in ("nogather", "tc_nogather"):
        return _nogather_plain(feats, nbr, weight)
    if mode in ("noproduct", "tc_noproduct"):
        return _noproduct_plain(feats, nbr, weight)
    if mode == "tc_1xtf32":
        return sp.sparse_conv_plain(tf32_rna(feats), nbr, tf32_rna(weight))
    raise ValueError(f"sparse_conv_variant: mode {mode!r}, want one of {ALL_MODES}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = native.load_library("sparse_conv_variants")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bevf_sparse_conv_variant_f32.argtypes = [vp] * 4 + [i32] * 7 + [vp]
    lib.bevf_sparse_conv_variant_f32.restype = i32
    lib.bevf_sparse_conv_tc_variant_f32.argtypes = [vp] * 4 + [i32] * 5 + [vp]
    lib.bevf_sparse_conv_tc_variant_f32.restype = i32
    lib.bevf_sparse_conv_bf16_variant.argtypes = [vp] * 4 + [i32] * 6 + [vp, vp]
    lib.bevf_sparse_conv_bf16_variant.restype = i32
    return lib


def build_kernels() -> None:
    """Compile and load the kernel library (done anyway at first launch)."""
    _lib()


def family_of(mode: str) -> str:
    """The family (``FAMILIES``) a mode belongs to."""
    for family, modes in FAMILIES.items():
        if mode in modes:
            return family
    raise ValueError(f"sparse_conv_variant: mode {mode!r}, want one of {ALL_MODES}")


def sparse_conv_variant(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                        mode: str = "current", tile: int = 64, stages=None) -> torch.Tensor:
    """A sparse-conv loop in ``mode``: the scalar family (``MODES``, with
    ``tile`` output sites a block, 64 or 128), the tensor-core family
    (``TC_MODES``: K1/K2's loop, 64 sites a block, Cin == Cout <= 64) or the
    bf16 family (``BF16_MODES``: K1/K2 bf16's loop, the same sizes, bf16
    operands and out); see ``sparse_conv_variant_plain`` for what each mode
    computes. CUDA tensors launch the hand-written kernel (contiguous; fp32,
    bf16 for the bf16 family; 1..128 channels for the scalar family) on the
    current stream; CPU tensors take the plain version.
    ``stages`` (the bf16 family only) replaces the launch's choice of the
    ring's depth (``bf16_sweep``). ``sparse_conv_variant.launches`` counts
    kernel launches, ``sparse_conv_variant.launches_by_family`` each
    family's."""
    family = family_of(mode)
    tiles = TILES if family == "scalar" else (TC_TILE,)
    if tile not in tiles:
        raise ValueError(f"sparse_conv_variant: tile {tile} for mode {mode!r}, want one of "
                         f"{tiles}")
    if family != "scalar" and (weight.dim() != 3 or weight.shape[1] != weight.shape[2]
                               or weight.shape[1] > 64):
        raise ValueError(f"sparse_conv_variant: the {family} modes take Cin == Cout <= 64, "
                         f"got weight {tuple(weight.shape)}")
    dtype = torch.bfloat16 if family == "bf16" else torch.float32
    if feats.dtype != dtype or weight.dtype != dtype:
        raise TypeError(f"sparse_conv_variant: the {family} modes take {dtype} operands, got "
                        f"{feats.dtype} rows and a {weight.dtype} weight")
    if feats.device.type == "cpu":
        return sparse_conv_variant_plain(feats, nbr, weight, mode)
    if feats.device.type != "cuda":
        raise ValueError(f"sparse_conv_variant: unsupported device {feats.device}")
    if weight.dim() != 3:
        raise ValueError(f"sparse_conv_variant: weight must be [K, Cin, Cout], got "
                         f"{tuple(weight.shape)}")
    K, Cin, Cout = weight.shape
    sp._check_cuda_args("sparse_conv_variant", feats, nbr, K, Cin, Cout, dtype,
                        weight=(weight, (K, Cin, Cout)))
    cap_out = nbr.shape[1]
    noproduct = mode.endswith("noproduct")
    out = torch.empty((cap_out, Cin if noproduct else Cout), dtype=dtype, device=feats.device)
    if cap_out == 0:
        return out
    ptrs = (feats.data_ptr(), nbr.data_ptr(), weight.data_ptr(), out.data_ptr(), feats.shape[0],
            cap_out, K)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        if family == "scalar":
            rc = _lib().bevf_sparse_conv_variant_f32(*ptrs, Cin, Cout, MODES.index(mode), tile,
                                                     stream)
        elif family == "tc":
            rc = _lib().bevf_sparse_conv_tc_variant_f32(*ptrs, Cin, TC_MODES.index(mode), stream)
        else:
            rc = _lib().bevf_sparse_conv_bf16_variant(*ptrs, Cin, BF16_MODES.index(mode),
                                                      -1 if stages is None else stages, stream,
                                                      None)
    if rc != 0:
        raise RuntimeError(f"sparse_conv_variant: kernel launch failed with cudaError {rc}")
    sparse_conv_variant.launches += 1
    sparse_conv_variant.launches_by_family[family] += 1
    return out


sparse_conv_variant.launches = 0
sparse_conv_variant.launches_by_family = dict.fromkeys(FAMILIES, 0)


def bf16_plan(c: int, num_offsets: int, cap_out: int, mode: str = "bf16", stages=None) -> dict:
    """What a bf16-family launch at Cin == Cout == ``c`` would run, from the
    built library on the current card (``PLAN_KEYS``: resident blocks an SM
    from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, registers and
    spilled bytes a thread, shared memory, stages, offsets staged ahead,
    threads, grid, slabs a warp), at ``stages`` if given; launches nothing."""
    info = (ctypes.c_int * len(PLAN_KEYS))()
    rc = _lib().bevf_sparse_conv_bf16_variant(None, None, None, None, 0, cap_out, num_offsets, c,
                                              BF16_MODES.index(mode),
                                              -1 if stages is None else stages, None,
                                              ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"bf16_plan: cudaError {rc}")
    return dict(zip(PLAN_KEYS, info))


def mode_bound(feats, nbr, weight, out, mode: str):
    """The least time (ms) of one mode on these inputs and what bounds it,
    with each input byte read once and the output written once (the weight
    unread by the ``noproduct`` modes), and per hit pair: 2*Cin*Cout flops
    on the fp32 FMA units (the scalar family), three TF32 products on the
    tensor cores (``tc``, ``tc_noskip``, ``tc_nogather``: the 3xTF32 split),
    one (``tc_1xtf32``), one bf16 product (``bf16``, ``bf16_noskip``,
    ``bf16_nogather``), or Cin adds (the ``noproduct`` modes). The bytes are
    the tensors' own: bf16 rows, weights and out in the bf16 family."""
    K, Cin, Cout = weight.shape
    hits = int((nbr >= 0).sum())
    if mode.endswith("noproduct"):
        return bound(hits * Cin, nbytes(feats, nbr, out))
    moved = nbytes(feats, nbr, weight, out)
    if mode in BF16_MODES:
        return bound(2 * hits * Cin * Cout, moved, BF16_FLOPS)
    if mode in ("tc", "tc_noskip", "tc_nogather"):
        return bound(3 * 2 * hits * Cin * Cout, moved, TF32_FLOPS)
    if mode == "tc_1xtf32":
        return bound(2 * hits * Cin * Cout, moved, TF32_FLOPS)
    return bound(2 * hits * Cin * Cout, moved)


def fma_bound(feats, nbr, weight, out, mode: str) -> float:
    """The fp32-FMA bound (ms) beside each mode's: the scalar family's
    bound, whatever unit the mode multiplies on."""
    scalar = {"tc": "current", "tc_noskip": "current", "tc_nogather": "nogather",
              "tc_noproduct": "noproduct", "tc_1xtf32": "current", "bf16": "current",
              "bf16_noskip": "current", "bf16_nogather": "nogather",
              "bf16_noproduct": "noproduct"}.get(mode, mode)
    return mode_bound(feats, nbr, weight, out, scalar)[0]


def slab_fill(nbr: torch.Tensor, cap_in: int) -> dict:
    """How much of what K1/K2 multiply is useful, from ``nbr`` on the host: a
    warp multiplies its 16-row slab by W[k] when any of its rows hits (nbr
    in [0, cap_in)), and stages offset k for its 64-site tile when any site
    hits. ``fill`` = hit pairs / (16 x the (slab, offset) pairs multiplied),
    the share of multiplied rows that do useful work; ``tile_fill`` =
    hit pairs / (64 x the (tile, offset) pairs staged)."""
    hit = (nbr >= 0) & (nbr < cap_in)
    K, cap = hit.shape
    hit = hit.cpu()
    pairs = int(hit.sum())
    slabs = int(F.pad(hit, (0, -cap % SLAB)).view(K, -1, SLAB).any(-1).sum())
    tiles = int(F.pad(hit, (0, -cap % TC_TILE)).view(K, -1, TC_TILE).any(-1).sum())
    return {"hit_pairs": pairs, "slab_pairs": slabs, "tile_pairs": tiles,
            "fill": pairs / (SLAB * slabs) if slabs else 0.0,
            "tile_fill": pairs / (TC_TILE * tiles) if tiles else 0.0}


def stage_cases(enc, coords: torch.Tensor, mask: torch.Tensor, seed: int = 0):
    """The stage-0, stage-1 and stage-2 submanifold convs of ``enc`` (a
    ``SparseEncoder``) on one voxelized sample: [(label, feats, nbr,
    weight)], seeded random fp32 operands at the stage's site cap and
    width, the tables built as the encoder builds them."""
    stages = enc.sparse_sites(coords, mask)[:3]
    g = torch.Generator(device=coords.device).manual_seed(seed)
    cases = []
    for s, st in enumerate(stages):
        C = st["channels"]
        nbr = sp.build_subm_rulebook(st["ids"], st["grid"])
        feats = torch.randn(st["ids"].shape[0], C, generator=g, device=coords.device)
        w = torch.randn(27, C, C, generator=g, device=coords.device) * (2 / (27 * C)) ** 0.5
        cases.append((f"stage{s} subm {C}->{C}, {st['ids'].shape[0]} sites", feats, nbr, w))
    return cases


def _time_modes(feats, nbr, w, modes, tile, dev, iters, warmup):
    out = {}
    for mode in modes:
        y = sparse_conv_variant(feats, nbr, w, mode, tile)
        b_ms, b_by = mode_bound(feats, nbr, w, y, mode)
        ms = time_fn(lambda: sparse_conv_variant(feats, nbr, w, mode, tile), iters=iters,
                     warmup=warmup, device=dev, queue_ahead=True)["median_ms"]
        out[mode] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                     "bound_fp32_fma_ms": fma_bound(feats, nbr, w, y, mode)}
    return out


def _max_diff(feats, nbr, w, a: str, b: str, tile: int) -> float:
    return (sparse_conv_variant(feats, nbr, w, a, tile)
            - sparse_conv_variant(feats, nbr, w, b, tile)).abs().max().item()


def breakdown(cases, device="cuda", tiles=TILES, iters: int = 20, warmup: int = 5,
              families=tuple(FAMILIES)):
    """For each case: a row per scalar tile, one tensor-core row and one bf16
    row (``family``; those of ``families``), each with every mode's median
    ms, bound and fp32-FMA bound, and the split: ``gather_ms``,
    ``product_ms``, ``skip_saves_ms``; for the tensor cores ``split_ms``
    (3xTF32 over one TF32 product) and for both tensor-core families
    ``slab_fill``; the skip's check that both routes agree (``noskip_vs``:
    max|d| of ``noskip`` from ``current``, ``tc_noskip`` from ``tc``,
    ``bf16_noskip`` from ``bf16``). The bf16 family runs on the case's
    operands rounded to bf16, its row also with ``tiles_ms``, ``bf16`` on a
    table of misses (the prologue, the epilogue and the launch: what the
    tiles cost with no offset to stage), and on the card ``plan``, what its
    ``bf16`` launch runs (``bf16_plan``)."""
    dev = resolve_device(device)
    rows = []
    for label, feats, nbr, w in cases:
        if "scalar" in families:
            for tile in tiles:
                modes = _time_modes(feats, nbr, w, MODES, tile, dev, iters, warmup)
                ms = {m: v["ms"] for m, v in modes.items()}
                rows.append({"shape": label, "family": "scalar", "tile": tile, "modes": modes,
                             "gather_ms": ms["current"] - ms["nogather"],
                             "product_ms": ms["current"] - ms["noproduct"],
                             "skip_saves_ms": ms["noskip"] - ms["current"],
                             "noskip_vs": _max_diff(feats, nbr, w, "noskip", "current", tile)})
        for family in ("tc", "bf16"):
            if family not in families:
                continue
            x, wf = (feats.bfloat16(), w.bfloat16()) if family == "bf16" else (feats, w)
            base = FAMILIES[family][0]
            modes = _time_modes(x, nbr, wf, FAMILIES[family], TC_TILE, dev, iters, warmup)
            ms = {m.replace(family, "tc"): v["ms"] for m, v in modes.items()}
            row = {"shape": label, "family": family, "tile": TC_TILE, "modes": modes,
                   "gather_ms": ms["tc"] - ms["tc_nogather"],
                   "product_ms": ms["tc"] - ms["tc_noproduct"],
                   "skip_saves_ms": ms["tc_noskip"] - ms["tc"],
                   "slab_fill": slab_fill(nbr, feats.shape[0]),
                   "noskip_vs": _max_diff(x, nbr, wf, f"{base}_noskip", base, TC_TILE)}
            if family == "tc":
                row["split_ms"] = ms["tc"] - ms["tc_1xtf32"]
            else:  # what the tiles cost with no offset to stage: every entry a miss
                miss = torch.full_like(nbr, -1)
                row["tiles_ms"] = time_fn(lambda: sparse_conv_variant(x, miss, wf, base),
                                          iters=iters, warmup=warmup, device=dev,
                                          queue_ahead=True)["median_ms"]
                if dev.type == "cuda":
                    row["plan"] = bf16_plan(w.shape[1], nbr.shape[0], nbr.shape[1])
                    row["tile"] = TC_TILE * row["plan"]["slabs"]
            rows.append(row)
    return rows


def print_breakdown(rows) -> None:
    for r in rows:
        ms = {m: v["ms"] for m, v in r["modes"].items()}
        base = FAMILIES[r["family"]][0]
        noskip = "noskip" if base == "current" else f"{base}_noskip"
        line = (f"{r['shape']} {r['family']} tile {r['tile']}: "
                + ", ".join(f"{m} {v:.4f}" for m, v in ms.items())
                + f" ms; gather {r['gather_ms']:.4f}, product {r['product_ms']:.4f}, skip saves "
                f"{r['skip_saves_ms']:.4f} ms")
        if r["family"] == "tc":
            line += f", 3xTF32 split {r['split_ms']:.4f} ms"
        if r["family"] != "scalar":
            f = r["slab_fill"]
            line += (f"; slab fill {f['fill']:.3f} ({f['hit_pairs']} hit pairs over "
                     f"{f['slab_pairs']} slab x offset pairs of 16 rows), tile fill "
                     f"{f['tile_fill']:.3f}; {base} {r['modes'][base]['bound_ms'] / ms[base]:.3f} "
                     f"of its bound")
        if "tiles_ms" in r:
            line += f"; the tiles alone (every entry a miss) {r['tiles_ms']:.4f} ms"
        if "plan" in r:
            line += "; plan " + ", ".join(f"{k} {v}" for k, v in r["plan"].items())
        print(line + f"; {noskip} vs {base} max|d| {r['noskip_vs']:.3e}")


def bf16_sweep(cases, device="cuda", iters: int = 20, warmup: int = 5):
    """K1/K2 bf16's loop (mode ``bf16``) at each case at every depth of its
    ring it can launch (3..8 stages), the operands rounded to bf16: each
    row the plan (``bf16_plan``: resident blocks an SM, registers, shared
    memory), its median ms and whether it is the launch's own choice (the
    most resident blocks, then the most stages that keep them)."""
    dev = resolve_device(device)
    rows = []
    for label, feats, nbr, w in cases:
        x, w16 = feats.bfloat16(), w.bfloat16()
        C, K, cap_out = w.shape[1], nbr.shape[0], nbr.shape[1]
        own = bf16_plan(C, K, cap_out)["stages"]
        for stages in range(3, 9):
            try:
                plan = bf16_plan(C, K, cap_out, stages=stages)
            except RuntimeError:  # does not fit in shared memory
                continue
            ms = time_fn(lambda: sparse_conv_variant(x, nbr, w16, "bf16", stages=stages),
                         iters=iters, warmup=warmup, device=dev, queue_ahead=True)["median_ms"]
            rows.append({"shape": label, "plan": plan, "ms": ms, "chosen": stages == own})
    return rows


def print_sweep(rows) -> None:
    for r in rows:
        p = r["plan"]
        print(f"{r['shape']} bf16: {p['stages']} stages ({p['ahead']} ahead), "
              f"{p['blocks_per_sm']} blocks an SM, {p['registers']} registers, "
              f"{p['smem_bytes']} B: {r['ms']:.4f} ms" + ("  <- the launch's choice"
                                                          if r["chosen"] else ""))


def main(argv=None) -> int:
    from ..runtime.flagship import build_flagship

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=120000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sweep", action="store_true",
                    help="also time K1/K2 bf16's loop at every depth of its ring (bf16_sweep)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"device: {card_line()}")
        for cin, cout in itertools.product((16, 32, 64, 128), repeat=2):  # K1/K2 bf16, K = 27
            plan = sp.sparse_conv_bf16_plan(65536, 27, cin, cout)
            print(f"sparse_conv_bf16 plan <{cin}, {cout}>: "
                  + ", ".join(f"{k} {v}" for k, v in plan.items() if k != "grid"))
    _, model, batch = build_flagship(dev, num_points=args.points)
    with torch.no_grad():
        vox = model.lidar_voxelize(batch["points"], batch["points_mask"])
        cases = stage_cases(model.encoders["lidar"]["backbone"], vox.coords[0], vox.mask[0])
        print_breakdown(breakdown(cases, dev, iters=args.iters))
        if args.sweep:
            print_sweep(bf16_sweep(cases, dev, iters=args.iters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
