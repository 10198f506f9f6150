"""The tiled-dense sparse-conv prototype against the port's engine, measured.

Counterpart of ``tools/bench_tiled_proto.py``, the decision experiment for
a sparse conv that needs no rulebook: pack the occupied (tx, ty, tz) tiles
densely, halo included, run dense 3D convs a tile, mask back to the sites
(submanifold validity), and gather the halo again between convs. Timed on
the card at the scan's own site sets of stages 0-2, against the port's
engine on the same sites, the rulebook's cost spread over the stage's
convs as in the encoder:

  tiled:   core scatter (once) -> NCONV x [halo gather -> ``F.conv3d``
           (cuDNN, unpadded, channels-last) -> scale, shift, ReLU in fp32
           -> submanifold mask]
  engine:  ``ops/sparse_conv.py:build_subm_rulebook`` (once) -> NCONV x
           ``sparse_conv_bf16`` (K1, the hand kernel: scale, shift, ReLU in
           its epilogue)

Each chain is timed as one call with ``utils/profiler.py:time_fn(...,
queue_ahead=True)``: the card waits until every call of the chain is
queued, so the reading is the chain's time on the card without the host's
gaps between launches (the port's counterpart of the JAX tool's one jitted
program; no CUDA graph). The JAX engine's ``build_column_table``,
``build_column_table9`` and ``build_windowed_rulebook`` exist only for its
TPU kernel: they are printed as absent.

Each stage also splits both chains: the tiled conv's parts timed apart
(scatter, halo gather, ``conv3d``, the epilogue and mask), and the
engine's chain into its rulebook, its K1 bf16 launches and the rest,
with one call of the chain and one of the rulebook under
``torch.profiler`` (``utils/profiler.py:device_trace``): the rest is the
other device work of the chain (the rows' cast to bf16) and the card's
idle time between launches. Beside them stands an estimate, arithmetic on
the measured parts and not a measured design: a tiled conv whose halo
gather runs at its bound and whose epilogue is fused into the conv, i.e.
``conv3d`` + the tiled conv's bound + the scatter spread over the convs.
The prototype's halo gather (``index_select``), its separate fp32
epilogue passes and its tiling maps built on the host (numpy) are what a
hand-written design would change.

``F.conv3d`` computes the tile products as the JAX tool leaves them to
``lax.conv_general_dilated``, outside any Pallas kernel. The JAX tool sums
in fp32 (``preferred_element_type``) and rounds to bf16 once, after the
ReLU; cuDNN's bf16 conv sums in fp32 and returns bf16, so the tiled conv
rounds twice: the conv's sums, then the epilogue's result. At unit scale
and zero shift (the stages' own) the second rounding is exact, and one
bf16 rounding (2^-7 relative) plus 1e-4 of the scale holds it, as it holds
K1 bf16; at another scale or shift, two roundings.

The stages' sites are the flagship's (``measure_tiles.stage_sites``: voxels
of 0.075 x 0.075 x 0.2 m, points outside the grid dropped; 70,748 / 74,134 /
49,178 sites at stages 0 / 1 / 2 of the 120k-point scan), the sites the
engine serves. The JAX tool voxelizes z at 0.075 m too and clips it to the
grid's 41 planes, which piles the 18% of the scan's points above z = -2 m
into the top plane (68,885 / 91,166 / 42,880 sites); the port does not copy
that.

A correctness parity on a tiny grid runs first, in fp32 (TF32 off),
against the gather-GEMM oracle ``sparse_conv_plain`` within the JAX tool's
2e-3, so the numbers are for a correct formulation. Reference match:
mmdet3d/ops/spconv/include/spconv/spconv_ops.h:261-360 (the gather-GEMM
rulebook engine this prototype would replace).

Run: ``python -m bevfusion_tpu_torch.tools.bench_tiled_proto`` (on the card).
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..ops import sparse_conv as sp
from ..utils.profiler import BF16_FLOPS, bound, card_line, device_trace, nbytes, time_fn
from .measure_tiles import stage_sites

NCONV = 4  # submanifold convs that share one rulebook or tiling build
PARITY_TOL = 2e-3  # the JAX tool's, tiled vs the oracle in fp32
BF16_REL = 2.0 ** -7  # one bf16 rounding, relative
FP32_ORDER = 1e-4  # of the scale: fp32 sums in another order
# the JAX engine's ops that exist for the TPU's windowed kernel only
TPU_ONLY = ("build_column_table", "build_column_table9", "build_windowed_rulebook")
# (name, channels, site cap, tile) of the JAX tool's stages (tools/bench_tiled_proto.py:236-240)
STAGES = (("stage0", 16, 120000, (4, 4, 2)), ("stage1", 32, 100000, (4, 4, 4)),
          ("stage2", 64, 60000, (4, 4, 4)))
# the JAX tool's parity: a 12 x 12 x 8 grid, 160 sites, a 256-site cap, C = 8, tile 4^3
PARITY = {"grid": (12, 12, 8), "sites": 160, "cap": 256, "channels": 8, "tile": (4, 4, 4)}
K1_BF16_KERNEL = "sparse_conv_bf16_kernel"  # K1 bf16's kernel, as the profiler names it


def build_tiling_np(coords, grid, tshape, cap):
    """Host maps for the tiled layout (the JAX tool's function, vectorised;
    its maps bit for bit).

    coords [M, 3] occupied voxel coords (sorted by flat id), grid
    (X, Y, Z), tshape (tx, ty, tz). Returns
      core_scatter [cap]    packed site row -> flat core index
                            (slot * vol + voxel); sentinel rows ->
                            T*vol+1 (out of bounds of the [T*vol+1]
                            core array -> dropped, NOT the zero row)
      hmap [T, pvol]        flat core index per padded-tile voxel
                            (T*vol = miss/zero row), x-major, z-minor
      occ [T * vol]         1.0 where the core voxel is an active site
      T, vol, pvol
    """
    tx, ty, tz = tshape
    X, Y, Z = grid
    tgy, tgz = -(-Y // ty), -(-Z // tz)
    t = coords // np.array([tx, ty, tz])
    tid = (t[:, 0] * tgy + t[:, 1]) * tgz + t[:, 2]
    uniq, inv = np.unique(tid, return_inverse=True)
    T = len(uniq)
    vol = tx * ty * tz
    px, py, pz = tx + 2, ty + 2, tz + 2
    pvol = px * py * pz

    local = coords - t * np.array([tx, ty, tz])
    voxel = (local[:, 0] * ty + local[:, 1]) * tz + local[:, 2]
    core_idx = inv.reshape(-1) * vol + voxel

    core_scatter = np.full(cap, T * vol + 1, np.int32)
    core_scatter[: len(coords)] = core_idx

    occ = np.zeros(T * vol, np.float32)
    occ[core_idx] = 1.0

    # site lookup: flat voxel id -> core index, by a search of the sorted ids
    site_flat = (coords[:, 0] * Y + coords[:, 1]) * Z + coords[:, 2]
    order = np.argsort(site_flat, kind="stable")
    flat_sorted, core_sorted = site_flat[order], core_idx[order]

    # every padded-tile voxel of every tile: the tile's origin - 1 + (dx, dy, dz)
    d = np.stack(np.meshgrid(np.arange(px), np.arange(py), np.arange(pz), indexing="ij"),
                 -1).reshape(pvol, 3)
    base = np.stack([uniq // (tgy * tgz) * tx, (uniq // tgz) % tgy * ty, uniq % tgz * tz],
                    -1) - 1
    g = base[:, None, :] + d[None, :, :]  # [T, pvol, 3]
    ok = ((g >= 0) & (g < np.array([X, Y, Z]))).all(-1)
    flat = (g[..., 0] * Y + g[..., 1]) * Z + g[..., 2]
    pos = np.minimum(np.searchsorted(flat_sorted, flat), len(flat_sorted) - 1)
    hit = ok & (flat_sorted[pos] == flat)
    hmap = np.where(hit, core_sorted[pos], T * vol).astype(np.int32)
    return core_scatter, hmap, occ, T, vol, pvol


class Tiling(NamedTuple):
    """``build_tiling_np``'s maps as tensors on a device, with the tile."""
    core_scatter: torch.Tensor  # [cap] int64
    hmap: torch.Tensor  # [T * pvol] int32
    occ: torch.Tensor  # [T, 1, tx, ty, tz] float32
    tile: Tuple[int, int, int]
    T: int

    @classmethod
    def build(cls, coords, grid, tshape, cap, device) -> "Tiling":
        cs, hm, occ, T, _, _ = build_tiling_np(coords, grid, tshape, cap)
        return cls(torch.as_tensor(cs, device=device).long(),
                   torch.as_tensor(hm, device=device).reshape(-1),
                   torch.as_tensor(occ, device=device).view(T, 1, *tshape), tuple(tshape), T)

    @property
    def vol(self) -> int:
        return self.tile[0] * self.tile[1] * self.tile[2]

    @property
    def pvol(self) -> int:
        return (self.tile[0] + 2) * (self.tile[1] + 2) * (self.tile[2] + 2)


def conv3d_weights(weights: torch.Tensor, dtype) -> list:
    """The engine's weights [NCONV, 27, Cin, Cout] (``kernel_offsets``
    order: x-major, z-minor, i.e. DHWIO [dx, dy, dz, Cin, Cout]) as
    ``F.conv3d``'s [Cout, Cin, kx, ky, kz], channels-last, in ``dtype``."""
    _, _, cin, cout = weights.shape
    return [w.view(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).to(dtype)
            .contiguous(memory_format=torch.channels_last_3d) for w in weights]


def scatter_cores(feats, tiling: Tiling, dtype=torch.bfloat16):
    """The packed site rows [cap, C] scattered into the tile cores
    [T * vol + 1, C] in ``dtype`` (row T * vol the zero row)."""
    rows = tiling.T * tiling.vol
    cores = feats.new_zeros((rows + 2, feats.shape[1]), dtype=dtype)
    cores[tiling.core_scatter] = feats.to(dtype)  # sentinel rows land in row T*vol+1, dropped
    return cores[: rows + 1]


def halo(cores, tiling: Tiling):
    """Every tile with its halo, gathered from the cores by ``hmap`` (a miss
    reads the zero row): [T, C, tx+2, ty+2, tz+2], channels-last."""
    tx, ty, tz = tiling.tile
    return cores.index_select(0, tiling.hmap).view(
        tiling.T, tx + 2, ty + 2, tz + 2, cores.shape[1]).permute(0, 4, 1, 2, 3)


def mask_back(out, scale, shift, occ, dtype=torch.bfloat16, relu: bool = True):
    """A conv's output [T, C, tx, ty, tz]: ``relu(out * scale + shift)`` in
    fp32, rounded to ``dtype``, times the occupancy, as cores [T * vol + 1,
    C] again."""
    C = out.shape[1]
    y = out.float() * scale.view(1, C, 1, 1, 1) + shift.view(1, C, 1, 1, 1)
    y = (torch.relu(y) if relu else y).to(dtype) * occ
    return torch.cat([y.permute(0, 2, 3, 4, 1).reshape(-1, C), y.new_zeros((1, C))])


def tiled_chain(feats, weights, scales, shifts, tiling: Tiling, dtype=torch.bfloat16,
                relu: bool = True):
    """``len(weights)`` submanifold convs on the packed tiles: feats [cap, C]
    (the packed site rows), ``weights`` from ``conv3d_weights``, scales and
    shifts [n, C] fp32. Returns the cores [T * vol + 1, C] in ``dtype`` (row
    T * vol the zero row): a conv is ``halo``, ``F.conv3d`` (unpadded), then
    ``mask_back``."""
    cores = scatter_cores(feats, tiling, dtype)
    occ = tiling.occ.to(dtype)
    for w, scale, shift in zip(weights, scales, shifts):
        cores = mask_back(F.conv3d(halo(cores, tiling), w), scale, shift, occ, dtype, relu)
    return cores


def site_rows(cores: torch.Tensor, tiling: Tiling) -> torch.Tensor:
    """The cores' rows back at the packed sites [cap, C]; sentinel rows 0."""
    return torch.cat([cores, cores.new_zeros((1, cores.shape[1]))])[tiling.core_scatter]


def engine_chain(feats, weights, scales, shifts, ids, grid, dtype=torch.bfloat16):
    """The port's engine on the same sites: ``build_subm_rulebook`` once,
    then a ``sp.sparse_conv`` a conv with scale, shift and ReLU in its
    epilogue: on the card K1 bf16 for bf16 rows and K1's 3xTF32 kernel for
    fp32 ones, on the CPU ``sparse_conv_plain``. weights [n, 27, C, C] in
    ``dtype``, scales / shifts [n, C] fp32. Returns the rows [cap, C]."""
    nbr = sp.build_subm_rulebook(ids, grid)
    x = feats.to(dtype)
    for w, scale, shift in zip(weights, scales, shifts):
        x = sp.sparse_conv(x, nbr, w, scale, shift, relu=True)
    return x


@contextlib.contextmanager
def no_tf32():
    """Both TF32 switches off for the block (cuDNN's convs and cuBLAS's
    matmuls in full fp32), restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def parity(device="cuda") -> dict:
    """The JAX tool's parity (its ``:167-199``): one tiled conv, fp32 and no
    epilogue, on the tiny grid against the gather-GEMM oracle
    (``sparse_conv_plain``) at the valid sites; TF32 off. Returns
    {"max_err", "rng"}: the error and the numpy generator after its draws,
    from which the stages draw (as in the JAX tool)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    (X, Y, Z), n, cap, C = PARITY["grid"], PARITY["sites"], PARITY["cap"], PARITY["channels"]
    flat = np.sort(rng.choice(X * Y * Z, n, replace=False))
    coords = np.stack([flat // (Y * Z), (flat // Z) % Y, flat % Z], 1)
    ids = np.full(cap, X * Y * Z, np.int32)
    ids[:n] = flat
    feats = rng.rand(cap, C).astype(np.float32)
    feats[n:] = 0
    w = rng.rand(3, 3, 3, C, C).astype(np.float32) - 0.5

    tiling = Tiling.build(coords, (X, Y, Z), PARITY["tile"], cap, dev)
    x = torch.as_tensor(feats, device=dev)
    w27 = torch.as_tensor(w.reshape(1, 27, C, C), device=dev)
    ones, zeros = torch.ones(1, C, device=dev), torch.zeros(1, C, device=dev)
    nbr = sp.build_subm_rulebook(torch.as_tensor(ids, device=dev), sp.SparseGrid(X, Y, Z))
    with no_tf32():
        got = site_rows(tiled_chain(x, conv3d_weights(w27, torch.float32), ones, zeros, tiling,
                                    torch.float32, relu=False), tiling)
        want = sp.sparse_conv_plain(x, nbr, w27[0])
    err = (got[:n] - want[:n]).abs().max().item()
    if not err < PARITY_TOL:
        raise RuntimeError(f"tiled formulation wrong: max err {err}")
    return {"max_err": err, "rng": rng}


def scan_stages():
    """The stages' site sets: the flagship's voxels of the 120k-point scan
    (``measure_tiles.stage_sites``), then two downsamples: [(name, coords,
    grid, C, cap, tile)]."""
    return [(name, c, g, C, cap, tile) for (name, C, cap, tile), (c, g) in
            zip(STAGES, stage_sites())]


class StageInputs(NamedTuple):
    feats: torch.Tensor  # [cap, C] fp32
    weights: torch.Tensor  # [NCONV, 27, C, C] fp32
    scales: torch.Tensor  # [NCONV, C] fp32, ones
    shifts: torch.Tensor  # [NCONV, C] fp32, zeros
    ids: torch.Tensor  # [cap] int32, the sites' ids (grid.size pads)
    grid: sp.SparseGrid
    tiling: Tiling


def stage_inputs(rng, coords, grid, C: int, cap: int, tile, device) -> StageInputs:
    """A stage's operands, drawn from ``rng`` as the JAX tool draws them
    (feats ``rand``, weights ``rand * 0.1``), unit scale, zero shift."""
    feats = rng.rand(cap, C).astype(np.float32)
    ws = rng.rand(NCONV, 3, 3, 3, C, C).astype(np.float32) * 0.1
    ids = np.full(cap, grid[0] * grid[1] * grid[2], np.int32)
    ids[: len(coords)] = (coords[:, 0] * grid[1] + coords[:, 1]) * grid[2] + coords[:, 2]
    return StageInputs(torch.as_tensor(feats, device=device),
                       torch.as_tensor(ws.reshape(NCONV, 27, C, C), device=device),
                       torch.ones(NCONV, C, device=device), torch.zeros(NCONV, C, device=device),
                       torch.as_tensor(ids, device=device), sp.SparseGrid(*grid),
                       Tiling.build(coords, grid, tile, cap, device))


def conv_gaps(s: StageInputs, valid: torch.Tensor) -> dict:
    """One tiled conv and one engine conv (K1 bf16 on the card), bf16, each
    against ``sparse_conv_plain`` in fp32 (TF32 off) on the same bf16-valued operands
    at the valid sites: {"tiled" / "engine": {"max_abs_err", "bad"}}, "bad"
    the elements past one bf16 rounding plus 1e-4 of the scale."""
    x, w = s.feats.bfloat16(), s.weights[:1].bfloat16()
    nbr = sp.build_subm_rulebook(s.ids, s.grid)
    with no_tf32():
        want = sp.sparse_conv_plain(x.float(), nbr, w[0].float(), s.scales[0], s.shifts[0],
                                    relu=True)[valid]
    got = {"tiled": site_rows(tiled_chain(x, conv3d_weights(w, torch.bfloat16), s.scales[:1],
                                          s.shifts[:1], s.tiling), s.tiling),
           "engine": sp.sparse_conv(x, nbr, w[0], s.scales[0], s.shifts[0], relu=True)}
    scale = max(want.abs().max().item(), 1.0)
    out = {}
    for name, g in got.items():
        d = (g.float()[valid] - want).abs()
        out[name] = {"max_abs_err": d.max().item(),
                     "bad": int((d > BF16_REL * want.abs() + FP32_ORDER * scale).sum())}
    return out


def bench_stage(name, coords, grid, C, s: StageInputs, device="cuda", iters: int = 10,
                warmup: int = 3) -> dict:
    """Both chains of one stage timed (ms a chain and a conv), the rulebook
    and one K1 bf16 launch alone, and their bounds a conv: the tiled conv's
    halo in and cores out over 3.35 TB/s against 2 * T * vol * 27 * C^2
    FLOPs over 989 TFLOP/s; K1 bf16's bytes (rows, rulebook, weight, out,
    scale, shift once) against 2 * hits * C^2. Then the engine chain split
    (``engine_split``) and the fused tiled conv's estimate (ms a conv:
    ``conv3d`` + the tiled bound + the scatter over the convs)."""
    dev = resolve_device(device)
    t = s.tiling
    w3 = conv3d_weights(s.weights, torch.bfloat16)
    w16 = s.weights.bfloat16()

    def timed(fn):
        return time_fn(fn, iters=iters, warmup=warmup, device=dev, queue_ahead=True)["median_ms"]

    tiled_ms = timed(lambda: tiled_chain(s.feats, w3, s.scales, s.shifts, t))
    engine_ms = timed(lambda: engine_chain(s.feats, w16, s.scales, s.shifts, s.ids, s.grid))
    nbr = sp.build_subm_rulebook(s.ids, s.grid)
    x = s.feats.bfloat16()
    rulebook_ms = timed(lambda: sp.build_subm_rulebook(s.ids, s.grid))
    # the tiled chain's parts apart, at its first conv
    cores = scatter_cores(s.feats, t)
    occ = t.occ.bfloat16()
    padded = halo(cores, t)
    conv_out = F.conv3d(padded, w3[0])
    parts = {"scatter": timed(lambda: scatter_cores(s.feats, t)),
             "halo": timed(lambda: halo(cores, t)),
             "conv3d": timed(lambda: F.conv3d(padded, w3[0])),
             "mask_back": timed(lambda: mask_back(conv_out, s.scales[0], s.shifts[0], occ))}
    out = sp.sparse_conv(x, nbr, w16[0], s.scales[0], s.shifts[0], relu=True)
    conv_ms = timed(lambda: sp.sparse_conv(x, nbr, w16[0], s.scales[0], s.shifts[0], relu=True))
    split = engine_split(lambda: engine_chain(s.feats, w16, s.scales, s.shifts, s.ids, s.grid),
                         lambda: sp.build_subm_rulebook(s.ids, s.grid), engine_ms, rulebook_ms,
                         conv_ms, dev)
    hits = int((nbr >= 0).sum())
    halo_bytes = t.T * t.pvol * C * 2
    tiled_bound = bound(2 * t.T * t.vol * 27 * C * C, halo_bytes + t.T * t.vol * C * 2,
                        BF16_FLOPS)
    k1_bound = bound(2 * hits * C * C, nbytes(x, nbr, w16[0], out, s.scales[0], s.shifts[0]),
                     BF16_FLOPS)
    return {"stage": name, "sites": len(coords), "grid": tuple(grid), "C": C,
            "cap": s.feats.shape[0], "tile": t.tile, "T": t.T,
            "density": len(coords) / (t.T * t.vol), "halo_mb": halo_bytes / 1e6, "hits": hits,
            "tiled_ms": tiled_ms, "tiled_ms_per_conv": tiled_ms / NCONV,
            "engine_ms": engine_ms, "engine_ms_per_conv": engine_ms / NCONV,
            "rulebook_ms": rulebook_ms, "k1_ms": conv_ms, "tiled_parts_ms": parts,
            "engine_split": split,
            "fused_estimate_ms_per_conv": parts["conv3d"] + tiled_bound[0]
            + parts["scatter"] / NCONV,
            "tiled_bound_ms": tiled_bound[0], "tiled_bound_by": tiled_bound[1],
            "k1_bound_ms": k1_bound[0], "k1_bound_by": k1_bound[1]}


def engine_split(chain, rulebook, chain_ms, rulebook_ms, k1_ms, device) -> dict:
    """The engine chain's time (``chain_ms``, queued ahead) apart: the
    rulebook's and NCONV K1 bf16 launches' own timings, and the rest; one
    call of the chain and one of the rulebook traced (``device_trace``),
    so the rest splits into the chain's other device work (busy less the
    rulebook's busy and K1's) and the card's idle time in the chain
    (``chain_ms`` less its busy). On the CPU both traces are empty."""
    tc = device_trace(chain, (K1_BF16_KERNEL,), device)
    tr = device_trace(rulebook, (), device)
    busy, k1_busy, rb_busy = tc["device_busy_ms"], tc["mark_ms"], tr["device_busy_ms"]
    return {"rest_ms": chain_ms - rulebook_ms - NCONV * k1_ms, "busy_ms": busy,
            "k1_busy_ms": k1_busy, "rulebook_busy_ms": rb_busy,
            "other_busy_ms": busy - k1_busy - rb_busy, "idle_ms": chain_ms - busy,
            "activities": tc["device_activities"],
            "sessions": (tc["activities_per_session"], tr["activities_per_session"]),
            "top": tc["top"]}


def print_stage(r) -> None:
    print(f"-- {r['stage']}: {r['sites']} sites, grid {r['grid']}, C={r['C']}, tile {r['tile']}: "
          f"T={r['T']} tiles, in-tile density {r['density'] * 100:.1f}%, halo "
          f"{r['halo_mb']:.0f} MB a conv")
    print(f"  tiled {NCONV}x subm conv (scatter + gather, conv3d, mask)   {r['tiled_ms']:8.4f} ms "
          f"({r['tiled_ms_per_conv']:.4f} ms/conv; bound {r['tiled_bound_ms']:.4f} ms/conv, "
          f"{r['tiled_bound_by']}, {r['tiled_bound_ms'] / r['tiled_ms_per_conv']:.3f} of it)")
    print("  tiled parts (one conv): " + ", ".join(f"{k} {v:.4f} ms"
                                                   for k, v in r["tiled_parts_ms"].items()))
    print(f"  engine rulebook + {NCONV}x K1 bf16                          {r['engine_ms']:8.4f} ms "
          f"({r['engine_ms_per_conv']:.4f} ms/conv; rulebook {r['rulebook_ms']:.4f} ms, one K1 "
          f"bf16 {r['k1_ms']:.4f} ms, its bound {r['k1_bound_ms']:.4f} ms, {r['k1_bound_by']}, "
          f"{r['k1_bound_ms'] / r['k1_ms']:.3f} of it; {r['hits']} hit pairs)")
    e = r["engine_split"]
    print(f"  engine chain split: rulebook {r['rulebook_ms']:.4f} + {NCONV}x K1 bf16 "
          f"{NCONV * r['k1_ms']:.4f} + the rest {e['rest_ms']:.4f} ms; one chain traced: busy "
          f"{e['busy_ms']:.4f} ms over {e['activities']} kernels and copies (rulebook "
          f"{e['rulebook_busy_ms']:.4f}, K1 bf16 {e['k1_busy_ms']:.4f}, other "
          f"{e['other_busy_ms']:.4f}; the sessions saw {e['sessions'][0]} and {e['sessions'][1]} "
          f"activities), the card idle {e['idle_ms']:.4f} ms of the chain; most "
          f"device time: " + "; ".join(f"{k['name'][:60]} x{k['count']} {k['ms']:.4f} ms"
                                       for k in e["top"]))
    print(f"  estimate, not measured: a tiled conv with its halo gather at its bound and its "
          f"epilogue fused, {r['fused_estimate_ms_per_conv']:.4f} ms/conv (conv3d + bound + "
          f"scatter / {NCONV}) against the engine's {r['engine_ms_per_conv']:.4f}")
    for op in TPU_ONLY:
        print(f"  {op:56s} absent (TPU-only, not ported)")


def print_table(rows) -> None:
    """The JAX tool's closing table, its second column the port's engine."""
    print("\n| stage | tiled ms/conv | engine: rulebook + K1 bf16 (meta amortized) ms/conv |")
    print("|---|---|---|")
    for r in rows:
        print(f"| {r['stage']} | {r['tiled_ms_per_conv']:.4f} | {r['engine_ms_per_conv']:.4f} |")


def prepare(device="cuda") -> dict:
    """The parity, then every stage's operands drawn after it: {"parity":
    ``parity``'s result, "stages": [(name, coords, grid, C, StageInputs)],
    "tiling_s": [host seconds of each stage's tiling maps and operands]}."""
    dev = resolve_device(device)
    par = parity(dev)
    print(f"parity OK (tiled vs oracle, max err {par['max_err']:.2e})", flush=True)
    stages, tiling_s = [], []
    for name, coords, grid, C, cap, tile in scan_stages():
        t0 = time.perf_counter()
        stages.append((name, coords, grid, C,
                       stage_inputs(par["rng"], coords, grid, C, cap, tile, dev)))
        tiling_s.append(time.perf_counter() - t0)
    return {"parity": par, "stages": stages, "tiling_s": tiling_s}


def run(device="cuda", iters: int = 10, warmup: int = 3, prepared=None) -> dict:
    """Every stage of ``prepared`` (``prepare(device)`` if None): {"parity_max_err",
    "stages": [rows], "gaps": the stage-0 ``conv_gaps``, "tiling_s": [host
    seconds of each stage's tiling]}. Prints as it goes."""
    dev = resolve_device(device)
    prepared = prepare(dev) if prepared is None else prepared
    par, tiling_s = prepared["parity"], prepared["tiling_s"]
    rows, gaps = [], None
    for (name, coords, grid, C, s), sec in zip(prepared["stages"], tiling_s):
        if gaps is None:
            gaps = conv_gaps(s, s.ids < s.grid.size)
        rows.append(bench_stage(name, coords, grid, C, s, dev, iters, warmup))
        print_stage(rows[-1])
        print(f"  host: tiling maps and operands {sec:.2f} s", flush=True)
    print("stage0 one conv vs fp32 sparse_conv_plain on the valid sites (one bf16 rounding + "
          "1e-4 of scale): " + ", ".join(f"{k} max|d| {v['max_abs_err']:.3e}, {v['bad']} past"
                                         for k, v in gaps.items()))
    print_table(rows)
    return {"parity_max_err": par["max_err"], "stages": rows, "gaps": gaps,
            "tiling_s": tiling_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"device: {card_line()}")
    with torch.no_grad():
        run(dev, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
