"""Tile occupancy of the tiled-dense sparse-conv design, with the H100's
constants.

Counterpart of ``tools/measure_tiles.py``: the same scan (the flagship's
120k-point ring scan at 0.075 m), the same site sets at each stage grid
(``voxel_coords``, then ``downsample`` three times, the last at the
flagship's (1, 1, 0) padding) and, for each candidate tile shape:

  - occupied tiles T, mean sites a tile, in-tile density;
  - the bytes a submanifold conv on padded tiles moves: every padded tile
    read once at Cin, every core written once at Cout, bf16 rows;
  - the least time of that conv on one H100: the bytes over 3.35 TB/s, and
    its products (T * vol * 27 * Cin * Cout multiply-adds) over the bf16
    tensor cores' 989 TFLOP/s, with the widths padded as the port's bf16
    loop issues its ``mma`` (``csrc/sparse_conv_bf16_tile.cuh``: Cin and Cout
    each padded to 16, 32, 64 or 128, the ``LayoutBf16<CIN_PAD, COUT_PAD>``
    the launch picks; no padding at the stages' widths 16 to 128).

The host work is numpy, copied from the JAX tool (``voxel_coords``,
``downsample``, ``tile_stats``, ``zext_stats``) and held to it bit for bit
by ``tests/test_torch_decision_tools.py``. The times are bounds from the
card's published rates, not measurements; ``bench_tiled_proto`` measures the
design on the card.

Run: ``python -m bevfusion_tpu_torch.tools.measure_tiles`` (names the card;
``--device cpu`` to print the same table without one).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..devices import resolve_device
from ..utils.profiler import BF16_FLOPS, HBM_BYTES_PER_S, card_line

PCR = np.array([-54, -54, -5, 54, 54, 3], np.float32)
VOX = np.array([0.075, 0.075, 0.2], np.float32)
# the widths the bf16 loop pads Cin and Cout to (csrc/sparse_conv.cu:launch_cout_bf16)
MMA_WIDTHS = (16, 32, 64, 128)
TILE_SHAPES = [(4, 4, 2), (4, 4, 4), (8, 8, 1), (8, 8, 2), (8, 8, 4), (8, 8, 8), (4, 4, 8),
               (16, 16, 4)]  # then (8, 8, Z) and (16, 16, Z), whole columns
STAGE_CHANNELS = [(16, 16), (32, 32), (64, 64), (128, 128)]
SCAN_POINTS, SCAN_SEED = 120000, 0  # the JAX tool's scan


def voxel_coords(points):
    """Sorted unique voxel coords [M, 3] (x, y, z) of the points on the
    1440 x 1440 x 41 grid."""
    c = np.floor((points[:, :3] - PCR[:3]) / VOX).astype(np.int64)
    ok = ((c >= 0).all(1) & (c[:, 0] < 1440) & (c[:, 1] < 1440)
          & (c[:, 2] < 41))
    c = c[ok]
    ids = (c[:, 0] * 1440 + c[:, 1]) * 41 + c[:, 2]
    ids = np.unique(ids)
    x, r = ids // (1440 * 41), ids % (1440 * 41)
    return np.stack([x, r // 41, r % 41], 1)


def downsample(coords, grid, k=3, s=2, p=(1, 1, 1)):
    """Active outputs of a strided sparse conv (parents of any input):
    (coords [M', 3] sorted, the output grid)."""
    og = tuple((g + 2 * pi - k) // s + 1 for g, pi in zip(grid, p))
    offs = np.arange(k)
    cand = []
    for ax in range(3):
        c = coords[:, ax]
        o = (c[:, None] + p[ax] - offs[None, :])
        ok = (o % s == 0)
        o = o // s
        ok &= (o >= 0) & (o < og[ax])
        cand.append((o, ok))
    ids = []
    for i in range(k):
        for j in range(k):
            for l in range(k):
                ok = cand[0][1][:, i] & cand[1][1][:, j] & cand[2][1][:, l]
                o = (cand[0][0][:, i] * og[1] + cand[1][0][:, j]) * og[2] + cand[2][0][:, l]
                ids.append(o[ok])
    ids = np.unique(np.concatenate(ids))
    x, r = ids // (og[1] * og[2]), ids % (og[1] * og[2])
    return np.stack([x, r // og[2], r % og[2]], 1), og


def mma_width(c: int) -> int:
    """The width the bf16 loop pads ``c`` channels to."""
    return next(w for w in MMA_WIDTHS if c <= w)


def tile_stats(coords, grid, tshape, cin, cout, label):
    """T, in-tile density, the bytes of one submanifold conv on the padded
    tiles (bf16), and its time bounds on the H100 (ms): ``t_mem`` the bytes
    over 3.35 TB/s, ``t_mma`` the products at the bf16 loop's padded widths
    over 989 TFLOP/s. Prints one line."""
    tx, ty, tz = tshape
    t = coords // np.array([tx, ty, tz])
    tg = tuple(-(-g // s) for g, s in zip(grid, (tx, ty, tz)))
    tid = (t[:, 0] * tg[1] + t[:, 1]) * tg[2] + t[:, 2]
    uniq = np.unique(tid)
    T = len(uniq)
    sites = coords.shape[0]
    vol = tx * ty * tz
    pvol = (tx + 2) * (ty + 2) * (tz + 2)
    dens = sites / (T * vol)
    rd = T * pvol * cin * 2
    wr = T * vol * cout * 2
    t_mem = (rd + wr) / HBM_BYTES_PER_S * 1e3
    t_mma = 2 * T * vol * 27 * mma_width(cin) * mma_width(cout) / BF16_FLOPS * 1e3
    print(f"  {label} tile {tx}x{ty}x{tz}: T={T:6d} sites/tile={sites/T:6.1f} "
          f"dens={dens*100:5.1f}% bytes={int((rd+wr)/1e6):4d}MB "
          f"t_mem={t_mem:7.4f}ms t_mma(pad {mma_width(cin)}x{mma_width(cout)})={t_mma:7.4f}ms")
    return dict(T=T, dens=dens, bytes=rd + wr, t_mem=t_mem, t_mma=t_mma)


def zext_stats(coords, grid, tx, ty, label):
    """z-extent per occupied 2D footprint tile (for z-windowed tiles):
    prints the JAX tool's line and returns the extents, one a footprint in
    the order the footprints first appear."""
    t = coords[:, 0] // tx * 10**6 + coords[:, 1] // ty
    zmin, zmax = {}, {}
    for ti, z in zip(t.tolist(), coords[:, 2].tolist()):
        zmin[ti] = min(zmin.get(ti, 99), z)
        zmax[ti] = max(zmax.get(ti, -1), z)
    ext = np.array([zmax[k] - zmin[k] + 1 for k in zmin])
    print(f"  {label} {tx}x{ty} cols: T2d={len(ext)} z-extent "
          f"p50={np.percentile(ext,50):.0f} p90={np.percentile(ext,90):.0f} "
          f"p99={np.percentile(ext,99):.0f} max={ext.max()}")
    return ext


def stage_sites():
    """The scan's sites at the four stage grids: [(coords, grid)]."""
    from ..runtime.flagship import synthetic_lidar_scan

    pts, mask = synthetic_lidar_scan(SCAN_POINTS, PCR, seed=SCAN_SEED)
    c0 = voxel_coords(pts[mask])
    g0 = (1440, 1440, 41)
    c1, g1 = downsample(c0, g0)
    c2, g2 = downsample(c1, g1)
    c3, g3 = downsample(c2, g2, p=(1, 1, 0))  # the flagship's stage-2 -> 3 padding
    return [(c0, g0), (c1, g1), (c2, g2), (c3, g3)]


def measure(stages):
    """Every stage's tile rows (``tile_stats``) and z-extents: [{"stage",
    "grid", "sites", "tiles": [tile_stats dicts]}]."""
    out = []
    for si, ((c, g), (ci, co)) in enumerate(zip(stages, STAGE_CHANNELS)):
        print(f"--- stage{si} grid {g} sites {len(c)} C={ci}->{co}")
        tiles = [dict(tile_stats(c, g, ts, ci, co, f"s{si}"), tile=ts)
                 for ts in TILE_SHAPES + [(8, 8, g[2]), (16, 16, g[2])]]
        zext_stats(c, g, 8, 8, f"s{si}")
        zext_stats(c, g, 16, 16, f"s{si}")
        out.append({"stage": si, "grid": g, "sites": len(c), "tiles": tiles})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        print(f"device: {card_line()}")
    print(f"bounds at {HBM_BYTES_PER_S / 1e12:.2f} TB/s and {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 "
          f"(NVIDIA H100 SXM, 700 W)")
    stages = stage_sites()
    (c0, _), (c1, g1), (c2, g2), (c3, g3) = stages
    print(f"stage0 sites: {len(c0)} (grid 1440x1440x41)")
    print(f"stage1 sites: {len(c1)} grid {g1}; stage2 sites: {len(c2)} grid {g2}; stage3 sites: "
          f"{len(c3)} grid {g3}")
    measure(stages)
    return 0


if __name__ == "__main__":
    sys.exit(main())
