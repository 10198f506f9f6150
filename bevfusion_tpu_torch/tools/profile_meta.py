"""Per-op breakdown of the sparse encoder's meta chain (its rulebooks).

Counterpart of ``tools/profile_meta.py``. The sites of each stage that
runs sparse come from the voxelized scan and the config's ``site_caps``
through the encoder's own ``sparse_sites``; then each op of the port's
rulebook chain is timed alone at its stage's inputs:
``build_subm_rulebook``, and for a strided conv that runs sparse,
``downsample_sites``, ``build_conv_rulebook`` and
``build_conv_transpose_rulebook`` (training only). The JAX chain's
``build_column_table`` and ``build_windowed_rulebook`` exist for the TPU's
windowed kernels and have no counterpart in the port: they are printed as
absent, not as zero.

Run: ``python -m bevfusion_tpu_torch.tools.profile_meta`` (on the card).
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..devices import resolve_device
from ..ops import sparse_conv as sp
from ..utils.profiler import op_timer

TPU_ONLY = ("build_column_table", "build_windowed_rulebook")


def profile_meta(enc, coords: torch.Tensor, mask: torch.Tensor, device="cuda", iters: int = 10,
                 warmup: int = 2):
    """Rows {"op", "ms"} per stage and op of the rulebook chain (``ms``
    None for the TPU-only ops), each timed alone at its stage's inputs."""
    dev = resolve_device(device)
    rows = []
    timed = op_timer(rows, dev, iters, warmup)
    stages = enc.sparse_sites(coords, mask)
    for s, st in enumerate(stages):
        ids, grid = st["ids"], st["grid"]
        tag = f"s{s} ({ids.shape[0]} sites, {int(st['mask'].sum())} valid, C={st['channels']})"
        rows.append({"op": f"{tag} build_column_table", "ms": None})
        timed(f"{tag} build_subm_rulebook", lambda: sp.build_subm_rulebook(ids, grid))
        rows.append({"op": f"{tag} build_windowed_rulebook (subm)", "ms": None})
        if st["down"] is None:
            continue
        padding, cap_out = st["down"]
        geo = (enc.DOWN_KERNEL, enc.DOWN_STRIDE, padding)
        og = sp.conv_out_shape(grid, *geo)
        out_ids, _ = timed(f"{tag} downsample_sites -> {cap_out}",
                           lambda: sp.downsample_sites(ids, grid, *geo, cap_out))
        timed(f"{tag} build_conv_rulebook",
              lambda: sp.build_conv_rulebook(ids, out_ids, grid, og, *geo))
        timed(f"{tag} build_conv_transpose_rulebook (training)",
              lambda: sp.build_conv_transpose_rulebook(ids, out_ids, grid, og, *geo))
        rows.append({"op": f"{tag} build_windowed_rulebook (strided)", "ms": None})
    return rows


def print_rows(rows, width: int = 64) -> None:
    """Each row's ms, "absent" for an op the port does not have, and the
    sum of the timed ops."""
    for r in rows:
        ms = "absent (TPU-only, not ported)" if r["ms"] is None else f"{r['ms']:8.3f} ms"
        print(f"{r['op']:{width}s} {ms}")
    print(f"{'TOTAL (op-isolated sum)':{width}s} "
          f"{sum(r['ms'] for r in rows if r['ms'] is not None):8.3f} ms")


def main(argv=None) -> int:
    from ..runtime.flagship import build_flagship

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=120000)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _, model, batch = build_flagship(dev, num_points=args.points)
    with torch.no_grad():
        vox = model.lidar_voxelize(batch["points"], batch["points_mask"])
        print_rows(profile_meta(model.encoders["lidar"]["backbone"], vox.coords[0], vox.mask[0],
                                dev, args.iters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
