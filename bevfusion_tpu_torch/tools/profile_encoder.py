"""Micro-profile of the sparse encoder at flagship scale.

Counterpart of ``tools/profile_encoder.py``. Runs the port's
``SparseEncoder`` forward (eval, one sample) with a timer as its
``timed`` hook, so each piece is timed at its real inputs: the meta
chain (downsampled sites, rulebooks), every sparse conv of stages 0-2
through the hand-written kernel (K1/K2: C 16/32/64, folded BN, residual
and ReLU in its epilogue), and stage 3 as the port's encoder runs it,
dense (the densify scatter and ``F.conv3d``), with ``conv_out``. The caps
are the config's ``site_caps``, which the model runs (the JAX tool sized
its own).

Run: ``python -m bevfusion_tpu_torch.tools.profile_encoder`` (on the card).
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..devices import resolve_device
from ..utils.profiler import op_timer
from .profile_meta import print_rows


def profile_encoder(enc, voxel_feats, coords, mask, device="cuda", iters: int = 10,
                    warmup: int = 2):
    """(rows {"op", "ms"}, one a piece of ``enc``'s forward on one sample
    (voxel_feats [M, C], coords [M, 3], mask [M]); the encoder's output)."""
    rows = []
    out = enc(voxel_feats[None], coords[None], mask[None],
              timed=op_timer(rows, resolve_device(device), iters, warmup))
    return rows, out


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
        rows, _ = profile_encoder(model.encoders["lidar"]["backbone"], vox.feats[0],
                                  vox.coords[0], vox.mask[0], dev, args.iters)
    print_rows(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
