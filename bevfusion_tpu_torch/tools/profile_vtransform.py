"""Per-op breakdown of the camera view transform (DepthLSS + BEV pool).

Counterpart of ``tools/profile_vtransform.py``. Runs the port's
``DepthLSSTransform`` forward at flagship shape (B 1, N 6, D 118, 32x88
features, 360x360 BEV) with a timer as its ``timed`` hook, so each piece
is timed: ``rasterize_depth``, the dtransform and depthnet convs, the
depth softmax and context layout, the pool through the hand-written
kernel (K4; with ``build_pool_lut`` when the batch has no LUT) and the
downsample. Then, alone: ``get_geometry`` (the in-graph route's
geometry), ``build_pool_lut`` on the card (per frame on the in-graph
route) and on the host (once per rig on the LUT route).

Run: ``python -m bevfusion_tpu_torch.tools.profile_vtransform`` (on the card).
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..devices import resolve_device
from ..models.vtransforms import build_pool_lut, get_geometry
from ..utils.profiler import op_timer, time_fn
from .profile_meta import print_rows


def profile_vtransform(vt, feats, batch, device="cuda", iters: int = 10, warmup: int = 2):
    """(rows {"op", "ms"}: one a piece of ``vt``'s forward on feats [B, N,
    Cin, fH, fW] and ``batch``, then the geometry and the pooling LUT on
    the batch's device and on the host; the module's output)."""
    dev = resolve_device(device)
    rows = []
    timed = op_timer(rows, dev, iters, warmup)
    out = vt(feats, batch["points"], batch["points_mask"], batch, timed=timed)
    timed("get_geometry (in-graph route)", lambda: get_geometry(
        vt.frustum, batch["camera2lidar"], batch["camera_intrinsics"][..., :3, :3],
        batch["img_aug_matrix"], batch["lidar_aug_matrix"]))
    timed("build_pool_lut on the batch's device (in-graph route)",
          lambda: build_pool_lut(vt.frustum, vt.dx, vt.bx, vt.nx, batch))
    mats = {k: v.cpu() for k, v in batch.items() if k != "pool_lut" and torch.is_tensor(v)}
    frustum = vt.frustum.cpu()
    rows.append({"op": "build_pool_lut on the host (LUT route, once per rig)",
                 "ms": time_fn(lambda: build_pool_lut(frustum, vt.dx, vt.bx, vt.nx, mats),
                               iters=max(1, iters // 5), warmup=1, device="cpu")["median_ms"]})
    return rows, out


def main(argv=None) -> int:
    from ..runtime.flagship import build_flagship

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _, model, batch = build_flagship(dev)
    cam = model.encoders["camera"]
    img = batch["img"]
    with torch.no_grad():
        feats = cam["neck"](cam["backbone"](img.reshape(-1, *img.shape[2:])))[0]
        feats = feats.view(*img.shape[:2], *feats.shape[1:])
        rows, _ = profile_vtransform(cam["vtransform"], feats, batch, dev, args.iters)
    print_rows(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
