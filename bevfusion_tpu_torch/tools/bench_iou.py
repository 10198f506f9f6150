"""Rotated 3D IoU benchmark: ``ops/iou3d.py:iou_3d`` at the TransFusion
matcher's shape (one decoder layer's proposals against a frame's ground
truths, ``models/heads/transfusion.py``'s IoU cost) and at the rotated
NMS's (``max_num`` detections against each other, the pair count of
``ops/nms.py:bev_suppression``), on random boxes made from a seed.

    python -m bevfusion_tpu_torch.tools.bench_iou [--proposals 200] [--gt 64] [--nms 500]
    python -m bevfusion_tpu_torch.tools.bench_iou --compare OTHER_CHECKOUT

``--compare`` loads ``OTHER_CHECKOUT/bevfusion_tpu_torch/ops/iou3d.py`` (a
file that imports only torch) beside this checkout's, checks that the two
give the same IoUs, and times them in one process on the same inputs in
the order other, this, this, other. Each time is the median of CUDA-event
intervals between back-to-back calls (``utils/profiler.time_fn``): the
card's time or the host's, whichever is longer, as the matcher sees it.

Prints one JSON line: the card, and per shape and version its ms.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

from ..devices import resolve_device
from ..ops import iou3d
from ..utils.profiler import card_line, time_fn


def random_boxes(n: int, seed: int) -> np.ndarray:
    """[n, 7] (x, y, z_bottom, dx, dy, dz, yaw): centers in a 20 m square,
    sizes 0.5-5 m, any yaw, so that many pairs overlap."""
    r = np.random.RandomState(seed)
    return np.concatenate([r.uniform(-10, 10, (n, 2)), r.uniform(-2, 0, (n, 1)),
                           r.uniform(0.5, 5, (n, 3)), r.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


def load_other(checkout: str):
    """The ``ops/iou3d.py`` module of another checkout, loaded on its own."""
    path = os.path.join(checkout, "bevfusion_tpu_torch", "ops", "iou3d.py")
    spec = importlib.util.spec_from_file_location("other_iou3d", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench(shapes, device="cuda", iters: int = 20, warmup: int = 3, other=None):
    """Per (label, N, M) of ``shapes``: ``iou_3d`` of N against M random
    boxes, its ms (and with ``other``, that module's ms in the order other,
    this, this, other, each version's the mean of its two, and the largest
    difference of the IoUs)."""
    dev = resolve_device(device)
    rows = []
    for i, (label, n, m) in enumerate(shapes):
        a = torch.from_numpy(random_boxes(n, 2 * i)).to(dev)
        b = torch.from_numpy(random_boxes(m, 2 * i + 1)).to(dev)

        def ms(mod):
            return time_fn(mod.iou_3d, a, b, iters=iters, warmup=warmup, device=dev)["median_ms"]

        row = {"shape": f"{label} [{n}] x [{m}]"}
        if other is None:
            row["ms"] = ms(iou3d)
        else:
            o1, t1, t2, o2 = ms(other), ms(iou3d), ms(iou3d), ms(other)
            row.update(ms=(t1 + t2) / 2, other_ms=(o1 + o2) / 2, runs_ms=[o1, t1, t2, o2],
                       max_abs_diff=(iou3d.iou_3d(a, b) - other.iou_3d(a, b)).abs().max().item())
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--proposals", type=int, default=200, help="the flagship's num_proposals")
    ap.add_argument("--gt", type=int, default=64, help="ground truths a frame (synthetic batch)")
    ap.add_argument("--nms", type=int, default=500, help="the CenterHead decode's max_num")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--compare", default=None, help="another checkout's root")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    other = load_other(args.compare) if args.compare else None
    rows = bench([("matcher", args.proposals, args.gt), ("nms", args.nms, args.nms)], dev,
                 args.iters, other=other)
    if other is not None and max(r["max_abs_diff"] for r in rows) > 1e-5:
        raise RuntimeError(f"bench_iou: the two versions' IoUs differ: {rows}")
    print(json.dumps({"metric": "iou_3d_ms", "card": card_line() if dev.type == "cuda" else None,
                      "other": args.compare, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
