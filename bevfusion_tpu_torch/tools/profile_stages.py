"""Per-stage latency profile of a config (eval, batch 1; the fused flagship
by default).

Counterpart of ``tools/profile_stages.py``: the forward split into the
JAX tool's stages (camera backbone, neck and vtransform; LiDAR voxelize
and sparse encoder, or pillar encoder; radar voxelize and encoder; fuser;
decoder backbone and neck; the object head's forward and decode, the map
head), each of the config's stages timed alone at its real inputs (median
of CUDA-event times on the card). Any of the eleven configs
``benchmark.py`` builds: the fused flagship, TransFusion-L at 0.1 and 0.075
m, the three map-segmentation configs, the three camera-only CenterHead
detectors (whose ``head/decode`` holds the per-task NMS), PointPillars and
camera + radar CenterHead.
Stages run eagerly either way, so their sum is close to the frame time;
use it to rank stages, ``benchmark.py`` for the frame.

``--flops`` adds each stage's GFLOP (``utils/profiler.flops_of``: the ATen
ops plus the port's kernels), TFLOP/s and its share of the peak of the
precision it runs in: TF32 (495 TFLOP/s) where cuDNN's TF32 switch is on,
else fp32 (67 TFLOP/s). ``--tf32 on|off`` sets both of PyTorch's TF32
switches; by default they stay as PyTorch sets them (cuDNN convolutions
in TF32, matmuls in fp32). JSON goes only to a path given as ``--out``.

Run: ``python -m bevfusion_tpu_torch.tools.profile_stages [config] [--flops]`` (on the card).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..devices import resolve_device
from ..utils.profiler import FP32_FLOPS, TF32_FLOPS, op_timer


def peak_flops():
    """(peak FLOP/s, its name) of the precision the convolutions run in."""
    if torch.backends.cudnn.allow_tf32:
        return TF32_FLOPS, "TF32 tensor cores, 495 TFLOP/s"
    return FP32_FLOPS, "fp32 without tensor cores, 67 TFLOP/s"


def profile_stages(model, batch, device="cuda", iters: int = 20, warmup: int = 3,
                   flops: bool = False):
    """(rows {"stage", "ms"[, "gflop", "tflops", "peak_share"]}, the model's
    output: ``boxes`` and / or ``masks_bev``)."""
    dev = resolve_device(device)
    rows = []
    with torch.no_grad():
        out = model(batch, timed=op_timer(rows, dev, iters, warmup, flops))
    peak, _ = peak_flops()
    for r in rows:
        r["stage"] = r.pop("op")
        if flops:
            r["gflop"] = r.pop("flops") / 1e9
            r["tflops"] = r["gflop"] / r["ms"]
            r["peak_share"] = r["tflops"] * 1e12 / peak
    return rows, out


def print_table(rows, flops: bool) -> None:
    total = sum(r["ms"] for r in rows)
    if not flops:
        print("| stage | ms |\n|---|---|")
        for r in rows:
            print(f"| {r['stage']} | {r['ms']:.2f} |")
        print(f"| **sum** | **{total:.2f}** |")
        return
    print("| stage | ms | GFLOP | TFLOP/s | share of peak |\n|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['stage']} | {r['ms']:.2f} | {r['gflop']:.2f} | {r['tflops']:.3f} "
              f"| {100 * r['peak_share']:.2f}% |")
    gflop = sum(r["gflop"] for r in rows)
    print(f"| **sum** | **{total:.2f}** | **{gflop:.2f}** | **{gflop / total:.3f}** | "
          f"**{100 * gflop / total * 1e12 / peak_flops()[0]:.2f}%** |")


def main(argv=None) -> int:
    from .benchmark import build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--points", type=int, default=120000)
    ap.add_argument("--flops", action="store_true")
    ap.add_argument("--tf32", choices=["on", "off"], default=None,
                    help="both TF32 switches on or off (default: as PyTorch sets them)")
    ap.add_argument("--out", default=None, help="write the rows as JSON to this path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.tf32 is not None:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = args.tf32 == "on"
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {card}; cuDNN TF32 {torch.backends.cudnn.allow_tf32}, matmul TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}; peak: {peak_flops()[1]}")
    _, model, batch = build(args.config, dev, args.points)
    rows, _ = profile_stages(model, batch, dev, args.iters, flops=args.flops)
    print_table(rows, args.flops)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"device": card, "cudnn_tf32": torch.backends.cudnn.allow_tf32,
                       "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
                       "peak": peak_flops()[1], "stages": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
