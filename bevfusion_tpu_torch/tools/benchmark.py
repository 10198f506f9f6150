"""Latency / FPS benchmark of a config (eval, batch 1).

Counterpart of ``tools/benchmark.py`` (reference tools/benchmark.py:
batch-1 wall clock, warmup 5, device-synchronised timing): host clock
around each frame, each ending in a synchronise. Any config whose modules
the port has (``_unported_types`` empty) builds through
``runtime/flagship.py:build_flagship``, at full width with seeded random
weights on a synthetic batch with the host pooling LUT (and the radar
scan where there is a radar branch): eleven configs, the fused flagship
(configs/nuscenes/det/transfusion/secfpn/camera+lidar/swint_v0p075/convfuser.yaml,
the default), TransFusion-L at 0.1 m and 0.075 m
(configs/nuscenes/det/transfusion/secfpn/lidar/voxelnet{,_0p075}.yaml), the
three BEV map-segmentation configs (configs/nuscenes/seg/{fusion-bev256d2-lss,
lidar-centerpoint-bev128,camera-bev256d2}.yaml), the three camera-only
CenterHead detectors (configs/nuscenes/det/centerhead/lssfpn/camera/256x704/
{swint/default,resnet/default,resnet/bevdepth}.yaml), PointPillars
(configs/nuscenes/det/transfusion/secfpn/lidar/pointpillars.yaml) and camera +
radar CenterHead (configs/nuscenes/det/centerhead/lssfpn/camera+radar/resnet50/
default.yaml). Any other config, or a batch size other than 1, raises.

Run: ``python -m bevfusion_tpu_torch.tools.benchmark [config] [--iters 20]`` (on the card).
"""
from __future__ import annotations

import argparse
import statistics
import sys

import torch

from ..devices import resolve_device
from ..utils.profiler import frame_ms


def _unported_types(model_cfg):
    """The module types of a config's model tree that the port does not
    register (``registry.py``), as "slot: type"."""
    from .. import models  # noqa: F401  (registers every ported module)
    from ..registry import BACKBONES, FUSERS, FUSIONMODELS, HEADS, NECKS, VTRANSFORMS

    slots = [("model", model_cfg, FUSIONMODELS), ("fuser", model_cfg.get("fuser"), FUSERS)]
    for name, enc in (model_cfg.get("encoders") or {}).items():
        enc = enc or {}
        slots += [(f"encoders.{name}.backbone", enc.get("backbone"), BACKBONES),
                  (f"encoders.{name}.neck", enc.get("neck"), NECKS),
                  (f"encoders.{name}.vtransform", enc.get("vtransform"), VTRANSFORMS)]
    dec = model_cfg.get("decoder") or {}
    slots += [("decoder.backbone", dec.get("backbone"), BACKBONES),
              ("decoder.neck", dec.get("neck"), NECKS)]
    slots += [(f"heads.{k}", v, HEADS) for k, v in (model_cfg.get("heads") or {}).items()]
    return [f"{slot}: {cfg['type']}" for slot, cfg, reg in slots
            if cfg and "type" in cfg and cfg["type"] not in reg._registry]


def build(config=None, device="cuda", num_points: int = 120000, batch_size: int = 1):
    """(cfg, model, batch) of a config the port builds (the flagship when
    ``config`` is None); raises NotImplementedError for a batch size other
    than 1 or a config with modules the port lacks, naming them."""
    from ..config import load_config
    from ..runtime.flagship import build_flagship

    if batch_size != 1:
        raise NotImplementedError(f"batch size {batch_size}: the port's build functions are B = 1 "
                                  "(ROADMAP Queue 1, tools)")
    if config is not None:
        missing = _unported_types(load_config(config).model)
        if missing:
            raise NotImplementedError(f"{config}: not ported: {', '.join(missing)}")
    return build_flagship(device, num_points=num_points, config_path=config)


def latency(model, batch, device="cuda", iters: int = 20, warmup: int = 5):
    """Eval forward ``model(batch)``: ``warmup`` frames, then ``iters``
    frames on the host clock, each ending in a synchronise. Returns
    ``mean_ms``, ``median_ms``, ``fps`` (at the mean) and the frames."""
    with torch.no_grad():
        frames, _ = frame_ms(lambda: model(batch), warmup, iters, resolve_device(device))
    mean = statistics.mean(frames)
    return {"mean_ms": mean, "median_ms": statistics.median(frames), "fps": 1e3 / mean,
            "frames_ms": frames}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--points", type=int, default=120000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _, model, batch = build(args.config, dev, args.points, args.batch_size)
    r = latency(model, batch, dev, args.iters, args.warmup)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"latency: {r['mean_ms']:.2f} ms (median {r['median_ms']:.2f})  fps: {r['fps']:.2f}  "
          f"[{card}, cuDNN TF32 {torch.backends.cudnn.allow_tf32}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
