"""Render ground truth or predictions as PNGs: the BEV lidar view with boxes,
each camera with the boxes projected, the map masks.

Counterpart of the JAX package's ``tools/visualize.py`` (reference
tools/visualize.py)::

    python -m bevfusion_tpu_torch.tools.visualize CONFIG [--checkpoint CKPT] \\
        [--mode gt|pred] [--split train|val|test] [--out-dir viz] [--max-samples 20] \\
        [--bbox-score 0.25] [--device cuda]

Each sample of the config's ``data[split]`` dataset (``data/``) is drawn
by ``utils/visualize.py`` into ``<out-dir>/sampleNNNNN/``: ``lidar.png``,
``cam<c>.png`` a camera and, in ``gt`` mode where the sample has them,
``map.png``. ``gt`` draws the sample's valid ground-truth boxes; ``pred``
runs the config's model (fp32, the weights of ``--checkpoint`` through
``runtime/checkpoint.py:restore_checkpoint``) on ``--device`` on each
sample, as a batch of one through ``runtime/eval.py:to_model_batch``, and
draws its kept boxes scored at least ``--bbox-score``. matplotlib draws
(imported at the first drawing, as the JAX module does); where it is
missing the tool raises there.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def predictor(cfg, checkpoint: str, device):
    """``sample -> out["boxes"]`` (numpy) of the config's model with the
    checkpoint's weights on ``device``."""
    import torch

    from ..models import build_model
    from ..runtime.checkpoint import restore_checkpoint
    from ..runtime.eval import to_model_batch

    model = build_model(cfg.model, device)
    restore_checkpoint(checkpoint, model)

    def infer(sample):
        arrays = {k: np.asarray(v)[None] for k, v in sample.items()
                  if isinstance(v, np.ndarray) and k not in ("metas", "gt_masks_bev")}
        with torch.inference_mode():
            out = model(to_model_batch(arrays, device))
        return {k: v.cpu().numpy() for k, v in out["boxes"].items()}

    return infer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--mode", default="gt", choices=["gt", "pred"])
    ap.add_argument("--split", default="val", choices=["train", "val", "test"])
    ap.add_argument("--out-dir", default="viz")
    ap.add_argument("--max-samples", type=int, default=20)
    ap.add_argument("--bbox-score", type=float, default=0.25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..data import build_dataset
    from ..devices import resolve_device
    from ..utils.visualize import visualize_camera, visualize_lidar, visualize_map

    cfg = load_config(args.config)
    dataset = build_dataset(cfg.data[args.split])
    infer = None
    if args.mode == "pred":
        if not args.checkpoint:
            raise ValueError("--mode pred needs --checkpoint")
        infer = predictor(cfg, args.checkpoint, resolve_device(args.device))

    classes = list(cfg.object_classes)
    for idx in range(min(args.max_samples, len(dataset))):
        sample = dataset[idx]
        name = f"sample{idx:05d}"
        if args.mode == "gt":
            boxes = sample.get("gt_boxes")
            labels = sample.get("gt_labels")
            if boxes is not None and "gt_valid" in sample:
                m = sample["gt_valid"]
                boxes, labels = boxes[m], labels[m]
        else:
            b = infer(sample)
            m = b["mask"][0] & (b["scores"][0] >= args.bbox_score)
            boxes, labels = b["bboxes"][0][m], b["labels"][0][m]

        pts = sample["points"][sample["points_mask"]] if "points_mask" in sample else sample["points"]
        visualize_lidar(
            os.path.join(args.out_dir, f"{name}/lidar.png"), pts,
            boxes, labels, classes,
            xlim=(cfg.point_cloud_range[0], cfg.point_cloud_range[3]),
            ylim=(cfg.point_cloud_range[1], cfg.point_cloud_range[4]),
        )
        if "img" in sample:
            for c in range(sample["img"].shape[0]):
                im = sample["img"][c]
                im = (im - im.min()) / max(im.max() - im.min(), 1e-6) * 255
                visualize_camera(
                    os.path.join(args.out_dir, f"{name}/cam{c}.png"), im,
                    boxes, labels, sample["lidar2image"][c], classes,
                )
        if "gt_masks_bev" in sample and args.mode == "gt":
            visualize_map(os.path.join(args.out_dir, f"{name}/map.png"),
                          np.asarray(sample["gt_masks_bev"]),
                          list(cfg.map_classes))
        print("rendered", name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
