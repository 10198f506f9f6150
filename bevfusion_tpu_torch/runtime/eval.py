"""Evaluation loop: run a model over a val/test loader and hand the
per-sample results to the dataset's evaluate methods.

Counterpart of ``bevfusion_tpu/runtime/eval.py`` (reference:
mmdet3d/apis/train.py:99-120, tools/test.py + apis/test.py: single_gpu_test
collects per-sample dicts of boxes_3d / scores_3d / labels_3d or masks_bev
for dataset.evaluate). ``shard_indices`` and ``collect_results_cpu`` are
copies. The model boundary is ``to_model_batch``, the only layout change
on the path: the loader's images are [B, N, H, W, 3], the port's forward
takes [B, N, 3, H, W]; the port's ``masks_bev`` is already [B, classes, X,
Y], so no transpose follows the forward. No pooling LUT rides in the
batch, since the calibration changes from sample to sample: the camera
branch builds its intervals in the graph, on the device.

The JAX package's loop sums the sparse encoders' ``window_overflow`` counters
(``_find_overflow``) and fails a batch that dropped a neighbor; the port's
rulebooks drop none (ROADMAP Queue 3), so it has no such guard.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

__all__ = ["shard_indices", "collect_results_cpu", "to_model_batch", "run_model_on_loader",
           "evaluate_dataset"]


def shard_indices(n: int, rank: int, world: int) -> range:
    """Round-robin dataset shard for one eval process — the reference's
    DistributedSampler(shuffle=False) split driven by multi_gpu_test
    (tools/test.py:198-203): rank r evaluates samples r, r+world, ..."""
    return range(rank, n, world)


def collect_results_cpu(result_part: List[Any], size: int, tmpdir: str,
                        rank: int, world: int,
                        timeout: float = 600.0) -> Optional[List[Any]]:
    """Gather per-rank result lists through a shared directory.

    Mirrors mmdet's collect_results_cpu (used by multi_gpu_test,
    tools/test.py:203): every rank pickles its part, rank 0 waits for
    all parts, interleaves them back into dataset order (parts come
    from the round-robin shard_indices split) and truncates to `size`.
    Non-zero ranks return None. Writes are atomic (tmp + rename) so a
    partially-written part is never loaded. rank and world are the
    process group's (``tools/test.py``); tmpdir sits on storage that
    every rank sees.
    """
    os.makedirs(tmpdir, exist_ok=True)
    final = os.path.join(tmpdir, f"part_{rank}.pkl")
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(result_part, f)
    os.replace(tmp, final)
    if rank != 0:
        return None
    parts: List[List[Any]] = []
    deadline = time.time() + timeout
    for r in range(world):
        path = os.path.join(tmpdir, f"part_{r}.pkl")
        while not os.path.exists(path):
            if time.time() > deadline:
                raise TimeoutError(f"eval rank {r} never produced {path}")
            time.sleep(0.05)
        with open(path, "rb") as f:
            parts.append(pickle.load(f))
    ordered: List[Any] = []
    for i in range(max((len(p) for p in parts), default=0)):
        for p in parts:
            if i < len(p):
                ordered.append(p[i])
    return ordered[:size]


def to_model_batch(np_batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch (``data/loader.py:collate``, without ``metas``
    and ``gt_masks_bev``) as the port's forward takes it: every array a
    tensor on ``device``, ``img`` [B, N, H, W, 3] -> [B, N, 3, H, W]
    (``runtime/flagship.py:synthetic_batch``'s layout)."""
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in np_batch.items()}
    if "img" in batch:
        batch["img"] = batch["img"].permute(0, 1, 4, 2, 3).contiguous()
    return {k: v.to(device) for k, v in batch.items()}


def run_model_on_loader(model: nn.Module, loader) -> List[Dict[str, Any]]:
    """Run ``model``'s eval forward on every batch of ``loader``, on the
    model's device, and split the fixed-shape masked outputs into the
    reference's per-sample result dicts (numpy): ``boxes_3d`` [n, 9],
    ``scores_3d`` [n] and ``labels_3d`` [n] of the kept boxes; ``masks_bev``
    [classes, X, Y] and, where the loader gave it, ``gt_masks_bev``."""
    device = next(model.parameters()).device
    results: List[Dict[str, Any]] = []
    for np_batch in loader:
        gt_masks = np_batch.pop("gt_masks_bev", None)
        np_batch.pop("metas", None)
        with torch.inference_mode():
            out = model(to_model_batch(np_batch, device))
        boxes = {k: v.cpu().numpy() for k, v in out["boxes"].items()} if "boxes" in out else None
        masks = out["masks_bev"].cpu().numpy() if "masks_bev" in out else None
        for b in range(next(iter(np_batch.values())).shape[0]):
            res: Dict[str, Any] = {}
            if boxes is not None:
                m = boxes["mask"][b]
                res["boxes_3d"] = boxes["bboxes"][b][m]
                res["scores_3d"] = boxes["scores"][b][m]
                res["labels_3d"] = boxes["labels"][b][m]
            if masks is not None:
                res["masks_bev"] = masks[b]
                if gt_masks is not None:
                    res["gt_masks_bev"] = gt_masks[b]
            results.append(res)
    return results


def evaluate_dataset(model: nn.Module, dataset, loader, metric: str = "bbox",
                     out_dir: Optional[str] = None, rank: int = 0, world: int = 1,
                     tmpdir: Optional[str] = None) -> Optional[Dict[str, float]]:
    """One eval pass: ``model`` in eval mode under ``torch.inference_mode``
    on its device (``build_model`` puts it on the card unless the caller
    asks for the CPU), then the dataset's metric: ``map``
    (``evaluate_map``) or ``bbox`` (``evaluate_detection``: the submission
    JSON, then the nuScenes devkit, whose ImportError is not caught).

    Multi-process: pass the process group's rank and world and a shared
    tmpdir; each process runs its loader's shard (built over
    ``shard_indices``, i.e. ``DataLoader(num_shards=world, shard_id=rank)``)
    and rank 0 merges and evaluates (multi_gpu_test semantics,
    tools/test.py:198-226). Non-zero ranks return None."""
    model.eval()
    results = run_model_on_loader(model, loader)
    if world > 1:
        results = collect_results_cpu(
            results, len(dataset), tmpdir or (out_dir or "runs/eval") + "/parts", rank, world)
        if results is None:
            return None
    if metric == "map":
        return dataset.evaluate_map(results)
    return dataset.evaluate_detection(results, out_dir or "runs/eval")
