"""Dry run of the data-parallel train step on the CPU: the tiny fused
detector, N gloo processes, one step.

Counterpart of ``__graft_entry__.dryrun_multichip`` (the JAX package jits
its train step over an N-device virtual CPU mesh and runs one step of the
tiny fused model of ``tests/test_bevfusion_model.py``): here N processes
join a gloo group on ``tcp://localhost``, each steps on its sample of a
global batch of N (``parallel.shard_batch``) through
``runtime/train.py:make_train_step``, and the step must be finite with the
ranks' weights bit-equal after it::

    python -m bevfusion_tpu_torch.parallel.dryrun [--ranks N]

``TINY_FUSED`` is the port's copy of that tiny model's config (all the real
blocks at toy sizes: Swin, DepthLSS, the sparse encoder, ConvFuser,
SECOND, TransFusion), ``tiny_batch`` its batch.
"""
from __future__ import annotations

import argparse
import socket
from typing import Dict

import numpy as np
import torch

PCR = [-16.0, -16.0, -4.0, 16.0, 16.0, 4.0]
TINY_FUSED = {
    "type": "BEVFusion",
    "encoders": {
        "camera": {
            "backbone": {"type": "SwinTransformer", "embed_dims": 16, "depths": [1, 1, 1],
                         "num_heads": [1, 2, 4], "window_size": 4, "out_indices": [1, 2],
                         "drop_path_rate": 0.0},
            "neck": {"type": "GeneralizedLSSFPN", "in_channels": [32, 64], "out_channels": 24,
                     "num_outs": 2, "upsample_cfg": {"mode": "bilinear", "align_corners": False}},
            "vtransform": {"type": "DepthLSSTransform", "in_channels": 24, "out_channels": 16,
                           "image_size": [32, 64], "feature_size": [4, 8],
                           "xbound": [-16.0, 16.0, 1.0], "ybound": [-16.0, 16.0, 1.0],
                           "zbound": [-10.0, 10.0, 20.0], "dbound": [1.0, 9.0, 1.0],
                           "downsample": 2}},
        "lidar": {
            "voxelize": {"max_num_points": 4, "point_cloud_range": PCR,
                         "voxel_size": [0.25, 0.25, 0.5], "max_voxels": [256, 256]},
            "backbone": {"type": "SparseEncoder", "in_channels": 5,
                         "sparse_shape": [128, 128, 33], "base_channels": 4,
                         "output_channels": 16,
                         "encoder_channels": [[4, 4, 8], [8, 8, 16], [16, 16, 16], [16, 16]],
                         "encoder_paddings": [[0, 0, 1], [0, 0, 1], [0, 0, [1, 1, 0]], [0, 0]],
                         "block_type": "basicblock"}}},
    "fuser": {"type": "ConvFuser", "in_channels": [16, 16], "out_channels": 24},
    "decoder": {
        "backbone": {"type": "SECOND", "in_channels": 24, "out_channels": [16, 32],
                     "layer_nums": [1, 1], "layer_strides": [1, 2]},
        "neck": {"type": "SECONDFPN", "in_channels": [16, 32], "out_channels": [24, 24],
                 "upsample_strides": [1, 2], "use_conv_for_no_stride": True}},
    "heads": {"object": {
        "type": "TransFusionHead", "num_proposals": 8, "auxiliary": True, "in_channels": 48,
        "hidden_channel": 16, "num_classes": 10, "num_decoder_layers": 1, "num_heads": 4,
        "nms_kernel_size": 3, "ffn_channel": 32, "dropout": 0.0,
        "common_heads": {"center": [2, 2], "height": [1, 2], "dim": [3, 2], "rot": [2, 2],
                         "vel": [2, 2]},
        "bbox_coder": {"type": "TransFusionBBoxCoder", "pc_range": [-16.0, -16.0],
                       "post_center_range": [-20.0, -20.0, -10.0, 20.0, 20.0, 10.0],
                       "score_threshold": 0.0, "out_size_factor": 8,
                       "voxel_size": [0.25, 0.25], "code_size": 10},
        "train_cfg": {
            "dataset": "nuScenes", "point_cloud_range": PCR, "grid_size": [128, 128, 1],
            "voxel_size": [0.25, 0.25, 0.5], "out_size_factor": 8, "gaussian_overlap": 0.1,
            "min_radius": 2, "pos_weight": -1, "code_weights": [1.0] * 8 + [0.2, 0.2],
            "assigner": {"type": "HungarianAssigner3D",
                         "cls_cost": {"type": "FocalLossCost", "gamma": 2.0, "alpha": 0.25,
                                      "weight": 0.15},
                         "reg_cost": {"type": "BBoxBEVL1Cost", "weight": 0.25},
                         "iou_cost": {"type": "IoU3DCost", "weight": 0.25}}},
        "test_cfg": {"dataset": "nuScenes", "grid_size": [128, 128, 1], "out_size_factor": 8,
                     "voxel_size": [0.25, 0.25], "pc_range": [-16.0, -16.0],
                     "nms_type": None}}},
}


def tiny_batch(B: int = 1, N: int = 2, P: int = 512, G: int = 4,
               seed: int = 0) -> Dict[str, torch.Tensor]:
    """The tiny model's batch (the JAX test's ``make_batch``, images
    [B, N, 3, 32, 64]): uniform points and boxes in the range, identity
    extrinsics, a 30-pixel focal length."""
    rng = np.random.RandomState(seed)
    eye = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    intr = eye.copy()
    intr[:, :, 0, 0] = intr[:, :, 1, 1] = 30.0
    intr[:, :, 0, 2], intr[:, :, 1, 2] = 32.0, 16.0
    one = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    batch = {
        "img": rng.rand(B, N, 32, 64, 3).astype(np.float32).transpose(0, 1, 4, 2, 3),
        "points": rng.uniform(-15, 15, (B, P, 5)).astype(np.float32),
        "points_mask": np.ones((B, P), bool), "camera2ego": eye, "lidar2ego": one,
        "lidar2camera": eye, "lidar2image": intr, "camera_intrinsics": intr,
        "camera2lidar": eye, "img_aug_matrix": eye, "lidar_aug_matrix": one.copy(),
        "gt_boxes": np.concatenate([rng.uniform(-12, 12, (B, G, 2)), rng.uniform(-2, 0, (B, G, 1)),
                                    rng.uniform(1, 3, (B, G, 3)), rng.uniform(-1, 1, (B, G, 3))],
                                   -1).astype(np.float32),
        "gt_labels": rng.randint(0, 10, (B, G)).astype(np.int32),
        "gt_valid": np.ones((B, G), bool)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def run_rank(rank: int, world: int, port: int) -> float:
    """Rank ``rank`` of ``world``: join the gloo group, one train step of the
    tiny model (seeded weights, broadcast from rank 0) on its sample;
    returns the global batch's total loss (raises if it is not finite or
    the ranks' weights differ after the step)."""
    from .. import parallel
    from ..models import build_model
    from ..runtime.flagship import init_weights
    from ..runtime.train import build_lr_schedule, build_optimizer, make_train_step

    torch.set_num_threads(1)
    parallel.init("cpu", "gloo", f"tcp://localhost:{port}", rank, world, timeout_s=300)
    try:
        model = init_weights(build_model(TINY_FUSED, "cpu"), seed=0)
        parallel.replicate_state(dict(model.state_dict()))
        opt = build_optimizer({"lr": 1e-4, "weight_decay": 0.01},
                              build_lr_schedule({"policy": "cyclic"}, 1e-4, 100), model,
                              grad_clip={"max_norm": 35})
        step = make_train_step(model, opt, "cpu", seed=0)
        total = float(step(parallel.shard_batch(tiny_batch(B=world), rank, world))["loss/total"])
        if not np.isfinite(total):
            raise RuntimeError(f"dryrun rank {rank}: loss/total {total}")
        parallel.assert_replicated(dict(model.state_dict()), "the weights after the step")
    finally:
        torch.distributed.destroy_process_group()
    return total


def _spawned(rank: int, world: int, port: int, out) -> None:
    out.put((rank, run_rank(rank, world, port)))


def dryrun_multichip(n_ranks: int = 2) -> float:
    """One data-parallel step of the tiny model in ``n_ranks`` gloo CPU
    processes; returns its total loss (every rank's)."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    mp.start_processes(_spawned, args=(n_ranks, port, out), nprocs=n_ranks, join=True,
                       start_method="spawn")
    losses = dict(out.get() for _ in range(n_ranks))
    if len(set(losses.values())) != 1:
        raise RuntimeError(f"dryrun_multichip: the ranks logged different losses {losses}")
    print(f"dryrun_multichip({n_ranks}): ok, loss/total={losses[0]:.4f}")
    return losses[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    dryrun_multichip(ap.parse_args().ranks)
