#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Five phases:

1. device: the card's name and power limit; TF32 off for fp32 parity;
2. build: compile the sparse-conv kernel from bevfusion_tpu_torch/csrc;
3. kernel vs plain: the kernel and its plain PyTorch version on the same
   CUDA tensors at the main path's shapes (a voxelized 120k-point scan at
   voxelnet_0p075: the input conv, a stage-0 residual conv, the stage-0
   strided conv, a stage-1 and a stage-2 residual conv),
   max|d| <= 1e-4 * max(|plain|, 1) on valid rows, and each one's median
   time;
4. the slice: TransFusion-L (voxelnet_0p075) at full width with seeded
   random weights, eval forward at batch 1 on the scan; the kernel must
   launch 15 times per forward, every box field must be finite, and the
   heatmap logits must match the same model run on the CPU (plain path)
   to 2e-3 relative; ms/frame and peak device memory;
5. a JSON line with the kernel table, a line with the card's name and
   power limit as nvidia-smi prints them, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when CUDA is unavailable or any
check fails. Imports neither JAX nor the JAX package.
"""
import copy
import json
import os
import statistics
import subprocess
import sys
import time

import torch

FP32_RTOL_KERNEL = 1e-4  # kernel vs plain on the card: summation order only
HEATMAP_RTOL = 2e-3  # full model on the card vs on the CPU, ~40 fp32 layers
LAUNCHES_PER_FRAME = 15  # 13 submanifold + 2 strided sparse convs at B=1


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, warmup: int = 5, iters: int = 20) -> float:
    """Median device time of ``fn`` over ``iters`` runs, after warmup."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)


def kernel_cases(cfg, batch, sp, vox):
    """The sparse convs of the main path at their real shapes: voxelize the
    scan, build the stage-0, -1 and -2 rulebooks, random fp32 operands."""
    enc = cfg.model.encoders.lidar.backbone
    out = vox(batch["points"], batch["points_mask"])
    feats, coords, mask = out.feats[0], out.coords[0], out.mask[0]
    grid = sp.SparseGrid(*enc.sparse_shape)
    ids = sp.lin_ids(coords, grid, mask)
    nbr0 = sp.build_subm_rulebook(ids, grid)
    cap1, cap2 = enc.site_caps[0], enc.site_caps[1]
    grid1 = sp.conv_out_shape(grid, 3, 2, 1)
    ids1, mask1 = sp.downsample_sites(ids, grid, 3, 2, 1, cap1)
    cnbr = sp.build_conv_rulebook(ids, ids1, grid, grid1, 3, 2, 1)
    nbr1 = sp.build_subm_rulebook(ids1, grid1)
    grid2 = sp.conv_out_shape(grid1, 3, 2, 1)
    ids2, mask2 = sp.downsample_sites(ids1, grid1, 3, 2, 1, cap2)
    nbr2 = sp.build_subm_rulebook(ids2, grid2)
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = feats.device

    def rand(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    def epi(c, residual_rows=None):
        kw = dict(scale=rand(c, std=0.1) + 1.0, shift=rand(c, std=0.1), relu=True)
        if residual_rows is not None:
            kw["residual"] = rand(residual_rows, c)
        return kw

    cap0 = feats.shape[0]
    return [
        ("conv_input 5->16", (feats, nbr0, rand(27, 5, 16, std=(2 / 135) ** 0.5)), epi(16),
         mask),
        ("stage0 subm 16->16", (rand(cap0, 16), nbr0, rand(27, 16, 16, std=(2 / 432) ** 0.5)),
         epi(16, cap0), mask),
        ("stage0 strided 16->32", (rand(cap0, 16), cnbr, rand(27, 16, 32, std=(2 / 432) ** 0.5)),
         epi(32), mask1),
        ("stage1 subm 32->32", (rand(cap1, 32), nbr1, rand(27, 32, 32, std=(2 / 864) ** 0.5)),
         epi(32, cap1), mask1),
        ("stage2 subm 64->64", (rand(cap2, 64), nbr2, rand(27, 64, 64, std=(2 / 1728) ** 0.5)),
         epi(64, cap2), mask2),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bevfusion_tpu_torch import native
    from bevfusion_tpu_torch.ops import sparse_conv as sp
    from bevfusion_tpu_torch.runtime.flagship import build_lidar_slice

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name}")
    print(f"nvidia-smi: {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off")

    # 2. build
    t0 = time.perf_counter()
    sp.build_kernels()
    build_s = time.perf_counter() - t0
    print(f"build: sparse_conv in {build_s:.2f} s")
    for line in native.build_log("sparse_conv").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain at the main path's shapes
    cpu_cfg, cpu_model, cpu_batch = build_lidar_slice("cpu", num_points=120000, seed=0)
    batch = {k: v.cuda() for k, v in cpu_batch.items()}
    shapes = []
    with torch.no_grad():
        for label, args, kw, valid in kernel_cases(cpu_cfg, batch, sp, cpu_model.lidar_voxelize):
            got = sp.sparse_conv(*args, **kw)
            want = sp.sparse_conv_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got - want)[valid].abs().max().item()
            scale = max(want[valid].abs().max().item(), 1.0)
            check(err <= FP32_RTOL_KERNEL * scale, f"{label}: max|d| {err} vs plain, scale {scale}")
            ms = cuda_ms(lambda: sp.sparse_conv(*args, **kw))
            plain_ms = cuda_ms(lambda: sp.sparse_conv_plain(*args, **kw))
            shapes.append({"shape": label, "sites_out": args[1].shape[1],
                           "valid_out": int(valid.sum()), "max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms})
            print(f"kernel {label}: {int(valid.sum())} of {args[1].shape[1]} output sites, "
                  f"max|d| {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # 4. the slice, eval forward at B=1
    model = copy.deepcopy(cpu_model).cuda()
    with torch.no_grad():
        torch.cuda.synchronize()
        sp.sparse_conv.launches = 0
        out = model(batch)["boxes"]
        torch.cuda.synchronize()
        launches = sp.sparse_conv.launches
        print(f"slice: sparse_conv launched {launches} times in one forward")
        check(launches == LAUNCHES_PER_FRAME, f"{launches} launches, want {LAUNCHES_PER_FRAME}")
        P = cpu_cfg.model.heads.object.num_proposals
        check(tuple(out["bboxes"].shape) == (1, P, 9), f"bboxes shape {tuple(out['bboxes'].shape)}")
        for key, v in out.items():
            check(bool(torch.isfinite(v.float()).all()), f"non-finite {key}")
        print(f"slice: {int(out['mask'].sum())} of {P} boxes kept, "
              f"top score {out['scores'].max().item():.4f}")

        heat = model.predict(batch)["dense_heatmap"]
        t0 = time.perf_counter()
        heat_cpu = cpu_model.predict(cpu_batch)["dense_heatmap"]
        cpu_s = time.perf_counter() - t0
        heat_err = rel_err(heat.cpu(), heat_cpu)
        print(f"slice: heatmap {tuple(heat.shape)} vs CPU plain path: rel err {heat_err:.3e} "
              f"(CPU forward {cpu_s:.1f} s)")
        check(heat_err <= HEATMAP_RTOL, f"heatmap rel err {heat_err} > {HEATMAP_RTOL}")

        for _ in range(5):
            model(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        frames = []
        for _ in range(20):
            t0 = time.perf_counter()
            model(batch)
            torch.cuda.synchronize()
            frames.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
    print(f"slice: {statistics.median(frames):.2f} ms/frame median, "
          f"{statistics.mean(frames):.2f} mean, {min(frames):.2f} min over 20 frames; "
          f"peak device memory {peak / 2**20:.1f} MiB")

    # 5. results
    entry = {
        "name": "sparse_conv", "route": "cuda",
        "source": "bevfusion_tpu_torch/csrc/sparse_conv.cu",
        "replaces": "bevfusion_tpu/ops/sparse_conv_windowed.py:285",
        "also_replaces": ["bevfusion_tpu/ops/sparse_conv_windowed.py:180"],
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": sum(s["ms"] for s in shapes),
        "plain_ms": sum(s["plain_ms"] for s in shapes),
        "shapes": shapes,
        "build_s": build_s,
    }
    print(json.dumps({"kernels": [entry], "frame_ms_median": statistics.median(frames),
                      "peak_mem_bytes": peak, "heatmap_rel_err": heat_err}))
    print(smi)  # the card's name and power limit, as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
