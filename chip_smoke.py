#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases:

1. device: the card's name and power limit; TF32 off for fp32 parity;
2. build: compile both kernels from bevfusion_tpu_torch/csrc (one nvcc
   per source, started together);
3. sparse-conv kernel vs plain: the kernel and its plain PyTorch version
   on the same CUDA tensors at the LiDAR branch's shapes (a voxelized
   120k-point scan at voxelnet_0p075: the input conv, a stage-0 residual
   conv, the stage-0 strided conv, a stage-1 and a stage-2 residual conv),
   max|d| <= 1e-4 * max(|plain|, 1) on valid rows, and each one's median
   time;
4. the LiDAR slice: TransFusion-L (voxelnet_0p075) at full width with
   seeded random weights, eval forward at batch 1 on the scan; the kernel
   must launch 15 times per forward, every box field must be finite, and
   the heatmap logits must match the same model run on the CPU (plain
   path) to 2e-3 relative; ms/frame and peak device memory;
5. BEV-pool kernel vs plain at the flagship's shape: depth [1, 6, 118, 32,
   88] (softmax of seeded noise), ctx [1, 6, 80, 32, 88] (held
   channels-last), the intervals of the flagship batch's own pooling LUT
   (the synthetic six-camera rig); max|d| <= 1e-4 * max(|plain|, 1), both
   median times, the point count P and interval count R; the time of
   building the LUT on the host and on the card;
6. the fused flagship (swint_v0p075/convfuser.yaml) at full width with
   seeded random weights and the host pooling LUT, eval forward at batch
   1: 15 sparse-conv and 1 BEV-pool launches per forward, every box field
   finite, heatmap logits within 2e-3 relative of the same model on the
   CPU (plain path, same LUT); ms/frame, peak device memory and the time
   of each stage; the frame and its stages again with TF32 on;
7. a JSON line with the kernel table, a line with the card's name and
   power limit as nvidia-smi prints them, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when CUDA is unavailable or any
check fails. Imports neither JAX nor the JAX package.
"""
import copy
import json
from concurrent.futures import ThreadPoolExecutor
import os
import statistics
import subprocess
import sys
import time

import torch

FP32_RTOL_KERNEL = 1e-4  # kernel vs plain on the card: summation order only
HEATMAP_RTOL = 2e-3  # full model on the card vs on the CPU, ~40 fp32 layers
SPARSE_LAUNCHES = 15  # 13 submanifold + 2 strided sparse convs at B=1
POOL_LAUNCHES = 1  # one BEV pool per frame at B=1


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


def frame_ms(fn, warmup: int = 5, iters: int = 20):
    """Host-clock ms of each of ``iters`` synchronised calls after warmup,
    and the peak device memory over them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frames = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        frames.append((time.perf_counter() - t0) * 1e3)
    return frames, torch.cuda.max_memory_allocated()


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


def run_model(label, model, batch, cpu_model, cpu_batch, counters, want_launches):
    """One eval forward with every launch counter set to 0 just before and
    read just after; then the box checks, the heatmap against the CPU model
    and the frame time. Returns (launches, heatmap rel err, frames, peak)."""
    with torch.no_grad():
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        out = model(batch)["boxes"]
        torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
        print(f"{label}: launches in one forward {launches}")
        check(launches == want_launches, f"{label}: launches {launches}, want {want_launches}")
        P = model.heads["object"].num_proposals
        check(tuple(out["bboxes"].shape) == (1, P, 9), f"bboxes shape {tuple(out['bboxes'].shape)}")
        for key, v in out.items():
            check(bool(torch.isfinite(v.float()).all()), f"{label}: non-finite {key}")
        print(f"{label}: {int(out['mask'].sum())} of {P} boxes kept, "
              f"top score {out['scores'].max().item():.4f}")

        heat = model.predict(batch)["dense_heatmap"]
        t0 = time.perf_counter()
        heat_cpu = cpu_model.predict(cpu_batch)["dense_heatmap"]
        cpu_s = time.perf_counter() - t0
        heat_err = rel_err(heat.cpu(), heat_cpu)
        print(f"{label}: heatmap {tuple(heat.shape)} vs CPU plain path: rel err {heat_err:.3e} "
              f"(CPU forward {cpu_s:.1f} s)")
        check(heat_err <= HEATMAP_RTOL, f"{label}: heatmap rel err {heat_err} > {HEATMAP_RTOL}")
        frames, peak = frame_ms(lambda: model(batch))
    print(f"{label}: {statistics.median(frames):.2f} ms/frame median, "
          f"{statistics.mean(frames):.2f} mean, {min(frames):.2f} min over 20 frames; "
          f"peak device memory {peak / 2**20:.1f} MiB")
    return launches, heat_err, frames, peak


def stage_ms(model, batch, iters: int = 10):
    """Median host-clock ms of each stage of the fused forward, each one
    closed by a synchronise: camera backbone + neck, vtransform (with the
    pool), LiDAR branch (voxelize + encoder), fuser, the rest (decoder,
    head, get_bboxes)."""
    cam = model.encoders["camera"]
    img = batch["img"]
    B, N = img.shape[:2]
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.no_grad():
        for _ in range(iters + 2):
            feats = timed("camera backbone+neck", lambda: cam["neck"](cam["backbone"](
                img.reshape(B * N, *img.shape[2:])))[0])
            bev_cam = timed("camera vtransform (incl. pool)", lambda: cam["vtransform"](
                feats.view(B, N, *feats.shape[1:]), batch["points"], batch["points_mask"], batch))
            bev_lidar = timed("lidar voxelize+encoder", lambda: model.extract_lidar_features(
                batch["points"], batch["points_mask"]))
            x = timed("fuser", lambda: model.fuser([bev_cam, bev_lidar]))
            timed("decoder+head+get_bboxes", lambda: model.heads["object"].get_bboxes(
                model.heads["object"](model.decoder["neck"](model.decoder["backbone"](x))[0])))
    return {k: statistics.median(v[2:]) for k, v in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bevfusion_tpu_torch import native
    from bevfusion_tpu_torch.models.vtransforms import build_pool_lut
    from bevfusion_tpu_torch.ops import bev_pool as bp
    from bevfusion_tpu_torch.ops import sparse_conv as sp
    from bevfusion_tpu_torch.runtime.flagship import (add_pool_lut, batch_to, build_flagship,
                                                      build_lidar_slice)

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
    with ThreadPoolExecutor(2) as ex:  # one nvcc per source, started together
        list(ex.map(lambda ops: ops.build_kernels(), (sp, bp)))
    build_s = time.perf_counter() - t0
    print(f"build: sparse_conv and bev_pool in {build_s:.2f} s")
    for lib in ("sparse_conv", "bev_pool"):
        for line in native.build_log(lib).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib}: {line.strip()}")

    # 3. sparse-conv kernel vs plain at the LiDAR branch's shapes
    cpu_cfg, cpu_model, cpu_batch = build_lidar_slice("cpu", num_points=120000, seed=0)
    batch = batch_to(cpu_batch, "cuda")
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

    # 4. the LiDAR slice, eval forward at B=1
    counters = {"sparse_conv": sp.sparse_conv, "bev_pool": bp.bev_pool}
    lidar_launches, lidar_heat_err, lidar_frames, lidar_peak = run_model(
        "lidar slice", copy.deepcopy(cpu_model).cuda(), batch, cpu_model, cpu_batch, counters,
        {"sparse_conv": SPARSE_LAUNCHES, "bev_pool": 0})
    del cpu_model, cpu_batch, batch

    # 5. BEV-pool kernel vs plain at the flagship's shape, on the main path's intervals
    cfg, cpu_model, cpu_batch = build_flagship("cpu", num_points=120000, seed=0)
    batch = batch_to(cpu_batch, "cuda")
    t0 = time.perf_counter()
    add_pool_lut(cfg, cpu_batch)
    lut_s = time.perf_counter() - t0
    iv = bp.PoolIntervals(*(batch["pool_lut"][k] for k in bp.PoolIntervals._fields))
    vt = cpu_model.encoders["camera"]["vtransform"]
    X, Y, Z = vt.nx
    D, fH, fW = vt.frustum.shape[:3]
    g = torch.Generator(device="cuda").manual_seed(0)
    depth = torch.randn(1, 6, D, fH, fW, generator=g, device="cuda").softmax(2)
    ctx = torch.randn(1, 6, vt.C, fH, fW, generator=g, device="cuda").permute(0, 1, 3, 4, 2)
    ctx = ctx.contiguous()
    P, R = iv.ranks_depth.numel(), iv.interval_cells.numel()
    got = bp.bev_pool(depth, ctx, iv, Z, X, Y)
    want = bp.bev_pool_plain(depth, ctx, iv, Z, X, Y)
    torch.cuda.synchronize()
    pool_err = (got - want).abs().max().item()
    pool_scale = max(want.abs().max().item(), 1.0)
    check(got.shape == (1, Z * vt.C, X, Y), f"bev_pool shape {tuple(got.shape)}")
    check(pool_err <= FP32_RTOL_KERNEL * pool_scale,
          f"bev_pool: max|d| {pool_err} vs plain, scale {pool_scale}")
    pool_ms = cuda_ms(lambda: bp.bev_pool(depth, ctx, iv, Z, X, Y))
    pool_plain_ms = cuda_ms(lambda: bp.bev_pool_plain(depth, ctx, iv, Z, X, Y))
    lengths = iv.interval_lengths.float()
    print(f"kernel bev_pool: P {P} of {depth.numel()} frustum points in the grid, R {R} "
          f"intervals of {Z * X * Y} cells (length mean {lengths.mean().item():.2f}, max "
          f"{int(lengths.max().item())}); max|d| {pool_err:.3e}, kernel {pool_ms:.4f} ms, "
          f"plain {pool_plain_ms:.4f} ms")
    frustum = vt.frustum.cuda()
    lut_card_ms = cuda_ms(lambda: build_pool_lut(frustum, vt.dx, vt.bx, vt.nx, batch))
    ids = build_pool_lut(frustum, vt.dx, vt.bx, vt.nx, batch)["cell_ids"].cpu()
    print(f"pool LUT build: host {lut_s:.3f} s, card {lut_card_ms:.3f} ms (the in-graph "
          f"route's cost per frame); the card's geometry puts "
          f"{(ids != cpu_batch['pool_lut']['cell_ids']).float().mean().item():.3e} of frustum "
          f"points in another cell than the host's (axis-aligned rig)")

    # 6. the fused flagship, eval forward at B=1
    model = copy.deepcopy(cpu_model).cuda()
    launches, heat_err, frames, peak = run_model(
        "flagship", model, batch, cpu_model, cpu_batch, counters,
        {"sparse_conv": SPARSE_LAUNCHES, "bev_pool": POOL_LAUNCHES})
    stages = stage_ms(model, batch)
    for stage, ms in stages.items():
        print(f"flagship stage {stage}: {ms:.2f} ms")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    with torch.no_grad():
        frames_tf32, peak_tf32 = frame_ms(lambda: model(batch))
    stages_tf32 = stage_ms(model, batch)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"flagship, TF32 on: {statistics.median(frames_tf32):.2f} ms/frame median, "
          f"peak device memory {peak_tf32 / 2**20:.1f} MiB; stages "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in stages_tf32.items()))

    # 7. results
    kernels = [
        {"name": "sparse_conv", "route": "cuda",
         "source": "bevfusion_tpu_torch/csrc/sparse_conv.cu",
         "replaces": "bevfusion_tpu/ops/sparse_conv_windowed.py:285",
         "also_replaces": ["bevfusion_tpu/ops/sparse_conv_windowed.py:180"],
         "launches": launches["sparse_conv"],
         "max_abs_err": max(s["max_abs_err"] for s in shapes),
         "ms": sum(s["ms"] for s in shapes),
         "plain_ms": sum(s["plain_ms"] for s in shapes),
         "shapes": shapes},
        {"name": "bev_pool", "route": "cuda",
         "source": "bevfusion_tpu_torch/csrc/bev_pool.cu",
         "replaces": "bevfusion_tpu/ops/bev_pool_pallas.py:49",
         "launches": launches["bev_pool"],
         "max_abs_err": pool_err, "ms": pool_ms, "plain_ms": pool_plain_ms,
         "points": P, "intervals": R, "lut_host_s": lut_s, "lut_card_ms": lut_card_ms},
    ]
    print(json.dumps({
        "kernels": kernels, "build_s": build_s,
        "flagship": {"frame_ms_median": statistics.median(frames), "peak_mem_bytes": peak,
                     "heatmap_rel_err": heat_err, "stage_ms": stages,
                     "frame_ms_median_tf32": statistics.median(frames_tf32),
                     "peak_mem_bytes_tf32": peak_tf32, "stage_ms_tf32": stages_tf32},
        "lidar_slice": {"launches": lidar_launches,
                        "frame_ms_median": statistics.median(lidar_frames),
                        "peak_mem_bytes": lidar_peak, "heatmap_rel_err": lidar_heat_err}}))
    print(smi)  # the card's name and power limit, as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
