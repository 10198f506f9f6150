#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases:

1. device: the card's name and power limit; TF32 off for fp32 parity;
2. build: compile the three kernels from bevfusion_tpu_torch/csrc (one
   nvcc per source, started together);
3. sparse-conv kernel vs plain: the kernel and its plain PyTorch version
   on the same CUDA tensors at the LiDAR branch's shapes (a voxelized
   120k-point scan at voxelnet_0p075: the input conv, a stage-0 residual
   conv, the stage-0 strided conv, a stage-1 and a stage-2 residual conv),
   max|d| <= 1e-4 * max(|plain|, 1) on valid rows; each one's median time,
   hit-pair count and bound;
4. weight-gradient kernel vs plain at the same five shapes, the same
   tolerance, times and bounds;
5. backward-data through the sparse-conv kernel (``SparseConvFunction``:
   mirrored weights for submanifold convs, the transposed rulebook for the
   strided one) vs autograd of the plain version, the same tolerance;
6. the LiDAR slice: TransFusion-L (voxelnet_0p075) at full width with
   seeded random weights, eval forward at batch 1 on the scan; 15 kernel
   launches per forward, every box field finite, heatmap logits within
   2e-3 relative of the same model on the CPU (plain path); ms/frame and
   peak device memory;
7. BEV-pool kernel vs plain at the flagship's shape: depth [1, 6, 118, 32,
   88] (softmax of seeded noise), ctx [1, 6, 80, 32, 88] (held
   channels-last), the intervals of the flagship batch's own pooling LUT;
   max|d| <= 1e-4 * max(|plain|, 1), both median times and the bound; the
   pool's backward (torch ops) vs autograd of the plain pool, the same
   tolerance, and its time; the time of building the LUT on the host and on
   the card;
8. the fused flagship (swint_v0p075/convfuser.yaml) at full width with
   seeded random weights and the host pooling LUT, eval forward at batch
   1: 15 sparse-conv and 1 BEV-pool launches per forward, every box field
   finite, heatmap logits within 2e-3 relative of the same model on the
   CPU (plain path, same LUT); ms/frame, peak device memory and the time
   of each stage; the frame and its stages again with TF32 on;
9. the flagship's training step at full width, B = 1, host LUT, TF32 off,
   PyTorch's deterministic algorithms on (the card's own run-to-run noise
   would swamp the comparison):
   one forward + backward through the kernels and one through their plain
   versions on the card (same weights, the heatmap head's last conv scaled
   by 0.2 so its logits stay unsaturated, same batch, a freshly seeded
   dropout generator each); both select the same proposals, the plain pass
   takes the kernel pass's Hungarian targets (whether its own match is
   printed: at random init the auction's assignment flips under the card's
   run-to-run noise); loss within 1e-4 relative and every parameter's
   gradient within 5e-3 relative in norm; every parameter has a gradient;
   the step launches the sparse-conv kernel 15 + 14 times (forward,
   backward-data: the input conv's voxel features need no gradient), the
   weight-gradient kernel 15 times and the BEV-pool kernel once;
10. five timed train steps with TF32 on (``runtime/train.py``: AdamW,
   clip 35, the config's cosine lr with linear warmup and cyclic momentum):
   losses finite, parameters changed; median ms/step split into forward,
   backward and optimizer (host clock around synchronises), peak device
   memory, and the auction matcher's time within the forward;
11. a JSON line with the kernel table, a line with the card's name and
   power limit as nvidia-smi prints them, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when CUDA is unavailable or any
check fails. Imports neither JAX nor the JAX package.
"""
import contextlib
import copy
import json
from concurrent.futures import ThreadPoolExecutor
import math
import os
import statistics
import subprocess
import sys
import time

import torch

FP32_RTOL_KERNEL = 1e-4  # kernel vs plain on the card: summation order only
HEATMAP_RTOL = 2e-3  # full model on the card vs on the CPU, ~40 fp32 layers
TRAIN_LOSS_RTOL = 1e-4  # train step through the kernels vs their plain versions
# per parameter, relative in norm: at random init the kernels' fp32
# summation order (~5e-6 on the heatmap) reaches BatchNorm-bias gradients,
# sums over 32,400 BEV cells that nearly cancel, at up to 1.7e-3 on an H100
TRAIN_GRAD_RTOL = 5e-3
ZERO_GRAD = 1e-6  # of the global norm: a gradient that is zero but for rounding
SPARSE_LAUNCHES = 15  # 13 submanifold + 2 strided sparse convs at B=1
POOL_LAUNCHES = 1  # one BEV pool per frame at B=1
TRAIN_LAUNCHES = {"sparse_conv": 15 + 14, "sparse_conv_dw": 15, "bev_pool": 1}
TRAIN_HORIZON = 1000  # steps of the lr and momentum schedules
DEVICE = "cuda"
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


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


def bound(flops: float, nbytes: float):
    """The least time (ms) the card could take: the larger of the
    operations over the fp32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@contextlib.contextmanager
def plain_kernels(sp, bp):
    """Every kernel wrapper replaced by its plain version (on CUDA tensors
    too) for the duration; the wrappers' launch counts are untouched."""
    saved = sp.sparse_conv, sp.sparse_conv_dw, bp.bev_pool
    sp.sparse_conv, sp.sparse_conv_dw, bp.bev_pool = (
        sp.sparse_conv_plain, sp.sparse_conv_dw_plain, bp.bev_pool_plain)
    try:
        yield
    finally:
        sp.sparse_conv, sp.sparse_conv_dw, bp.bev_pool = saved


@contextlib.contextmanager
def recorded_targets(head, store):
    """The head's Hungarian targets recorded into ``store`` by the first
    pass and replayed to later ones, so two passes take the same discrete
    decisions: at random init the auction's assignment is not stable under
    the differences in summation order between the two."""
    compute = head._targets

    def targets(b, *args):
        if b not in store:
            store[b] = compute(b, *args)
        return store[b]

    head._targets = targets
    try:
        yield compute
    finally:
        del head._targets


@contextlib.contextmanager
def timed_auction(records):
    """Each call of the head's auction matcher timed on the host clock
    around synchronises, appended to ``records`` as (ms, rows assigned,
    valid rows)."""
    from bevfusion_tpu_torch.models.heads import transfusion

    auction = transfusion.auction_assignment

    def timed(cost, row_valid, col_valid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = auction(cost, row_valid, col_valid)
        assigned = int((out >= 0).sum())
        records.append(((time.perf_counter() - t0) * 1e3, assigned, int(row_valid.sum())))
        return out

    transfusion.auction_assignment = timed
    try:
        yield
    finally:
        transfusion.auction_assignment = auction


def kernel_cases(cfg, batch, sp, vox):
    """The sparse convs of the main path at their real shapes: voxelize the
    scan, build the stage-0, -1 and -2 rulebooks (and the strided conv's
    transposed one), random fp32 operands. Returns (label, (feats, nbr,
    weight), epilogue kwargs, valid output rows, transposed table or None)."""
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
    cnbr_t = sp.build_conv_transpose_rulebook(ids, ids1, grid, grid1, 3, 2, 1)
    nbr1 = sp.build_subm_rulebook(ids1, grid1)
    grid2 = sp.conv_out_shape(grid1, 3, 2, 1)
    ids2, mask2 = sp.downsample_sites(ids1, grid1, 3, 2, 1, cap2)
    nbr2 = sp.build_subm_rulebook(ids2, grid2)
    g = torch.Generator(device=DEVICE).manual_seed(0)
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
         mask, None),
        ("stage0 subm 16->16", (rand(cap0, 16), nbr0, rand(27, 16, 16, std=(2 / 432) ** 0.5)),
         epi(16, cap0), mask, None),
        ("stage0 strided 16->32", (rand(cap0, 16), cnbr, rand(27, 16, 32, std=(2 / 432) ** 0.5)),
         epi(32), mask1, cnbr_t),
        ("stage1 subm 32->32", (rand(cap1, 32), nbr1, rand(27, 32, 32, std=(2 / 864) ** 0.5)),
         epi(32, cap1), mask1, None),
        ("stage2 subm 64->64", (rand(cap2, 64), nbr2, rand(27, 64, 64, std=(2 / 1728) ** 0.5)),
         epi(64, cap2), mask2, None),
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


def sparse_kernel_phases(sp, cases):
    """Phases 3-5 at each shape: forward, weight gradient and backward-data
    against their plain versions; times and bounds. Returns three lists of
    per-shape records."""
    fwd, dw, bwd = [], [], []
    for label, (feats, nbr, w), kw, valid, nbr_t in cases:
        K, Cin, Cout = w.shape
        hits = int((nbr >= 0).sum())
        got = sp.sparse_conv(feats, nbr, w, **kw)
        want = sp.sparse_conv_plain(feats, nbr, w, **kw)
        torch.cuda.synchronize()
        err = (got - want)[valid].abs().max().item()
        scale = max(want[valid].abs().max().item(), 1.0)
        check(err <= FP32_RTOL_KERNEL * scale, f"{label}: max|d| {err} vs plain, scale {scale}")
        b_ms, b_by = bound(2 * hits * Cin * Cout, nbytes(feats, nbr, w, got, *(
            v for v in kw.values() if torch.is_tensor(v))))
        ms = cuda_ms(lambda: sp.sparse_conv(feats, nbr, w, **kw))
        plain_ms = cuda_ms(lambda: sp.sparse_conv_plain(feats, nbr, w, **kw))
        fwd.append({"shape": label, "sites_out": nbr.shape[1], "valid_out": int(valid.sum()),
                    "hits": hits, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by})
        print(f"kernel sparse_conv {label}: {int(valid.sum())} of {nbr.shape[1]} output sites, "
              f"{hits} hit pairs, max|d| {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of bound")

        # 4. the weight gradient of the same conv, for a random output gradient
        dout = torch.randn(nbr.shape[1], Cout, device=DEVICE,
                           generator=torch.Generator(device=DEVICE).manual_seed(hits))
        dout = dout * valid[:, None]
        got = sp.sparse_conv_dw(feats, nbr, dout)
        want = sp.sparse_conv_dw_plain(feats, nbr, dout)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(want.abs().max().item(), 1.0)
        check(err <= FP32_RTOL_KERNEL * scale, f"{label} dW: max|d| {err} vs plain, scale {scale}")
        check(torch.equal(sp.sparse_conv_dw(feats, nbr, dout), got), f"{label} dW: not repeatable")
        b_ms, b_by = bound(2 * hits * Cin * Cout, nbytes(feats, nbr, dout, got))
        ms = cuda_ms(lambda: sp.sparse_conv_dw(feats, nbr, dout))
        plain_ms = cuda_ms(lambda: sp.sparse_conv_dw_plain(feats, nbr, dout))
        dw.append({"shape": label, "hits": hits, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
        print(f"kernel sparse_conv_dw {label}: {hits} hit pairs, max|d| {err:.3e}, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms:.3f} of bound")

        # 5. backward-data through the forward kernel vs autograd of the plain conv
        x = feats.clone().requires_grad_()
        sp.SparseConvFunction.apply(x, w, nbr, nbr_t).backward(dout)
        x0 = feats.clone().requires_grad_()
        sp.sparse_conv_plain(x0, nbr, w).backward(dout)
        torch.cuda.synchronize()
        err = (x.grad - x0.grad).abs().max().item()
        scale = max(x0.grad.abs().max().item(), 1.0)
        check(err <= FP32_RTOL_KERNEL * scale, f"{label} d_feats: max|d| {err}, scale {scale}")
        table, wt = ((nbr, w.flip(0).transpose(1, 2).contiguous()) if nbr_t is None
                     else (nbr_t, w.transpose(1, 2).contiguous()))
        ms = cuda_ms(lambda: sp.sparse_conv(dout, table, wt))
        bwd.append({"shape": label, "max_abs_err": err, "ms": ms})
        print(f"kernel sparse_conv backward-data {label}: max|d| {err:.3e} vs autograd of "
              f"plain, kernel {ms:.4f} ms")
    return fwd, dw, bwd


def summary(name, source, replaces, launches, shapes, extra_err=()):
    """One kernel's entry of the JSON line: times and bounds summed over
    its shapes, the largest error, the limit of the largest bound."""
    top = max(shapes, key=lambda s: s["bound_ms"])
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max([s["max_abs_err"] for s in shapes] + list(extra_err)),
            "ms": sum(s["ms"] for s in shapes), "plain_ms": sum(s["plain_ms"] for s in shapes),
            "bound_ms": sum(s["bound_ms"] for s in shapes), "bound_by": top["bound_by"],
            "library_ms": None, "shapes": shapes}


def train_step_parity(model, batch, sp, bp, counters):
    """Phase 9: one forward + backward through the kernels (launches
    counted) and one through the plain versions, same weights and batch,
    a freshly seeded dropout generator each. Both passes must select the
    same proposals; the plain pass takes the kernel pass's Hungarian
    targets (``recorded_targets``), and whether its own would differ is
    reported."""
    from bevfusion_tpu_torch.models.layers import set_dropout_generator

    params = dict(model.named_parameters())
    head = model.heads["object"]
    store = {}
    # cuDNN's and index_add_'s atomics otherwise make two kernel passes differ
    # by more than the kernels and their plain versions do
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)

    def fwd_bwd():
        preds = {}
        hook = head.register_forward_hook(
            lambda mod, args, out: preds.update({k: v.detach() for k, v in out.items()}))
        set_dropout_generator(model, torch.Generator(device=DEVICE).manual_seed(0))
        model.zero_grad(set_to_none=True)
        with recorded_targets(head, store) as compute:
            losses = model(batch)
        hook.remove()
        total = sum(v for k, v in losses.items() if k.startswith("loss/"))
        total.backward()
        torch.cuda.synchronize()
        with torch.no_grad():
            own = compute(0, preds, batch["gt_boxes"][0], batch["gt_labels"][0],
                          batch["gt_valid"][0], 1)
        return ({k: v.item() for k, v in losses.items()}, total.item(),
                {n: p.grad.clone() for n, p in params.items() if p.grad is not None}, preds, own)

    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    losses, total, grads, preds, own = fwd_bwd()
    kernel_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    print(f"train step: launches in one forward + backward {launches}; {kernel_s:.2f} s")
    check(launches == TRAIN_LAUNCHES, f"train step: launches {launches}, want {TRAIN_LAUNCHES}")
    missing = sorted(set(params) - set(grads))
    check(not missing, f"train step: parameters without a gradient {missing[:5]}")
    check(math.isfinite(total), f"train step: loss {total}")
    with plain_kernels(sp, bp):
        t0 = time.perf_counter()
        losses_p, total_p, grads_p, preds_p, own_p = fwd_bwd()
        plain_s = time.perf_counter() - t0
    check({name: c.launches for name, c in counters.items()} == launches,
          "the plain path launched a kernel")
    heat_err = rel_err(preds["dense_heatmap"], preds_p["dense_heatmap"])
    score_err = rel_err(preds["query_heatmap_score"], preds_p["query_heatmap_score"])
    same_queries = torch.equal(preds["query_labels"], preds_p["query_labels"])
    same_targets = all(torch.equal(a, b) for a, b in zip(own, own_p))
    print(f"train step: dense heatmap rel err {heat_err:.3e}; the same proposals "
          f"{same_queries} (their scores rel err {score_err:.3e}); the plain pass's own "
          f"Hungarian targets equal the kernel pass's: {same_targets}")
    check(same_queries and score_err <= TRAIN_LOSS_RTOL, "train step: proposals differ")
    loss_err = max(abs(losses[k] - v) / max(abs(v), 1e-6) for k, v in losses_p.items())
    loss_err = max(loss_err, abs(total - total_p) / abs(total_p))
    print(f"train step: losses {losses}; vs plain path max rel err {loss_err:.3e} "
          f"(plain path {plain_s:.2f} s)")
    check(loss_err <= TRAIN_LOSS_RTOL, f"train step: loss rel err {loss_err}")
    global_norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads_p.values()))
    worst, zero = 0.0, []
    for n, g in grads_p.items():
        diff, ref = float((grads[n] - g).double().norm()), float(g.double().norm())
        if ref <= ZERO_GRAD * global_norm:
            zero.append(n)
            check(diff <= ZERO_GRAD * global_norm, f"train step: {n} grad |d| {diff}")
        else:
            worst = max(worst, diff / ref)
            check(diff <= TRAIN_GRAD_RTOL * ref, f"train step: {n} grad rel err {diff / ref}")
    print(f"train step: {len(grads)} parameter gradients, max rel err {worst:.3e} in norm vs "
          f"plain path; {len(zero)} zero but for rounding (< {ZERO_GRAD:g} of the global norm "
          f"{global_norm:.4e})")
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    return {"launches": launches, "losses": losses, "loss_rel_err": loss_err,
            "grad_rel_err": worst, "zero_grads": len(zero), "heatmap_rel_err": heat_err,
            "same_own_targets": same_targets, "kernel_s": kernel_s, "plain_s": plain_s}


def timed_train_steps(cfg, model, batch, steps: int = 5, warmup: int = 2):
    """Phase 10: ``steps`` train steps after ``warmup`` through the port's
    trainer; per-phase host-clock ms around synchronises, peak memory."""
    from bevfusion_tpu_torch.runtime import train

    opt_cfg = cfg.optimizer
    opt = train.build_optimizer(
        opt_cfg, train.build_lr_schedule(cfg.lr_config, opt_cfg.lr, TRAIN_HORIZON), model,
        cfg.optimizer_config.grad_clip,
        train.build_momentum_schedule(cfg.momentum_config, 0.9, TRAIN_HORIZON))
    step = train.make_train_step(model, opt, DEVICE, seed=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    records = []

    def one():
        phases, t = {}, [0.0]

        def mark(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            phases[name] = (now - t[0]) * 1e3
            t[0] = now

        torch.cuda.synchronize()
        t[0] = time.perf_counter()
        logs = step(batch, mark)
        phases["step"] = sum(phases.values())
        return {k: v.item() for k, v in logs.items()}, phases

    for _ in range(warmup):
        one()
    torch.cuda.reset_peak_memory_stats()
    auctions = []
    with timed_auction(auctions):
        for _ in range(steps):
            records.append(one())
    peak = torch.cuda.max_memory_allocated()
    losses = [logs["loss/total"] for logs, _ in records]
    check(all(math.isfinite(v) for logs, _ in records for v in logs.values()),
          f"timed steps: non-finite logs {records[-1][0]}")
    unchanged = [n for n, p in model.named_parameters() if torch.equal(p.detach(), before[n])]
    check(not unchanged, f"timed steps: parameters unchanged {unchanged[:5]}")
    med = {k: statistics.median(ph[k] for _, ph in records)
           for k in ("forward", "backward", "optimizer", "step")}
    print(f"train steps (TF32 on): total loss {[round(v, 4) for v in losses]}; median ms/step "
          f"{med['step']:.2f} (forward {med['forward']:.2f}, backward {med['backward']:.2f}, "
          f"optimizer {med['optimizer']:.2f}); peak device memory {peak / 2**20:.1f} MiB; "
          f"{opt.count} optimizer steps")
    auction_ms = statistics.median(ms for ms, _, _ in auctions)
    print(f"train steps: the auction matcher (in the forward) {auction_ms:.2f} ms median over "
          f"{len(auctions)} calls, {[f'{a} of {v}' for _, a, v in auctions]} ground truths "
          f"assigned")
    return {"ms_median": med, "steps": [ph for _, ph in records], "losses": losses,
            "peak_mem_bytes": peak, "auction_ms": [ms for ms, _, _ in auctions],
            "auction_assigned": [[a, v] for _, a, v in auctions]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # cuBLAS takes deterministic workspaces only if told before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    builds = (sp.build_kernels, sp.build_dw_kernels, bp.build_kernels)
    with ThreadPoolExecutor(len(builds)) as ex:  # one nvcc per source, started together
        list(ex.map(lambda build: build(), builds))
    build_s = time.perf_counter() - t0
    print(f"build: sparse_conv, sparse_conv_dw and bev_pool in {build_s:.2f} s")
    for lib in ("sparse_conv", "sparse_conv_dw", "bev_pool"):
        for line in native.build_log(lib).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib}: {line.strip()}")

    # 3-5. sparse-conv kernels vs plain at the LiDAR branch's shapes
    cpu_cfg, cpu_model, cpu_batch = build_lidar_slice("cpu", num_points=120000, seed=0)
    batch = batch_to(cpu_batch, "cuda")
    cases = kernel_cases(cpu_cfg, batch, sp, cpu_model.lidar_voxelize)
    shapes, dw_shapes, bwd_shapes = sparse_kernel_phases(sp, cases)
    del cases

    # 6. the LiDAR slice, eval forward at B=1
    counters = {"sparse_conv": sp.sparse_conv, "bev_pool": bp.bev_pool}
    lidar_launches, lidar_heat_err, lidar_frames, lidar_peak = run_model(
        "lidar slice", copy.deepcopy(cpu_model).cuda(), batch, cpu_model, cpu_batch, counters,
        {"sparse_conv": SPARSE_LAUNCHES, "bev_pool": 0})
    del cpu_model, cpu_batch, batch

    # 7. BEV-pool kernel vs plain at the flagship's shape, on the main path's intervals
    cfg, cpu_model, cpu_batch = build_flagship("cpu", num_points=120000, seed=0)
    batch = batch_to(cpu_batch, "cuda")
    t0 = time.perf_counter()
    add_pool_lut(cfg, cpu_batch)
    lut_s = time.perf_counter() - t0
    iv = bp.PoolIntervals(*(batch["pool_lut"][k] for k in bp.PoolIntervals._fields))
    vt = cpu_model.encoders["camera"]["vtransform"]
    X, Y, Z = vt.nx
    D, fH, fW = vt.frustum.shape[:3]
    g = torch.Generator(device=DEVICE).manual_seed(0)
    depth = torch.randn(1, 6, D, fH, fW, generator=g, device=DEVICE).softmax(2)
    ctx = torch.randn(1, 6, vt.C, fH, fW, generator=g, device=DEVICE).permute(0, 1, 3, 4, 2)
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
    # each input byte once (the P pooled depth values, the whole ctx table,
    # the interval arrays), the zero-filled output grid once; a multiply-add
    # per pooled point and channel
    pool_bound, pool_by = bound(2 * P * vt.C, 4 * P + nbytes(ctx, got, *iv))
    lengths = iv.interval_lengths.float()
    print(f"kernel bev_pool: P {P} of {depth.numel()} frustum points in the grid, R {R} "
          f"intervals of {Z * X * Y} cells (length mean {lengths.mean().item():.2f}, max "
          f"{int(lengths.max().item())}); max|d| {pool_err:.3e}, kernel {pool_ms:.4f} ms, "
          f"plain {pool_plain_ms:.4f} ms, bound {pool_bound:.4f} ms ({pool_by}), "
          f"{pool_bound / pool_ms:.3f} of bound")
    # the pool's backward (torch ops, chunked) vs autograd of the plain pool
    gout = torch.randn(got.shape, generator=g, device=DEVICE)
    dr, cr = depth.clone().requires_grad_(), ctx.clone().requires_grad_()
    bp.BEVPoolFunction.apply(dr, cr, iv, Z, X, Y).backward(gout)
    dr0, cr0 = depth.clone().requires_grad_(), ctx.clone().requires_grad_()
    plain_out = bp.bev_pool_plain(dr0, cr0, iv, Z, X, Y)
    plain_out.backward(gout, retain_graph=True)
    torch.cuda.synchronize()
    pool_bwd_err = max((a - b).abs().max().item() / max(b.abs().max().item(), 1.0)
                       for a, b in ((dr.grad, dr0.grad), (cr.grad, cr0.grad)))
    check(pool_bwd_err <= FP32_RTOL_KERNEL, f"bev_pool backward: rel err {pool_bwd_err}")
    pool_bwd_ms = cuda_ms(lambda: bp.bev_pool_backward(depth, ctx, iv, gout, Z, X, Y))
    pool_bwd_plain_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, (dr0, cr0), gout,
                                                            retain_graph=True))
    del plain_out, dr, cr, dr0, cr0
    print(f"bev_pool backward (torch ops, {bp.POOL_BWD_CHUNK} points a chunk): rel err "
          f"{pool_bwd_err:.3e} vs autograd of plain, {pool_bwd_ms:.4f} ms (autograd of plain "
          f"{pool_bwd_plain_ms:.4f} ms)")
    frustum = vt.frustum.cuda()
    lut_card_ms = cuda_ms(lambda: build_pool_lut(frustum, vt.dx, vt.bx, vt.nx, batch))
    ids = build_pool_lut(frustum, vt.dx, vt.bx, vt.nx, batch)["cell_ids"].cpu()
    print(f"pool LUT build: host {lut_s:.3f} s, card {lut_card_ms:.3f} ms (the in-graph "
          f"route's cost per frame); the card's geometry puts "
          f"{(ids != cpu_batch['pool_lut']['cell_ids']).float().mean().item():.3e} of frustum "
          f"points in another cell than the host's (axis-aligned rig)")

    # 8. the fused flagship, eval forward at B=1
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
    del model, cpu_model, cpu_batch, batch, depth, ctx, got, want, gout
    torch.cuda.empty_cache()

    # 9. the flagship's training step, B=1, host LUT, TF32 off: kernels vs plain
    cfg, model, batch = build_flagship("cuda", num_points=120000, seed=0, training=True)
    with torch.no_grad():  # moderate heatmap logits: an unsaturated sigmoid ranks apart
        model.heads["object"].heatmap_head[-1].weight.mul_(0.2)
    train_counters = {"sparse_conv": sp.sparse_conv, "sparse_conv_dw": sp.sparse_conv_dw,
                      "bev_pool": bp.bev_pool}
    parity = train_step_parity(model, batch, sp, bp, train_counters)

    # 10. five timed train steps, TF32 on
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    steps = timed_train_steps(cfg, model, batch)
    step_ms = steps["ms_median"]["step"]
    print(f"pool LUT build on the host: {lut_s * 1e3:.1f} ms = {lut_s * 1e3 / step_ms:.3f} "
          f"train steps; on the card {lut_card_ms:.3f} ms = {lut_card_ms / step_ms:.4f} steps")

    # 11. results
    pool_entry = {"shape": "flagship [1,6,118,32,88] x [1,6,32,88,80]", "points": P,
                  "intervals": R, "max_abs_err": pool_err, "ms": pool_ms,
                  "plain_ms": pool_plain_ms, "bound_ms": pool_bound, "bound_by": pool_by}
    kernels = [
        dict(summary("sparse_conv", "bevfusion_tpu_torch/csrc/sparse_conv.cu",
                     "bevfusion_tpu/ops/sparse_conv_windowed.py:285",
                     parity["launches"]["sparse_conv"], shapes,
                     [s["max_abs_err"] for s in bwd_shapes]),
             also_replaces=["bevfusion_tpu/ops/sparse_conv_windowed.py:180"],
             launches_eval=launches["sparse_conv"], backward_data=bwd_shapes),
        summary("sparse_conv_dw", "bevfusion_tpu_torch/csrc/sparse_conv_dw.cu",
                "bevfusion_tpu/ops/sparse_conv_windowed.py:501",
                parity["launches"]["sparse_conv_dw"], dw_shapes),
        dict(summary("bev_pool", "bevfusion_tpu_torch/csrc/bev_pool.cu",
                     "bevfusion_tpu/ops/bev_pool_pallas.py:49", parity["launches"]["bev_pool"],
                     [pool_entry]),
             launches_eval=launches["bev_pool"], backward_ms=pool_bwd_ms,
             backward_plain_ms=pool_bwd_plain_ms, backward_rel_err=pool_bwd_err,
             lut_host_s=lut_s, lut_card_ms=lut_card_ms),
    ]
    print(json.dumps({
        "kernels": kernels, "build_s": build_s,
        "flagship": {"frame_ms_median": statistics.median(frames), "peak_mem_bytes": peak,
                     "heatmap_rel_err": heat_err, "stage_ms": stages,
                     "frame_ms_median_tf32": statistics.median(frames_tf32),
                     "peak_mem_bytes_tf32": peak_tf32, "stage_ms_tf32": stages_tf32},
        "train": {"parity_tf32_off": parity, "steps_tf32_on": steps},
        "lidar_slice": {"launches": lidar_launches,
                        "frame_ms_median": statistics.median(lidar_frames),
                        "peak_mem_bytes": lidar_peak, "heatmap_rel_err": lidar_heat_err}}))
    print(smi)  # the card's name and power limit, as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
