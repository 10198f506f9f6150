#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases:

1. device: the card's name and power limit; TF32 off for fp32 parity;
2. build: compile the six kernel sources of bevfusion_tpu_torch/csrc (one
   nvcc per source, started together); the ptxas register and spill lines;
   the count of tensor-core instructions (``HMMA``) in the SASS
   (``cuobjdump -sass``) of the sparse-conv, weight-gradient and cost
   breakdown libraries, and of TMA bulk copies (``UBLKCP``) in the memory
   probes' library, each of which must be above 0;
3. sparse-conv kernel vs plain: the kernel and its plain PyTorch version
   on the same CUDA tensors at the LiDAR branch's six shapes (a voxelized
   120k-point scan at voxelnet_0p075: the input conv, a stage-0 residual
   conv, the stage-0 strided conv, a stage-1 residual conv, the stage-1
   strided conv and a stage-2 residual conv; the strided convs' geometry
   the encoder's own), max|d| <= 1e-4 * max(|plain|, 1) on valid rows;
   each one's median time,
   hit-pair count and bound (3 TF32 products per multiply-add on the
   tensor cores, the 3xTF32 split; the fp32-FMA bound beside it); its time
   without epilogue beside the scalar loop, the kernel's first form (K7
   ``current`` at tile 64), timed in the same run, and the ratio;
4. weight-gradient kernel vs plain at the same six shapes, the same
   tolerance, bit-equal across two calls; times and bounds as phase 3 (3
   TF32 products per multiply-add, the fp32-FMA bound beside it); the
   kernel's and the plain version's max|d| against the product in float64;
   the kernel's time over the forward's without epilogue in the same run;
   the sum over a train step's 15 launches (time x launches a shape);
5. backward-data through the sparse-conv kernel (``SparseConvFunction``:
   mirrored weights for submanifold convs, the transposed rulebooks for the
   strided ones) vs autograd of the plain version, the same tolerance; its
   time beside the scalar loop on the same operands, and the ratio;
6. the memory probes' kernels vs plain (``tools/bench_tile_micro.py``): K5,
   the copy ``x + 1``, at [65536, 1024] bf16, and K6, the tile gather, on
   both engines (TMA bulk copies, and its first form, ``cp.async``) at the
   tool's five settings, each equal to its plain version bit for bit;
7. the sparse-conv cost breakdown's kernel vs plain
   (``tools/bench_kernel_variants.py``, K7) at the stage-0 (C = 16),
   stage-1 (C = 32) and stage-2 (C = 64) submanifold convs of the scan,
   max|d| <= 1e-4 * max(|plain|, 1) in every mode: the scalar family's four
   modes at tiles 64 and 128, ``noskip`` equal to ``current`` bit for bit,
   and ``current`` at tile 64 (the scalar loop, which K7 keeps) within the
   same 1e-4 of the sparse-conv kernel without epilogue (a tensor-core
   kernel, so not bit for bit); the tensor-core family's five modes (K1/K2's
   own loop), ``tc`` equal to the sparse-conv kernel without epilogue and
   ``tc_noskip`` to ``tc``, bit for bit, and ``tc_1xtf32``'s max|d| from
   the fp32 plain conv (one TF32 product: ~1e-3 relative); the plain
   versions' times;
8. the LiDAR slice: TransFusion-L (voxelnet_0p075) at full width with
   seeded random weights, eval forward at batch 1 on the scan; 15 kernel
   launches per forward, every box field finite, heatmap logits within
   2e-3 relative of the same model on the CPU (plain path); ms/frame and
   peak device memory;
9. BEV-pool kernel vs plain at the flagship's shape: depth [1, 6, 118, 32,
   88] (softmax of seeded noise), ctx [1, 6, 80, 32, 88] (held
   channels-last), the intervals of the flagship batch's own pooling LUT
   (their length's mean, p99 and max, and how many distinct (cell, ctx
   row) pairs they hold against P; the wrapper's zero fill alone, and the
   kernel on the intervals longest first and on those of <= 64 points);
   max|d| <= 1e-4 * max(|plain|, 1), both median times and the bound; the
   pool's backward (torch ops) vs autograd of the plain pool, the same
   tolerance, and its time; the time of building the LUT on the host and on
   the card;
10. the fused flagship (swint_v0p075/convfuser.yaml) at full width with
   seeded random weights and the host pooling LUT, eval forward at batch
   1: 15 sparse-conv and 1 BEV-pool launches per forward, every box field
   finite, heatmap logits within 2e-3 relative of the same model on the
   CPU (plain path, same LUT); ms/frame, peak device memory and the time
   of each stage (``tools/profile_stages.py``); the frame and its stages
   again with TF32 on;
11. the three BEV map-segmentation configs (configs/nuscenes/seg/: fused
   fusion-bev256d2-lss, LiDAR-only lidar-centerpoint-bev128, camera-only
   camera-bev256d2) at full width with seeded random weights, the host
   pooling LUT where there is a camera and the 120k-point scan where there
   is a LiDAR, eval forward at batch 1, TF32 off: 15 sparse-conv and 1
   BEV-pool launches per forward (fused), 15 and 0 (LiDAR), 0 and 1
   (camera); ``masks_bev`` [1, 6, 200, 200] finite and within [0, 1]; the
   map classifier's logits (a forward hook on ``heads.map.classifier``)
   within 2e-3 relative of the same model on the CPU (plain path, same
   LUT); ms/frame and peak device memory with TF32 off and on, and the
   stage times (``tools/profile_stages.py``) of each; then the BEV-pool
   kernel vs plain at the seg grid (256 x 256 cells of 0.4 m, the fused
   config's own LUT) as in phase 9: max|d|, times, the zero fill, the bound
   and the interval lengths;
11b. det-camera: the three camera-only CenterHead detectors
   (configs/nuscenes/det/centerhead/lssfpn/camera/256x704/: swint/default,
   resnet/default, resnet/bevdepth) at full width with seeded random weights
   (each head branch's last conv scaled and shifted per channel so its maps
   on the batch have a moderate mean and spread: at random init they run to
   1e4 and every box falls outside the range), the host pooling LUT, eval
   forward at batch 1, TF32 off: 0 sparse-conv, 1 BEV-pool and 6 NMS
   launches per forward (one greedy pass a task); every task's raw head
   maps (a forward hook on ``heads.object``) within 2e-3 relative of the
   same model on the CPU; ``get_bboxes`` on the card and on the CPU on the
   same predictions (the CPU model's): equal keep masks and labels, kept
   boxes and scores within 1e-5 relative, every kept box finite; ms/frame
   and peak device memory with TF32 off and on, and the stages
   (``tools/profile_stages.py``, ``head/forward`` and ``head/decode``
   apart); the decode once under ``torch.profiler`` (the card's kernels
   and copies, their device time, the NMS kernel's, the idle share of the
   call's wall time); then the NMS kernel vs ``greedy_suppress_plain`` bit for bit on
   every suppression matrix of the three frames' decodes, a random one,
   one with everything suppressed, one with nothing, and one at N = 1000
   (``pre_max_size``), with the times and the bound of the swint frame's
   six and the four made ones; and the BEV-pool kernel vs plain at the
   ResNet configs' shape (C = 64, 128 x 128 cells of 0.8 m) as in phase 9;
11c. pillar: PointPillars TransFusion
   (configs/nuscenes/det/transfusion/secfpn/lidar/pointpillars.yaml: the
   120k-point scan as a [60000, 20, 5] pillar table, PillarFeatureNet, the
   scatter to 512 x 512, SECOND + SECONDFPN, TransFusion at 128 x 128) at full
   width with seeded random weights, eval at batch 1, TF32 off: no kernel
   launch (0 sparse-conv, 0 BEV-pool, 0 NMS), every box field finite,
   heatmap logits within 2e-3 relative of the CPU model; the occupied and
   the capped pillar counts; ms/frame, peak memory and stages with TF32 off
   and on, and the pillar encoder's share of the stages; then camera + radar
   CenterHead (configs/nuscenes/det/centerhead/lssfpn/camera+radar/resnet50/
   default.yaml: ResNet-50 + SECONDFPN + LSS at 0.8 m, a 300-point
   45-channel radar scan through four RFN layers and the scatter to 128 x
   128, ConvFuser, GeneralizedResNet + LSSFPN, CenterHead) as each phase-11b
   frame, head moderated, launches 0 / 1 / 6, the radar branch's stages
   (``radar/voxelize``, ``radar/encoder``) among the stages; last,
   resnet50/dlss.yaml must raise its stride ValueError (the depth branch
   32 x 88 against 16 x 44 features);
12. the flagship's training step at full width, B = 1, host LUT, TF32 off,
   PyTorch's deterministic algorithms on (the card's own run-to-run noise
   would swamp the comparison), the heatmap head's last conv scaled by 0.2
   so its logits stay unsaturated; passes of one forward + backward (same
   weights and batch, a freshly seeded dropout generator each), every
   later one taking the first one's top-k proposals and Hungarian targets
   (whether its own match is printed: at random init both flip under
   rounding differences): A through the kernels; B through the plain
   versions, the sparse convs' in float64 rounded once to fp32
   (``sparse_conv_exact``): loss and the proposals' scores within 1e-4
   relative of A; C, A's forward through the kernels and the backward
   through the plain versions: every parameter's gradient within 5e-3
   relative in norm of A's, every parameter has a gradient; B', B with the
   sparse convs in fp32: each of A's gradients within 5e-3 relative in
   norm of B's plus 4 times B' vs B (A and B's gradients differ wherever
   rounding moves an input across a ReLU's or a top-k's tie, and B' shows
   how far each gradient moves so); pass A launches the sparse-conv
   kernel 15 + 14 times (forward, backward-data: the input conv's voxel
   features need no gradient), the weight-gradient kernel 15 times and
   the BEV-pool kernel once, pass C the forward's 15 + 1;
12b. the train steps of nine more configs (``TRAIN_CONFIG_LAUNCHES``: the three seg
   configs, TransFusion-L voxelnet_0p075, PointPillars, the three camera
   CenterHead configs and camera + radar), each at full width, B = 1, with
   64 random boxes or seeded map masks [1, 6, 200, 200] and the depth
   images of ``runtime/flagship.py:add_train_targets``, the head moderated
   (TransFusion's heatmap conv scaled by 0.2, CenterHead's branches by
   ``moderate_head`` on the training forward), held as phase 12 holds the
   flagship, TF32 off: pass A's launches equal ``TRAIN_CONFIG_LAUNCHES``
   (sparse conv 29 and weight gradient 15 where a sparse encoder runs, the
   pool once where a camera does, the NMS never), every loss of A within
   1e-4 of B's, every gradient of A within 5e-3 in norm of C's, the B' gate
   where sparse convs run, the matcher's targets replayed where TransFusion's
   head runs; then 3 timed steps after 1 warmup with TF32 on: ms a step
   (forward, backward, optimizer) and the peak memory;
13. five timed train steps with TF32 on (``tools/bench_train_step.py`` on
   ``runtime/train.py``: AdamW, clip 35, the config's cosine lr with linear
   warmup and cyclic momentum): losses finite, parameters changed; median
   ms/step split into forward, backward and optimizer (host clock around
   synchronises), peak device memory, and the auction matcher's time
   within the forward;
14. the measurement tools (``bevfusion_tpu_torch/tools/``, this path's
   entry points), TF32 on, every launch count set to 0 just before and read
   just after: the memory probes (torch's ``x + 1``, K5, K6 at its five
   settings, both engines, six bf16 matmuls), the cost breakdown (K7) of
   both families at the three shapes with the slab fill, then on the
   flagship held by phase 13 (in eval mode) the
   per-stage profile with FLOPs, the encoder, meta-chain and vtransform
   profiles and the latency benchmark's timing, and two train steps
   through the train-step benchmark; every row finite and every kernel
   launched; then ``python -m bevfusion_tpu_torch.tools.benchmark --iters
   5``, and the same on configs/nuscenes/seg/fusion-bev256d2-lss.yaml, each in
   a subprocess: exit 0 and its latency line;
15. a JSON line with the kernel table (the BEV pool's second shape the seg
   grid, its third the ResNet det configs'; K6's two engines and K7's two
   families each with their ms, plain ms, bound, share and launches; every
   kernel's launches on the seg, det-camera and pillar paths; the NMS
   kernel's row after K1-K7; every kernel's launches in each train step of
   phases 12 and 12b), the seg, det-camera, pillar and train-config results
   and the script's total time, a line with the card's name and
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

from bevfusion_tpu_torch.utils.profiler import (HBM_BYTES_PER_S, TF32_FLOPS, bound, card_line,
                                               frame_ms, nbytes, time_fn)

FP32_RTOL_KERNEL = 1e-4  # kernel vs plain on the card: summation order only
HEATMAP_RTOL = 2e-3  # full model on the card vs on the CPU, ~40 fp32 layers
TRAIN_LOSS_RTOL = 1e-4  # train step through the kernels vs their plain versions
# per parameter, relative in norm: at random init the kernels' fp32
# summation order (~5e-6 on the heatmap) reaches BatchNorm-bias gradients,
# sums over 32,400 BEV cells that nearly cancel, at up to 1.7e-3 on an H100
TRAIN_GRAD_RTOL = 5e-3
ZERO_GRAD = 1e-6  # of the global norm: a gradient that is zero but for rounding
# the forward kernels' effect on a gradient (A vs B) may exceed the gate above
# by this many times how far the same gradient of B moves when B's sparse
# convs turn from float64 to fp32 (B'): where a rounding-level change of the
# forward flips a ReLU or a tie, the gradient jumps by about as much whichever
# conv rounds (the kernel is closer to float64 than cuBLAS fp32, phase 3)
TRAIN_GRAD_SENSITIVITY = 4
SPARSE_LAUNCHES = 15  # 13 submanifold + 2 strided sparse convs at B=1
POOL_LAUNCHES = 1  # one BEV pool per frame at B=1
# launches per eval frame of each map-segmentation config (phase 11)
SEG_LAUNCHES = {"fusion-bev256d2-lss": {"sparse_conv": SPARSE_LAUNCHES, "bev_pool": POOL_LAUNCHES},
                "lidar-centerpoint-bev128": {"sparse_conv": SPARSE_LAUNCHES, "bev_pool": 0},
                "camera-bev256d2": {"sparse_conv": 0, "bev_pool": POOL_LAUNCHES}}
SEG_MASKS = (1, 6, 200, 200)  # six map classes on the 100 m x 100 m, 0.5 m output grid
# launches per eval frame of each camera-only CenterHead config (phase 11b): one
# greedy NMS pass per task group
DET_LAUNCHES = {"sparse_conv": 0, "bev_pool": POOL_LAUNCHES, "greedy_nms": 6}
DECODE_RTOL = 1e-5  # get_bboxes on the card vs the CPU, on the same predictions
TRAIN_LAUNCHES = {"sparse_conv": 15 + 14, "sparse_conv_dw": 15, "bev_pool": 1, "greedy_nms": 0}
# the configs phase 12b trains beside the flagship, in its order (voxelnet.yaml
# differs from voxelnet_0p075.yaml only in its voxel size), and their launches a step
_SPARSE_STEP = {"sparse_conv": 15 + 14, "sparse_conv_dw": 15}
TRAIN_CONFIG_LAUNCHES = {
    "seg-fused": dict(_SPARSE_STEP, bev_pool=1), "seg-lidar": _SPARSE_STEP,
    "seg-camera": {"bev_pool": 1}, "transfusion-l": _SPARSE_STEP, "pointpillars": {},
    "det-swint": {"bev_pool": 1}, "det-resnet": {"bev_pool": 1}, "det-bevdepth": {"bev_pool": 1},
    "camera+radar": {"bev_pool": 1}}
DEVICE = "cuda"
K7_SHAPES = 3  # the cost breakdown runs at the stage-0, 1 and 2 submanifold convs
TOOL_ITERS = 5  # timed calls per op in the tools phase
TOOLS_ABSENT = {"greedy_nms"}  # the tools drive the TransFusion flagship, which has no NMS
SEG_BENCHMARK = "configs/nuscenes/seg/fusion-bev256d2-lss.yaml"  # the tools phase's second CLI run


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def kernel_ms(fn) -> float:
    """Median of 20 CUDA-event timings of ``fn`` after 5 warmup calls, the
    card waiting until the host has queued the 20 (a kernel's time, not its
    wrapper's host time)."""
    return time_fn(fn, iters=20, warmup=5, device=DEVICE, queue_ahead=True)["median_ms"]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)


def sparse_conv_exact(sp):
    """``sparse_conv_plain`` with its gather-GEMM in float64, rounded once to
    fp32 (epilogue after): the train step's plain sparse conv (passes B and
    C). cuBLAS in fp32 is 2e-7 to 2e-6 of scale off float64 at the encoder's
    shapes, 1.2-7x the 3xTF32 kernel (phase 3)."""
    def conv(feats, nbr, weight, scale=None, shift=None, residual=None, relu=False):
        y = sp.sparse_conv_plain(feats.double(), nbr, weight.double()).float()
        return sp._epilogue(y, scale, shift, residual, relu)
    return conv


@contextlib.contextmanager
def plain_kernels(sp, bp, conv=None):
    """Every kernel wrapper replaced by its plain version (on CUDA tensors
    too) for the duration, the sparse conv by ``conv`` where given; the
    wrappers' launch counts are untouched."""
    saved = sp.sparse_conv, sp.sparse_conv_dw, bp.bev_pool
    sp.sparse_conv, sp.sparse_conv_dw, bp.bev_pool = (
        conv or sp.sparse_conv_plain, sp.sparse_conv_dw_plain, bp.bev_pool_plain)
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
def recorded_proposals(head, store):
    """The head's top-k proposals recorded by the first pass and replayed
    to later ones, as ``recorded_targets`` does for the Hungarian targets:
    at random init the peak-filtered heatmap is a near-flat plateau, and a
    top-200 of 324,000 scores swaps near-tied neighbours under rounding
    differences far below the gates (ROADMAP Queue 3, decode ties). Yields
    the list of each later pass's own selection."""
    select, own = head._proposals, []

    def proposals(scores, P):
        top = select(scores, P)
        if "top" not in store:
            store["top"] = top
        else:
            own.append(top)
        return store["top"]

    head._proposals = proposals
    try:
        yield own
    finally:
        del head._proposals


def kernel_cases(enc, feats, coords, mask, sp):
    """The sparse convs of the main path at their real shapes: the sites of
    the encoder ``enc``'s stages 0-2 on the voxelized scan (voxel feats
    [M, 5], coords [M, 3], mask [M]), their rulebooks (the strided convs'
    kernel, stride and padding the encoder's own, and their transposed
    tables), random fp32 operands. Returns (label, (feats, nbr, weight),
    epilogue kwargs, valid output rows, transposed table or None, launches
    of the shape in a train step's weight gradient)."""
    from bevfusion_tpu_torch.models.sparse_encoder import SparseBasicBlock

    s0, s1, s2 = enc.sparse_sites(coords, mask)
    subm = [2 * sum(isinstance(b, SparseBasicBlock) for b in layer)
            for layer in enc.encoder_layers.children()]
    nbr0, nbr1, nbr2 = (sp.build_subm_rulebook(s["ids"], s["grid"]) for s in (s0, s1, s2))

    def strided(a, b):
        geo = (enc.DOWN_KERNEL, enc.DOWN_STRIDE, a["down"][0])
        return (sp.build_conv_rulebook(a["ids"], b["ids"], a["grid"], b["grid"], *geo),
                sp.build_conv_transpose_rulebook(a["ids"], b["ids"], a["grid"], b["grid"], *geo))

    (cnbr0, cnbr0_t), (cnbr1, cnbr1_t) = strided(s0, s1), strided(s1, s2)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    dev = coords.device

    def rand(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    def epi(c, residual_rows=None):
        kw = dict(scale=rand(c, std=0.1) + 1.0, shift=rand(c, std=0.1), relu=True)
        if residual_rows is not None:
            kw["residual"] = rand(residual_rows, c)
        return kw

    cap0, cap1, cap2 = (s["ids"].shape[0] for s in (s0, s1, s2))
    return [
        ("conv_input 5->16", (feats, nbr0, rand(27, 5, 16, std=(2 / 135) ** 0.5)), epi(16),
         mask, None, 1),
        ("stage0 subm 16->16", (rand(cap0, 16), nbr0, rand(27, 16, 16, std=(2 / 432) ** 0.5)),
         epi(16, cap0), mask, None, subm[0]),
        ("stage0 strided 16->32", (rand(cap0, 16), cnbr0, rand(27, 16, 32, std=(2 / 432) ** 0.5)),
         epi(32), s1["mask"], cnbr0_t, 1),
        ("stage1 subm 32->32", (rand(cap1, 32), nbr1, rand(27, 32, 32, std=(2 / 864) ** 0.5)),
         epi(32, cap1), s1["mask"], None, subm[1]),
        ("stage1 strided 32->64", (rand(cap1, 32), cnbr1, rand(27, 32, 64, std=(2 / 864) ** 0.5)),
         epi(64), s2["mask"], cnbr1_t, 1),
        ("stage2 subm 64->64", (rand(cap2, 64), nbr2, rand(27, 64, 64, std=(2 / 1728) ** 0.5)),
         epi(64, cap2), s2["mask"], None, subm[2]),
    ]


def run_model(label, model, batch, cpu_model, cpu_batch, counters, want_launches):
    """One eval forward with every launch counter set to 0 just before and
    read just after; then the box checks, the heatmap against the CPU model
    and the frame time. Returns (launches, heatmap rel err, frames, peak)."""
    with torch.no_grad():
        torch.cuda.synchronize()
        zero_counts(counters)
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


def beside_scalar_loop(kv, sp, feats, nbr, w):
    """The sparse-conv kernel without epilogue and the scalar loop (K7
    ``current`` at tile 64) on the same operands, timed in turns (scalar,
    kernel, kernel, scalar): (kernel ms, scalar ms), each the mean of its
    two medians."""
    runs = {"kernel": lambda: sp.sparse_conv(feats, nbr, w),
            "scalar": lambda: kv.sparse_conv_variant(feats, nbr, w, "current", 64)}
    ms = {k: 0.0 for k in runs}
    for k in ("scalar", "kernel", "kernel", "scalar"):
        ms[k] += kernel_ms(runs[k]) / 2
    return ms["kernel"], ms["scalar"]


def vs_float64(kv, sp, feats, nbr, w, valid):
    """max|d| / max(|ref|, 1) on the valid rows against the conv in float64
    on the card, without epilogue: the kernel (3xTF32), the scalar loop (fp32
    FMA) and the plain version (cuBLAS fp32)."""
    ref = sp.sparse_conv_plain(feats.double(), nbr, w.double())[valid]
    scale = max(ref.abs().max().item(), 1.0)
    got = {"kernel": sp.sparse_conv(feats, nbr, w),
           "scalar loop": kv.sparse_conv_variant(feats, nbr, w, "current", 64),
           "cuBLAS fp32": sp.sparse_conv_plain(feats, nbr, w)}
    return {k: (v.double()[valid] - ref).abs().max().item() / scale for k, v in got.items()}


def sparse_kernel_phases(sp, kv, cases):
    """Phases 3-5 at each shape: forward, weight gradient and backward-data
    against their plain versions; times and bounds, the forward and
    backward-data beside the scalar loop. Returns three lists of per-shape
    records."""
    fwd, dw, bwd = [], [], []
    for label, (feats, nbr, w), kw, valid, nbr_t, step_launches in cases:
        K, Cin, Cout = w.shape
        hits = int((nbr >= 0).sum())
        got = sp.sparse_conv(feats, nbr, w, **kw)
        want = sp.sparse_conv_plain(feats, nbr, w, **kw)
        torch.cuda.synchronize()
        err = (got - want)[valid].abs().max().item()
        scale = max(want[valid].abs().max().item(), 1.0)
        check(err <= FP32_RTOL_KERNEL * scale, f"{label}: max|d| {err} vs plain, scale {scale}")
        # 3xTF32: three TF32 products on the tensor cores per useful multiply-add
        moved = nbytes(feats, nbr, w, got, *(v for v in kw.values() if torch.is_tensor(v)))
        b_ms, b_by = bound(3 * 2 * hits * Cin * Cout, moved, TF32_FLOPS)
        fma_ms, fma_by = bound(2 * hits * Cin * Cout, moved)  # the scalar kernel's: fp32 FMA
        ms = kernel_ms(lambda: sp.sparse_conv(feats, nbr, w, **kw))
        plain_ms = kernel_ms(lambda: sp.sparse_conv_plain(feats, nbr, w, **kw))
        bare_ms, scalar_ms = beside_scalar_loop(kv, sp, feats, nbr, w)
        f64 = vs_float64(kv, sp, feats, nbr, w, valid)
        fwd.append({"shape": label, "sites_out": nbr.shape[1], "valid_out": int(valid.sum()),
                    "hits": hits, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "bound_fp32_fma_ms": fma_ms,
                    "ms_no_epilogue": bare_ms, "scalar_loop_ms": scalar_ms,
                    "scalar_over_new": scalar_ms / bare_ms, "rel_err_vs_float64": f64})
        print(f"kernel sparse_conv {label}: {int(valid.sum())} of {nbr.shape[1]} output sites, "
              f"{hits} hit pairs, max|d| {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}; fp32 FMA {fma_ms:.4f} ms, {fma_by}), "
              f"{b_ms / ms:.3f} of bound; without epilogue {bare_ms:.4f} ms vs the scalar "
              f"loop {scalar_ms:.4f} ms in this run: "
              f"{scalar_ms / bare_ms:.2f}x; max|d| / max(|f64|, 1) vs float64 (no epilogue): "
              + ", ".join(f"{k} {v:.2e}" for k, v in f64.items()))

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
        # 3xTF32, as phase 3: three TF32 products per useful multiply-add
        moved = nbytes(feats, nbr, dout, got)
        b_ms, b_by = bound(3 * 2 * hits * Cin * Cout, moved, TF32_FLOPS)
        fma_ms, fma_by = bound(2 * hits * Cin * Cout, moved)
        ms = kernel_ms(lambda: sp.sparse_conv_dw(feats, nbr, dout))
        plain_ms = kernel_ms(lambda: sp.sparse_conv_dw_plain(feats, nbr, dout))
        ref = sp.sparse_conv_dw_plain(feats.double(), nbr, dout.double())
        ref_scale = max(ref.abs().max().item(), 1.0)
        f64 = {"kernel": (got.double() - ref).abs().max().item() / ref_scale,
               "plain (cuBLAS fp32)": (want.double() - ref).abs().max().item() / ref_scale}
        over_fwd = ms / fwd[-1]["ms_no_epilogue"]
        dw.append({"shape": label, "hits": hits, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "bound_fp32_fma_ms": fma_ms, "rel_err_vs_float64": f64,
                   "over_forward_no_epilogue": over_fwd, "step_launches": step_launches})
        print(f"kernel sparse_conv_dw {label}: {hits} hit pairs, max|d| {err:.3e}, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; fp32 FMA "
              f"{fma_ms:.4f} ms, {fma_by}), {b_ms / ms:.3f} of bound; {over_fwd:.2f}x the "
              f"forward without epilogue in this run; {step_launches} a step; max|d| / "
              f"max(|f64|, 1) vs float64: " + ", ".join(f"{k} {v:.2e}" for k, v in f64.items()))

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
        ms, scalar_ms = beside_scalar_loop(kv, sp, dout, table, wt)
        bwd.append({"shape": label, "max_abs_err": err, "ms": ms, "scalar_loop_ms": scalar_ms,
                    "scalar_over_new": scalar_ms / ms})
        print(f"kernel sparse_conv backward-data {label}: max|d| {err:.3e} vs autograd of "
              f"plain, kernel {ms:.4f} ms vs the scalar loop {scalar_ms:.4f} ms in this run: "
              f"{scalar_ms / ms:.2f}x")
    return fwd, dw, bwd


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(torch.int16),
                                                                      b.view(torch.int16))


def tile_probe_checks(tm):
    """Phase 6: K5 at [65536, 1024] bf16 and K6 at the tool's five
    settings, each equal to its plain version bit for bit. Returns the
    max|d| of each (0 when equal)."""
    x = torch.randn(65536, 1024, generator=torch.Generator(device=DEVICE).manual_seed(0),
                    device=DEVICE).to(torch.bfloat16)
    got, want = tm.copy_add_one(x), tm.copy_add_one_plain(x)
    torch.cuda.synchronize()
    check(bits_equal(got, want), "K5 copy_add_one: not equal to x + 1 bit for bit")
    errs = {"copy": (got.float() - want.float()).abs().max().item()}
    print(f"kernel tile_copy (K5) [65536, 1024] bf16: equal to x + 1 bit for bit")
    for T, R, G, steps in tm.GATHERS:
        pool, slots = tm.gather_inputs(T, R, G, steps, DEVICE)
        want = tm.gather_tiles_plain(pool, slots, R, G)
        errs[(R, G)] = 0.0
        for engine in tm.ENGINES:
            got = tm.gather_tiles(pool, slots, R, G, engine)
            torch.cuda.synchronize()
            check(bits_equal(got, want),
                  f"K6 gather_tiles {engine} R={R} G={G}: not equal to plain")
            errs[(R, G)] = max(errs[(R, G)], (got.float() - want.float()).abs().max().item())
        print(f"kernel tile_gather (K6) R={R} G={G} steps={steps} T={T}: both engines "
              f"{tm.ENGINES} equal to plain bit for bit")
    return errs


def variant_checks(kv, sp, cases):
    """Phase 7: K7's two families against their plain versions (max|d| <=
    1e-4 * max(|plain|, 1)). The scalar family's four modes at both tiles,
    ``noskip`` equal to ``current`` bit for bit, and ``current`` at tile 64
    (the scalar loop) within the same 1e-4 of ``sparse_conv`` with no
    epilogue (the tensor-core kernel). The tensor-core family's five modes
    (K1/K2's loop), ``tc`` equal to ``sparse_conv`` with no epilogue and
    ``tc_noskip`` to ``tc``, bit for bit; ``tc_1xtf32``'s max|d| from the
    fp32 plain conv. Returns {(shape, mode): (max|d| over the tiles, plain
    ms)} and {shape: tc_1xtf32's max|d| / max(|plain|, 1)}."""
    out, one_tf32 = {}, {}
    for label, feats, nbr, w in cases:
        new = sp.sparse_conv(feats, nbr, w)
        for mode in kv.MODES + kv.TC_MODES:
            want = kv.sparse_conv_variant_plain(feats, nbr, w, mode)
            scale = max(want.abs().max().item(), 1.0)
            tiles = kv.TILES if mode in kv.MODES else (kv.TC_TILE,)
            errs = []
            for tile in tiles:
                got = kv.sparse_conv_variant(feats, nbr, w, mode, tile)
                torch.cuda.synchronize()
                errs.append((got - want).abs().max().item())
                check(errs[-1] <= FP32_RTOL_KERNEL * scale,
                      f"K7 {label} {mode} tile {tile}: max|d| {errs[-1]} vs plain, scale {scale}")
                if mode == "current" and tile == 64:
                    d = (got - new).abs().max().item()
                    check(d <= FP32_RTOL_KERNEL * scale,
                          f"K7 {label}: current at tile 64 vs sparse_conv max|d| {d}")
                if mode == "noskip":
                    check(torch.equal(got, kv.sparse_conv_variant(feats, nbr, w, "current", tile)),
                          f"K7 {label}: noskip differs from current at tile {tile}")
                if mode == "tc":
                    check(torch.equal(got, new), f"K7 {label}: tc differs from sparse_conv")
                if mode == "tc_noskip":
                    check(torch.equal(got, kv.sparse_conv_variant(feats, nbr, w, "tc")),
                          f"K7 {label}: tc_noskip differs from tc")
                if mode == "tc_1xtf32":
                    exact = kv.sparse_conv_variant_plain(feats, nbr, w, "tc")
                    one_tf32[label] = ((got - exact).abs().max().item()
                                       / max(exact.abs().max().item(), 1.0))
            plain_ms = kernel_ms(lambda: kv.sparse_conv_variant_plain(feats, nbr, w, mode))
            out[(label, mode)] = (max(errs), plain_ms)
            print(f"kernel sparse_conv_variants (K7) {label} {mode}: max|d| {max(errs):.3e} at "
                  f"tiles {tiles}, plain {plain_ms:.4f} ms")
        print(f"kernel sparse_conv_variants (K7) {label}: current at tile 64 (the scalar loop) "
              f"within {FP32_RTOL_KERNEL:g} of sparse_conv without epilogue, noskip equal to "
              f"current bit for bit; tc equal to sparse_conv without epilogue and tc_noskip to "
              f"tc bit for bit; tc_1xtf32 max|d| / max(|fp32 plain|, 1) {one_tf32[label]:.3e}")
    return out, one_tf32


def zero_counts(counters) -> None:
    """Every count of each wrapper to 0: ``launches`` and, where a wrapper
    splits it (K6 by engine, K7 by family), each part."""
    for c in counters.values():
        c.launches = 0
        for name in ("launches_by_engine", "launches_by_family"):
            if hasattr(c, name):
                getattr(c, name).update(dict.fromkeys(getattr(c, name), 0))


def finite_rows(rows, what: str, keys=("ms",)) -> None:
    for r in rows:
        for k in keys:
            v = r.get(k)
            check(v is None or math.isfinite(v), f"{what}: {r} has a non-finite {k}")


def tools_phase(cfg, model, batch, cases, counters):
    """Phase 14: the measurement tools, this path's entry points, with every
    launch count set to 0 just before and read just after. Returns (their
    results, the launches, K6's by engine and K7's by family)."""
    from bevfusion_tpu_torch.tools import (bench_kernel_variants as kv, bench_tile_micro as tm,
                                           bench_train_step, benchmark, profile_encoder,
                                           profile_meta, profile_stages, profile_vtransform)

    torch.cuda.synchronize()
    zero_counts(counters)
    t0 = time.perf_counter()
    res = {"ew": tm.bench_ew(DEVICE), "copy": tm.bench_copy(device=DEVICE),
           "gathers": [tm.bench_gather(*g, device=DEVICE) for g in tm.GATHERS],
           "matmuls": [tm.bench_matmul(*m, device=DEVICE) for m in tm.MATMULS],
           "breakdown": kv.breakdown(cases, DEVICE)}
    model.eval()
    res["stages"], _ = profile_stages.profile_stages(model, batch, DEVICE, TOOL_ITERS,
                                                     flops=True)
    with torch.no_grad():
        vox = model.lidar_voxelize(batch["points"], batch["points_mask"])
        enc = model.encoders["lidar"]["backbone"]
        res["encoder"], _ = profile_encoder.profile_encoder(
            enc, vox.feats[0], vox.coords[0], vox.mask[0], DEVICE, TOOL_ITERS)
        res["meta"] = profile_meta.profile_meta(enc, vox.coords[0], vox.mask[0], DEVICE,
                                                TOOL_ITERS)
        cam, img = model.encoders["camera"], batch["img"]
        feats = cam["neck"](cam["backbone"](img.reshape(-1, *img.shape[2:])))[0]
        res["vtransform"], _ = profile_vtransform.profile_vtransform(
            cam["vtransform"], feats.view(*img.shape[:2], *feats.shape[1:]), batch, DEVICE,
            TOOL_ITERS)
        res["latency"] = benchmark.latency(model, batch, DEVICE, TOOL_ITERS, warmup=2)
    res["train"] = bench_train_step.train_steps(cfg, model, batch, DEVICE, steps=2, warmup=1)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    parts = {"tile_gather": dict(tm.gather_tiles.launches_by_engine),
             "sparse_conv_variants": dict(kv.sparse_conv_variant.launches_by_family)}
    res["seconds"] = time.perf_counter() - t0
    print(f"tools: launches in the tools' run {launches}; K6 by engine {parts['tile_gather']}, "
          f"K7 by family {parts['sparse_conv_variants']}; {res['seconds']:.1f} s")
    for name, n in launches.items():
        if name in TOOLS_ABSENT:
            check(n == 0, f"tools: the kernel {name} was launched {n} times")
        else:
            check(n > 0, f"tools: the kernel {name} was not launched")
    for name, by in parts.items():
        for part, n in by.items():
            check(n > 0, f"tools: the kernel {name} {part} was not launched")

    print(f"tools: torch x + 1 on 128 MiB bf16 {res['ew']['ms']:.4f} ms, "
          f"{res['ew']['gb_per_s']:.1f} GB/s")
    c = res["copy"]
    print(f"tools: K5 {c['shape']} {c['ms']:.4f} ms ({c['gb_per_s']:.1f} GB/s), bound "
          f"{c['bound_ms']:.4f} ms = {c['bound_ms'] / c['ms']:.3f} of it; torch x + 1 "
          f"{c['library_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms")
    for r in res["gathers"]:
        tm.print_gather(r, "tools: K6")
    for r in res["matmuls"]:
        print(f"tools: matmul bf16 {r['shape']}: {r['ms']:.4f} ms, {r['tflops']:.1f} TFLOP/s "
              f"({r['peak_share']:.3f} of 989)")
    kv.print_breakdown(res["breakdown"])
    profile_stages.print_table(res["stages"], flops=True)
    print(f"tools: the stages' peak: {profile_stages.peak_flops()[1]}")
    profile_meta.print_rows(res["encoder"])
    profile_meta.print_rows(res["meta"])
    profile_meta.print_rows(res["vtransform"])
    for what in ("encoder", "meta", "vtransform"):
        finite_rows(res[what], what)
    finite_rows(res["stages"], "stages", ("ms", "gflop", "tflops"))
    finite_rows([res["ew"], res["copy"]] + res["gathers"] + res["matmuls"], "probes")
    finite_rows([m for r in res["breakdown"] for m in r["modes"].values()], "breakdown")
    lat = res["latency"]
    check(math.isfinite(lat["mean_ms"]), f"benchmark latency {lat}")
    print(f"tools: benchmark latency (TF32 on) {lat['mean_ms']:.2f} ms mean, "
          f"{lat['median_ms']:.2f} median over {len(lat['frames_ms'])} frames")
    line = bench_train_step.result_line(res["train"])
    check(math.isfinite(line["value"]) and not res["train"]["unchanged"],
          f"bench_train_step: {line}, unchanged {res['train']['unchanged'][:5]}")
    print(f"tools: bench_train_step {json.dumps(line)}")

    for config in (None, SEG_BENCHMARK):
        args = ["--iters", "5"] if config is None else [config, "--iters", "5"]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "bevfusion_tpu_torch.tools.benchmark", *args],
                              capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        out = proc.stdout.strip().splitlines()
        print(f"tools: python -m bevfusion_tpu_torch.tools.benchmark {' '.join(args)}: exit "
              f"{proc.returncode} in {time.perf_counter() - t0:.1f} s: {out[-1] if out else ''}")
        check(proc.returncode == 0 and out and out[-1].startswith("latency:"),
              f"benchmark CLI {args}: exit {proc.returncode}, {proc.stderr[-2000:]}")
        res["benchmark_cli" if config is None else "benchmark_cli_seg"] = out[-1]
    return res, launches, parts


def pool_case(label, bp, vt, lut):
    """The BEV-pool kernel against its plain version on the intervals of
    ``lut`` (the pooling LUT of the vtransform ``vt``'s grid for the six-camera
    rig): depth (softmax of seeded noise) and ctx (held channels-last) at
    ``vt``'s frustum; max|d| <= 1e-4 * max(|plain|, 1), both median times and
    the bound; where the time goes: the wrapper's zero fill of the grid
    alone, the kernel on the intervals of at most 64 points alone and on all
    of them longest first (the LUT's cell order puts long intervals
    anywhere); the interval lengths, and how many distinct (cell, ctx row)
    pairs they hold against P. Returns (the kernel table's shape entry,
    (depth, ctx, output, intervals))."""
    iv = bp.PoolIntervals(*(lut[k] for k in bp.PoolIntervals._fields))
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
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1.0)
    check(got.shape == (1, Z * vt.C, X, Y), f"bev_pool {label}: shape {tuple(got.shape)}")
    check(err <= FP32_RTOL_KERNEL * scale, f"bev_pool {label}: max|d| {err} vs plain, scale {scale}")
    ms = kernel_ms(lambda: bp.bev_pool(depth, ctx, iv, Z, X, Y))
    plain_ms = kernel_ms(lambda: bp.bev_pool_plain(depth, ctx, iv, Z, X, Y))
    zero_ms = kernel_ms(lambda: torch.zeros((Z * X * Y, vt.C), device=DEVICE))
    by_length = torch.argsort(iv.interval_lengths, descending=True, stable=True)
    short = iv.interval_lengths <= 64
    split = {}
    for key, sel in (("longest_first_ms", by_length), ("short_only_ms", short)):
        part = bp.PoolIntervals(iv.ranks_depth, iv.ranks_feat,
                                *(t[sel].contiguous() for t in iv[2:]))
        split[key] = kernel_ms(lambda: bp.bev_pool(depth, ctx, part, Z, X, Y))
    # each input byte once (the P pooled depth values, the whole ctx table,
    # the interval arrays), the zero-filled output grid once; a multiply-add
    # per pooled point and channel
    b_ms, b_by = bound(2 * P * vt.C, 4 * P + nbytes(ctx, got, *iv))
    lengths = iv.interval_lengths.float()
    stats = {"mean": lengths.mean().item(), "p99": lengths.quantile(0.99).item(),
             "max": int(lengths.max().item())}
    # distinct ctx rows a cell reads: what a pool that reads each (cell,
    # ctx row) once would gather, against the P rows gathered now
    cell_of_point = torch.repeat_interleave(iv.interval_cells.long(), iv.interval_lengths.long())
    pairs = torch.unique(cell_of_point * (ctx.numel() // vt.C) + iv.ranks_feat.long()).numel()
    print(f"kernel bev_pool {label} ({X}x{Y} cells): P {P} of {depth.numel()} frustum points in "
          f"the grid, R {R} intervals (length mean {stats['mean']:.2f}, p99 {stats['p99']:.0f}, "
          f"max {stats['max']}); {pairs} distinct (cell, ctx row) pairs = {pairs / P:.4f} of P; "
          f"max|d| {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), {b_ms / ms:.3f} of bound; the wrapper's zero fill alone {zero_ms:.4f} ms; "
          f"the same call with the intervals longest first {split['longest_first_ms']:.4f} ms, on "
          f"the {int(short.sum())} intervals of <= 64 points "
          f"({int(iv.interval_lengths[short].sum())} points) alone {split['short_only_ms']:.4f} ms")
    entry = {"shape": f"{label} [1,6,{D},{fH},{fW}] x [1,6,{fH},{fW},{vt.C}] -> {X}x{Y}",
             "points": P, "intervals": R, "interval_lengths": stats,
             "distinct_cell_ctx_pairs": pairs, "zero_fill_ms": zero_ms, **split,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": b_by}
    return entry, (depth, ctx, got, iv)


def frame_profile(model, batch):
    """ms/frame (median of 20), peak memory and the stages
    (``tools/profile_stages.py``, median of 5) with TF32 off, then on; TF32
    off again after."""
    from bevfusion_tpu_torch.tools import profile_stages

    out = {}
    for suffix, tf32 in (("", False), ("_tf32", True)):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        with torch.no_grad():
            frames, peak = frame_ms(lambda: model(batch))
        out["frame_ms_median" + suffix] = statistics.median(frames)
        out["peak_mem_bytes" + suffix] = peak
        out["stage_ms" + suffix] = {
            r["stage"]: r["ms"]
            for r in profile_stages.profile_stages(model, batch, DEVICE, iters=5)[0]}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return out


def seg_phase(counters, bp):
    """Phase 11: each map-segmentation config's eval forward on the card,
    with every launch count set to 0 just before and read just after; its
    masks, its classifier's logits against the CPU model's, its frame time,
    peak memory and stages with TF32 off and on; then the pool kernel at the
    seg grid. Returns ({config: results}, the pool's shape entry)."""
    from bevfusion_tpu_torch.runtime.flagship import SEG_CONFIGS, batch_to, build_flagship

    def forward(model, batch):
        logits = []
        hook = model.heads["map"].classifier.register_forward_hook(
            lambda mod, args, out: logits.append(out))
        with torch.no_grad():
            masks = model(batch)["masks_bev"]
        hook.remove()
        return masks, logits[0]

    res, pool_entry = {}, None
    for name, want in SEG_LAUNCHES.items():
        t0 = time.perf_counter()
        _, cpu_model, cpu_batch = build_flagship("cpu", num_points=120000, seed=0,
                                                 config_path=SEG_CONFIGS[name])
        model, batch = copy.deepcopy(cpu_model).cuda(), batch_to(cpu_batch, "cuda")
        want = dict({k: 0 for k in counters}, **want)
        torch.cuda.synchronize()
        zero_counts(counters)
        masks, logits = forward(model, batch)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        check(launches == want, f"seg {name}: launches {launches}, want {want}")
        check(tuple(masks.shape) == SEG_MASKS, f"seg {name}: masks_bev {tuple(masks.shape)}")
        check(bool(torch.isfinite(masks).all()) and masks.min() >= 0 and masks.max() <= 1,
              f"seg {name}: masks_bev not finite in [0, 1]")
        t_cpu = time.perf_counter()
        _, cpu_logits = forward(cpu_model, cpu_batch)
        cpu_s = time.perf_counter() - t_cpu
        err = rel_err(logits.cpu(), cpu_logits)
        check(err <= HEATMAP_RTOL, f"seg {name}: logits rel err {err} > {HEATMAP_RTOL}")
        r = {"launches": launches, "logits_rel_err": err, "masks_mean": masks.mean().item(),
             "logits_std": logits.std().item(), "cpu_forward_s": cpu_s}
        r.update(frame_profile(model, batch))
        if pool_entry is None and "pool_lut" in batch:
            pool_entry, _ = pool_case("seg", bp, model.encoders["camera"]["vtransform"],
                                      batch["pool_lut"])
        r["seconds"] = time.perf_counter() - t0
        res[name] = r
        print(f"seg {name}: launches {launches}; masks_bev {tuple(masks.shape)} mean "
              f"{r['masks_mean']:.4f}; logits (std {r['logits_std']:.3f}) vs the CPU plain path: "
              f"rel err {err:.3e} (CPU forward {cpu_s:.1f} s); {r['frame_ms_median']:.2f} "
              f"ms/frame median, peak {r['peak_mem_bytes'] / 2**20:.1f} MiB; TF32 on "
              f"{r['frame_ms_median_tf32']:.2f} ms, peak {r['peak_mem_bytes_tf32'] / 2**20:.1f} "
              f"MiB; {r['seconds']:.1f} s")
        for key in ("stage_ms", "stage_ms_tf32"):
            print(f"seg {name} stages, {key}: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in r[key].items()))
        del model, batch, cpu_model, cpu_batch, masks, logits, cpu_logits
        torch.cuda.empty_cache()
    return res, pool_entry


def moderate_head(model, batch) -> None:
    """Each CenterHead branch's last conv scaled and shifted per output
    channel so that its maps on ``batch`` take ``DET_HEAD_MODERATE``'s mean and std:
    the same model up to an affine map of each output channel. At random
    init the maps run to 1e4 (the camera backbone's residual sums), where
    every box falls outside the post-center range or overflows ``exp``."""
    from bevfusion_tpu_torch.runtime.flagship import DET_HEAD_MODERATE

    with torch.no_grad():
        preds = model.predict(batch)
        for pred, head in zip(preds, model.heads["object"].task_heads):
            for name, (mean, std) in DET_HEAD_MODERATE.items():
                last, y = getattr(head, name)[-1], pred[name].double()
                a = std / y.std(dim=(0, 2, 3))
                last.weight.mul_(a[:, None, None, None].float())
                last.bias.copy_((a * (last.bias.double() - y.mean(dim=(0, 2, 3))) + mean).float())


def max_sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi``'s ``clocks.max.sm``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def nms_kernel_cases(nms, frames):
    """The NMS kernel against ``greedy_suppress_plain`` bit for bit on every
    (label, suppression matrix, order) of ``frames`` and on four made ones
    (P = 1): random at N = 500, everything suppressed, nothing suppressed,
    random at N = 1000 (``pre_max_size``). The timed shapes: the first six
    of ``frames`` (one frame's tasks) and the made ones, each with its
    kernel and plain times and its bound: the larger of the bytes (the
    matrix, the order and the keep mask once) over the memory rate and the
    N dependent steps of the pass at one SM clock each (``operations``).
    Returns (the kernel table's shape entries, the number of matrices held)."""
    g = torch.Generator(device=DEVICE).manual_seed(0)

    def made(n, density):
        sup = torch.rand(1, n, n, generator=g, device=DEVICE) < density
        return sup, torch.randperm(n, generator=g, device=DEVICE)[None]

    cases = list(frames) + [("made random N=500", *made(500, 0.02)),
                            ("made all suppressed N=500", *made(500, 1.0)),
                            ("made none suppressed N=500", *made(500, 0.0)),
                            ("made random N=1000", *made(1000, 0.01))]
    clock = max_sm_clock_hz()
    shapes = []
    for i, (label, sup, order) in enumerate(cases):
        got = nms.greedy_suppress(sup, order)
        want = nms.greedy_suppress_plain(sup, order)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"NMS kernel {label}: keep mask differs from plain")
        if i >= 6 and i < len(frames):
            continue
        P, N = order.shape
        ms = kernel_ms(lambda: nms.greedy_suppress(sup, order))
        plain_ms = time_fn(lambda: nms.greedy_suppress_plain(sup, order), iters=5, warmup=1,
                           device=DEVICE)["median_ms"]
        b_bytes = nbytes(sup, order, got) / HBM_BYTES_PER_S * 1e3
        b_steps = N / clock * 1e3
        shapes.append({"shape": f"{label} [{P},{N},{N}]", "kept": int(got.sum()),
                       "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": max(b_bytes, b_steps),
                       "bound_by": "bytes" if b_bytes >= b_steps else "operations"})
        r = shapes[-1]
        print(f"kernel greedy_nms {r['shape']}: {r['kept']} kept, equal to plain bit for bit; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}: bytes {b_bytes:.5f}, {N} steps at {clock / 1e6:.0f} MHz "
              f"{b_steps:.5f}), {r['bound_ms'] / ms:.4f} of bound")
    return shapes, len(cases)


def decode_trace(head, preds):
    """``head.get_bboxes(preds)`` on the card: its wall time (host clock
    around a synchronised call, after one warmup), then the same call once
    under ``torch.profiler``: the card's activities (kernels, copies), their
    summed device time, the NMS kernel's part of it, the share of the wall
    time the card is idle, and the five kernel names with the most device
    time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        head.get_bboxes(preds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        head.get_bboxes(preds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            head.get_bboxes(preds)
            torch.cuda.synchronize()
    acts = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in acts) / 1e3
    by_name = {}
    for e in acts:
        n, ms = by_name.get(e.name[:90], (0, 0.0))
        by_name[e.name[:90]] = (n + 1, ms + e.device_time / 1e3)
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:5]
    return {"wall_ms": wall_ms, "device_activities": len(acts), "device_busy_ms": busy_ms,
            "nms_kernel_ms": sum(e.device_time for e in acts if "greedy_suppress" in e.name) / 1e3,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "top": [{"name": k, "count": n, "ms": ms} for k, (n, ms) in top]}


def det_forward(model, batch):
    """(decoded boxes, every task's raw maps) of one eval forward."""
    maps = []
    hook = model.heads["object"].register_forward_hook(lambda mod, args, out: maps.append(out))
    with torch.no_grad():
        boxes = model(batch)["boxes"]
    hook.remove()
    return boxes, maps[0]


def det_frame(label, path, counters, want):
    """One CenterHead config's eval forward on the card (its head moderated
    first), with every launch count set to 0 just before and read just
    after (``want`` the counts a frame must show); its raw head maps against
    the CPU model's; ``get_bboxes`` on the card and the CPU on the same
    predictions; the decode traced; its frame time, peak memory and stages
    with TF32 off and on. Returns (results, the suppression matrices of its
    NMS passes, the card's model, its batch)."""
    from bevfusion_tpu_torch.runtime.flagship import batch_to, build_flagship

    t0 = time.perf_counter()
    _, cpu_model, cpu_batch = build_flagship("cpu", num_points=120000, seed=0, config_path=path)
    moderate_head(cpu_model, cpu_batch)
    model, batch = copy.deepcopy(cpu_model).cuda(), batch_to(cpu_batch, "cuda")
    want = dict({k: 0 for k in counters}, **want)
    torch.cuda.synchronize()
    zero_counts(counters)
    boxes, maps = det_forward(model, batch)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    check(launches == want, f"{label}: launches {launches}, want {want}")
    t_cpu = time.perf_counter()
    cpu_boxes, cpu_maps = det_forward(cpu_model, cpu_batch)
    cpu_s = time.perf_counter() - t_cpu
    map_err = max(rel_err(m[k].cpu(), c[k]) for m, c in zip(maps, cpu_maps) for k in c)
    check(len(maps) == 6 and map_err <= HEATMAP_RTOL,
          f"{label}: head maps rel err {map_err} > {HEATMAP_RTOL}")
    # the decode on the card and on the CPU, on the same (the CPU model's) maps
    same = [{k: v.cuda() for k, v in m.items()} for m in cpu_maps]
    with torch.no_grad():
        dec = model.heads["object"].get_bboxes(same)
        sups = model.heads["object"].suppressions(same)  # what get_bboxes's NMS passes took
    keep = cpu_boxes["mask"]
    check(torch.equal(dec["mask"].cpu(), keep) and torch.equal(dec["labels"].cpu(),
                                                                 cpu_boxes["labels"]),
          f"{label}: keep masks or labels differ from the CPU's")
    box_err = rel_err(dec["bboxes"].cpu()[keep], cpu_boxes["bboxes"][keep])
    score_err = rel_err(dec["scores"].cpu(), cpu_boxes["scores"])
    check(box_err <= DECODE_RTOL and score_err <= DECODE_RTOL,
          f"{label}: decode rel err boxes {box_err}, scores {score_err}")
    trace = decode_trace(model.heads["object"], same)
    check(trace["device_activities"] > 0 and 0.0 < trace["nms_kernel_ms"] < trace["wall_ms"],
          f"{label}: decode trace {trace}")
    kept = boxes["mask"]
    check(int(keep.sum()) > 0 and bool(torch.isfinite(dec["bboxes"][dec["mask"]]).all())
          and bool(torch.isfinite(boxes["bboxes"][kept]).all()),
          f"{label}: no box kept, or a kept box not finite")
    r = {"launches": launches, "head_maps_rel_err": map_err, "decode_boxes_rel_err": box_err,
         "decode_scores_rel_err": score_err, "kept_same_predictions": int(keep.sum()),
         "kept_own_forward": int(kept.sum()),
         "kept_per_task": keep.view(6, -1).sum(1).tolist(), "cpu_forward_s": cpu_s,
         "decode_trace": trace}
    r.update(frame_profile(model, batch))
    r["seconds"] = time.perf_counter() - t0
    print(f"{label}: launches {launches}; head maps vs the CPU plain path: rel err "
          f"{map_err:.3e} (CPU forward {cpu_s:.1f} s); decode on the same predictions: equal "
          f"keep masks ({r['kept_same_predictions']} kept, per task {r['kept_per_task']}), "
          f"boxes rel err {box_err:.3e}, scores {score_err:.3e}; {r['kept_own_forward']} kept "
          f"in the card's own frame; {r['frame_ms_median']:.2f} ms/frame median, peak "
          f"{r['peak_mem_bytes'] / 2**20:.1f} MiB; TF32 on {r['frame_ms_median_tf32']:.2f} "
          f"ms, peak {r['peak_mem_bytes_tf32'] / 2**20:.1f} MiB; {r['seconds']:.1f} s")
    for key in ("stage_ms", "stage_ms_tf32"):
        print(f"{label} stages, {key}: " + ", ".join(f"{k} {v:.2f}" for k, v in r[key].items()))
    print(f"{label} decode (get_bboxes, TF32 off): {trace['wall_ms']:.2f} ms wall; traced: "
          f"{trace['device_activities']} kernels and copies on the card, "
          f"{trace['device_busy_ms']:.3f} ms busy (the NMS kernel "
          f"{trace['nms_kernel_ms']:.3f}), idle {100 * trace['idle_share']:.1f}% of the wall; "
          f"most device time: " + "; ".join(f"{t['name']} x{t['count']} {t['ms']:.3f} ms"
                                            for t in trace["top"]))
    return r, [(f"{label} task {t}", sup, order) for t, (sup, order) in enumerate(sups)], \
        model, batch


def det_phase(counters, bp, nms):
    """Phase 11b: each camera-only CenterHead config's frame (``det_frame``);
    then the NMS kernel alone on the frames' suppression matrices and four
    made ones, and the pool kernel at the ResNet configs' shape. Returns
    ({config: results}, the NMS kernel's shape entries, the pool's shape
    entry)."""
    from bevfusion_tpu_torch.runtime.flagship import DET_CAMERA_CONFIGS

    res, frames, pool_entry = {}, [], None
    for name, path in DET_CAMERA_CONFIGS.items():
        res[name], sups, model, batch = det_frame(f"det {name}", path, counters, DET_LAUNCHES)
        frames += sups
        if name == "resnet":
            pool_entry, _ = pool_case("det resnet", bp, model.encoders["camera"]["vtransform"],
                                      batch["pool_lut"])
        del model, batch, sups
        torch.cuda.empty_cache()
    nms_shapes, held = nms_kernel_cases(nms, frames)
    print(f"kernel greedy_nms: {held} suppression matrices equal to plain bit for bit")
    return res, nms_shapes, pool_entry


def pillar_phase(counters):
    """Phase 11c: PointPillars' eval frame (``run_model``: launches, boxes,
    heatmap against the CPU model) with its pillar counts, frame time, peak
    memory and stages with TF32 off and on; camera + radar CenterHead's frame
    (``det_frame``); dlss.yaml's refusal. Returns {config: results}."""
    from bevfusion_tpu_torch.config import load_config
    from bevfusion_tpu_torch.models import build_model
    from bevfusion_tpu_torch.runtime.flagship import (DLSS_CONFIG, PILLAR_CONFIGS, batch_to,
                                                      build_flagship)

    t0 = time.perf_counter()
    cfg, cpu_model, cpu_batch = build_flagship("cpu", num_points=120000, seed=0,
                                               config_path=PILLAR_CONFIGS["pointpillars"])
    vox = cpu_model.lidar_voxelize(cpu_batch["points"], cpu_batch["points_mask"])
    cap = cfg.model.encoders.lidar.voxelize.max_num_points
    pillars = {"in_range_points": int(cpu_batch["points_mask"].sum()),
               "pillar_rows": int(vox.mask.numel()), "occupied_pillars": int(vox.mask.sum()),
               "capped_pillars": int((vox.num_points == cap).sum())}
    print(f"pointpillars: {pillars['in_range_points']} points in range occupy "
          f"{pillars['occupied_pillars']} of {pillars['pillar_rows']} pillar rows; "
          f"{pillars['capped_pillars']} pillars hold the cap of {cap} points")
    model, batch = copy.deepcopy(cpu_model).cuda(), batch_to(cpu_batch, "cuda")
    launches, heat_err, _, _ = run_model("pointpillars", model, batch, cpu_model, cpu_batch,
                                         counters, dict.fromkeys(counters, 0))
    r = dict(pillars, launches=launches, heatmap_rel_err=heat_err, **frame_profile(model, batch))
    share = {k: r[k]["lidar/encoder"] / sum(r[k].values()) for k in ("stage_ms", "stage_ms_tf32")}
    print(f"pointpillars: {r['frame_ms_median']:.2f} ms/frame median, peak "
          f"{r['peak_mem_bytes'] / 2**20:.1f} MiB; TF32 on {r['frame_ms_median_tf32']:.2f} ms, "
          f"peak {r['peak_mem_bytes_tf32'] / 2**20:.1f} MiB; the pillar encoder (PFN + scatter) "
          f"{100 * share['stage_ms']:.1f}% of the stages' sum (TF32 on "
          f"{100 * share['stage_ms_tf32']:.1f}%)")
    for key in ("stage_ms", "stage_ms_tf32"):
        print(f"pointpillars stages, {key}: "
              + ", ".join(f"{k} {v:.2f}" for k, v in r[key].items()))
    r["encoder_share"] = share
    r["seconds"] = time.perf_counter() - t0
    res = {"pointpillars": r}
    del model, batch, cpu_model, cpu_batch, vox
    torch.cuda.empty_cache()

    res["camera+radar"], _, model, batch = det_frame(
        "camera+radar", PILLAR_CONFIGS["camera+radar"], counters, DET_LAUNCHES)
    del model, batch
    torch.cuda.empty_cache()

    refused = None
    try:
        build_model(load_config(DLSS_CONFIG).model, "cpu")
    except ValueError as e:  # the refusal this phase checks for
        refused = str(e)
    check(refused is not None and "32 x 88" in refused and "16 x 44" in refused,
          f"dlss.yaml: built, or refused with another message ({refused})")
    print(f"dlss.yaml refused: {refused}")
    res["dlss_refusal"] = refused
    return res


def summary(name, source, replaces, launches, shapes, extra_err=(), library_ms=None):
    """One kernel's entry of the JSON line: times and bounds summed over
    its shapes, the largest error, the limit of the largest bound."""
    top = max(shapes, key=lambda s: s["bound_ms"])
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max([s["max_abs_err"] for s in shapes] + list(extra_err)),
            "ms": sum(s["ms"] for s in shapes), "plain_ms": sum(s["plain_ms"] for s in shapes),
            "bound_ms": sum(s["bound_ms"] for s in shapes), "bound_by": top["bound_by"],
            "library_ms": library_ms, "shapes": shapes}


def form_summary(rows, launches):
    """One form's sums over its shapes (a K6 engine's, a K7 family's): ms,
    plain ms, bound, the bound's share of the ms, its launches in the
    tools' run, and the rows. The share leaves out the rows whose own share
    is None (K6's L2-resident settings, where the HBM bound is no floor),
    and is None if that leaves none."""
    ms, plain_ms, bound_ms = (sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms"))
    bounded = [r for r in rows if r.get("hbm_share", 0.0) is not None]
    share = (sum(r["bound_ms"] for r in bounded) / sum(r["ms"] for r in bounded)
             if bounded else None)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "share": share,
            "launches": launches, "shapes": rows}


def grad_gaps(grads, ref, global_norm):
    """Per parameter of ``ref``: (|grads - ref| in norm, |ref| in norm), and
    the worst relative gap among those above ``ZERO_GRAD`` of the global
    norm, with its name."""
    gaps = {n: (float((grads[n] - g).double().norm()), float(g.double().norm()))
            for n, g in ref.items()}
    worst = max(((d / r, n) for n, (d, r) in gaps.items() if r > ZERO_GRAD * global_norm),
                default=(0.0, None))
    return gaps, worst


def train_step_parity(label, model, batch, sp, bp, counters, want):
    """One config's train step held to the plain path (phases 12 and 12b):
    passes of one forward + backward, same weights and batch, a freshly
    seeded dropout generator each; where the object head is TransFusion's
    (the auction matcher), every later pass takes the first one's proposals
    and Hungarian targets (``recorded_proposals``, ``recorded_targets``), and
    whether its own would differ is reported. ``want``: the launches of pass
    A by name (every other counter 0).

    - A: through the kernels (launches counted);
    - B: through the plain versions, the sparse convs in float64 rounded
      once (``sparse_conv_exact``): every loss within 1e-4 relative of A's
      (the forward kernels), and with the matcher the proposals' heatmap
      scores too;
    - C: A's forward through the kernels, the backward through the plain
      versions: every parameter's gradient within 5e-3 relative in norm of
      A's (the backward kernels: backward-data, the weight gradient); every
      parameter has a gradient. A shares C's ReLU masks, batch statistics and
      top-k; against B they differ wherever a rounding difference moves an
      input across a tie, and a gradient jumps there (PERF.md §6);
    - B' (where sparse convs run): B with the sparse convs in fp32 (cuBLAS):
      how far each of B's gradients moves under a rounding-level change of
      the forward. Every gradient of A within 5e-3 relative in norm of B's
      plus ``TRAIN_GRAD_SENSITIVITY`` times that move (the forward kernels'
      effect on the gradients). Elsewhere A vs B's gradient gap is reported."""
    from bevfusion_tpu_torch.models.layers import set_dropout_generator

    params = dict(model.named_parameters())
    head = model.heads["object"] if "object" in model.heads else None
    matcher = hasattr(head, "_targets")  # TransFusion's Hungarian targets
    sparse = want.get("sparse_conv", 0) > 0
    store, tops = {}, {}
    exact = sparse_conv_exact(sp)
    # cuDNN's and index_add_'s atomics otherwise make two kernel passes differ
    # by more than the kernels and their plain versions do
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)

    def fwd_bwd(plain_backward=False):
        preds, own = {}, None
        hook = head.register_forward_hook(
            lambda mod, args, out: preds.update({k: v.detach() for k, v in out.items()})) \
            if matcher else None
        set_dropout_generator(model, torch.Generator(device=DEVICE).manual_seed(0))
        model.zero_grad(set_to_none=True)
        with contextlib.ExitStack() as replay:
            if matcher:
                compute = replay.enter_context(recorded_targets(head, store))
                own_top = replay.enter_context(recorded_proposals(head, tops))
            losses = model(batch)
        if hook:
            hook.remove()
        total = sum(v for k, v in losses.items() if k.startswith("loss/"))
        with plain_kernels(sp, bp, exact) if plain_backward else contextlib.nullcontext():
            total.backward()
        torch.cuda.synchronize()
        if matcher:
            with torch.no_grad():
                own = compute(0, preds, batch["gt_boxes"][0], batch["gt_labels"][0],
                              batch["gt_valid"][0], 1)
            preds["own_top"] = own_top[0] if own_top else tops["top"]
        return ({k: v.item() for k, v in losses.items()}, total.item(),
                {n: p.grad.clone() for n, p in params.items() if p.grad is not None}, preds, own)

    def counted(fn, launches_want, what):
        torch.cuda.synchronize()
        zero_counts(counters)
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        print(f"{label}, {what}: launches {launches}; {seconds:.2f} s")
        check(launches == launches_want,
              f"{label}, {what}: launches {launches}, want {launches_want}")
        return out, launches, seconds

    none = dict.fromkeys(counters, 0)
    (losses, total, grads, preds, own), launches, kernel_s = counted(
        fwd_bwd, dict(none, **want), "A, forward + backward through the kernels")
    missing = sorted(set(params) - set(grads))
    check(not missing, f"{label}: parameters without a gradient {missing[:5]}")
    check(math.isfinite(total), f"{label}: loss {total}")
    with plain_kernels(sp, bp, exact):
        (losses_p, total_p, grads_p, preds_p, own_p), _, plain_s = counted(
            fwd_bwd, none, "B, through the plain versions")
    if sparse:
        with plain_kernels(sp, bp):
            (_, _, grads_p32, _, _), _, _ = counted(fwd_bwd, none, "B', B with fp32 sparse convs")
    forward_only = dict(none, sparse_conv=SPARSE_LAUNCHES if sparse else 0,
                        bev_pool=want.get("bev_pool", 0))
    (_, _, grads_c, preds_c, _), _, _ = counted(
        lambda: fwd_bwd(plain_backward=True), forward_only,
        "C, the kernels' forward and the plain versions' backward")

    out = {"launches": launches}
    if matcher:
        heat_err = rel_err(preds["dense_heatmap"], preds_p["dense_heatmap"])
        score_err = rel_err(preds["query_heatmap_score"], preds_p["query_heatmap_score"])
        same_queries = torch.equal(preds["query_labels"], preds_p["query_labels"])
        own_queries = torch.equal(preds["own_top"], preds_p["own_top"])
        same_targets = all(torch.equal(a, b) for a, b in zip(own, own_p))
        same_forward = torch.equal(preds["dense_heatmap"], preds_c["dense_heatmap"])
        print(f"{label}: A vs B: dense heatmap rel err {heat_err:.3e}; the same proposals "
              f"{same_queries} (their scores rel err {score_err:.3e}); B's own proposals equal "
              f"A's: {own_queries}; its own Hungarian targets: {same_targets}; A and C's "
              f"forwards equal: {same_forward}")
        check(same_queries and score_err <= TRAIN_LOSS_RTOL, f"{label}: proposals differ")
        out.update(heatmap_rel_err=heat_err, same_forward_a_c=same_forward,
                   same_own_proposals=own_queries, same_own_targets=same_targets)
    loss_err = max(abs(losses[k] - v) / max(abs(v), 1e-6) for k, v in losses_p.items())
    loss_err = max(loss_err, abs(total - total_p) / abs(total_p))
    print(f"{label}: losses {losses}; A vs B max rel err {loss_err:.3e} (B {plain_s:.2f} s)")
    check(loss_err <= TRAIN_LOSS_RTOL, f"{label}: loss rel err {loss_err}")

    global_norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads_c.values()))
    gaps, worst = grad_gaps(grads, grads_c, global_norm)
    zero = [n for n, (_, r) in gaps.items() if r <= ZERO_GRAD * global_norm]
    for n, (diff, ref) in gaps.items():
        if n in zero:
            check(diff <= ZERO_GRAD * global_norm, f"{label}: {n} grad |d| {diff}")
        else:
            check(diff <= TRAIN_GRAD_RTOL * ref,
                  f"{label}: {n} grad rel err {diff / ref} (norm {ref / global_norm:.3e} of "
                  f"the global norm)")
    print(f"{label}: {len(grads)} parameter gradients, A vs C max rel err {worst[0]:.3e} in "
          f"norm ({worst[1]}); {len(zero)} zero but for rounding (< {ZERO_GRAD:g} of the "
          f"global norm {global_norm:.4e})")
    gaps_ab, worst_ab = grad_gaps(grads, grads_p, global_norm)
    out.update(losses=losses, loss_rel_err=loss_err, grad_rel_err=worst[0],
               grad_rel_err_vs_plain=worst_ab[0], zero_grads=len(zero), kernel_s=kernel_s,
               plain_s=plain_s)
    if sparse:
        gaps_bb, worst_bb = grad_gaps(grads_p32, grads_p, global_norm)
        used, beyond = {}, []  # A vs B over what the gate allows; those past 5e-3 alone
        for n, (diff, ref) in gaps_ab.items():
            alone = ZERO_GRAD * global_norm if n in zero else TRAIN_GRAD_RTOL * ref
            used[n] = diff / (alone + TRAIN_GRAD_SENSITIVITY * gaps_bb[n][0])
            if diff > alone:
                beyond.append(n)
        order = sorted(used, key=used.get, reverse=True)

        def rel(gap):
            return gap[0] / max(gap[1], ZERO_GRAD * global_norm)

        print(f"{label}: A vs B max rel err {worst_ab[0]:.3e} ({worst_ab[1]}), B' vs B "
              f"{worst_bb[0]:.3e} ({worst_bb[1]}); {len(beyond)} gradients of A past "
              f"{TRAIN_GRAD_RTOL:g} of B's; the gate ({TRAIN_GRAD_RTOL:g} + "
              f"{TRAIN_GRAD_SENSITIVITY} x B' vs B) most used by: "
              + "; ".join(f"{n} {used[n]:.3f} (A vs B {rel(gaps_ab[n]):.3e}, B' vs B "
                          f"{rel(gaps_bb[n]):.3e})" for n in order[:5]))
        for n in order:
            check(used[n] <= 1.0, f"{label}: {n} grad A vs B rel err {rel(gaps_ab[n])}, B' vs "
                  f"B {rel(gaps_bb[n])}: {used[n]:.3f} of the gate")
        out.update(plain_grad_rel_err_fp32_vs_float64=worst_bb[0],
                   grad_vs_plain_share_of_gate=used[order[0]], grads_past_rtol_vs_plain=len(beyond))
    else:
        print(f"{label}: A vs B max rel err {worst_ab[0]:.3e} in norm ({worst_ab[1]}; not gated: "
              f"no sparse conv, so no B' to scale the gate)")
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    return out


def prepare_train_model(model, batch) -> None:
    """Moderate a training model's head on ``batch`` as the parity phases need:
    TransFusion's heatmap head's last conv scaled by 0.2 (an unsaturated
    sigmoid ranks apart); each CenterHead branch's last conv by
    ``moderate_head``, on the training forward (batch statistics)."""
    from bevfusion_tpu_torch.models.layers import set_dropout_generator

    head = model.heads["object"] if "object" in model.heads else None
    if hasattr(head, "heatmap_head"):
        with torch.no_grad():
            head.heatmap_head[-1].weight.mul_(0.2)
    elif hasattr(head, "task_heads"):
        set_dropout_generator(model, torch.Generator(device=DEVICE).manual_seed(0))
        moderate_head(model, batch)


def train_configs_phase(sp, bp, counters):
    """Phase 12b: each config of ``TRAIN_CONFIG_LAUNCHES`` built for training at full
    width (B = 1, 64 random boxes or seeded map masks and the depth images of
    ``add_train_targets``), its head moderated, held to the plain path by
    ``train_step_parity`` with TF32 off; then 3 timed steps after 1 warmup
    with TF32 on (``tools/bench_train_step.py``): ms a step split into
    forward, backward and optimizer, the peak memory less what was allocated
    before the config was built (the flagship's model). Returns {config:
    results}."""
    from bevfusion_tpu_torch.runtime.flagship import (DET_CAMERA_CONFIGS, LIDAR_SLICE_CONFIG,
                                                      PILLAR_CONFIGS, SEG_CONFIGS, build_flagship)
    from bevfusion_tpu_torch.tools.bench_train_step import train_steps

    paths = {"seg-fused": SEG_CONFIGS["fusion-bev256d2-lss"],
             "seg-lidar": SEG_CONFIGS["lidar-centerpoint-bev128"],
             "seg-camera": SEG_CONFIGS["camera-bev256d2"], "transfusion-l": LIDAR_SLICE_CONFIG,
             "pointpillars": PILLAR_CONFIGS["pointpillars"],
             **{f"det-{k}": p for k, p in DET_CAMERA_CONFIGS.items()},
             "camera+radar": PILLAR_CONFIGS["camera+radar"]}
    res = {}
    for name, want in TRAIN_CONFIG_LAUNCHES.items():
        t0 = time.perf_counter()
        resident = torch.cuda.memory_allocated()  # the flagship's, held for phases 13-14
        cfg, model, batch = build_flagship("cuda", num_points=120000, seed=0, training=True,
                                           config_path=paths[name])
        if "map" in model.heads:
            check(tuple(batch["gt_masks_bev"].shape) == SEG_MASKS,
                  f"train {name}: masks {tuple(batch['gt_masks_bev'].shape)}")
        prepare_train_model(model, batch)
        r = train_step_parity(f"train {name}", model, batch, sp, bp, counters, want)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        steps = train_steps(cfg, model, batch, DEVICE, steps=3, warmup=1)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        check(not steps.pop("unchanged"), f"train {name}: timed steps left parameters unchanged")
        med, own = steps["ms_median"], steps["peak_mem_bytes"] - resident
        r.update(steps_tf32_on=steps, peak_mem_bytes_own=own, seconds=time.perf_counter() - t0)
        print(f"train {name} (TF32 on): median ms/step {med['step']:.2f} (forward "
              f"{med['forward']:.2f}, backward {med['backward']:.2f}, optimizer "
              f"{med['optimizer']:.2f}); peak device memory {own / 2**20:.1f} MiB of its own "
              f"({steps['peak_mem_bytes'] / 2**20:.1f} with the flagship's); auction "
              f"{[round(a, 2) for a in steps['auction_ms']]} ms; {r['seconds']:.1f} s")
        res[name] = r
        del cfg, model, batch
        torch.cuda.empty_cache()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # cuBLAS takes deterministic workspaces only if told before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bevfusion_tpu_torch import native
    from bevfusion_tpu_torch.models.vtransforms import build_pool_lut
    from bevfusion_tpu_torch.ops import bev_pool as bp
    from bevfusion_tpu_torch.ops import nms
    from bevfusion_tpu_torch.ops import sparse_conv as sp
    from bevfusion_tpu_torch.runtime.flagship import (add_pool_lut, batch_to, build_flagship,
                                                      build_lidar_slice)
    from bevfusion_tpu_torch.tools import bench_kernel_variants as kv
    from bevfusion_tpu_torch.tools import bench_tile_micro as tm
    from bevfusion_tpu_torch.tools import profile_stages
    from bevfusion_tpu_torch.tools.bench_train_step import train_steps

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = card_line()
    print(f"device: {name}")
    print(f"nvidia-smi: {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off")

    # 2. build
    t0 = time.perf_counter()
    builds = {"sparse_conv": sp.build_kernels, "sparse_conv_dw": sp.build_dw_kernels,
              "bev_pool": bp.build_kernels, "tile_micro": tm.build_kernels,
              "sparse_conv_variants": kv.build_kernels, "nms": nms.build_kernels}
    with ThreadPoolExecutor(len(builds)) as ex:  # one nvcc per source, started together
        list(ex.map(lambda build: build(), builds.values()))
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(builds)} in {build_s:.2f} s")
    for lib in builds:
        for line in native.build_log(lib).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib}: {line.strip()}")
    for lib in ("sparse_conv", "sparse_conv_dw", "sparse_conv_variants"):
        hmma = sum("HMMA" in line for line in native.sass(lib).splitlines())
        print(f"build: {hmma} tensor-core (HMMA) instructions in the {lib} library's SASS")
        check(hmma > 0, f"the {lib} kernel has no tensor-core (HMMA) instruction")
    bulk = sum("UBLKCP" in line for line in native.sass("tile_micro").splitlines())
    print(f"build: {bulk} TMA bulk copies (UBLKCP) in the tile_micro library's SASS")
    check(bulk > 0, "the TMA gather has no bulk copy (UBLKCP) in its SASS")

    # 3-5. sparse-conv kernels vs plain at the LiDAR branch's shapes
    _, cpu_model, cpu_batch = build_lidar_slice("cpu", num_points=120000, seed=0)
    batch = batch_to(cpu_batch, "cuda")
    vox = cpu_model.lidar_voxelize(batch["points"], batch["points_mask"])
    enc = cpu_model.encoders["lidar"]["backbone"]
    cases = kernel_cases(enc, vox.feats[0], vox.coords[0], vox.mask[0], sp)
    shapes, dw_shapes, bwd_shapes = sparse_kernel_phases(sp, kv, cases)
    del cases
    step_dw = {k: sum(s[k] * s["step_launches"] for s in dw_shapes)
               for k in ("ms", "plain_ms", "bound_ms")}
    check(sum(s["step_launches"] for s in dw_shapes) == TRAIN_LAUNCHES["sparse_conv_dw"],
          f"phase 4: launches a step {[s['step_launches'] for s in dw_shapes]}")
    print(f"kernel sparse_conv_dw: a train step's {TRAIN_LAUNCHES['sparse_conv_dw']} launches at "
          f"these shapes {step_dw['ms']:.4f} ms (plain {step_dw['plain_ms']:.4f} ms, bound "
          f"{step_dw['bound_ms']:.4f} ms)")

    # 6. the memory probes' kernels vs plain
    tile_errs = tile_probe_checks(tm)

    # 7. the cost breakdown's kernel vs plain, at the scan's stage-0, 1 and 2 subm convs
    k7_cases = kv.stage_cases(enc, vox.coords[0], vox.mask[0])
    check(len(k7_cases) == K7_SHAPES, f"K7: {len(k7_cases)} stage shapes")
    k7_checks, k7_one_tf32 = variant_checks(kv, sp, k7_cases)

    # 8. the LiDAR slice, eval forward at B=1
    counters = {"sparse_conv": sp.sparse_conv, "bev_pool": bp.bev_pool,
                "greedy_nms": nms.greedy_suppress}
    lidar_launches, lidar_heat_err, lidar_frames, lidar_peak = run_model(
        "lidar slice", copy.deepcopy(cpu_model).cuda(), batch, cpu_model, cpu_batch, counters,
        {"sparse_conv": SPARSE_LAUNCHES, "bev_pool": 0, "greedy_nms": 0})
    del cpu_model, cpu_batch, batch

    # 9. BEV-pool kernel vs plain at the flagship's shape, on the main path's intervals
    cfg, cpu_model, cpu_batch = build_flagship("cpu", num_points=120000, seed=0)
    batch = batch_to(cpu_batch, "cuda")
    t0 = time.perf_counter()
    add_pool_lut(cfg, cpu_batch)
    lut_s = time.perf_counter() - t0
    vt = cpu_model.encoders["camera"]["vtransform"]
    pool_entry, (depth, ctx, got, iv) = pool_case("flagship", bp, vt, batch["pool_lut"])
    X, Y, Z = vt.nx
    g = torch.Generator(device=DEVICE).manual_seed(1)
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
    pool_bwd_ms = kernel_ms(lambda: bp.bev_pool_backward(depth, ctx, iv, gout, Z, X, Y))
    pool_bwd_plain_ms = kernel_ms(lambda: torch.autograd.grad(plain_out, (dr0, cr0), gout,
                                                            retain_graph=True))
    del plain_out, dr, cr, dr0, cr0
    print(f"bev_pool backward (torch ops, {bp.POOL_BWD_CHUNK} points a chunk): rel err "
          f"{pool_bwd_err:.3e} vs autograd of plain, {pool_bwd_ms:.4f} ms (autograd of plain "
          f"{pool_bwd_plain_ms:.4f} ms)")
    frustum = vt.frustum.cuda()
    lut_card_ms = kernel_ms(lambda: build_pool_lut(frustum, vt.dx, vt.bx, vt.nx, batch))
    ids = build_pool_lut(frustum, vt.dx, vt.bx, vt.nx, batch)["cell_ids"].cpu()
    print(f"pool LUT build: host {lut_s:.3f} s, card {lut_card_ms:.3f} ms (the in-graph "
          f"route's cost per frame); the card's geometry puts "
          f"{(ids != cpu_batch['pool_lut']['cell_ids']).float().mean().item():.3e} of frustum "
          f"points in another cell than the host's (axis-aligned rig)")

    # 10. the fused flagship, eval forward at B=1
    model = copy.deepcopy(cpu_model).cuda()
    launches, heat_err, frames, peak = run_model(
        "flagship", model, batch, cpu_model, cpu_batch, counters,
        {"sparse_conv": SPARSE_LAUNCHES, "bev_pool": POOL_LAUNCHES, "greedy_nms": 0})
    stages = {r["stage"]: r["ms"]
              for r in profile_stages.profile_stages(model, batch, DEVICE, iters=10)[0]}
    for stage, ms in stages.items():
        print(f"flagship stage {stage}: {ms:.2f} ms")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    with torch.no_grad():
        frames_tf32, peak_tf32 = frame_ms(lambda: model(batch))
    stages_tf32 = {r["stage"]: r["ms"]
                   for r in profile_stages.profile_stages(model, batch, DEVICE, iters=10)[0]}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"flagship, TF32 on: {statistics.median(frames_tf32):.2f} ms/frame median, "
          f"peak device memory {peak_tf32 / 2**20:.1f} MiB; stages "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in stages_tf32.items()))
    del model, cpu_model, cpu_batch, batch, depth, ctx, got, gout
    torch.cuda.empty_cache()

    # 11. the three map-segmentation configs, eval forward at B=1, and the pool at the seg grid
    all_counters = {"sparse_conv": sp.sparse_conv, "sparse_conv_dw": sp.sparse_conv_dw,
                    "bev_pool": bp.bev_pool, "tile_copy": tm.copy_add_one,
                    "tile_gather": tm.gather_tiles, "sparse_conv_variants": kv.sparse_conv_variant,
                    "greedy_nms": nms.greedy_suppress}
    t0 = time.perf_counter()
    seg, seg_pool = seg_phase(all_counters, bp)
    seg_s = time.perf_counter() - t0
    print(f"seg: the three configs and the pool at the seg grid in {seg_s:.1f} s")

    # 11b. the three camera-only CenterHead configs, eval forward at B=1; NMS and the pool alone
    t0 = time.perf_counter()
    det, nms_shapes, det_pool = det_phase(all_counters, bp, nms)
    det_s = time.perf_counter() - t0
    print(f"det: the three configs, the NMS kernel and the pool at C = 64 in {det_s:.1f} s")

    # 11c. the pillar configs, eval forward at B=1: PointPillars, camera + radar; dlss refused
    t0 = time.perf_counter()
    pillar = pillar_phase(all_counters)
    pillar_s = time.perf_counter() - t0
    print(f"pillar: PointPillars, camera + radar and the dlss refusal in {pillar_s:.1f} s")

    # 12. the flagship's training step, B=1, host LUT, TF32 off: kernels vs plain
    cfg, model, batch = build_flagship("cuda", num_points=120000, seed=0, training=True)
    prepare_train_model(model, batch)
    parity = train_step_parity("train step", model, batch, sp, bp, all_counters, TRAIN_LAUNCHES)

    # 12b. the train steps of nine more configs, each held to the plain path, then timed
    t0 = time.perf_counter()
    train_cfgs = train_configs_phase(sp, bp, all_counters)
    train_cfgs_s = time.perf_counter() - t0
    print(f"train configs: {len(train_cfgs)} configs' steps held and timed in "
          f"{train_cfgs_s:.1f} s")

    # 13. five timed train steps, TF32 on
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    steps = train_steps(cfg, model, batch, DEVICE, steps=5, warmup=2)
    check(not steps.pop("unchanged"), "timed steps: parameters unchanged")
    med, step_ms = steps["ms_median"], steps["ms_median"]["step"]
    print(f"train steps (TF32 on): total loss {[round(v, 4) for v in steps['losses']]}; median "
          f"ms/step {step_ms:.2f} (forward {med['forward']:.2f}, backward {med['backward']:.2f}, "
          f"optimizer {med['optimizer']:.2f}); peak device memory "
          f"{steps['peak_mem_bytes'] / 2**20:.1f} MiB; {steps['optimizer_steps']} optimizer steps")
    print(f"train steps: the auction matcher (in the forward) "
          f"{statistics.median(steps['auction_ms']):.2f} ms median over "
          f"{len(steps['auction_ms'])} calls, "
          f"{[f'{a} of {v}' for a, v in steps['auction_assigned']]} ground truths assigned")
    print(f"pool LUT build on the host: {lut_s * 1e3:.1f} ms = {lut_s * 1e3 / step_ms:.3f} "
          f"train steps; on the card {lut_card_ms:.3f} ms = {lut_card_ms / step_ms:.4f} steps")

    # 14. the measurement tools: this path's entry points
    tools, tool_launches, tool_parts = tools_phase(cfg, model, batch, k7_cases, all_counters)

    # 15. results
    k7_rows = [{"shape": f"{r['shape']} tile {r['tile']} {mode}", "family": r["family"],
                "ms": m["ms"], "plain_ms": k7_checks[(r["shape"], mode)][1],
                "max_abs_err": k7_checks[(r["shape"], mode)][0], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "bound_fp32_fma_ms": m["bound_fp32_fma_ms"]}
               for r in tools["breakdown"] for mode, m in r["modes"].items()]
    kernels = [
        dict(summary("sparse_conv", "bevfusion_tpu_torch/csrc/sparse_conv.cu",
                     "bevfusion_tpu/ops/sparse_conv_windowed.py:285",
                     parity["launches"]["sparse_conv"], shapes,
                     [s["max_abs_err"] for s in bwd_shapes]),
             also_replaces=["bevfusion_tpu/ops/sparse_conv_windowed.py:180"],
             launches_eval=launches["sparse_conv"], backward_data=bwd_shapes,
             ms_no_epilogue=sum(s["ms_no_epilogue"] for s in shapes),
             scalar_loop_ms=sum(s["scalar_loop_ms"] for s in shapes),
             bound_fp32_fma_ms=sum(s["bound_fp32_fma_ms"] for s in shapes)),
        dict(summary("sparse_conv_dw", "bevfusion_tpu_torch/csrc/sparse_conv_dw.cu",
                     "bevfusion_tpu/ops/sparse_conv_windowed.py:501",
                     parity["launches"]["sparse_conv_dw"], dw_shapes),
             step_ms=step_dw["ms"], step_plain_ms=step_dw["plain_ms"],
             step_bound_ms=step_dw["bound_ms"]),
        dict(summary("bev_pool", "bevfusion_tpu_torch/csrc/bev_pool.cu",
                     "bevfusion_tpu/ops/bev_pool_pallas.py:49", parity["launches"]["bev_pool"],
                     [pool_entry, seg_pool, det_pool]),
             launches_eval=launches["bev_pool"], backward_ms=pool_bwd_ms,
             backward_plain_ms=pool_bwd_plain_ms, backward_rel_err=pool_bwd_err,
             lut_host_s=lut_s, lut_card_ms=lut_card_ms),
        summary("tile_copy", "bevfusion_tpu_torch/csrc/tile_micro.cu",
                "tools/bench_tile_micro.py:50", tool_launches["tile_copy"],
                [dict(tools["copy"], max_abs_err=tile_errs["copy"])],
                library_ms=tools["copy"]["library_ms"]),
        dict(summary("tile_gather", "bevfusion_tpu_torch/csrc/tile_micro.cu",
                     "tools/bench_tile_micro.py:77", tool_launches["tile_gather"],
                     [dict(r, max_abs_err=tile_errs[(r["R"], r["G"])]) for r in tools["gathers"]]),
             engines={e: form_summary(
                 [{"shape": r["shape"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                   **r["engines"][e]} for r in tools["gathers"]], tool_parts["tile_gather"][e])
                 for e in tm.ENGINES}),
        dict(summary("sparse_conv_variants", "bevfusion_tpu_torch/csrc/sparse_conv_variants.cu",
                     "tools/bench_kernel_variants.py:33", tool_launches["sparse_conv_variants"],
                     k7_rows),
             families={f: form_summary([r for r in k7_rows if r["family"] == f],
                                       tool_parts["sparse_conv_variants"][f])
                       for f in kv.FAMILIES},
             tc_1xtf32_rel_err_vs_fp32=k7_one_tf32,
             split=[{k: v for k, v in r.items() if k != "modes"} for r in tools["breakdown"]]),
    ]
    # not a TPU kernel: the JAX package's greedy pass is a lax.fori_loop
    kernels.append(dict(summary("greedy_nms", "bevfusion_tpu_torch/csrc/nms.cu",
                                "bevfusion_tpu/ops/nms.py:25",
                                sum(r["launches"]["greedy_nms"] for r in det.values()), nms_shapes),
                        pallas=False, launches_eval=launches["greedy_nms"],
                        launches_lidar=lidar_launches["greedy_nms"],
                        launches_tools=tool_launches["greedy_nms"]))
    for k in kernels[:3]:
        k["launches_tools"] = tool_launches[k["name"]]
    for k in kernels:
        k["launches_seg"] = {name: r["launches"][k["name"]] for name, r in seg.items()}
        k["launches_det_camera"] = {name: r["launches"][k["name"]] for name, r in det.items()}
        k["launches_pillar"] = {name: pillar[name]["launches"][k["name"]]
                                for name in ("pointpillars", "camera+radar")}
        k["launches_train"] = {"flagship": parity["launches"][k["name"]],
                               **{name: r["launches"][k["name"]] for name, r in train_cfgs.items()}}
    print(json.dumps({
        "kernels": kernels, "build_s": build_s, "total_s": time.perf_counter() - t_start,
        "flagship": {"frame_ms_median": statistics.median(frames), "peak_mem_bytes": peak,
                     "heatmap_rel_err": heat_err, "stage_ms": stages,
                     "frame_ms_median_tf32": statistics.median(frames_tf32),
                     "peak_mem_bytes_tf32": peak_tf32, "stage_ms_tf32": stages_tf32},
        "seg": dict(seg, seconds=seg_s),
        "det_camera": dict(det, seconds=det_s),
        "pillar": dict(pillar, seconds=pillar_s),
        "train": {"parity_tf32_off": parity, "steps_tf32_on": steps},
        "train_configs": dict(train_cfgs, seconds=train_cfgs_s),
        "tools": {k: v for k, v in tools.items() if k not in ("copy", "gathers")},
        "lidar_slice": {"launches": lidar_launches,
                        "frame_ms_median": statistics.median(lidar_frames),
                        "peak_mem_bytes": lidar_peak, "heatmap_rel_err": lidar_heat_err}}))
    print(smi)  # the card's name and power limit, as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
