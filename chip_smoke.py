#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``
(``python3 chip_smoke.py --gate-probe``: only the runs that measure the
gates of phases 11e, 11e-dp and 13c, ``gate_probe``; ``--long-tail``: phase
11g alone; ``--sparse-kernels``: phases 5b and 7 alone, the quick check of
the sparse-conv kernels, with K3 bf16's passes apart (``torch.profiler``)
and K7's dw_bf16 family timed). Phases:

1. device: the card's name and power limit; TF32 off for fp32 parity;
2. build: compile the eight kernel sources of bevfusion_tpu_torch/csrc (one
   nvcc per source, started together); the ptxas register and spill lines;
   the count of tensor-core instructions (``HMMA``) in the SASS
   (``cuobjdump -sass``) of the sparse-conv, weight-gradient and cost
   breakdown libraries, of bf16 m16n8k16 ones (``HMMA.16816.F32.BF16``, the
   bf16 forms) in the first two, and of TMA bulk copies (``UBLKCP``) in the
   memory probes' library, each of which must be above 0;
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
5b. the bf16 forms of K1/K2 and K3 at the same six shapes (the operands
   rounded to bf16; scale and shift fp32): K1/K2 with and without the
   epilogue, every valid element within one bf16 rounding (2^-7 of |plain|)
   plus 1e-4 of the scale of its bf16 plain version (the product and the
   epilogue in fp32, one rounding), the count of elements that differ
   printed, equal bits across two calls; K3 (fp32 dW) within 1e-4 *
   max(|plain|, 1), equal bits across two calls; each one's median time,
   bound (the bytes at bf16 rows; one bf16 product a useful multiply-add at
   989 TFLOP/s) and share, beside the fp32 kernels' times of phases 3-4 and
   K1/K2 bf16's recorded times before its redesign (``BF16_MS_BEFORE``,
   printed only), with the bf16 frame's 15 launches summed at the frame's
   launches a shape (``BF16_FRAME_LAUNCHES``, printed only); K1/K2 bf16's
   launch plan at each shape (registers, spills, resident blocks an SM,
   stages, grid); K3 bf16's times beside its recorded ones before its
   redesign (``DW_BF16_MS_BEFORE``) and the bf16 train step's 15 launches
   summed (the shapes' ``step_launches``), each printed only, and its plan
   at each shape (teams, stages, resident blocks an SM); K7's bf16 family is
   timed in phase 14, beside the tensor-core family;
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
   the fp32 plain conv (one TF32 product: ~1e-3 relative); the bf16
   family's four modes (K1/K2 bf16's loop) within one bf16 rounding of
   plain, ``bf16`` equal to the bf16 kernel without epilogue and
   ``bf16_noskip`` to ``bf16``, bit for bit; the plain versions' times;
   the dw_bf16 family's four modes (K3 bf16's kernel), ``dw_bf16`` and
   ``dw_bf16_nogather`` within 1e-4 of plain and ``dw_bf16`` equal to the
   bf16 weight-gradient kernel bit for bit, the two counting modes equal to
   the hit counts (timed by ``--sparse-kernels``, not in phase 14);
8. the LiDAR slice: TransFusion-L (voxelnet_0p075) at full width with
   seeded random weights, eval forward at batch 1 on the scan; 15 kernel
   launches per forward, every box field finite, heatmap logits within
   2e-3 relative of the same model on the CPU (plain path); ms/frame
   (median of 5, ``FRAMES``) and peak device memory;
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
10b. the same flagship frame at bf16 (``compute_dtype`` on the same
   weights): 15 bf16 sparse convs, no fp32 one, 1 pool, no NMS; every box
   field finite and fp32; the head's BEV input and the dense heatmap
   logits within 0.15 relative in norm of the fp32 frame (TF32 off); ms a
   frame and peak at fp32 and bf16 in turns, cuDNN TF32 on and matmul TF32
   off (``runtime/precision.py``), the bf16 stages, and one frame of each
   traced (``torch.profiler``: kernels on the card, busy time, idle share);
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
11d. cli: the eval entry point on files. A seeded 4-sample nuScenes-format
   set (``bevfusion_tpu_torch/data/synthetic.py``) under build/cli_smoke/: an
   info pkl, six 900 x 1600 PNG cameras a sample on a jittered ring, a
   keyframe and 9 sweeps of 30,000 points as .bin (300,000 points, the
   pipeline's ``max_points``), a few boxes, no map location; a seeded
   checkpoint of each config written with ``save_checkpoint`` and restored
   into a model on the card. The flagship's four samples go through the
   nuScenes test pipeline, the threaded loader and ``run_model_on_loader``,
   then ``format_results`` (``evaluate_dataset(metric="bbox")`` up to the
   devkit); the fused seg config (fusion-bev256d2-lss) through
   ``bevfusion_tpu_torch.tools.test.main([..., "--eval", "map"])``. Each
   run launches the sparse-conv kernel 15 and the BEV pool (intervals built
   in the graph) once a frame, nothing else; the submission holds the four
   tokens, the schema's keys and finite values; the map metrics' keys, each
   finite; one loaded sample's heatmap / map logits within 2e-3 relative of
   the CPU model's; the host pipeline's ms a sample, the frame's ms on a
   loaded sample with TF32 off and on;
11e. train-cli: the train entry point on files, TF32 on. A seeded
   nuScenes-format set under build/train_cli_smoke/ (a train split of 3
   samples with boxes around keyframe points, which CBGS makes 9, so 2
   steps an epoch at B = 4; a val split of 2; six 900 x 1600 PNG cameras,
   300,000 points a sample) and its GT database (``create_gt_database``); a
   seeded TransFusion-L (voxelnet_0p075) checkpoint. Run A: the flagship
   through ``bevfusion_tpu_torch.tools.train.main`` for 2 epochs at its
   samples_per_gpu of 4 with ObjectPaste, ``--load-from`` the TransFusion-L
   checkpoint (the keys left missing must be the camera branch's and the
   fuser's), eval off (no devkit), both checkpoints kept, each holding
   the optimizer state and {epoch, iter}; run B: resumed from A's
   ``epoch_1``; A and B's final weights and optimizer moments compared and,
   where they differ, runs A' and A'' (A again, twice): B's gaps within 2x
   the mean of theirs, B bit-equal wherever both are and its ``nu`` gap
   in norm within ``RESUME_NU_GAP`` (the factor, the two reruns, the mean
   and the cap set from ``--gate-probe``'s readings); then the
   forward, the backward, the voxel means' ``index_add_``, the pool's
   backward and a cuDNN conv's backward each run twice on the same inputs,
   to name what is not deterministic; then (11e-dp) the flagship for 1
   epoch as two processes (gloo, samples_per_gpu 2 each, every dropout
   rate 0) against one process at 4 run twice: the same steps on both
   ranks, rank 0 alone writes ``epoch_1``, each rank launches K1/K2 58, K3
   30 and K4 1 a step, the first step's loss within 2x the one-process
   run-to-run gap, theirs or the largest measured (``TRAIN_CLI_DP_RTOL``);
   then the same runs A, B, A', A''
   and C at the config's own precision, bf16
   (the resume gate must hold B and refuse C again); these runs at fp32
   (``precision.compute_dtype=float32``); last the fused seg config
   (fusion-bev256d2-lss, fp32) for 1 epoch with the loop's per-epoch
   ``map`` eval (the map metrics' keys, finite). Every run's
   launches equal the count the code predicts: a step 4 x (29 sparse conv,
   15 weight gradient) and one BEV pool (the batch's intervals together),
   a val frame 15 and 1 (at bf16 the same counts on the bf16 kernels);
   losses finite; ms a step (median, host clock
   around a synchronised step), ms a step waiting on the loader, the
   peak memory, the loss at the first and last step, the checkpoint's
   size;
11f. one bf16 eval frame of each of the ten other served configs
   (TransFusion-L at 0.075 and 0.1 m, the three seg configs, the three
   camera CenterHead configs, PointPillars, camera + radar) built at bf16
   on the card, CenterHead heads moderated: the launches of the config's
   fp32 frame with the sparse convs on the bf16 kernel, every output
   finite; ms a frame (median of 5) and the peak;
11g. the long tail no served config reaches (``long_tail_phase``, TF32 off;
   each part's launches counted from 0 just before it): the swint camera
   CenterHead config with ``DCNSeparateHead``, one eval frame (K4 1, the
   deformable im2col D1 twice a task, the greedy pass once a task), every
   task's maps within 2e-3 of the same head on the CPU from the card's head
   input, then D1 against its plain version at that input with random
   offsets (some on integers, some outside the image; bit for bit), its
   time, bound (bytes) and share; furthest point sampling D2 against its
   plain version at the four sampling levels of VoteNet's PointNet2SASSG
   (20,000 points of the flagship scan -> 2048 -> 1024 -> 512 -> 256; indices
   bit for bit), and that SA/FP stack on the card (D2 4 launches) against the
   same weights on the CPU (the sampled points equal, the FP output within
   2e-3); the flagship with ``test_cfg.nms_type`` circle and rotate, one
   frame each (15 + 1 and the greedy pass 2), the keep masks of the kernel
   and of the plain pass equal, on the frame's boxes and on the same boxes
   clustered into the two NMS groups; the flagship's encoder in
   ``block_type: conv_module`` on the flagship scan (K1/K2 10 launches)
   against the plain versions, the inverse sparse conv (one K1/K2 launch)
   and the sparse max pool at its level-1 -> 2 strided conv; VoVNet-19-slim-
   eSE and DLA-34, each with a DetectronFPN, on the six images against the
   CPU; the flagship with ``AddFuser`` (15 + 1), its dense heatmap against
   the CPU's fuser, decoder and head on the card's fuser inputs; the phase's
   seconds (``--long-tail`` runs the build and this phase alone);
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
   where a kernel runs (B' the sparse convs in fp32 where they run, else
   the pool in float64: the camera configs, where a gradient past it is
   held again with B'', the pool's fp32 sums in reverse order, and past
   that too passes only if ``CAMERA_TIES`` names it, within 1e-2 of B's),
   the matcher's targets replayed
   where TransFusion's head runs; then 1 timed step after 1 warmup with
   TF32 on: ms a step (forward, backward, optimizer) and the peak memory;
13. two timed train steps with TF32 on (``tools/bench_train_step.py`` on
   ``runtime/train.py``: AdamW, clip 35, the config's cosine lr with linear
   warmup and cyclic momentum): losses finite, parameters changed; median
   ms/step split into forward, backward and optimizer (host clock around
   synchronises), peak device memory, and the auction matcher's time
   within the forward;
13b. the flagship's train step at bf16 on the phase-13 model: an fp32 pass
   records its proposals and Hungarian targets, the bf16 pass replays them
   (deterministic algorithms, TF32 off): 29 bf16 K1/K2, 15 bf16 K3, 1
   pool, no fp32 sparse conv; the losses finite, every gradient fp32 and
   finite; all gradients within 1e-2 relative in norm of the same forward's
   with the plain versions' backward (the bf16 kernels' backward alone), and
   within 8x of the fp32 pass's as far as a TF32 pass moves them from it
   (at random init a rounding-level change of the forward moves the
   gradients far: phase 12's B'), cosines printed; then 2 timed bf16
   steps: ms a step and the peak;
13c. data parallelism on one card (``dp_phase``): the flagship's step at
   full width on 2 ranks x 1 sample, two processes over gloo on CUDA
   tensors (NCCL refuses two ranks on one card), against one process at
   B = 2 on the same weights and batch, fp32 with TF32 off and bf16, every
   dropout rate 0, the one-process step's proposals and Hungarian targets
   replayed: each rank launches K1/K2 29, K3 15 and K4 once (the bf16 forms
   at bf16); the losses within 1e-4, the gradients by phase 12's rule with
   B' from R' and R_b (float64 BatchNorm moments), ``dp_gates``, which
   must refuse two controls (the loss normalisers' and the BatchNorm sums
   over the ranks patched out), the BatchNorm statistics and the
   parameters after AdamW as ``dp_gates`` says, the ranks' weights
   bit-equal; at bf16 13b's gate; ms a step and each rank's peak;
13d. NCCL at world size 1: the step through a group of one against the
   step without a group (no collective runs; within the run-to-run gap,
   bit-equal where that is 0), and an NCCL all-reduce and broadcast that
   leave the gradients unchanged;
14. the measurement tools (``bevfusion_tpu_torch/tools/``, this path's
   entry points), TF32 on, every launch count set to 0 just before and read
   just after: the memory probes (torch's ``x + 1``, K5, K6 at its five
   settings, both engines, six bf16 matmuls), the cost breakdown (K7) of
   its three families at the three shapes with the slab fill (the bf16
   family's row also with the tiles alone, every entry of the table a miss,
   and its launch plan), then on the
   flagship held by phase 13 (in eval mode) the
   per-stage profile with FLOPs, the encoder, meta-chain and vtransform
   profiles and the latency benchmark's timing, and two train steps
   through the train-step benchmark; every row finite and every kernel
   launched; then ``python -m bevfusion_tpu_torch.tools.benchmark --iters
   5`` (at the CLI's default bf16), and the same on
   configs/nuscenes/seg/fusion-bev256d2-lss.yaml, each in a subprocess:
   exit 0 and its latency line; then ``python -m
   bevfusion_tpu_torch.tools.dryrun_flagship_sharded --ranks 2
   --dist-backend gloo --steps 0``: both ranks build the flagship and
   hold rank 0's weights (13c runs and holds their steps);
14a. export: ``tools/export.py`` (its body, ``export.run``) on the flagship at
   bf16, the config's dtype, then at fp32: ``torch.export`` of the eval
   forward's boxes with every hand kernel a ``bevfusion::`` custom op
   (``ops/library.py``), saved as ``.pt2`` and loaded back with
   ``torch.export.load``: the graph (its autocast submodules too) holds 15
   ``sparse_conv_bf16`` (fp32: 15 ``sparse_conv``) and 1 ``bev_pool`` nodes and
   no other; one frame of the loaded program beside one eager frame on the
   same batch, deterministic algorithms on: boxes, scores, labels and mask
   bit for bit (else the fields named and the head's predictions before
   the top-k held at 1e-5); the export's seconds, the file's bytes, the
   load's seconds, each frame's ms;
14b. longevity: ``tools/train_longevity.py --steps 12 --resume-probe 3
   --scenes 8``, the flagship at bf16 over one whole schedule of 12 steps,
   the resume probe at step 12 (under deterministic algorithms, bit for
   bit, or the rule the tool states): every loss finite, a step's launches
   29 bf16 K1/K2, 15 bf16 K3 and 1 K4, no fp32 sparse conv;
14c. counters at run time: phase 14a's eager frame and the loaded
   program's frame each read 15 + 1 launches from the counters, which the
   custom ops' CUDA implementations add to;
15. a JSON line with the kernel table (the BEV pool's second shape the seg
   grid, its third the ResNet det configs'; K6's two engines and K7's two
   families each with their ms, plain ms, bound, share and launches; every
   kernel's launches on the seg, det-camera and pillar paths; the NMS
   kernel's row after K1-K7, then the bf16 forms of K1/K2 and K3, their
   launches those of the bf16 train step (13b), then D1 and D2 (11g's DCN
   frame and VoteNet stack; ``launches_long_tail`` each kernel's in every
   run of 11g); every kernel's launches in
   each train step of
   phases 12 and 12b; their launches in each run of phase 11d and of phase
   11e; ``launches_train_dp``, each rank's in 13c at fp32 and bf16;
   ``launches_export``, a frame of each loaded program of 14a;
   ``launches_longevity``, a step of 14b), the seg,
   det-camera, pillar, cli, train-cli, train-config, data-parallel, export
   and longevity results
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
import shutil
import statistics
import subprocess
import sys
import time

import torch

from bevfusion_tpu_torch.utils.profiler import (BF16_FLOPS, HBM_BYTES_PER_S, TF32_FLOPS, bound,
                                               card_line, frame_ms, nbytes, time_fn)

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
BF16_REL = 2.0 ** -7  # one bf16 rounding, relative: a bf16 kernel against its bf16 plain version
# a bf16 frame's head input and heatmap logits against the fp32 frame of the same weights,
# relative in norm: the CPU tests (tests/test_torch_precision_models.py) measure 1.0e-2 to
# 5.8e-2 on the tiny models, at most 2.3x the JAX package's own bf16 gap; this allows ~2.5x
# the largest for the deeper full-width nets. A gap below BF16_MIN_GAP means no bf16 ran.
BF16_EVAL_GAP = 0.15
BF16_MIN_GAP = 1e-4
# the bf16 step's gradients, relative in norm over all of them: through the kernels against
# the same forward with the plain versions' backward (the kernels' bf16 backward-data rounds
# a few elements the other way), and against the fp32 step as a multiple of how far TF32 moves
# them (bf16 rounds to 8 significant bits, TF32 the conv and matmul inputs to 11: 2^3)
BF16_TRAIN_KERNEL_GAP = 1e-2
BF16_TRAIN_VS_TF32 = 8.0
BF16_TRAIN_LAUNCHES = {"sparse_conv_bf16": 15 + 14, "sparse_conv_dw_bf16": 15, "bev_pool": 1}
# K1/K2 bf16 before its redesign, ms at the six shapes (phase 5b on an NVIDIA H100 80GB HBM3
# at 700 W, PERF.md), and the launches of each shape in the flagship's bf16 frame (10b): 5b
# prints both beside its own times; neither enters the results
BF16_MS_BEFORE = {"conv_input 5->16": 0.0783, "stage0 subm 16->16": 0.0519,
                "stage0 strided 16->32": 0.0570, "stage1 subm 32->32": 0.0863,
                "stage1 strided 32->64": 0.0843, "stage2 subm 64->64": 0.1603}
# K3 bf16's times before its redesign (measured on one H100; PERF.md section 6), printed beside
# phase 5b's; its launches a bf16 train step are phase 5b's `step_launches` (kernel_cases)
DW_BF16_MS_BEFORE = {"conv_input 5->16": 0.0467, "stage0 subm 16->16": 0.0375,
                     "stage0 strided 16->32": 0.0347, "stage1 subm 32->32": 0.0875,
                     "stage1 strided 32->64": 0.0593, "stage2 subm 64->64": 0.1377}
BF16_FRAME_LAUNCHES = {"conv_input 5->16": 1, "stage0 subm 16->16": 4, "stage0 strided 16->32": 1,
                      "stage1 subm 32->32": 4, "stage1 strided 32->64": 1,
                      "stage2 subm 64->64": 4}
VOXELNET_0P1 = "configs/nuscenes/det/transfusion/secfpn/lidar/voxelnet.yaml"  # TransFusion-L 0.1 m
K7_SHAPES = 3  # the cost breakdown runs at the stage-0, 1 and 2 submanifold convs
TOOL_ITERS = 5  # timed calls per op in the tools phase
FRAMES = (2, 5)  # a frame time's warmup and timed frames (median of 5)
STAGE_ITERS = 2  # frames profile_stages times each stage over
# the tools drive the TransFusion flagship, which has no NMS, at fp32 in this process (their
# CLIs' bf16 default runs in the benchmark subprocesses)
TOOLS_ABSENT = {"greedy_nms", "sparse_conv_bf16", "sparse_conv_dw_bf16", "deform_im2col",
                "furthest_point_sample"}
SEG_BENCHMARK = "configs/nuscenes/seg/fusion-bev256d2-lss.yaml"  # the tools phase's second CLI run
CLI_SAMPLES = 4  # samples of the synthesized nuScenes-format set of phase 11d
TRAIN_CLI_SAMPLES = 3  # phase 11e's train split: CBGS makes 9 of them, 2 steps an epoch at B = 4
TRAIN_CLI_VAL_SAMPLES = 2  # phase 11e's val split (the seg config's per-epoch eval)
TRAIN_CLI_BATCH = 4  # the flagship's and the seg config's samples_per_gpu
DP_WORLD = 2  # ranks of phases 11e-dp and 13c: processes on the one card, over gloo
# 13c: the ranks' BatchNorm running statistics against one process's, relative in norm, plus
# TRAIN_GRAD_SENSITIVITY x how far R' moves them (the moments' summation order: two passes
# over the ranks in fp32 against cuDNN's batch norm)
DP_STATS_RTOL = 1e-4
# 13c at bf16: each loss of the ranks' step against one process's bf16 step (their BatchNorms
# round their bf16 outputs apart: the ranks normalise in fp32 and cast, one process in cuDNN)
BF16_DP_LOSS_GAP = 5e-2
# 13c: the parameters whose gradient may pass phase 12's rule (a share of them), each within
# this relative gap: a ReLU that only the ranks' rounding flips (dp_gates). Measured on one
# H100 (--gate-probe): two such tensors, 1.24e-2 and 1.83e-2 off, of 400; each control (a sync
# patched out) moves the whole gradient by 1.0-1.3 and is refused
DP_FLIP_SHARE = 0.01
DP_FLIP_RTOL = 5e-2
# 12b, the camera configs' train steps (B' the pool in float64): a gradient past the B' rule is
# held again with B'' (the pool's fp32 sums in reverse order) in place of B'; past that too, only
# the one tensor measured there on one H100 may pass, within CAMERA_TIE_RTOL of B's: det-resnet's
# heads.object.task_heads.1.dim.0.conv.weight, A vs B 6.27e-3 where B' moves it 6.9e-6 (A vs C 0:
# the backward is the plain one's), at 1.246 of the rule, the same bits in two runs
CAMERA_TIES = {"det-resnet": ("heads.object.task_heads.1.dim.0.conv.weight",)}
CAMERA_TIE_RTOL = 1e-2
# 11e-dp: the first step's loss of the train CLI at two ranks against one process at twice the
# batch, relative: within 2x the one-process run's run-to-run gap, this run's (O1-O2) or the
# largest measured on one H100 (2.81e-4 between two runs; 1.06e-5-1.52e-4 over ten pairs of
# five, --gate-probe; the ranks 2.0e-5-3.06e-4 from one process, the control without the
# normalisers' sum 1.01)
TRAIN_CLI_DP_RTOL = 6e-4
# 11e-dp: every dropout and drop-path rate of the flagship to 0 (each rank draws its own masks)
NO_DROPOUT = ["model.heads.object.dropout=0.0", "model.encoders.camera.backbone.drop_path_rate=0.0"]
# ``python3 chip_smoke.py --gate-probe``: the runs that measure the gates of 11e and 11e-dp
PROBE_RESUMES = 3  # runs B (resumed from A's epoch_1), at fp32 and at bf16
PROBE_RERUNS = 5  # reruns of A
PROBE_ONE_PROCESS = 5  # 11e-dp's one-process runs
PROBE_RANKS_RUNS = 2  # 11e-dp's two-rank runs (and one control)
# 14a: the exported flagship's launches a frame (and its graph's bevfusion:: nodes) by dtype
EXPORT_LAUNCHES = {"bfloat16": {"sparse_conv_bf16": SPARSE_LAUNCHES, "bev_pool": POOL_LAUNCHES},
                   "float32": {"sparse_conv": SPARSE_LAUNCHES, "bev_pool": POOL_LAUNCHES}}
# 14a, should the loaded program's boxes not be eager's bit for bit: its head's predictions
# before the top-k against eager's, relative (ROADMAP Queue 3, decode ties)
EXPORT_PRED_RTOL = 1e-5
# 14b: tools/train_longevity.py's short form, one whole schedule, the probe at mid-run
LONGEVITY_ARGS = ["--steps", "12", "--resume-probe", "3", "--scenes", "8"]
# 11g: VoteNet's PointNet2SASSG (mmdet3d configs/_base_/models/votenet.py): per SA level the
# points sampled, the radius, the samples a group and the MLP; the FP levels' MLPs; the points
# (SUN RGB-D's count in VoteNet), taken from the flagship scan
VOTENET_SA = ((2048, 0.2, 64, (64, 64, 128)), (1024, 0.4, 32, (128, 128, 256)),
              (512, 0.8, 16, (128, 128, 256)), (256, 1.2, 16, (128, 128, 256)))
VOTENET_FP = ((256, 256), (256, 256))
VOTENET_POINTS = 20000
TRANSFUSION_NMS_GROUPS = 2  # nuScenes' class groups with a radius > 0 (TransFusionHead.NMS_TASKS)
# the flagship's encoder in conv_module: the input conv and stages 0-2's three blocks each
# sparse (stage 3 dense), a launch each at B = 1
CONV_MODULE_LAUNCHES = 10


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


def bev_pool_exact(bp):
    """``bev_pool_plain`` in float64, rounded once to fp32: the camera
    configs' rounding-level change of the forward (phase 12b's B')."""
    def pool(depth, ctx, intervals, Z, X, Y):
        return bp.bev_pool_plain(depth.double(), ctx.double(), intervals, Z, X, Y).float()
    return pool


def bev_pool_reversed(bp):
    """``bev_pool_plain`` over the sorted points in reverse order, so each
    cell's fp32 sum runs the other way: the camera configs' second
    rounding-level change of the forward (phase 12b's B'')."""
    def pool(depth, ctx, iv, Z, X, Y):
        rev = bp.PoolIntervals(iv.ranks_depth.flip(0), iv.ranks_feat.flip(0),
                               iv.interval_starts, iv.interval_lengths.flip(0),
                               iv.interval_cells.flip(0))  # the plain version reads no start
        return bp.bev_pool_plain(depth, ctx, rev, Z, X, Y)
    return pool


@contextlib.contextmanager
def plain_kernels(sp, bp, conv=None, pool=None):
    """Every kernel wrapper replaced by its plain version (on CUDA tensors
    too) for the duration, the sparse conv by ``conv`` and the pool by
    ``pool`` where given; the wrappers' launch counts are untouched."""
    saved = sp.sparse_conv, sp.sparse_conv_dw, bp.bev_pool
    sp.sparse_conv, sp.sparse_conv_dw, bp.bev_pool = (
        conv or sp.sparse_conv_plain, sp.sparse_conv_dw_plain, pool or bp.bev_pool_plain)
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
        frames, peak = frame_ms(lambda: model(batch), *FRAMES)
    print(f"{label}: {statistics.median(frames):.2f} ms/frame median, "
          f"{statistics.mean(frames):.2f} mean, {min(frames):.2f} min over {len(frames)} frames; "
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
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


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
    """Phase 7: K7's three families against their plain versions (max|d| <=
    1e-4 * max(|plain|, 1); the bf16 family within one bf16 rounding of it
    plus that 1e-4, as phase 5b). The scalar family's four modes at both
    tiles, ``noskip`` equal to ``current`` bit for bit, and ``current`` at
    tile 64 (the scalar loop) within the same 1e-4 of ``sparse_conv`` with
    no epilogue (the tensor-core kernel). The tensor-core family's five
    modes (K1/K2's loop), ``tc`` equal to ``sparse_conv`` with no epilogue
    and ``tc_noskip`` to ``tc``, bit for bit; ``tc_1xtf32``'s max|d| from
    the fp32 plain conv. The bf16 family's four modes (K1/K2 bf16's loop) on
    the operands rounded to bf16, ``bf16`` equal to ``sparse_conv`` on them
    with no epilogue and ``bf16_noskip`` to ``bf16``, bit for bit. Returns
    {(shape, mode): (max|d| over the tiles, plain ms)} and {shape:
    tc_1xtf32's max|d| / max(|plain|, 1)}."""
    out, one_tf32 = {}, {}
    for label, feats, nbr, w in cases:
        new = sp.sparse_conv(feats, nbr, w)
        x16, w16 = feats.bfloat16(), w.bfloat16()
        new16 = sp.sparse_conv(x16, nbr, w16)
        for mode in kv.CONV_MODES:
            bf16 = mode in kv.BF16_MODES
            x, wm = (x16, w16) if bf16 else (feats, w)
            want = kv.sparse_conv_variant_plain(x, nbr, wm, mode)
            scale = max(want.abs().max().item(), 1.0)
            tiles = kv.TILES if mode in kv.MODES else (kv.TC_TILE,)
            errs = []
            for tile in tiles:
                got = kv.sparse_conv_variant(x, nbr, wm, mode, tile)
                torch.cuda.synchronize()
                d = (got.float() - want.float()).abs()
                errs.append(d.max().item())
                if bf16:
                    bad = int((d > BF16_REL * want.float().abs() + FP32_RTOL_KERNEL * scale).sum())
                    check(bad == 0, f"K7 {label} {mode}: {bad} elements past one bf16 rounding")
                else:
                    check(errs[-1] <= FP32_RTOL_KERNEL * scale,
                          f"K7 {label} {mode} tile {tile}: max|d| {errs[-1]} vs plain, scale "
                          f"{scale}")
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
                if mode == "bf16":
                    check(bits_equal(got, new16), f"K7 {label}: bf16 differs from sparse_conv")
                if mode == "bf16_noskip":
                    check(bits_equal(got, kv.sparse_conv_variant(x16, nbr, w16, "bf16")),
                          f"K7 {label}: bf16_noskip differs from bf16")
                if mode == "tc_1xtf32":
                    exact = kv.sparse_conv_variant_plain(feats, nbr, w, "tc")
                    one_tf32[label] = ((got - exact).abs().max().item()
                                       / max(exact.abs().max().item(), 1.0))
            plain_ms = kernel_ms(lambda: kv.sparse_conv_variant_plain(x, nbr, wm, mode))
            out[(label, mode)] = (max(errs), plain_ms)
            print(f"kernel sparse_conv_variants (K7) {label} {mode}: max|d| {max(errs):.3e} at "
                  f"tiles {tiles}, plain {plain_ms:.4f} ms")
        print(f"kernel sparse_conv_variants (K7) {label}: current at tile 64 (the scalar loop) "
              f"within {FP32_RTOL_KERNEL:g} of sparse_conv without epilogue, noskip equal to "
              f"current bit for bit; tc equal to sparse_conv without epilogue and tc_noskip to "
              f"tc bit for bit; bf16 equal to sparse_conv on bf16 operands without epilogue and "
              f"bf16_noskip to bf16 bit for bit; tc_1xtf32 max|d| / max(|fp32 plain|, 1) "
              f"{one_tf32[label]:.3e}")
        out.update(dw_variant_checks(kv, sp, label, x16, nbr))
    return out, one_tf32


def dw_variant_checks(kv, sp, label, x16, nbr):
    """K7's dw_bf16 family (K3 bf16's loop) at one case, on the bf16 rows and
    a seeded bf16 output gradient: ``dw_bf16`` and ``dw_bf16_nogather``
    within 1e-4 * max(|plain|, 1) of their plain versions, ``dw_bf16`` equal
    to ``sparse_conv_dw`` bit for bit; ``dw_bf16_noproduct`` and
    ``dw_bf16_compact`` (hit counts) equal to theirs. Returns {(shape,
    mode): (max|d|, None)}: the family is timed by ``--sparse-kernels``
    alone, not in phase 14."""
    g = torch.Generator(device=DEVICE).manual_seed(nbr.shape[1])
    dout = torch.randn(nbr.shape[1], x16.shape[1], generator=g, device=DEVICE).bfloat16()
    out = {}
    for mode in kv.DW_BF16_MODES:
        want = kv.sparse_conv_dw_variant_plain(x16, nbr, dout, mode)
        got = kv.sparse_conv_dw_variant(x16, nbr, dout, mode)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if mode in ("dw_bf16", "dw_bf16_nogather"):
            scale = max(want.abs().max().item(), 1.0)
            check(err <= FP32_RTOL_KERNEL * scale,
                  f"K7 {label} {mode}: max|d| {err} vs plain, scale {scale}")
        else:
            check(torch.equal(got, want), f"K7 {label} {mode}: not the hit counts")
        if mode == "dw_bf16":
            check(torch.equal(got, sp.sparse_conv_dw(x16, nbr, dout)),
                  f"K7 {label}: dw_bf16 differs from sparse_conv_dw")
        out[(label, mode)] = (err, None)
        print(f"kernel sparse_conv_variants (K7) {label} {mode}: max|d| {err:.3e}")
    return out


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
           "breakdown": kv.breakdown(cases, DEVICE, families=tuple(kv.FAMILIES))}
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

    # the data-parallel dry run at full width, two ranks on the card over gloo: the group, the
    # build and the broadcast only (13c runs and holds the ranks' steps)
    t0 = time.perf_counter()
    args = ["--ranks", str(DP_WORLD), "--dist-backend", "gloo", "--steps", "0"]
    proc = subprocess.run([sys.executable, "-m", "bevfusion_tpu_torch.tools.dryrun_flagship_sharded",
                           *args], capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    check(proc.returncode == 0 and len(rows) == DP_WORLD,
          f"dryrun_flagship_sharded {args}: exit {proc.returncode}, {proc.stderr[-2000:]}")
    for r in rows:
        print(f"tools: dryrun_flagship_sharded rank {r['rank']} of {r['world']} ({r['backend']}, "
              f"{r['dtype']}): built and replicated, peak {r['peak_mem_bytes'] / 2**20:.1f} MiB")
        check(r["world"] == DP_WORLD and not r["losses"]
              and not any(r["launches_per_step"].values()),
              f"dryrun_flagship_sharded rank {r['rank']}: {r}")
    print(f"tools: dryrun_flagship_sharded {' '.join(args)} in {time.perf_counter() - t0:.1f} s")
    res["dryrun_sharded"] = rows
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
    """ms/frame (median of 5), peak memory and the stages
    (``tools/profile_stages.py``, median of 5) with TF32 off, then on; TF32
    off again after."""
    from bevfusion_tpu_torch.tools import profile_stages

    out = {}
    for suffix, tf32 in (("", False), ("_tf32", True)):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        with torch.no_grad():
            frames, peak = frame_ms(lambda: model(batch), *FRAMES)
        out["frame_ms_median" + suffix] = statistics.median(frames)
        out["peak_mem_bytes" + suffix] = peak
        out["stage_ms" + suffix] = {
            r["stage"]: r["ms"]
            for r in profile_stages.profile_stages(model, batch, DEVICE, iters=STAGE_ITERS)[0]}
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


def traced(fn, mark=None):
    """``fn()`` on the card: its wall time (host clock around a synchronised
    call, after one warmup), then the same call once under
    ``torch.profiler``: the card's activities (kernels, copies), their
    summed device time, the part of it in kernels whose name holds ``mark``,
    the share of the wall time the card is idle, and the five kernel names
    with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    acts = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in acts) / 1e3
    by_name = {}
    for e in acts:
        n, ms = by_name.get(e.name[:90], (0, 0.0))
        by_name[e.name[:90]] = (n + 1, ms + e.device_time / 1e3)
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:5]
    return {"wall_ms": wall_ms, "device_activities": len(acts), "device_busy_ms": busy_ms,
            "mark_ms": sum(e.device_time for e in acts if mark and mark in e.name) / 1e3,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "top": [{"name": k, "count": n, "ms": ms} for k, (n, ms) in top]}


def decode_trace(head, preds):
    """``head.get_bboxes(preds)`` traced (``traced``), the NMS kernel's
    device time apart."""
    r = traced(lambda: head.get_bboxes(preds), "greedy_suppress")
    r["nms_kernel_ms"] = r.pop("mark_ms")
    return r


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


def cli_phase(counters, smi):
    """Phase 11d: the eval entry point on files. A seeded 4-sample
    nuScenes-format set (``data/synthetic.py``) under build/cli_smoke/ (six
    900 x 1600 PNG cameras a sample, jittered; a keyframe and 9 sweeps of
    30,000 points as .bin), a seeded checkpoint of each config
    (``save_checkpoint``) restored into a model on the card; the flagship
    through ``run_model_on_loader`` and ``format_results`` (what
    ``evaluate_dataset(metric="bbox")`` does before the devkit), the fused
    seg config through ``tools/test.py``'s ``main`` with ``--eval map``, each
    launch count set to 0 just before and read just after; one loaded
    sample's heatmap / map logits against the CPU model's on the same
    sample; the host pipeline's ms a sample and the frame's ms on a loaded
    sample with TF32 off and on. Returns {config: results}."""
    from bevfusion_tpu_torch.config import load_config
    from bevfusion_tpu_torch.data import DataLoader, build_dataset, collate
    from bevfusion_tpu_torch.data.synthetic import write_synthetic_nuscenes
    from bevfusion_tpu_torch.models import build_model
    from bevfusion_tpu_torch.runtime.checkpoint import restore_checkpoint, save_checkpoint
    from bevfusion_tpu_torch.runtime.eval import run_model_on_loader, to_model_batch
    from bevfusion_tpu_torch.runtime.flagship import FLAGSHIP_CONFIG, SEG_CONFIGS, init_weights
    from bevfusion_tpu_torch.tools import test as test_cli

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli_smoke")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_synthetic_nuscenes(root, num_samples=CLI_SAMPLES, seed=0)
    res = {"write_s": time.perf_counter() - t0}
    overrides = {"dataset_root": root + "/"}
    want = dict(dict.fromkeys(counters, 0), sparse_conv=SPARSE_LAUNCHES * CLI_SAMPLES,
                bev_pool=POOL_LAUNCHES * CLI_SAMPLES)

    def loaded(cfg, model, cpu_model, logits_of):
        """Sample 0 of the config's test set: the host pipeline's ms a sample
        (all samples, serially), the card's output against the CPU model's,
        and the frame on it with TF32 off and on."""
        dataset = build_dataset(cfg.data.test)
        t = time.perf_counter()
        samples = [dataset[i] for i in range(len(dataset))]
        out = {"pipeline_ms_per_sample": (time.perf_counter() - t) * 1e3 / len(samples),
               "points_in_sample0": int(samples[0]["points_mask"].sum())}
        np_batch = collate(samples[:1])
        for k in ("gt_masks_bev", "metas"):
            np_batch.pop(k, None)
        batch, cpu_batch = to_model_batch(np_batch, DEVICE), to_model_batch(np_batch, "cpu")
        with torch.no_grad():
            got = logits_of(model, batch)
            t = time.perf_counter()
            want_cpu = logits_of(cpu_model, cpu_batch)
            out["cpu_forward_s"] = time.perf_counter() - t
        out["rel_err"] = rel_err(got.cpu(), want_cpu)
        out["std"] = want_cpu.std().item()
        for suffix, tf32 in (("", False), ("_tf32", True)):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            with torch.no_grad():
                frames, peak = frame_ms(lambda: model(batch), *FRAMES)
            out["frame_ms_median" + suffix] = statistics.median(frames)
            out["peak_mem_bytes" + suffix] = peak
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        return out

    # the fused flagship: run_model_on_loader, then the submission
    t1 = time.perf_counter()
    cfg = load_config(FLAGSHIP_CONFIG, overrides=overrides)
    cpu_model = init_weights(build_model(cfg.model, "cpu"), seed=0)
    ckpt = os.path.join(root, "ckpt", "flagship", "epoch_1.pth")
    save_checkpoint(ckpt, cpu_model, meta={"seed": 0})
    model = build_model(cfg.model, DEVICE)
    restore_checkpoint(ckpt, model)
    dataset = build_dataset(cfg.data.test)
    loader = DataLoader(dataset, batch_size=1, num_workers=2, drop_last=False)
    torch.cuda.synchronize()
    zero_counts(counters)
    t = time.perf_counter()
    results = run_model_on_loader(model, loader)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    launches = {k: c.launches for k, c in counters.items()}
    check(launches == want, f"cli flagship: launches {launches}, want {want}")
    sub = dataset.format_results(results, os.path.join(root, "out", "results_nusc.json"))
    tokens = {info["token"] for info in dataset.data_infos}
    check(set(sub) == {"meta", "results"} and set(sub["results"]) == tokens
          and len(tokens) == CLI_SAMPLES, f"cli flagship: submission tokens {sorted(sub['results'])}")
    annos = [a for v in sub["results"].values() for a in v]
    keys = {"sample_token", "translation", "size", "rotation", "velocity", "detection_name",
            "detection_score", "attribute_name"}
    check(bool(annos) and all(set(a) == keys for a in annos), "cli flagship: submission schema")
    check(all(math.isfinite(x) for a in annos for k in ("translation", "size", "rotation",
                                                         "velocity") for x in a[k])
          and all(math.isfinite(a["detection_score"]) for a in annos),
          "cli flagship: a non-finite value in the submission")
    r = {"launches": launches, "eval_loop_s": loop_s, "boxes": len(annos),
         **loaded(cfg, model, cpu_model, lambda m, b: m.predict(b)["dense_heatmap"])}
    check(r["rel_err"] <= HEATMAP_RTOL, f"cli flagship: heatmap rel err {r['rel_err']}")
    r["seconds"] = time.perf_counter() - t1
    res["flagship"] = r
    print(f"cli flagship: {CLI_SAMPLES} loaded samples through run_model_on_loader in "
          f"{loop_s:.2f} s, launches {launches}; the submission holds {len(annos)} boxes over "
          f"{len(tokens)} tokens, every value finite; heatmap (std {r['std']:.3f}) vs the CPU "
          f"plain path on loaded sample 0 ({r['points_in_sample0']} points): rel err "
          f"{r['rel_err']:.3e} (CPU forward {r['cpu_forward_s']:.1f} s); host pipeline "
          f"{r['pipeline_ms_per_sample']:.1f} ms a sample; {r['frame_ms_median']:.2f} ms/frame "
          f"median on a loaded sample (TF32 on {r['frame_ms_median_tf32']:.2f} ms), peak "
          f"{r['peak_mem_bytes'] / 2**20:.1f} MiB; {smi}")
    del model, cpu_model, loader, results
    torch.cuda.empty_cache()

    # the fused seg config: tools/test.py end to end
    t1 = time.perf_counter()
    path = SEG_CONFIGS["fusion-bev256d2-lss"]
    cfg = load_config(path, overrides=overrides)
    cpu_model = init_weights(build_model(cfg.model, "cpu"), seed=0)
    ckpt = os.path.join(root, "ckpt", "seg", "epoch_1.pth")
    save_checkpoint(ckpt, cpu_model, meta={"seed": 0})
    torch.cuda.synchronize()
    zero_counts(counters)
    t = time.perf_counter()
    metrics = test_cli.main([path, ckpt, "--eval", "map", "--out-dir", os.path.join(root, "out"),
                             "--device", DEVICE, f"dataset_root={root}/"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    launches = {k: c.launches for k, c in counters.items()}
    check(launches == want, f"cli seg: launches {launches}, want {want}")
    want_keys = {f"map/{c}/iou@max" for c in cfg.map_classes} | {"map/mean/iou@max"}
    check(metrics is not None and set(metrics) == want_keys
          and all(math.isfinite(v) for v in metrics.values()), f"cli seg: map metrics {metrics}")
    model = build_model(cfg.model, DEVICE)
    restore_checkpoint(ckpt, model)

    def map_logits(m, b):
        out = []
        hook = m.heads["map"].classifier.register_forward_hook(lambda mod, a, o: out.append(o))
        m(b)
        hook.remove()
        return out[0]

    r = {"launches": launches, "cli_s": cli_s, "metrics": metrics,
         **loaded(cfg, model, cpu_model, map_logits)}
    check(r["rel_err"] <= HEATMAP_RTOL, f"cli seg: logits rel err {r['rel_err']}")
    r["seconds"] = time.perf_counter() - t1
    res["seg"] = r
    print(f"cli seg fusion-bev256d2-lss: tools/test.py --eval map on {CLI_SAMPLES} samples in "
          f"{cli_s:.2f} s, launches {launches}, metrics {metrics}; map logits (std "
          f"{r['std']:.3f}) vs the CPU plain path on loaded sample 0: rel err {r['rel_err']:.3e} "
          f"(CPU forward {r['cpu_forward_s']:.1f} s); host pipeline "
          f"{r['pipeline_ms_per_sample']:.1f} ms a sample; {r['frame_ms_median']:.2f} ms/frame "
          f"median on a loaded sample (TF32 on {r['frame_ms_median_tf32']:.2f} ms), peak "
          f"{r['peak_mem_bytes'] / 2**20:.1f} MiB; {smi}")
    del model, cpu_model
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return res


RESUME_PARTS = ("parameters", "buffers", "mu", "nu")
# 11e: the largest relative gap in norm of AdamW's ``nu`` to A's that a resume may show. On one
# H100 (``--gate-probe``, two runs at fp32 and bf16) a correct resume's reached 0.206 and a rerun
# of A's 0.306, while C's (the moments lost: nu holds only the second epoch) was 0.433-0.518 and
# reached 1.69x the reruns' when A itself was far from them: a cap between the two sets it apart
RESUME_NU_GAP = 0.37


def checkpoint_gaps(path_a: str, path_b: str):
    """Two train checkpoints side by side, in four parts: the trainable
    parameters (the state dict's entries the optimizer holds moments for),
    the buffers (BatchNorm statistics) and AdamW's ``mu`` and ``nu``. Returns
    ({part: {"max": the largest relative gap of a tensor, max|a - b| /
    max(|a|, |b|), "tensor": the tensor that holds it, "norm": the part's
    |a - b| / |a| over all its tensors, "abs": the largest |a - b|,
    "abs_tensor": its tensor}}, the names of the tensors that are
    bit-equal, the number of tensors). The optimizer's step counts must
    agree."""
    a, b = (torch.load(p, map_location="cpu", weights_only=False) for p in (path_a, path_b))
    check(a["optimizer"]["count"] == b["optimizer"]["count"] and a["meta"] == b["meta"],
          f"train-cli: {path_a} and {path_b} stand at other steps")
    params = set(a["optimizer"]["mu"])
    pairs = [("parameters" if k in params else "buffers", f"state_dict.{k}", v,
              b["state_dict"][k]) for k, v in a["state_dict"].items()]
    pairs += [(m, f"{m}.{k}", v, b["optimizer"][m][k]) for m in ("mu", "nu")
              for k, v in a["optimizer"][m].items()]
    gaps = {part: {"max": 0.0, "tensor": None, "abs": 0.0, "abs_tensor": None}
            for part in RESUME_PARTS}
    sq = {part: [0.0, 0.0] for part in RESUME_PARTS}  # sum (a - b)^2, sum a^2
    equal = set()
    for part, name, x, y in pairs:
        x, y = x.double(), y.double()
        sq[part][1] += x.square().sum().item()
        if bits_equal(x, y):
            equal.add(name)
            continue
        d = x - y
        sq[part][0] += d.square().sum().item()
        absd = d.abs().max().item()
        rel = absd / torch.maximum(x.abs().max(), y.abs().max()).item()
        if rel > gaps[part]["max"]:
            gaps[part].update(max=rel, tensor=name)
        if absd > gaps[part]["abs"]:
            gaps[part].update(abs=absd, abs_tensor=name)
    for part, (num, den) in sq.items():
        gaps[part]["norm"] = math.sqrt(num / den) if den > 0 else 0.0
    return gaps, equal, len(pairs)


def run_to_run(controls, pool=statistics.fmean):
    """The card's run-to-run gap from the (gaps, bit-equal names) of several
    uninterrupted runs against A: in each part the mean of their gaps
    (``pool``; the tensor named is the larger gap's), and the tensors
    bit-equal in all of them (on one H100 every rerun holds the same 69
    bit-equal)."""
    gaps = {p: {k: pool([g[p][k] for g, _ in controls]) for k in ("max", "norm", "abs")}
            for p in RESUME_PARTS}
    for p in RESUME_PARTS:
        for k, t in (("max", "tensor"), ("abs", "abs_tensor")):
            gaps[p][t] = max((g for g, _ in controls), key=lambda g: g[p][k])[p][t]
    return gaps, set.intersection(*(e for _, e in controls))


def resume_holds(gaps_b, equal_b, gaps_a2, equal_a2) -> bool:
    """The resume gate: in every part, B's gaps to A (the largest of a
    tensor and the part's norm) within 2x the run-to-run gap of the
    uninterrupted runs A' and A'' (``run_to_run``: the mean of their gaps),
    B bit-equal wherever both are, and ``nu``'s gap in norm within
    ``RESUME_NU_GAP``. The factor, the two reruns, their mean and the cap
    are the probe's (``gate_readings``; one H100, 3 resumes and 5 reruns at
    fp32 and bf16, twice; PERF.md §6): a correct resume's largest ratio to
    the mean of two reruns 1.75x (one rerun: 2.08x once), C's least 1.91x."""
    return (all(gaps_b[p][k] <= 2 * gaps_a2[p][k] for p in RESUME_PARTS
                for k in ("max", "norm")) and equal_a2 <= equal_b
            and gaps_b["nu"]["norm"] <= RESUME_NU_GAP)


def gate_readings(bs, reruns, c):
    """The probe's readings behind the resume gate (``python3 chip_smoke.py
    --gate-probe``), from the (gaps, bit-equal names) of several resumes B,
    several reruns of A and the control C: for the gate on one rerun, on the
    larger of two and on their mean (``run_to_run``), the largest ratio of a
    correct run's
    gap to the gate's base (each B, and each rerun against the others) over
    every part and gap, the least such largest ratio of C (what refuses it),
    the bases whose bit-equal tensors a B missed, and each run's gaps in
    norm. A gate of F x the base holds every correct run and refuses C where
    the first ratio stays below F and the second above."""
    def worst(gaps, base):
        return max((gaps[p][k] / base[p][k], f"{p} {k}") for p in RESUME_PARTS
                   for k in ("max", "norm") if base[p][k] > 0)

    idx = range(len(reruns))
    pairs = [(j, k) for j in idx for k in idx if j < k]
    out = {}
    for design, bases, pool in (("one", [(j,) for j in idx], max), ("two", pairs, max),
                                ("mean_of_two", pairs, statistics.fmean)):
        base = {js: run_to_run([reruns[j] for j in js], pool) for js in bases}
        b = [worst(g, base[js][0]) + (i, js) for i, (g, _) in enumerate(bs) for js in bases]
        a = [worst(reruns[i][0], base[js][0]) + (i, js) for i in idx for js in bases
             if i not in js]
        cs = [worst(c[0], base[js][0]) + (js,) for js in bases]
        out[design] = {"b_worst": max(b), "reruns_as_b_worst": max(a) if a else None,
                       "c_least": min(cs),
                       "b_bit_equal_missed": sum(not base[js][1] <= e for g, e in bs
                                                 for js in bases)}
    out["norms"] = {name: [{p: g[p]["norm"] for p in RESUME_PARTS} for g, _ in runs]
                    for name, runs in (("b", bs), ("reruns", reruns), ("c", [c]))}
    return out


def gaps_text(gaps) -> str:
    return "; ".join(f"{p} max {g['max']:.3e} ({g['tensor']}), norm "
                     f"{g['norm']:.3e}, max|d| {g['abs']:.3e} ({g['abs_tensor']})"
                     for p, g in gaps.items())


def nondeterministic_ops(model, np_batch, bp):
    """Which ops of the flagship's train step give other bits on the same
    inputs, each run twice on the card: the whole forward (the loss dict),
    the backward (every parameter's gradient), and the ops that sum with
    atomics or may: the voxel means' ``index_add_`` (ops/voxelize.py), the
    BEV pool's backward (ops/bev_pool.py:bev_pool_backward, ``index_add_``),
    and cuDNN's backward of the decoder's first conv. Returns {op: True
    where the two runs differ}, and the count of gradients that differ."""
    from bevfusion_tpu_torch.models.layers import set_dropout_generator
    from bevfusion_tpu_torch.models.vtransforms import build_pool_lut
    from bevfusion_tpu_torch.runtime.eval import to_model_batch

    batch = to_model_batch(np_batch, DEVICE)
    model.train()
    passes = []
    for _ in range(2):
        set_dropout_generator(model, torch.Generator(device=DEVICE).manual_seed(0))
        model.zero_grad(set_to_none=True)
        losses = model(batch)
        sum(v for k, v in losses.items() if k.startswith("loss/")).backward()
        passes.append(({k: v.detach() for k, v in losses.items()},
                       {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}))
    (l0, g0), (l1, g1) = passes
    out = {"forward (the loss dict)": any(not bits_equal(l0[k], l1[k]) for k in l0)}
    differ = sum(not bits_equal(g0[n], g1[n]) for n in g0)
    out["backward (the gradients)"] = differ > 0
    with torch.no_grad():
        vox = [model.lidar_voxelize(batch["points"], batch["points_mask"], training=True).feats
               for _ in range(2)]
    out["index_add_ of the voxel means (ops/voxelize.py)"] = not bits_equal(*vox)
    vt = model.encoders["camera"]["vtransform"]
    lut = build_pool_lut(vt.frustum, vt.dx, vt.bx, vt.nx, batch)
    iv = bp.PoolIntervals(*(lut[k] for k in bp.PoolIntervals._fields))
    X, Y, Z = vt.nx
    g = torch.Generator(device=DEVICE).manual_seed(2)
    B, N = batch["img"].shape[:2]
    fH, fW = vt.frustum.shape[1:3]
    depth = torch.randn(B, N, vt.D, fH, fW, generator=g, device=DEVICE).softmax(2)
    ctx = torch.randn(B, N, fH, fW, vt.C, generator=g, device=DEVICE)
    gout = torch.randn(B, Z * vt.C, X, Y, generator=g, device=DEVICE)
    grads = [bp.bev_pool_backward(depth, ctx, iv, gout, Z, X, Y) for _ in range(2)]
    out["bev_pool_backward's index_add_ (ops/bev_pool.py)"] = not all(
        bits_equal(a, b) for a, b in zip(*grads))
    conv = next(m for m in model.decoder["backbone"].modules()
                if isinstance(m, torch.nn.Conv2d))
    x = torch.randn(B, conv.in_channels, X // 2, Y // 2, generator=g, device=DEVICE)
    dy = torch.randn(conv(x).shape, generator=g, device=DEVICE)
    conv_grads = [torch.autograd.grad(conv(x.requires_grad_()), (x, conv.weight), dy)
                  for _ in range(2)]
    out["cuDNN conv2d backward (decoder.backbone's first conv)"] = not all(
        bits_equal(a, b) for a, b in zip(*conv_grads))
    model.zero_grad(set_to_none=True)
    return out, differ


def train_cli_dp(run, root, lidar, fp32, per_step, smi, probe=False):
    """Phase 11e-dp: the flagship through ``tools/train.py`` as two processes
    on the card (``--dist-backend gloo``, ``samples_per_gpu`` 2 each, the
    group from torchrun's environment variables) for one epoch of phase
    11e's set, ``--load-from`` the TransFusion-L checkpoint, fp32, every
    dropout rate 0, against one process at samples_per_gpu 4 run twice (O1,
    O2; ``run``: the train CLI in this process, its launches checked): both
    ranks take O1's steps and log the same losses, each launches K1/K2 29 x 2
    and K3 15 x 2 a step and K4 once, rank 0 alone writes ``epoch_1``, no
    tensor differed from rank 0's at the start, and the first step's loss is
    within the one-process runs' run-to-run gap of O1's: 2x O1-O2's, or
    ``TRAIN_CLI_DP_RTOL``, the largest measured. With ``probe`` (``python3
    chip_smoke.py --gate-probe``) ``PROBE_ONE_PROCESS`` one-process runs,
    ``PROBE_RANKS_RUNS`` two-rank runs and a control with the loss
    normalisers' sum over the ranks patched out (``without_sync``), no gate
    raised: the readings behind ``TRAIN_CLI_DP_RTOL``. Returns the results."""
    from bevfusion_tpu_torch.runtime.flagship import FLAGSHIP_CONFIG

    t0 = time.perf_counter()
    one = ["--load-from", lidar, "--device", DEVICE, f"dataset_root={root}/", "max_epochs=1",
           "evaluation.disable=true", *fp32, *NO_DROPOUT]
    dp = {}
    names = [f"o{i + 1}" for i in range(PROBE_ONE_PROCESS if probe else 2)]
    for name in names:
        dp[name], _ = run(f"{name} (one process, 1 epoch, no dropout)",
                          [FLAGSHIP_CONFIG, "--run-dir", os.path.join(root, "runs", name), *one],
                          per_step)
        torch.cuda.empty_cache()
    steps = dp["o1"]["steps"]
    per_rank = {k: v * (TRAIN_CLI_BATCH // DP_WORLD) * steps for k, v in _SPARSE_STEP.items()}
    per_rank["bev_pool"] = POOL_LAUNCHES * steps

    def ranks_run(name, sync=None):
        """The two ranks' run ``name`` (``sync`` patched out on both), its
        checks; returns each rank's line."""
        run_dp = os.path.join(root, "runs", name)
        argv = [FLAGSHIP_CONFIG, "--run-dir", run_dp, "--dist-backend", "gloo", *one,
                f"data.samples_per_gpu={TRAIN_CLI_BATCH // DP_WORLD}"]
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", DP_CLI_CODE, os.path.dirname(os.path.abspath(__file__)),
             json.dumps(argv), sync or ""], stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, WORLD_SIZE=str(DP_WORLD), RANK=str(r), LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port))) for r in range(DP_WORLD)]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        check(all(p.returncode == 0 for p in procs),
              f"train-cli {name}: ranks exited {[p.returncode for p in procs]}")
        ranks = [json.loads(next(line[7:] for line in o.splitlines()
                                 if line.startswith("DP_CLI "))) for o in outs]
        for r in ranks:
            print(f"train-cli {name} rank {r['rank']} of {r['world']}"
                  + (f" (without the sum of {sync})" if sync else "")
                  + f": {r['steps']} steps at samples_per_gpu {TRAIN_CLI_BATCH // DP_WORLD}; "
                  f"losses {[round(v, 4) for v in r['losses']]}; ms a step "
                  f"{[round(v, 1) for v in r['step_ms']]} (gloo on CUDA tensors, both ranks on "
                  f"the card); peak {r['peak_mem_bytes'] / 2**20:.1f} MiB; launches "
                  f"{r['launches']}; checkpoints {[os.path.basename(c) for c in r['checkpoints']]}"
                  f"; {smi}")
            check(r["steps"] == steps and r["world"] == DP_WORLD,
                  f"train-cli {name} rank {r['rank']}: {r['steps']} steps, want {steps}")
            check(r["losses"] == ranks[0]["losses"]
                  and all(math.isfinite(v) for v in r["losses"]),
                  f"train-cli {name} rank {r['rank']}: losses {r['losses']} against rank 0's")
            want = dict(dict.fromkeys(r["launches"], 0), **per_rank)
            check(r["launches"] == want, f"train-cli {name} rank {r['rank']}: launches "
                  f"{r['launches']}, want {want}")
            check(r["checkpoints"] == ([os.path.join(run_dp, "epoch_1")] if r["rank"] == 0
                                       else []) and r["replicated"] == 0,
                  f"train-cli {name} rank {r['rank']}: checkpoints {r['checkpoints']}, "
                  f"{r['replicated']} tensors took rank 0's values")
        written = sorted(f for f in os.listdir(run_dp) if f.startswith("epoch_"))
        check(written == ["epoch_1"], f"train-cli {name}: the run directory holds {written}")
        return ranks

    first = {n: dp[n]["loss_first"] for n in names}
    a0, a2 = first["o1"], first["o2"]
    limit = max(2 * abs(a2 - a0), TRAIN_CLI_DP_RTOL * abs(a0))
    out = dict(dp, ranks=ranks_run("dp"))
    d0 = out["ranks"][0]["losses"][0]
    print(f"train-cli dp: the first step's loss {d0:.6f} against one process's {a0:.6f} "
          f"(rel {abs(d0 - a0) / abs(a0):.3e}; its run-to-run gap {abs(a2 - a0) / abs(a0):.3e}, "
          f"the gate {limit / abs(a0):.3e}); checkpoints in the run directory ['epoch_1']")
    if probe:
        losses = {"one_process": first}
        for i in range(1, PROBE_RANKS_RUNS):
            losses[f"dp{i + 1}"] = ranks_run(f"dp{i + 1}")[0]["losses"][0]
        losses["dp"] = d0
        losses["control_count_sum"] = ranks_run("dp_without", "count_sum")[0]["losses"][0]
        vals = list(first.values())
        rel = {"one_process_pairs": sorted(abs(x - y) / abs(a0) for i, x in enumerate(vals)
                                           for y in vals[i + 1:]),
               "ranks_vs_each": {k: [abs(v - x) / abs(a0) for x in vals]
                                 for k, v in losses.items() if k != "one_process"}}
        print(f"gate-probe train-cli dp: first-step losses {losses}; relative gaps {rel}")
        out["probe"] = {"first_losses": losses, "rel_gaps": rel}
    else:
        check(abs(d0 - a0) <= limit, f"train-cli dp: the first step's loss {d0} against {a0} "
              f"(run to run {a2})")
    return dict(out, loss_rel_gap=abs(d0 - a0) / abs(a0),
                run_to_run_rel_gap=abs(a2 - a0) / abs(a0), seconds=time.perf_counter() - t0)


DP_CLI_CODE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from bevfusion_tpu_torch import parallel
from bevfusion_tpu_torch.ops import bev_pool as bp, sparse_conv as sp
from bevfusion_tpu_torch.tools import train
kernels = {"sparse_conv": sp.sparse_conv, "sparse_conv_dw": sp.sparse_conv_dw,
           "sparse_conv_bf16": sp.sparse_conv_bf16, "sparse_conv_dw_bf16": sp.sparse_conv_dw_bf16,
           "bev_pool": bp.bev_pool}
if sys.argv[3] == "count_sum":  # the probe's control: each rank's own loss normalisers
    parallel.count_sum = lambda t: t.detach()
out = train.main(json.loads(sys.argv[2]))
print("DP_CLI " + json.dumps({
    "rank": out["rank"], "world": out["world"], "steps": len(out["history"]),
    "losses": [h["loss"] for h in out["history"]], "step_ms": [h["step_ms"] for h in out["history"]],
    "checkpoints": out["checkpoints"], "replicated": len(out.get("replicated", [])),
    "launches": {k: c.launches for k, c in kernels.items()},
    "peak_mem_bytes": torch.cuda.max_memory_allocated()}))
"""


def train_cli_phase(counters, smi, bp, probe=False):
    """Phase 11e: the train entry point on files. A seeded nuScenes-format
    set under build/train_cli_smoke/ (``write_synthetic_nuscenes`` with a
    train split of ``TRAIN_CLI_SAMPLES``, boxes around keyframe points) and
    its GT database (``create_gt_database``); a seeded TransFusion-L
    (voxelnet_0p075) checkpoint. Run A: the flagship through
    ``tools/train.py``'s ``main`` for 2 epochs at its samples_per_gpu (4),
    ``--load-from`` the TransFusion-L checkpoint (the fused recipe), eval
    off (no devkit), both epochs' checkpoints kept; run B: resumed from A's
    ``epoch_1``; A and B's final state compared (``checkpoint_gaps``: the
    parameters, the buffers, ``mu`` and ``nu`` apart), and where they differ
    runs A' and A'' (A again, twice) and C (resumed from ``epoch_1`` with
    the moments zeroed): in every part B's gap within 2x the mean of A''s
    and A'''s (``run_to_run``), B bit-equal wherever both are and its
    ``nu`` gap within ``RESUME_NU_GAP`` (``resume_holds``), C refused
    by the same gate, and the ops that give other bits on
    the same inputs named (``nondeterministic_ops``); the fp32 runs are
    followed by ``train_cli_dp`` (11e-dp). Then the fused seg
    config for 1 epoch with its per-epoch ``map`` eval. Each run's launches
    against ``_SPARSE_STEP`` x the batch + one pool a step (+ ``POOL_LAUNCHES``
    / 15 sparse convs a val sample for the seg eval), and the matcher's calls
    timed (``timed_auction``), TF32 on. Returns the results."""
    from bevfusion_tpu_torch.config import load_config
    from bevfusion_tpu_torch.data import DataLoader, build_dataset
    from bevfusion_tpu_torch.data.converter import create_gt_database
    from bevfusion_tpu_torch.data.synthetic import CLASSES, write_synthetic_nuscenes
    from bevfusion_tpu_torch.models import build_model
    from bevfusion_tpu_torch.runtime.checkpoint import restore_checkpoint, save_checkpoint
    from bevfusion_tpu_torch.runtime.flagship import (FLAGSHIP_CONFIG, LIDAR_SLICE_CONFIG,
                                                      SEG_CONFIGS, init_weights)
    from bevfusion_tpu_torch.tools import train as train_cli
    from bevfusion_tpu_torch.tools.bench_train_step import timed_auction

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_cli_smoke")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_synthetic_nuscenes(root, num_samples=TRAIN_CLI_VAL_SAMPLES, seed=0,
                             train_samples=TRAIN_CLI_SAMPLES)
    create_gt_database(root, os.path.join(root, "nuscenes_infos_train.pkl"), CLASSES)
    res = {"write_s": time.perf_counter() - t0}
    lidar = os.path.join(root, "ckpt", "transfusion_l.pth")
    save_checkpoint(lidar, init_weights(build_model(load_config(LIDAR_SLICE_CONFIG).model, "cpu"),
                                        seed=0))
    common = ["--device", DEVICE, f"dataset_root={root}/", "max_epochs=2",
              "evaluation.disable=true", "checkpoint.max_keep=2"]
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True

    def run(name, argv, per_step, per_val=None):
        """``tools/train.py``'s main on ``argv``, the counts set to 0 just
        before and read just after; the launches against ``per_step`` x its
        steps (+ ``per_val`` x the val samples evaluated)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        t = time.perf_counter()
        auctions = []
        with timed_auction(auctions, DEVICE):
            out = train_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {k: c.launches for k, c in counters.items()}
        steps = len(out["history"])
        evals = len(out["eval"]) * TRAIN_CLI_VAL_SAMPLES
        want = {k: per_step.get(k, 0) * steps + (per_val or {}).get(k, 0) * evals
                for k in counters}
        check(launches == want, f"train-cli {name}: launches {launches}, want {want} "
              f"({steps} steps, {evals} val samples)")
        losses = [h["loss"] for h in out["history"]]
        check(steps > 0 and all(math.isfinite(v) for v in losses),
              f"train-cli {name}: losses {losses}")
        r = {"launches": launches, "launches_want": want, "steps": steps,
             "steps_per_epoch": out["steps_per_epoch"], "start_epoch": out["start_epoch"],
             "step_ms_median": statistics.median(h["step_ms"] for h in out["history"]),
             "wait_ms_median": statistics.median(h["wait_ms"] for h in out["history"]),
             "step_ms": [h["step_ms"] for h in out["history"]],
             "wait_ms": [h["wait_ms"] for h in out["history"]],
             "loss_first": losses[0], "loss_last": losses[-1],
             "peak_mem_bytes_own": torch.cuda.max_memory_allocated() - resident,
             "checkpoint_bytes": os.path.getsize(out["checkpoints"][-1]),
             "eval": out["eval"], "seconds": seconds,
             "auction_ms": [ms for ms, _, _ in auctions],
             "auction_assigned": [[a, v] for _, a, v in auctions]}
        print(f"train-cli {name}: {steps} steps ({out['steps_per_epoch']} an epoch, from epoch "
              f"{out['start_epoch']}) in {seconds:.1f} s; median {r['step_ms_median']:.1f} ms a "
              f"step (TF32 on), {r['wait_ms_median']:.1f} ms a step waiting on the loader; loss "
              f"{r['loss_first']:.4f} -> {r['loss_last']:.4f}; peak "
              f"{r['peak_mem_bytes_own'] / 2**20:.1f} MiB; checkpoint "
              f"{r['checkpoint_bytes'] / 2**20:.1f} MiB; launches {launches} (want {want}); {smi}")
        if auctions:
            ms = r["auction_ms"]
            print(f"train-cli {name}: the matcher {len(ms)} calls ({len(ms) / steps:g} a step), "
                  f"median {statistics.median(ms):.1f} ms a call (min {min(ms):.1f}, max "
                  f"{max(ms):.1f}), {sum(ms) / steps:.1f} ms a step, "
                  f"{sum(ms) / sum(r['step_ms']):.1%} of the steps' time; rows assigned / valid "
                  f"a call {r['auction_assigned']}")
        return r, out

    def flagship_runs(out, tag, extra, per_step, name_ops):
        """Runs A, B and, where they differ, A', A'' and C of the flagship with the
        extra arguments ``extra`` (the compute dtype), their results into
        ``out``; with ``name_ops`` the ops that are not deterministic are
        named too. With ``probe``, ``PROBE_RESUMES`` runs B and
        ``PROBE_RERUNS`` reruns of A, the gate's readings (``gate_readings``)
        recorded and no gate raised."""
        run_a = os.path.join(root, "runs", "a" + tag.strip())
        out["a"], out_a = run(f"A{tag} (flagship, 2 epochs, load_from TransFusion-L)",
                              [FLAGSHIP_CONFIG, "--run-dir", run_a, "--load-from", lidar,
                               *common, *extra], per_step)
        prefixes = {".".join(k.split(".")[:2]) for k in out_a["missing_keys"]}
        check(prefixes == {"encoders.camera", "fuser.0", "fuser.1"}
              and not out_a["unexpected_keys"],
              f"train-cli A{tag}: load_from left {sorted(prefixes)} missing, "
              f"{out_a['unexpected_keys'][:3]} unexpected")
        out["a"]["missing_keys"] = len(out_a["missing_keys"])
        for epoch in (1, 2):
            ckpt = torch.load(os.path.join(run_a, f"epoch_{epoch}"), map_location="cpu",
                              weights_only=False)
            check(ckpt["meta"] == {"epoch": epoch, "iter": epoch * out_a["steps_per_epoch"]}
                  and ckpt["optimizer"]["count"] == epoch * out_a["steps_per_epoch"],
                  f"train-cli A{tag}: epoch_{epoch} holds {ckpt['meta']}")
            del ckpt

        def gaps_to_a(name, label, argv):
            run_x = os.path.join(root, "runs", name + tag.strip())
            out[name], _ = run(f"{label}{tag}", [FLAGSHIP_CONFIG, "--run-dir", run_x, *argv,
                                                 *common, *extra], per_step)
            return checkpoint_gaps(os.path.join(run_a, "epoch_2"), os.path.join(run_x, "epoch_2"))

        resume = ["--resume-from", os.path.join(run_a, "epoch_1")]
        bs = [gaps_to_a("b" if i == 0 else f"b{i + 1}", f"B{i + 1 if i else ''} (resumed from "
                        "A's epoch_1)", resume) for i in range(PROBE_RESUMES if probe else 1)]
        check(out["b"]["start_epoch"] == 1,
              f"train-cli B{tag}: started at epoch {out['b']['start_epoch']}")
        gaps_b, equal_b, n = bs[0]
        out["resume"] = {"gaps_b": gaps_b, "bit_equal_b": len(equal_b), "tensors": n}
        if len(equal_b) == n:
            print(f"train-cli{tag} resume: B's final weights, buffers and optimizer moments "
                  f"equal A's bit for bit ({n} tensors)")
            return
        # A again: A' and A'' (the gate's), more with probe
        reruns = [gaps_to_a(f"a{i + 2}", "A" + "'" * (i + 1) + " (A again)",
                            ["--load-from", lidar])[:2]
                  for i in range(PROBE_RERUNS if probe else 2)]
        gaps_a2, equal_a2 = run_to_run(reruns[:2])
        # the gate's control: a resume that keeps the weights and the step count but
        # loses AdamW's moments must be refused
        lost = torch.load(os.path.join(run_a, "epoch_1"), map_location="cpu",
                          weights_only=False)
        for m in ("mu", "nu"):
            lost["optimizer"][m] = {k: torch.zeros_like(v)
                                    for k, v in lost["optimizer"][m].items()}
        lost_path = os.path.join(root, "ckpt", "epoch_1_moments_lost" + tag.strip())
        torch.save(lost, lost_path)
        del lost
        gaps_c, equal_c, _ = gaps_to_a("c", "C (resumed from A's epoch_1 with the moments "
                                       "zeroed)", ["--resume-from", lost_path])
        out["resume"].update(gaps_a2=gaps_a2, bit_equal_a2=len(equal_a2), gaps_c=gaps_c,
                             bit_equal_c=len(equal_c))
        if name_ops and not probe:
            cfg = load_config(FLAGSHIP_CONFIG, overrides={"dataset_root": root + "/"})
            model = build_model(cfg.model, DEVICE)
            restore_checkpoint(os.path.join(run_a, "epoch_2"), model)
            np_batch = next(iter(DataLoader(build_dataset(cfg.data.train), TRAIN_CLI_BATCH,
                                            num_workers=2)))
            np_batch.pop("metas", None)
            ops, grads_differ = nondeterministic_ops(model, np_batch, bp)
            del model
            out["resume"].update(ops=ops, gradients_differ=grads_differ)
            print(f"train-cli resume: on the same inputs twice: {grads_differ} gradients "
                  f"differ; " + "; ".join(f"{op}: {'differs' if d else 'bit-equal'}"
                                          for op, d in ops.items()))
        print(f"train-cli{tag} resume, each part's gaps to A's final state (the largest "
              f"relative gap of a tensor and the tensor, the part's relative gap in norm, "
              f"the largest absolute gap and its tensor): B {gaps_text(gaps_b)}; "
              f"{len(equal_b)} of {n} tensors bit-equal")
        print(f"train-cli{tag} resume: A' and A'', the mean of each part's gaps "
              f"{gaps_text(gaps_a2)}; {len(equal_a2)} bit-equal in both")
        print(f"train-cli{tag} resume: C (moments lost) {gaps_text(gaps_c)}; "
              f"{len(equal_c)} bit-equal")
        if probe:
            out["probe"] = gate_readings([b[:2] for b in bs], reruns, (gaps_c, equal_c))
            print(f"gate-probe train-cli{tag}: {json.dumps(out['probe'])}")
            return
        check(resume_holds(gaps_b, equal_b, gaps_a2, equal_a2),
              f"train-cli{tag} resume: B {gaps_text(gaps_b)} against 2x the mean of A' and A'' "
              f"and nu's cap {RESUME_NU_GAP:g}: "
              f"{gaps_text(gaps_a2)}; bit-equal in A' and A'' but not in B: "
              f"{sorted(equal_a2 - equal_b)[:5]}")
        check(not resume_holds(gaps_c, equal_c, gaps_a2, equal_a2),
              f"train-cli{tag} resume: the gate passed C, a resume that lost the moments: "
              f"{gaps_text(gaps_c)}")

    per_step = {k: v * TRAIN_CLI_BATCH for k, v in _SPARSE_STEP.items()}
    per_step["bev_pool"] = POOL_LAUNCHES  # one pool a step: the batch's intervals together
    fp32 = ["precision.compute_dtype=float32"]  # the config's own is bf16
    flagship_runs(res, "", fp32, per_step, True)
    torch.cuda.empty_cache()

    res["dp"] = train_cli_dp(run, root, lidar, fp32, per_step, smi, probe)
    # again at the config's own precision, bf16: the bf16 kernels' launches
    res["bf16"] = {}
    per_step_bf16 = {k: v * TRAIN_CLI_BATCH for k, v in BF16_TRAIN_LAUNCHES.items()}
    per_step_bf16["bev_pool"] = POOL_LAUNCHES
    flagship_runs(res["bf16"], " bf16", [], per_step_bf16, False)
    torch.cuda.empty_cache()
    if probe:
        shutil.rmtree(root, ignore_errors=True)
        return res

    # the fused seg config: 1 epoch and its per-epoch map eval, inside the loop
    path = SEG_CONFIGS["fusion-bev256d2-lss"]
    res["seg"], out_seg = run(
        "seg fusion-bev256d2-lss (1 epoch + map eval)",
        [path, "--run-dir", os.path.join(root, "runs", "seg"), "--device", DEVICE,
         f"dataset_root={root}/", "max_epochs=1", *fp32], per_step,
        {"sparse_conv": SPARSE_LAUNCHES, "bev_pool": POOL_LAUNCHES})
    want_keys = {f"map/{c}/iou@max" for c in load_config(path).data.val.map_classes} | {
        "map/mean/iou@max"}
    metrics = out_seg["eval"].get(1)
    check(metrics is not None and set(metrics) == want_keys
          and all(math.isfinite(v) for v in metrics.values()),
          f"train-cli seg: the loop's eval gave {metrics}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    return res


def counted(counters, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after: (its result, {kernel: launches})."""
    torch.cuda.synchronize()
    zero_counts(counters)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def dcn_frame(counters, none):
    """11g (i): the swint camera CenterHead config with ``separate_head.type:
    DCNSeparateHead``, one eval frame on the card (launches: the pool once, D1
    twice a task, the greedy pass once a task); every task's maps against the
    same head on the CPU from the card's head input; then D1 alone against
    its plain version at that head's input with random offsets. Returns
    (results, D1's shape entry)."""
    from bevfusion_tpu_torch.config import load_config
    from bevfusion_tpu_torch.models import build_model
    from bevfusion_tpu_torch.ops import deform_conv as dc
    from bevfusion_tpu_torch.runtime.flagship import (DET_CAMERA_CONFIGS, add_pool_lut, batch_to,
                                                      init_weights, synthetic_batch)

    cfg = load_config(DET_CAMERA_CONFIGS["swint"],
                      overrides={"model.heads.object.separate_head.type": "DCNSeparateHead"})
    model = init_weights(build_model(cfg.model, "cpu"), 0).to(DEVICE)
    batch = batch_to(add_pool_lut(cfg, synthetic_batch(cfg, B=1, num_points=1000, seed=0)),
                     DEVICE)
    head = model.heads["object"]
    seen = {}
    hooks = [head.register_forward_pre_hook(lambda m, a: seen.setdefault("x", a[0])),
             head.register_forward_hook(lambda m, a, out: seen.setdefault("maps", out))]
    with torch.no_grad():
        _, launches = counted(counters, lambda: model(batch)["boxes"])
    for h in hooks:
        h.remove()
    want = dict(none, bev_pool=POOL_LAUNCHES, greedy_nms=6, deform_im2col=2 * 6)
    check(launches == want, f"11g dcn: launches {launches}, want {want}")
    t0 = time.perf_counter()
    cpu_head = copy.deepcopy(head).cpu()
    with torch.no_grad():
        cpu_maps = cpu_head(seen["x"].cpu())
        x = head.shared_conv(seen["x"]).permute(0, 2, 3, 1).contiguous()  # D1's input, NHWC
    cpu_s = time.perf_counter() - t0
    map_err = max(rel_err(m[k].cpu(), c[k]) for m, c in zip(seen["maps"], cpu_maps) for k in c)
    check(map_err <= HEATMAP_RTOL, f"11g dcn: head maps rel err {map_err} > {HEATMAP_RTOL}")
    # D1 alone: offsets of a few pixels, some taps on integers, some wholly outside
    g = torch.Generator(device=DEVICE).manual_seed(3)
    off = torch.rand(*x.shape[:3], 18, generator=g, device=DEVICE) * 6 - 3
    off = torch.where(torch.rand(off.shape, generator=g, device=DEVICE) < 0.3, off.round(), off)
    off = torch.where(torch.rand(off.shape, generator=g, device=DEVICE) < 0.05, 40.0, off)
    got = dc.deform_im2col(x, off, None, 3, 1, 1)
    plain = dc.deform_im2col_plain(x, off, None, 3, 1, 1)
    torch.cuda.synchronize()
    err = (got - plain).abs().max().item()
    check(err <= FP32_RTOL_KERNEL * max(plain.abs().max().item(), 1.0),
          f"11g D1: max|d| {err} against its plain version")
    ms = kernel_ms(lambda: dc.deform_im2col(x, off, None, 3, 1, 1))
    plain_ms = kernel_ms(lambda: dc.deform_im2col_plain(x, off, None, 3, 1, 1))
    # per column element 4 products and 3 sums of the corners; bytes: x, offsets, columns
    bound_ms, bound_by = bound(7 * got.numel(), nbytes(x, off, got))
    shape = {"shape": f"x {tuple(x.shape)} NHWC, K 9, col {tuple(got.shape)}", "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "share": bound_ms / ms, "max_abs_err": err, "bit_equal": bits_equal(got, plain)}
    print(f"11g dcn: swint CenterHead with DCNSeparateHead, launches {launches}; head maps vs "
          f"the CPU head on the card's head input: rel err {map_err:.3e} (CPU {cpu_s:.1f} s)")
    print(f"kernel deform_im2col (D1) at {shape['shape']}: {ms:.4f} ms (plain {plain_ms:.4f} "
          f"ms), bound {bound_ms:.4f} ms ({bound_by}), share {shape['share']:.3f}, max|d| "
          f"{err:.3e}, bit-equal {shape['bit_equal']}")
    return {"launches": launches, "head_maps_rel_err": map_err, "cpu_head_s": cpu_s}, shape


def votenet_stack(in_channels):
    """VoteNet's PointNet2SASSG (mmdet3d configs/_base_/models/votenet.py) from
    the ported modules: four SA modules, two FP modules, seeded weights."""
    from bevfusion_tpu_torch.models.pointnet_modules import PointFPModule, PointSAModuleMSG
    from bevfusion_tpu_torch.runtime.flagship import init_weights

    sa, c = [], in_channels
    for num, radius, samples, mlp in VOTENET_SA:
        sa.append(PointSAModuleMSG(num, (radius,), (samples,), (mlp,), in_channels=c))
        c = mlp[-1]
    fp = [PointFPModule(VOTENET_FP[0], in_channels=256 + 256),
          PointFPModule(VOTENET_FP[1], in_channels=VOTENET_FP[0][-1] + 256)]
    return init_weights(torch.nn.ModuleList(sa + fp), 4).eval()


def votenet_forward(stack, xyz, feats):
    """The SA levels then the FP levels (PointNet2SASSG.forward): the last FP
    output [num_points of SA2, 256] and every SA level's sampled points."""
    xyzs, fs = [xyz], [feats]
    for sa in stack[:4]:
        x, f = sa(xyzs[-1], fs[-1])
        xyzs.append(x)
        fs.append(f)
    f = stack[4](xyzs[3], xyzs[4], fs[3], fs[4])
    f = stack[5](xyzs[2], xyzs[3], fs[2], f)
    return f, xyzs[1:]


def pointnet_part(counters, none, cpu_batch):
    """11g (ii): D2 against its plain version (bit-equal indices) at the four
    SA levels' sampling, then the VoteNet stack on 20,000 points of the
    flagship scan on the card (launches: D2 once a level) against the same
    weights on the CPU. Returns (results, D2's shape entries)."""
    from bevfusion_tpu_torch.ops import pointnet as pn

    pts = cpu_batch["points"][0][cpu_batch["points_mask"][0]]
    pick = torch.randperm(pts.shape[0], generator=torch.Generator().manual_seed(5))
    pts = pts[pick[:VOTENET_POINTS]]
    xyz_cpu, feats_cpu = pts[:, :3].contiguous(), pts[:, 3:4].contiguous()  # xyz, intensity
    stack = votenet_stack(1)
    card = copy.deepcopy(stack).to(DEVICE)
    xyz, feats = xyz_cpu.to(DEVICE), feats_cpu.to(DEVICE)
    with torch.no_grad():
        (out, xyzs), launches = counted(counters, lambda: votenet_forward(card, xyz, feats))
    want = dict(none, furthest_point_sample=len(VOTENET_SA))
    check(launches == want, f"11g votenet: launches {launches}, want {want}")
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_out, cpu_xyzs = votenet_forward(stack, xyz_cpu, feats_cpu)
    cpu_s = time.perf_counter() - t0
    check(all(torch.equal(a.cpu(), b) for a, b in zip(xyzs, cpu_xyzs)),
          "11g votenet: the sampled points differ from the CPU's")
    out_err = rel_err(out.cpu(), cpu_out)
    check(tuple(out.shape) == (VOTENET_SA[1][0], VOTENET_FP[1][-1]) and out_err <= HEATMAP_RTOL
          and bool(torch.isfinite(out).all()), f"11g votenet: {tuple(out.shape)}, rel err {out_err}")
    shapes, src = [], xyz
    for (num, *_), nxt in zip(VOTENET_SA, xyzs):
        got = pn.furthest_point_sample(src, num)
        plain = pn.furthest_point_sample_plain(src[None], num)[0]
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"11g D2: indices at N {src.shape[0]} differ from plain")
        ms = kernel_ms(lambda: pn.furthest_point_sample(src, num))
        plain_ms = time_fn(lambda: pn.furthest_point_sample_plain(src[None], num), iters=3,
                           warmup=1, device=DEVICE, queue_ahead=True)["median_ms"]
        # a round: 3 differences, 3 products, 2 sums, a min and a compare per point
        bound_ms, bound_by = bound(10 * src.shape[0] * (num - 1), nbytes(src, got))
        shapes.append({"shape": f"N {src.shape[0]} -> {num}", "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms,
                       "max_abs_err": 0.0, "rounds": num - 1})
        print(f"kernel furthest_point_sample (D2) at {shapes[-1]['shape']}: {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms), bound {bound_ms:.5f} ms ({bound_by}), {ms * 1e3 / (num - 1):.2f}"
              f" us a round; indices bit-equal")
        src = nxt
    print(f"11g votenet: PointNet2SASSG on {VOTENET_POINTS} points, launches {launches}; the FP "
          f"output {tuple(out.shape)} vs the CPU: rel err {out_err:.3e}, sampled points equal "
          f"(CPU {cpu_s:.1f} s)")
    return {"launches": launches, "fp_rel_err": out_err, "cpu_s": cpu_s}, shapes


def flagship_nms_part(counters, none, model, batch):
    """11g (iii): the flagship with ``test_cfg.nms_type`` circle, then rotate:
    one frame each (launches: 15 + 1 and the greedy pass once a class group
    with a radius), and the keep masks of the kernel against the plain greedy
    pass on the same predictions."""
    from bevfusion_tpu_torch.ops import nms

    head = model.heads["object"]
    saved = head.test_cfg.get("nms_type")
    res = {}
    with torch.no_grad():
        preds = model.predict(batch)
        for nms_type in ("circle", "rotate"):
            head.test_cfg["nms_type"] = nms_type
            boxes, launches = counted(counters, lambda: model(batch)["boxes"])
            want = dict(none, sparse_conv=SPARSE_LAUNCHES, bev_pool=POOL_LAUNCHES,
                        greedy_nms=TRANSFUSION_NMS_GROUPS)
            check(launches == want, f"11g nms {nms_type}: launches {launches}, want {want}")
            keep = head.get_bboxes(preds)["mask"]
            kernel = nms.greedy_suppress
            nms.greedy_suppress = nms.greedy_suppress_plain
            try:
                plain = head.get_bboxes(preds)["mask"]
            finally:
                nms.greedy_suppress = kernel
            check(torch.equal(keep, plain), f"11g nms {nms_type}: keep masks differ from plain")
            check(bool(torch.isfinite(boxes["bboxes"]).all()), f"11g nms {nms_type}: boxes")
            # at random init the proposals lie apart, few or none in the groups NMS runs on,
            # and it keeps them all: the same decode with every box moved into a 0.5 m
            # cluster and labelled by turns 8 and 9 (the two groups), where they suppress
            dec = head.get_bboxes(preds)
            g = torch.Generator(device=DEVICE).manual_seed(9)
            dec["bboxes"][..., :2] = dec["bboxes"][:, :1, :2] + 0.5 * torch.rand(
                dec["bboxes"][..., :2].shape, generator=g, device=DEVICE)
            dec["labels"] = 8 + torch.arange(dec["labels"].shape[1],
                                             device=DEVICE).expand_as(dec["labels"]) % 2
            packed = head.suppress(dec)
            nms.greedy_suppress = nms.greedy_suppress_plain
            try:
                packed_plain = head.suppress(dec)
            finally:
                nms.greedy_suppress = kernel
            check(torch.equal(packed, packed_plain) and int(packed.sum()) < int(dec["mask"].sum()),
                  f"11g nms {nms_type}: clustered boxes: keep {int(packed.sum())} of "
                  f"{int(dec['mask'].sum())}, equal to plain {torch.equal(packed, packed_plain)}")
            res[nms_type] = {"launches": launches, "kept": int(keep.sum()),
                             "kept_clustered": int(packed.sum())}
            print(f"11g nms {nms_type}: launches {launches}; {int(keep.sum())} of "
                  f"{keep.numel()} kept, keep mask equal to the plain pass's; the boxes "
                  f"clustered: {int(packed.sum())} kept, equal to the plain pass's")
    head.test_cfg["nms_type"] = saved
    return res


def conv_module_part(counters, none, cfg, model, batch):
    """11g (iv): the flagship's LiDAR encoder in ``block_type: conv_module`` at
    full width (seeded weights), one eval forward on the flagship scan through
    K1/K2 against the plain versions; the inverse sparse conv (K1/K2) and the
    sparse max pool at the encoder's level-1 -> level-2 strided conv."""
    from bevfusion_tpu_torch.models.sparse_encoder import SparseEncoder
    from bevfusion_tpu_torch.ops import bev_pool as bp
    from bevfusion_tpu_torch.ops import sparse_conv as sp
    from bevfusion_tpu_torch.runtime.flagship import init_weights

    enc_cfg = dict(cfg.model.encoders.lidar.backbone, block_type="conv_module")
    enc_cfg.pop("type")
    enc = init_weights(SparseEncoder(**enc_cfg), 1).to(DEVICE).eval()
    with torch.no_grad():
        vox = model.lidar_voxelize(batch["points"], batch["points_mask"])
        out, launches = counted(counters, lambda: enc(vox.feats, vox.coords, vox.mask))
        want = dict(none, sparse_conv=CONV_MODULE_LAUNCHES)
        check(launches == want, f"11g conv_module: launches {launches}, want {want}")
        with plain_kernels(sp, bp):
            plain = enc(vox.feats, vox.coords, vox.mask)
    err = rel_err(out, plain)
    check(err <= HEATMAP_RTOL and bool(torch.isfinite(out).all()),
          f"11g conv_module: rel err {err} against the plain versions")
    stages = enc.sparse_sites(vox.coords[0], vox.mask[0])
    a, b = stages[1], stages[2]
    pad = a["down"][0]
    nbr = sp.build_conv_rulebook(a["ids"], b["ids"], a["grid"], b["grid"], 3, 2, pad)
    nbr_t = sp.build_conv_transpose_rulebook(a["ids"], b["ids"], a["grid"], b["grid"], 3, 2, pad)
    g = torch.Generator(device=DEVICE).manual_seed(6)
    f_b = torch.randn(b["ids"].shape[0], b["channels"], generator=g, device=DEVICE)
    w = torch.randn(27, b["channels"], a["channels"], generator=g, device=DEVICE) * 0.05
    inv, inv_launches = counted(counters, lambda: sp.sparse_inverse_conv_gemm(f_b, nbr_t, w))
    check(inv_launches == dict(none, sparse_conv=1), f"11g inverse conv: {inv_launches}")
    inv_err = rel_err(inv, sp.sparse_conv_plain(f_b, nbr_t, w))
    check(inv_err <= FP32_RTOL_KERNEL, f"11g inverse conv: rel err {inv_err}")
    f_a = torch.randn(a["ids"].shape[0], a["channels"], generator=g, device=DEVICE)
    pooled = sp.sparse_maxpool(f_a, nbr)
    check(torch.equal(pooled.cpu(), sp.sparse_maxpool(f_a.cpu(), nbr.cpu())),
          "11g sparse max pool: the card's differs from the CPU's")
    sites = [int(s["mask"].sum()) for s in stages]
    print(f"11g conv_module: the flagship encoder (conv_module) on the flagship scan, sites per "
          f"level {sites}, launches {launches}, output {tuple(out.shape)} vs the plain versions: "
          f"rel err {err:.3e}; inverse conv (level 2 -> 1, {inv_launches['sparse_conv']} K1/K2 "
          f"launch) rel err {inv_err:.3e}; max pool (level 1 -> 2) equal to the CPU's")
    return {"launches": launches, "rel_err": err, "sites": sites,
            "inverse_conv_launches": inv_launches, "inverse_conv_rel_err": inv_err}


def camera_backbones_part(counters, none, batch):
    """11g (v): VoVNet-19-slim-eSE and DLA-34, each with a DetectronFPN, one
    fp32 frame of the six images on the card against the same weights on the
    CPU (no hand kernel on this path)."""
    from bevfusion_tpu_torch.models.dla import DLA
    from bevfusion_tpu_torch.models.necks import DetectronFPN
    from bevfusion_tpu_torch.models.vovnet import VoVNet
    from bevfusion_tpu_torch.runtime.flagship import init_weights

    img = batch["img"][0]
    res = {}
    for name, backbone, widths in (
            ("vovnet-19-slim-ese", VoVNet("V-19-slim-eSE"), (112, 256, 384, 512)),
            ("dla-34", DLA(out_features=("level2", "level3", "level4", "level5")),
             (64, 128, 256, 512))):
        net = init_weights(torch.nn.Sequential(
            backbone, DetectronFPN((0, 1, 2, 3), (0, 1, 2, 3), widths, 256)), 7).eval()
        card = copy.deepcopy(net).to(DEVICE)
        with torch.no_grad():
            outs, launches = counted(counters, lambda: card(img))
            t0 = time.perf_counter()
            cpu_outs = net(img.cpu())
        cpu_s = time.perf_counter() - t0
        check(launches == none, f"11g {name}: launches {launches}")
        err = max(rel_err(o.cpu(), c) for o, c in zip(outs, cpu_outs))
        check(err <= HEATMAP_RTOL and all(bool(torch.isfinite(o).all()) for o in outs),
              f"11g {name}: rel err {err}")
        res[name] = {"launches": launches, "rel_err": err, "cpu_s": cpu_s,
                     "shapes": [list(o.shape) for o in outs]}
        print(f"11g {name} + DetectronFPN: {[tuple(o.shape) for o in outs]} vs the CPU: rel err "
              f"{err:.3e} (CPU {cpu_s:.1f} s)")
    return res


def add_fuser_part(counters, none, cfg, model, batch, cpu_model):
    """11g (vi): the fused flagship with AddFuser in place of ConvFuser, one fp32
    frame on the card (15 + 1 launches); the dense heatmap against the CPU
    model's fuser, decoder and head on the card's fuser inputs."""
    from bevfusion_tpu_torch.models.fusers import AddFuser
    from bevfusion_tpu_torch.runtime.flagship import init_weights

    conv = model.fuser
    add = init_weights(AddFuser(cfg.model.fuser.in_channels, cfg.model.fuser.out_channels,
                                dropout=0.1), 8).eval()
    model.fuser = copy.deepcopy(add).to(DEVICE)
    seen = {}
    hook = model.fuser.register_forward_pre_hook(lambda m, a: seen.setdefault("x", a[0]))
    try:
        with torch.no_grad():
            preds, launches = counted(counters, lambda: model.predict(batch))
            xs = [x.cpu() for x in seen["x"]]
            x = add(xs)
            x = cpu_model.decoder["neck"](cpu_model.decoder["backbone"](x))
            heat = cpu_model.heads["object"](list(x)[0] if isinstance(x, (list, tuple))
                                             else x)["dense_heatmap"]
    finally:
        hook.remove()
        model.fuser = conv
    want = dict(none, sparse_conv=SPARSE_LAUNCHES, bev_pool=POOL_LAUNCHES)
    check(launches == want, f"11g add fuser: launches {launches}, want {want}")
    err = rel_err(preds["dense_heatmap"].cpu(), heat)
    check(err <= HEATMAP_RTOL, f"11g add fuser: heatmap rel err {err}")
    print(f"11g add fuser: the flagship with AddFuser, launches {launches}; dense heatmap vs the "
          f"CPU fuser, decoder and head on the card's fuser inputs: rel err {err:.3e}")
    return {"launches": launches, "heatmap_rel_err": err}


def long_tail_launches(res, name):
    """A kernel's launches in each counted run of phase 11g."""
    runs = {"dcn": res["dcn"], "votenet": res["votenet"], "add_fuser": res["add_fuser"],
            "conv_module": res["conv_module"],
            "inverse_conv": {"launches": res["conv_module"]["inverse_conv_launches"]},
            **{f"nms_{k}": v for k, v in res["nms"].items()},
            **res["camera_backbones"]}
    return {run: r["launches"][name] for run, r in runs.items()}


def long_tail_phase(cfg, model, batch, cpu_model, cpu_batch, counters):
    """Phase 11g: the long tail no served config reaches, on the card (each
    part's launches counted from 0 just before it and read just after).
    Returns (results, D1's shape entries, D2's shape entries)."""
    t0 = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    none = dict.fromkeys(counters, 0)
    res, parts = {}, {}
    for name, fn in (("dcn", lambda: dcn_frame(counters, none)),
                     ("votenet", lambda: pointnet_part(counters, none, cpu_batch)),
                     ("nms", lambda: flagship_nms_part(counters, none, model, batch)),
                     ("conv_module", lambda: conv_module_part(counters, none, cfg, model, batch)),
                     ("camera_backbones", lambda: camera_backbones_part(counters, none, batch)),
                     ("add_fuser", lambda: add_fuser_part(counters, none, cfg, model, batch,
                                                          cpu_model))):
        t = time.perf_counter()
        res[name] = fn()
        parts[name] = time.perf_counter() - t
        torch.cuda.empty_cache()
    res["dcn"], d1 = res["dcn"]
    res["votenet"], d2 = res["votenet"]
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    res["part_seconds"] = parts
    res["seconds"] = time.perf_counter() - t0
    print(f"11g long tail: {res['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return res, [d1], d2


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


def train_step_parity(label, model, batch, sp, bp, counters, want, ties=()):
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
    - B': B with a rounding-level change of the forward, the sparse convs in
      fp32 (cuBLAS) where they run, else the pool in float64 rounded once
      (``bev_pool_exact``) where a camera does: how far each of B's gradients
      moves so. Every gradient of A within 5e-3 relative in norm of B's
      plus ``TRAIN_GRAD_SENSITIVITY`` times that move (the forward kernels'
      effect on the gradients). For the camera configs a gradient past
      that rule is held again with B'' in place of B' (B with the pool's fp32
      sums in reverse order, ``bev_pool_reversed``), and past that too
      passes only if ``ties`` names it, within ``CAMERA_TIE_RTOL`` of B's.
      With neither (PointPillars: no kernel) A vs B's gradient gap is
      reported."""
    from bevfusion_tpu_torch.models.layers import set_dropout_generator

    params = dict(model.named_parameters())
    head = model.heads["object"] if "object" in model.heads else None
    matcher = hasattr(head, "_targets")  # TransFusion's Hungarian targets
    sparse = want.get("sparse_conv", 0) > 0
    pool = want.get("bev_pool", 0) > 0
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
    elif pool:
        with plain_kernels(sp, bp, exact, bev_pool_exact(bp)):
            (_, _, grads_p32, _, _), _, _ = counted(fwd_bwd, none, "B', B with the pool in float64")
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
    if sparse or pool:
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
        # the camera configs (B' the pool in float64): a gradient past the rule is held again
        # with B'' (the pool's sums reversed) as the rounding-level pass; past both, only a
        # tie that ``ties`` names may pass, within CAMERA_TIE_RTOL
        past = [n for n in order if used[n] > 1.0] if not sparse else []
        flips, moved_rev = [], {}
        if past:
            with plain_kernels(sp, bp, exact, bev_pool_reversed(bp)):
                (_, _, grads_rev, _, _), _, _ = counted(
                    fwd_bwd, none, "B'', B with the pool's sums in reverse order")
            gaps_rb, _ = grad_gaps(grads_rev, {n: grads_p[n] for n in past}, global_norm)
            by_rev = {}
            for n in past:
                alone = ZERO_GRAD * global_norm if n in zero else TRAIN_GRAD_RTOL * gaps_ab[n][1]
                moved_rev[n] = rel(gaps_rb[n])
                by_rev[n] = gaps_ab[n][0] / (alone + TRAIN_GRAD_SENSITIVITY * gaps_rb[n][0])
                used[n] = min(used[n], by_rev[n])
            flips = [n for n in past if used[n] > 1.0]
            print(f"{label}: {len(past)} of {len(order)} gradients past the B' rule, held with "
                  f"B'': " + "; ".join(
                      f"{n} A vs B {rel(gaps_ab[n]):.3e}, B' vs B {rel(gaps_bb[n]):.3e}, B'' vs B "
                      f"{moved_rev[n]:.3e}: {by_rev[n]:.3f} of the B'' rule" for n in past))
        for n in order:
            ok = (n in ties and rel(gaps_ab[n]) <= CAMERA_TIE_RTOL) if n in flips \
                else used[n] <= 1.0
            check(ok, f"{label}: {n} grad A vs B rel err {rel(gaps_ab[n])}, B' vs "
                  f"B {rel(gaps_bb[n])}, B'' vs B {moved_rev.get(n)}: {used[n]:.3f} of the gate")
        out.update(plain_grad_rel_err_fp32_vs_float64=worst_bb[0], grads_past_gate_ties=flips,
                   grads_past_b1_rule_b2_moves=moved_rev,
                   grad_vs_plain_share_of_gate=used[order[0]], grads_past_rtol_vs_plain=len(beyond))
    else:
        print(f"{label}: A vs B max rel err {worst_ab[0]:.3e} in norm ({worst_ab[1]}; not gated: "
              f"no kernel, so no B' to scale the gate)")
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
    ``train_step_parity`` with TF32 off; then 1 timed step after 1 warmup
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
        r = train_step_parity(f"train {name}", model, batch, sp, bp, counters, want,
                              CAMERA_TIES.get(name, ()))
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        steps = train_steps(cfg, model, batch, DEVICE, steps=1, warmup=1)
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


def bf16_kernel_phase(sp, cases, fwd32, dw32):
    """Phase 5b: the bf16 forms of K1/K2 and K3 at the six shapes of phases
    3-5 (the same operands rounded to bf16, the residual too; scale and
    shift fp32). K1/K2 with and without the epilogue against the bf16 plain
    version (fp32 product and epilogue, one rounding): every valid element
    within one bf16 rounding (2^-7 of |plain|) plus the fp32 order gate
    (1e-4 of the scale); the count of elements that differ; equal bits
    across two calls; what the launch runs (``sp.sparse_conv_bf16_plan``:
    registers, spills, resident blocks an SM, stages, grid). K3 against its
    plain version (fp32 dW of bf16 rows: the products exact in fp32) within
    1e-4 * max(|plain|, 1), equal bits across two calls. Times (median of
    20), bounds (the bytes at bf16 rows; one bf16 product a useful
    multiply-add at 989 TFLOP/s) and shares, beside the fp32 kernels' times
    of phases 3-4 (None: not run) and K1/K2 bf16's recorded times before
    its redesign (``BF16_MS_BEFORE``, printed and not returned). Returns the
    two lists of per-shape records."""
    fwd, dw = [], []
    fwd32 = fwd32 or [None] * len(cases)
    dw32 = dw32 or [None] * len(cases)
    for (label, (feats, nbr, w), kw, valid, _, step_launches), f32, d32 in zip(cases, fwd32, dw32):
        K, Cin, Cout = w.shape
        hits = int((nbr >= 0).sum())
        x, w16 = feats.bfloat16(), w.bfloat16()
        epi16 = dict(kw, **({"residual": kw["residual"].bfloat16()} if "residual" in kw else {}))
        row = {"shape": label, "hits": hits, "valid_out": int(valid.sum()),
               "fp32_ms": f32 and f32["ms"], "fp32_ms_no_epilogue": f32 and f32["ms_no_epilogue"],
               "plan": sp.sparse_conv_bf16_plan(nbr.shape[1], K, Cin, Cout)}
        for tag, epi in (("", epi16), ("_no_epilogue", {})):
            got = sp.sparse_conv(x, nbr, w16, **epi)
            want = sp.sparse_conv_plain(x, nbr, w16, **epi)
            torch.cuda.synchronize()
            d = (got.float() - want.float())[valid]
            ref = want.float()[valid]
            scale = max(ref.abs().max().item(), 1.0)
            bad = int((d.abs() > BF16_REL * ref.abs() + FP32_RTOL_KERNEL * scale).sum())
            check(got.dtype == torch.bfloat16 and bad == 0,
                  f"bf16 {label}{tag}: {bad} elements past one bf16 rounding of plain")
            check(bits_equal(sp.sparse_conv(x, nbr, w16, **epi), got),
                  f"bf16 {label}{tag}: not repeatable")
            moved = nbytes(x, nbr, w16, got, *(v for v in epi.values() if torch.is_tensor(v)))
            b_ms, b_by = bound(2 * hits * Cin * Cout, moved, BF16_FLOPS)
            ms = kernel_ms(lambda: sp.sparse_conv(x, nbr, w16, **epi))
            plain_ms = kernel_ms(lambda: sp.sparse_conv_plain(x, nbr, w16, **epi))
            row.update({f"max_abs_err{tag}": d.abs().max().item(),
                        f"elements_differ{tag}": int((d != 0).sum()), f"elements{tag}": d.numel(),
                        f"ms{tag}": ms, f"plain_ms{tag}": plain_ms, f"bound_ms{tag}": b_ms,
                        f"bound_by{tag}": b_by, f"share{tag}": b_ms / ms})
        fwd.append(row)
        fp32 = (f" (fp32 {f32['ms']:.4f})", f" (fp32 {f32['ms_no_epilogue']:.4f})") if f32 \
            else ("", "")
        print(f"kernel sparse_conv_bf16 {label}: {row['elements_differ']} of {row['elements']} "
              f"elements differ from plain (max|d| {row['max_abs_err']:.3e}; without epilogue "
              f"{row['elements_differ_no_epilogue']}, {row['max_abs_err_no_epilogue']:.3e}), "
              f"kernel {row['ms']:.4f} ms{fp32[0]} against {BF16_MS_BEFORE[label]:.4f} ms recorded "
              f"before its redesign: {BF16_MS_BEFORE[label] / row['ms']:.2f}x; plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"{row['share']:.3f} of bound; without epilogue {row['ms_no_epilogue']:.4f} "
              f"ms{fp32[1]}, {row['share_no_epilogue']:.3f} of bound; plan "
              + ", ".join(f"{k} {v}" for k, v in row["plan"].items()))

        dout = torch.randn(nbr.shape[1], Cout, device=DEVICE,
                           generator=torch.Generator(device=DEVICE).manual_seed(hits))
        dout = (dout * valid[:, None]).bfloat16()
        got = sp.sparse_conv_dw(x, nbr, dout)
        want = sp.sparse_conv_dw_plain(x, nbr, dout)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(want.abs().max().item(), 1.0)
        check(got.dtype == torch.float32 and err <= FP32_RTOL_KERNEL * scale,
              f"bf16 {label} dW: max|d| {err} vs plain, scale {scale}")
        check(torch.equal(sp.sparse_conv_dw(x, nbr, dout), got),
              f"bf16 {label} dW: not repeatable")
        moved = nbytes(x, nbr, dout, got)
        b_ms, b_by = bound(2 * hits * Cin * Cout, moved, BF16_FLOPS)
        ms = kernel_ms(lambda: sp.sparse_conv_dw(x, nbr, dout))
        plain_ms = kernel_ms(lambda: sp.sparse_conv_dw_plain(x, nbr, dout))
        plan = sp.sparse_conv_dw_bf16_plan(nbr.shape[1], K, Cin, Cout)
        dw.append({"shape": label, "hits": hits, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "share": b_ms / ms, "fp32_ms": d32 and d32["ms"],
                   "step_launches": step_launches, "plan": plan})
        fp32 = f" (fp32 {d32['ms']:.4f})" if d32 else ""
        print(f"kernel sparse_conv_dw_bf16 {label}: max|d| {err:.3e} (scale {scale:.3e}), "
              f"kernel {ms:.4f} ms{fp32}, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms:.3f} of bound; plan " + ", ".join(f"{k} {v}" for k, v in plan.items()))
        print(f"kernel sparse_conv_dw_bf16 {label}: {ms:.4f} ms against "
              f"{DW_BF16_MS_BEFORE[label]:.4f} ms recorded before its redesign: "
              f"{DW_BF16_MS_BEFORE[label] / ms:.2f}x")
    frame = sum(BF16_FRAME_LAUNCHES[r["shape"]] * r["ms"] for r in fwd)
    frame_before = sum(BF16_FRAME_LAUNCHES[r["shape"]] * BF16_MS_BEFORE[r["shape"]] for r in fwd)
    frame_bound = sum(BF16_FRAME_LAUNCHES[r["shape"]] * r["bound_ms"] for r in fwd)
    print(f"kernel sparse_conv_bf16: the bf16 frame's {sum(BF16_FRAME_LAUNCHES.values())} launches "
          f"at these shapes (BF16_FRAME_LAUNCHES a shape) {frame:.4f} ms (recorded before the "
          f"redesign {frame_before:.4f} ms, bound {frame_bound:.4f} ms)")
    step = sum(r["step_launches"] * r["ms"] for r in dw)
    step_before = sum(r["step_launches"] * DW_BF16_MS_BEFORE[r["shape"]] for r in dw)
    step_bound = sum(r["step_launches"] * r["bound_ms"] for r in dw)
    print(f"kernel sparse_conv_dw_bf16: the bf16 train step's {sum(r['step_launches'] for r in dw)} "
          f"launches at these shapes (step_launches a shape) {step:.4f} ms")
    print(f"kernel sparse_conv_dw_bf16: the same launches recorded before the redesign "
          f"{step_before:.4f} ms, bound {step_bound:.4f} ms")
    return fwd, dw


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float64."""
    return float((a.double() - b.double()).norm() / b.double().norm())


def bf16_eval_phase(model, batch, counters):
    """Phase 10b: the flagship's eval frame at bf16 (the same weights,
    ``compute_dtype`` set on the phase-10 model), every launch count set to
    0 just before and read just after: 15 bf16 sparse convs, no fp32 one, 1
    pool, no NMS; every box field finite; the head's BEV input and the
    dense heatmap logits against the fp32 frame (TF32 off) within
    ``BF16_EVAL_GAP`` relative in norm; then ms a frame (median of 5) and
    the peak at fp32 and bf16 in turns (fp32, bf16, bf16, fp32) with the
    fp32 runs' TF32 switches (``runtime/precision.py``), the bf16 stages,
    and one frame of each dtype traced (``traced``). Returns the results;
    the model is fp32 again after."""
    from bevfusion_tpu_torch.runtime import precision
    from bevfusion_tpu_torch.tools import profile_stages

    seen = {}
    hooks = [model.decoder["neck"].register_forward_hook(
                 lambda mod, args, out: seen.__setitem__("bev", out)),
             model.heads["object"].register_forward_hook(
                 lambda mod, args, out: seen.__setitem__("preds", out))]

    def forward(dtype):
        model.compute_dtype = dtype
        with torch.no_grad():
            boxes = model(batch)["boxes"]
        bev = seen["bev"][0] if isinstance(seen["bev"], (list, tuple)) else seen["bev"]
        return boxes, bev.float(), seen["preds"]["dense_heatmap"].float()

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    _, bev32, heat32 = forward(torch.float32)
    want = dict(dict.fromkeys(counters, 0), sparse_conv_bf16=SPARSE_LAUNCHES,
                bev_pool=POOL_LAUNCHES)
    torch.cuda.synchronize()
    zero_counts(counters)
    boxes, bev16, heat16 = forward(torch.bfloat16)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    for h in hooks:
        h.remove()
    check(launches == want, f"bf16 flagship: launches {launches}, want {want}")
    for key, v in boxes.items():
        check(bool(torch.isfinite(v.float()).all()), f"bf16 flagship: non-finite {key}")
    check(boxes["bboxes"].dtype == torch.float32, f"bf16 flagship: boxes {boxes['bboxes'].dtype}")
    gaps = {"bev_into_head": rel_gap(bev16, bev32), "heatmap_logits": rel_gap(heat16, heat32)}
    print(f"bf16 flagship: launches {launches}; relative gaps in norm to the fp32 frame (TF32 "
          f"off): BEV into the head {gaps['bev_into_head']:.3e}, dense heatmap logits "
          f"{gaps['heatmap_logits']:.3e} (gate {BF16_EVAL_GAP:g})")
    check(all(BF16_MIN_GAP < g <= BF16_EVAL_GAP for g in gaps.values()),
          f"bf16 flagship: gaps {gaps}")
    precision.apply_tf32_defaults()
    ms, peak = {"float32": [], "bfloat16": []}, {}
    for dtype in (torch.float32, torch.bfloat16, torch.bfloat16, torch.float32):
        model.compute_dtype = dtype
        with torch.no_grad():
            frames, p = frame_ms(lambda: model(batch), *FRAMES)
        ms[precision.dtype_name(dtype)].append(statistics.median(frames))
        peak[precision.dtype_name(dtype)] = p
    model.compute_dtype = torch.bfloat16
    stages = {r["stage"]: r["ms"]
              for r in profile_stages.profile_stages(model, batch, DEVICE, iters=STAGE_ITERS)[0]}
    traces = {}
    for dtype in (torch.float32, torch.bfloat16):
        model.compute_dtype = dtype
        traces[precision.dtype_name(dtype)] = t = traced(lambda: model(batch))
        print(f"{precision.dtype_name(dtype)} flagship frame traced: {t['wall_ms']:.2f} ms wall, "
              f"{t['device_activities']} kernels and copies on the card, "
              f"{t['device_busy_ms']:.2f} ms busy, idle {100 * t['idle_share']:.1f}% of the "
              f"wall; most device time: " + "; ".join(
                  f"{k['name']} x{k['count']} {k['ms']:.3f} ms" for k in t["top"]))
    model.compute_dtype = torch.float32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    r = {"launches": launches, "gaps": gaps, "frame_ms_median": ms, "peak_mem_bytes": peak,
         "stage_ms": stages, "frame_trace": traces}
    print(f"bf16 flagship (cuDNN TF32 on, matmul TF32 off): ms/frame medians fp32 "
          f"{ms['float32']}, bf16 {ms['bfloat16']} in turns; peak fp32 "
          f"{peak['float32'] / 2**20:.1f} MiB, bf16 {peak['bfloat16'] / 2**20:.1f} MiB; bf16 "
          f"stages " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    return r


def bf16_configs_phase(counters):
    """Phase 11f: one bf16 eval frame of each of the ten other served
    configs (TransFusion-L at 0.075 and 0.1 m, the three seg configs, the
    three camera CenterHead configs, PointPillars, camera + radar), each
    built at bf16 on the card (seeded random weights, CenterHead heads
    moderated): the launch counts of the config's fp32 frame with the sparse
    convs on the bf16 kernel, every output finite (the kept boxes, the
    masks within [0, 1]); ms a frame (median of 5 after 2) and the peak,
    with the fp32 runs' TF32 switches. Returns {config: results}."""
    from bevfusion_tpu_torch.runtime import precision
    from bevfusion_tpu_torch.runtime.flagship import (DET_CAMERA_CONFIGS, LIDAR_SLICE_CONFIG,
                                                      PILLAR_CONFIGS, REPO_ROOT, SEG_CONFIGS,
                                                      build_flagship)

    lidar = {"sparse_conv": SPARSE_LAUNCHES}
    configs = {"transfusion-l": (LIDAR_SLICE_CONFIG, lidar),
               "transfusion-l-0p1": (os.path.join(REPO_ROOT, VOXELNET_0P1), lidar),
               **{f"seg-{k}": (SEG_CONFIGS[k], v) for k, v in SEG_LAUNCHES.items()},
               **{f"det-{k}": (p, DET_LAUNCHES) for k, p in DET_CAMERA_CONFIGS.items()},
               "pointpillars": (PILLAR_CONFIGS["pointpillars"], {}),
               "camera+radar": (PILLAR_CONFIGS["camera+radar"], DET_LAUNCHES)}
    precision.apply_tf32_defaults()
    res = {}
    for name, (path, fp32_want) in configs.items():
        t0 = time.perf_counter()
        _, model, batch = build_flagship(DEVICE, num_points=120000, seed=0, config_path=path,
                                         dtype=torch.bfloat16)
        if hasattr(model.heads["object"] if "object" in model.heads else None, "task_heads"):
            moderate_head(model, batch)
        want = dict.fromkeys(counters, 0)
        want.update({"sparse_conv_bf16" if k == "sparse_conv" else k: v
                     for k, v in fp32_want.items()})
        torch.cuda.synchronize()
        zero_counts(counters)
        with torch.no_grad():
            out = model(batch)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        check(launches == want, f"bf16 {name}: launches {launches}, want {want}")
        if "boxes" in out:
            b = out["boxes"]
            kept = b["mask"]
            check(bool(torch.isfinite(b["scores"]).all()) and
                  bool(torch.isfinite(b["bboxes"][kept]).all()) and int(kept.sum()) > 0,
                  f"bf16 {name}: no box kept, or a kept box not finite")
        if "masks_bev" in out:
            m = out["masks_bev"]
            check(bool(torch.isfinite(m).all()) and m.min() >= 0 and m.max() <= 1,
                  f"bf16 {name}: masks_bev not finite in [0, 1]")
        with torch.no_grad():
            frames, peak = frame_ms(lambda: model(batch), warmup=2, iters=5)
        res[name] = {"launches": launches, "frame_ms_median": statistics.median(frames),
                     "frames_ms": frames, "peak_mem_bytes": peak,
                     "seconds": time.perf_counter() - t0}
        print(f"bf16 {name}: launches {launches}; {res[name]['frame_ms_median']:.2f} ms/frame "
              f"median of 5, peak {peak / 2**20:.1f} MiB; {res[name]['seconds']:.1f} s")
        del model, batch, out
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return res


def bf16_train_phase(cfg, model, batch, counters, sp, bp):
    """Phase 13b: the flagship's train step at bf16 on the phase-13 model
    (``compute_dtype`` set; deterministic algorithms on, TF32 off). Passes
    of one forward + backward, a freshly seeded dropout generator each: the
    first, fp32, records its proposals and Hungarian targets
    (``recorded_proposals``, ``recorded_targets``) and every later one
    replays them. T: fp32 with both TF32 switches on, the control; A: bf16
    through the kernels, every launch count set to 0 just before it and
    read just after (29 bf16 K1/K2, 15 bf16 K3, 1 pool, no fp32 sparse
    conv); C: A's forward, the backward through the plain versions (the
    bf16 kernels' backward alone). Held: A's losses finite and every
    parameter's gradient fp32 and finite; A vs C within
    ``BF16_TRAIN_KERNEL_GAP`` relative in norm over all gradients; A vs the
    fp32 pass within ``BF16_TRAIN_VS_TF32`` times T vs the fp32 pass (at
    random init a rounding-level change of the forward moves the gradients
    far, phase 12's B' shows it at fp32; T measures it at TF32's 11
    significant bits, bf16 keeps 8), cosines printed. Then 2 timed bf16
    steps after 2 with the fp32 runs' TF32 switches
    (``tools/bench_train_step.py``). Returns the results; the model is
    fp32 again after."""
    from bevfusion_tpu_torch.models.layers import set_dropout_generator
    from bevfusion_tpu_torch.runtime import precision
    from bevfusion_tpu_torch.tools.bench_train_step import train_steps

    head = model.heads["object"]
    params = dict(model.named_parameters())
    store, tops = {}, {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)

    def fwd_bwd(dtype, plain_backward=False):
        model.compute_dtype = dtype
        set_dropout_generator(model, torch.Generator(device=DEVICE).manual_seed(0))
        model.zero_grad(set_to_none=True)
        with recorded_targets(head, store), recorded_proposals(head, tops) as own:
            losses = model(batch)
        total = sum(v for k, v in losses.items() if k.startswith("loss/"))
        with plain_kernels(sp, bp) if plain_backward else contextlib.nullcontext():
            total.backward()
        torch.cuda.synchronize()
        return ({k: v.item() for k, v in losses.items()}, total.item(),
                {n: p.grad.clone() for n, p in params.items() if p.grad is not None}, own)

    def gap_and_cosine(grads, ref):
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in ref.values()))
        other = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        dot = sum(float((grads[n].double() * g.double()).sum()) for n, g in ref.items())
        gap = math.sqrt(sum(float((grads[n].double() - g.double()).square().sum())
                            for n, g in ref.items())) / norm
        return gap, dot / (norm * other)

    model.train()
    losses32, _, grads32, _ = fwd_bwd(torch.float32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    _, _, grads_t, _ = fwd_bwd(torch.float32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    zero_counts(counters)
    losses16, total16, grads16, own = fwd_bwd(torch.bfloat16)
    launches = {k: c.launches for k, c in counters.items()}
    want = dict(dict.fromkeys(counters, 0), **BF16_TRAIN_LAUNCHES)
    check(launches == want, f"bf16 train step: launches {launches}, want {want}")
    check(math.isfinite(total16), f"bf16 train step: loss {total16}")
    check(set(grads16) == set(params) and all(
        g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads16.values()),
        "bf16 train step: a parameter without an fp32, finite gradient")
    _, _, grads16_c, _ = fwd_bwd(torch.bfloat16, plain_backward=True)
    kernel_gap, _ = gap_and_cosine(grads16, grads16_c)
    gap, cosine = gap_and_cosine(grads16, grads32)
    tf32_gap, tf32_cosine = gap_and_cosine(grads_t, grads32)
    n32 = math.sqrt(sum(float(g.double().square().sum()) for g in grads32.values()))
    worst = sorted(((rel_gap(grads16[n], g), n) for n, g in grads32.items()
                    if float(g.norm()) > ZERO_GRAD * n32), reverse=True)[:5]
    worst_c = sorted(((rel_gap(grads16[n], g), n) for n, g in grads16_c.items()
                      if float(g.norm()) > ZERO_GRAD * n32), reverse=True)[:3]
    same_top = bool(own) and torch.equal(own[0], tops["top"])
    print(f"bf16 train step: launches {launches}; losses {losses16} (fp32 {losses32}); "
          f"gradients, relative gap in norm over all of them: A vs C (the bf16 kernels' "
          f"backward against the plain versions') {kernel_gap:.3e} (gate "
          f"{BF16_TRAIN_KERNEL_GAP:g}; largest per parameter "
          + "; ".join(f"{n} {g:.3e}" for g, n in worst_c)
          + f"); A vs fp32 {gap:.3e}, cosine {cosine:.6f}; T (TF32 on) vs fp32 {tf32_gap:.3e}, "
          f"cosine {tf32_cosine:.6f} (gate A vs fp32 <= {BF16_TRAIN_VS_TF32:g} x T's); the "
          f"largest per parameter of A vs fp32: " + "; ".join(f"{n} {g:.3e}" for g, n in worst)
          + f"; the bf16 pass's own proposals equal fp32's: {same_top}")
    check(kernel_gap <= BF16_TRAIN_KERNEL_GAP, f"bf16 train step: kernel gap {kernel_gap}")
    check(gap <= BF16_TRAIN_VS_TF32 * tf32_gap,
          f"bf16 train step: gradient gap {gap} against TF32's {tf32_gap}")
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    precision.apply_tf32_defaults()
    model.compute_dtype = torch.bfloat16
    steps = train_steps(cfg, model, batch, DEVICE, steps=2, warmup=1)
    model.compute_dtype = torch.float32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    check(not steps.pop("unchanged"), "bf16 timed steps: parameters unchanged")
    med = steps["ms_median"]
    print(f"bf16 train steps (cuDNN TF32 on, matmul TF32 off): losses "
          f"{[round(v, 4) for v in steps['losses']]}; median ms/step {med['step']:.2f} (forward "
          f"{med['forward']:.2f}, backward {med['backward']:.2f}, optimizer "
          f"{med['optimizer']:.2f}); peak {steps['peak_mem_bytes'] / 2**20:.1f} MiB; the "
          f"matcher {statistics.median(steps['auction_ms']):.2f} ms median a call")
    return {"launches": launches, "losses": losses16, "losses_fp32": losses32,
            "grad_rel_gap_kernels": kernel_gap, "grad_rel_gap": gap, "grad_cosine": cosine,
            "grad_rel_gap_tf32": tf32_gap, "grad_cosine_tf32": tf32_cosine,
            "grad_worst": [[n, g] for g, n in worst], "own_proposals_equal": same_top,
            "steps": steps}


class PredsForward(torch.nn.Module):
    """The object head's raw predictions (``BEVFusion.predict``): what the
    decode's top-k reads."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return {k: v for k, v in self.model.predict(batch).items() if torch.is_tensor(v)}


def export_phase(counters, eager_ms):
    """Phases 14a and 14c: ``tools/export.py`` (``export.run``, the CLI's
    body) on the flagship at bf16, its config's dtype, then
    (``export.export_model`` and ``export.save``) the same model at fp32, traced
    with deterministic algorithms on, as the comparison runs (a trace takes
    the Python branches that run: ``F.interpolate``'s bilinear resize is a
    decomposition on CUDA under them, the CUDA kernel otherwise, 1.3e-7
    apart at fp32); the ``.pt2`` loaded back with ``torch.export.load``. 14a: the graph holds
    ``EXPORT_LAUNCHES`` bevfusion:: nodes and no other; one frame of the
    loaded program beside one eager frame of the same model on the same
    batch, deterministic algorithms on: boxes, scores, labels and mask bit
    for bit, else the differing fields named and the head's predictions
    before the top-k (a second export) held at ``EXPORT_PRED_RTOL``. 14c: the
    launches of the eager frame and of the loaded program's frame, read
    from the counters, both ``EXPORT_LAUNCHES``. Also the export's, the
    save's and the load's seconds, the file's bytes and the loaded
    program's ms a frame (median of 5) beside ``eager_ms``, the same
    flagship's eager frame as phases 10 (fp32, TF32 off) and 10b (bf16,
    cuDNN TF32 on) timed it, under the same TF32 switches."""
    from bevfusion_tpu_torch.ops.library import OPS, op_counts
    from bevfusion_tpu_torch.runtime import precision
    from bevfusion_tpu_torch.tools import export
    from bevfusion_tpu_torch.tools.train_longevity import deterministic

    res, model = {}, None
    for dtype, want in EXPORT_LAUNCHES.items():
        t0 = time.perf_counter()
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "export_smoke",
                            f"flagship_{dtype}.pt2")
        with deterministic():  # the trace takes the branches the comparison runs
            if model is None:  # the CLI's body: build, export, save
                r = export.run(out=path, device=DEVICE)  # the config's bf16
                s, model, batch = r["summary"], r["model"], r["batch"]
                del r
            else:  # the same weights and batch at the next dtype
                model.compute_dtype = precision.parse_dtype(dtype)
                ep = export.export_model(model, batch)
                s = {"export_s": time.perf_counter() - t0, "dtype": dtype}
                t_save = time.perf_counter()
                s.update(bytes=export.save(ep, path), save_s=time.perf_counter() - t_save,
                         op_counts=op_counts(ep.graph_module))
                del ep
        check(s["dtype"] == dtype, f"export: the program computes in {s['dtype']}, not {dtype}")
        check(s["op_counts"] == dict(dict.fromkeys(OPS, 0), **want),
              f"export {dtype}: the graph's ops {s['op_counts']}, want {want}")
        t_load = time.perf_counter()
        loaded = torch.export.load(path)
        load_s = time.perf_counter() - t_load
        check(op_counts(loaded.graph_module) == s["op_counts"],
              f"export {dtype}: the loaded graph's ops {op_counts(loaded.graph_module)}")
        t_module = time.perf_counter()
        program = loaded.module()
        module_s = time.perf_counter() - t_module
        want_launches = dict(dict.fromkeys(counters, 0), **want)
        launches, t_compare = {}, time.perf_counter()
        with deterministic(), torch.no_grad():
            for name, fn in (("eager", lambda: model(batch)["boxes"]),
                             ("loaded", lambda: program(batch))):
                torch.cuda.synchronize()
                zero_counts(counters)
                out = fn()
                torch.cuda.synchronize()
                launches[name] = {k: c.launches for k, c in counters.items()}
                if name == "eager":
                    eager = out
            got = out
        compare_s = time.perf_counter() - t_compare
        for name, n in launches.items():
            check(n == want_launches, f"14c export {dtype}: the {name} frame launched {n}, "
                  f"want {want_launches}")
        same = {k: bits_equal(got[k], eager[k]) for k in eager}
        for k in ("bboxes", "scores"):
            check(bool(torch.isfinite(got[k]).all()), f"export {dtype}: {k} not finite")
        entry = dict(s, load_s=load_s, module_s=module_s, compare_s=compare_s,
                     launches_eager=launches["eager"],
                     launches_loaded=launches["loaded"], bit_equal=same)
        if not all(same.values()):
            pre = torch.export.export(PredsForward(model), (batch,), strict=False)
            with deterministic(), torch.no_grad():
                want_p, got_p = PredsForward(model)(batch), pre.module()(batch)
            errs = {k: rel_err(got_p[k].float(), want_p[k].float()) for k in want_p}
            print(f"export {dtype}: boxes differ from eager's in "
                  f"{[k for k, v in same.items() if not v]}; the head's predictions before the "
                  f"top-k, rel err {errs}")
            check(max(errs.values()) <= EXPORT_PRED_RTOL,
                  f"export {dtype}: predictions before the top-k off by {errs}")
            entry["pre_topk_rel_err"] = errs
        tf32 = dtype == "bfloat16"  # phase 10b's switches at bf16, phase 10's at fp32
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32, False
        with torch.no_grad():
            entry["frame_ms_loaded"] = statistics.median(
                frame_ms(lambda: program(batch), *FRAMES)[0])
        torch.backends.cudnn.allow_tf32 = False
        entry["frame_ms_eager"] = eager_ms[dtype]
        entry["seconds"] = time.perf_counter() - t0
        print(f"14a export {dtype}: {s['bytes']} bytes in {s['export_s']:.1f} s (save "
              f"{s['save_s']:.1f} s, load {load_s:.1f} s, module {module_s:.1f} s, the "
              f"two frames held {compare_s:.1f} s); graph ops {s['op_counts']}; loaded vs eager "
              f"bit for bit {same}; "
              f"14c launches eager {launches['eager']}, loaded {launches['loaded']}; a frame "
              f"loaded {entry['frame_ms_loaded']:.2f} ms (cuDNN TF32 {tf32}), eager "
              f"{entry['frame_ms_eager']:.2f} ms (phase {'10b' if tf32 else '10'}); "
              f"{entry['seconds']:.1f} s")
        res[dtype] = entry
        os.remove(path)
        del loaded, program, eager, got
    del model, batch
    torch.cuda.empty_cache()
    return res


def longevity_phase():
    """Phase 14b: ``tools/train_longevity.py`` (``main``) in its short form,
    ``LONGEVITY_ARGS``: the flagship at bf16 over one whole schedule of 12
    steps on 8 scenes, the resume probe at step 6. Gates: the tool's own
    (finite losses, the probe by the rule it states), every loss finite in
    its JSON, and a step's launches 29 bf16 K1/K2, 15 bf16 K3 and 1 K4, no
    fp32 sparse conv and no NMS."""
    from bevfusion_tpu_torch.tools import train_longevity

    t0 = time.perf_counter()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "longevity_smoke",
                       "longevity.json")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        check(train_longevity.main(LONGEVITY_ARGS + ["--out", out]) == 0, "longevity: exit")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    with open(out) as f:
        res = json.load(f)
    want = dict(dict.fromkeys(res["launches_per_step"], 0), sparse_conv_bf16=29,
                sparse_conv_dw_bf16=15, bev_pool=1)
    check(res["launches_per_step"] == want,
          f"longevity: a step launched {res['launches_per_step']}, want {want}")
    check(all(map(math.isfinite, res["losses"])), "longevity: a loss is not finite")
    check(bool(res["resume_rule"]), "longevity: no resume rule ran")
    res["seconds"] = time.perf_counter() - t0
    print(f"14b longevity {' '.join(LONGEVITY_ARGS)}: loss {res['loss_first']:.4f} -> "
          f"{res['loss_last']:.4f} (min {res['loss_min']:.4f}); {res['ms_per_step_avg']:.1f} ms "
          f"a step; resume probe: {res['resume_rule']}, bit-identical "
          f"{res['resume_bit_identical']}, ops without a deterministic form "
          f"{res['nondeterministic_ops']}; launches a step {res['launches_per_step']}; "
          f"{res['seconds']:.1f} s")
    return res


def kernel_counters():
    """Every kernel wrapper of the JSON line, by its name there."""
    from bevfusion_tpu_torch.ops import bev_pool as bp
    from bevfusion_tpu_torch.ops import deform_conv as dc
    from bevfusion_tpu_torch.ops import nms
    from bevfusion_tpu_torch.ops import pointnet as pn
    from bevfusion_tpu_torch.ops import sparse_conv as sp
    from bevfusion_tpu_torch.tools import bench_kernel_variants as kv
    from bevfusion_tpu_torch.tools import bench_tile_micro as tm

    return {"sparse_conv": sp.sparse_conv, "sparse_conv_dw": sp.sparse_conv_dw,
            "sparse_conv_bf16": sp.sparse_conv_bf16,
            "sparse_conv_dw_bf16": sp.sparse_conv_dw_bf16, "bev_pool": bp.bev_pool,
            "tile_copy": tm.copy_add_one, "tile_gather": tm.gather_tiles,
            "sparse_conv_variants": kv.sparse_conv_variant, "greedy_nms": nms.greedy_suppress,
            "deform_im2col": dc.deform_im2col, "furthest_point_sample": pn.furthest_point_sample}


def no_dropout(model) -> None:
    """Every dropout and drop-path rate of ``model`` to 0: each rank draws its
    own masks (``runtime/train.py:step_seed``), so a parity run draws none."""
    from bevfusion_tpu_torch.models.layers import Dropout, DropPath

    for m in model.modules():
        if isinstance(m, (Dropout, DropPath)):
            m.rate = 0.0


def dp_pass(cfg, model, batch, state0, dtype, store, tops, counters, plain=False):
    """One train step (``runtime/train.py:make_train_step``: forward, backward,
    the sum over the ranks where a group of several runs it, AdamW with the
    config's clip and schedules) from ``state0`` (the weights and buffers
    restored first) at ``dtype``, the proposals and Hungarian targets
    replayed from ``tops`` / ``store`` (recorded by the first pass), through
    the plain versions with ``plain``. Every launch count set to 0 just
    before and read just after. Returns the logs, every gradient as AdamW
    sees it, the state after, the launches, ms (host clock around the
    synchronised step) and the peak memory."""
    from bevfusion_tpu_torch.ops import bev_pool as bp
    from bevfusion_tpu_torch.ops import sparse_conv as sp
    from bevfusion_tpu_torch.runtime import train
    from bevfusion_tpu_torch.tools.bench_train_step import HORIZON

    model.load_state_dict(state0)
    model.compute_dtype = dtype
    opt = train.build_optimizer(
        cfg.optimizer, train.build_lr_schedule(cfg.lr_config, cfg.optimizer.lr, HORIZON), model,
        cfg.optimizer_config.grad_clip,
        train.build_momentum_schedule(cfg.get("momentum_config"), 0.9, HORIZON))
    step = train.make_train_step(model, opt, DEVICE, seed=0)
    params, grads = dict(model.named_parameters()), {}

    def mark(phase):
        if phase == "backward":
            grads.update({n: p.grad.detach().clone() for n, p in params.items()
                          if p.grad is not None})

    head = model.heads["object"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as replay:
        replay.enter_context(recorded_targets(head, store))
        replay.enter_context(recorded_proposals(head, tops))
        if plain:
            replay.enter_context(plain_kernels(sp, bp))
        logs = step(batch, mark)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    model.compute_dtype = torch.float32
    return {"logs": {k: float(v) for k, v in logs.items()}, "grads": grads,
            "lr0": opt.lr_schedule(0) * max(opt.lr_mult),  # the step's largest learning rate
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "launches": {k: c.launches for k, c in counters.items()}, "ms": ms,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def norm_gap(a, b) -> float:
    """|a - b| in norm (float64)."""
    return float((a.double() - b.double()).norm())


def pass_moves(p, ref):
    """How far pass ``p`` moved from pass ``ref``: each gradient's gap in
    norm, each BatchNorm running statistic's, and the parameter elements
    apart after AdamW by more than 1e-3 of the step's largest learning rate
    (``dp_gates`` reads them)."""
    lr0 = ref["lr0"]
    return {"grads": {n: norm_gap(p["grads"][n], g) for n, g in ref["grads"].items()},
            "stats": {k: norm_gap(p["state"][k], v) for k, v in ref["state"].items()
                      if "running" in k and v.is_floating_point()},
            "apart": sum(int(((p["state"][k] - v).abs() > 1e-3 * lr0).sum())
                         for k, v in ref["state"].items() if k in ref["grads"])}


def dp_gates(got, ref, moved):
    """The fp32 step of the ranks (``got``, the global gradient) against the
    one-process step R at the global batch (``ref``), phase 12's rules with
    its B' taken as the larger move of two rounding-level changes of R's
    forward (``moved``, ``pass_moves`` of R' through the plain versions and
    of R_b with float64 BatchNorm moments): every loss within
    ``TRAIN_LOSS_RTOL``; the whole gradient within ``TRAIN_GRAD_RTOL`` of R's
    in norm plus ``TRAIN_GRAD_SENSITIVITY`` x how far those passes move it,
    and each parameter's likewise (those zero but for rounding within
    ``ZERO_GRAD`` of the global norm) but for at most ``DP_FLIP_SHARE`` of
    them, each within ``DP_FLIP_RTOL``: a ReLU near zero that only the ranks'
    rounding flips (their decoder runs at B = 1) moves a small head gradient
    by 1e-3-4e-2 where neither pass flips it (measured on one H100: the dim
    branch's BatchNorm bias 3.9e-3 off, R' and the ranks' arithmetic in one
    process bit-equal or 6e-8 there); each BatchNorm running statistic
    within ``DP_STATS_RTOL`` plus the same multiple of their move. The parameters
    after AdamW's first step: it moves each element by lr * g / (|g| + eps)
    (+ the weight decay, the same on both sides), about lr times the
    gradient's sign, so the two sides agree but where a gradient element
    near zero took the other sign: every element within 2 lr (+ rounding)
    of R's, and the elements apart by more than 1e-3 lr at most
    ``TRAIN_GRAD_SENSITIVITY`` x the passes' count + 1e-4 of all. Returns
    the gaps and what is past a gate."""
    out, bad = {}, []
    loss_err = max(abs(got["logs"][k] - v) / max(abs(v), 1e-6)
                   for k, v in ref["logs"].items() if k.startswith("loss/"))
    out["loss_rel_err"] = loss_err
    if loss_err > TRAIN_LOSS_RTOL:
        bad.append(f"loss rel err {loss_err:.3e}")
    missing = sorted(set(ref["grads"]) - set(got["grads"]))
    if missing:
        return out, [f"gradients missing {missing[:3]}"]
    global_norm = math.sqrt(sum(float(g.double().square().sum()) for g in ref["grads"].values()))
    used, flips, gap_sq, move_sq = {}, {}, 0.0, [0.0] * len(moved)
    for n, g in ref["grads"].items():
        norm, gap = float(g.double().norm()), norm_gap(got["grads"][n], g)
        moves = [m["grads"][n] for m in moved]
        gap_sq += gap ** 2
        move_sq = [s + v ** 2 for s, v in zip(move_sq, moves)]
        zero = norm <= ZERO_GRAD * global_norm
        alone = ZERO_GRAD * global_norm if zero else TRAIN_GRAD_RTOL * norm
        u = gap / (alone + TRAIN_GRAD_SENSITIVITY * max(moves))
        if u > 1.0 and not zero and gap <= DP_FLIP_RTOL * norm:
            flips[n] = gap / norm
        else:
            used[f"grad {n}"] = u
    whole, whole_move = math.sqrt(gap_sq) / global_norm, math.sqrt(max(move_sq)) / global_norm
    out.update(grad_rel_gap=whole, grad_rel_move=whole_move, flips=flips)
    if whole > TRAIN_GRAD_RTOL + TRAIN_GRAD_SENSITIVITY * whole_move:
        bad.append(f"the whole gradient {whole:.3e} from R's in norm (the passes move it "
                   f"{whole_move:.3e})")
    if len(flips) > DP_FLIP_SHARE * len(ref["grads"]):
        bad.append(f"{len(flips)} gradients past phase 12's rule: {sorted(flips)[:5]}")
    lr0, apart, elements, worst = ref["lr0"], 0, 0, 0.0
    apart_p = [m["apart"] for m in moved]
    for k, v in ref["state"].items():
        if not v.is_floating_point():
            continue
        if "running" in k:
            move = TRAIN_GRAD_SENSITIVITY * max(m["stats"][k] for m in moved)
            alone = DP_STATS_RTOL * float(v.double().norm())
            used[f"bn {k}"] = norm_gap(got["state"][k], v) / max(alone + move, 1e-30)
        elif k in ref["grads"]:
            d = (got["state"][k] - v).abs()
            # 2 lr, and the fp32 rounding of the update and of the parameter
            worst = max(worst, float(((d - 1e-6 * v.abs()) / (2 * lr0 * (1 + 1e-5))).max()))
            apart += int((d > 1e-3 * lr0).sum())
            elements += v.numel()
    out.update(param_worst_of_2lr=worst, params_apart=apart, params_apart_r_prime=apart_p,
               param_elements=elements)
    if worst > 1.0:
        bad.append(f"a parameter {worst:.3f} x 2 lr from R's")
    if apart > TRAIN_GRAD_SENSITIVITY * max(apart_p) + 1e-4 * elements:
        bad.append(f"{apart} parameter elements apart from R's (R', R_b: {apart_p})")
    order = sorted(used, key=used.get, reverse=True)
    bad += [f"{n} at {used[n]:.3f} of its gate" for n in order if used[n] > 1.0]
    for kind in ("grad", "bn"):
        top = next((n for n in order if n.startswith(kind)), None)
        out[f"{kind}_worst"] = [top, used[top]] if top else None
    out["gate_most_used"] = [[n, used[n]] for n in order[:5]]
    return out, bad


def dp_rank(rank: int, world: int, port: int, root: str) -> int:
    """A rank of phase 13c (``python3 chip_smoke.py --dp-rank R WORLD PORT DIR``):
    gloo on CUDA tensors (two ranks share the card; NCCL refuses that), the
    flagship from ``DIR/spec.pt`` (weights, the global batch, the one-process
    step's proposals and Hungarian targets), its rows of the batch
    (``parallel.shard_batch``) with their own pooling LUT, rank 0's state
    broadcast and checked; then the steps (``dp_pass``): the control with
    the loss normalisers' sum patched out (untimed, it also warms cuDNN), the
    fp32 step, the control with the BatchNorm sums patched out
    (``without_sync``), an untimed bf16 step and the bf16 step, each real
    step followed by the check that every rank holds rank 0's weights. Rank
    0 holds them to the one-process steps (``DIR/ref.pt``): ``dp_gates`` at
    fp32, which must refuse both controls; at bf16 the losses within
    ``BF16_DP_LOSS_GAP`` and the gradients within ``BF16_TRAIN_VS_TF32`` x a
    TF32 pass's gap, 13b's gate. Prints one JSON line: launches, ms and peak
    of each step, the gaps."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from bevfusion_tpu_torch import parallel
    from bevfusion_tpu_torch.config import load_config
    from bevfusion_tpu_torch.models import build_model
    from bevfusion_tpu_torch.runtime.flagship import FLAGSHIP_CONFIG, add_pool_lut, batch_to

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    parallel.init("cuda", "gloo", f"tcp://localhost:{port}", rank, world, timeout_s=600)
    counters = kernel_counters()
    spec = torch.load(os.path.join(root, "spec.pt"), weights_only=False)
    cfg = load_config(FLAGSHIP_CONFIG)
    model = build_model(cfg.model, "cpu")
    model.load_state_dict(spec["state"])
    model.to(DEVICE)
    no_dropout(model)
    batch = batch_to(add_pool_lut(cfg, parallel.shard_batch(spec["batch"], rank, world)), DEVICE)
    state0 = {k: v.to(DEVICE) for k, v in spec["state"].items()}
    differed = parallel.replicate_state(state0)
    store = {0: tuple(t.to(DEVICE) for t in spec["targets"][rank])}
    tops = {"top": spec["top"][rank:rank + 1].to(DEVICE)}
    ref = (torch.load(os.path.join(root, "ref.pt"), map_location=DEVICE, weights_only=False)
           if rank == 0 else None)
    res = {"rank": rank, "world": world, "replicated": len(differed), "controls": {}}

    def step(dtype, sync=None):
        with without_sync(sync):
            return dp_pass(cfg, model, batch, state0, dtype, store, tops, counters)

    def control(sync):
        r = step(torch.float32, sync)
        if ref is not None:
            gaps, past = dp_gates(r, ref["R"], ref["moves"])
            res["controls"][sync] = {"gaps": gaps, "past_gate": past}

    def kept(name, r):
        parallel.assert_replicated(dict(model.state_dict()), f"13c {name}: the weights after")
        res[name] = {"launches": r["launches"], "ms": r["ms"], "peak_mem_bytes": r["peak_mem_bytes"],
                     "loss_total": r["logs"]["loss/total"]}

    control("count_sum")  # also the untimed first step: cuDNN's search
    fp32 = step(torch.float32)
    kept("fp32", fp32)
    if ref is not None:
        res["fp32"]["gaps"], res["fp32"]["past_gate"] = dp_gates(fp32, ref["R"], ref["moves"])
    del fp32
    control("moments")
    step(torch.bfloat16)  # warm: cuDNN's search at bf16
    got = step(torch.bfloat16)
    kept("bf16", got)
    if ref is not None:
        want = ref["R16"]
        loss_gap = max(abs(got["logs"][k] - v) / max(abs(v), 1e-6)
                       for k, v in want["logs"].items() if k.startswith("loss/"))
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in want["grads"].values()))
        grad_gap = math.sqrt(sum(norm_gap(got["grads"][n], g) ** 2
                                 for n, g in want["grads"].items())) / norm
        ok = all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                 for g in got["grads"].values()) and set(got["grads"]) == set(want["grads"])
        past = [] if ok else ["a gradient missing, not fp32 or not finite"]
        if not loss_gap <= BF16_DP_LOSS_GAP:
            past.append(f"loss gap {loss_gap:.3e}")
        if not grad_gap <= BF16_TRAIN_VS_TF32 * ref["tf32_gap"]:
            past.append(f"gradient gap {grad_gap:.3e} past {BF16_TRAIN_VS_TF32:g} x TF32's "
                        f"{ref['tf32_gap']:.3e}")
        res["bf16"].update(loss_rel_gap=loss_gap, grad_rel_gap=grad_gap,
                           tf32_gap=ref["tf32_gap"], past_gate=past)
    torch.distributed.destroy_process_group()
    print("DP_RANK " + json.dumps(res))
    return 0


@contextlib.contextmanager
def without_sync(sync):
    """13c's controls, on every rank alike: ``count_sum``, each loss
    normaliser and mean count this rank's own (the sum over the ranks
    patched out of ``parallel.count_sum``); ``moments``, each BatchNorm's
    moments this rank's own (``parallel.masked_moments`` run as at world
    size 1). None: as it is."""
    from bevfusion_tpu_torch import parallel

    if sync is None:
        yield
        return
    saved = parallel.count_sum, parallel.masked_moments
    if sync == "count_sum":
        parallel.count_sum = lambda t: t.detach()
    else:
        check(sync == "moments", f"13c: no control {sync!r}")

        def own(x, m, dims):
            active = parallel.active
            parallel.active = lambda: False
            try:
                return saved[1](x, m, dims)
            finally:
                parallel.active = active
        parallel.masked_moments = own
    try:
        yield
    finally:
        parallel.count_sum, parallel.masked_moments = saved


def dp_phase(counters):
    """Phases 13c and 13d: data parallelism on one card.

    13c. The flagship's full-width train step at 2 ranks x 1 sample (two
    processes, gloo on CUDA tensors: NCCL refuses two ranks on one card)
    against one process at B = 2 on the same weights and batch, fp32 with
    TF32 off and deterministic algorithms, every dropout rate 0: the
    one-process passes R (kernels; its proposals and Hungarian targets
    recorded and replayed to every later pass, as phase 12), N2 (R again,
    warm, timed), R' (the plain versions), R_b (float64 BatchNorm moments,
    ``float64_moments``), T (TF32 on) and R16 (bf16 kernels; again warm,
    timed) run here, then the ranks (``dp_rank``): each launches K1/K2 29, K3
    15 and K4 once at fp32 and the bf16 forms as many at bf16; rank 0 holds
    its step to R (``dp_gates``, B' from R' and R_b) and R16, and the gate
    must refuse both controls (a sync patched out, ``without_sync``).

    13d. NCCL at world size 1: a group of one joined on the card, the step
    through it (no collective runs at world size 1) against R and N2: its
    gap to R within 2x N2's (bit-equal where that is 0); then one NCCL
    all-reduce and broadcast of the gradients, which must come back
    unchanged. Returns the results."""
    from bevfusion_tpu_torch import parallel
    from bevfusion_tpu_torch.config import load_config
    from bevfusion_tpu_torch.models import build_model
    from bevfusion_tpu_torch.runtime.flagship import (FLAGSHIP_CONFIG, add_pool_lut,
                                                      add_train_targets, batch_to, init_weights,
                                                      synthetic_batch)

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "dp_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = load_config(FLAGSHIP_CONFIG)
    model = init_weights(build_model(cfg.model, "cpu"), seed=0).to(DEVICE).train()
    batch = add_train_targets(cfg, synthetic_batch(cfg, B=DP_WORLD, num_points=120000, seed=0,
                                                   training=True), 0)
    one = batch_to(add_pool_lut(cfg, batch), DEVICE)
    prepare_train_model(model, one)
    no_dropout(model)
    state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    store, tops, passes = {}, {}, {}
    for name, dtype, plain, tf32 in (("R", torch.float32, False, False),
                                     ("N2", torch.float32, False, False),
                                     ("R'", torch.float32, True, False),
                                     ("R_b", torch.float32, False, False),
                                     ("T", torch.float32, False, True),
                                     ("R16", torch.bfloat16, False, False),
                                     ("R16w", torch.bfloat16, False, False)):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        with float64_moments() if name == "R_b" else contextlib.nullcontext():
            passes[name] = dp_pass(cfg, model, one, state0, dtype, store, tops, counters, plain)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    # a rank's launches a step (B = 1), and one process's at B = 2: the sparse convs run
    # sample by sample, the pool once on the batch's intervals together
    per_rank = {"fp32": dict(dict.fromkeys(counters, 0), **TRAIN_LAUNCHES),
                "bf16": dict(dict.fromkeys(counters, 0), **BF16_TRAIN_LAUNCHES)}
    want = {key: {k: DP_WORLD * v if k.startswith("sparse") else v for k, v in w.items()}
            for key, w in per_rank.items()}
    for name, key in (("R", "fp32"), ("R16", "bf16")):
        check(passes[name]["launches"] == want[key],
              f"13c one process {name}: launches {passes[name]['launches']}, want {want[key]}")
    grads_r = passes["R"]["grads"]
    norm_r = math.sqrt(sum(float(g.double().square().sum()) for g in grads_r.values()))

    def global_gap(p):
        return math.sqrt(sum(norm_gap(p["grads"][n], g) ** 2 for n, g in grads_r.items())) / norm_r

    tf32_gap = global_gap(passes["T"])
    r16 = {k: passes["R16"][k] for k in ("logs", "grads")}
    torch.save(to_cpu({"R": passes["R"], "R16": r16, "tf32_gap": tf32_gap,
                       "moves": [pass_moves(passes[n], passes["R"]) for n in ("R'", "R_b")]}),
               os.path.join(root, "ref.pt"))
    torch.save({"state": {k: v.cpu() for k, v in state0.items()}, "batch": batch,
                "top": tops["top"].cpu(),
                "targets": [tuple(t.cpu() for t in store[b]) for b in range(DP_WORLD)]},
               os.path.join(root, "spec.pt"))
    plain = passes["R'"]
    print(f"13c one process at B = {DP_WORLD}: R {passes['R']['ms']:.1f} ms (loss "
          f"{passes['R']['logs']['loss/total']:.4f}), R' (plain) {plain['ms']:.1f} ms, gradient gap "
          f"to R {global_gap(plain):.3e}, R_b (float64 BatchNorm moments) gradient gap to R "
          f"{global_gap(passes['R_b']):.3e}, "
          f"T (TF32 on) {passes['T']['ms']:.1f} ms, gradient gap to R {tf32_gap:.3e}; R16 "
          f"(loss {passes['R16']['logs']['loss/total']:.4f}); ms a warm step (TF32 off) fp32 "
          f"{passes['N2']['ms']:.1f}, bf16 {passes['R16w']['ms']:.1f}; peak "
          f"{passes['R']['peak_mem_bytes'] / 2**20:.1f} MiB (fp32), "
          f"{passes['R16w']['peak_mem_bytes'] / 2**20:.1f} MiB (bf16)")
    one_process = {"fp32_ms": passes["N2"]["ms"], "bf16_ms": passes["R16w"]["ms"],
                   "fp32_peak_mem_bytes": passes["R"]["peak_mem_bytes"],
                   "bf16_peak_mem_bytes": passes["R16w"]["peak_mem_bytes"],
                   "grad_rel_move_plain": global_gap(plain),
                   "grad_rel_move_float64_moments": global_gap(passes["R_b"]),
                   "grad_rel_move_tf32": tf32_gap}

    # 13d. the step through a group of one on NCCL against the step without a group
    rr = global_gap(passes["N2"])
    parallel.init(DEVICE, "nccl", f"tcp://localhost:{free_port()}", 0, 1, timeout_s=300)
    try:
        check(parallel.world() == 1 and not parallel.active(), "13d: a group of one")
        grp = dp_pass(cfg, model, one, state0, torch.float32, store, tops, counters)
        flat = torch.cat([g.flatten() for g in grp["grads"].values()])
        before = flat.clone()
        torch.distributed.all_reduce(flat)
        torch.distributed.broadcast(flat, src=0)
        torch.cuda.synchronize()
        nccl_same = torch.equal(flat, before)
    finally:
        torch.distributed.destroy_process_group()
    gap = global_gap(grp)
    loss_gap = abs(grp["logs"]["loss/total"] - passes["R"]["logs"]["loss/total"])
    rr_loss = abs(passes["N2"]["logs"]["loss/total"] - passes["R"]["logs"]["loss/total"])
    print(f"13d NCCL, a group of one: gradient gap to R {gap:.3e} in norm (the run-to-run gap "
          f"{rr:.3e}, N2's: R again without a group), loss gap {loss_gap:.3e} "
          f"(run to run {rr_loss:.3e}); launches {grp['launches']}; an NCCL all-reduce and "
          f"broadcast of the gradients left them unchanged: {nccl_same}")
    check(grp["launches"] == want["fp32"], f"13d: launches {grp['launches']}")
    check(nccl_same, "13d: NCCL changed the gradients at world size 1")
    check(gap <= 2 * rr and loss_gap <= 2 * rr_loss,
          f"13d: the step through the group is {gap:.3e} ({loss_gap:.3e} in the loss) from R, "
          f"past 2x the run-to-run gap {rr:.3e} ({rr_loss:.3e})")
    nccl = {"grad_gap": gap, "run_to_run_gap": rr, "loss_gap": loss_gap,
            "run_to_run_loss_gap": rr_loss, "nccl_unchanged": nccl_same,
            "launches": grp["launches"]}
    del passes, grp, flat, before, model, one
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False

    # 13c. the ranks
    t0 = time.perf_counter()
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
                               str(DP_WORLD), str(port), root], stdout=subprocess.PIPE,
                              text=True) for r in range(DP_WORLD)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    ranks_s = time.perf_counter() - t0
    check(all(p.returncode == 0 for p in procs),
          f"13c: ranks exited {[p.returncode for p in procs]}")
    ranks = [json.loads(next(line[8:] for line in o.splitlines() if line.startswith("DP_RANK ")))
             for o in outs]
    for r in ranks:
        for key in ("fp32", "bf16"):
            launches = r[key]["launches"]
            print(f"13c rank {r['rank']} {key}: launches {launches}; {r[key]['ms']:.1f} ms a step "
                  f"(gloo on CUDA tensors, two ranks on one card); peak "
                  f"{r[key]['peak_mem_bytes'] / 2**20:.1f} MiB; loss {r[key]['loss_total']:.4f}")
            check(launches == per_rank[key], f"13c rank {r['rank']} {key}: launches "
                  f"{launches}, want {per_rank[key]}")
        check(r["replicated"] == 0, f"13c rank {r['rank']}: {r['replicated']} tensors differed "
              "from rank 0's before the broadcast")
    g32, g16 = ranks[0]["fp32"], ranks[0]["bf16"]
    gaps = g32["gaps"]
    print(f"13c fp32, the ranks' step against R: loss rel err {gaps['loss_rel_err']:.3e}; the "
          f"whole gradient {gaps['grad_rel_gap']:.3e} in norm (R' and R_b move it up to "
          f"{gaps['grad_rel_move']:.3e}); past phase 12's rule per parameter (at most "
          f"{DP_FLIP_SHARE:g} of them, each within {DP_FLIP_RTOL:g}): "
          + (", ".join(f"{n} {v:.3e}" for n, v in gaps["flips"].items()) or "none")
          + "; the gates most used: " + "; ".join(f"{n} {u:.3f}" for n, u in gaps["gate_most_used"])
          + f"; parameters after AdamW: the largest gap {gaps['param_worst_of_2lr']:.3f} x 2 lr, "
          f"{gaps['params_apart']} of {gaps['param_elements']} elements apart (R', R_b "
          f"{gaps['params_apart_r_prime']})")
    for sync, c in ranks[0]["controls"].items():
        print(f"13c control, the sum over the ranks patched out of {sync}: the whole gradient "
              f"{c['gaps'].get('grad_rel_gap', float('nan')):.3e} from R's in norm, loss rel err "
              f"{c['gaps']['loss_rel_err']:.3e}, {len(c['past_gate'])} gates refuse it: "
              f"{c['past_gate'][:3]}")
        check(bool(c["past_gate"]), f"13c: the gate passed the control without {sync}")
    print(f"13c bf16, the ranks' step against R16: loss rel gap {g16['loss_rel_gap']:.3e} (gate "
          f"{BF16_DP_LOSS_GAP:g}), gradient gap {g16['grad_rel_gap']:.3e} in norm (gate "
          f"{BF16_TRAIN_VS_TF32:g} x T's {g16['tf32_gap']:.3e}); the ranks in {ranks_s:.1f} s")
    check(not g32["past_gate"], f"13c fp32: {g32['past_gate'][:5]}")
    check(not g16["past_gate"], f"13c bf16: {g16['past_gate'][:5]}")
    shutil.rmtree(root, ignore_errors=True)
    return {"one_process": one_process, "ranks": ranks, "ranks_s": ranks_s, "nccl_world_1": nccl,
            "seconds": time.perf_counter() - t_phase}


@contextlib.contextmanager
def float64_moments():
    """Pass R_b: every training BatchNorm (``models/layers.py``'s and the
    sparse encoder's masked one) normalised by moments this script takes
    itself, in float64 (two passes) and cast back to fp32, the running
    statistics moved alike: a rounding-level change of R's forward where the
    ranks' arithmetic differs from one process's, which runs nothing of
    ``parallel`` (``dp_gates`` takes B' from its move)."""
    from bevfusion_tpu_torch.models import layers
    from bevfusion_tpu_torch.models.sparse_encoder import MaskedBatchNorm

    def norm(bn, x, m, dims):
        xd = x.double()
        if m is None:
            mean = xd.mean(dims, keepdim=True)
            var = (xd - mean).square().mean(dims, keepdim=True)
        else:
            md = m.double()
            cnt = md.sum().clamp(min=1.0)
            mean = (xd * md).sum(dims, keepdim=True) / cnt
            var = ((xd - mean).square() * md).sum(dims, keepdim=True) / cnt
        mean, var = mean.float(), var.float()
        with torch.no_grad():
            bn.running_mean.lerp_(mean.flatten(), bn.momentum)
            bn.running_var.lerp_(var.flatten(), bn.momentum)
            bn.num_batches_tracked += 1
        shape = mean.shape
        return ((x.float() - mean) * torch.rsqrt(var + bn.eps) * bn.weight.view(shape)
                + bn.bias.view(shape))

    flax_forward, masked_train = layers._FlaxStatsBatchNorm.forward, MaskedBatchNorm._train

    def forward(self, x):
        if not self.training:
            return flax_forward(self, x)
        return norm(self, x, None, [0, *range(2, x.dim())]).to(x.dtype)

    layers._FlaxStatsBatchNorm.forward = forward
    MaskedBatchNorm._train = lambda self, x, m, dims: (norm(self, x, m, dims)
                                                    * m.float()).to(x.dtype)
    try:
        yield
    finally:
        layers._FlaxStatsBatchNorm.forward, MaskedBatchNorm._train = flax_forward, masked_train


def free_port() -> int:
    """A free localhost port (bound, then released for a group to take)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def to_cpu(obj):
    """``obj`` (nested dicts of tensors) with every tensor on the CPU."""
    if torch.is_tensor(obj):
        return obj.cpu()
    return {k: to_cpu(v) for k, v in obj.items()} if isinstance(obj, dict) else obj


def gate_probe() -> int:
    """``python3 chip_smoke.py --gate-probe``: the readings behind the gates
    that hold runs on the card to their run-to-run gap (one card): phase
    11e's resume gate at fp32 and bf16 (``PROBE_RESUMES`` resumes B,
    ``PROBE_RERUNS`` reruns of A, the control C; ``gate_readings``), 11e-dp's
    first-step loss (``PROBE_ONE_PROCESS`` one-process runs,
    ``PROBE_RANKS_RUNS`` two-rank runs, a control without the loss
    normalisers' sum), then phases 13c-13d as the smoke runs them
    (``dp_gates`` and its two controls). Prints the readings as one JSON
    line and writes them to build/gate_probe.json."""
    t_start = time.perf_counter()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from bevfusion_tpu_torch.ops import bev_pool as bp
    from bevfusion_tpu_torch.ops import sparse_conv as sp

    smi = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(3) as ex:
        list(ex.map(lambda build: build(), (sp.build_kernels, sp.build_dw_kernels,
                                            bp.build_kernels)))
    counters = kernel_counters()
    cli = train_cli_phase(counters, smi, bp, probe=True)
    out = {"card": smi, "train_cli": {"fp32": cli.get("probe"), "bf16": cli["bf16"].get("probe")},
           "train_cli_dp": cli["dp"]["probe"]}
    path = os.path.join(here, "build", "gate_probe.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f)
    dp = dp_phase(counters)
    r0 = dp["ranks"][0]
    out["dp"] = {"fp32": r0["fp32"]["gaps"], "controls": r0["controls"],
                 "one_process": dp["one_process"]}
    out["seconds"] = time.perf_counter() - t_start
    with open(path, "w") as f:
        json.dump(out, f)
    print(json.dumps(out))
    return 0


def long_tail_only() -> int:
    """``python3 chip_smoke.py --long-tail``: the kernels that path runs built
    (one nvcc per source, started together), then phase 11g alone on the
    flagship; its results as a JSON line. A quick check of the long tail."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bevfusion_tpu_torch import native
    from bevfusion_tpu_torch.ops import bev_pool as bp
    from bevfusion_tpu_torch.ops import deform_conv as dc
    from bevfusion_tpu_torch.ops import nms
    from bevfusion_tpu_torch.ops import pointnet as pn
    from bevfusion_tpu_torch.ops import sparse_conv as sp
    from bevfusion_tpu_torch.runtime.flagship import batch_to, build_flagship

    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}")
    t0 = time.perf_counter()
    builds = (sp.build_kernels, bp.build_kernels, nms.build_kernels, dc.build_kernels,
              pn.build_kernels)
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda build: build(), builds))
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for lib in ("deform_conv", "pointnet"):
        for line in native.build_log(lib).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu_model, cpu_batch = build_flagship("cpu", num_points=120000, seed=0)
    model, batch = copy.deepcopy(cpu_model).to(DEVICE), batch_to(cpu_batch, DEVICE)
    res, d1, d2 = long_tail_phase(cfg, model, batch, cpu_model, cpu_batch, kernel_counters())
    print(json.dumps({"long_tail": res, "deform_im2col": d1, "furthest_point_sample": d2}))
    return 0


def sparse_kernels_only() -> int:
    """``python3 chip_smoke.py --sparse-kernels``: the three sparse-conv
    sources built (one nvcc each, started together) and their ptxas lines,
    then phase 5b and phase 7 alone at the LiDAR branch's shapes: K1/K2 bf16
    and K3 bf16 against their plain versions, K1/K2 bf16's plans and times
    beside its times before the redesign, K7's three families against their
    plain versions and the bf16 family's breakdown (phase 14's, here
    alone); the results as a JSON
    line. A quick check of the sparse-conv kernels."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bevfusion_tpu_torch import native
    from bevfusion_tpu_torch.ops import sparse_conv as sp
    from bevfusion_tpu_torch.runtime.flagship import batch_to, build_lidar_slice
    from bevfusion_tpu_torch.tools import bench_kernel_variants as kv

    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}")
    t0 = time.perf_counter()
    builds = {"sparse_conv": sp.build_kernels, "sparse_conv_dw": sp.build_dw_kernels,
              "sparse_conv_variants": kv.build_kernels}
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda build: build(), builds.values()))
    print(f"build: {time.perf_counter() - t0:.2f} s")
    ptxas_lines(native, builds)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    _, cpu_model, cpu_batch = build_lidar_slice("cpu", num_points=120000, seed=0)
    batch = batch_to(cpu_batch, DEVICE)
    vox = cpu_model.lidar_voxelize(batch["points"], batch["points_mask"])
    enc = cpu_model.encoders["lidar"]["backbone"]
    cases = kernel_cases(enc, vox.feats[0], vox.coords[0], vox.mask[0], sp)
    k7_cases = kv.stage_cases(enc, vox.coords[0], vox.mask[0])
    fwd, dw = bf16_kernel_phase(sp, cases, None, None)
    passes = dw_bf16_kernels(sp, kv, cases)
    checks, _ = variant_checks(kv, sp, k7_cases)
    rows = kv.breakdown(k7_cases, DEVICE, families=("bf16", "dw_bf16"))
    kv.print_breakdown(rows)
    finite_rows([m for r in rows for m in r["modes"].values()], "bf16 breakdown")
    print(json.dumps({"sparse_conv_bf16": fwd, "sparse_conv_dw_bf16": dw,
                      "sparse_conv_dw_bf16_kernels": passes, "bf16_breakdown": rows,
                      "k7_max_abs_err": {f"{k[0]} {k[1]}": v[0] for k, v in checks.items()}}))
    return 0


def dw_bf16_kernels(sp, kv, cases):
    """K3 bf16 at the six shapes of phase 5b (the same operands): each CUDA
    kernel's device time a call of ``sparse_conv_dw`` from a
    ``torch.profiler`` trace of 20 calls (``kv.device_ms_by_kernel``: its
    launches apart, where it makes more than one). Returns {shape: {kernel:
    ms}}."""
    out = {}
    for label, (feats, nbr, w), _, valid, _, _ in cases:
        hits = int((nbr >= 0).sum())
        dout = torch.randn(nbr.shape[1], w.shape[2], device=DEVICE,
                           generator=torch.Generator(device=DEVICE).manual_seed(hits))
        x, dout = feats.bfloat16(), (dout * valid[:, None]).bfloat16()
        out[label] = kv.device_ms_by_kernel(lambda: sp.sparse_conv_dw(x, nbr, dout))
        print(f"kernel sparse_conv_dw_bf16 {label}: device ms a call by kernel "
              + ", ".join(f"{k} {v:.4f}" for k, v in out[label].items())
              + f" (sum {sum(out[label].values()):.4f})")
    return out


def ptxas_lines(native, libs) -> None:
    """Each library's ptxas lines: the kernel (demangled by c++filt where the
    toolkit's cu++filt is there), its registers, shared memory and spills."""
    for lib in libs:
        for line in native.build_log(lib).read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {lib}: {line.strip()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of phase 13c, started by the phase itself
        return dp_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    if sys.argv[1:2] == ["--gate-probe"]:
        return gate_probe()
    if sys.argv[1:2] == ["--long-tail"]:
        return long_tail_only()
    if sys.argv[1:2] == ["--sparse-kernels"]:
        return sparse_kernels_only()
    t_start = time.perf_counter()
    # cuBLAS takes deterministic workspaces only if told before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bevfusion_tpu_torch import native
    from bevfusion_tpu_torch.models.vtransforms import build_pool_lut
    from bevfusion_tpu_torch.ops import bev_pool as bp
    from bevfusion_tpu_torch.ops import deform_conv as dc
    from bevfusion_tpu_torch.ops import nms
    from bevfusion_tpu_torch.ops import pointnet as pn
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
              "sparse_conv_variants": kv.build_kernels, "nms": nms.build_kernels,
              "deform_conv": dc.build_kernels, "pointnet": pn.build_kernels}
    with ThreadPoolExecutor(len(builds)) as ex:  # one nvcc per source, started together
        list(ex.map(lambda build: build(), builds.values()))
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(builds)} in {build_s:.2f} s")
    ptxas_lines(native, builds)
    for lib in ("sparse_conv", "sparse_conv_dw", "sparse_conv_variants"):
        lines = native.sass(lib).splitlines()
        hmma = sum("HMMA" in line for line in lines)
        bf16 = sum("HMMA.16816.F32.BF16" in line for line in lines)
        print(f"build: {hmma} tensor-core (HMMA) instructions in the {lib} library's SASS, "
              f"{bf16} of them bf16 m16n8k16 (HMMA.16816.F32.BF16)")
        check(hmma > 0, f"the {lib} kernel has no tensor-core (HMMA) instruction")
        check(bf16 > 0 or lib == "sparse_conv_variants",
              f"the {lib} library's bf16 form has no bf16 mma (HMMA.16816.F32.BF16)")
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
    # 5b. the bf16 forms of K1/K2 and K3 at the same shapes
    bf16_shapes, bf16_dw_shapes = bf16_kernel_phase(sp, cases, shapes, dw_shapes)
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
              for r in profile_stages.profile_stages(model, batch, DEVICE, iters=STAGE_ITERS)[0]}
    for stage, ms in stages.items():
        print(f"flagship stage {stage}: {ms:.2f} ms")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    with torch.no_grad():
        frames_tf32, peak_tf32 = frame_ms(lambda: model(batch), *FRAMES)
    stages_tf32 = {r["stage"]: r["ms"]
                   for r in profile_stages.profile_stages(model, batch, DEVICE, iters=STAGE_ITERS)[0]}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"flagship, TF32 on: {statistics.median(frames_tf32):.2f} ms/frame median, "
          f"peak device memory {peak_tf32 / 2**20:.1f} MiB; stages "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in stages_tf32.items()))

    # 10b. the flagship's frame at bf16: launches, its gap to the fp32 frame, ms a frame
    bf16_eval = bf16_eval_phase(model, batch, dict(counters, sparse_conv_bf16=sp.sparse_conv_bf16))
    del depth, ctx, got, gout
    torch.cuda.empty_cache()

    # 11g. the long tail: DCNSeparateHead (D1), PointNet++ (D2), TransFusion NMS, the
    # conv_module encoder with the inverse conv and max pool, VoVNet / DLA + DetectronFPN,
    # AddFuser
    long_tail, d1_shapes, d2_shapes = long_tail_phase(cfg, model, batch, cpu_model, cpu_batch,
                                                      kernel_counters())
    del model, cpu_model, cpu_batch, batch
    torch.cuda.empty_cache()

    # 11. the three map-segmentation configs, eval forward at B=1, and the pool at the seg grid
    all_counters = kernel_counters()
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

    # 11d. the eval entry point on files: the flagship and the fused seg config from a dataset
    t0 = time.perf_counter()
    cli = cli_phase(all_counters, smi)
    cli_s = time.perf_counter() - t0
    print(f"cli: the synthesized set ({cli['write_s']:.1f} s), the flagship through "
          f"run_model_on_loader and the fused seg config through tools/test.py in {cli_s:.1f} s; "
          f"host pipeline {cli['flagship']['pipeline_ms_per_sample']:.1f} ms a sample, "
          f"{cli['flagship']['frame_ms_median_tf32']:.2f} ms a loaded flagship frame (TF32 on)")

    # 11e. the train entry point on files: the flagship 2 epochs at B=4, resumed; the seg config
    t0 = time.perf_counter()
    train_cli = train_cli_phase(all_counters, smi, bp)
    train_cli_s = time.perf_counter() - t0
    runs = "A, B, A', A'', C" if "a2" in train_cli else "A, B"
    print(f"train-cli: the synthesized set and its GT database ({train_cli['write_s']:.1f} s), "
          f"runs {runs} of the flagship and the seg config's epoch in {train_cli_s:.1f} s")

    # 11f. one bf16 eval frame of each of the ten other served configs
    t0 = time.perf_counter()
    bf16_cfgs = bf16_configs_phase(all_counters)
    bf16_cfgs_s = time.perf_counter() - t0
    print(f"bf16 configs: {len(bf16_cfgs)} configs' bf16 frames in {bf16_cfgs_s:.1f} s")

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

    # 13. two timed train steps, TF32 on
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    steps = train_steps(cfg, model, batch, DEVICE, steps=2, warmup=1)
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

    # 13b. the flagship's train step at bf16: launches, gradients vs fp32, ms a step
    bf16_train = bf16_train_phase(cfg, model, batch, all_counters, sp, bp)

    # 13c-13d. data parallelism: two ranks on the card over gloo against one process at B=2;
    # NCCL at world size 1
    dp = dp_phase(all_counters)
    print(f"data parallel: one process, the group of one on NCCL and the two ranks in "
          f"{dp['seconds']:.1f} s")

    # 14. the measurement tools: this path's entry points
    tools, tool_launches, tool_parts = tools_phase(cfg, model, batch, k7_cases, all_counters)
    del model, batch
    torch.cuda.empty_cache()

    # 14a, 14c. the export entry point: the flagship's eval forward through torch.export at bf16
    # and fp32, loaded back, against eager; the launches of both at run time
    t0 = time.perf_counter()
    exported = export_phase(all_counters, {
        "float32": statistics.median(frames),
        "bfloat16": statistics.fmean(bf16_eval["frame_ms_median"]["bfloat16"])})
    export_s = time.perf_counter() - t0

    # 14b. the longevity entry point, short form: one whole schedule of 12 bf16 steps
    longevity = longevity_phase()

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
    # the bf16 forms of K1/K2 and K3: launches in the bf16 train step (phase 13b)
    kernels += [
        dict(summary("sparse_conv_bf16", "bevfusion_tpu_torch/csrc/sparse_conv.cu",
                     "bevfusion_tpu/ops/sparse_conv_windowed.py:285",
                     bf16_train["launches"]["sparse_conv_bf16"], bf16_shapes),
             also_replaces=["bevfusion_tpu/ops/sparse_conv_windowed.py:180"],
             launches_eval=bf16_eval["launches"]["sparse_conv_bf16"],
             ms_no_epilogue=sum(s["ms_no_epilogue"] for s in bf16_shapes),
             plain_ms_no_epilogue=sum(s["plain_ms_no_epilogue"] for s in bf16_shapes),
             bound_ms_no_epilogue=sum(s["bound_ms_no_epilogue"] for s in bf16_shapes),
             fp32_ms=sum(s["fp32_ms"] for s in bf16_shapes)),
        dict(summary("sparse_conv_dw_bf16", "bevfusion_tpu_torch/csrc/sparse_conv_dw.cu",
                     "bevfusion_tpu/ops/sparse_conv_windowed.py:501",
                     bf16_train["launches"]["sparse_conv_dw_bf16"], bf16_dw_shapes),
             fp32_ms=sum(s["fp32_ms"] for s in bf16_dw_shapes)),
    ]
    # not TPU kernels either: the JAX package's deform_conv2d samples with XLA gathers, its
    # furthest_point_sample is a lax.fori_loop; launches in 11g's DCN frame and VoteNet stack
    kernels += [
        dict(summary("deform_im2col", "bevfusion_tpu_torch/csrc/deform_conv.cu",
                     "bevfusion_tpu/ops/deform_conv.py:52",
                     long_tail["dcn"]["launches"]["deform_im2col"], d1_shapes), pallas=False),
        dict(summary("furthest_point_sample", "bevfusion_tpu_torch/csrc/pointnet.cu",
                     "bevfusion_tpu/ops/pointnet.py:64",
                     long_tail["votenet"]["launches"]["furthest_point_sample"], d2_shapes),
             pallas=False)]
    for k in kernels[:3]:
        k["launches_tools"] = tool_launches[k["name"]]
    for k in kernels:
        k["launches_seg"] = {name: r["launches"][k["name"]] for name, r in seg.items()}
        k["launches_det_camera"] = {name: r["launches"][k["name"]] for name, r in det.items()}
        k["launches_pillar"] = {name: pillar[name]["launches"][k["name"]]
                                for name in ("pointpillars", "camera+radar")}
        k["launches_cli"] = {name: cli[name]["launches"][k["name"]] for name in ("flagship", "seg")}
        k["launches_train_cli"] = {name: train_cli[name]["launches"][k["name"]]
                                   for name in ("a", "b", "a2", "a3", "c", "seg")
                                   if name in train_cli}
        k["launches_train"] = {"flagship": parity["launches"][k["name"]],
                               **{name: r["launches"][k["name"]] for name, r in train_cfgs.items()}}
        k["launches_train_cli_bf16"] = {name: train_cli["bf16"][name]["launches"][k["name"]]
                                        for name in ("a", "b", "a2", "a3", "c")
                                        if name in train_cli["bf16"]}
        k["launches_bf16_configs"] = {name: r["launches"][k["name"]]
                                      for name, r in bf16_cfgs.items()}
        k["launches_bf16_train"] = bf16_train["launches"][k["name"]]
        k["launches_train_dp"] = {key: [r[key]["launches"][k["name"]] for r in dp["ranks"]]
                                  for key in ("fp32", "bf16")}
        k["launches_export"] = {dt: r["launches_loaded"][k["name"]] for dt, r in exported.items()}
        k["launches_longevity"] = longevity["launches_per_step"].get(
            {"greedy_nms": "greedy_suppress"}.get(k["name"], k["name"]), 0)
        k["launches_long_tail"] = long_tail_launches(long_tail, k["name"])
    print(json.dumps({
        "kernels": kernels, "build_s": build_s, "total_s": time.perf_counter() - t_start,
        "flagship": {"frame_ms_median": statistics.median(frames), "peak_mem_bytes": peak,
                     "heatmap_rel_err": heat_err, "stage_ms": stages,
                     "frame_ms_median_tf32": statistics.median(frames_tf32),
                     "peak_mem_bytes_tf32": peak_tf32, "stage_ms_tf32": stages_tf32},
        "seg": dict(seg, seconds=seg_s),
        "det_camera": dict(det, seconds=det_s),
        "pillar": dict(pillar, seconds=pillar_s),
        "cli": dict(cli, seconds=cli_s),
        "train_cli": dict(train_cli, seconds=train_cli_s),
        "train": {"parity_tf32_off": parity, "steps_tf32_on": steps},
        "train_configs": dict(train_cfgs, seconds=train_cfgs_s),
        "bf16": {"flagship_eval": bf16_eval, "configs": dict(bf16_cfgs, seconds=bf16_cfgs_s),
                 "train": bf16_train},
        "data_parallel": dp,
        "export": dict(exported, seconds=export_s),
        "longevity": {k: v for k, v in longevity.items() if k != "losses"},
        "long_tail": long_tail,
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
