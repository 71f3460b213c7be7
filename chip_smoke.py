#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (plr2_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its elapsed time; any failure raises and exits
non-zero, and there is no CPU fallback:

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles plr2_tpu_torch/csrc/*.cu with one nvcc call (into the
   git-ignored plr2_tpu_torch/_build/) and prints the wall time; scans
   the library's SASS (cuobjdump, beside nvcc): each bf16 tensor-core
   kernel must hold HGMMA (wgmma) instructions, each f32 kernel FFMA and
   no HMMA or HGMMA (no TF32 on the tensor cores), each instantiation of
   the int8 ladder IGMMA (s8 wgmma) and no IMMA (mma.sync), and no knn
   kernel any tensor-core instruction.
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in f32 and bf16, at the shapes the main path gives it (batch 8; f32
   also at batch 128, where it picks other tiles); then both dtypes at
   ragged shapes that fill no tile (heads at 977 and 8000 rows, K = 21,
   63, 84, and a narrow ladder; decoder stages at odd sizes, Cin 64 and
   1024, Cout 24 and 256, batch 1 and 3; f32 also Cin 6 and 37, Cout 10
   and 130, and a head of C = 202).
4. knn: the three ADD-S nearest-neighbour kernels (nn_match, nn_argmin,
   nn_match_mxu) against their plain twins at the stage-1 shape (5
   symmetric samples x 500k queries x 500 targets) and at YCB's 2600-point
   large mesh, plus duplicate targets at both sizes (the first index must
   win) and a ragged size (10,007 queries x 1029 targets).
5. gradients: the mlp_head and upconv3x3_prelu autograd Functions against
   autograd of their plain versions at the training shapes (batch 32).
6. main path: DenseFusionPipeline.estimate at YCB width (21 objects, 1000
   points, 160 px crops, 2 refine iterations, batch 8, seeded random
   weights) in f32 and bf16; checks the kernel launch counts of the run,
   finite outputs and unit quaternions, and q/t against the same pipeline
   run through the plain versions on the card.
7. train: one f32 stage-1 step and one refine-stage step of
   make_train_step at batch 32 (500 mesh points, YCB's symmetric objects),
   each once through the kernels and once through the plain versions from
   the same state and dropout seed; checks the launch counts of each step,
   loss, dis, gradients, updated parameters and BN running statistics;
   then 3 more stage-1 steps with finite losses.
8. timing: estimate frames/s at batch 8 and 128, per-kernel times at the
   main-path shapes beside the plain version, one PyTorch library call of
   the same function, and the bound of the H100 (also at batch 128);
   profiler tables of one f32 and one bf16 estimate at batch 128;
   train-step ms and samples/s of both stages; a profiler table of a
   stage-1 step.
9. tf32: the f32 estimate runs with TF32 off whatever the caller set (a
   hook on a PoseNet convolution reads the flags); then the f32 PoseNet at
   batch 128 with cuDNN TF32 on and off: ms and the best-hypothesis pose
   gap, the size of what the estimate's own switch closes.
10. quant: the int8 pose-head ladder (quantized_mlp_head) on the seeded
   PoseNet's three heads and fused 1408-d features at batch 8 (8000 rows):
   launch counts of the path, the kernel against its plain version in both
   rounding modes (exact), determinism per seed, accuracy against the f32
   head kernel (tests/test_quant.py's bounds), a small ladder of another
   depth at 40 rows; exactness in both modes also at batch 128 (128,000
   rows), on random rows of the YCB widths at 977 rows, on a ragged ladder
   (200 -> 72 -> 40 -> 24 -> 5) and on x of 202 columns; times at batch 8
   and 128 (stochastic rounding, the op's default, and to nearest) beside
   the f32 and bf16 head kernels, the plain version, a torch._int_mm
   chain and the bound.

11. trainer (after train): the training entry point at YCB width (21
   objects, 1000 points, 500 mesh points, YCB's symmetric objects) on the
   fixed 21-object synthetic library of tools/journey_config5.py at 480 x
   640 (16 train / 8 test samples, crops 80 to 200 px, non-square too):
   Trainer.fit for 2 epochs with margins that fire the decay and refine
   switches after epoch 1, best / last checkpoints, the launch counts per
   sample of each stage, the restore_into round trip (exact), a stop
   mid-window (BN back to the window's start, last saved); one stage-1
   epoch through the kernels and through the plain versions from one state
   and seed (losses 1e-4 relative, parameters 1e-3 relative L2 over the
   network); every
   kernel of that path against its plain version at each crop's shapes.
   Every trainer phase below runs its eager path (graphs=False); phase 20
   holds the CUDA graphs against it.
12. fused: one FusedTrainer epoch (window 8, f32) with its launch counts;
   a window on its shared canvas against 8 per-sample steps of the same
   samples (losses and gradients 1e-5 relative L2), and the per-sample
   loop against itself (bit-equal).
13. mixed: BatchTrainer in bf16 mixed precision, batch 32, stage 1, 3
   steps: launch counts, bf16 operands at both kernels, f32 parameters, BN
   statistics and Adam state; the same steps through the plain versions
   (loss 2e-2 relative) and in f32 (5%).
14. train entry timing: Trainer samples/s in both stages, a profiler table
   of one per-sample stage-1 step, FusedTrainer ms per window, mixed bf16
   ms per step and samples/s at batch 32, and the
   wall time of `python -m plr2_tpu_torch.tools.train --synthetic --nepoch
   2` on the card.
15. determinism (after train entry timing): one stage-1 step at batch 32
   under torch.use_deterministic_algorithms(True, warn_only=True) (the ops
   it names must be none; the switch is off again after it), the same
   switch on the ops that the step ran before (for the record), the step's
   kernels that scatter or index (printed); the gather's backward
   kernel against its plain version, bit for bit, on the step's indices and
   on repeated ones, f32 and bf16, and its time beside index_add_ and its
   bound; two runs each of a per-sample window at its own crops, a fused
   window and a mixed bf16 step from one state: gradients, parameters, BN
   buffers and losses bit-equal; the stage-1 step's ms with cuDNN
   restricted to deterministic algorithms and without.
16. eval (run right after main path): `evaluate` per-crop and batched
   (batch 16, canvas 240), f32 and bf16, at YCB width (21 objects, 1000
   points, 500 mesh points, 2 refine iterations, seeded weights) on 8
   held-out frames of the 21-object library (32 samples): launch counts
   per run, kernels vs plain versions
   on every sample's distance (a tolerance derived from the estimate gate;
   no hypothesis may flip in f32) and on each EvalResult field; samples/s.
17. eval entry: `python -m plr2_tpu_torch.tools.train --synthetic --nepoch
   1`, then `tools.eval_linemod --synthetic --model ... --refine_iterations
   4 --save_distances ...`, then `tools.plot_accuracy --distances ...
   --json ...` as processes (wall times), and the table against the same
   evaluation run in this process.

18. serve (after eval): FrameEstimator (plr2_tpu_torch/serving.py) at YCB
   width (21 objects, 1000 points, 500-point meshes, K = 5 slots, a 240 px
   canvas on 480 x 640 make_scene frames, 4 refine iterations, seeded
   weights): the device bbox against the host bbox (the frames' masks,
   an empty mask, edges, windows larger than the canvas); CUDA's stable
   sorts and the batched choose against the CPU's; run_with_samples
   against the port's host chain on the card (host bbox -> raw_to_sample
   with the same key words -> stack_samples -> estimate) on the wrap and
   the subsample path: choose, points, image, target and poses bit-equal;
   graph replay against eager, f32 and bf16, run and run_frames (F = 8):
   bit-equal; the launches of an eager run (3 + 3 per PoseNet forward)
   and the port's kernels in the profile of one replay against an eager
   run's; kernels against a use_kernels=False pipeline (the estimate
   gates); run_frames against 8 separate runs; valid / oversized on an
   inactive slot, an absent label and a window larger than the canvas; an
   eager run under torch.cuda.set_sync_debug_mode("error").
19. serve timing: frames/s of run (K = 5) and run_frames (F = 8), eager
   and graph, f32 and bf16 (CUDA events after warm-up), the latency of
   one synchronised run, the device-busy share and launches of one eager
   run and one replay (profiler), and the walls of `python -m
   plr2_tpu_torch.tools.serve --synthetic --num_frames 8` and `--batch 8`.

20. train graphs (after train entry timing): the training programs as
   CUDA graphs (plr2_tpu_torch/train/graphs.py). The host time of one
   eager per-sample stage-1 sample split into the data path (get_raw ->
   raw_to_sample -> preprocess_crop, synchronised), the kernels' plain
   backward passes (host time of the mlp_head / upconv3x3_prelu autograd
   Functions' backward, and their device time) and the rest (Python,
   dispatch and autograd, per launch), beside the device's busy time;
   a fused window of WINDOW as one graph against the per-sample loop on
   the same samples, masks and BN state (bit-equal, or FUSED_TOL), two
   replays bit-equal, the launch counters of the capture (warm-up + capture:
   the program twice; a replay adds none), the port's kernels in one
   replay's profile and its busy share; window ms graph vs eager (masks,
   copy-in and Adam included) and the split after the graphs; the refine
   stage's window (WINDOW // ITERS samples) as a graph against its loop,
   two replays and the counters; a FusedTrainer epoch with graphs against
   phase 12's eager epoch (same seeds; counters per capture); the mixed
   bf16 step at batch MIXED_BATCH as a graph against eager, two replays,
   and sym_slots auto (compact) against 0 (mixed): bit-equal; the refine
   stage's mixed step as a graph against eager, two replays; step ms of
   each and the busy share of an eager step and a replay; a graphed
   BatchTrainer epoch against phase 13's eager one; a full synthetic epoch
   (KEY_FRAMES frames, 256 samples) of each graphed trainer, twice, and of
   its eager twin: the distinct keys, the captures (fails if a key is
   captured twice), samples/s and the card memory the graphs held; remat
   at batch TRAIN_BATCH, f32, stage 1: gradients and BN bit-equal, the
   step's peak memory above the state (must be lower) and step ms.

21. real data: the real-data path (plr2_tpu_torch/data/{codecs,
   linemod, ycb, prefetch}.py, plr2_tpu_torch/native) on the card, with no
   PIL and no PyYAML. Writes a LineMOD tree at 480 x 640 (ape and the
   symmetric eggbox, 8 train and 2 test frames each; PNGs by the port's
   writer with every row filter, upstream-style gt.yml / models_info.yml
   text, ASCII PLY) and a YCB-Video tree (the 21 classes, meshes for three
   of them, one symmetric; real frames of both cameras and synthetic
   frames; meta.mat), and reads every file back (read_png, read_yaml:
   equal); the native data plane's g++ build time; prefetch at 0, 2 and 4
   workers, threads and processes, on both trees: bit-equal samples;
   decode ms cold and cached, native host prep and finish_sample ms a
   sample, prefetch samples/s at 0, 2 and 4 workers against the inline
   iterate_samples, Trainer stage-1 samples/s inline and with 2 workers;
   a stage-1 Trainer epoch and its test epoch on the LineMOD tree fed by 2
   worker threads (the launch counts: the slice's main path, added to the
   kernels line as "real_data"); the CLI chain as processes with walls:
   train --dataset linemod --dataset_root --workers 2 --cache_mb 64, then
   eval_linemod with and without --segnet_results (checkpoint restored,
   report keys the tree's objects), train --dataset ycb, serve
   --dataset_root eager and with graphs, infer on one frame; every kernel
   against its plain version at the real crops' shapes.

22. segmentation (last): the segmentation slice and the config-5 full
   pipeline (plr2_tpu_torch/models/segnet.py, train/seg_trainer.py,
   eval/{segment,full_pipeline}.py, the segmenter inside serving.py's
   graph) at YCB's 22 classes on 480 x 640 frames. Kernel 2 on the PSPNet
   segmenter's three decoder stages at full-frame shapes (60 x 80 x 1024
   -> 480 x 640 x 64; F = 1 and 8, and a 484 x 644 frame padded to 512 x
   672), f32 and bf16, against its plain version, and its time at F = 1
   and 8 beside the plain version, cuDNN's interpolate + conv2d + prelu
   and the bound; SegNet (VGG16 widths) at 480 x 640 run twice bit-equal,
   a frame of one colour included (every unpool window ties), and the
   PSPNet segmenter through the kernels against its plain versions, f32
   and bf16; each segmenter's frames/s at F = 1 and 8; 3 SegTrainer steps
   of each architecture at 128 px crops, batch 3 (finite, falling loss),
   the pspnet ones also through the plain versions from one state (loss
   1e-5 relative, parameters 1e-3 relative L2) and the step's ms;
   FrameEstimator with each segmenter at seg_scale 1 and 2, f32 and bf16
   (K = 5, canvas 240, 4 refine iterations): an eager run's launches
   (added to the kernels line as "segmentation"), two replays bit-equal
   to it, the labels at s = 1 equal to SegTrainer.predict's, frames/s
   eager and graph; evaluate_full_pipeline on 4 make_scene frames of 5
   objects with GT masks (host vs device mode: the same lost detections,
   distances within the estimate's gate; frames/s of both), with SegNet
   masks (a narrow SegNet with weights that label the scene colours: the
   segmenter inside the device program equal to device mode fed its
   labels, and host vs device where both cut the same window), with
   PoseCNN ROI results (lost and extra detections), and a .mat export read
   back by `tools.plot_accuracy --mat_dir --synthetic` (the same table as
   in the process); the CLIs as processes with walls: train_segmentation,
   eval_ycb --full_pipeline --save_mat and serve --seg_arch pspnet
   --seg_scale 2 at once, then segment_linemod on phase 21's LineMOD tree
   and eval_linemod --segnet_results on its masks.

23. parallel: the parallel layer (plr2_tpu_torch/parallel/) at the
   train cell's width (batch 32, 160 px, 1000 points, 21 objects, 2 refine
   iterations). (a) One rank over NCCL: the graphed data-parallel
   BatchTrainer step (its BatchNorm, gradient and metric collectives
   captured with the program) in f32 and bf16 against the single-device
   step, with its ms beside the graphed and eager single-device steps.
   f32: loss 1e-5, gradients outside the colour encoder 1e-3 in relative
   L2; the colour encoder's (ill-conditioned in f32) no less accurate
   against the float64 single-device step than the f32 single-device
   step's (twice its error plus 1e-3), and the float64 mesh step equal to
   the float64 single-device step (the plain versions; every gradient
   1e-3). bf16: the loss at the mixed phase's 2e-2, every gradient no less
   accurate against the f32 step than the bf16 single-device step's (twice
   plus 2e-2). run_frames over the mesh (F = 8, K = 5) against the
   unsharded call after 0, 2 and 4 refine iterations (the estimate gates)
   and the frames/s of both graphed; the tensor-parallel estimate and
   stage-1 step (no mlp_head launch: the sliced heads are per-layer
   F.linear), the point-parallel estimate and step (gradients as the
   f32 DP step's) and sp_match bit-equal to nn_match on one sample's
   500,000 ADD-S queries, the pipelined estimate (1 stage of 2 iterations,
   2 micro-batches); each counts its collectives (at least 1). (b) Two
   gloo ranks spawned on the one card, eager: the data-parallel step at
   batch 32 (16 a rank) against the single-device step on the global
   batch (as in (a), the float64 twins on rank 0), run_frames split 4 / 4
   against the unsharded call on each rank's 4 frames (the estimate gates,
   both dtypes, 0, 2 and 4 iterations) and on all 8 (f32 gated; bf16 up
   to 2 iterations within the 4-frame call's own gap to the 8-frame call,
   plus 5e-2), sp_match over 2 ranks bit-equal to nn_match, the pipelined
   estimate with pipe = 2; every rank's launches of kernels 1, 2, 4 and
   the gather.

24. tail (last): the last modules of the port and their tools.
   `tools.soak_run --mode fused` starts first as a process (one SIGTERM
   after epoch 2, the auto-resume, a 4-epoch horizon on 16 frames; its
   summary checked at the end) and shares the card with the untimed work
   that follows. Every kernel of the tools' path against its plain
   version at their shapes (the decoder on the 240 px canvas at batch 8
   and 32, f32 and bf16; the heads at 500 points and 4 objects; the ADD-S
   match of 32 symmetric samples of 500 x 256 queries). A YAML written by
   `config_io.save_config`
   (the linemod_train preset, 2 epochs) reads back equal; a torchvision-
   layout resnet18 state dict built from a seed loads into a Trainer's
   pipeline on the card (90 tensors imported, 32 skipped, each imported
   tensor equal to the source, the stem at its init); `tools.train
   --config --synthetic --pretrained_trunk` runs as a process;
   `tools.export_torch` splits its `best` into the reference's two .pth
   files and `load_reference_checkpoint` reloads them into a fresh
   pipeline: its f32 estimate bit-equal to the checkpoint's. Then, in
   this process, a shortened `tools.train_synthetic_e2e` (200 steps at
   batch 32, an evaluation every 100; its FINAL line); once the soak run
   has ended, `tools.overfit_synthetic` at batch 8 for 100 steps in f32
   and with --bf16 (the last dis below the first; samples/s) and
   `utils.debug.checked` around an f32 stage-1 step (the loss bit-equal
   to the unchecked step's; an injected NaN raises). The launches of the
   in-process runs go into the kernels line as "tail".

The second-to-last line is a JSON object with one entry per kernel and
dtype; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# main-path configuration (bench.py's flagship shape)
NUM_OBJ, NUM_POINTS, CROP, ITERS = 21, 1000, 160, 2
BATCH, BATCH_BIG = 8, 128
# PSP decoder stages at 160 px: (h, w, Cin, Cout) of the low-res input
STAGES = {"up_1": (20, 20, 1024, 256), "up_2": (40, 40, 256, 64),
          "up_3": (80, 80, 64, 64)}
HEAD_WIDTHS = (1408, 640, 256, 128)
HEAD_OUT = {"r": 4, "t": 3, "c": 1}

# H100 SXM published dense peaks (NVIDIA data sheet, 700 W); int8 in ops/s
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12

# kernel vs plain version on the card: |k - p| <= atol + rtol |p|. f32:
# the same f32 products summed in another order. bf16: outputs (and, in
# the ladder, the activations between layers) are rounded to bf16, so a
# sum that lands near a rounding boundary may round one ulp (2^-8 relative)
# the other way, and the ladder carries such flips on.
TOL = {"f32": (1e-4, 1e-4), "bf16": (3e-2, 3e-2)}
# estimate, kernel pipeline vs plain-version pipeline, on q and t of the
# frames that pick the same best hypothesis. Near-ties in confidence may
# pick different hypotheses (only allowed within CONF_TIE).
POSE_TOL = {"f32": 1e-3, "bf16": 5e-2}
CONF_TIE = {"f32": 1e-5, "bf16": 1e-2}

# training slice: bench.py --train's batch, YCB's mesh sizes and
# symmetric objects (plr2_tpu/config.py:139), the reference w and lr
TRAIN_BATCH, MESH_POINTS, MESH_LARGE = 32, 500, 2600
SYM_LIST, W, LR = (12, 15, 18, 19, 20), 0.015, 1e-4
# stage-1 ADD-S match: the symmetric samples of idx = arange(32) % 21; the
# steps on train's batch compact the match to exactly these rows
# (make_train_step(sym_slots=NUM_SYM): the compact branch)
NUM_SYM = sum(int(i % NUM_OBJ in SYM_LIST) for i in range(TRAIN_BATCH))
# nn_match_mxu vs its twin: the kernel fuses a.(-2b) into FMAs and the twin
# rounds each product, so they may pick different targets only where two
# targets' augmented d2 agree to within rounding of the summed terms
# (|a|^2, |b|^2 and 2 a.b, which cancel down to d2)
MXU_TIE = 1e-6
# train step, kernels vs plain versions on the card (f32): relative error
# of loss and dis; each parameter's gradient in relative L2 norm: f32 sums
# over 32,000 rows or 51,200 pixels in another order, and ReLU masks of
# near-zero activations that the kernel's forward and the cuBLAS recompute
# in the ladder's backward may put on different sides of 0 (measured on an
# H100 80GB HBM3 at 700 W: 1.9e-4 on the colour encoder, and 1.4e-4 of the
# largest entry on the heads); BN statistics as |d| <= atol + rtol |ref|
STEP_TOL = {"loss": 1e-5, "grad_l2": 1e-3, "bn": (1e-5, 1e-4)}

# int8 head ladder: kernel vs plain version must agree exactly (the same f32
# steps, each correctly rounded, and exact int32 sums); accuracy against the
# f32 head kernel as tests/test_quant.py:47-49 bounds it
QUANT_SEED = 1234
QUANT_ACC = {"median": 0.05, "mean": 0.15}
QUANT_SMALL, QUANT_SMALL_ROWS = (128, 64, 32, 16), 40  # tests/test_quant.py
# and ragged ladders at 977 rows (no whole 64-row block): the YCB widths
# on random rows, widths of no multiple of 16 or 128, and x of 202 columns
# (not a multiple of 4: scalar loads, weights padded by the wrapper)
QUANT_RAGGED = [(977, HEAD_WIDTHS + (NUM_OBJ * od,)) for od in HEAD_OUT.values()] \
    + [(977, (200, 72, 40, 24, 5)), (977, (202, 40, 24, 12, 5))]
# a unit quaternion after the estimate: f32 exact to rounding; bf16 is
# normalised and composed in bf16 as in JAX and not renormalised after the
# last composition, so each component carries a few bf16 ulps (3.9e-3)
QUAT_NORM_TOL = {"f32": 1e-5, "bf16": 3e-2}

# the training entry point (Trainer, FusedTrainer, BatchTrainer) at YCB's
# width on the fixed 21-object library of tools/journey_config5.py: library
# ids 13, 16, 19, 20, 21 are the symmetric boxes, YCB's 0-based SYM_LIST
LIB_SYM_IDS = (13, 16, 19, 20, 21)
TRAIN_FRAMES, TEST_FRAMES, PER_FRAME = 4, 2, 4  # 16 train / 8 test samples
WINDOW = 8  # the per-sample trainers' accumulation window (batch_size)
MIXED_BATCH, MIXED_STEPS = 32, 3
# a full synthetic epoch for the training graphs' key space (phase 20): 64
# frames of 4 objects, 256 samples, 32 windows of 8 or 8 batches of 32
KEY_FRAMES = 64
# one stage-1 Trainer epoch through the kernels vs through the plain
# versions (each window starting from one state): per-sample loss,
# relative; PoseNet's parameters after each window's Adam step, relative L2
# over the whole network (a tensor alone can be far off where it starts at
# zero, as BatchNorm's shifts do, and Adam turns a near-zero gradient's
# f32 noise into a step of either sign)
EPOCH_TOL = {"loss": 1e-4, "param_l2": 1e-3}
# a fused window vs the same samples' per-sample steps: losses and each
# gradient tensor in relative L2. One computation on other tensors: the
# window's samples are slices of a stacked canvas, so the library may pick
# other kernels and sum in another order (measured on an H100 80GB HBM3 at
# 700 W: up to 4.1e-6). The same loop run twice must be bit-equal: the
# train step is deterministic (the choose gather's fixed-order backward,
# the PSP pooling and resize as products, cuDNN restricted to
# deterministic algorithms)
FUSED_TOL = 1e-5
# mixed precision: bf16 kernels vs their plain versions on one loss
# (bf16 activations), and bf16 compute vs the f32 trajectory
# (tests/test_train_eval.py:366-368)
MIXED_TOL = {"kernel_vs_plain": 2e-2, "vs_f32": 0.05}
# two runs of this script before the train step was made deterministic,
# on an H100 80GB HBM3 at 700 W, printed beside this run's: the stage-1
# step at batch 32 (ms), the fused window of 8 (ms), the mixed bf16 step at
# batch 32 (ms)
BEFORE_MS = {"stage1": (138.307, 140.376), "fused_window": (405.355, 292.313),
           "mixed": (102.586, 97.117)}

# eval at YCB width on held-out frames of the 21-object library: 8 frames
# of 4 objects (32 samples), per-crop (batch 1 at each crop) and batched
# (batch 16 on a canvas of max(240, largest crop)), f32 and bf16
EVAL_FRAMES, EVAL_BATCH, EVAL_CANVAS = 8, 16, 240

# frame serving at YCB width and tools/serve.py's defaults: K object slots
# (tools/bench_serving.py:27), F frames a run_frames call (serve --batch 8),
# the 240 px canvas on 480 x 640 frames, 4 refine iterations; make_scene
# frames of K objects with 500-point meshes
SERVE_K, SERVE_F, SERVE_CANVAS, SERVE_ITERS = 5, 8, 240, 4
SERVE_POINTS, SERVE_MESH = NUM_POINTS, 500

DEVICE = "cuda"

SOURCES = {"mlp_head": ("plr2_tpu_torch/csrc/mlp_head.cu",
                        "plr2_tpu/ops/pallas_fusion.py:55"),
           "upconv3x3_prelu": ("plr2_tpu_torch/csrc/upconv.cu",
                               "plr2_tpu/ops/pallas_upsample.py:255")}
KNN_SOURCES = {"nn_match": "plr2_tpu/ops/pallas_knn.py:121",
               "nn_argmin": "plr2_tpu/ops/pallas_knn.py:66",
               "nn_match_mxu": "plr2_tpu/ops/pallas_knn.py:197"}
QUANT_SOURCE = ("plr2_tpu_torch/csrc/quant.cu", "plr2_tpu/ops/pallas_quant.py:117")
# the choose gather's deterministic backward: a repair kernel, not the port
# of a pallas_call (JAX's backward is an XLA one-hot product, gather.py:34)
GATHER_SOURCE = ("plr2_tpu_torch/csrc/gather.cu", "plr2_tpu/ops/gather.py:34")
KERNEL_NAMES = (*SOURCES, *KNN_SOURCES, "quantized_mlp_head",
                "gather_rows_backward")
# the bf16 tensor-core kernels, by a substring of their SASS function names
TC_KERNELS = {"mlp_head": "mlp_head_wgmma_kernel",
              "upconv3x3_prelu": "upconv_wgmma_kernel"}
# the f32 FP32-core kernels: FFMA only, no tensor-core instruction (TF32
# would run as HMMA or HGMMA), in every template instantiation
F32_KERNELS = {"mlp_head": "head_sgemm_kernel",
               "upconv3x3_prelu": "upconv_sgemm_kernel"}
# the int8 ladder: s8 wgmma (IGMMA) and no mma.sync (IMMA) in both
# instantiations (nearest and stochastic rounding); the knn kernels: FP32
# cores only (no HMMA, HGMMA or IGMMA)
INT8_KERNEL = "qmlp_wgmma_kernel"
KNN_KERNELS = ("nn_kernel", "nn_mxu_kernel")
SASS_OPS = ("FFMA", "HMMA", "HGMMA", "IMMA", "IGMMA")
# ragged shapes for the f32 and bf16 kernels: head (rows, widths) and
# decoder (batch, h, w, Cin, Cout); none fills every tile
RAGGED_HEADS = [(rows, HEAD_WIDTHS + (NUM_OBJ * od,)) for rows in (977, 8000)
                for od in HEAD_OUT.values()] + [(977, (200, 72, 40, 24, 5))]
RAGGED_STAGES = [(1, 5, 7, 64, 24), (3, 21, 13, 1024, 256),
                 (3, 5, 7, 1024, 24), (1, 21, 13, 64, 256)]
# f32 only (the bf16 kernel needs Cin % 8 == 0): Cin not a multiple of 4
# (the footprint's 4-byte copies) and Cout not a multiple of 4 (padded
# weight rows, scalar stores)
F32_STAGES = [(2, 5, 7, 6, 10), (1, 9, 6, 37, 130)]
# and a head whose x rows are not 16 bytes (C = 202: scalar loads of A)
F32_HEADS = [(977, (202, 40, 24, 12, 5))]
PATH_NAMES = {"f32": "estimate_f32", "bf16": "estimate_bf16"}
# the port's kernels in an f32 training replay's profile (by a substring of
# their names): the heads, the decoder, the ADD-S match, the gather's
# backward
GRAPH_KERNELS = ("head_sgemm_kernel", "upconv_sgemm_kernel", "nn_kernel<",
                 "gather_bwd_kernel")
# the autograd Functions around the kernels whose backward is plain PyTorch
BACKWARD_FUNCTIONS = ("_MLPHeadBackward", "_UpConvBackward")


def counts(**launched):
    """The launch counts a path should show: `launched`, every other kernel 0."""
    return {name: launched.get(name, 0) for name in KERNEL_NAMES}


def phase(name):
    def deco(fn):
        def run(*a, **k):
            print(f"== phase {name}", flush=True)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            print(f"== phase {name} done in {time.perf_counter() - t0:.2f} s",
                  flush=True)
            return out
        return run
    return deco


def import_port():
    if not (ROOT / "plr2_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"plr2_tpu_torch not found beside {__file__}: run "
                         "chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import plr2_tpu_torch  # noqa: F401


@phase("device")
def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    # f32 products and convolutions in full f32 (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"card: {smi}")
    return smi


@phase("build")
def build_phase():
    from plr2_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.lib()
    wall = time.perf_counter() - t0
    print(f"kernel library {path}: {'built' if log is not None else 'reused'}"
          f", wall {wall:.2f} s")
    for line in (log or "").splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "C7515" in line):
            print("  ptxas:", line.strip())
    sass = count_sass(path, _build.find_nvcc())
    bad = []
    for name, sub in TC_KERNELS.items():
        n = min((c["HGMMA"] for f, c in sass.items() if sub in f), default=0)
        print(f"  SASS: {n} HGMMA instructions in {name} (bf16 {sub}; "
              f"must be > 0) {'ok' if n else 'FAIL'}")
        bad += [] if n else [f"{name} bf16 has no HGMMA"]
    for name, sub in F32_KERNELS.items():
        fns = {f: c for f, c in sass.items() if sub in f}
        for f, c in sorted(fns.items()):
            ok = c["FFMA"] > 0 and c["HMMA"] == 0 and c["HGMMA"] == 0
            print(f"  SASS: {c['FFMA']} FFMA, {c['HMMA']} HMMA, {c['HGMMA']} HGMMA "
                  f"in f32 {f[:90]} (FFMA > 0, no tensor-core instruction) "
                  f"{'ok' if ok else 'FAIL'}")
            bad += [] if ok else [f"{name} f32 {f}: {c}"]
        bad += [] if fns else [f"no f32 {sub} in the library"]
    fns = {f: c for f, c in sass.items() if INT8_KERNEL in f}
    for f, c in sorted(fns.items()):
        ok = c["IGMMA"] > 0 and c["IMMA"] == 0
        print(f"  SASS: {c['IGMMA']} IGMMA, {c['IMMA']} IMMA in int8 {f[:90]} "
              f"(IGMMA > 0, no mma.sync) {'ok' if ok else 'FAIL'}")
        bad += [] if ok else [f"int8 {f}: {c}"]
    bad += [] if len(fns) == 2 else [f"{len(fns)} int8 {INT8_KERNEL} in the library, not 2"]
    for sub in KNN_KERNELS:
        fns = {f: c for f, c in sass.items() if sub in f}
        for f, c in sorted(fns.items()):
            tc = c["HMMA"] + c["HGMMA"] + c["IGMMA"] + c["IMMA"]
            print(f"  SASS: {c['FFMA']} FFMA, {tc} tensor-core instructions in "
                  f"knn {f[:90]} (must be 0) {'ok' if tc == 0 else 'FAIL'}")
            bad += [] if tc == 0 else [f"knn {f}: {c}"]
        bad += [] if fns else [f"no knn {sub} in the library"]
    if bad:
        raise AssertionError(f"SASS check failed: {bad}")
    return wall


def count_sass(lib_path, nvcc):
    """FFMA, HMMA, HGMMA, IMMA and IGMMA instructions of each function in
    the library's SASS (cuobjdump, beside nvcc), by mangled function name."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    per_fn, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            per_fn[fn] = {op: 0 for op in SASS_OPS}
        elif fn is not None:
            for op in per_fn[fn]:
                if f" {op}." in line or f" {op} " in line:
                    per_fn[fn][op] += 1
    return per_fn


def _rand(shape, gen, scale=1.0, dtype=None):
    t = torch.randn(shape, generator=gen) * scale
    return t.to(device=DEVICE, dtype=dtype)


def stage_inputs(name, dtype, gen, batch=None):
    h, w, cin, cout = STAGES[name]
    batch = batch or BATCH
    x = _rand((batch, h, w, cin), gen, 1.0, dtype)
    wk = _rand((3, 3, cin, cout), gen, (9 * cin) ** -0.5, dtype)
    bias = _rand((cout,), gen, 0.1, dtype)
    alpha = torch.full((1,), 0.25, device=DEVICE, dtype=dtype)
    return x, wk, bias, alpha


def head_inputs(tag, dtype, gen, batch=None, points=NUM_POINTS, objects=NUM_OBJ):
    rows = (batch or BATCH) * points
    widths = HEAD_WIDTHS + (objects * HEAD_OUT[tag],)
    x = _rand((rows, widths[0]), gen, 1.0, dtype)
    params = [(_rand((o, i), gen, i ** -0.5, dtype), _rand((o,), gen, 0.1, dtype))
              for i, o in zip(widths[:-1], widths[1:])]
    return x, params


def compare(what, got, ref, tol):
    atol, rtol = tol
    g, r = got.float(), ref.float()
    if g.shape != r.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} != {tuple(r.shape)}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (g - r).abs()
    max_abs = float(err.max())
    max_rel = max_abs / max(float(r.abs().max()), 1e-30)
    worst = float((err - rtol * r.abs()).max())
    ok = worst <= atol
    print(f"  {what}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
          f"(tol |d| <= {atol:g} + {rtol:g}|ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return max_abs


@phase("kernels")
def kernels_phase():
    from plr2_tpu_torch.ops import mlp_head, upconv
    errs = {}
    gen = torch.Generator().manual_seed(1)
    # the f32 kernels pick their tiles by the grid's waves: batch 128 takes
    # other tiles than batch 8, so both are checked
    for dt_name, dtype, batch in (("f32", torch.float32, BATCH),
                                  ("bf16", torch.bfloat16, BATCH),
                                  ("f32", torch.float32, BATCH_BIG)):
        for name in STAGES:
            args = stage_inputs(name, dtype, gen, batch)
            got = upconv.upconv3x3_prelu(*args)
            torch.cuda.synchronize()
            ref = upconv.upconv3x3_prelu_plain(*args)
            e = compare(f"upconv3x3_prelu {name} {dt_name} "
                        f"{tuple(args[0].shape)}", got, ref, TOL[dt_name])
            errs[("upconv3x3_prelu", dt_name)] = max(
                errs.get(("upconv3x3_prelu", dt_name), 0.0), e)
            del args, got, ref
        for tag in HEAD_OUT:
            x, params = head_inputs(tag, dtype, gen, batch)
            got = mlp_head.mlp_head(x, params)
            torch.cuda.synchronize()
            ref = mlp_head.mlp_head_plain(x, params)
            e = compare(f"mlp_head {tag} {dt_name} {tuple(x.shape)}->"
                        f"{params[-1][0].shape[0]}", got, ref, TOL[dt_name])
            errs[("mlp_head", dt_name)] = max(
                errs.get(("mlp_head", dt_name), 0.0), e)
            del x, params, got, ref
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        heads = RAGGED_HEADS + (F32_HEADS if dtype == torch.float32 else [])
        for rows, widths in heads:
            x = _rand((rows, widths[0]), gen, 1.0, dtype)
            params = [(_rand((o, i), gen, i ** -0.5, dtype), _rand((o,), gen, 0.1, dtype))
                      for i, o in zip(widths[:-1], widths[1:])]
            got = mlp_head.mlp_head(x, params)
            torch.cuda.synchronize()
            e = compare(f"mlp_head ragged {dt_name} {rows} rows {widths}", got,
                        mlp_head.mlp_head_plain(x, params), TOL[dt_name])
            errs[("mlp_head", dt_name)] = max(errs[("mlp_head", dt_name)], e)
        stages = RAGGED_STAGES + (F32_STAGES if dtype == torch.float32 else [])
        for b, h, w, cin, cout in stages:
            x = _rand((b, h, w, cin), gen, 1.0, dtype)
            args = (x, _rand((3, 3, cin, cout), gen, (9 * cin) ** -0.5, dtype),
                    _rand((cout,), gen, 0.1, dtype),
                    torch.full((1,), 0.25, device=DEVICE, dtype=dtype))
            got = upconv.upconv3x3_prelu(*args)
            torch.cuda.synchronize()
            e = compare(f"upconv3x3_prelu ragged {dt_name} {tuple(x.shape)}->{cout}",
                        got, upconv.upconv3x3_prelu_plain(*args), TOL[dt_name])
            errs[("upconv3x3_prelu", dt_name)] = max(
                errs[("upconv3x3_prelu", dt_name)], e)
    return errs


def knn_inputs(gen, m2, queries=None):
    """The stage-1 ADD-S match: NUM_SYM samples x (NUM_POINTS hypotheses x
    MESH_POINTS mesh points) queries against m2 targets, at mesh scale."""
    p = queries or NUM_POINTS * MESH_POINTS
    return _rand((NUM_SYM, p, 3), gen, 0.05), _rand((NUM_SYM, m2, 3), gen, 0.05)


def mxu_disagreements(q, got, ref):
    """Rows where nn_match_mxu and its twin matched different targets; each
    must be a near-tie of the twin's augmented d2 (see MXU_TIE)."""
    from plr2_tpu_torch.ops import knn
    rows = (got != ref).any(-1).nonzero(as_tuple=True)
    if not rows[0].numel():
        return 0, 0.0
    a, bk, bp = q[rows][:, None], got[rows][:, None], ref[rows][:, None]
    d2k = knn._d2_augmented(a, bk).flatten()
    d2p = knn._d2_augmented(a, bp).flatten()
    scale = (a * a).sum((-2, -1)) + (bp * bp).sum((-2, -1))
    return int(rows[0].numel()), float(((d2k - d2p).abs() / scale).max())


@phase("knn")
def knn_phase():
    from plr2_tpu_torch.ops import knn
    gen = torch.Generator().manual_seed(4)
    errs = {name: 0.0 for name in KNN_SOURCES}
    for m2 in (MESH_POINTS, MESH_LARGE):
        q, t = knn_inputs(gen, m2)
        shape = f"q {tuple(q.shape)} t {tuple(t.shape)}"
        idx = knn.nn_argmin(q, t)
        match = knn.nn_match(q, t)
        mxu = knn.nn_match_mxu(q, t)
        torch.cuda.synchronize()
        idx_p = knn.nn_argmin_plain(q, t)
        match_p = knn.nn_match_plain(q, t)
        mxu_p = knn.nn_match_mxu_plain(q, t)
        n_idx = int((idx != idx_p).sum())
        n_match = int((match != match_p).any(-1).sum())
        picked = torch.gather(t, 1, idx[..., None].expand(-1, -1, 3))
        n_diff, worst = mxu_disagreements(q, mxu, mxu_p)
        print(f"  nn_argmin {shape}: {n_idx} indices differ from the twin "
              f"(exact: must be 0) {'ok' if n_idx == 0 else 'FAIL'}")
        print(f"  nn_match {shape}: {n_match} rows differ from the twin "
              f"(exact: must be 0) {'ok' if n_match == 0 else 'FAIL'}")
        print(f"  nn_match_mxu {shape}: {n_diff} rows pick another target "
              f"than the twin; largest |d2 difference| / (|a|^2 + |b|^2) "
              f"{worst:.3e} (tol {MXU_TIE:g}) "
              f"{'ok' if worst <= MXU_TIE else 'FAIL'}")
        if n_idx or n_match or not torch.equal(match, picked):
            raise AssertionError(f"exact-difference knn kernels disagree "
                                 f"with their plain twins at {shape}")
        if worst > MXU_TIE:
            raise AssertionError(f"nn_match_mxu disagrees with its twin "
                                 f"beyond near-ties at {shape}")
        errs["nn_argmin"] = max(errs["nn_argmin"], float((idx - idx_p).abs().max()))
        errs["nn_match"] = max(errs["nn_match"], float((match - match_p).abs().max()))
        errs["nn_match_mxu"] = max(errs["nn_match_mxu"],
                                   float((mxu - mxu_p).abs().max()))
        del q, t, idx, match, mxu, idx_p, match_p, mxu_p, picked
    # duplicate targets: every odd target repeats the even one before it,
    # so each query ties exactly between two indices and the even one wins
    q, t = knn_inputs(gen, MESH_POINTS, queries=100_000)
    t[:, 1::2] = t[:, 0::2]
    idx = knn.nn_argmin(q, t)
    same = [torch.equal(f(q, t), g(q, t)) for f, g in (
        (knn.nn_argmin, knn.nn_argmin_plain), (knn.nn_match, knn.nn_match_plain),
        (knn.nn_match_mxu, knn.nn_match_mxu_plain))]
    odd = int((idx % 2).sum())
    print(f"  ties (duplicate targets) {tuple(q.shape)}: {odd} odd indices "
          f"(must be 0); kernels equal their twins: {same}")
    if odd or not all(same):
        raise AssertionError("knn kernels do not take the first index on ties")
    # the same at the large mesh, where the mxu kernel is held to MXU_TIE
    q, t = knn_inputs(gen, MESH_LARGE, queries=100_000)
    t[:, 1::2] = t[:, 0::2]
    idx = knn.nn_argmin(q, t)
    odd = int((idx % 2).sum())
    same = [torch.equal(f(q, t), g(q, t)) for f, g in (
        (knn.nn_argmin, knn.nn_argmin_plain), (knn.nn_match, knn.nn_match_plain))]
    n_diff, worst = mxu_disagreements(q, knn.nn_match_mxu(q, t),
                                      knn.nn_match_mxu_plain(q, t))
    print(f"  ties (duplicate targets) {tuple(q.shape)} x {MESH_LARGE}: {odd} odd "
          f"indices (must be 0); exact kernels equal their twins: {same}; "
          f"nn_match_mxu: {n_diff} rows differ, worst {worst:.3e} (tol {MXU_TIE:g})")
    if odd or not all(same) or worst > MXU_TIE:
        raise AssertionError("knn kernels do not take the first index on ties "
                             "at the large mesh")
    # distinct targets at exactly the same d2: a query at the origin and
    # the six unit points +-e_i (d2 = 1 in both forms, exactly) among far
    # points, two of them in one group of 8 and the rest later; the first
    # (index 13) must win
    far = _rand((NUM_SYM, 1029, 3), gen, 1.0)
    far = far / far.norm(dim=-1, keepdim=True) * 4.0
    unit = torch.cat([torch.eye(3, device=DEVICE), -torch.eye(3, device=DEVICE)])
    for k, m in zip((13, 14, 300, 301, 1024, 1028), unit):
        far[:, k] = m
    q0 = torch.zeros((NUM_SYM, 10_007, 3), device=DEVICE)
    got = [f(q0, far) for f in (knn.nn_match, knn.nn_match_mxu)]
    first = int((knn.nn_argmin(q0, far) != 13).sum())
    wrong = [int((g != unit[0]).any(-1).sum()) for g in got]
    print(f"  equal-d2 ties {tuple(q0.shape)} x 1029: nn_argmin misses index "
          f"13 on {first} rows, nn_match / nn_match_mxu on {wrong} (must be 0)")
    if first or any(wrong):
        raise AssertionError("knn kernels do not take the first of equal d2")
    # a ragged size: P not a multiple of a block's queries, M2 of no whole
    # group or chunk
    q, t = _rand((NUM_SYM, 10_007, 3), gen, 0.05), _rand((NUM_SYM, 1029, 3), gen, 0.05)
    same = [torch.equal(f(q, t), g(q, t)) for f, g in (
        (knn.nn_argmin, knn.nn_argmin_plain), (knn.nn_match, knn.nn_match_plain))]
    n_diff, worst = mxu_disagreements(q, knn.nn_match_mxu(q, t),
                                      knn.nn_match_mxu_plain(q, t))
    print(f"  ragged q {tuple(q.shape)} t {tuple(t.shape)}: exact kernels equal "
          f"their twins: {same}; nn_match_mxu {n_diff} rows differ, worst "
          f"{worst:.3e} (tol {MXU_TIE:g})")
    if not all(same) or worst > MXU_TIE:
        raise AssertionError("knn kernels disagree with their twins at a ragged size")
    return errs


@phase("gradients")
def grad_phase():
    """The kernels' autograd Functions against autograd of the plain
    versions, f32, at the training shapes; the cotangent is scaled by
    1/sqrt(rows) so gradients are O(1), under the f32 kernel tolerance."""
    from plr2_tpu_torch.ops import mlp_head, upconv
    gen = torch.Generator().manual_seed(5)
    tol = TOL["f32"]

    def both(fn_k, fn_p, args, cot):
        leaves = [[a.clone().requires_grad_(True) for a in args] for _ in range(2)]
        for fn, ls in ((fn_k, leaves[0]), (fn_p, leaves[1])):
            (fn(*ls) * cot).sum().backward()
        return [(k.grad, p.grad) for k, p in zip(*leaves)]

    for name in STAGES:
        args = stage_inputs(name, torch.float32, gen, TRAIN_BATCH)
        b, h, w, _ = args[0].shape
        cot = _rand((b, 2 * h, 2 * w, args[1].shape[3]), gen,
                    (b * 4 * h * w) ** -0.5)
        for arg, (gk, gp) in zip(("x", "w", "bias", "alpha"), both(
                upconv.upconv3x3_prelu, upconv.upconv3x3_prelu_plain, args, cot)):
            compare(f"d{arg} upconv3x3_prelu {name} f32 {tuple(args[0].shape)}",
                    gk, gp, tol)
    for tag in HEAD_OUT:
        x, params = head_inputs(tag, torch.float32, gen, TRAIN_BATCH)
        flat = [x] + [t for wb in params for t in wb]
        cot = _rand((x.shape[0], params[-1][0].shape[0]), gen, x.shape[0] ** -0.5)

        def unflat(fn):
            return lambda x, *f: fn(x, list(zip(f[0::2], f[1::2])))
        grads = both(unflat(mlp_head.mlp_head), unflat(mlp_head.mlp_head_plain),
                     flat, cot)
        for arg, (gk, gp) in zip(["x"] + [f"{n}{i}" for i in range(1, 5)
                                          for n in ("w", "b")], grads):
            compare(f"d{arg} mlp_head {tag} f32 {tuple(x.shape)}", gk, gp, tol)


def train_batch(seed=6):
    """A seeded batch at the slice's shape: `target` is `model_points` under
    a random rigid pose per sample, so it is not a copy of it."""
    from plr2_tpu_torch.geometry import quat_to_matrix_df
    g = torch.Generator().manual_seed(seed)
    b = TRAIN_BATCH
    img = torch.randn((b, CROP, CROP, 3), generator=g)
    points = torch.randn((b, NUM_POINTS, 3), generator=g) * 0.1
    choose = torch.randint(0, CROP * CROP, (b, NUM_POINTS), generator=g)
    mp = torch.randn((b, MESH_POINTS, 3), generator=g) * 0.05
    q = torch.randn((b, 4), generator=g)
    rot = quat_to_matrix_df(q / q.norm(dim=-1, keepdim=True))
    target = (mp[..., :, None, :] * rot[:, None]).sum(-1) \
        + torch.randn((b, 1, 3), generator=g) * 0.05
    batch = dict(img=img, points=points, choose=choose, target=target,
                 model_points=mp, idx=torch.arange(b) % NUM_OBJ)
    # the host object ids: the loss picks its ADD-S branch from them
    return {**{k: v.to(DEVICE) for k, v in batch.items()},
            "obj": tuple(i % NUM_OBJ for i in range(b))}


def compare_steps(what, mod_k, mod_p, step_k, step_p, met_k, met_p, before):
    """Kernel step vs plain step from the same state: loss, dis, gradients
    (from Adam's first moment), updated parameters (each within what Adam
    makes of gradients that differ as measured) and BN running stats."""
    worst = {}
    for key in ("loss", "dis"):
        k, p = float(met_k[key]), float(met_p[key])
        worst[key] = abs(k - p) / max(abs(p), 1e-30)
    params_p = dict(mod_p.named_parameters())
    grad_err, max_param, bad = 0.0, 0.0, []
    for name, pk in mod_k.named_parameters():
        pp = params_p[name]
        gk = step_k.optimizer.state[pk]["exp_avg"].double() / 0.1
        gp = step_p.optimizer.state[pp]["exp_avg"].double() / 0.1
        err = gk - gp
        rel = float(err.norm() / gp.norm().clamp(min=1e-300))
        grad_err = max(grad_err, rel)
        if rel > STEP_TOL["grad_l2"]:
            bad.append((name, "grad", rel))
        d = float(err.abs().max())
        margin = (gp.abs() - d).clamp(min=0)
        bound = torch.where(margin > 0, LR * d / margin.clamp(min=1e-300),
                            torch.full_like(margin, 2 * LR)).clamp(max=2 * LR)
        b0 = before[name].double()
        slack = 1e-7 + 2.4e-7 * b0.abs()
        diff = ((pk.detach().double() - b0) - (pp.detach().double() - b0)).abs()
        if bool((diff > bound + slack).any()):
            bad.append((name, "update", float((diff - bound).max())))
        max_param = max(max_param, float(diff.max()))
    max_bn = 0.0
    state_p = mod_p.state_dict()
    atol, rtol = STEP_TOL["bn"]
    for name, tk in mod_k.state_dict().items():
        if "running" in name:
            tp = state_p[name]
            dev = float(((tk - tp).abs() - rtol * tp.abs()).max())
            max_bn = max(max_bn, float((tk - tp).abs().max()))
            if dev > atol:
                bad.append((name, "bn", dev))
    ok = (not bad and worst["loss"] <= STEP_TOL["loss"]
          and worst["dis"] <= STEP_TOL["loss"])
    print(f"  {what} kernels vs plain: loss {float(met_k['loss']):.6f} / "
          f"{float(met_p['loss']):.6f} (rel {worst['loss']:.2e}), dis "
          f"{float(met_k['dis']):.6f} / {float(met_p['dis']):.6f} (rel "
          f"{worst['dis']:.2e}), tol {STEP_TOL['loss']:g}")
    print(f"    gradients: largest relative L2 error {grad_err:.2e} (tol "
          f"{STEP_TOL['grad_l2']:g}); largest updated-parameter difference {max_param:.3e} (lr {LR:g}; "
          f"bound: Adam's step for the measured gradient gap); largest BN "
          f"running-stat difference {max_bn:.3e} (tol {atol:g} + {rtol:g}|ref|) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel step disagrees with the plain "
                             f"step: {bad[:5]}")
    return {"max_param_diff": max_param, "max_bn_diff": max_bn,
            "grad_l2": grad_err, **worst}


def run_step(step, batch, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    met = step(batch, gen)
    torch.cuda.synchronize()
    return met


@phase("train")
def train_phase():
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    from plr2_tpu_torch.parallel import make_train_step
    kern = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0)
    plain = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, use_kernels=False,
                                device=DEVICE, seed=0)
    batch = train_batch()
    print(f"  batch {TRAIN_BATCH}, {NUM_SYM} symmetric samples: the stage-1 "
          f"ADD-S match is {NUM_SYM} x {NUM_POINTS * MESH_POINTS} queries "
          f"against {MESH_POINTS} targets")
    launches, result = {}, {}
    for stage, iters, expect in (
            ("train_stage1", 0, counts(mlp_head=3, upconv3x3_prelu=3, nn_match=1,
                                       gather_rows_backward=1)),
            ("train_refine", ITERS, counts(mlp_head=3, upconv3x3_prelu=3,
                                           nn_match=ITERS))):
        mod_k, mod_p = ((kern.refiner, plain.refiner) if iters
                        else (kern.posenet, plain.posenet))
        if iters:  # the same state: PoseNet as the kernel run left it
            plain.posenet.load_state_dict(kern.posenet.state_dict())
        before = {k: v.detach().clone() for k, v in mod_k.named_parameters()}
        step_k = make_train_step(kern, SYM_LIST, W, LR, refine_iterations=iters,
                                 sym_slots=NUM_SYM)
        step_p = make_train_step(plain, SYM_LIST, W, LR, refine_iterations=iters,
                                 sym_slots=NUM_SYM)
        reset_launch_counts()
        met_k = run_step(step_k, batch, seed=11)
        seen = launch_counts()
        print(f"  launches in one {stage} step: {seen}")
        if seen != expect:
            raise AssertionError(f"{stage}: expected launches {expect}, got {seen}")
        met_p = run_step(step_p, batch, seed=11)
        if launch_counts() != seen:
            raise AssertionError(f"{stage}: the plain step launched a kernel")
        launches[stage] = seen
        result[stage] = compare_steps(stage, mod_k, mod_p, step_k, step_p,
                                      met_k, met_p, before)
        result[stage]["step"] = step_k
    del plain
    torch.cuda.empty_cache()
    losses = [float(run_step(result["train_stage1"]["step"], batch, seed=12 + i)["loss"])
              for i in range(3)]
    print(f"  3 more stage-1 steps: losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite stage-1 loss")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 was switched on")
    return kern, batch, launches, result


def step_ms(step, batch, reps):
    run_step(step, batch, seed=20)
    t0 = time.perf_counter()
    for i in range(reps):
        step(batch, torch.Generator(device=DEVICE).manual_seed(21 + i))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def profile_step(step, batch):
    """The ten CUDA kernels of one stage-1 step that take the most device
    time, and the device's busy share of its wall time."""
    from torch.profiler import ProfilerActivity, profile
    run_step(step, batch, seed=30)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step(step, batch, seed=31)
        wall = (time.perf_counter() - t0) * 1e3
    total = top_device_kernels(prof, wall, "one stage-1 step")
    return wall, total


def main_inputs(batch, seed=2):
    g = torch.Generator().manual_seed(seed)
    img = torch.randn((batch, CROP, CROP, 3), generator=g)
    cloud = torch.randn((batch, NUM_POINTS, 3), generator=g) * 0.1
    choose = torch.randint(0, CROP * CROP, (batch, NUM_POINTS), generator=g)
    obj = torch.arange(batch) % NUM_OBJ
    return [t.to(DEVICE) for t in (img, cloud, choose, obj)]


def check_pose(dt_name, est):
    q, t = est.quat, est.trans
    if not (torch.isfinite(q).all() and torch.isfinite(t).all()
            and torch.isfinite(est.confidence).all()):
        raise AssertionError(f"estimate {dt_name}: non-finite output")
    if q.shape != (BATCH, 4) or t.shape != (BATCH, 3):
        raise AssertionError(f"estimate {dt_name}: shapes {q.shape} {t.shape}")
    norm_err = float((q.float().norm(dim=-1) - 1).abs().max())
    if norm_err > QUAT_NORM_TOL[dt_name]:
        raise AssertionError(f"estimate {dt_name}: |q| off 1 by {norm_err}")
    print(f"  estimate {dt_name}: finite, max ||q|-1| {norm_err:.2e}")


@phase("main path")
def main_path_phase():
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    kern = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0)
    plain = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, use_kernels=False,
                                device=DEVICE, seed=0)
    inputs = main_inputs(BATCH)
    launches = {}
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if dtype != torch.float32:
            kern.cast(dtype)
            plain.cast(dtype)
        reset_launch_counts()
        est = kern.estimate(*inputs, refine_iterations=ITERS)
        torch.cuda.synchronize()
        seen = launch_counts()
        print(f"  launches in one estimate ({dt_name}): {seen}")
        if seen != counts(mlp_head=3, upconv3x3_prelu=3):
            raise AssertionError("expected 3 mlp_head + 3 upconv3x3_prelu "
                                 f"launches per PoseNet forward, got {seen}")
        launches[dt_name] = seen
        check_pose(dt_name, est)
        ref = plain.estimate(*inputs, refine_iterations=ITERS)
        if launch_counts() != seen:
            raise AssertionError("the plain pipeline launched a kernel")
        # which hypothesis each run picked, from the same PoseNet outputs
        with torch.no_grad():
            ck = kern.posenet(*inputs)[2][..., 0].float()
            cp = plain.posenet(*inputs)[2][..., 0].float()
        reset_launch_counts()
        ik, ip = ck.argmax(-1), cp.argmax(-1)
        same = ik == ip
        rows = torch.arange(BATCH, device=DEVICE)
        gap = float((ck[rows, ik] - ck[rows, ip]).abs().max())
        if gap > CONF_TIE[dt_name]:
            raise AssertionError(f"estimate {dt_name}: runs picked hypotheses "
                                 f"whose confidences differ by {gap}")
        dq = float((est.quat.float() - ref.quat.float())[same].abs().max()) \
            if same.any() else 0.0
        dtr = float((est.trans - ref.trans)[same].abs().max()) if same.any() else 0.0
        ok = dq <= POSE_TOL[dt_name] and dtr <= POSE_TOL[dt_name]
        print(f"  estimate {dt_name} kernels vs plain: {int(same.sum())}/{BATCH} "
              f"frames pick the same hypothesis (others within {gap:.2e} "
              f"confidence); max |dq| {dq:.3e} max |dt| {dtr:.3e} "
              f"(tol {POSE_TOL[dt_name]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"estimate {dt_name}: kernel pipeline "
                                 "disagrees with the plain-version pipeline")
        # the host-bound batch-8 estimate while the process is fresh (the
        # timing phase measures it again after the training phases)
        ms = time_ms(lambda: kern.estimate(*inputs, refine_iterations=ITERS), 10)
        print(f"  estimate {dt_name} batch {BATCH}, fresh process: {ms:.3f} ms "
              f"= {BATCH * 1e3 / ms:.1f} frames/s")
    del plain
    torch.cuda.empty_cache()
    return kern, launches


def time_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def upconv_library(x, w, bias, alpha):
    """The decoder stage as PyTorch library calls in the working dtype
    (cuDNN): a yardstick of speed only, never on the port's path."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                      align_corners=False)
    y = F.conv2d(y, w.permute(3, 2, 0, 1), bias, padding=1)
    return F.prelu(y, alpha.reshape(1))


@phase("timing")
def timing_phase(kern, launches, errs):
    frames, tables = {}, {}
    gen = torch.Generator().manual_seed(3)
    for dt_name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        kern.cast(dtype)
        for batch, reps in ((BATCH, 10), (BATCH_BIG, 3)):
            inputs = main_inputs(batch)
            ms = time_ms(lambda: kern.estimate(*inputs, refine_iterations=ITERS),
                         reps, warmup=1)
            del inputs
            frames[f"{dt_name}_b{batch}"] = batch * 1e3 / ms
            print(f"  estimate {dt_name} batch {batch}: {ms:.3f} ms "
                  f"= {batch * 1e3 / ms:.1f} frames/s")
            t = tables[(dt_name, batch)] = kernel_table(
                dt_name, dtype, gen, batch, with_plain=batch == BATCH)
            kms = {k: v["ms"] for k, v in t.items()}
            print(f"    kernels of its PoseNet forward: mlp_head x3 "
                  f"{kms['mlp_head']:.3f} ms + upconv3x3_prelu x3 "
                  f"{kms['upconv3x3_prelu']:.3f} ms = "
                  f"{100 * sum(kms.values()) / ms:.1f}% of the estimate")

    entries = []
    for dt_name in ("f32", "bf16"):
        paths = (("f32", "train_stage1", "train_refine", "trainer", "fused",
                  "fused_graphs", "eval_f32", "serve_f32") if dt_name == "f32"
                 else ("bf16", "mixed", "mixed_graphs", "eval_bf16", "serve_bf16"))
        for kname, t in tables[(dt_name, BATCH)].items():
            by_path = {PATH_NAMES.get(pth, pth): launches[pth][kname]
                       for pth in paths}
            bound, bound_by = bound_of(t, dt_name)
            entry = {
                "name": f"{kname}_{dt_name}", "route": "cuda",
                "source": SOURCES[kname][0], "replaces": SOURCES[kname][1],
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": errs[(kname, dt_name)],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": t["library_ms"]}
            b = tables[(dt_name, BATCH_BIG)][kname]
            entry.update({"ms_b128": b["ms"], "library_ms_b128": b["library_ms"],
                          "bound_ms_b128": bound_of(b, dt_name)[0]})
            entries.append(entry)
    profile = {"f32": profile_estimate(kern, BATCH_BIG)}  # kern is f32 here
    kern.cast(torch.bfloat16)
    profile["bf16"] = profile_estimate(kern, BATCH_BIG)
    return frames, entries, profile


def bound_of(t, dt_name):
    """The H100's least time for a kernel's work: max(operations / peak,
    bytes / HBM rate), and which of the two it is."""
    ops_ms = t["flops"] / PEAK_FLOPS[dt_name] * 1e3
    bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def kernel_table(dt_name, dtype, gen, batch, with_plain):
    """Per PoseNet forward at `batch` (3 decoder stages, 3 heads): kernel,
    plain-version (if `with_plain`) and library ms, FLOP and bytes."""
    from plr2_tpu_torch.ops import mlp_head, upconv
    item = torch.empty((), dtype=dtype).element_size()
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "flops": 0, "bytes": 0} for k in SOURCES}
    for name, (h, w, cin, cout) in STAGES.items():
        args = stage_inputs(name, dtype, gen, batch)
        t = tot["upconv3x3_prelu"]
        k = time_ms(lambda: upconv.upconv3x3_prelu(*args), 10)
        p = time_ms(lambda: upconv.upconv3x3_prelu_plain(*args), 5) if with_plain else 0.0
        lib = time_ms(lambda: upconv_library(*args), 10)
        b = args[0].shape[0]
        fl = upconv.flops(b, h, w, cin, cout)
        by = item * (b * h * w * cin + 9 * cin * cout + cout + 1
                     + b * 4 * h * w * cout)
        print(f"  upconv3x3_prelu {name} {dt_name} batch {batch}: kernel {k:.3f} ms "
              f"({fl / k / 1e9:.1f} TFLOP/s), "
              + (f"plain {p:.3f} ms, " if with_plain else "")
              + f"library {lib:.3f} ms")
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                       ("flops", fl), ("bytes", by)):
            t[key] += v
        del args
    for tag, od in HEAD_OUT.items():
        x, params = head_inputs(tag, dtype, gen, batch)
        rows = x.shape[0]
        widths = HEAD_WIDTHS + (NUM_OBJ * od,)
        t = tot["mlp_head"]
        k = time_ms(lambda: mlp_head.mlp_head(x, params), 10)
        p = time_ms(lambda: mlp_head.mlp_head_plain(x, params), 5) if with_plain else 0.0

        def library():
            h = x
            for i, (wt, b) in enumerate(params):
                h = torch.addmm(b, h, wt.t())
                if i < 3:
                    h = torch.relu(h)
            return h
        lib = time_ms(library, 10)
        fl = mlp_head.flops(rows, widths)
        by = item * (rows * widths[0] + rows * widths[-1] + sum(
            wt.numel() + b.numel() for wt, b in params))
        print(f"  mlp_head {tag} {dt_name} batch {batch}: kernel {k:.3f} ms "
              f"({fl / k / 1e9:.1f} TFLOP/s), "
              + (f"plain {p:.3f} ms, " if with_plain else "")
              + f"library {lib:.3f} ms")
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                       ("flops", fl), ("bytes", by)):
            t[key] += v
        del x, params
    for kname, t in tot.items():
        bound, bound_by = bound_of(t, dt_name)
        print(f"  {kname} {dt_name} batch {batch}, per forward: kernel "
              f"{t['ms']:.3f} ms, library {t['library_ms']:.3f} ms, bound "
              f"{bound:.4f} ms ({bound_by})")
    torch.cuda.empty_cache()
    return tot


def top_device_kernels(prof, wall, what, n=10):
    """Print the `n` CUDA kernels with the most device time in a profile
    (device-side events only: adding the host-side ops would count each
    kernel twice) and the device's busy share of `wall`."""
    from torch.autograd import DeviceType
    kernels = [(e.self_device_time_total / 1e3, e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(ms for ms, _ in kernels)
    print(f"  profiler, {what}: wall {wall:.3f} ms, device busy "
          f"{total:.3f} ms ({100 * total / wall:.1f}% of the wall time, idle "
          f"{100 - 100 * total / wall:.1f}%), "
          f"{sum(e.count for _, e in kernels)} kernel launches")
    if not kernels:
        print("  the profiler recorded no device time: the times above "
              "(CUDA events or host clock around synchronised work) stand alone")
    for ms, e in sorted(kernels, key=lambda v: -v[0])[:n]:
        print(f"    {ms:9.3f} ms {100 * ms / max(total, 1e-12):5.1f}%  x{e.count:<5d} "
              f"{e.key[:100]}")
    return total


def profile_estimate(kern, batch):
    """The CUDA kernels of one estimate at `batch` in the pipeline's dtype
    that take the most device time, and the device's idle share of its
    wall time."""
    from torch.profiler import ProfilerActivity, profile
    inputs = main_inputs(batch)
    kern.estimate(*inputs, refine_iterations=ITERS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kern.estimate(*inputs, refine_iterations=ITERS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dt_name = "bf16" if kern.dtype == torch.bfloat16 else "f32"
    busy = top_device_kernels(prof, wall, f"one {dt_name} estimate at batch {batch}", 12)
    del inputs
    torch.cuda.empty_cache()
    return {"wall_ms": wall, "device_ms": busy}


@phase("train timing")
def train_timing_phase(kern, batch, result, launches, errs):
    """Train-step ms and samples/s of both stages (host clock around
    synchronised steps), a profiler table of a stage-1 step, and the knn
    kernels at the stage-1 shape beside their twins, a PyTorch library
    yardstick (torch.cdist + argmin + gather, timed here only) and the
    H100's bound."""
    from plr2_tpu_torch.ops import knn
    from plr2_tpu_torch.parallel import make_train_step
    times = {}
    refine = make_train_step(kern, SYM_LIST, W, LR, refine_iterations=ITERS)
    for stage, step in (("stage1", result["train_stage1"]["step"]),
                        ("refine", refine)):
        ms = step_ms(step, batch, 5)
        times[f"{stage}_ms"] = ms
        times[f"{stage}_samples_per_s"] = TRAIN_BATCH * 1e3 / ms
        print(f"  {stage} step f32 batch {TRAIN_BATCH}: {ms:.3f} ms = "
              f"{TRAIN_BATCH * 1e3 / ms:.1f} samples/s"
              + (f" (before the determinism repair: {BEFORE_MS['stage1']} ms)"
                 if stage == "stage1" else ""))
    times["profile_wall_ms"], times["profile_device_ms"] = profile_step(
        result["train_stage1"]["step"], batch)

    gen = torch.Generator().manual_seed(7)
    q, t = knn_inputs(gen, MESH_POINTS)
    s, p, m2 = q.shape[0], q.shape[1], t.shape[1]

    def library_index():
        return torch.cdist(q, t).argmin(-1)

    def library_match():
        return torch.gather(t, 1, library_index()[..., None].expand(-1, -1, 3))
    entries = []
    for name, fn, plain, lib, out_bytes in (
            ("nn_match", knn.nn_match, knn.nn_match_plain, library_match, 12),
            ("nn_argmin", knn.nn_argmin, knn.nn_argmin_plain, library_index, 8),
            ("nn_match_mxu", knn.nn_match_mxu, knn.nn_match_mxu_plain,
             library_match, 12)):
        k = time_ms(lambda: fn(q, t), 10)
        pl = time_ms(lambda: plain(q, t), 3, warmup=1)
        lb = time_ms(lib, 3, warmup=1)
        slots = knn.issue_slots(s * p, m2, augmented=name == "nn_match_mxu")
        ops_ms = slots / knn.FP32_SLOTS_PER_S * 1e3
        bytes_ms = (12 * s * p + 12 * s * m2 + out_bytes * s * p) / HBM_BYTES_PER_S * 1e3
        by_path = {pth: launches[pth][name] for pth in (
            "train_stage1", "train_refine", "trainer", "fused", "mixed",
            "fused_graphs", "mixed_graphs")}
        print(f"  {name} f32 q {tuple(q.shape)} t {tuple(t.shape)}: kernel "
              f"{k:.3f} ms ({slots / k / 1e9:.1f} T FP32 slots/s at "
              f"{slots // (s * p * m2)} a pair), plain {pl:.3f} ms, library "
              f"{lb:.3f} ms, bound {max(ops_ms, bytes_ms):.3f} ms "
              f"({100 * max(ops_ms, bytes_ms) / k:.0f}% of it reached)")
        entries.append({
            "name": name, "route": "cuda",
            "source": "plr2_tpu_torch/csrc/knn.cu",
            "replaces": KNN_SOURCES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name], "ms": k, "plain_ms": pl,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lb,
            "bound_operations": f"FP32 issue slots, {slots // (s * p * m2)} a pair, "
                                f"at {knn.FP32_SLOTS_PER_S:.3g}/s"})
    return times, entries


# ---------------- the training entry point (Trainer, FusedTrainer,
# BatchTrainer in mixed precision) on the synthetic data path ----------------


def train_config(dtype="float32", **train):
    """YCB's width (21 objects, 1000 points, 500 mesh points, its symmetric
    objects) with the reference curriculum's w and lr."""
    from plr2_tpu_torch.config import (DatasetConfig, ModelConfig,
                                       PipelineConfig, TrainConfig)
    return PipelineConfig(
        dataset=DatasetConfig(name="ycb", num_points=NUM_POINTS,
                              num_objects=NUM_OBJ, num_mesh_points=MESH_POINTS,
                              num_mesh_points_large=MESH_LARGE,
                              sym_list=SYM_LIST, crop_size=CROP),
        model=ModelConfig(num_points=NUM_POINTS, num_objects=NUM_OBJ,
                          dtype=dtype),
        train=TrainConfig(**{"batch_size": WINDOW, "refine_iterations": ITERS,
                             "lr": LR, "w": W, **train}))


def scene_dataset(frames, seed):
    """Frames of the fixed 21-object library at 480 x 640 (tools/
    journey_config5.py's: symmetric library ids LIB_SYM_IDS)."""
    from plr2_tpu_torch.data import SyntheticSceneDataset
    from plr2_tpu_torch.data.synthetic import make_model_library
    models = make_model_library(NUM_OBJ, MESH_POINTS, sym_ids=LIB_SYM_IDS)
    return SyntheticSceneDataset(models, frames, objects_per_frame=PER_FRAME,
                                 num_points=NUM_POINTS, seed=seed)


def is_sym(ds, i):
    return ds.items[i]["obj"] - 1 in SYM_LIST


def crop_shapes(ds):
    """The (h, w) of every sample's border-list crop."""
    from plr2_tpu_torch.data import get_bbox_from_mask
    out = []
    for i in range(len(ds)):
        raw = ds.get_raw(i)
        rmin, rmax, cmin, cmax = get_bbox_from_mask(raw["mask"])
        out.append((rmax - rmin, cmax - cmin))
    return out


def recording_trainer(kind, cfg, pipe, forced=None):
    """A trainer that records its network's parameters after each window's
    optimizer step; with `forced` (another run's records) it then loads that
    run's parameters, so each window of two runs starts from one state."""
    tr = kind(cfg, pipe=pipe)
    tr.after_steps = []
    make = tr.stage_step

    def stage_step(state):
        step = make(state)
        apply = step.apply

        def recorded():
            apply()
            net = step.network
            tr.after_steps.append({n: p.detach().clone()
                                   for n, p in net.named_parameters()})
            k = len(tr.after_steps) - 1
            if forced is not None and k < len(forced):
                with torch.no_grad():
                    for n, p in net.named_parameters():
                        p.copy_(forced[k][n])
        step.apply = recorded
        return step
    tr.stage_step = stage_step
    return tr


def bn_state(net):
    return {k: v.clone() for k, v in net.state_dict().items()
            if "running" in k or "num_batches" in k}


def check_kernels_at(shapes, errs, gen, dt_name="f32", batch=1, match=True,
                     points=NUM_POINTS, objects=NUM_OBJ, mesh=MESH_POINTS):
    """Each kernel of a training path against its plain version at the
    shapes that path gives it: the three decoder stages of every (h, w)
    crop or canvas in `shapes` (non-square ones too), the heads at `batch`
    samples' rows (`points` a sample, `objects` classes), and (with
    `match`) the ADD-S match of `match` symmetric samples (True: one) of
    `points` x `mesh` queries against `mesh` targets."""
    from plr2_tpu_torch.ops import knn, mlp_head, upconv
    dtype = torch.float32 if dt_name == "f32" else torch.bfloat16
    for h, w in sorted(set(shapes)):
        for div, cin, cout in ((8, 1024, 256), (4, 256, 64), (2, 64, 64)):
            args = (_rand((batch, h // div, w // div, cin), gen, 1.0, dtype),
                    _rand((3, 3, cin, cout), gen, (9 * cin) ** -0.5, dtype),
                    _rand((cout,), gen, 0.1, dtype),
                    torch.full((1,), 0.25, device=DEVICE, dtype=dtype))
            got = upconv.upconv3x3_prelu(*args)
            torch.cuda.synchronize()
            e = compare(f"upconv3x3_prelu {dt_name} at {h}x{w} "
                        f"{tuple(args[0].shape)}->{cout}", got,
                        upconv.upconv3x3_prelu_plain(*args), TOL[dt_name])
            errs[("upconv3x3_prelu", dt_name)] = max(
                errs[("upconv3x3_prelu", dt_name)], e)
            del args, got
    for tag in HEAD_OUT:
        x, params = head_inputs(tag, dtype, gen, batch=batch, points=points,
                                objects=objects)
        got = mlp_head.mlp_head(x, params)
        torch.cuda.synchronize()
        e = compare(f"mlp_head {tag} {dt_name} {tuple(x.shape)}", got,
                    mlp_head.mlp_head_plain(x, params), TOL[dt_name])
        errs[("mlp_head", dt_name)] = max(errs[("mlp_head", dt_name)], e)
    if match:
        q = _rand((int(match), points * mesh, 3), gen, 0.05)
        t = _rand((int(match), mesh, 3), gen, 0.05)
        got, ref = knn.nn_match(q, t), knn.nn_match_plain(q, t)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError("nn_match at one sample's shape differs from its twin")
        print(f"  nn_match {int(match)} symmetric sample(s) q {tuple(q.shape)} t "
              f"{tuple(t.shape)}: equal to its twin ok")
    torch.cuda.empty_cache()


@phase("trainer")
def trainer_phase(errs):
    """Trainer.fit for 2 epochs on the library's frames (the margins fire the
    decay and refine switches after epoch 1), best / last checkpoints and
    their round trip, a stop mid-window, then one stage-1 epoch through the
    kernels and through the plain versions from one state and seed."""
    import tempfile
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    from plr2_tpu_torch.train import CheckpointManager, Trainer
    train_ds, test_ds = scene_dataset(TRAIN_FRAMES, 0), scene_dataset(TEST_FRAMES, 1)
    n_tr, n_te = len(train_ds), len(test_ds)
    s_tr = sum(is_sym(train_ds, i) for i in range(n_tr))
    s_te = sum(is_sym(test_ds, i) for i in range(n_te))
    crops = crop_shapes(train_ds) + crop_shapes(test_ds)
    print(f"  {n_tr} train / {n_te} test samples ({s_tr} / {s_te} symmetric), "
          f"crops {sorted(set(crops))}")
    cfg = train_config(decay_margin=1e9, refine_margin=1e9)
    tr = Trainer(cfg, device=DEVICE)
    state = tr.init_state()
    logs = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(tmp)
        reset_launch_counts()
        t0 = time.perf_counter()
        state = tr.fit(state, train_ds, test_ds, epochs=2, log_fn=logs.append,
                       checkpoint_fn=lambda s, d: ckpt.save(s, d),
                       save_last_fn=lambda s: ckpt.save(s, s.best_test, tag="last"))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        seen = launch_counts()
        for line in logs:
            print(f"  {line}")
        # per sample: one PoseNet forward (3 + 3 launches); the ADD-S match
        # once a symmetric sample in stage 1 and in its test epoch, and
        # once an iteration of every sample in the refine stage and in its
        # test epoch (refine_loss computes ADD-S on every row and selects,
        # as JAX's does); the gather's backward once a sample of the
        # stage-1 epoch (the refine stage runs PoseNet without gradients)
        fwd = 3 * 2 * (n_tr + n_te)
        expect = counts(mlp_head=fwd, upconv3x3_prelu=fwd,
                        nn_match=s_tr + s_te + (n_tr + n_te) * ITERS,
                        gather_rows_backward=n_tr)
        print(f"  launches in Trainer.fit (2 epochs, {fit_s:.2f} s): {seen}")
        if seen != expect:
            raise AssertionError(f"trainer: expected launches {expect}, got {seen}")
        if not (state.epoch == 2 and state.decay_started and state.refine_started
                and math.isclose(state.lr, LR * 0.3) and math.isclose(state.w, W * 0.3)):
            raise AssertionError(f"trainer: the curriculum did not switch: {state}")
        if sorted(os.listdir(tmp)) != ["best.pt", "last.pt"]:
            raise AssertionError(f"trainer: checkpoints {os.listdir(tmp)}")
        other = Trainer(train_config(seed=1), device=DEVICE)
        back = ckpt.restore_into(other.init_state(), "last")
        for a, b in ((tr.pipe.posenet, other.pipe.posenet),
                     (tr.pipe.refiner, other.pipe.refiner)):
            sa, sb = a.state_dict(), b.state_dict()
            bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
            if bad:
                raise AssertionError(f"restore_into differs on {bad[:5]}")
        meta = (back.lr, back.w, back.decay_started, back.refine_started,
                back.best_test, back.epoch)
        if meta != (state.lr, state.w, True, True, state.best_test, 2):
            raise AssertionError(f"restore_into meta {meta}")
        opt_ids = {id(p) for g in back.optimizer.param_groups for p in g["params"]}
        if opt_ids != {id(p) for p in other.pipe.refiner.parameters()}:
            raise AssertionError("restore_into built Adam for the wrong network")
        print("  checkpoints best/last written; restore_into of last: both "
              "state dicts and the six curriculum fields exact, Adam over the "
              "refiner ok")
        del other, back

    # a stop mid-window: BN back to the window's start, `last` saved
    stop_tr = Trainer(cfg, device=DEVICE)
    stop_state = stop_tr.init_state()
    bn0 = bn_state(stop_tr.pipe.posenet)
    calls = {"n": 0}

    def stop_fn():
        calls["n"] += 1
        return calls["n"] > 3  # three samples of a window of WINDOW

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(tmp)
        stop_state = stop_tr.fit(stop_state, train_ds, test_ds, epochs=2,
                                 log_fn=logs.append,
                                 save_last_fn=lambda s: ckpt.save(s, s.best_test, tag="last"),
                                 stop_fn=stop_fn)
        last = ckpt.restore("last")
    bn1 = bn_state(stop_tr.pipe.posenet)
    bad = [k for k in bn0 if not torch.equal(bn0[k], bn1[k])]
    if bad or stop_state.epoch != 0 or last is None or last["meta"]["epoch"] != 0:
        raise AssertionError(f"stop mid-window: BN changed {bad[:5]}, epoch "
                             f"{stop_state.epoch}, last {last and last['meta']}")
    print(f"  stop after 3 samples of a window of {WINDOW}: BN buffers equal to "
          "the window-start snapshot, last saved at epoch 0 ok")
    del stop_tr, stop_state

    # one stage-1 epoch through the plain versions, then through the kernels
    # from the same state and seed; each window of the kernel run starts
    # from the plain run's parameters
    runs = {}
    for name, use_kernels in (("plain", False), ("kernels", True)):
        pipe = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, use_kernels=use_kernels,
                                   device=DEVICE, seed=0)
        forced = runs["plain"][0].after_steps if use_kernels else None
        rt = recording_trainer(Trainer, train_config(), pipe, forced)
        st, info = rt.train_epoch(rt.init_state(), train_ds,
                                  torch.Generator().manual_seed(5))
        torch.cuda.synchronize()
        runs[name] = (rt, st, info)
    (pk, _, ip), (kk, kst, ik) = runs["plain"], runs["kernels"]
    worst = max(abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(ik["losses"], ip["losses"]))
    worst_dis = max(abs(a - b) / max(abs(b), 1e-30)
                    for a, b in zip(ik["dists"], ip["dists"]))
    param_l2 = 0.0
    for a, b in zip(kk.after_steps, pk.after_steps):
        num = sum(float((a[n] - b[n]).pow(2).sum()) for n in a)
        param_l2 = max(param_l2, (num / sum(float(b[n].pow(2).sum()) for n in a)) ** 0.5)
    ok = worst <= EPOCH_TOL["loss"] and param_l2 <= EPOCH_TOL["param_l2"]
    print(f"  stage-1 epoch ({n_tr} samples, {len(pk.after_steps)} windows) "
          f"kernels vs plain: per-sample loss max rel {worst:.2e} (tol "
          f"{EPOCH_TOL['loss']:g}); PoseNet's parameters after each window, "
          f"relative L2, max {param_l2:.2e} (tol {EPOCH_TOL['param_l2']:g}) "
          f"{'ok' if ok else 'FAIL'}; per-sample dis max rel {worst_dis:.2e} "
          "(not gated: the best-confidence hypothesis's distance, where a "
          "confidence near-tie within f32 noise may pick another point)")
    if not ok:
        raise AssertionError("trainer: kernel epoch disagrees with the plain epoch")
    del runs, pk
    torch.cuda.empty_cache()
    check_kernels_at(crops, errs, torch.Generator().manual_seed(8))
    return {"trainer": seen}, {"tr": tr, "state": state, "stage1": kk,
                               "stage1_state": kst, "train_ds": train_ds,
                               "fit_s": fit_s}


@phase("fused")
def fused_phase(train_ds, errs):
    """One FusedTrainer epoch (window WINDOW, f32), then a window on its
    shared canvas against WINDOW per-sample steps of the same samples."""
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    from plr2_tpu_torch.parallel import TrainStep
    from plr2_tpu_torch.parallel.data_parallel import BATCH_KEYS
    from plr2_tpu_torch.train import FusedTrainer, make_fused_window_grads
    n = len(train_ds)
    s_n = sum(is_sym(train_ds, i) for i in range(n))
    # the per-sample loop (graphs=False); the CUDA graph of a window is
    # held against it in the train graphs phase
    ftr = FusedTrainer(train_config(), device=DEVICE, graphs=False)
    state = ftr.init_state()
    reset_launch_counts()
    state, info = ftr.train_epoch(state, train_ds, torch.Generator().manual_seed(6))
    torch.cuda.synchronize()
    seen = launch_counts()
    print(f"  launches in one FusedTrainer epoch ({n} samples, window {WINDOW}, "
          f"{info['seconds']:.2f} s): {seen}")
    expect = counts(mlp_head=3 * n, upconv3x3_prelu=3 * n, nn_match=s_n,
                    gather_rows_backward=n)
    if seen != expect:
        raise AssertionError(f"fused: expected launches {expect}, got {seen}")
    samples = list(ftr._sample_iter(train_ds, torch.Generator().manual_seed(7),
                                    add_noise=True, shuffle=False, seed=0))[:WINDOW]
    win = ftr._stack_eval(samples)
    net = ftr.pipe.posenet
    bn0 = bn_state(net)

    def loop_grads():
        """WINDOW per-sample steps of the same samples (the Trainer's
        per-sample code), from the same BN state and dropout seed."""
        net.load_state_dict({**net.state_dict(), **bn0})
        step = TrainStep(ftr.pipe, SYM_LIST, W)
        net.zero_grad(set_to_none=True)
        gen = torch.Generator().manual_seed(9)
        losses = torch.stack([step.accumulate(
            {k: win[k][i:i + 1] for k in BATCH_KEYS}, gen)[0]
            for i in range(WINDOW)])
        torch.cuda.synchronize()
        return {k: p.grad.clone() for k, p in net.named_parameters()}, losses

    def rel_l2(a, b):
        return max((float((a[k] - b[k]).norm() / b[k].norm().clamp(min=1e-30)), k)
                   for k in b)

    fused_losses, _ = make_fused_window_grads(ftr.pipe, SYM_LIST, W, graphs=False)(
        win, torch.Generator().manual_seed(9))
    torch.cuda.synchronize()
    g_fused = {k: p.grad.clone() for k, p in net.named_parameters()}
    g_loop, loop_losses = loop_grads()
    g_again, again_losses = loop_grads()
    net.zero_grad(set_to_none=True)
    rel, worst_name = rel_l2(g_fused, g_loop)
    equal = sum(torch.equal(g_fused[k], g_loop[k]) for k in g_loop)
    again = sum(torch.equal(g_again[k], g_loop[k]) for k in g_loop)
    dl = float((fused_losses - loop_losses).abs().max() / loop_losses.abs().max())
    ok = (rel <= FUSED_TOL and dl <= FUSED_TOL and again == len(g_loop)
          and torch.equal(again_losses, loop_losses))
    print(f"  window of {WINDOW} on a {win['img'].shape[1]} px canvas vs {WINDOW} "
          f"per-sample steps: losses max rel {dl:.2e}; gradients max rel L2 "
          f"{rel:.2e} ({worst_name}), {equal}/{len(g_loop)} tensors bit-equal "
          f"(tol {FUSED_TOL:g}); the same per-sample loop run twice: "
          f"{again}/{len(g_loop)} gradient tensors and the losses bit-equal "
          f"(must be all) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fused window differs from the per-sample steps, "
                             "or the per-sample loop from itself")
    canvas = win["img"].shape[1]
    check_kernels_at([(canvas, canvas)], errs, torch.Generator().manual_seed(10),
                     match=False)
    return {"fused": seen}, {"ftr": ftr, "win": win, "epoch_s": info["seconds"],
                             "losses": info["losses"]}


@phase("mixed")
def mixed_phase(errs):
    """BatchTrainer in bf16 mixed precision, batch MIXED_BATCH, stage 1, for
    MIXED_STEPS steps through the kernels; the same epoch through the plain
    versions and in f32, from one state and seed."""
    import numpy as np
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.ops import launch_counts, mlp_head, reset_launch_counts, upconv
    from plr2_tpu_torch.train import BatchTrainer
    ds = scene_dataset(MIXED_BATCH * MIXED_STEPS // PER_FRAME, 2)
    n = len(ds)
    order = np.arange(n)
    np.random.default_rng(0).shuffle(order)  # BatchTrainer's epoch-0 order
    batches_with_sym = sum(any(is_sym(ds, int(i)) for i in order[b:b + MIXED_BATCH])
                           for b in range(0, n, MIXED_BATCH))
    from plr2_tpu_torch.train.trainer import snap_canvas
    crops = crop_shapes(ds)
    canvases = [max(snap_canvas(max(max(crops[int(i)]) for i in order[b:b + MIXED_BATCH])),
                    CROP) for b in range(0, n, MIXED_BATCH)]
    dtypes = set()
    orig = mlp_head.mlp_head_forward, upconv.upconv3x3_prelu_forward

    def head(x, params):
        dtypes.add(("mlp_head", x.dtype, params[0][0].dtype))
        return orig[0](x, params)

    def up(x, w, b, a):
        dtypes.add(("upconv3x3_prelu", x.dtype, w.dtype))
        return orig[1](x, w, b, a)

    runs = {}
    for name, use_kernels, dt_name in (("mixed", True, "bfloat16"),
                                       ("mixed_plain", False, "bfloat16"),
                                       ("f32", True, "float32")):
        cfg = train_config(dtype=dt_name, batch_size=MIXED_BATCH)
        pipe = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, use_kernels=use_kernels,
                                   device=DEVICE, seed=0,
                                   dtype=torch.bfloat16 if dt_name == "bfloat16"
                                   else torch.float32)
        btr = BatchTrainer(cfg, pipe=pipe, graphs=False)
        state = btr.init_state()
        if name == "mixed":
            reset_launch_counts()
            mlp_head.mlp_head_forward, upconv.upconv3x3_prelu_forward = head, up
        try:
            state, info = btr.train_epoch(state, ds, torch.Generator().manual_seed(3))
            torch.cuda.synchronize()
        finally:
            mlp_head.mlp_head_forward, upconv.upconv3x3_prelu_forward = orig
        if name == "mixed":
            seen = launch_counts()
            print(f"  launches in {MIXED_STEPS} mixed-precision BatchTrainer steps "
                  f"at batch {MIXED_BATCH}: {seen}; kernel operand dtypes "
                  f"{sorted((k, str(a), str(b)) for k, a, b in dtypes)}")
            expect = counts(mlp_head=3 * MIXED_STEPS, upconv3x3_prelu=3 * MIXED_STEPS,
                            nn_match=batches_with_sym,
                            gather_rows_backward=MIXED_STEPS)
            if seen != expect:
                raise AssertionError(f"mixed: expected launches {expect}, got {seen}")
            if {(a, b) for _, a, b in dtypes} != {(torch.bfloat16, torch.bfloat16)}:
                raise AssertionError(f"mixed: kernels saw dtypes {dtypes}")
            f32 = [(k, t.dtype) for net in (pipe.posenet, pipe.refiner)
                   for k, t in net.state_dict().items()
                   if t.dtype not in (torch.float32, torch.int64)]
            f32 += [("adam", v.dtype) for s in state.optimizer.state.values()
                    for k, v in s.items() if k.startswith("exp_avg")
                    and v.dtype != torch.float32]
            if f32:
                raise AssertionError(f"mixed: state not f32: {f32[:5]}")
            print("  parameters, BN statistics and Adam's moments stay f32 ok")
            runs["btr"], runs["state"] = btr, state
        runs[name] = info["losses"]
        if name != "mixed":
            del btr, pipe, state
        torch.cuda.empty_cache()
    kp = max(abs(a - b) / abs(b) for a, b in zip(runs["mixed"], runs["mixed_plain"]))
    kf = max(abs(a - b) / abs(b) for a, b in zip(runs["mixed"], runs["f32"]))
    ok = kp <= MIXED_TOL["kernel_vs_plain"] and kf <= MIXED_TOL["vs_f32"]
    print(f"  losses: mixed {runs['mixed']}, mixed plain {runs['mixed_plain']}, "
          f"f32 {runs['f32']}; kernels vs plain max rel {kp:.2e} (tol "
          f"{MIXED_TOL['kernel_vs_plain']:g}), mixed vs f32 max rel {kf:.2e} "
          f"(tol {MIXED_TOL['vs_f32']:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("mixed precision: losses disagree")
    check_kernels_at([(c, c) for c in canvases], errs,
                     torch.Generator().manual_seed(14), "bf16", MIXED_BATCH,
                     match=False)
    return {"mixed": seen}, {"btr": runs["btr"], "state": runs["state"], "ds": ds,
                             "losses": runs["mixed"]}


@phase("train entry timing")
def entry_timing_phase(trainer_out, fused_out, mixed_out):
    """Samples/s of the per-sample Trainer in both stages (host clock around
    a synchronised epoch), FusedTrainer ms per window, mixed bf16 BatchTrainer
    ms per step at batch MIXED_BATCH, and the CLI's wall time for 2 synthetic
    epochs on the card."""
    import tempfile
    from plr2_tpu_torch.train import make_fused_accum_step
    out = {}
    ds = trainer_out["train_ds"]
    from plr2_tpu_torch.train import Trainer
    stage1 = Trainer(train_config(), pipe=trainer_out["stage1"].pipe)
    for stage, tr, state in (
            ("stage1", stage1, trainer_out["stage1_state"]),
            ("refine", trainer_out["tr"], trainer_out["state"])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_epoch(state, ds, torch.Generator().manual_seed(11))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        out[f"trainer_{stage}_samples_per_s"] = len(ds) / s
        print(f"  Trainer {stage} epoch f32: {len(ds)} samples in {s:.3f} s = "
              f"{len(ds) / s:.1f} samples/s (per-sample steps at their own crops)")
    # where a per-sample step's time goes: one stage-1 sample's forward and
    # backward (no optimizer step) under the profiler
    from torch.profiler import ProfilerActivity, profile
    from plr2_tpu_torch.train.trainer import sample_batch
    sample = next(iter(stage1._sample_iter(ds, torch.Generator().manual_seed(15),
                                           add_noise=True, shuffle=False, seed=0)))
    one = stage1.stage_step(trainer_out["stage1_state"])
    b, gen = sample_batch(sample), torch.Generator().manual_seed(16)
    one.accumulate(b, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one.accumulate(b, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    one.network.zero_grad(set_to_none=True)
    out["sample_step_wall_ms"] = wall
    out["sample_step_device_ms"] = top_device_kernels(
        prof, wall, f"one per-sample stage-1 step (forward and backward) at "
        f"{tuple(sample.img.shape[:2])}", 8)
    ftr, win = fused_out["ftr"], fused_out["win"]
    step = make_fused_accum_step(ftr.pipe, SYM_LIST, W, lr=LR, graphs=False)
    gen = torch.Generator().manual_seed(12)
    step(win, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(win, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 3
    out["fused_window_ms"] = ms
    out["fused_epoch_ms_per_window"] = fused_out["epoch_s"] * 1e3 / (len(ds) // WINDOW)
    print(f"  FusedTrainer window of {WINDOW} f32 on a {win['img'].shape[1]} px "
          f"canvas: {ms:.3f} ms per window ({WINDOW * 1e3 / ms:.1f} samples/s; "
          f"before the determinism repair: {BEFORE_MS['fused_window']} ms); its epoch "
          f"{out['fused_epoch_ms_per_window']:.3f} ms per window with "
          "the data path (first epoch)")
    btr, state = mixed_out["btr"], mixed_out["state"]
    samples = list(btr._sample_iter(mixed_out["ds"], torch.Generator().manual_seed(13),
                                    add_noise=True, shuffle=False, seed=0))
    batch = btr._stack_eval(samples[:MIXED_BATCH])
    mstep = btr.stage_step(state)
    ms = step_ms(mstep, batch, 5)
    out["mixed_ms"], out["mixed_samples_per_s"] = ms, MIXED_BATCH * 1e3 / ms
    print(f"  mixed bf16 stage-1 step batch {MIXED_BATCH} ({batch['img'].shape[1]} px "
          f"canvas): {ms:.3f} ms = {MIXED_BATCH * 1e3 / ms:.1f} samples/s "
          f"(before the determinism repair: {BEFORE_MS['mixed']} ms)")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "plr2_tpu_torch.tools.train", "--synthetic",
             "--nepoch", "2", "--outf", tmp, "--log_dir", tmp],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode != 0 or sorted(os.listdir(Path(tmp) / "linemod")) != [
                "best.pt", "last.pt"]:
            raise AssertionError(f"CLI failed: {res.stderr[-3000:]}")
    out["cli_wall_s"] = wall
    for line in (res.stderr + res.stdout).splitlines():
        if "epoch" in line or "training" in line:
            print(f"  cli: {line}")
    print(f"  python -m plr2_tpu_torch.tools.train --synthetic --nepoch 2 (LineMOD "
          f"preset: 13 objects, 500 points; 8 train / 4 test samples): "
          f"{wall:.2f} s wall, process start included")
    return out


def host_split(prof, wall, data_ms):
    """Where one per-sample step's host time goes (module docstring, phase
    20): the data path, the kernels' plain backward passes (the autograd
    Functions of mlp_head and upconv3x3_prelu: host time with their
    children, and their device time), and the rest of the step (Python,
    dispatch and autograd) per launch; beside the device's busy time."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    n = sum(e.count for e in kernels)
    bwd = [e for e in prof.key_averages()
           if e.key.startswith("autograd::engine::evaluate_function: ")
           and any(f in e.key for f in BACKWARD_FUNCTIONS)]
    bwd_host = sum(e.cpu_time_total for e in bwd) / 1e3
    bwd_dev = sum(e.device_time_total for e in bwd) / 1e3
    split = {"data_ms": data_ms, "step_wall_ms": wall, "device_busy_ms": busy,
             "launches": n, "backward_fn_host_ms": bwd_host,
             "backward_fn_device_ms": bwd_dev,
             "rest_host_us_per_launch": 1e3 * (wall - bwd_host) / max(n, 1)}
    total = data_ms + wall
    print(f"  host time of one per-sample stage-1 sample, {total:.3f} ms: data "
          f"path {data_ms:.3f} ms ({100 * data_ms / total:.1f}%); the kernels' "
          f"plain backward passes {bwd_host:.3f} ms of host time "
          f"({100 * bwd_host / total:.1f}%; {bwd_dev:.3f} ms on the device); "
          f"the rest of the step {wall - bwd_host:.3f} ms ({100 * (wall - bwd_host) / total:.1f}%: "
          f"Python, dispatch and autograd, {split['rest_host_us_per_launch']:.1f} us "
          f"a launch over {n} launches); device busy {busy:.3f} ms of the "
          f"step's {wall:.3f} ms ({100 * busy / wall:.1f}%)")
    return split


def state_of(net):
    """Gradients (where set) and BN buffers of `net`, cloned."""
    return ({k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None},
            bn_state(net))


def same_state(what, a, b, losses_a, losses_b, tol):
    """`a` and `b` (state_of) and their losses: bit-equal, or each gradient
    within `tol` in relative L2 and the losses within `tol` relative.
    Returns whether they were bit-equal; raises otherwise."""
    (ga, bna), (gb, bnb) = a, b
    if ga.keys() != gb.keys():
        raise AssertionError(f"{what}: gradients of other parameters")
    equal = (all(torch.equal(ga[k], gb[k]) for k in gb)
             and all(torch.equal(bna[k], bnb[k]) for k in bnb)
             and torch.equal(losses_a, losses_b))
    rel = max(float((ga[k] - gb[k]).norm() / gb[k].norm().clamp(min=1e-30)) for k in gb)
    rel_bn = max((float((bna[k].double() - bnb[k].double()).norm()
                        / bnb[k].double().norm().clamp(min=1e-30)) for k in bnb),
                 default=0.0)
    dl = float(((losses_a - losses_b).abs() / losses_b.abs().clamp(min=1e-30)).max())
    ok = equal or (rel <= tol and rel_bn <= tol and dl <= tol)
    print(f"  {what}: {'bit-equal' if equal else 'not bit-equal'}; gradients max "
          f"rel L2 {rel:.2e}, BN buffers {rel_bn:.2e}, losses max rel {dl:.2e} "
          f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} differ")
    return equal


def alternating_ms(fns, reps):
    """ms a call of each of `fns` (name -> callable), host clock around
    synchronised runs, in turns a, b, b, a after one warm call each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for name in list(fns) + list(fns)[::-1]:
        t0 = time.perf_counter()
        for _ in range(reps):
            fns[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3 / reps)
    return {k: sum(v) / len(v) for k, v in times.items()}


def recorded_keys(graphs):
    """The distinct keys that `graphs` (a GradientGraphs) is asked for (the
    caller's key: stage, w, sym_slots, branch; and the batch's image
    shape), and the card memory (MiB reserved, the allocator's cache
    emptied around the call) that each call with a new key added."""
    keys, grown, run = set(), [], graphs.run

    def run_recorded(key, step, program, inputs):
        k = (key, tuple(inputs["img"].shape))
        if k in keys:
            return run(key, step, program, inputs)
        keys.add(k)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        res = run(key, step, program, inputs)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        grown.append((torch.cuda.memory_reserved() - r0) / 2 ** 20)
        return res
    graphs.run = run_recorded
    return keys, grown


def key_space_epochs(name, kind, cfg, dtype, ds):
    """Two epochs of the graphed trainer `kind` on `ds` from a seeded
    pipeline, then one epoch of its eager twin from the same start:
    samples/s of each (data path included), the graphs' distinct keys and
    captures (a key captured twice fails) and the card memory the graphs
    held (reserved memory released by dropping them)."""
    from plr2_tpu_torch import DenseFusionPipeline
    n, res = len(ds), {}
    for graphed in (True, False):
        pipe = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0,
                                   dtype=dtype)
        tr = kind(cfg, pipe=pipe, device=DEVICE, graphs=graphed)
        st = tr.init_state()
        if graphed:
            keys, grown = recorded_keys(tr.graphs)
        for epoch in range(2 if graphed else 1):
            caps0 = tr.graphs.captures if graphed else 0
            st, info = tr.train_epoch(st, ds, torch.Generator().manual_seed(40 + epoch))
            torch.cuda.synchronize()
            tag = f"{'graph' if graphed else 'eager'}_epoch{epoch + 1}"
            res[f"{tag}_samples_per_s"] = n / info["seconds"]
            if graphed:
                res[f"{tag}_captures"] = tr.graphs.captures - caps0
        if graphed:
            res["keys"], res["held"] = len(keys), tr.graphs.held
            shapes = sorted((k[0][-1], k[1]) for k in keys)
            if tr.graphs.captures != len(keys) or tr.graphs.held != len(keys):
                raise AssertionError(f"{name}: {tr.graphs.captures} captures and "
                                     f"{tr.graphs.held} graphs for {len(keys)} keys")
            pipe.posenet.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved()
            tr.graphs.clear()
            torch.cuda.empty_cache()
            res["graphs_mib"] = (before - torch.cuda.memory_reserved()) / 2 ** 20
            res.update({f"capture{i + 1}_mib": m for i, m in enumerate(grown)})
        del tr, st, pipe
        torch.cuda.empty_cache()
    print(f"  {name}, a full synthetic epoch of {n} samples at YCB width, twice: "
          f"{res['keys']} distinct keys (branch, batch shape) {shapes}, captures "
          f"{res['graph_epoch1_captures']} + {res['graph_epoch2_captures']}; "
          f"{res['graph_epoch1_samples_per_s']:.1f} samples/s (captures included), then "
          f"{res['graph_epoch2_samples_per_s']:.1f}; eager "
          f"{res['eager_epoch1_samples_per_s']:.1f} samples/s; the {res['held']} graphs "
          f"(one memory pool, one set of gradients) held {res['graphs_mib']:.1f} MiB, "
          f"the captures in turn added {' + '.join(f'{m:.1f}' for m in grown)} MiB "
          "(a later graph reuses what an earlier one freed where the blocks fit)")
    return res


@phase("train graphs")
def train_graphs_phase(tkern, batch, trainer_out, fused_out, mixed_out):
    """Phase 20: the training graphs (train/graphs.py) against the eager
    paths they replace, the host-time split, remat and sym_slots."""
    from torch.profiler import ProfilerActivity, profile
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.losses.add_loss import loss_branch
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    from plr2_tpu_torch.parallel import TrainStep, make_train_step
    from plr2_tpu_torch.parallel.data_parallel import count_symmetric
    from plr2_tpu_torch.train import (BatchTrainer, FusedTrainer,
                                      make_fused_accum_step,
                                      make_fused_window_grads)
    from plr2_tpu_torch.train.graphs import GradientGraphs
    from plr2_tpu_torch.train.trainer import sample_batch
    out = {}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    # -- the host-time split of one eager per-sample stage-1 step --
    ds = trainer_out["train_ds"]
    stage1 = trainer_out["stage1"]
    it = stage1._sample_iter(ds, torch.Generator().manual_seed(15), add_noise=True,
                             shuffle=False, seed=0)
    samples = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WINDOW):
        samples.append(next(it))
        torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    data_ms = data_s * 1e3 / WINDOW
    print(f"  data path (get_raw -> raw_to_sample -> preprocess_crop, synchronised), "
          f"{WINDOW} samples: {data_s:.3f}s total, {data_ms:.2f} ms/call")
    step = stage1.stage_step(trainer_out["stage1_state"])
    b, gen = sample_batch(samples[0]), torch.Generator().manual_seed(16)
    step.accumulate(b, gen)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step.accumulate(b, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    step.network.zero_grad(set_to_none=True)
    split = host_split(prof, wall, data_ms)
    out.update({f"eager_{k}": v for k, v in split.items()})

    # -- a window as one CUDA graph against the per-sample loop --
    ftr, win = fused_out["ftr"], fused_out["win"]
    pipe, net = ftr.pipe, ftr.pipe.posenet
    bn0 = bn_state(net)

    def window_run(fn):
        net.load_state_dict({**net.state_dict(), **bn0})
        net.zero_grad(set_to_none=True)
        losses, _ = fn(win, torch.Generator().manual_seed(9))
        torch.cuda.synchronize()
        return state_of(net), losses.clone()

    eager, eager_l = window_run(make_fused_window_grads(pipe, SYM_LIST, W, graphs=False))
    cache = GradientGraphs()
    graphed = make_fused_window_grads(pipe, SYM_LIST, W, graphs=cache)
    reset_launch_counts()
    first, first_l = window_run(graphed)
    at_capture = launch_counts()
    second, second_l = window_run(graphed)
    after_replay = launch_counts()
    canvas = win["img"].shape[1]
    same_state(f"window of {WINDOW} on a {canvas} px canvas, CUDA graph vs the per-sample "
               f"loop (same samples, masks and BN state)", first, eager, first_l,
               eager_l, FUSED_TOL)
    if not same_state("the window graph replayed twice from one state", second, first,
                      second_l, first_l, 0.0):
        raise AssertionError("two replays of the window graph differ")
    # the warm-up and the capture each run the program once: per sample 3 + 3
    # PoseNet launches, the batch-1 mixed form's ADD-S match, the gather's
    # backward; a replay calls no wrapper
    expect = counts(mlp_head=2 * 3 * WINDOW, upconv3x3_prelu=2 * 3 * WINDOW,
                    nn_match=2 * WINDOW, gather_rows_backward=2 * WINDOW)
    print(f"  launch counters at the capture (warm-up + capture): {at_capture}; "
          f"after a replay: {after_replay} (replays run no Python)")
    if at_capture != expect or after_replay != at_capture:
        raise AssertionError(f"window graph: expected counters {expect} at the "
                             f"capture and no more after a replay, got "
                             f"{at_capture} / {after_replay}")
    net.load_state_dict({**net.state_dict(), **bn0})
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        graphed(win, torch.Generator().manual_seed(9))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    seen = port_kernel_counts(prof, GRAPH_KERNELS)
    want = {"head_sgemm_kernel": 12 * WINDOW, "upconv_sgemm_kernel": 3 * WINDOW,
            "nn_kernel<": WINDOW, "gather_bwd_kernel": WINDOW}
    print(f"  the port's kernels in the profile of one replay: {seen} (expected {want})")
    if seen != want:
        raise AssertionError(f"window replay ran kernels {seen}, expected {want}")
    busy = top_device_kernels(prof, wall, f"one replayed window of {WINDOW} "
                              "(mask draw and copy-in included)", 6)
    out["graph_window_busy_ms"], out["graph_window_wall_ms"] = busy, wall
    # the batch-1 mixed form runs the ADD-S match on every sample of the
    # window, the asymmetric ones too: what that costs in a replay
    from torch.autograd import DeviceType
    out["graph_window_match_ms"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and "nn_kernel<" in e.key) / 1e3
    n_sym = sum(int(o) in SYM_LIST for o in win["obj"])
    print(f"  the ADD-S match in the replay: {out['graph_window_match_ms']:.3f} ms "
          f"over {WINDOW} launches ({n_sym} of the {WINDOW} samples symmetric)")
    steps = {"eager": make_fused_accum_step(pipe, SYM_LIST, W, lr=LR, graphs=False),
             "graph": make_fused_accum_step(pipe, SYM_LIST, W, lr=LR, graphs=cache)}
    gens = {k: torch.Generator().manual_seed(12) for k in steps}
    ms = alternating_ms({k: (lambda k=k: steps[k](win, gens[k])) for k in steps}, 3)
    out["fused_window_eager_ms"], out["fused_window_graph_ms"] = ms["eager"], ms["graph"]
    print(f"  FusedTrainer window of {WINDOW} f32 on a {canvas} px canvas (masks drawn, "
          f"copy-in, gradients, Adam): eager {ms['eager']:.3f} ms, CUDA graph "
          f"{ms['graph']:.3f} ms ({ms['eager'] / ms['graph']:.2f}x); per sample "
          f"{ms['graph'] / WINDOW:.3f} ms beside the data path's {data_ms:.3f} ms")
    del steps, cache, graphed
    net.load_state_dict({**net.state_dict(), **bn0})
    # after the graphs a sample's step is its share of a replayed window
    # (masks, copy-in and Adam included); the data path is unchanged
    step_ms_after = ms["graph"] / WINDOW
    out["graph_sample_step_ms"] = step_ms_after
    total = data_ms + step_ms_after
    print(f"  host time of one sample after the graphs, {total:.3f} ms: data path "
          f"{data_ms:.3f} ms ({100 * data_ms / total:.1f}%), its share of a "
          f"replayed window {step_ms_after:.3f} ms ({100 * step_ms_after / total:.1f}%; "
          f"before: data {data_ms:.3f} + step {split['step_wall_ms']:.3f} ms)")

    # -- the refine stage's window (WINDOW // ITERS samples, FusedTrainer
    # after the refine switch) as one graph against the per-sample loop --
    rnet, rwin = pipe.refiner, {k: v[:WINDOW // ITERS] for k, v in win.items()}
    nr = WINDOW // ITERS
    r0 = {k: v.clone() for k, v in rnet.state_dict().items()}

    def refine_run(fn):
        rnet.load_state_dict(r0)
        rnet.zero_grad(set_to_none=True)
        losses, _ = fn(rwin)
        torch.cuda.synchronize()
        return state_of(rnet), losses.clone()

    r_eager, rl_eager = refine_run(make_fused_window_grads(
        pipe, SYM_LIST, W, refine_iterations=ITERS, graphs=False))
    rgraphed = make_fused_window_grads(pipe, SYM_LIST, W, refine_iterations=ITERS,
                                       graphs=GradientGraphs())
    reset_launch_counts()
    r_first, rl_first = refine_run(rgraphed)
    at_capture = launch_counts()
    r_second, rl_second = refine_run(rgraphed)
    same_state(f"refine-stage window of {nr} ({ITERS} iterations), CUDA graph vs the "
               "per-sample loop", r_first, r_eager, rl_first, rl_eager, FUSED_TOL)
    if not same_state("the refine window graph replayed twice from one state", r_second,
                      r_first, rl_second, rl_first, 0.0):
        raise AssertionError("two replays of the refine window graph differ")
    # warm-up and capture: per sample 3 + 3 PoseNet launches (eval, no
    # backward) and one ADD-S match an iteration; a replay calls no wrapper
    expect = counts(mlp_head=2 * 3 * nr, upconv3x3_prelu=2 * 3 * nr,
                    nn_match=2 * ITERS * nr)
    print(f"  refine window: launch counters at the capture {at_capture}, after a "
          f"replay {launch_counts()}")
    if at_capture != expect or launch_counts() != at_capture:
        raise AssertionError(f"refine window graph: expected counters {expect} at the "
                             f"capture and no more after a replay")
    rnet.load_state_dict(r0)
    del rgraphed

    # -- FusedTrainer epochs: the graph against the per-sample loop --
    n = len(ds)
    ftr_g = FusedTrainer(train_config(), device=DEVICE)
    st_g = ftr_g.init_state()
    reset_launch_counts()
    st_g, info_g = ftr_g.train_epoch(st_g, ds, torch.Generator().manual_seed(6))
    torch.cuda.synchronize()
    seen, caps = launch_counts(), ftr_g.graphs.captures
    graph_launches = {"fused_graphs": seen}
    expect = counts(mlp_head=2 * 3 * WINDOW * caps, upconv3x3_prelu=2 * 3 * WINDOW * caps,
                    nn_match=2 * WINDOW * caps, gather_rows_backward=2 * WINDOW * caps)
    print(f"  graphed FusedTrainer epoch ({n} samples, {caps} captures): launch "
          f"counters {seen}")
    if seen != expect:
        raise AssertionError(f"graphed fused epoch: expected counters {expect}, got {seen}")
    lg, le = torch.tensor(info_g["losses"]), torch.tensor(fused_out["losses"])
    rel = float(((lg - le).abs() / le.abs()).max())
    print(f"  graphed FusedTrainer epoch vs the per-sample loop's (phase fused, same "
          f"seeds): per-sample losses {'bit-equal' if torch.equal(lg, le) else 'not bit-equal'}, "
          f"max rel {rel:.2e} (tol {EPOCH_TOL['loss']:g})")
    if rel > EPOCH_TOL["loss"]:
        raise AssertionError("graphed FusedTrainer epoch differs from the eager one")
    del ftr_g, st_g
    torch.cuda.empty_cache()

    # -- the mixed BatchTrainer step: graph vs eager, sym_slots auto vs 0 --
    btr = mixed_out["btr"]
    mpipe, mnet = btr.pipe, btr.pipe.posenet
    msamples = list(btr._sample_iter(mixed_out["ds"], torch.Generator().manual_seed(13),
                                     add_noise=True, shuffle=False, seed=0))
    mbatch = btr._stack_eval(msamples[:MIXED_BATCH])
    n_sym, auto = count_symmetric(mbatch, SYM_LIST), btr._sym_slots()
    branch = {k: loss_branch(MIXED_BATCH, n_sym, False, SYM_LIST, k) for k in (auto, None)}
    state0 = {k: v.clone() for k, v in mnet.state_dict().items()}
    mcache = GradientGraphs()

    def grads_of(fn):
        mnet.load_state_dict(state0)
        mnet.zero_grad(set_to_none=True)
        loss, _ = fn()
        torch.cuda.synchronize()
        return state_of(mnet), loss.reshape(1).clone()

    def eager_step(slots):
        return TrainStep(mpipe, SYM_LIST, W, sym_slots=slots).accumulate(
            mbatch, torch.Generator().manual_seed(9))

    def graph_step(slots):
        return mcache.gradients(TrainStep(mpipe, SYM_LIST, W, sym_slots=slots), mbatch,
                                torch.Generator().manual_seed(9))

    e_auto, el_auto = grads_of(lambda: eager_step(auto))
    g_auto, gl_auto = grads_of(lambda: graph_step(auto))
    g_again, gl_again = grads_of(lambda: graph_step(auto))
    g_off, gl_off = grads_of(lambda: graph_step(None))
    canvas_m = mbatch["img"].shape[1]
    print(f"  mixed bf16 batch {MIXED_BATCH} on a {canvas_m} px canvas, {n_sym} "
          f"symmetric samples; sym_slots auto = {auto} (the {branch[auto]} branch), "
          f"0 = the {branch[None]} branch")
    same_state("mixed step, CUDA graph vs eager (sym_slots auto)", g_auto, e_auto,
               gl_auto, el_auto, FUSED_TOL)
    if not same_state("mixed step graph replayed twice", g_again, g_auto, gl_again,
                      gl_auto, 0.0):
        raise AssertionError("two replays of the mixed step differ")
    if not same_state("mixed step graph, sym_slots auto vs 0", g_auto, g_off,
                      gl_auto, gl_off, 0.0):
        raise AssertionError("sym_slots auto and 0 differ")
    # the refine stage's batched step (BatchTrainer after the refine switch)
    # in the same graph cache: PoseNet in eval, the refiner trained
    rmnet = mpipe.refiner
    rm0 = {k: v.clone() for k, v in rmnet.state_dict().items()}
    rstep = TrainStep(mpipe, SYM_LIST, W, refine_iterations=ITERS, sym_slots=auto)

    def refine_grads(fn):
        rmnet.load_state_dict(rm0)
        rmnet.zero_grad(set_to_none=True)
        loss, _ = fn()
        torch.cuda.synchronize()
        return state_of(rmnet), loss.reshape(1).clone()

    r_eager, rl_eager = refine_grads(lambda: rstep.accumulate(mbatch))
    r_first, rl_first = refine_grads(lambda: mcache.gradients(rstep, mbatch))
    r_second, rl_second = refine_grads(lambda: mcache.gradients(rstep, mbatch))
    same_state(f"refine-stage mixed step batch {MIXED_BATCH}, CUDA graph vs eager",
               r_first, r_eager, rl_first, rl_eager, FUSED_TOL)
    if not same_state("refine mixed step graph replayed twice", r_second, r_first,
                      rl_second, rl_first, 0.0):
        raise AssertionError("two replays of the refine mixed step differ")
    rmnet.load_state_dict(rm0)
    mnet.load_state_dict(state0)
    fns = {}
    for name, slots, graphed_step in (("eager auto", auto, False), ("graph auto", auto, True),
                                      ("graph 0", None, True)):
        st = TrainStep(mpipe, SYM_LIST, W, lr=LR, sym_slots=slots)
        g = torch.Generator().manual_seed(21)
        if graphed_step:
            fns[name] = (lambda st=st, g=g: (mcache.gradients(st, mbatch, g),
                                             st.optimizer.step()))
        else:
            fns[name] = (lambda st=st, g=g: st(mbatch, g))
    ms = alternating_ms(fns, 3)
    mnet.load_state_dict(state0)
    out.update({f"mixed_{k.replace(' ', '_')}_ms": v for k, v in ms.items()})
    print(f"  mixed bf16 step batch {MIXED_BATCH} (Adam included): eager "
          f"{ms['eager auto']:.3f} ms, CUDA graph {ms['graph auto']:.3f} ms "
          f"({ms['eager auto'] / ms['graph auto']:.2f}x); graph with sym_slots 0 "
          f"{ms['graph 0']:.3f} ms (auto saves {ms['graph 0'] - ms['graph auto']:.3f} ms)")
    for name in ("eager auto", "graph auto"):
        fns[name]()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = top_device_kernels(prof, wall, f"one mixed step, {name}", 5)
        out[f"mixed_{name.split()[0]}_busy_share"] = busy / wall
    mnet.load_state_dict(state0)
    del fns, mcache
    bpipe = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0,
                                dtype=torch.bfloat16)
    btr_g = BatchTrainer(train_config(dtype="bfloat16", batch_size=MIXED_BATCH), pipe=bpipe)
    reset_launch_counts()
    _, info = btr_g.train_epoch(btr_g.init_state(), mixed_out["ds"],
                                torch.Generator().manual_seed(3))
    torch.cuda.synchronize()
    seen, caps = launch_counts(), btr_g.graphs.captures
    graph_launches["mixed_graphs"] = seen
    # each capture runs a step's program twice: 3 + 3 PoseNet launches, the
    # gather's backward and, unless its batch has no symmetric sample, one
    # ADD-S match
    print(f"  graphed BatchTrainer epoch: launch counters {seen}")
    if (seen != counts(mlp_head=6 * caps, upconv3x3_prelu=6 * caps,
                       gather_rows_backward=2 * caps, nn_match=seen["nn_match"])
            or not 0 < seen["nn_match"] <= 2 * caps):
        raise AssertionError(f"graphed mixed epoch: launch counters {seen} for "
                             f"{caps} captures")
    lg, le = torch.tensor(info["losses"]), torch.tensor(mixed_out["losses"])
    rel = float(((lg - le).abs() / le.abs()).max())
    print(f"  graphed BatchTrainer epoch ({MIXED_STEPS} mixed steps, "
          f"{btr_g.graphs.captures} captures) vs the eager epoch (phase mixed, same "
          f"seeds): losses {'bit-equal' if torch.equal(lg, le) else 'not bit-equal'}, "
          f"max rel {rel:.2e} (tol {EPOCH_TOL['loss']:g})")
    if rel > EPOCH_TOL["loss"]:
        raise AssertionError("graphed BatchTrainer epoch differs from the eager one")
    del btr_g, bpipe
    torch.cuda.empty_cache()

    # -- the graphs' key space over a full synthetic epoch of each trainer --
    kds = scene_dataset(KEY_FRAMES, 4)
    for name, kind, cfg, dtype in (
            ("FusedTrainer", FusedTrainer, train_config(), torch.float32),
            ("BatchTrainer", BatchTrainer,
             train_config(dtype="bfloat16", batch_size=MIXED_BATCH), torch.bfloat16)):
        out.update({f"{name}_{k}": v
                    for k, v in key_space_epochs(name, kind, cfg, dtype, kds).items()})
    del kds

    # -- remat at batch 32, f32, stage 1 --
    tnet = tkern.posenet
    t0_state = {k: v.clone() for k, v in tnet.state_dict().items()}
    res, losses = {}, {}
    for remat in (False, True):
        tnet.load_state_dict(t0_state)
        tnet.zero_grad(set_to_none=True)
        st = make_train_step(tkern, SYM_LIST, W, LR, remat=remat, sym_slots=NUM_SYM)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses[remat] = st.accumulate(
            batch, torch.Generator(device=DEVICE).manual_seed(3))[0].reshape(1)
        torch.cuda.synchronize()
        res[remat] = (state_of(tnet), (torch.cuda.max_memory_allocated() - base) / 2 ** 20)
    tnet.zero_grad(set_to_none=True)
    same_state(f"remat vs no remat, stage-1 step batch {TRAIN_BATCH} f32 (one "
               "accumulate from one state)", res[True][0], res[False][0],
               losses[True], losses[False], 0.0)
    steps = {"plain": make_train_step(tkern, SYM_LIST, W, LR, sym_slots=NUM_SYM),
             "remat": make_train_step(tkern, SYM_LIST, W, LR, remat=True,
                                      sym_slots=NUM_SYM)}
    ms = alternating_ms({k: (lambda k=k: steps[k](batch, torch.Generator(device=DEVICE)
                                                  .manual_seed(22))) for k in steps}, 2)
    tnet.load_state_dict(t0_state)
    out.update(remat_peak_mib=res[True][1], plain_peak_mib=res[False][1],
               remat_ms=ms["remat"], plain_step_ms=ms["plain"])
    print(f"  remat, stage-1 step batch {TRAIN_BATCH} f32: peak memory above the "
          f"state {res[False][1]:.1f} MiB without, {res[True][1]:.1f} MiB with "
          f"({100 * (1 - res[True][1] / res[False][1]):.1f}% less); step "
          f"{ms['plain']:.3f} ms without, {ms['remat']:.3f} ms with "
          f"({ms['remat'] / ms['plain']:.2f}x)")
    if not res[True][1] < res[False][1]:
        raise AssertionError("remat did not lower the step's peak memory")
    return graph_launches, out


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _set_tf32(cudnn, matmul):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


@phase("tf32")
def tf32_phase(kern):
    """The f32 estimate switches TF32 off itself; then the gap that switch
    closes: the f32 PoseNet at batch 128 with cuDNN TF32 on and off (the
    flags the process had set), its time and its best-hypothesis pose."""
    from plr2_tpu_torch.refine import initial_pose
    if kern.dtype != torch.float32:
        raise AssertionError("tf32 phase needs the f32 pipeline")
    inputs = main_inputs(BATCH)
    conv = next(m for m in kern.posenet.modules() if isinstance(m, torch.nn.Conv2d))
    seen = []
    hook = conv.register_forward_pre_hook(lambda m, a: seen.append(_tf32_flags()))
    est = {}
    try:
        for caller in (False, True):
            _set_tf32(caller, caller)
            est[caller] = kern.estimate(*inputs, refine_iterations=ITERS)
            if _tf32_flags() != (caller, caller):
                raise AssertionError("estimate did not restore the TF32 flags")
    finally:
        hook.remove()
        _set_tf32(False, False)
    gap = max(float((est[True].quat - est[False].quat).abs().max()),
              float((est[True].trans - est[False].trans).abs().max()))
    print(f"  f32 estimate with the caller's TF32 flags on: the convolutions "
          f"saw {sorted(set(seen))} (must be (False, False) only); pose "
          f"against flags off differs by {gap:.3e}")
    if set(seen) != {(False, False)}:
        raise AssertionError(f"the f32 estimate ran with TF32 flags {seen}")

    inputs = main_inputs(BATCH_BIG)
    out = {}
    for on in (False, True):
        torch.backends.cudnn.allow_tf32 = on
        try:
            with torch.no_grad():
                ms = time_ms(lambda: kern.posenet(*inputs), 3, warmup=1)
                pred_r, pred_t, pred_c, _ = kern.posenet(*inputs)
                q, t = initial_pose(pred_r, pred_t, pred_c, inputs[1])
        finally:
            torch.backends.cudnn.allow_tf32 = False
        out[on] = (ms, q, t, pred_c[..., 0].argmax(-1), pred_c)
    same = out[True][3] == out[False][3]
    dq = float((out[True][1] - out[False][1])[same].abs().max()) if same.any() else 0.0
    dt = float((out[True][2] - out[False][2])[same].abs().max()) if same.any() else 0.0
    dc = float((out[True][4] - out[False][4]).abs().max())
    print(f"  f32 PoseNet batch {BATCH_BIG}: cuDNN TF32 off {out[False][0]:.3f} ms, "
          f"on {out[True][0]:.3f} ms; {int(same.sum())}/{BATCH_BIG} frames pick "
          f"the same hypothesis, on those max |dq| {dq:.3e} max |dt| {dt:.3e}; "
          f"max |d confidence| {dc:.3e}")
    return {"off_ms": out[False][0], "on_ms": out[True][0], "same": int(same.sum()),
            "dq": dq, "dt": dt, "dconf": dc}


def head_features(pipe, batch):
    """The fused per-point features PoseNet feeds its heads, as
    `PoseNet.forward` computes them: (batch * NUM_POINTS, 1408) f32."""
    img, cloud, choose, _ = main_inputs(batch)
    with torch.no_grad():
        feat = pipe.posenet.feat(cloud, pipe.posenet.cnn(img, choose))
    return feat.reshape(-1, feat.shape[-1]).contiguous()


def head_layers(pipe, tag):
    """Head `tag`'s four (w (out, in), b) f32 layers of the seeded PoseNet."""
    layers = [getattr(pipe.posenet, f"conv{i}_{tag}") for i in range(1, 5)]
    return [(m.weight.detach().reshape(m.weight.shape[0], -1).contiguous(),
             m.bias.detach()) for m in layers]


def int_mm_library(x, qparams):
    """The int8 ladder as PyTorch library calls: torch._int_mm (cuBLASLt) on
    int8 codes and weights padded to 8 output columns, the quantise and
    dequantise as elementwise torch ops. A yardstick of speed only, never on
    the port's path."""
    padded = []
    for w, s, b in qparams:
        n, k = w.shape
        wp = torch.zeros(((n + 7) // 8 * 8, k), dtype=torch.int8, device=w.device)
        wp[:n] = w
        padded.append((wp.t(), s, b, n))  # (K, N8), column-major

    def run():
        h = x
        for i, (wt, s, b, n) in enumerate(padded):
            a = torch.clamp(h.abs().amax(1, keepdim=True) / 127.0, min=1e-12)
            codes = torch.clamp(torch.round(h / a), -127, 127).to(torch.int8)
            h = torch._int_mm(codes, wt)[:, :n].float() * a * s + b
            if i < len(padded) - 1:
                h = torch.relu(h)
        return h
    return run


@phase("quant")
def quant_phase():
    """The int8 head ladder on the seeded PoseNet's heads and features."""
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.ops import launch_counts, mlp_head, quant, reset_launch_counts
    pipe = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0)
    x = head_features(pipe, BATCH)
    heads = {tag: head_layers(pipe, tag) for tag in HEAD_OUT}
    qheads = {tag: quant.quantize_weights(layers) for tag, layers in heads.items()}
    print(f"  features {tuple(x.shape)}; heads "
          f"{[tuple(w.shape) for w, _, _ in qheads['r']]} int8 (r), K = "
          f"{[NUM_OBJ * od for od in HEAD_OUT.values()]}")

    # the path: the three ladders with the op's defaults (seed 0, stochastic)
    reset_launch_counts()
    outs = {tag: quant.quantized_mlp_head(x, q) for tag, q in qheads.items()}
    torch.cuda.synchronize()
    seen = launch_counts()
    print(f"  launches in one int8 head forward: {seen}")
    if seen != counts(quantized_mlp_head=3):
        raise AssertionError(f"expected 3 quantized_mlp_head launches, got {seen}")
    for tag, out in outs.items():
        if out.shape != (x.shape[0], NUM_OBJ * HEAD_OUT[tag]) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"int8 head {tag}: shape {tuple(out.shape)} or "
                                 "non-finite values")

    # 1. kernel against its plain version, both rounding modes, exact
    max_err, results = 0.0, {}
    for stochastic in (False, True):
        for tag, q in qheads.items():
            got = quant.quantized_mlp_head(x, q, QUANT_SEED, stochastic)
            torch.cuda.synchronize()
            ref = quant.quantized_mlp_head_plain(x, q, QUANT_SEED, stochastic)
            n_diff = int((got != ref).sum())
            err = float((got - ref).abs().max())
            max_err = max(max_err, err)
            results[(tag, stochastic)] = got
            print(f"  quantized_mlp_head {tag} stochastic={stochastic} "
                  f"{tuple(x.shape)}->{got.shape[1]}: {n_diff} of {got.numel()} "
                  f"outputs differ from the plain version, max |d| {err:.3e} "
                  f"(exact: must be 0) {'ok' if n_diff == 0 else 'FAIL'}")
            if n_diff:
                raise AssertionError("quantized_mlp_head disagrees with its "
                                     "plain version")
    # 2. the same seed twice gives the same draws, another seed others
    for tag, q in qheads.items():
        again = quant.quantized_mlp_head(x, q, QUANT_SEED, True)
        other = quant.quantized_mlp_head(x, q, QUANT_SEED + 1, True)
        moved = int((other != again).sum())
        print(f"  stochastic {tag}: seed {QUANT_SEED} twice identical "
              f"{torch.equal(again, results[(tag, True)])}; seed {QUANT_SEED + 1} "
              f"moves {moved} of {other.numel()} outputs")
        if not torch.equal(again, results[(tag, True)]) or moved == 0:
            raise AssertionError("stochastic rounding is not deterministic per seed")
    # 3. accuracy against the f32 head kernel (tests/test_quant.py's bounds)
    for tag, layers in heads.items():
        ref = mlp_head.mlp_head(x, layers)
        denom = torch.maximum(ref.abs(), ref.abs().mean())
        for stochastic in (False, True):
            rel = (results[(tag, stochastic)] - ref).abs() / denom
            med, mean = float(rel.median()), float(rel.mean())
            ok = med < QUANT_ACC["median"] and mean < QUANT_ACC["mean"]
            print(f"  int8 vs f32 head kernel {tag} stochastic={stochastic}: "
                  f"median rel err {med:.4f} (< {QUANT_ACC['median']}), mean "
                  f"{mean:.4f} (< {QUANT_ACC['mean']}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("int8 head too far from the f32 head")
    # 4. other depths, widths and row counts: tests/test_quant.py's ladder
    # at 40 rows, the ragged ladders at 977
    gen = torch.Generator().manual_seed(8)
    for rows, widths in [(QUANT_SMALL_ROWS, QUANT_SMALL)] + QUANT_RAGGED:
        ladder = quant.quantize_weights(
            [(_rand((o, i), gen, i ** -0.5), _rand((o,), gen, 0.05))
             for i, o in zip(widths[:-1], widths[1:])])
        xs = _rand((rows, widths[0]), gen)
        for stochastic in (False, True):
            got = quant.quantized_mlp_head(xs, ladder, QUANT_SEED, stochastic)
            torch.cuda.synchronize()
            ref = quant.quantized_mlp_head_plain(xs, ladder, QUANT_SEED, stochastic)
            n_diff = int((got != ref).sum())
            print(f"  quantized_mlp_head {widths} at {rows} rows, "
                  f"stochastic={stochastic}: {n_diff} outputs differ (exact) "
                  f"{'ok' if n_diff == 0 else 'FAIL'}")
            if n_diff:
                raise AssertionError(f"quantized_mlp_head disagrees with its "
                                     f"plain version on {widths} at {rows} rows")
    # 5. batch 128: the seeded heads on 128,000 rows of features
    xb = head_features(pipe, BATCH_BIG)
    for stochastic in (False, True):
        for tag, q in qheads.items():
            got = quant.quantized_mlp_head(xb, q, QUANT_SEED, stochastic)
            torch.cuda.synchronize()
            ref = quant.quantized_mlp_head_plain(xb, q, QUANT_SEED, stochastic)
            n_diff = int((got != ref).sum())
            max_err = max(max_err, float((got - ref).abs().max()))
            print(f"  quantized_mlp_head {tag} stochastic={stochastic} "
                  f"{tuple(xb.shape)}->{got.shape[1]}: {n_diff} of {got.numel()} "
                  f"outputs differ (exact) {'ok' if n_diff == 0 else 'FAIL'}")
            if n_diff:
                raise AssertionError("quantized_mlp_head disagrees with its "
                                     "plain version at batch 128")
            del got, ref
    del xb
    torch.cuda.empty_cache()
    return pipe, heads, qheads, seen, max_err


@phase("quant timing")
def quant_timing_phase(pipe, heads, qheads, seen, max_err):
    """Per forward (three ladders): the int8 kernel, the f32 and bf16 head
    kernels on the same rows, the plain version, a torch._int_mm chain and
    the H100's bound, at batch 8 and 128."""
    from plr2_tpu_torch.ops import mlp_head, quant
    entry = None
    for batch in (BATCH, BATCH_BIG):
        x = head_features(pipe, batch)
        rows = x.shape[0]
        t = {"ms": 0.0, "nearest_ms": 0.0, "f32_ms": 0.0, "bf16_ms": 0.0,
             "plain_ms": 0.0, "library_ms": 0.0, "ops": 0, "bytes": 0}
        per_launch = []
        xb = x.bfloat16()
        for tag, q in qheads.items():
            k = time_ms(lambda: quant.quantized_mlp_head(x, q), 10)
            per_launch.append(k)
            t["ms"] += k
            t["nearest_ms"] += time_ms(
                lambda: quant.quantized_mlp_head(x, q, stochastic=False), 10)
            t["f32_ms"] += time_ms(lambda: mlp_head.mlp_head(x, heads[tag]), 5)
            hb = [(w.bfloat16(), b.bfloat16()) for w, b in heads[tag]]
            t["bf16_ms"] += time_ms(lambda: mlp_head.mlp_head(xb, hb), 5)
            t["library_ms"] += time_ms(int_mm_library(x, q), 10)
            if batch == BATCH:
                t["plain_ms"] += time_ms(
                    lambda: quant.quantized_mlp_head_plain(x, q), 3, warmup=1)
            widths = (x.shape[1], *(w.shape[0] for w, _, _ in q))
            t["ops"] += mlp_head.flops(rows, widths)  # int8 multiply-adds x 2
            t["bytes"] += 4 * rows * (widths[0] + widths[-1]) + sum(
                w.numel() + 4 * (s.numel() + b.numel()) for w, s, b in q)
        ops_ms = t["ops"] / PEAK_FLOPS["int8"] * 1e3
        bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        print(f"  int8 heads batch {batch} ({rows} rows): kernel "
              f"{' + '.join(f'{v:.3f}' for v in per_launch)} = {t['ms']:.3f} ms "
              f"per forward ({t['ops'] / t['ms'] / 1e9:.1f} TOP/s; stochastic "
              f"rounding, the op's default), {t['nearest_ms']:.3f} ms rounding "
              f"to nearest; f32 head "
              f"kernel {t['f32_ms']:.3f} ms, bf16 {t['bf16_ms']:.3f} ms; "
              f"torch._int_mm chain {t['library_ms']:.3f} ms; "
              + (f"plain {t['plain_ms']:.3f} ms; " if batch == BATCH else "")
              + f"bound {bound:.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}"
              f": {t['bytes'] / 1e6:.1f} MB, {t['ops'] / 1e9:.1f} G int8 ops)")
        if batch == BATCH:
            entry = {
                "name": "quantized_mlp_head_int8", "route": "cuda",
                "source": QUANT_SOURCE[0], "replaces": QUANT_SOURCE[1],
                "launches": seen["quantized_mlp_head"],
                "launches_by_path": {"estimate_f32": 0, "estimate_bf16": 0,
                                     "train_stage1": 0, "train_refine": 0,
                                     "trainer": 0, "fused": 0, "mixed": 0,
                                     "quant": seen["quantized_mlp_head"]},
                "max_abs_err": max_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": bound,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": t["library_ms"], "nearest_ms": t["nearest_ms"],
                "f32_head_ms": t["f32_ms"], "bf16_head_ms": t["bf16_ms"]}
        else:
            entry.update({"ms_b128": t["ms"], "library_ms_b128": t["library_ms"],
                          "nearest_ms_b128": t["nearest_ms"],
                          "bound_ms_b128": bound, "f32_head_ms_b128": t["f32_ms"],
                          "bf16_head_ms_b128": t["bf16_ms"]})
        del x, xb
        torch.cuda.empty_cache()
    return entry



# ---------------- determinism of the train step (the gather's fixed-order
# backward, the PSP pooling and resize as products, cuDNN restricted to
# deterministic algorithms inside the step) ----------------


def twice(net, one_run):
    """`one_run()` (gradients into `net`'s .grad; returns the losses) twice
    from one state of `net`, each run followed by an Adam step from fresh
    moments. Returns the names of what differs between the two runs
    (gradients, parameters and BN buffers after the step, losses), the
    count of tensors compared and the largest relative L2 gap of a
    gradient."""
    from plr2_tpu_torch.parallel.data_parallel import adam
    state0 = {k: v.clone() for k, v in net.state_dict().items()}
    runs = []
    for _ in range(2):
        net.load_state_dict(state0)
        net.zero_grad(set_to_none=True)
        opt = adam(net, LR)
        losses = one_run()
        grads = {k: p.grad.clone() for k, p in net.named_parameters()
                 if p.grad is not None}
        opt.step()
        torch.cuda.synchronize()
        runs.append((losses, grads, {k: v.clone() for k, v in net.state_dict().items()}))
    net.load_state_dict(state0)
    net.zero_grad(set_to_none=True)
    (l1, g1, s1), (l2, g2, s2) = runs
    diff = ([f"grad {k}" for k in g1 if not torch.equal(g1[k], g2[k])]
            + [f"state {k}" for k in s1 if not torch.equal(s1[k], s2[k])]
            + ([] if torch.equal(l1, l2) else ["losses"]))
    gap = max(float((g1[k] - g2[k]).norm() / g2[k].norm().clamp(min=1e-30))
              for k in g1)
    return diff, len(g1) + len(s1), gap


def deterministic_warnings(fn):
    """The warnings of `fn()` under torch.use_deterministic_algorithms(True,
    warn_only=True): each names an op with no deterministic CUDA
    implementation. The switch is off again on return."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split("\n")[0][:150] for w in caught})


# kernel names that scatter, index or add by atomics (a step's profile is
# searched for them and they are printed)
SCATTER_WORDS = ("atomic", "scatter", "index_add", "indexing_backward",
                 "index_put", "upsample", "adaptive", "embedding_backward")


@phase("determinism")
def determinism_phase(tkern, batch, trainer_out, fused_out, mixed_out, launches):
    """The diagnostic (one stage-1 step under torch's determinism switch:
    the ops it names; the step's kernels that scatter), the gather's
    backward kernel against its plain version, bit for bit, then two runs
    each of a per-sample window, a fused window and a mixed bf16 step,
    which must be bit-equal; the step ms with cuDNN's deterministic
    restriction on and off."""
    import contextlib
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from plr2_tpu_torch.ops import gather
    from plr2_tpu_torch.parallel import data_parallel as dp
    from plr2_tpu_torch.train.trainer import sample_batch
    net = tkern.posenet
    state0 = {k: v.clone() for k, v in net.state_dict().items()}
    step = dp.TrainStep(tkern, SYM_LIST, W, sym_slots=NUM_SYM)

    def one_step():
        step.accumulate(batch, torch.Generator(device=DEVICE).manual_seed(3))

    named = deterministic_warnings(one_step)
    print(f"  diagnostic, one stage-1 step (batch {TRAIN_BATCH}) under "
          f"torch.use_deterministic_algorithms(True, warn_only=True): "
          f"{len(named)} ops named {named}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_step()
        torch.cuda.synchronize()
    net.load_state_dict(state0)
    net.zero_grad(set_to_none=True)
    kernels = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    scatter = sorted(k[:120] for k in kernels
                     if any(w in k.lower() for w in SCATTER_WORDS))
    # what is left writes each address once: torch.gather's forward and
    # its scatter_add backward in PoseNet's selection of the query object's
    # rows (one value a destination), and the sorted-segment backward of
    # the loss's row indexing (indexing_backward_kernel); the repeat runs
    # below hold the step to bit-equality
    print(f"  the step's {len(kernels)} distinct CUDA kernels; those that "
          f"scatter or index: {scatter or 'none'} (each address written once "
          "or in a fixed order: the object-row selection and the loss's row "
          "indexing)")

    # for the record: the ops that the step ran before this repair, at
    # their shapes in this step, name themselves under the switch
    def replaced():
        x = torch.randn((TRAIN_BATCH, 512, 20, 20), device=DEVICE,
                        requires_grad=True)
        y = sum(F.interpolate(F.adaptive_avg_pool2d(x, s), (20, 20),
                              mode="bilinear", align_corners=False)
                for s in (1, 2, 3, 6))
        p = torch.randn((TRAIN_BATCH, CROP * CROP, 64), device=DEVICE,
                        requires_grad=True)
        g = torch.gather(p, 1, batch["choose"][..., None].expand(-1, -1, 64))
        (y.sum() + g.sum()).backward()
    print(f"  the same switch on the replaced ops (AdaptiveAvgPool2d, bilinear "
          f"F.interpolate, torch.gather) at this step's shapes names "
          f"{deterministic_warnings(replaced)} (an op that has a deterministic "
          f"kernel takes it under the switch without a word; without the switch "
          f"these backward passes add by atomics)")
    if named:
        raise AssertionError(f"determinism: the step runs ops without a "
                             f"deterministic path: {named}")

    # the gather's backward kernel against its plain version on CPU copies
    # (index_add_ on the CPU adds in ascending n, the kernel's order), on
    # the step's own indices and on indices that repeat half of each row
    idx = batch["choose"]
    hw = CROP * CROP
    rep = idx.clone()
    rep[:, NUM_POINTS // 2:] = rep[:, :NUM_POINTS - NUM_POINTS // 2]
    gen = torch.Generator().manual_seed(17)
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        ct = torch.randn((TRAIN_BATCH, NUM_POINTS, 64), generator=gen).to(dt)
        for which, ind in (("step", idx), ("repeated", rep)):
            got = gather.gather_rows_backward(ct.to(DEVICE), ind, hw)
            torch.cuda.synchronize()
            ref = gather.gather_rows_backward_plain(ct, ind.cpu(), hw)
            err = max(err, float((got.cpu().float() - ref.float()).abs().max()))
            if not torch.equal(got.cpu(), ref):
                raise AssertionError(f"gather_rows_backward {dt} ({which} "
                                     "indices) differs from its plain version")
    print(f"  gather_rows_backward at {(TRAIN_BATCH, NUM_POINTS, 64)} -> "
          f"{(TRAIN_BATCH, hw, 64)}, f32 and bf16, the step's indices and "
          "half-repeated ones: bit-equal to the plain version ok")
    ct = torch.randn((TRAIN_BATCH, NUM_POINTS, 64), generator=gen).to(DEVICE)
    k_ms = time_ms(lambda: gather.gather_rows_backward(ct, idx, hw), 20)
    p_ms = time_ms(lambda: gather.gather_rows_backward_plain(ct, idx, hw), 20)
    rows = (idx + torch.arange(TRAIN_BATCH, device=DEVICE)[:, None] * hw).reshape(-1)
    flat = ct.reshape(-1, 64)
    lib_ms = time_ms(lambda: torch.zeros((TRAIN_BATCH * hw, 64), device=DEVICE)
                     .index_add_(0, rows, flat), 20)
    bound = gather.bytes_moved(TRAIN_BATCH, NUM_POINTS, hw, 64, 4) / HBM_BYTES_PER_S * 1e3
    by_path = {pth: launches[pth]["gather_rows_backward"] for pth in (
        "train_stage1", "train_refine", "trainer", "fused", "mixed",
        "fused_graphs", "mixed_graphs")}
    print(f"  gather_rows_backward f32 (stable sort + the segment kernel, dy "
          f"zeroed): {k_ms:.4f} ms, plain (index_add_ by atomics) {p_ms:.4f} "
          f"ms, library index_add_ {lib_ms:.4f} ms, bound {bound:.4f} ms "
          f"(bytes); launches {by_path}")
    entry = {"name": "gather_rows_backward", "route": "cuda",
             "source": GATHER_SOURCE[0], "replaces": GATHER_SOURCE[1],
             "launches": sum(by_path.values()), "launches_by_path": by_path,
             "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
             "note": "a repair kernel (deterministic backward of the choose "
                     "gather), not the port of a pallas_call"}

    # two runs each, from one state: bit-equal or fail
    ds = trainer_out["train_ds"]
    pipe = trainer_out["stage1"].pipe
    from plr2_tpu_torch.train import Trainer
    tr = Trainer(train_config(), pipe=pipe)
    samples = list(tr._sample_iter(ds, torch.Generator().manual_seed(15),
                                   add_noise=True, shuffle=False, seed=0))[:WINDOW]

    def per_sample():
        st = dp.TrainStep(pipe, SYM_LIST, W)
        gen = torch.Generator().manual_seed(9)
        return torch.stack([st.accumulate(sample_batch(s), gen)[0] for s in samples])

    from plr2_tpu_torch.train import make_fused_window_grads
    ftr, win = fused_out["ftr"], fused_out["win"]
    window = make_fused_window_grads(ftr.pipe, SYM_LIST, W, graphs=False)

    def fused():
        return window(win, torch.Generator().manual_seed(9))[0]

    btr = mixed_out["btr"]
    msamples = list(btr._sample_iter(mixed_out["ds"], torch.Generator().manual_seed(13),
                                     add_noise=True, shuffle=False, seed=0))
    mbatch = btr._stack_eval(msamples[:MIXED_BATCH])
    mstep = dp.TrainStep(btr.pipe, SYM_LIST, W, sym_slots=btr._sym_slots())

    def mixed():
        return mstep.accumulate(mbatch, torch.Generator().manual_seed(9))[0]

    crops = sorted({tuple(s.img.shape[:2]) for s in samples})
    for what, netw, fn in (
            (f"per-sample window of {WINDOW} (f32, crops {crops})", pipe.posenet, per_sample),
            (f"fused window of {WINDOW} (f32, {win['img'].shape[1]} px canvas)",
             ftr.pipe.posenet, fused),
            (f"mixed bf16 step, batch {MIXED_BATCH} ({mbatch['img'].shape[1]} px canvas)",
             btr.pipe.posenet, mixed)):
        diff, n, _ = twice(netw, fn)
        print(f"  {what}, run twice from one state: {n - len(diff)}/{n} "
              f"gradient, parameter and BN tensors bit-equal, losses "
              f"{'equal' if 'losses' not in diff else 'DIFFER'} "
              f"{'ok' if not diff else 'FAIL ' + str(diff[:5])}")
        if diff:
            raise AssertionError(f"determinism: two runs of the {what} differ")

    # what cuDNN's deterministic restriction does: two runs of the stage-1
    # step at batch 32 with it (bit-equal or fail) and without it (for the
    # record), then the step's ms with it and without it, in turns
    def step32():
        return dp.TrainStep(tkern, SYM_LIST, W, sym_slots=NUM_SYM).accumulate(
            batch, torch.Generator(device=DEVICE).manual_seed(3))[0][None]
    orig = dp.deterministic_convs
    dp.deterministic_convs = contextlib.nullcontext
    try:
        loose, n, loose_gap = twice(net, step32)
    finally:
        dp.deterministic_convs = orig
    strict, _, _ = twice(net, step32)
    print(f"  stage-1 step batch {TRAIN_BATCH} run twice from one state: with "
          f"cuDNN restricted to deterministic algorithms {n - len(strict)}/{n} "
          f"tensors bit-equal; without the restriction {n - len(loose)}/{n} "
          f"(gradients up to {loose_gap:.2e} relative L2 apart) "
          f"{'ok' if not strict else 'FAIL'}")
    if strict:
        raise AssertionError(f"determinism: two runs of the stage-1 step differ: "
                             f"{strict[:5]}")
    cost = {"on": [], "off": []}
    step1 = dp.make_train_step(tkern, SYM_LIST, W, LR, sym_slots=NUM_SYM)
    for label in ("on", "off", "off", "on"):
        orig = dp.deterministic_convs
        if label == "off":
            dp.deterministic_convs = contextlib.nullcontext
        try:
            cost[label].append(step_ms(step1, batch, 5))
        finally:
            dp.deterministic_convs = orig
    net.load_state_dict(state0)
    on, off = sum(cost["on"]) / 2, sum(cost["off"]) / 2
    print(f"  stage-1 step f32 batch {TRAIN_BATCH}: {cost['on']} ms with cuDNN "
          f"restricted to deterministic algorithms (the port's step), "
          f"{cost['off']} ms without: the restriction costs {on - off:.3f} ms "
          f"({100 * (on - off) / off:.1f}%); before the determinism repair "
          f"{BEFORE_MS['stage1']} ms")
    return entry, {"det_on_ms": on, "det_off_ms": off, "gather_ms": k_ms}


# ---------------- evaluation (ADD / ADD-S, the VOCap AUC) ----------------


def recording(pipe):
    """Record each PoseNet call's per-point confidences (B, N) of `pipe`:
    which hypothesis each sample's estimate picks."""
    seen = []
    run = pipe.run_posenet

    def recorded(*a, **k):
        out = run(*a, **k)
        seen.append(out[2][..., 0].float())
        return out
    pipe.run_posenet = recorded
    return seen


def sample_order(res, objs):
    """An EvalResult's distances in sample order (objects in `objs`)."""
    pos = {o: 0 for o in res.per_object_distances}
    out = []
    for o in objs:
        out.append(res.per_object_distances[o][pos[o]])
        pos[o] += 1
    return out


def rate_gap(dists, threshold, tol):
    """The share of samples within `tol` of `threshold`: how far a rate
    may move when each distance moves by at most `tol`."""
    return sum(abs(d - threshold) <= tol for d in dists) / max(len(dists), 1)


@phase("eval")
def eval_phase():
    """`evaluate` per-crop and batched, f32 and bf16, at YCB width on
    held-out library frames: launch counts per run, kernels vs plain
    versions on every sample's distance and on each EvalResult field, and
    samples/s (host clock around a synchronised evaluate, data path
    included, after a first run that warms each crop shape)."""
    import numpy as np
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.eval import evaluate
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    ds = scene_dataset(EVAL_FRAMES, 3)
    n = len(ds)
    objs = [ds.items[i]["obj"] - 1 for i in range(n)]
    crops = crop_shapes(ds)
    radius = max(float(np.sqrt((m.astype(np.float64) ** 2).sum(1)).max())
                 for m in ds.models.values())
    # a pose within the estimate gate e (every |dq|, |dt| <= e) moves a
    # distance by at most |dt| + ||dR|| r <= e (sqrt(3) + 4 sqrt(2) r) for
    # points within r of the origin (||R(q) - R(p)|| <= 2 sqrt(2) |q - p|)
    dis_tol = {d: POSE_TOL[d] * (3 ** 0.5 + 4 * 2 ** 0.5 * radius) for d in POSE_TOL}
    print(f"  {n} samples ({sum(o in SYM_LIST for o in objs)} symmetric), crops "
          f"{sorted(set(crops))}; distance tolerance kernels vs plain "
          f"{ {d: round(v, 6) for d, v in dis_tol.items()} } m (POSE_TOL x "
          f"(sqrt 3 + 4 sqrt 2 x {radius:.4f} m))")
    kern = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0)
    plain = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, use_kernels=False,
                                device=DEVICE, seed=0)
    rates, launches = {}, {}
    kw = dict(sym_list=SYM_LIST, refine_iterations=ITERS,
              diameters=ds.diameters, crop_canvas=EVAL_CANVAS, seed=4)
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if dtype != torch.float32:
            kern.cast(dtype)
            plain.cast(dtype)
        total = counts()
        for mode, bs in (("per_crop", 1), ("batched", EVAL_BATCH)):
            fwd = n if bs == 1 else -(-n // bs)
            conf_k = recording(kern)
            reset_launch_counts()
            res_k = evaluate(kern, ds, batch_size=bs, **kw)
            torch.cuda.synchronize()
            seen = launch_counts()
            del kern.run_posenet
            if seen != counts(mlp_head=3 * fwd, upconv3x3_prelu=3 * fwd):
                raise AssertionError(f"eval {mode} {dt_name}: expected {fwd} PoseNet "
                                     f"forwards' launches, got {seen}")
            total = {k: total[k] + seen[k] for k in total}
            t0 = time.perf_counter()
            again = evaluate(kern, ds, batch_size=bs, **kw)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            rates[f"{mode}_{dt_name}"] = n / s
            conf_p = recording(plain)
            reset_launch_counts()
            res_p = evaluate(plain, ds, batch_size=bs, **kw)
            del plain.run_posenet
            if launch_counts() != counts():
                raise AssertionError("eval: the plain pipeline launched a kernel")
            # which hypothesis each sample picked, and the confidence gap
            # where the two runs picked different ones
            ck, cp = torch.cat(conf_k), torch.cat(conf_p)
            rows = torch.arange(ck.shape[0], device=ck.device)
            ik, ip = ck.argmax(-1), cp.argmax(-1)
            same = (ik == ip).cpu()
            gap = float((ck[rows, ik] - ck[rows, ip]).abs().max())
            dk, dp_ = sample_order(res_k, objs), sample_order(res_p, objs)
            dd = max((abs(a - b) for a, b, ok in zip(dk, dp_, same) if ok), default=0.0)
            tol = dis_tol[dt_name]
            flips = int((~same).sum())
            bad = []
            if dt_name == "f32" and flips:
                bad.append(f"{flips} hypotheses flipped")
            if gap > CONF_TIE[dt_name]:
                bad.append(f"picked hypotheses {gap:.2e} apart in confidence")
            if dd > tol:
                bad.append(f"distance gap {dd:.3e}")
            if (res_k.num_samples, res_k.lost_detections) != (n, 0) or \
                    (res_p.num_samples, res_p.lost_detections) != (n, 0):
                bad.append("sample counts")
            if sample_order(again, objs) != dk:
                bad.append("the timed run's distances differ from the first run's")
            if not flips:
                thr = [0.1 * ds.diameters[o] for o in objs]
                near = sum(abs(d - t) <= tol for d, t in zip(dp_, thr)) / n
                checks = {
                    "mean_distance": (res_k.mean_distance, res_p.mean_distance, tol),
                    "auc": (res_k.auc, res_p.auc, 1000 * tol),
                    "under_2cm": (res_k.under_2cm, res_p.under_2cm,
                                  rate_gap(dp_, 0.02, tol)),
                    "mean_success": (res_k.mean_success, res_p.mean_success, near),
                }
                for o in res_p.per_object_auc:
                    checks[f"auc[{o}]"] = (res_k.per_object_auc[o],
                                           res_p.per_object_auc[o], 1000 * tol)
                bad += [f"{k} {a} vs {b}" for k, (a, b, t) in checks.items()
                        if abs(a - b) > t]
            print(f"  evaluate {mode} {dt_name} ({fwd} estimates): launches {seen}; "
                  f"{n / s:.1f} samples/s ({s:.3f} s); kernels vs plain: "
                  f"{n - flips}/{n} same hypothesis (others within {gap:.2e}), "
                  f"max distance gap {dd:.3e} m (tol {tol:.3e}), AUC "
                  f"{res_k.auc:.4f} / {res_p.auc:.4f}, <2cm {res_k.under_2cm:.4f} / "
                  f"{res_p.under_2cm:.4f}, mean distance {res_k.mean_distance:.6f} / "
                  f"{res_p.mean_distance:.6f} m {'ok' if not bad else 'FAIL'}")
            if bad:
                raise AssertionError(f"eval {mode} {dt_name}: {bad}")
        launches[f"eval_{dt_name}"] = total
    del kern, plain
    torch.cuda.empty_cache()
    return launches, rates


@phase("eval entry")
def eval_entry_phase():
    """The train -> eval -> report chain of CLIs on the card (wall time of
    each process), and the report's table against the same evaluation run
    in this process: equal."""
    import tempfile
    from plr2_tpu_torch.eval.report import load_distance_report
    from plr2_tpu_torch.tools import eval_linemod
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        model, dist, table = (str(Path(tmp) / n) for n in ("linemod", "d.json", "t.json"))
        eval_args = ["--synthetic", "--model", model, "--refine_iterations", "4"]
        for name, args in (
                ("train", ["--synthetic", "--nepoch", "1", "--outf", tmp,
                           "--log_dir", tmp]),
                ("eval_linemod", [*eval_args, "--save_distances", dist]),
                ("plot_accuracy", ["--distances", dist, "--json", table])):
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", f"plr2_tpu_torch.tools.{name}",
                                  *args], cwd=ROOT, capture_output=True, text=True,
                                 timeout=600)
            walls[name] = time.perf_counter() - t0
            if res.returncode != 0:
                raise AssertionError(f"{name} CLI failed: {res.stderr[-3000:]}")
            for line in (res.stdout + res.stderr).splitlines():
                if any(w in line for w in ("epoch 1:", "mean success", "loaded",
                                           "all ", "object")):
                    print(f"  {name}: {line}")
        rows = {r["object"]: r for r in json.loads(Path(table).read_text())}
        per_obj, _ = load_distance_report(dist)
        ref, _ = eval_linemod.run(eval_linemod.parse_args(eval_args))
    # the distances bit for bit; the aggregates to float64 rounding (the
    # table sums objects in sorted order, EvalResult in sample order)
    def close(a, b):
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-15)
    bad = []
    if per_obj != ref.per_object_distances:
        bad.append("distances")
    every = rows["all"]
    if every["count"] != ref.num_samples or not all(close(a, b) for a, b in (
            (every["auc"], ref.auc), (every["mean_distance"], ref.mean_distance),
            (every["under_2cm"], ref.under_2cm),
            (every["success_01d"], ref.mean_success))):
        bad.append(f"all: {every}")
    for obj, auc in ref.per_object_auc.items():
        if not (close(rows[obj]["auc"], auc) and close(
                rows[obj]["success_01d"], ref.per_object_success[obj])):
            bad.append(f"object {obj}: {rows[obj]}")
    print(f"  CLI walls (process start included): "
          f"{ {k: round(v, 2) for k, v in walls.items()} } s; the table "
          f"(AUC {every['auc']:.4f}, {every['count']} samples) equals the "
          f"same evaluation in this process {'ok' if not bad else 'FAIL'}")
    if bad:
        raise AssertionError(f"eval entry: the report differs from EvalResult: {bad}")
    return walls


# ---------------- frame serving (plr2_tpu_torch/serving.py) ----------------


def serve_scene(seed, wrap=False):
    """make_scene's frame of SERVE_K objects (500-point meshes), as the
    serve CLI builds it, with its poses. wrap=True keeps depth on every
    third row and every other column only: each mask then holds 300-800
    pixels, under SERVE_POINTS (the wrap-sampling path); the full frames'
    1,800-4,700 pixels take the subsample path."""
    import numpy as np
    from plr2_tpu_torch.data.synthetic import make_scene
    frame, models = make_scene(num_objects=SERVE_K, model_points=SERVE_MESH,
                               seed=seed)
    depth = frame.depth.astype(np.float32)
    if wrap:
        keep = np.zeros_like(depth, bool)
        keep[::3, ::2] = True
        depth = np.where(keep, depth, 0.0).astype(np.float32)
    return frame, models, depth


def serve_inputs(frame, models, depth, obj_ids):
    """The device tensors of one frame's `run` call (all slots' meshes and
    ground-truth poses; inactive or absent ids take object 1's)."""
    import numpy as np
    ids = [int(o) for o in obj_ids]
    pick = [o if o in frame.poses else 1 for o in ids]
    intr = [frame.intrinsics[k] for k in ("cx", "cy", "fx", "fy", "cam_scale")]
    out = (torch.from_numpy(frame.color), torch.from_numpy(depth),
           torch.from_numpy(frame.label.astype(np.int32)), torch.tensor(ids),
           torch.from_numpy(np.stack([models[o] for o in pick])).float(),
           torch.tensor(intr, dtype=torch.float32))
    tr = torch.from_numpy(np.stack([frame.poses[o][0] for o in pick])).float()
    tt = torch.from_numpy(np.stack([frame.poses[o][1] for o in pick])).float()
    return [t.to(DEVICE) for t in out], tr.to(DEVICE), tt.to(DEVICE)


def serve_host_chain(pipe, frame, models, depth, obj_ids, words):
    """The port's host chain on the card: host bbox -> raw_to_sample (the
    same key words) -> stack_samples on the canvas -> estimate."""
    from plr2_tpu_torch.data import Draws, raw_to_sample, stack_samples
    samples = []
    for o, kw in zip(obj_ids, words.tolist()):
        raw = dict(color=frame.color, depth=depth,
                   mask=(frame.label == o) & (depth > 0),
                   target_r=frame.poses[o][0], target_t=frame.poses[o][1],
                   model_points=models[o], obj_idx=o - 1,
                   intrinsics=frame.intrinsics)
        draws = Draws(tuple(kw), torch.ones(4), torch.arange(4), torch.zeros(3))
        samples.append(raw_to_sample(raw, draws, pipe.num_points, device=DEVICE))
    batch = stack_samples(samples, crop=SERVE_CANVAS)
    return batch, pipe.estimate(batch.img, batch.points, batch.choose,
                                batch.idx, refine_iterations=SERVE_ITERS)


def same_poses(what, dt_name, got, ref, conf_got, conf_ref, gated=True):
    """got vs ref FramePoses of the same slots: valid equal; each slot picks
    the same best hypothesis, or one within CONF_TIE of it in `conf_got`;
    |dq|, |dt| within POSE_TOL where the hypothesis is the same. Not
    `gated`: printed only."""
    ik, ip = conf_got.argmax(-1), conf_ref.argmax(-1)
    same = ik == ip
    rows = torch.arange(ik.shape[0], device=ik.device)
    gap = float((conf_got[rows, ik] - conf_got[rows, ip]).abs().max())
    dq = (got.quat.float() - ref.quat.float()).reshape(-1, 4)[same]
    dt = (got.trans.float() - ref.trans.float()).reshape(-1, 3)[same]
    dq = float(dq.abs().max()) if same.any() else 0.0
    dt = float(dt.abs().max()) if same.any() else 0.0
    ok = (torch.equal(got.valid, ref.valid) and gap <= CONF_TIE[dt_name]
          and dq <= POSE_TOL[dt_name] and dt <= POSE_TOL[dt_name])
    verdict = ("ok" if ok else "FAIL") if gated else "not gated"
    print(f"  {what} {dt_name}: valid equal {torch.equal(got.valid, ref.valid)}; "
          f"{int(same.sum())}/{same.numel()} slots pick the same hypothesis "
          f"(others within {gap:.2e}); max |dq| {dq:.3e} max |dt| {dt:.3e} "
          f"(tol {POSE_TOL[dt_name]:g}) {verdict}")
    if gated and not ok:
        raise AssertionError(f"serve: {what} {dt_name} disagree")
    return dq, dt


def recorded_conf(pipe, fn):
    """fn()'s result and the per-point confidences of every PoseNet call it
    made through `pipe`, concatenated over calls."""
    seen = recording(pipe)
    try:
        out = fn()
    finally:
        del pipe.run_posenet
    return out, torch.cat(seen)


def port_kernel_counts(prof, names=(*TC_KERNELS.values(), *F32_KERNELS.values())):
    """Launches by CUDA kernel of the port's kernels `names` (by a substring
    of their names; by default the head and decoder kernels: f32
    head_sgemm_kernel once a layer, bf16 one mlp_head_wgmma_kernel a
    ladder) in a profile."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for n in names:
                if n in e.key:
                    out[n] = out.get(n, 0) + e.count
    return out


@phase("serve")
def serve_phase():
    """FrameEstimator at YCB width (21 objects, 1000 points, 500-point
    meshes, K = 5 slots, canvas 240, 4 refine iterations) on make_scene
    frames: the device bbox against the host bbox; CUDA's stable sorts and
    the batched choose against the CPU's; run_with_samples against the
    port's host chain on the card (wrap and subsample paths); graph replay
    against eager (f32 and bf16, run and run_frames); the kernels against a
    use_kernels=False pipeline; run_frames against F separate runs;
    valid / oversized slots; the launch counts of an eager run and the
    kernels of one replay's profile; an eager run under
    torch.cuda.set_sync_debug_mode("error")."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.data import bbox as t_bbox
    from plr2_tpu_torch.data import preprocess as t_pre
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    from plr2_tpu_torch.serving import FrameEstimator, frame_key_words

    scenes = [serve_scene(s) for s in range(SERVE_F)]
    ids = np.arange(1, SERVE_K + 1)

    # 1. the device bbox vs the host bbox: every object of the frames, an
    # empty mask, masks on the edges and corners, and windows larger than
    # the canvas, on the canvas-padded mask as the program pads it
    masks = [(fr.label == o) & (d > 0) for fr, _, d in scenes for o in ids]
    h, w = masks[0].shape
    for r0, c0, rh, cw in ((0, 0, 0, 0), (0, 0, 23, 31), (455, 600, 25, 40),
                           (0, 610, 50, 30), (470, 0, 10, 300),
                           (100, 100, 300, 260), (0, 0, 480, 640)):
        m = np.zeros((h, w), bool)
        m[r0:r0 + rh, c0:c0 + cw] = True
        masks.append(m)
    padded = torch.from_numpy(np.pad(np.stack(masks), ((0, 0), (0, SERVE_CANVAS),
                                                       (0, SERVE_CANVAS)))).to(DEVICE)
    got = torch.stack(t_bbox.device_bbox_from_mask(padded, h, w), -1).tolist()
    want = [list(t_bbox.get_bbox_from_mask(m, h, w)) for m in masks]
    over = sum(max(b[1] - b[0], b[3] - b[2]) > SERVE_CANVAS for b in want)
    print(f"  device bbox vs host bbox on {len(masks)} masks ({over} windows "
          f"larger than the canvas): {'equal' if got == want else 'FAIL'}")
    if got != want:
        raise AssertionError("serve: the device bbox differs from the host bbox")

    # 2. CUDA's stable sorts break ties toward the lowest index, as the
    # CPU's do (the JAX contract of sample_choose), and the batched choose
    # on the card equals the CPU's at the canvas size
    g = torch.Generator().manual_seed(5)
    keys = torch.randint(0, 50, (SERVE_K, SERVE_CANVAS ** 2), generator=g)
    sorts_ok = all(torch.equal(torch.sort(keys.to(DEVICE), dim=-1, descending=d,
                                          stable=True).indices.cpu(),
                               torch.sort(keys, dim=-1, descending=d,
                                          stable=True).indices)
                   for d in (False, True))
    cm = torch.zeros((SERVE_K, SERVE_CANVAS ** 2), dtype=torch.bool)
    for row, n in enumerate((0, 600, SERVE_POINTS, 1001, 20000)):
        cm[row, torch.randperm(SERVE_CANVAS ** 2, generator=g)[:n]] = True
    kw = torch.randint(0, 2 ** 32, (SERVE_K, 2), generator=g)
    choose_ok = torch.equal(t_pre.sample_choose_batch(
        cm.to(DEVICE), SERVE_POINTS, kw.to(DEVICE), width=SERVE_CANVAS).cpu(),
        t_pre.sample_choose_batch(cm, SERVE_POINTS, kw, width=SERVE_CANVAS))
    print(f"  stable sorts of {tuple(keys.shape)} int64 with ties, CUDA vs CPU: "
          f"{'equal' if sorts_ok else 'FAIL'}; batched choose (0, 600, 1000, "
          f"1001, 20000 pixels) CUDA vs CPU: {'equal' if choose_ok else 'FAIL'}")
    if not (sorts_ok and choose_ok):
        raise AssertionError("serve: CUDA's sort or choose differs from the CPU's")

    kern = DenseFusionPipeline(SERVE_POINTS, NUM_OBJ, device=DEVICE, seed=0)
    plain = DenseFusionPipeline(SERVE_POINTS, NUM_OBJ, use_kernels=False,
                                device=DEVICE, seed=0)
    est = {g: FrameEstimator(kern, canvas=SERVE_CANVAS, refine_iterations=SERVE_ITERS,
                             graphs=g) for g in (False, True)}
    frames = [serve_inputs(fr, m, d, ids)[0] for fr, m, d in scenes]
    stacked = [torch.stack(x) for x in zip(*frames)]
    seeds = torch.arange(SERVE_F, device=DEVICE)
    launches, profiles, gaps = {}, {}, {}
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if dtype != torch.float32:
            kern.cast(dtype)
            plain.cast(dtype)
        eager, graph = est[False], est[True]

        # 3. the serving path vs the port's host chain, wrap and subsample
        for regime in ("wrap", "subsample"):
            fr, models, depth = serve_scene(0, wrap=regime == "wrap")
            counts_ = [int(((fr.label == o) & (depth > 0)).sum()) for o in ids]
            inputs, tr, tt = serve_inputs(fr, models, depth, ids)
            poses, sam = eager.run_with_samples(*inputs, 0, target_r=tr,
                                                target_t=tt)
            words = frame_key_words(torch.tensor(0), torch.from_numpy(ids))
            batch, ref = serve_host_chain(kern, fr, models, depth, ids, words)
            eq = {f: torch.equal(getattr(sam, f), getattr(batch, f))
                  for f in ("choose", "points", "img", "target", "idx")}
            eq.update({f: torch.equal(getattr(poses, f), getattr(ref, f))
                       for f in ("quat", "trans", "confidence")})
            gp, gs = graph.run_with_samples(*inputs, 0, target_r=tr, target_t=tt)
            eq["graph"] = all(torch.equal(a, b) for a, b in zip(
                (*gp, *gs), (*poses, *sam)))
            ok = all(eq.values()) and bool(poses.valid.all())
            print(f"  run_with_samples {dt_name} {regime} (pixels {counts_}, "
                  f"{SERVE_POINTS} points) vs the host chain: "
                  f"{ {k: v for k, v in eq.items()} } {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"serve {dt_name} {regime}: the serving path "
                                     "differs from the host chain")

        # 4. launches of an eager run and an eager run_frames (one PoseNet
        # forward each); the kernels of one replay's profile vs an eager one
        reset_launch_counts()
        one = eager.run(*frames[0], 0)
        torch.cuda.synchronize()
        seen_run = launch_counts()
        frames_eager = eager.run_frames(*stacked, seeds)
        torch.cuda.synchronize()
        seen = launch_counts()
        print(f"  launches in one eager run ({dt_name}): {seen_run}; with one "
              f"eager run_frames (F = {SERVE_F}): {seen}")
        if seen_run != counts(mlp_head=3, upconv3x3_prelu=3) or \
                seen != counts(mlp_head=6, upconv3x3_prelu=6):
            raise AssertionError("serve: expected 3 mlp_head + 3 upconv3x3_prelu "
                                 "launches per PoseNet forward")
        launches[f"serve_{dt_name}"] = seen
        graph.run(*frames[0], 0)  # capture (warm-up launches counted there)
        for name, fn in (("eager run", lambda: eager.run(*frames[0], 0)),
                         ("graph replay", lambda: graph.run(*frames[0], 0))):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            profiles[(dt_name, name)] = port_kernel_counts(prof)
        pe, pg = profiles[(dt_name, "eager run")], profiles[(dt_name, "graph replay")]
        print(f"  the port's kernels in one run's profile ({dt_name}): eager {pe}, "
              f"one graph replay {pg} {'ok' if pe == pg and pe else 'FAIL'}")
        if pe != pg or not pe:
            raise AssertionError("serve: a replay does not launch the kernels of "
                                 "an eager run")

        # 5. graph replay vs eager, bit for bit (run on every frame, then
        # run_frames)
        bad = [i for i, f in enumerate(frames) if not all(
            torch.equal(a, b) for a, b in zip(graph.run(*f, i), eager.run(*f, i)))]
        frames_graph = graph.run_frames(*stacked, seeds)
        fr_eq = all(torch.equal(a, b) for a, b in zip(frames_graph, frames_eager))
        print(f"  graph replay vs eager ({dt_name}): run on {SERVE_F} frames "
              f"{'bit-equal' if not bad else f'DIFFER on {bad}'}, run_frames "
              f"{'bit-equal' if fr_eq else 'DIFFER'}")
        if bad or not fr_eq:
            raise AssertionError(f"serve {dt_name}: graph replay differs from eager")

        # 6. kernels vs plain versions, and run_frames vs F separate runs,
        # after 0, 2 (the estimate's configuration, where POSE_TOL was set)
        # and 4 (the served default) refine iterations. The refiner runs no
        # port kernel: it carries the PoseNet's gap on, and with seeded
        # weights it amplifies bf16 rounding (measured on an H100 80GB HBM3
        # at 700 W, kernels vs plain: |dt| 7.8e-3 after 0 iterations, 4.4e-2
        # after 2, 1.3e-1 after 4, on translations up to 3.5 m), so bf16 is
        # gated up to 2 iterations and printed at 4; f32 is gated at all
        for iters in (0, ITERS, SERVE_ITERS):
            gated = dt_name == "f32" or iters <= ITERS
            ek, ep = (FrameEstimator(p_, canvas=SERVE_CANVAS, refine_iterations=iters,
                                     graphs=False) for p_ in (kern, plain))
            got, ck = recorded_conf(kern, lambda: ek.run_frames(*stacked, seeds))
            reset_launch_counts()
            ref, cp = recorded_conf(plain, lambda: ep.run_frames(*stacked, seeds))
            if launch_counts() != counts():
                raise AssertionError("serve: the plain pipeline launched a kernel")
            gaps[(dt_name, iters, "plain")] = same_poses(
                f"run_frames (F = {SERVE_F}, {iters} iterations) kernels vs plain",
                dt_name, got, ref, ck, cp, gated)
            singles, cs = recorded_conf(kern, lambda: [
                ek.run(*f, i) for i, f in enumerate(frames)])
            singles = type(got)(*(torch.stack(x) for x in zip(*singles)))
            gaps[(dt_name, iters, "runs")] = same_poses(
                f"run_frames vs {SERVE_F} runs ({iters} iterations)", dt_name,
                got, singles, ck, cs, gated)
            for x in (one.quat, one.trans, got.quat, got.trans):
                if not torch.isfinite(x).all():
                    raise AssertionError(f"serve {dt_name}: non-finite pose")

    # 7. valid / oversized: an inactive slot, an absent label and a window
    # larger than the canvas (a 260 x 260 object)
    fr, models, depth = serve_scene(1)
    label = fr.label.copy()
    label[100:360, 300:560] = 21
    depth = depth.copy()
    depth[100:360, 300:560] = 1200.0
    fr.label = label
    obj_ids = np.array([2, 0, 99, 21, 1])
    inputs, _, _ = serve_inputs(fr, models, depth, obj_ids)
    for g_ in (False, True):
        p = est[g_].run(*inputs, 3)
        ok = (p.valid.tolist() == [True, False, False, False, True]
              and p.oversized.tolist() == [False, False, False, True, False])
        print(f"  slots {obj_ids.tolist()} ({'graph' if g_ else 'eager'}): valid "
              f"{p.valid.tolist()} oversized {p.oversized.tolist()} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("serve: valid / oversized flags")

    # 8. no host sync in an eager run (after its warm-up, inputs on the card)
    seed0 = torch.tensor(0, device=DEVICE)
    eager = est[False]
    eager.run(*frames[0], seed0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager.run(*frames[0], seed0)
        eager.run_frames(*stacked, seeds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  eager run and run_frames (bf16) under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync")
    kern.cast(torch.float32)
    eager.run(*frames[0], seed0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager.run(*frames[0], seed0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("  eager run (f32) under set_sync_debug_mode('error'): no host sync")
    del est, plain
    torch.cuda.empty_cache()
    return kern, frames, stacked, launches


def serve_cli_walls():
    """Wall time of the serve CLI as a process (start and build reuse
    included): single frames and --batch, and the steady per-frame ms it
    prints (the median of its later frames)."""
    walls = {}
    for name, extra in (("single", []), (f"batch{SERVE_F}", ["--batch", str(SERVE_F)])):
        cmd = [sys.executable, "-m", "plr2_tpu_torch.tools.serve", "--synthetic",
               "--num_frames", str(SERVE_F), *extra]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        walls[name] = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"serve CLI failed: {res.stderr[-3000:]}")
        lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
        if len(lines) != SERVE_F:
            raise AssertionError(f"serve CLI: {len(lines)} frame lines, not {SERVE_F}")
        dropped = sum(x.get("dropped", 0) for x in lines)
        ms = sorted(x["ms"] for x in lines[1:]) or [lines[0]["ms"]]
        print(f"  python -m plr2_tpu_torch.tools.serve --synthetic --num_frames "
              f"{SERVE_F} {' '.join(extra)}: wall {walls[name]:.2f} s, first frame "
              f"{lines[0]['ms']} ms, later frames median {ms[len(ms) // 2]} ms, "
              f"{dropped} slots dropped")
    return walls


@phase("serve timing")
def serve_timing_phase(kern, frames, stacked):
    """Frames/s of run (K = 5, one frame) and run_frames (F = 8), eager and
    graph, f32 and bf16: CUDA events around back-to-back calls after
    warm-up (inputs on the card); the latency of one synchronised run
    (host clock, median); profiles of one eager run and one replay (device
    busy share, launches); the serve CLI's walls."""
    from torch.profiler import ProfilerActivity, profile
    from plr2_tpu_torch.serving import FrameEstimator
    rates, lat = {}, {}
    seeds = torch.arange(SERVE_F, device=DEVICE)
    for dt_name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        kern.cast(dtype)
        for mode in ("eager", "graph"):
            fe = FrameEstimator(kern, canvas=SERVE_CANVAS,
                                refine_iterations=SERVE_ITERS,
                                graphs=mode == "graph")
            one = lambda: fe.run(*frames[0], 0)
            ms = time_ms(one, 20, warmup=3)
            rates[f"run_{mode}_{dt_name}"] = 1e3 / ms
            walls = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            lat[f"run_{mode}_{dt_name}"] = sorted(walls)[len(walls) // 2]
            fms = time_ms(lambda: fe.run_frames(*stacked, seeds), 5, warmup=2)
            rates[f"frames_{mode}_{dt_name}"] = SERVE_F * 1e3 / fms
            print(f"  {dt_name} {mode}: run (K = {SERVE_K}) {ms:.3f} ms = "
                  f"{1e3 / ms:.1f} frames/s (one synchronised run: "
                  f"{lat[f'run_{mode}_{dt_name}']:.3f} ms); run_frames "
                  f"(F = {SERVE_F}) {fms:.3f} ms = {SERVE_F * 1e3 / fms:.1f} frames/s")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                one()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy = top_device_kernels(
                prof, wall, f"one {mode} run ({dt_name}, K = {SERVE_K})",
                8 if mode == "eager" else 4)
            lat[f"busy_{mode}_{dt_name}"] = busy
            del fe
            torch.cuda.empty_cache()
    walls = serve_cli_walls()
    return rates, lat, walls


# ---------------- the real-data path (LineMOD / YCB-Video layouts on disk,
# the native data plane, the prefetcher, the CLIs' --dataset_root) ----------

# LineMOD: ape (id 1, OBJLIST position 0) and eggbox (id 10, position 7,
# symmetric: the ADD-S match runs); frames per object
REAL_LM_OBJS, REAL_LM_TRAIN, REAL_LM_TEST = (1, 10), 8, 2
# LineMOD's width (the linemod_train preset): 500 points, 500 mesh points
REAL_LM_POINTS = 500
# YCB-Video: the 21 upstream classes; meshes for 002_master_chef_can,
# 003_cracker_box and 024_bowl (class 12, symmetric); real frames of camera
# 1 (sequence 0001) and camera 2 (sequence 0060), synthetic frames
YCB_CLASSES = ("002_master_chef_can", "003_cracker_box", "004_sugar_box",
               "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
               "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
               "011_banana", "019_pitcher_base", "021_bleach_cleanser",
               "024_bowl", "025_mug", "035_power_drill", "036_wood_block",
               "037_scissors", "040_large_marker", "051_large_clamp",
               "052_extra_large_clamp", "061_foam_brick")
REAL_YCB_OBJS = (0, 1, 12)
REAL_YCB_TRAIN = ("data/0001/000001", "data/0001/000002", "data/0001/000003",
                  "data/0060/000001", "data_syn/000001", "data_syn/000002")
REAL_YCB_TEST = ("data/0001/000004", "data/0060/000002")
REAL_WORKERS = (0, 2, 4)
# every PNG row filter, row by row (None, Sub, Up, Average, Paeth)
PNG_FILTERS = (0, 1, 2, 3, 4)


def _fmt(v):
    return f"{float(v):.8f}"


def write_linemod_layout(root, written):
    """A Linemod_preprocessed tree at 480 x 640: per object rgb / depth /
    mask PNGs (the port's writer, every row filter; the ape's masks grey,
    the eggbox's RGB as upstream's), upstream-style gt.yml (flow lists,
    one wrapped over two lines), info.yml, train / test splits, models in
    mm as ASCII PLY and models_info.yml (flow mappings). Returns the YAML
    documents it means; `written` collects every PNG's array by path."""
    from plr2_tpu_torch.data.codecs import write_png
    from plr2_tpu_torch.data.linemod import INTRINSICS
    from plr2_tpu_torch.data.synthetic import (box_model_points, random_pose,
                                               render_frame)
    rng = np.random.default_rng(0)
    (root / "models").mkdir(parents=True)
    meant, info_lines = {}, []
    for k, obj in enumerate(REAL_LM_OBJS):
        d = root / "data" / f"{obj:02d}"
        for sub in ("rgb", "depth", "mask"):
            (d / sub).mkdir(parents=True)
        # half extents: ~10 and ~15 cm across, as the ape's and the
        # eggbox's diameters (102 and 165 mm)
        ext = (0.03, 0.04, 0.035) if obj == 1 else (0.045, 0.05, 0.04)
        mp = box_model_points(2500, extent=ext, seed=obj) * 1000.0
        with open(root / "models" / f"obj_{obj:02d}.ply", "w") as f:
            f.write(f"ply\nformat ascii 1.0\nelement vertex {len(mp)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "element face 0\nproperty list uchar int vertex_indices\n"
                    "end_header\n")
            f.writelines(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n" for p in mp)
        diameter = float(np.linalg.norm(mp.max(0) - mp.min(0)))
        info_lines.append(f"{obj}: {{diameter: {_fmt(diameter)}, min_x: "
                          f"{_fmt(mp[:, 0].min())}, size_x: {_fmt(np.ptp(mp[:, 0]))}}}\n")
        meant.setdefault("models_info", {})[obj] = {
            "diameter": float(_fmt(diameter)), "min_x": float(_fmt(mp[:, 0].min())),
            "size_x": float(_fmt(np.ptp(mp[:, 0])))}
        gt_text, gt = ["# ground truth, upstream layout\n"], {}
        n = REAL_LM_TRAIN + REAL_LM_TEST
        for fr in range(n):
            r, t = random_pose(rng, z_range=(0.6, 0.9))
            frame = render_frame({obj: mp / 1000.0}, {obj: (r, t)},
                                 intrinsics=INTRINSICS, seed=100 * k + fr)
            mask = ((frame.label == obj) * 255).astype(np.uint8)
            if obj == 10:
                mask = np.repeat(mask[..., None], 3, -1)
            for sub, arr in (("rgb", frame.color), ("depth", frame.depth),
                             ("mask", mask)):
                path = d / sub / f"{fr:04d}.png"
                write_png(path, arr, filters=PNG_FILTERS)
                written[path] = arr
            rr, tt = r.reshape(-1), t * 1000.0
            ys, xs = np.nonzero(frame.label == obj)
            bb = [int(xs.min()), int(ys.min()), int(np.ptp(xs)), int(np.ptp(ys))]
            head = ", ".join(_fmt(v) for v in rr[:3])
            tail = ", ".join(_fmt(v) for v in rr[3:])
            sep = ",\n    " if fr == 1 else ", "  # one list wrapped over two lines
            gt_text.append(f"{fr}:\n- cam_R_m2c: [{head}{sep}{tail}]\n"
                           f"  cam_t_m2c: [{', '.join(_fmt(v) for v in tt)}]\n"
                           f"  obj_bb: [{', '.join(map(str, bb))}]\n  obj_id: {obj}\n")
            gt[fr] = [{"cam_R_m2c": [float(_fmt(v)) for v in rr],
                       "cam_t_m2c": [float(_fmt(v)) for v in tt],
                       "obj_bb": bb, "obj_id": obj}]
        (d / "gt.yml").write_text("".join(gt_text))
        (d / "info.yml").write_text("".join(
            f"{fr}:\n  cam_K: [572.4114, 0.0, 325.2611, 0.0, 573.57043, "
            f"242.04899, 0.0, 0.0, 1.0]\n  depth_scale: 1.0\n" for fr in range(n)))
        (d / "train.txt").write_text("".join(f"{fr:04d}\n" for fr in range(REAL_LM_TRAIN)))
        (d / "test.txt").write_text("".join(f"{fr:04d}\n" for fr in range(REAL_LM_TRAIN, n)))
        meant[obj] = gt
    (root / "models" / "models_info.yml").write_text("".join(info_lines))
    return meant


def write_ycb_layout(root, written):
    """A YCB_Video_Dataset tree at 480 x 640: colour / depth (factor 10000)
    / label PNGs and meta.mat per frame (three objects each, one
    symmetric), the 21 classes, train / test lists with real frames of
    both cameras and synthetic frames, and points.xyz meshes in metres."""
    import scipy.io as sio
    from plr2_tpu_torch.data.codecs import write_png
    from plr2_tpu_torch.data.synthetic import (box_model_points, random_pose,
                                               render_frame)
    from plr2_tpu_torch.data.ycb import CAM_1, CAM_2
    rng = np.random.default_rng(1)
    (root / "dataset_config").mkdir(parents=True)
    models = {}
    for ci in REAL_YCB_OBJS:
        (root / "models" / YCB_CLASSES[ci]).mkdir(parents=True)
        models[ci] = box_model_points(3000, extent=(0.025, 0.03, 0.035), seed=20 + ci)
        np.savetxt(root / "models" / YCB_CLASSES[ci] / "points.xyz", models[ci], fmt="%.6f")
    for j, rel in enumerate(REAL_YCB_TRAIN + REAL_YCB_TEST):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        cam = CAM_2 if rel.startswith("data/0060") else CAM_1
        poses = {}
        for k, ci in enumerate(REAL_YCB_OBJS):
            r, t = random_pose(rng, z_range=(0.9, 1.1))
            t[0], t[1] = -0.14 + 0.14 * k, 0.02 * k - 0.02
            poses[ci + 1] = (r, t)
        frame = render_frame({ci + 1: models[ci] for ci in REAL_YCB_OBJS}, poses,
                             intrinsics=cam, seed=300 + j)
        for suffix, arr in (("color", frame.color), ("depth", frame.depth),
                            ("label", frame.label.astype(np.uint8))):
            path = root / f"{rel}-{suffix}.png"
            write_png(path, arr, filters=PNG_FILTERS)
            written[path] = arr
        ids = sorted(poses)
        sio.savemat(str(root / f"{rel}-meta.mat"), {
            "poses": np.stack([np.concatenate([poses[i][0], poses[i][1][:, None]], 1)
                               for i in ids], -1).astype(np.float64),
            "cls_indexes": np.asarray(ids, np.float64)[:, None],
            "factor_depth": np.array([[cam["cam_scale"]]]),
            "intrinsic_matrix": np.array([[cam["fx"], 0, cam["cx"]],
                                          [0, cam["fy"], cam["cy"]], [0, 0, 1]])})
    (root / "dataset_config" / "classes.txt").write_text("\n".join(YCB_CLASSES) + "\n")
    (root / "dataset_config" / "train_data_list.txt").write_text("\n".join(REAL_YCB_TRAIN) + "\n")
    (root / "dataset_config" / "test_data_list.txt").write_text("\n".join(REAL_YCB_TEST) + "\n")


def samples_equal(what, a, b):
    if len(a) != len(b) or any(x.obj != y.obj or not all(torch.equal(u, v) for u, v in zip(x, y))
                               for x, y in zip(a, b)):
        raise AssertionError(f"real data: {what} differ")


def real_cli(name, args, walls, tag=None):
    """One `python -m plr2_tpu_torch.tools.<name>` process; its wall time
    goes into `walls` under `tag`. Returns stdout + stderr."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"plr2_tpu_torch.tools.{name}", *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    walls[tag or name] = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"{tag or name} CLI failed: {res.stderr[-3000:]}")
    return res.stdout + res.stderr


def linemod_config(workers):
    import dataclasses
    from plr2_tpu_torch.config import get_preset
    from plr2_tpu_torch.tools.train import with_sizes
    cfg = get_preset("linemod_train")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, workers=workers, batch_size=WINDOW))
    return with_sizes(cfg, REAL_LM_POINTS, REAL_LM_POINTS)


@phase("real data")
def real_data_phase(errs):
    """The real-data path on the card: miniature LineMOD and YCB-Video trees
    written here (no PIL, no PyYAML), read back; the native data plane's
    build; prefetch at 0, 2 and 4 workers, threads and processes, bit-equal;
    per-sample times and samples/s; a Trainer epoch on the LineMOD tree fed
    by two worker threads with its launch counts; the CLI chain with
    --dataset_root as processes; the kernels at the real crops' shapes."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from plr2_tpu_torch import native
    from plr2_tpu_torch.data import LinemodDataset, YCBDataset, iterate_samples
    from plr2_tpu_torch.data.codecs import read_png, read_yaml, write_png
    from plr2_tpu_torch.data.linemod import OBJLIST
    from plr2_tpu_torch.data.prefetch import (finish_sample, host_prepare_raw,
                                              iterate_prefetch_samples)
    from plr2_tpu_torch.data.preprocess import draw
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    from plr2_tpu_torch.train import Trainer
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lm_root, ycb_root = tmp / "Linemod_preprocessed", tmp / "YCB_Video_Dataset"
        written = {}
        t0 = time.perf_counter()
        meant = write_linemod_layout(lm_root, written)
        write_ycb_layout(ycb_root, written)
        out["write_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        path, log = native.build()
        native.lib()
        out["native_build_s"] = time.perf_counter() - t0
        print(f"  native data plane {path}: {'built' if log is not None else 'reused'} "
              f"by one g++ call, wall {out['native_build_s']:.2f} s")

        bad = [str(p) for p, arr in written.items()
               if not (read_png(p).dtype == arr.dtype and np.array_equal(read_png(p), arr))]
        for obj in REAL_LM_OBJS:
            if read_yaml(lm_root / "data" / f"{obj:02d}" / "gt.yml") != meant[obj]:
                bad.append(f"gt.yml of {obj}")
        if read_yaml(lm_root / "models" / "models_info.yml") != meant["models_info"]:
            bad.append("models_info.yml")
        print(f"  wrote {len(written)} PNGs (rows filtered by types {PNG_FILTERS}), "
              f"upstream-style YAML and meta.mat in {out['write_s']:.2f} s; read_png "
              f"and read_yaml give back what was written: {'ok' if not bad else bad[:5]}")
        if bad:
            raise AssertionError(f"real data: read back differs: {bad[:5]}")

        lm_train = LinemodDataset(str(lm_root), "train", REAL_LM_POINTS, REAL_LM_POINTS)
        lm_test = LinemodDataset(str(lm_root), "test", REAL_LM_POINTS, REAL_LM_POINTS, add_noise=False)
        ycb_train = YCBDataset(str(ycb_root), "train", NUM_POINTS, MESH_POINTS, cache_mb=64)
        n_tr, n_te = len(lm_train), len(lm_test)
        s_tr = sum(it["obj"] == 10 for it in lm_train.items)
        s_te = sum(it["obj"] == 10 for it in lm_test.items)

        # prefetch: the same samples at any worker count, threads or
        # processes (2 workers on both trees, 4 on LineMOD's: a spawned
        # worker takes seconds to import torch, so the first two pools
        # start at once)
        def prefetched(ds, n_pts, workers, procs):
            t0 = time.perf_counter()
            got = list(iterate_prefetch_samples(
                ds, torch.Generator().manual_seed(21), n_pts, add_noise=True,
                shuffle=True, seed=4, num_workers=workers, device=DEVICE,
                use_processes=procs))
            torch.cuda.synchronize()
            return got, time.perf_counter() - t0
        trees = {"linemod": (lm_train, REAL_LM_POINTS), "ycb": (ycb_train, NUM_POINTS)}
        runs = {(name, w, False): prefetched(*trees[name], w, False)
                for name in trees for w in REAL_WORKERS}
        with ThreadPoolExecutor(2) as pool:
            futures = {(name, 2, True): pool.submit(prefetched, *trees[name], 2, True)
                       for name in trees}
            runs.update({k: f.result() for k, f in futures.items()})
        runs[("linemod", 4, True)] = prefetched(*trees["linemod"], 4, True)
        for (name, w, procs), (got, _) in runs.items():
            samples_equal(f"{name} prefetch with {w} {'processes' if procs else 'threads'}",
                          got, runs[(name, 0, False)][0])
        for name, (ds, _) in trees.items():
            print(f"  prefetch {name} ({len(ds)} samples, augmented): 0 workers, 2 and 4 "
                  f"threads, {'2 and 4' if name == 'linemod' else '2'} processes bit-equal "
                  f"ok (walls " + ", ".join(f"{w}{'p' if p else 't'} {t:.2f} s"
                                            for (nm, w, p), (_, t) in runs.items()
                                            if nm == name)
                  + "; process pools started cold)")
        del runs

        # per-sample times of the path: decode cold and cached, the native
        # host prep, finish_sample on the card
        cold = LinemodDataset(str(lm_root), "train", REAL_LM_POINTS, REAL_LM_POINTS)
        cached = LinemodDataset(str(lm_root), "train", REAL_LM_POINTS, REAL_LM_POINTS, cache_mb=64)
        raws = [cached.get_raw(i) for i in range(n_tr)]  # fills the cache
        t0 = time.perf_counter()
        for i in range(n_tr):
            cold.get_raw(i)
        out["decode_cold_ms"] = (time.perf_counter() - t0) * 1e3 / n_tr
        t0 = time.perf_counter()
        for i in range(n_tr):
            cached.get_raw(i)
        out["decode_cached_ms"] = (time.perf_counter() - t0) * 1e3 / n_tr
        t0 = time.perf_counter()
        preps = [host_prepare_raw(r, REAL_LM_POINTS, seed=i) for i, r in enumerate(raws)]
        out["host_prep_ms"] = (time.perf_counter() - t0) * 1e3 / n_tr
        names = ("img_u8", "points", "choose", "model_points", "target_r", "target_t")
        d = draw(torch.Generator().manual_seed(3))

        def finish_all():
            for p in preps:
                finish_sample(*(torch.from_numpy(np.array(p[k])).to(DEVICE) for k in names),
                              int(p["idx"]), d, add_noise=True)
        finish_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finish_all()
        torch.cuda.synchronize()
        out["finish_ms"] = (time.perf_counter() - t0) * 1e3 / n_tr
        t0 = time.perf_counter()
        for i in range(len(ycb_train)):
            ycb_train._decode_frame(ycb_train.items[i]["frame"])
        out["ycb_decode_cold_ms"] = (time.perf_counter() - t0) * 1e3 / len(ycb_train)
        print(f"  a LineMOD sample (480 x 640, {REAL_LM_POINTS} points): decode {out['decode_cold_ms']:.3f} "
              f"ms cold, {out['decode_cached_ms']:.4f} ms cached; native host prep "
              f"{out['host_prep_ms']:.3f} ms; finish_sample (upload, jitter, noise, "
              f"normalisation on the card) {out['finish_ms']:.3f} ms; a YCB frame's "
              f"decode (3 PNGs and meta.mat) {out['ycb_decode_cold_ms']:.3f} ms cold")

        # samples/s of the prefetcher (decode included: no cache) against the
        # inline device path (iterate_samples): 3 passes each, in one order
        # and then the reverse (the host's clock drifts), the mean of both
        reps = 3
        fns = {f"prefetch_{w}": lambda w=w: iterate_prefetch_samples(
                   cold, torch.Generator().manual_seed(1), REAL_LM_POINTS,
                   add_noise=True, shuffle=True, num_workers=w, device=DEVICE)
               for w in REAL_WORKERS}
        fns["inline"] = lambda: iterate_samples(
            cold, torch.Generator().manual_seed(1), REAL_LM_POINTS, add_noise=True,
            shuffle=True, device=DEVICE)
        for fn in fns.values():
            list(fn())
        rates = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    for _s in fns[name]():
                        pass
                torch.cuda.synchronize()
                rates[name].append(reps * n_tr / (time.perf_counter() - t0))
        for name, r in rates.items():
            out[f"{name}_samples_per_s"] = sum(r) / len(r)
        print("  samples/s over the LineMOD tree (decode included, augmented, on the card; "
              "forward and reverse order): " + ", ".join(
                  f"{k} {r[0]:.1f} / {r[1]:.1f}" for k, r in rates.items()))

        # the path through the kernels: a stage-1 Trainer epoch and its test
        # epoch on the LineMOD tree, fed by two worker threads
        tr = Trainer(linemod_config(2), device=DEVICE)
        state = tr.init_state()
        reset_launch_counts()
        state, info = tr.train_epoch(state, lm_train, torch.Generator().manual_seed(6))
        dis = tr.test_epoch(state, lm_test, torch.Generator().manual_seed(7))
        torch.cuda.synchronize()
        seen = launch_counts()
        fwd = 3 * (n_tr + n_te)
        expect = counts(mlp_head=fwd, upconv3x3_prelu=fwd, nn_match=s_tr + s_te,
                        gather_rows_backward=n_tr)
        finite = all(math.isfinite(v) for v in info["losses"]) and math.isfinite(dis)
        print(f"  Trainer stage-1 epoch on the LineMOD tree ({n_tr} train / {n_te} test "
              f"samples, {s_tr} / {s_te} eggbox), 2 worker threads: loss "
              f"{info['train_loss']:.5f}, test dis {dis:.5f}, finite {finite}; "
              f"launches {seen}")
        if seen != expect or not finite:
            raise AssertionError(f"real data: expected launches {expect}, got {seen}; "
                                 f"finite {finite}")
        trainers = {w: Trainer(linemod_config(w), pipe=tr.pipe) for w in (0, 2)}
        states = {w: t.init_state() for w, t in trainers.items()}
        trainers[0].train_epoch(states[0], cold, torch.Generator().manual_seed(8))  # warm
        rates = {0: [], 2: []}
        for workers in (0, 2, 2, 0):  # in turns: the host's clock drifts
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainers[workers].train_epoch(states[workers], cold,
                                          torch.Generator().manual_seed(9))
            torch.cuda.synchronize()
            rates[workers].append(n_tr / (time.perf_counter() - t0))
        for workers, r in rates.items():
            out[f"trainer_{workers}w_samples_per_s"] = sum(r) / len(r)
        print(f"  Trainer stage-1 samples/s on the LineMOD tree (decode included; epochs "
              f"in turns 0, 2, 2, 0 workers): inline {rates[0][0]:.1f} / {rates[0][1]:.1f}, "
              f"2 worker threads {rates[2][0]:.1f} / {rates[2][1]:.1f}")
        tw, st = trainers, states
        del tr, tw, st, state

        # the CLI chain as processes, in two waves: both trainings, then the
        # five runs that read their checkpoints
        walls = {}
        seg = tmp / "segnet_results"
        for obj in REAL_LM_OBJS:
            (seg / f"{obj:02d}_label").mkdir(parents=True)
            for fr in range(REAL_LM_TRAIN, REAL_LM_TRAIN + REAL_LM_TEST):
                m = read_png(lm_root / "data" / f"{obj:02d}" / "mask" / f"{fr:04d}.png")
                m = (m if m.ndim == 2 else m[..., 0]).copy()
                m[:, 1::3] = 0  # an imperfect prediction
                write_png(seg / f"{obj:02d}_label" / f"{fr:04d}_label.png", m)
        models = tmp / "models"
        train_args = {name: ["--dataset", name, "--dataset_root", str(root), "--nepoch",
                             "1", "--workers", "2", "--cache_mb", "64", "--outf",
                             str(models / name), "--log_dir", str(models / name)]
                      for name, root in (("linemod", lm_root), ("ycb", ycb_root))}
        with ThreadPoolExecutor(5) as pool:
            logs = {name: pool.submit(real_cli, "train", a, walls, f"train_{name}")
                    for name, a in train_args.items()}
            losses = [float(x.split("loss=")[1].split()[0])
                      for f in logs.values() for x in f.result().splitlines()
                      if "epoch 1:" in x]
            dists = {tag: tmp / f"{tag}.json" for tag in ("eval_linemod", "eval_linemod_segnet")}
            evals = {tag: pool.submit(real_cli, "eval_linemod", [
                "--dataset_root", str(lm_root), "--model", str(models / "linemod" / "linemod"),
                "--refine_iterations", "2", "--save_distances", str(dists[tag]),
                *(["--segnet_results", str(seg)] if tag.endswith("segnet") else [])],
                walls, tag) for tag in dists}
            serves = {tag: pool.submit(real_cli, "serve", [
                "--dataset_root", str(ycb_root), "--model", str(models / "ycb" / "ycb"),
                "--num_frames", "2", "--max_objects", "3", *extra], walls, tag)
                for tag, extra in (("serve_eager", ["--eager"]), ("serve_graph", []))}
            base = ycb_root / REAL_YCB_TEST[0]
            infer = pool.submit(real_cli, "infer", [
                "--color", f"{base}-color.png", "--depth", f"{base}-depth.png",
                "--label", f"{base}-label.png", "--obj", "13", "--points",
                str(ycb_root / "models" / YCB_CLASSES[12] / "points.xyz"),
                "--model", str(models / "ycb" / "ycb")], walls)
            loaded = {tag: "loaded checkpoint (epoch 1)" in f.result()
                      for tag, f in evals.items()}
            reports = {tag: (json.loads(dists[tag].read_text()), loaded[tag])
                       for tag in evals}
            served = {tag: [json.loads(x) for x in f.result().splitlines()
                            if x.startswith("{")] for tag, f in serves.items()}
            inf = infer.result()
        keys = sorted(str(OBJLIST.index(o)) for o in REAL_LM_OBJS)
        ok = (len(losses) == 2 and all(math.isfinite(v) for v in losses)
              and all(sorted(r["distances"]) == keys and loaded for r, loaded in reports.values())
              and all(len(v) == 2 and [o["obj"] for o in v[0]["objects"]] ==
                      [c + 1 for c in REAL_YCB_OBJS] and all(o["valid"] for f in v for o in f["objects"])
                      for v in served.values())
              and "loaded checkpoint" in inf and "pose quaternion" in inf)
        poses_same = all(a["objects"] == b["objects"] for a, b in
                         zip(served["serve_eager"], served["serve_graph"]))
        out.update({f"{k}_wall_s": v for k, v in walls.items()})
        print(f"  CLI chain with --dataset_root (walls, process start included; the two "
              f"trainings at once, then the other five at once): "
              f"{ {k: round(v, 2) for k, v in walls.items()} } s; epoch-1 losses {losses}; "
              f"report keys {keys} with and without --segnet_results, checkpoints "
              f"restored; serve (eager and graph) poses of objects "
              f"{[c + 1 for c in REAL_YCB_OBJS]} valid, eager == graph {poses_same}; "
              f"infer on one frame {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"real data: CLI chain: {reports}, {served}, {inf[-1000:]}")

        # the kernels at the real crops' shapes
        crops = set()
        for ds in (lm_train, lm_test, ycb_train):
            for i in range(len(ds)):
                raw = ds.get_raw(i)
                r0, r1, c0, c1 = native.mask_bbox(raw.get("bbox_mask", raw["mask"]))
                crops.add((r1 - r0, c1 - c0))
        print(f"  the real crops' shapes: {sorted(crops)}")
    check_kernels_at(crops, errs, torch.Generator().manual_seed(12))
    return seen, out


def add_real_launches(entries, seen, errs):
    """The real-data path's launches (an f32 Trainer epoch) and the kernels'
    errors at its crops into the kernels line."""
    for e in entries:
        kname = {"mlp_head_f32": "mlp_head", "upconv3x3_prelu_f32": "upconv3x3_prelu",
                 "nn_match": "nn_match", "nn_argmin": "nn_argmin",
                 "nn_match_mxu": "nn_match_mxu",
                 "gather_rows_backward": "gather_rows_backward"}.get(e["name"])
        if kname is None:
            continue
        e["launches_by_path"]["real_data"] = seen[kname]
        e["launches"] += seen[kname]
        if e["name"].endswith("_f32"):
            e["max_abs_err"] = max(e["max_abs_err"], errs[(kname, "f32")])


# ---------------- segmentation and the config-5 full pipeline (phase 22) ----

# YCB's 22 classes (21 objects + background) on 480 x 640 frames; the
# PSPNet segmenter's decoder stages at a padded frame (hp, wp): (h, w, Cin,
# Cout) of each stage's low-res input; F frames a call
SEG_CLASSES, SEG_H, SEG_W, SEG_F = NUM_OBJ + 1, 480, 640, (1, 8)
# a frame that fills no tile: _segment pads 484 x 644 to 512 x 672
SEG_ODD = (484, 644)
# SegTrainer steps (the reference's batch 3 of 128 px crops) and the
# kernels-vs-plain gates of a pspnet step from one state: loss relative,
# parameters in relative L2 over the network (EPOCH_TOL's reasons)
SEG_CROP, SEG_BATCH, SEG_STEPS = 128, 3, 3
SEG_STEP_TOL = {"loss": 1e-5, "param_l2": 1e-3}
# the PSPNet segmenter through the kernels vs through the plain versions:
# f32 logits at TOL; bf16 labels must agree on this share of the pixels
# (the decoder's bf16 roundings flip near-tied logits)
SEG_BF16_AGREE = 0.99
# the full pipeline: make_scene frames of SERVE_K objects, 4 refine
# iterations; host vs device distances within the estimate's f32 gate. Its
# SegNet masks come from SegNet at two narrow blocks with weights set to
# label the scene colours (`colour_segnet_state`): at VGG16's five levels a
# decoder pixel holds the per-channel maxima of a 32 x 32 region, which no
# choice of weights turns back into that pixel's colour
SEG_FRAMES = 4
SEG_COLOUR_BLOCKS = ((1, 8), (1, 16))


def seg_stages(hp, wp):
    """The decoder stages of the PSPNet segmenter on an (hp, wp) frame."""
    return {"up_1": (hp // 8, wp // 8, 1024, 256), "up_2": (hp // 4, wp // 4, 256, 64),
            "up_3": (hp // 2, wp // 2, 64, 64)}


def seg_frame_tensor(frames):
    """(F, H, W, 3) uint8 on the card."""
    return torch.from_numpy(np.stack([f.color for f in frames])).to(DEVICE)


def colour_segnet_state(num_classes, blocks):
    """A SegNet state dict whose labels are the scene colours: every conv
    is its centre tap carrying the normalised colour + 2 in channels 0-2
    (positive, so the ReLUs pass it), each decoder block's first BatchNorm
    scales by 4 (the unpool writes y / 4 in a flat window), and the
    classifier scores class k by the cosine with c_k + 2 (c_k:
    make_scene's colour of object k, grey 30 for the background), so a
    flat object is labelled with its id and the scale of an edge pixel
    changes no label. Random weights paint every object with one class."""
    from plr2_tpu_torch.models.segnet import SegNet
    ids = np.arange(num_classes)
    cols = np.stack([(ids * 67) % 200 + 55, (ids * 131) % 200 + 55,
                     (ids * 29) % 200 + 55], 1)
    cols[0] = 30
    cols = torch.tensor(cols, dtype=torch.float32) / 255.0 * 2 - 1
    net = SegNet(num_classes, blocks)
    state = {k: torch.zeros_like(v) for k, v in net.state_dict().items()}
    firsts = {f"dec{bi}_0" for bi in range(len(blocks))}
    for name in {k.split(".")[0] for k in state if not k.startswith("classifier")}:
        w = state[f"{name}.conv.weight"]
        w[:3, :3, 1, 1] = torch.eye(3)
        if name == "enc0_0":
            state[f"{name}.conv.bias"][:3] = 2.0
        state[f"{name}.bn.weight"].fill_(4.0 if name in firsts else 1.0)
        state[f"{name}.bn.running_var"].fill_(1.0)
    direction = cols + 2
    state["classifier.weight"][:, :3, 1, 1] = direction / direction.norm(dim=1, keepdim=True)
    return state


def seg_trainer_on(model, arch):
    """A SegTrainer whose segmenter is `model` (its predict and steps)."""
    from plr2_tpu_torch.train.seg_trainer import SegTrainer
    tt = SegTrainer(num_classes=SEG_CLASSES, crop=SEG_CROP, batch=SEG_BATCH,
                    arch=arch, device=DEVICE)
    tt.model = model
    return tt


def seg_kernel_checks(errs, gen):
    """Kernel 2 on the PSPNet segmenter's three stages at full-frame shapes
    (F = 1 and 8 at 480 x 640, F = 1 at the padded 484 x 644 frame), f32
    and bf16, against its plain version; its time at 480 x 640 beside
    the plain version, cuDNN's interpolate + conv2d + prelu chain and the
    bound. Returns {dtype: {F: totals of the three stages}}."""
    from plr2_tpu_torch.ops import upconv
    hp, wp = (-(-s // 32) * 32 for s in SEG_ODD)
    table = {}
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        item = torch.empty((), dtype=dtype).element_size()
        table[dt_name] = {}
        for f, (fh, fw) in ((1, (SEG_H, SEG_W)), (8, (SEG_H, SEG_W)), (1, (hp, wp))):
            frame_shape = (fh, fw) == (SEG_H, SEG_W)
            tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0, "bytes": 0}
            for name, (h, w, cin, cout) in seg_stages(fh, fw).items():
                args = (_rand((f, h, w, cin), gen, 1.0, dtype),
                        _rand((3, 3, cin, cout), gen, (9 * cin) ** -0.5, dtype),
                        _rand((cout,), gen, 0.1, dtype),
                        torch.full((1,), 0.25, device=DEVICE, dtype=dtype))
                got = upconv.upconv3x3_prelu(*args)
                torch.cuda.synchronize()
                e = compare(f"upconv3x3_prelu {dt_name} segmenter {name} at a {fh} x {fw} "
                            f"frame {tuple(args[0].shape)}->{cout}", got,
                            upconv.upconv3x3_prelu_plain(*args), TOL[dt_name])
                errs[("upconv3x3_prelu", dt_name)] = max(errs[("upconv3x3_prelu", dt_name)], e)
                del got
                if frame_shape:
                    k = time_ms(lambda: upconv.upconv3x3_prelu(*args), 5)
                    p = time_ms(lambda: upconv.upconv3x3_prelu_plain(*args), 3)
                    lib = time_ms(lambda: upconv_library(*args), 5)
                    fl = upconv.flops(f, h, w, cin, cout)
                    by = item * (f * h * w * cin + 9 * cin * cout + cout + 1
                                 + f * 4 * h * w * cout)
                    print(f"    {name} F = {f} {dt_name}: kernel {k:.3f} ms "
                          f"({fl / k / 1e9:.1f} TFLOP/s), plain {p:.3f} ms, cuDNN "
                          f"chain {lib:.3f} ms")
                    for key, v in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                                   ("flops", fl), ("bytes", by)):
                        tot[key] += v
                del args
                torch.cuda.empty_cache()
            if frame_shape:
                tot["bound_ms"], tot["bound_by"] = bound_of(tot, dt_name)
                table[dt_name][f] = tot
                print(f"  decoder of the segmenter, {dt_name}, F = {f} at {SEG_H} x {SEG_W}: "
                      f"kernel {tot['ms']:.3f} ms ({tot['flops'] / f / 1e9:.1f} GFLOP a "
                      f"frame, {tot['flops'] / tot['ms'] / 1e9:.1f} TFLOP/s), plain "
                      f"{tot['plain_ms']:.3f} ms, cuDNN chain {tot['library_ms']:.3f} ms, "
                      f"bound {tot['bound_ms']:.4f} ms ({tot['bound_by']})")
    return table


def seg_forward_checks(scenes, timings):
    """SegNet at 480 x 640 x 22 classes against itself run twice (bit-equal;
    a frame of one colour included, where every unpool window ties) and
    the PSPNet segmenter through the kernels against use_kernels=False,
    f32 and bf16; the segmenters' frames/s at F = 1 and 8."""
    from plr2_tpu_torch.models.segnet import build_segmenter
    from plr2_tpu_torch.pipeline import full_f32
    from plr2_tpu_torch.data.preprocess import normalize_frames
    colors = seg_frame_tensor([s[0] for s in scenes[:SEG_F[-1]]])
    flat = colors[:2].clone()
    flat[1] = torch.tensor([90, 140, 200], dtype=torch.uint8, device=DEVICE)
    x8 = normalize_frames(colors)
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        with torch.no_grad(), full_f32(dtype == torch.float32):
            seg = build_segmenter("segnet", SEG_CLASSES, dtype=dtype, device=DEVICE, seed=3)
            xf = normalize_frames(flat)
            a, b = seg(xf), seg(xf)
            same = torch.equal(a, b)
            print(f"  SegNet {dt_name} at {SEG_H} x {SEG_W} x {SEG_CLASSES} (a scene and a "
                  f"frame of one colour): finite {bool(torch.isfinite(a).all())}, two runs "
                  f"bit-equal {same}")
            if not same or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"segmentation: SegNet {dt_name} is not repeatable")
            psp = build_segmenter("pspnet", SEG_CLASSES, dtype=dtype, device=DEVICE, seed=4)
            plain = build_segmenter("pspnet", SEG_CLASSES, dtype=dtype, device=DEVICE,
                                    seed=None, use_kernels=False)
            plain.load_state_dict(psp.state_dict())
            got, ref = psp(x8[:2]), plain(x8[:2])
            torch.cuda.synchronize()
            agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
            if dt_name == "f32":
                compare("PSPNet segmenter f32 logits, kernels vs plain versions", got, ref,
                        TOL["f32"])
            else:
                print(f"  PSPNet segmenter bf16, kernels vs plain versions: max |d| "
                      f"{float((got.float() - ref.float()).abs().max()):.3e}, labels agree on "
                      f"{agree * 100:.3f}% (gate {SEG_BF16_AGREE * 100:g}%)")
                if agree < SEG_BF16_AGREE:
                    raise AssertionError("segmentation: bf16 PSPNet segmenter labels disagree")
            del got, ref, plain
            for arch, model in (("segnet", seg), ("pspnet", psp)):
                for f in SEG_F:
                    ms = time_ms(lambda: model(x8[:f]), 3, warmup=1)
                    timings[f"segmenter_{arch}_{dt_name}_f{f}_frames_per_s"] = f * 1e3 / ms
                    print(f"  {arch} segmenter {dt_name} F = {f}: {ms:.3f} ms = "
                          f"{f * 1e3 / ms:.1f} frames/s")
            del seg, psp
            torch.cuda.empty_cache()


def seg_train_checks(scenes, timings):
    """SEG_STEPS SegTrainer steps at 128 px crops, batch 3, of each
    architecture on one batch (finite, falling loss); the pspnet steps
    once through the kernels and once through the plain versions from one
    state and the same dropout masks; step ms."""
    from plr2_tpu_torch.data.preprocess import normalize_frames
    from plr2_tpu_torch.train.seg_trainer import SegTrainer, frame_crops, step_generator
    img, lab = next(frame_crops([s[0] for s in scenes], SEG_CROP, SEG_BATCH,
                                np.random.default_rng(0)))
    x = normalize_frames(torch.from_numpy(img).to(DEVICE))
    y = torch.from_numpy(lab.astype(np.int64)).to(DEVICE)
    for arch in ("segnet", "pspnet"):
        runs = {}
        for kern in ((True, False) if arch == "pspnet" else (True,)):
            tt = SegTrainer(num_classes=SEG_CLASSES, crop=SEG_CROP, batch=SEG_BATCH,
                            arch=arch, device=DEVICE, use_kernels=kern)
            state = tt.init_state(5)
            losses = [float(tt.train_step(state, x, y, step_generator(1, i)))
                      for i in range(SEG_STEPS)]
            runs[kern] = (losses, torch.cat([p.detach().flatten() for p in tt.model.parameters()]))
            if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
                raise AssertionError(f"segmentation: {arch} steps {losses}")
            if kern:
                ms = time_ms(lambda: tt.train_step(state, x, y, step_generator(1, 9)), 3)
                timings[f"seg_train_step_{arch}_ms"] = ms
            print(f"  SegTrainer {arch} ({'kernels' if kern else 'plain versions'}), "
                  f"{SEG_STEPS} steps at {SEG_CROP} px, batch {SEG_BATCH}: losses "
                  f"{[round(v, 6) for v in losses]}"
                  + (f"; a step {timings[f'seg_train_step_{arch}_ms']:.3f} ms" if kern else ""))
            del tt, state
        if arch == "pspnet":
            (lk, pk), (lp, pp) = runs[True], runs[False]
            dl = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
            dp = float((pk - pp).norm() / pp.norm())
            ok = dl <= SEG_STEP_TOL["loss"] and dp <= SEG_STEP_TOL["param_l2"]
            print(f"  pspnet steps, kernels vs plain versions from one state: loss "
                  f"{dl:.3e} relative (tol {SEG_STEP_TOL['loss']:g}), parameters "
                  f"{dp:.3e} relative L2 (tol {SEG_STEP_TOL['param_l2']:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("segmentation: pspnet steps disagree with the plain versions")
    torch.cuda.empty_cache()


def seg_serve_checks(scenes, timings):
    """FrameEstimator with each segmenter at seg_scale 1 and 2, f32 and
    bf16 (K = 5, canvas 240, 4 refine iterations): the launches of an
    eager run, the graph's replays bit-equal to the eager run, the labels
    at s = 1 equal to SegTrainer.predict's; frames/s eager and replay.
    Returns the launches by dtype."""
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.models.segnet import build_segmenter
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    from plr2_tpu_torch.serving import FrameEstimator
    from plr2_tpu_torch.data.preprocess import normalize_frames
    frame, models, depth = scenes[0]
    ids = np.arange(1, SERVE_K + 1)
    inputs, _, _ = serve_inputs(frame, models, depth, ids)
    launches = {}
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        pipe = DenseFusionPipeline(SERVE_POINTS, NUM_OBJ, device=DEVICE, seed=0)
        if dtype != torch.float32:
            pipe.cast(dtype)
        total = counts()
        for arch in ("segnet", "pspnet"):
            seg = build_segmenter(arch, SEG_CLASSES, dtype=dtype, device=DEVICE, seed=1)
            for s in (1, 2):
                kw = dict(canvas=SERVE_CANVAS, img_h=depth.shape[0], img_w=depth.shape[1],
                          refine_iterations=SERVE_ITERS, seg_model=seg, seg_scale=s)
                eager = FrameEstimator(pipe, graphs=False, **kw)
                reset_launch_counts()
                e = eager.run(*inputs, 7)
                torch.cuda.synchronize()
                seen = launch_counts()
                want = counts(mlp_head=3, upconv3x3_prelu=3 + 3 * (arch == "pspnet"))
                if seen != want:
                    raise AssertionError(f"segmentation: {arch} s={s} {dt_name} eager "
                                         f"launches {seen}, expected {want}")
                for k, v in seen.items():
                    total[k] += v
                graph = FrameEstimator(pipe, **kw)
                g1, g2 = graph.run(*inputs, 7), graph.run(*inputs, 7)
                same = all(torch.equal(a, b) and torch.equal(a, c)
                           for a, b, c in zip(e, g1, g2))
                labels_ok = None
                if s == 1:
                    labels = eager._segment(inputs[0][None])
                    pred = seg_trainer_on(seg, arch).predict(normalize_frames(inputs[0][None]))
                    labels_ok = torch.equal(labels, pred.to(torch.int32))
                rates = {}
                for mode, fe in (("eager", eager), ("graph", graph)):
                    ms = time_ms(lambda: fe.run(*inputs, 7), 5, warmup=1)
                    rates[mode] = 1e3 / ms
                    timings[f"serve_seg_{arch}_s{s}_{mode}_{dt_name}_frames_per_s"] = 1e3 / ms
                print(f"  FrameEstimator + {arch} segmenter, seg_scale {s}, {dt_name}: eager "
                      f"launches {seen['mlp_head']} mlp_head + {seen['upconv3x3_prelu']} "
                      f"upconv3x3_prelu; replays bit-equal to eager {same}; "
                      + ("" if labels_ok is None else
                         f"labels equal to SegTrainer.predict {labels_ok}; ")
                      + f"valid {e.valid.tolist()}; frames/s eager {rates['eager']:.1f}, "
                      f"graph {rates['graph']:.1f}")
                if not same or labels_ok is False:
                    raise AssertionError(f"segmentation: {arch} s={s} {dt_name} serving")
                del eager, graph
                torch.cuda.empty_cache()
            del seg
        launches[dt_name] = total
        del pipe
    return launches


def seg_pipeline_checks(scenes, timings, tmp):
    """evaluate_full_pipeline on SEG_FRAMES make_scene frames of SERVE_K
    objects: GT masks in host and device mode (the same lost detections,
    distances within the estimate's gate); SegNet masks (colour weights)
    inside the device program against device mode fed the same label
    maps (equal), and against host mode (gated where both modes cut the
    same window: host mode snaps it from the mask's largest component,
    device mode from the whole mask, and the splatted scenes' masks carry
    stray pixels);
    PoseCNN ROI results; the .mat export read back by `tools.plot_accuracy
    --mat_dir --synthetic`; frames/s of both modes."""
    import types
    import scipy.io as sio
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.config import get_preset
    from plr2_tpu_torch.data import SyntheticPoseDataset, get_bbox_from_mask
    from plr2_tpu_torch.data.linemod import largest_component_mask
    from plr2_tpu_torch.data.posecnn import PoseCNNMasks
    from plr2_tpu_torch.eval.full_pipeline import evaluate_full_pipeline
    from plr2_tpu_torch.eval.segment import segment_frame
    from plr2_tpu_torch.eval.report import accuracy_table
    from plr2_tpu_torch.models.segnet import SegNet
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    all_frames, models = [], {}
    for fr, mods, depth in scenes:
        all_frames.append(types.SimpleNamespace(
            color=fr.color, depth=depth, label=fr.label, poses=dict(fr.poses),
            intrinsics=fr.intrinsics))
        models.update(mods)
    frames = all_frames[:SEG_FRAMES]
    pipe = DenseFusionPipeline(SERVE_POINTS, NUM_OBJ, device=DEVICE, seed=0)
    run = lambda frames=frames, **kw: evaluate_full_pipeline(  # noqa: E731
        pipe, frames, models, SYM_LIST, refine_iterations=SERVE_ITERS,
        crop_canvas=SERVE_CANVAS, **kw)

    def gate(what, a, b, keys=None):
        """a vs b: lost detections equal (over `keys`, (object, visit), where
        given) and finite distances within the gate."""
        worst, lost = 0.0, 0
        for o, d in a.per_object_distances.items():
            for i, (x, y) in enumerate(zip(d, b.per_object_distances[o])):
                if keys is not None and (o, i) not in keys:
                    continue
                if math.isinf(x) != math.isinf(y):
                    raise AssertionError(f"segmentation: {what}: object {o} lost in one mode")
                lost += math.isinf(x)
                if math.isfinite(x):
                    worst = max(worst, abs(x - y))
        ok = ((keys is not None or a.lost_detections == b.lost_detections)
              and worst <= POSE_TOL["f32"])
        print(f"  {what}: lost {a.lost_detections} / {b.lost_detections} of "
              f"{a.num_objects} ({lost} of the compared, in both), max |d dis| "
              f"{worst:.3e} m (gate {POSE_TOL['f32']:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"segmentation: {what} disagree")

    reset_launch_counts()
    host = run()
    torch.cuda.synchronize()
    seen = launch_counts()
    if seen != counts(mlp_head=3 * SEG_FRAMES, upconv3x3_prelu=3 * SEG_FRAMES):
        raise AssertionError(f"segmentation: host-mode full pipeline launches {seen}")
    device = run(device_pipeline=True)
    gate("full pipeline, GT masks, host vs device mode", host, device)
    # frames/s over all the scenes, each mode twice in turns; a device-mode
    # call builds its FrameEstimator, so its figure holds one capture
    rates = {"host": [], "device": []}
    for mode in ("host", "device", "device", "host"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(all_frames, device_pipeline=mode == "device")
        torch.cuda.synchronize()
        rates[mode].append(len(all_frames) / (time.perf_counter() - t0))
    for mode, r in rates.items():
        timings[f"full_pipeline_{mode}_frames_per_s"] = sum(r) / len(r)
    print(f"  full pipeline frames/s (GT masks, {len(all_frames)} frames of {SERVE_K} objects, "
          f"{SERVE_ITERS} refine iterations, f32; modes in turns host, device, device, host; "
          f"a device-mode call captures its graph once): host "
          f"{' / '.join(f'{v:.2f}' for v in rates['host'])}, device "
          f"{' / '.join(f'{v:.2f}' for v in rates['device'])}")

    seg = SegNet(SEG_CLASSES, SEG_COLOUR_BLOCKS).to(DEVICE).eval()
    seg.load_state_dict(colour_segnet_state(SEG_CLASSES, SEG_COLOUR_BLOCKS))
    tt = seg_trainer_on(seg, "segnet")
    preds = [segment_frame(tt, f.color) for f in frames]
    acc = float(np.mean([(p == f.label).mean() for p, f in zip(preds, frames)]))

    def windows(p, f, o):
        h, w = p.shape
        m = p == o
        return (get_bbox_from_mask(largest_component_mask(m), h, w) if m.any() else None,
                get_bbox_from_mask(m & (f.depth > 0), h, w) if m.any() else None)
    same_window = {(o, fi) for fi, (p, f) in enumerate(zip(preds, frames)) for o in f.poses
                   if len(set(windows(p, f, o))) == 1}
    keys = {(o, sum(1 for j in range(fi) if o in frames[j].poses))
            for o, fi in same_window}
    seg_host = run(seg_predict=lambda c: segment_frame(tt, c))
    seg_dev = run(device_pipeline=True, seg_model=seg)
    maps = iter(preds)
    seg_fed = run(device_pipeline=True, seg_predict=lambda c: next(maps))
    inside = (seg_dev.per_object_distances == seg_fed.per_object_distances
              and seg_dev.lost_detections == seg_fed.lost_detections)
    print(f"  SegNet masks (two narrow blocks, colour weights): pixel accuracy {acc:.4f}; "
          f"device mode with the segmenter in its graph equal to device mode fed its "
          f"label maps {inside} (lost {seg_dev.lost_detections}); "
          f"{len(same_window)} of {sum(len(f.poses) for f in frames)} objects get the "
          f"same window in host and device mode")
    if not inside or not same_window:
        raise AssertionError("segmentation: SegNet masks in device mode")
    gate("full pipeline, SegNet masks, host vs device mode (the same windows)",
         seg_host, seg_dev, keys)

    # PoseCNN results: the first object of every frame undetected, and a
    # detection of a class with no mesh (extra, not estimated)
    pc = tmp / "posecnn"
    pc.mkdir()
    for fi, f in enumerate(frames):
        rois = []
        for o in sorted(f.poses)[1:]:
            ys, xs = np.nonzero(f.label == o)
            rois.append([0, o, xs.min() - 1, ys.min() - 1, xs.max() + 2, ys.max() + 2])
        rois.append([0, NUM_OBJ, 10, 10, 60, 60])
        sio.savemat(pc / f"{fi:06d}.mat", {"labels": f.label.astype(np.int32),
                                           "rois": np.asarray(rois, np.float32)})
    roi = run(seg_predict=PoseCNNMasks(str(pc)))
    ok = (roi.lost_detections == SEG_FRAMES and roi.extra_detections == SEG_FRAMES
          and roi.num_objects == SEG_FRAMES * SERVE_K)
    print(f"  PoseCNN ROI protocol: lost {roi.lost_detections}, extra "
          f"{roi.extra_detections}, scored {roi.num_objects}, AUC {roi.auc:.2f} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("segmentation: PoseCNN ROI counts")

    # the .mat export of the frames plot_accuracy --synthetic re-reads
    cfg = get_preset("ycb_refine")
    ds = SyntheticPoseDataset(num_frames=2, num_objects=3,
                              model_points=cfg.dataset.num_mesh_points,
                              num_points=cfg.model.num_points, seed=7)
    mats = tmp / "mat"
    res = evaluate_full_pipeline(pipe, ds.frames, dict(ds.models), cfg.dataset.sym_list,
                                 refine_iterations=2, save_mat_dir=str(mats))
    table = tmp / "table.json"
    real_cli("plot_accuracy", ["--mat_dir", str(mats), "--synthetic", "--json", str(table)],
             {})
    rows, want = json.loads(table.read_text()), accuracy_table(res.per_object_distances)
    same = (len(rows) == len(want) and all(
        r["object"] == w["object"] and r["count"] == w["count"]
        and abs(r["auc"] - w["auc"]) <= 1e-3 and r["under_2cm"] == w["under_2cm"]
        for r, w in zip(rows, want)))
    print(f"  .mat export of {res.num_frames} frames re-read by tools.plot_accuracy "
          f"--mat_dir --synthetic: the same table as in the process {same}")
    if not same:
        raise AssertionError(f"segmentation: plot_accuracy table {rows} != {want}")
    del pipe, seg
    torch.cuda.empty_cache()


def seg_cli_walls(tmp):
    """The segmentation CLIs as processes, with walls: train_segmentation
    (14 classes), eval_ycb --full_pipeline --save_mat and serve with the
    pspnet segmenter at seg_scale 2 at once; then segment_linemod on phase
    21's LineMOD tree (written again by its writer) and eval_linemod with
    those masks."""
    from concurrent.futures import ThreadPoolExecutor
    walls = {}
    lm_root = tmp / "Linemod_preprocessed"
    write_linemod_layout(lm_root, {})
    seg_dir = tmp / "seg14"
    with ThreadPoolExecutor(3) as pool:
        train = pool.submit(real_cli, "train_segmentation", [
            "--synthetic", "--nepoch", "1", "--num_classes", "14",
            "--save_path", str(seg_dir), "--logs_path", str(seg_dir)], walls)
        ycb = pool.submit(real_cli, "eval_ycb", [
            "--synthetic", "--full_pipeline", "--save_mat", str(tmp / "cli_mat")], walls)
        serve = pool.submit(real_cli, "serve", [
            "--synthetic", "--seg_arch", "pspnet", "--seg_scale", "2",
            "--num_frames", "4"], walls, "serve_seg")
        logs = {"train": train.result(), "eval_ycb": ycb.result(), "serve": serve.result()}
    masks = tmp / "segnet_results"
    logs["segment"] = real_cli("segment_linemod", [
        "--dataset_root", str(lm_root), "--model", str(seg_dir / "best.pt"),
        "--out", str(masks)], walls)
    logs["eval"] = real_cli("eval_linemod", [
        "--dataset_root", str(lm_root), "--segnet_results", str(masks),
        "--refine_iterations", "2"], walls, "eval_linemod_segmented")
    served = [json.loads(x) for x in logs["serve"].splitlines() if x.startswith("{")]
    ok = ("epoch 1: loss=" in logs["train"] and "ADD-S AUC (<0.1 m):" in logs["eval_ycb"]
          and sorted(os.listdir(tmp / "cli_mat")) == ["000000.mat", "000001.mat"]
          and len(served) == 4 and "wrote 4 predicted masks" in logs["segment"]
          and "mean success rate:" in logs["eval"])
    print(f"  CLIs as processes (walls, process start included; the first three at "
          f"once): {json.dumps({k: round(v, 2) for k, v in walls.items()})} s; "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"segmentation: CLIs: {logs}")
    return walls


@phase("segmentation")
def segmentation_phase(errs):
    """Segmentation and the config-5 full pipeline on the card: kernel 2 at
    the PSPNet segmenter's full-frame shapes, SegNet and the PSPNet
    segmenter at 480 x 640 x 22 classes, SegTrainer steps, FrameEstimator
    with each segmenter inside its graph, evaluate_full_pipeline in both
    modes and three mask sources, the CLIs, and the timings."""
    import tempfile
    timings = {}
    gen = torch.Generator().manual_seed(22)
    table = seg_kernel_checks(errs, gen)
    scenes = [serve_scene(s) for s in range(SEG_F[-1])]
    seg_forward_checks(scenes, timings)
    seg_train_checks(scenes, timings)
    launches = seg_serve_checks(scenes, timings)
    with tempfile.TemporaryDirectory() as tmp:
        seg_pipeline_checks(scenes, timings, Path(tmp))
        walls = seg_cli_walls(Path(tmp))
    timings.update({f"{k}_wall_s": v for k, v in walls.items()})
    return launches, table, timings


def add_seg_launches(entries, launches, table):
    """The segmented serving path's launches (its eager runs, by dtype)
    and kernel 2's times at the segmenter's frame shapes into the kernels
    line."""
    for e in entries:
        kname, _, dt_name = e["name"].rpartition("_")
        if kname not in SOURCES or dt_name not in launches:
            continue
        e["launches_by_path"]["segmentation"] = launches[dt_name][kname]
        e["launches"] += launches[dt_name][kname]
        if kname == "upconv3x3_prelu":
            for f, t in table[dt_name].items():
                e[f"segmenter_frame_f{f}"] = {
                    k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}


# ---------------- the parallel layer (phase 23) ----------------

# the train cell's width (batch TRAIN_BATCH, CROP px, NUM_POINTS points,
# NUM_OBJ objects, ITERS refine iterations) and serve's F = SERVE_F frames;
# estimates and run_frames against their single-device twins at POSE_TOL
# (PERF.md section 2)
PAR_SEED = 7
# a mesh step against its single-device twin: loss and dis relative at
# STEP_TOL's 1e-5, each gradient in relative L2, every tensor outside the
# colour encoder at STEP_TOL's 1e-3. The colour encoder's (`cnn.*`) f32
# gradients are ill-conditioned (tests/test_torch_port_train.py
# `_grad_error`): two f32 evaluations of them that round in another order
# (the mesh's BatchNorm takes E[x] and E[x^2], flax's order, where one
# device calls F.batch_norm; two ranks sum their halves) differ there by
# about as much as either differs from float64. So the mesh step is held
# to the single-device step where that costs nothing, and to its accuracy
# where it does:
# - in float64, through the plain versions: every gradient at 1e-3, the
#   loss and dis at 1e-5 (STEP_TOL);
# - in f32, through the kernels: the colour encoder's largest gradient
#   error against the float64 single-device step at most ACCURACY_FACTOR
#   times the f32 single-device step's, plus STEP_TOL's 1e-3. Two
#   roundings of one function land at one scale; a fault of the mesh
#   (statistics of one block, a gradient not averaged) moves the
#   gradients by far more, the other tensors' included;
# - in bf16 (mixed precision, one rank): the loss at MIXED_TOL's 2e-2, and
#   every gradient's largest error against the f32 single-device step at
#   most ACCURACY_FACTOR times the bf16 single-device step's, plus 2e-2.
ACCURACY_FACTOR = 2.0


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def collectives():
    from plr2_tpu_torch.parallel import mesh
    return dict(mesh.launches)


def reset_collectives():
    from plr2_tpu_torch.parallel import mesh
    for k in mesh.launches:
        mesh.launches[k] = 0


def grads_of(net):
    return {n: p.grad.detach().double().clone() for n, p in net.named_parameters()
            if p.grad is not None}


def rel_l2(grads, ref_grads):
    if set(grads) != set(ref_grads):
        raise AssertionError(f"gradients of {sorted(set(grads) ^ set(ref_grads))[:4]}")
    return {n: float((grads[n] - r).norm() / r.norm().clamp(min=1e-300))
            for n, r in ref_grads.items()}


def largest(gaps, cnn):
    """The largest of `gaps` in the colour encoder (`cnn`) or outside it."""
    return max((v for n, v in gaps.items() if n.startswith("cnn.") == cnn),
               default=0.0)


def step_gap(what, met, ref_met, grads, ref_grads, loss_tol, grad_tol=None,
             cnn_tol=None):
    """A mesh step against its single-device twin: loss and dis relative,
    each gradient in relative L2 (the colour encoder's largest and the
    rest's); the loss gated at `loss_tol`, dis with the gradients outside
    the colour encoder at `grad_tol`, the colour encoder's at `cnn_tol`
    (None: printed only)."""
    loss = abs(float(met["loss"]) - float(ref_met["loss"])) / abs(float(ref_met["loss"]))
    dis = abs(float(met["dis"]) - float(ref_met["dis"])) / abs(float(ref_met["dis"]))
    gaps = rel_l2(grads, ref_grads)
    cnn, rest = largest(gaps, True), largest(gaps, False)
    ok = (loss <= loss_tol
          and (grad_tol is None or (dis <= loss_tol and rest <= grad_tol))
          and (cnn_tol is None or cnn <= cnn_tol))
    print(f"  {what} vs the single-device step: loss rel {loss:.2e} (tol "
          f"{loss_tol:g}), dis rel {dis:.2e}, gradients largest rel L2: colour "
          f"encoder {cnn:.2e} (tol {cnn_tol if cnn_tol is not None else '-'}), "
          f"the rest {rest:.2e} (tol {grad_tol if grad_tol is not None else '-'}); "
          f"worst {max(gaps, key=gaps.get)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the mesh step disagrees")
    return {"loss": loss, "dis": dis, "grad_l2": rest, "cnn_grad_l2": cnn}


def accuracy_gap(what, grads, single_grads, ref_grads, ref_name, slack,
                 parts=(True,)):
    """The mesh step's gradients against the higher-precision `ref_grads`,
    beside the single-device step's: in each of `parts` (True: the colour
    encoder, False: the rest) the mesh's largest rel. L2 error at most
    ACCURACY_FACTOR times the single device's, plus `slack`."""
    em, es = rel_l2(grads, ref_grads), rel_l2(single_grads, ref_grads)
    out, ok = {}, True
    for cnn in parts:
        m, one = largest(em, cnn), largest(es, cnn)
        good = m <= ACCURACY_FACTOR * one + slack
        ok = ok and good
        name = "colour encoder" if cnn else "the rest"
        print(f"  {what}, {name}'s gradients against {ref_name}: largest rel "
              f"L2 error mesh {m:.3e}, single device {one:.3e} (gate: mesh <= "
              f"{ACCURACY_FACTOR:g} x single + {slack:g}) {'ok' if good else 'FAIL'}")
        out["cnn" if cnn else "rest"] = (m, one)
    if not ok:
        raise AssertionError(f"{what}: the mesh step is less accurate than "
                             "the single-device step")
    return out


def f64_step(mesh, batch):
    """The stage-1 step in float64 through the plain versions (no kernel),
    over `mesh` (None: one device, the global batch): (metrics, gradients)."""
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.parallel import make_train_step
    b64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
           for k, v in batch.items()}
    pipe = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, use_kernels=False,
                               device=DEVICE, seed=0).cast(torch.float64)
    step = make_train_step(pipe, SYM_LIST, W, LR, mesh=mesh, sym_slots=NUM_SYM)
    met = run_step(step, b64, PAR_SEED)
    out = met, grads_of(step.network)
    del pipe, step
    torch.cuda.empty_cache()
    return out


def f64_gaps(what, mesh, batch, ref64, met32, grads32, single_met32,
             single_grads32):
    """`f64_step` over `mesh` against `ref64`, the one-device float64 step,
    at STEP_TOL on every gradient, and the f32 steps' colour-encoder
    gradients against `ref64` (`accuracy_gap`)."""
    m64, g64 = f64_step(mesh, batch)
    s64, r64 = ref64
    gap64 = step_gap(f"{what} in float64 (plain versions)", m64, s64, g64, r64,
                     STEP_TOL["loss"], STEP_TOL["grad_l2"], STEP_TOL["grad_l2"])
    acc = accuracy_gap(f"{what} f32", grads32, single_grads32, r64,
                       "the float64 single-device step", STEP_TOL["grad_l2"])
    for name, m in (("mesh", met32), ("single device", single_met32)):
        print(f"  {what} f32 {name}: loss {float(m['loss']):.9f} against "
              f"float64 {float(s64['loss']):.9f}")
    return gap64, acc


def check_collectives(what, seen):
    n = sum(seen.values())
    print(f"  {what}: {seen} collectives")
    if n < 1:
        raise AssertionError(f"{what} launched no collective")


def par_frames():
    """F = SERVE_F make_scene frames of SERVE_K objects: run_frames' inputs."""
    import numpy as np
    scenes = [serve_scene(s) for s in range(SERVE_F)]
    ids = np.arange(1, SERVE_K + 1)
    frames = [serve_inputs(fr, m, d, ids)[0] for fr, m, d in scenes]
    return [torch.stack(x) for x in zip(*frames)], torch.arange(SERVE_F, device=DEVICE)


def par_run_frames(mesh, pipe, graphs, stacked, seeds, dt_name):
    """run_frames over `mesh`, eagerly, after 0, ITERS and SERVE_ITERS
    refine iterations (the hypotheses from the recorded confidences),
    against two unsharded calls:
    - on this rank's block of frames alone (the F / n frames whose crops
      make its PoseNet batch): gated at POSE_TOL at every count in both
      dtypes. This is what the mesh adds, and it should be nothing: the
      line says whether the two are bit-equal;
    - on all F frames: f32 gated at every count. A PoseNet batch of F / n
      frames rounds cuDNN's bf16 convolutions otherwise than one of F, and
      the seeded refiner amplifies that at each iteration (the serve
      phase's rule), with no mesh at all: so beside the split, the block
      call itself is held against the F call (the batch-size reading),
      and bf16 is gated up to ITERS at that reading plus POSE_TOL.
    Then the frames/s of the mesh and the F call at SERVE_ITERS, graphed
    if `graphs`. Returns the frames/s, the kernel launches of the first
    eager run over the mesh, and the largest |dt| of each comparison."""
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    from plr2_tpu_torch.serving import FrameEstimator, FramePoses
    ax = mesh.axis("data")
    blk = ax.block(SERVE_F, "the frames")

    def estimator(iters, graphs_, mesh_=None):
        return FrameEstimator(pipe, canvas=SERVE_CANVAS, refine_iterations=iters,
                              graphs=graphs_, mesh=mesh_)

    def rows(conf):  # this rank's frames' slots of an F-frame call
        k = conf.shape[0] // SERVE_F
        return conf[blk.start * k:blk.stop * k]
    seen, gaps = None, {}
    for iters in (0, ITERS, SERVE_ITERS):
        sharded, whole = estimator(iters, False, mesh), estimator(iters, False)
        reset_launch_counts()
        got, cg = recorded_conf(pipe, lambda: sharded.run_frames(*stacked, seeds))
        seen = seen or launch_counts()
        part, cp = recorded_conf(pipe, lambda: whole.run_frames(
            *(x[blk] for x in stacked), seeds[blk]))
        mine = FramePoses(*(x[blk] for x in got))
        exact = all(torch.equal(a, b) for a, b in zip(mine, part))
        tag = f"run_frames over {mesh.shape} (F = {SERVE_F}, {iters} iterations)"
        gaps[(iters, "block")] = same_poses(
            f"{tag}: rank {mesh.rank}'s {blk.stop - blk.start} frames vs the "
            f"unsharded call on them (bit-equal {exact})", dt_name, mine, part,
            cg, cp)[1]
        if ax.size == 1:  # the block is the whole
            continue
        ref, cr = recorded_conf(pipe, lambda: whole.run_frames(*stacked, seeds))
        reading = same_poses(
            f"  ... the unsharded call on those {blk.stop - blk.start} frames vs "
            f"the F = {SERVE_F} call (no mesh)", dt_name, part,
            FramePoses(*(x[blk] for x in ref)), cp, rows(cr), gated=False)
        split = same_poses(f"{tag} vs the F = {SERVE_F} call", dt_name, got, ref,
                           ax.gather_rows(cg), cr, dt_name == "f32")
        gaps[(iters, "reading")], gaps[(iters, "whole")] = reading[1], split[1]
        if dt_name != "f32" and iters <= ITERS:
            # the split covers every rank's block: their largest readings
            worst = ax.all_gather(torch.tensor(reading, device=DEVICE)).amax(0)
            limit = [float(r) + POSE_TOL[dt_name] for r in worst]
            ok = split[0] <= limit[0] and split[1] <= limit[1]
            print(f"  {tag} bf16 vs the F = {SERVE_F} call: max |dq| {split[0]:.3e} "
                  f"|dt| {split[1]:.3e} against the batch-size reading plus "
                  f"{POSE_TOL[dt_name]:g}: {limit[0]:.3e} / {limit[1]:.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag}: the split differs from the F call "
                                     "by more than the batch size explains")
    sharded, whole = estimator(SERVE_ITERS, graphs, mesh), estimator(SERVE_ITERS, graphs)
    ms = time_ms(lambda: sharded.run_frames(*stacked, seeds), 5)
    ms_whole = time_ms(lambda: whole.run_frames(*stacked, seeds), 5)
    return SERVE_F * 1e3 / ms, SERVE_F * 1e3 / ms_whole, seen, gaps


def par_estimate(what, dt_name, pipe, ref_pipe, fn, inputs, gather=None):
    """An estimate through `fn` against ref_pipe.estimate on `inputs`."""
    got, cg = recorded_conf(pipe, lambda: fn(*inputs))
    ref, cr = recorded_conf(ref_pipe, lambda: ref_pipe.estimate(*inputs, ITERS))
    if gather is not None:
        cg = gather(cg)
    from plr2_tpu_torch.serving import FramePoses
    valid = torch.ones(inputs[0].shape[0], dtype=torch.bool, device=DEVICE)

    def poses(e):
        return FramePoses(e.quat, e.trans, e.confidence, valid, ~valid)
    same_poses(what, dt_name, poses(got), poses(ref), cg, cr)


def par_nccl_steps(timings, launches):
    """(a): the graphed data-parallel BatchTrainer step over a 1-rank NCCL
    mesh, f32 and bf16, against the single-device step (the gates above
    ACCURACY_FACTOR). Returns the float64 single-device step (`f64_step`), the
    reference of the other steps' colour-encoder gradients."""
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    from plr2_tpu_torch.parallel import make_mesh
    from plr2_tpu_torch.train import BatchTrainer
    batch = train_batch()
    single_f32 = ref64 = None
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = train_config(dtype="float32" if dt_name == "f32" else "bfloat16",
                           batch_size=TRAIN_BATCH, sym_slots=NUM_SYM)
        trainers = {}
        for name, mesh, graphs in (("mesh", make_mesh(1), True),
                                   ("single", None, False),
                                   ("single_graph", None, True)):
            pipe = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0,
                                       dtype=dtype)
            tr = BatchTrainer(cfg, pipe=pipe, graphs=graphs, mesh=mesh)
            trainers[name] = (tr, tr.stage_step(tr.init_state()))
        tr, step = trainers["mesh"]
        reset_launch_counts()
        reset_collectives()
        met = tr._step(step, batch, torch.Generator(device=DEVICE).manual_seed(PAR_SEED))
        torch.cuda.synchronize()
        seen, coll = launch_counts(), collectives()
        launches[dt_name] = {k: launches[dt_name].get(k, 0) + v for k, v in seen.items()}
        print(f"  graphed DP step ({dt_name}, 1-rank NCCL mesh, batch {TRAIN_BATCH}) "
              f"warm-up + capture + replay: kernel launches {seen}")
        check_collectives(f"graphed DP step {dt_name} (BN statistics, gradients, "
                          "metrics; captured)", coll)
        if seen["mlp_head"] < 3 or seen["upconv3x3_prelu"] < 3 or \
                seen["gather_rows_backward"] < 1 or seen["nn_match"] < 1:
            raise AssertionError(f"graphed DP step {dt_name}: launches {seen}")
        if DEVICE == "cuda" and tr.graphs.captures != 1:
            raise AssertionError(f"graphed DP step {dt_name}: "
                                 f"{tr.graphs.captures} captures, not 1")
        str_, sstep = trainers["single"]
        ref = str_._step(sstep, batch, torch.Generator(device=DEVICE).manual_seed(PAR_SEED))
        what = f"graphed DP step {dt_name}"
        grads, single = grads_of(step.network), grads_of(sstep.network)
        met, ref = ({k: float(v) for k, v in m.items()} for m in (met, ref))
        if dt_name == "f32":
            gap = step_gap(what, met, ref, grads, single, STEP_TOL["loss"],
                           STEP_TOL["grad_l2"])
            single_f32 = single
        else:
            gap = step_gap(what, met, ref, grads, single, MIXED_TOL["kernel_vs_plain"])
            acc = accuracy_gap(what, grads, single, single_f32,
                               "the f32 single-device step",
                               MIXED_TOL["kernel_vs_plain"], (True, False))
        timings[f"dp_graph_step_gap_{dt_name}"] = gap["cnn_grad_l2"]
        timings[f"dp_graph_step_gap_rest_{dt_name}"] = gap["grad_l2"]
        gtr, gstep = trainers["single_graph"]
        gtr._step(gstep, batch, torch.Generator(device=DEVICE).manual_seed(PAR_SEED))
        gen = torch.Generator(device=DEVICE)
        for name in ("mesh", "single_graph", "single"):
            t, s = trainers[name]
            timings[f"step_ms_{name}_{dt_name}"] = time_ms(
                lambda: t._step(s, batch, gen.manual_seed(PAR_SEED)), 5)
        print(f"  step ms ({dt_name}): graphed 1-rank NCCL mesh "
              f"{timings[f'step_ms_mesh_{dt_name}']:.3f}, graphed single device "
              f"{timings[f'step_ms_single_graph_{dt_name}']:.3f}, eager single "
              f"device {timings[f'step_ms_single_{dt_name}']:.3f}")
        del trainers, tr, step, str_, sstep, gtr, gstep
        torch.cuda.empty_cache()
        if dt_name == "f32":  # the float64 twins, with the trainers freed
            ref64 = f64_step(None, batch)
            gap64, acc = f64_gaps("DP step, 1-rank NCCL mesh", make_mesh(1), batch,
                                  ref64, met, grads, ref, single)
            timings["dp_f64_grad_l2"] = max(gap64["grad_l2"], gap64["cnn_grad_l2"])
        for part, (m, one) in acc.items():
            timings[f"dp_graph_step_err_{part}_{dt_name}"] = m
            timings[f"single_step_err_{part}_{dt_name}"] = one
        del grads
    return ref64


def par_nccl_axes(timings, launches, ref64):
    """(a): run_frames over the mesh, and the tensor-, point- and
    pipeline-parallel steps on 1-rank NCCL meshes, f32."""
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.ops import knn, launch_counts, reset_launch_counts
    from plr2_tpu_torch.parallel import (make_inference_step, make_mesh,
                                         make_pp_estimate_step,
                                         make_sp_inference_step,
                                         make_sp_train_step, make_train_step,
                                         shard_pipeline, sp_match)
    stacked, seeds = par_frames()
    pipe = DenseFusionPipeline(SERVE_POINTS, NUM_OBJ, device=DEVICE, seed=0)
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if dtype != torch.float32:
            pipe.cast(dtype)
        reset_collectives()
        rate, rate_whole, seen, _ = par_run_frames(make_mesh(1), pipe, True,
                                                   stacked, seeds, dt_name)
        launches[dt_name] = {k: launches[dt_name].get(k, 0) + v
                             for k, v in seen.items()}
        check_collectives(f"run_frames over a 1-rank mesh {dt_name}", collectives())
        timings[f"run_frames_mesh1_fps_{dt_name}"] = rate
        timings[f"run_frames_whole_fps_{dt_name}"] = rate_whole
        print(f"  run_frames {dt_name} graphed: 1-rank mesh {rate:.1f} frames/s, "
              f"unsharded {rate_whole:.1f}")
    del pipe
    batch = train_batch()
    inputs = main_inputs(BATCH)

    def pipes():
        return [DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0)
                for _ in range(2)]

    def step_pair(what, step, ref_step, expect):
        reset_launch_counts()
        reset_collectives()
        met = run_step(step, batch, PAR_SEED)
        seen, coll = launch_counts(), collectives()
        launches["f32"] = {k: launches["f32"].get(k, 0) + v for k, v in seen.items()}
        print(f"  {what}: kernel launches {seen}")
        check_collectives(what, coll)
        if seen != expect:
            raise AssertionError(f"{what}: expected launches {expect}, got {seen}")
        ref = run_step(ref_step, batch, PAR_SEED)
        grads, single = grads_of(step.network), grads_of(ref_step.network)
        key = what.split()[0]
        timings[f"{key}_grad_l2"] = step_gap(
            what, met, ref, grads, single, STEP_TOL["loss"],
            STEP_TOL["grad_l2"])["cnn_grad_l2"]
        timings[f"{key}_err_cnn"] = accuracy_gap(
            what, grads, single, ref64[1], "the float64 single-device step",
            STEP_TOL["grad_l2"])["cnn"][0]
        del grads, single
        timings[f"step_ms_{key}"] = time_ms(
            lambda: run_step(step, batch, PAR_SEED), 3)

    # tensor parallelism over a (data, model) = (1, 1) mesh: kernel 1 does
    # not run on the sliced heads (per-layer F.linear)
    tp, ref = pipes()
    mesh = make_mesh(1, ("data", "model"), shape=(1, 1))
    shard_pipeline(mesh, tp)
    reset_collectives()
    par_estimate("tensor-parallel estimate", "f32", tp, ref,
                 make_inference_step(tp, ITERS, mesh), inputs)
    check_collectives("tensor-parallel estimate", collectives())
    step_pair("tensor-parallel stage-1 step",
              make_train_step(tp, SYM_LIST, W, LR, mesh=mesh, sym_slots=NUM_SYM),
              make_train_step(ref, SYM_LIST, W, LR, sym_slots=NUM_SYM),
              counts(upconv3x3_prelu=3, nn_match=1, gather_rows_backward=1))
    # point parallelism over a 1-rank points axis
    sp, ref = pipes()
    mesh = make_mesh(1, ("points",))
    reset_collectives()
    par_estimate("point-parallel estimate", "f32", sp, ref,
                 make_sp_inference_step(sp, mesh, ITERS), inputs)
    check_collectives("point-parallel estimate", collectives())
    step_pair("point-parallel stage-1 step",
              make_sp_train_step(sp, mesh, SYM_LIST, W, LR, sym_slots=NUM_SYM),
              make_train_step(ref, SYM_LIST, W, LR, sym_slots=NUM_SYM),
              counts(mlp_head=3, upconv3x3_prelu=3, nn_match=1,
                     gather_rows_backward=1))
    # one sample's ADD-S queries (NUM_POINTS hypotheses x MESH_POINTS)
    q = (batch["points"][0][:, None, :] + batch["model_points"][0]).reshape(-1, 3)
    t = batch["target"][0].contiguous()
    reset_collectives()
    before = knn.launches["nn_match"]
    got = sp_match(mesh, q, t)
    n = knn.launches["nn_match"] - before
    ok = n == 1 and torch.equal(got.view(torch.int32),
                                knn.nn_match(q, t).view(torch.int32))
    print(f"  sp_match over a 1-rank points axis ({q.shape[0]} queries x "
          f"{t.shape[0]} targets): {n} launch of nn_match, bit-equal to "
          f"nn_match {'ok' if ok else 'FAIL'}")
    check_collectives("sp_match", collectives())
    if not ok:
        raise AssertionError("sp_match differs from nn_match")
    # pipeline parallelism: one stage of ITERS iterations, 2 micro-batches
    pp, ref = pipes()
    reset_collectives()
    par_estimate("pipelined estimate (1 stage x 2 iterations, 2 micro-batches)",
                 "f32", pp, ref, make_pp_estimate_step(pp, make_mesh(1, ("pipe",)), 2,
                                                       iters_per_stage=ITERS),
                 inputs)
    check_collectives("pipelined estimate", collectives())
    del tp, sp, pp, ref
    torch.cuda.empty_cache()


def par_rank(frames_args):
    """(b): one of 2 gloo ranks sharing the card (spawned, eager): the DP
    step at batch TRAIN_BATCH (TRAIN_BATCH / 2 a rank) against the
    single-device step on the global batch, run_frames with F = SERVE_F
    split 4 / 4 against the unsharded call (f32 and bf16), sp_match
    bit-equal to nn_match, the pipelined estimate with pipe = 2."""
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.ops import knn, launch_counts, reset_launch_counts
    from plr2_tpu_torch.parallel import (make_mesh, make_pp_estimate_step,
                                         make_train_step, sp_match)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    mesh = make_mesh(2)
    rank = mesh.rank
    batch = train_batch()
    pm, ps = (DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0)
              for _ in range(2))
    step = make_train_step(pm, SYM_LIST, W, LR, mesh=mesh, sym_slots=NUM_SYM)
    ref_step = make_train_step(ps, SYM_LIST, W, LR, sym_slots=NUM_SYM)
    reset_launch_counts()
    reset_collectives()
    met = run_step(step, batch, PAR_SEED)
    out["launches"], out["collectives"] = launch_counts(), collectives()
    ref = run_step(ref_step, batch, PAR_SEED)
    grads, single = grads_of(step.network), grads_of(ref_step.network)
    what = f"rank {rank}: 2-rank gloo DP step"
    out["dp_gap"] = step_gap(f"{what} f32", met, ref, grads, single,
                             STEP_TOL["loss"], STEP_TOL["grad_l2"])
    t0 = time.perf_counter()
    for _ in range(3):
        run_step(step, batch, PAR_SEED)
    out["dp_step_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    del pm, ps, step, ref_step
    torch.cuda.empty_cache()
    # the float64 twins: the mesh step on both ranks, the one-device step
    # and the comparisons on rank 0 (the mesh's gradients are the same on
    # both)
    if rank == 0:
        ref64 = f64_step(None, batch)
        gap64, acc = f64_gaps(what, mesh, batch, ref64, met, grads, ref, single)
        out["dp_f64_grad_l2"] = max(gap64["grad_l2"], gap64["cnn_grad_l2"])
        out["dp_err_cnn"] = acc["cnn"]
        del ref64
    else:
        f64_step(mesh, batch)
    del grads, single
    torch.cuda.empty_cache()
    stacked, seeds = frames_args
    stacked, seeds = [x.to(DEVICE) for x in stacked], seeds.to(DEVICE)
    pipe = DenseFusionPipeline(SERVE_POINTS, NUM_OBJ, device=DEVICE, seed=0)
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if dtype != torch.float32:
            pipe.cast(dtype)
        *out[f"fps_{dt_name}"], out[f"frames_launches_{dt_name}"], \
            out[f"frames_dt_{dt_name}"] = par_run_frames(mesh, pipe, False, stacked,
                                                         seeds, dt_name)
    del pipe
    # one sample's ADD-S queries (NUM_POINTS hypotheses x MESH_POINTS)
    q = (batch["points"][0][:, None, :] + batch["model_points"][0]).reshape(-1, 3)
    t = batch["target"][0].contiguous()
    before = knn.launches["nn_match"]
    got = sp_match(make_mesh(2, ("points",)), q, t)
    out["sp_match_launches"] = knn.launches["nn_match"] - before
    out["sp_match_equal"] = torch.equal(got.view(torch.int32),
                                        knn.nn_match(q, t).view(torch.int32))
    pp, ref_pipe = (DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0)
                    for _ in range(2))
    ring = make_mesh(2, ("pipe",))
    par_estimate(f"rank {rank}: pipelined estimate (pipe = 2, 4 micro-batches)",
                 "f32", pp, ref_pipe, make_pp_estimate_step(pp, ring, 4),
                 main_inputs(BATCH), gather=ring.axis("pipe").gather_rows)
    out["pp_ok"] = True
    return out


@phase("parallel")
def parallel_phase():
    """The parallel layer (plr2_tpu_torch/parallel/) on the card: (a) one
    rank over NCCL: the graphed data-parallel BatchTrainer step (BN and
    gradient collectives captured), run_frames over the mesh, the tensor-,
    point- and pipeline-parallel steps; (b) two gloo ranks on the one card,
    spawned, eager. Each against its single-device twin."""
    import torch.distributed as dist
    from plr2_tpu_torch.parallel import init_distributed
    from plr2_tpu_torch.parallel.launch import spawn_ranks
    timings = {}
    launches = {"f32": {}, "bf16": {}}
    init_distributed("nccl", f"tcp://localhost:{free_port()}", 0, 1)
    torch.cuda.set_device(0)
    try:
        par_nccl_axes(timings, launches, par_nccl_steps(timings, launches))
    finally:
        dist.destroy_process_group()
    stacked, seeds = par_frames()
    t0 = time.perf_counter()
    outs = spawn_ranks(par_rank, 2, (([x.cpu() for x in stacked], seeds.cpu()),),
                       backend="gloo", threads=0, timeout=600)
    print(f"  2 gloo ranks on one card: wall {time.perf_counter() - t0:.1f} s")
    for r, o in enumerate(outs):
        expect = counts(mlp_head=3, upconv3x3_prelu=3, nn_match=1,
                        gather_rows_backward=1)
        print(f"  rank {r}: DP step launches {o['launches']}, collectives "
              f"{o['collectives']}, step {o['dp_step_ms']:.3f} ms (wall, both "
              f"ranks on one card), run_frames {o['fps_f32'][0]:.1f} / "
              f"{o['fps_bf16'][0]:.1f} frames/s f32 / bf16 (unsharded "
              f"{o['fps_f32'][1]:.1f} / {o['fps_bf16'][1]:.1f}), sp_match "
              f"{o['sp_match_launches']} launch, bit-equal {o['sp_match_equal']}")
        if o["launches"] != expect or sum(o["collectives"].values()) < 1:
            raise AssertionError(f"rank {r}: DP step launches {o['launches']}, "
                                 f"expected {expect}")
        if not o["sp_match_equal"] or o["sp_match_launches"] != 1 or not o["pp_ok"]:
            raise AssertionError(f"rank {r}: sp_match / pipelined estimate failed")
        for dt_name in ("f32", "bf16"):
            seen = o[f"frames_launches_{dt_name}"]
            launches[dt_name] = {k: launches[dt_name].get(k, 0) + v
                                 for k, v in seen.items()}
        launches["f32"] = {k: launches["f32"].get(k, 0) + v
                           for k, v in o["launches"].items()}
        timings[f"gloo2_dp_step_ms_rank{r}"] = o["dp_step_ms"]
        timings[f"gloo2_run_frames_fps_f32_rank{r}"] = o["fps_f32"][0]
        timings[f"gloo2_run_frames_fps_bf16_rank{r}"] = o["fps_bf16"][0]
        timings[f"gloo2_dp_grad_l2_rank{r}"] = o["dp_gap"]["cnn_grad_l2"]
        for dt_name in ("f32", "bf16"):
            for (iters, kind), dt in o[f"frames_dt_{dt_name}"].items():
                key = f"gloo2_frames_dt_{dt_name}_{kind}_{iters}"
                timings[key] = max(timings.get(key, 0.0), dt)
        if r == 0:
            timings["gloo2_dp_f64_grad_l2"] = o["dp_f64_grad_l2"]
            (timings["gloo2_dp_err_cnn_mesh"],
             timings["gloo2_dp_err_cnn_single"]) = o["dp_err_cnn"]
    return launches, timings


def add_path_launches(entries, launches, path):
    """A phase's launches (per dtype; the dtype-free kernels summed) into
    the kernels line under `path`."""
    for e in entries:
        kname, _, dt_name = e["name"].rpartition("_")
        if kname in SOURCES and dt_name in launches:
            n = launches[dt_name].get(kname, 0)
        elif e["name"] in launches["f32"]:
            n = sum(launches[d].get(e["name"], 0) for d in launches)
        else:
            continue
        e["launches_by_path"][path] = n
        e["launches"] += n


# ---------------- the tail: YAML configs, trunk import, .pth export, tools (phase 24) ----

# the tools' widths: tools/overfit_synthetic.py and train_synthetic_e2e.py
# (500 points, 4 objects, 256-point meshes, 240 px canvas), and the
# linemod_train preset of the --config run (500 points, 13 objects)
TAIL_POINTS, TAIL_OBJ, TAIL_MESH, TAIL_CANVAS = 500, 4, 256, 240
TAIL_SEED = 17
# a torchvision resnet18's partial load into the deep-stem trunk: 18
# convs and their 18 BatchNorms x 4 tensors imported, 32 keys skipped
# (tests/test_torch_port_tail.py TRUNK_COUNTS)
TRUNK_COUNTS = (90, 32)
OVERFIT_STEPS, E2E_STEPS, E2E_EVERY, E2E_BATCH = 100, 200, 100, 32


def fake_torchvision_resnet18(seed):
    """torchvision.models.resnet18's state-dict layout, values from `seed`
    (the fabricated state dict of tests/test_torchvision_import.py)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def add(name, shape):
        sd[name] = torch.tensor(rng.standard_normal(shape).astype(np.float32) * 0.1)

    def add_bn(prefix, ch):
        add(f"{prefix}.weight", (ch,))
        add(f"{prefix}.bias", (ch,))
        add(f"{prefix}.running_mean", (ch,))
        sd[f"{prefix}.running_var"] = torch.tensor(
            rng.uniform(0.5, 1.5, (ch,)).astype(np.float32))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    add("conv1.weight", (64, 3, 7, 7))
    add_bn("bn1", 64)
    for li, (inp, planes) in {1: (64, 64), 2: (64, 128), 3: (128, 256),
                              4: (256, 512)}.items():
        for bi in range(2):
            p, cin = f"layer{li}.{bi}", inp if bi == 0 else planes
            add(f"{p}.conv1.weight", (planes, cin, 3, 3))
            add_bn(f"{p}.bn1", planes)
            add(f"{p}.conv2.weight", (planes, planes, 3, 3))
            add_bn(f"{p}.bn2", planes)
            if bi == 0 and li > 1:
                add(f"{p}.downsample.0.weight", (planes, cin, 1, 1))
                add_bn(f"{p}.downsample.1", planes)
    add("fc.weight", (1000, 512))
    add("fc.bias", (1000,))
    return sd


def tail_cli(name, args, walls, timeout=300):
    """`python -m plr2_tpu_torch.tools.<name>` on the card; its wall time
    into `walls`. Returns stdout + stderr."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"plr2_tpu_torch.tools.{name}", *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    walls[f"{name}_wall_s"] = time.perf_counter() - t0
    out = res.stdout + res.stderr
    if res.returncode != 0:
        raise AssertionError(f"{name} CLI failed (rc {res.returncode}): {out[-3000:]}")
    return out


def tail_config_run(tmp, timings):
    """save_config -> load_config equal; the trunk import into the trainer's
    pipeline on the card (tensors, stem, counts); `tools.train --config
    --synthetic --pretrained_trunk` as a process; export_torch on its best
    and load_reference_checkpoint into a fresh pipeline: a bit-equal f32
    estimate. Returns the launches of the in-process estimates."""
    import dataclasses
    from plr2_tpu_torch import ops
    from plr2_tpu_torch.config import get_preset
    from plr2_tpu_torch.config_io import load_config, save_config
    from plr2_tpu_torch.models.torch_import import (load_pretrained_trunk,
                                                    load_reference_checkpoint)
    from plr2_tpu_torch.pipeline import DenseFusionPipeline
    from plr2_tpu_torch.tools import export_torch
    from plr2_tpu_torch.train import CheckpointManager, Trainer
    cfg = get_preset("linemod_train")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, nepoch=2))
    yml, pth = tmp / "linemod_train.yml", tmp / "resnet18.pth"
    save_config(cfg, str(yml))
    if load_config(str(yml)) != cfg:
        raise AssertionError("tail: save_config -> load_config changed the config")
    sd = fake_torchvision_resnet18(TAIL_SEED)
    torch.save(sd, pth)
    trainer = Trainer(cfg, device=DEVICE)
    init_stem = trainer.pipe.posenet.cnn.model.feats.conv1.weight.clone()
    imported, skipped = load_pretrained_trunk(str(pth), trainer.pipe)
    own = trainer.pipe.posenet.cnn.model.feats.state_dict()
    bad = [k for k in imported if not torch.equal(own[k].cpu(), sd[k])]
    if (len(imported), len(skipped)) != TRUNK_COUNTS or bad or not torch.equal(
            own["conv1.weight"], init_stem):
        raise AssertionError(f"tail: trunk import {len(imported)} / {len(skipped)} "
                             f"(expected {TRUNK_COUNTS}), differing {bad[:5]}")
    print(f"  trunk import on the card: {len(imported)} imported, {len(skipped)} "
          f"skipped; imported tensors equal the source, the stem kept its init ok")
    del trainer, own
    out = tail_cli("train", ["--config", str(yml), "--synthetic", "--pretrained_trunk",
                             str(pth), "--outf", str(tmp / "out"), "--log_dir",
                             str(tmp / "logs")], timings)
    want = (f"{TRUNK_COUNTS[0]} tensors imported, {TRUNK_COUNTS[1]} without a "
            "deep-stem counterpart kept at init")
    if want not in out or "epoch 2:" not in out:
        raise AssertionError(f"tail: train --config run: {out[-2000:]}")
    for line in out.splitlines():
        if "pretrained trunk" in line or line.startswith("epoch "):
            print(f"  train: {line}")
    ckpt_dir = tmp / "out" / "linemod"
    paths = export_torch.main(["--checkpoint", str(ckpt_dir), "--out_dir",
                               str(tmp / "exported"), "--reference_names"])
    payload = CheckpointManager(str(ckpt_dir)).restore("best")
    ref = DenseFusionPipeline(cfg.model.num_points, cfg.model.num_objects, seed=1)
    ref.posenet.load_state_dict(payload["posenet"])
    ref.refiner.load_state_dict(payload["refiner"])
    pipe = load_reference_checkpoint(paths[0], DenseFusionPipeline(
        cfg.model.num_points, cfg.model.num_objects, seed=2), paths[1])
    gen = torch.Generator().manual_seed(TAIL_SEED)
    inputs = (_rand((BATCH, CROP, CROP, 3), gen),
              _rand((BATCH, cfg.model.num_points, 3), gen, 0.1),
              torch.randint(0, CROP * CROP, (BATCH, cfg.model.num_points),
                            generator=gen).to(DEVICE),
              (torch.arange(BATCH) % cfg.model.num_objects).to(DEVICE))
    ops.reset_launch_counts()
    want_est, got_est = ref.estimate(*inputs), pipe.estimate(*inputs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if not all(torch.equal(a, b) for a, b in zip(got_est, want_est)):
        raise AssertionError("tail: the exported and reloaded pipeline's estimate differs")
    print(f"  export_torch {[Path(x).name for x in paths]} -> load_reference_checkpoint: "
          f"f32 estimate (batch {BATCH}, {cfg.model.num_points} points) bit-equal ok")
    return launches


def tail_overfit(timings):
    """overfit_synthetic at batch 8, f32 and --bf16: the final dis below
    the first. Returns the launches by dtype."""
    from plr2_tpu_torch import ops
    from plr2_tpu_torch.tools import overfit_synthetic
    launches = {}
    for dt_name, flag in (("f32", []), ("bf16", ["--bf16"])):
        ops.reset_launch_counts()
        out = overfit_synthetic.main(["--steps", str(OVERFIT_STEPS), "--batch",
                                      str(BATCH), *flag])
        torch.cuda.synchronize()
        launches[dt_name] = ops.launch_counts()
        (_, _, first), (_, _, last) = out["history"][0], out["history"][-1]
        timings[f"overfit_{dt_name}_samples_per_s"] = out["samples_per_s"]
        timings[f"overfit_{dt_name}_dis_first"] = first
        timings[f"overfit_{dt_name}_dis_last"] = last
        ok = math.isfinite(last) and last < first
        print(f"  overfit_synthetic {dt_name}: dis {first:.5f} -> {last:.5f} over "
              f"{OVERFIT_STEPS} steps at batch {BATCH}, {out['samples_per_s']:.1f} "
              f"samples/s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"tail: overfit {dt_name} dis did not fall")
    return launches


def tail_e2e(tmp, timings):
    """train_synthetic_e2e shortened: its FINAL line. Returns the launches."""
    import contextlib
    import io
    from plr2_tpu_torch import ops
    from plr2_tpu_torch.tools import train_synthetic_e2e
    ops.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = train_synthetic_e2e.main(["--steps", str(E2E_STEPS), "--batch",
                                        str(E2E_BATCH), "--eval_every",
                                        str(E2E_EVERY), "--outf", str(tmp / "e2e")])
    torch.cuda.synchronize()
    # the soak run's processes share the card meanwhile
    timings["e2e_short_wall_s"] = time.perf_counter() - t0
    launches = ops.launch_counts()
    for line in buf.getvalue().splitlines():
        print(f"  e2e: {line}")
    if not (math.isfinite(res.auc) and res.num_samples > 0):
        raise AssertionError(f"tail: e2e evaluation {res}")
    timings["e2e_short_auc"], timings["e2e_short_under_2cm"] = res.auc, res.under_2cm
    return launches


def tail_soak_start(tmp):
    """Start `tools.soak_run --mode fused` (one SIGTERM after epoch 2, a
    4-epoch horizon, 16 frames) as the leader of a new process group, its
    output into a file. Returns (process, output file, start time)."""
    out = open(tmp / "soak_run.out", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "plr2_tpu_torch.tools.soak_run", "--mode", "fused",
         "--nepoch", "4", "--kill_epochs", "2", "--synthetic_frames", "16",
         "--poll_s", "0.2", "--leg_timeout", "240", "--outf", str(tmp / "soak"),
         "--log_dir", str(tmp / "soak_logs")],
        cwd=ROOT, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    return proc, out, time.perf_counter()


def tail_soak_stop(started):
    """Kill the soak run and the trainer it launched (its process group)."""
    proc, out, _ = started
    if proc.poll() is None:
        os.killpg(proc.pid, 9)
        proc.wait()
    out.close()


def tail_soak_finish(tmp, started, timings):
    """Wait for the soak run; check its exit and its summary."""
    proc, out, t0 = started
    try:
        rc = proc.wait(timeout=600)
    finally:
        tail_soak_stop(started)
    timings["soak_run_wall_s"] = time.perf_counter() - t0
    text = (tmp / "soak_run.out").read_text()
    if rc != 0:
        raise AssertionError(f"tail: soak_run exited {rc}: {text[-3000:]}")
    summary = json.loads((tmp / "soak" / "soak_summary.json").read_text())
    leg0, leg1 = summary["legs"]
    ok = (summary["kill_epochs"] == [2] and leg0["graceful_stop"]
          and leg1["resumed_from"] is not None and leg1["epochs_logged"][1] >= 4)
    print(f"  soak_run: {text.strip().splitlines()[-1]}")
    print(f"  soak legs: {[{k: l[k] for k in ('kill_epoch', 'seconds', 'resumed_from', 'epochs_logged', 'graceful_stop')} for l in summary['legs']]} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"tail: soak summary {summary}")
    timings["soak_leg0_s"], timings["soak_leg1_s"] = leg0["seconds"], leg1["seconds"]


def tail_checked(timings):
    """`checked` around an f32 stage-1 step at the overfit width: the loss
    bit-equal to the unchecked step's from the same state, and an injected
    NaN raises. Returns the launches."""
    from plr2_tpu_torch import ops
    from plr2_tpu_torch.data import SyntheticPoseDataset, draw, raw_to_sample, stack_samples
    from plr2_tpu_torch.parallel import make_train_step
    from plr2_tpu_torch.pipeline import DenseFusionPipeline
    from plr2_tpu_torch.utils.debug import checked
    ds = SyntheticPoseDataset(num_frames=BATCH // 2, num_objects=2,
                              model_points=TAIL_MESH, num_points=TAIL_POINTS, seed=3)
    g = torch.Generator().manual_seed(TAIL_SEED)
    bs = stack_samples([raw_to_sample(ds.get_raw(i), draw(g), TAIL_POINTS,
                                      add_noise=True, device=DEVICE)
                        for i in range(len(ds))], crop=TAIL_CANVAS)
    batch = {k: getattr(bs, k) for k in ("img", "points", "choose", "target",
                                         "model_points", "idx", "obj")}
    ops.reset_launch_counts()
    out = {}
    for name, wrap in (("plain", lambda f: f), ("checked", checked)):
        pipe = DenseFusionPipeline(TAIL_POINTS, TAIL_OBJ, seed=4)
        step = make_train_step(pipe, sym_list=(0, 1), w=W, lr=LR)
        t0 = time.perf_counter()
        m = wrap(step)(batch, torch.Generator().manual_seed(5))
        torch.cuda.synchronize()
        out[name] = (m["loss"].clone(), m["dis"].clone(), time.perf_counter() - t0)
    launches = ops.launch_counts()
    same = all(torch.equal(a, b) for a, b in zip(out["plain"][:2], out["checked"][:2]))
    bad = dict(batch, points=batch["points"].clone())
    bad["points"][0, 0, 0] = float("nan")
    try:
        checked(step)(bad, torch.Generator().manual_seed(5))
        raised = ""
    except FloatingPointError as e:
        raised = str(e)
    print(f"  checked stage-1 step (batch {len(ds)}, sym): loss {float(out['checked'][0]):.6f} "
          f"bit-equal to the unchecked step's {'ok' if same else 'FAIL'}; "
          f"{out['checked'][2] * 1e3:.1f} ms checked, {out['plain'][2] * 1e3:.1f} ms not "
          f"(first step of each); injected NaN: {raised or 'no error: FAIL'}")
    if not same or not raised:
        raise AssertionError("tail: checked step")
    timings["checked_step_ms"], timings["unchecked_step_ms"] = (
        out["checked"][2] * 1e3, out["plain"][2] * 1e3)
    return launches


@phase("tail")
def tail_phase(errs):
    """The tail on the card: YAML configs, the trunk import, the .pth
    export and reload, the overfit, synthetic end-to-end and soak tools,
    `checked`; every kernel of the tools' path against its plain version
    at their shapes. The soak run's processes share the card with the
    untimed work (the kernel checks, the --config run, the e2e run); the
    overfit runs and the checked step, whose times are printed, run after
    it. Returns (launches by dtype, timings)."""
    import tempfile
    timings = {}
    launches = {"f32": {}, "bf16": {}}

    def add(dt_name, seen):
        launches[dt_name] = {k: launches[dt_name].get(k, 0) + v for k, v in seen.items()}

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        soak = tail_soak_start(tmp)
        try:
            gen = torch.Generator().manual_seed(TAIL_SEED)
            for dt_name, batch in (("f32", BATCH), ("bf16", BATCH), ("f32", E2E_BATCH)):
                check_kernels_at([(TAIL_CANVAS, TAIL_CANVAS)], errs, gen, dt_name,
                                 batch, match=False, points=TAIL_POINTS,
                                 objects=TAIL_OBJ)
            # the e2e batch's ADD-S match: every sample symmetric
            check_kernels_at([], errs, gen, "f32", match=E2E_BATCH, points=TAIL_POINTS,
                             objects=TAIL_OBJ, mesh=TAIL_MESH)
            add("f32", tail_config_run(tmp, timings))
            add("f32", tail_e2e(tmp, timings))
            tail_soak_finish(tmp, soak, timings)
        finally:
            tail_soak_stop(soak)
        torch.cuda.empty_cache()
        for dt_name, seen in tail_overfit(timings).items():
            add(dt_name, seen)
        add("f32", tail_checked(timings))
    total = {k: launches["f32"][k] + launches["bf16"].get(k, 0) for k in launches["f32"]}
    print(f"  tail launches (in-process runs): f32 {launches['f32']}, bf16 "
          f"{launches['bf16']}")
    missing = [k for k in ("mlp_head", "upconv3x3_prelu", "nn_match",
                           "gather_rows_backward") if total.get(k, 0) == 0]
    if missing or not all(launches["bf16"].get(k, 0) for k in ("mlp_head", "upconv3x3_prelu")):
        raise AssertionError(f"tail: kernels never launched on the path: {missing}")
    return launches, timings


def main():
    t0 = time.perf_counter()
    import_port()
    smi = device_phase()
    build_s = build_phase()
    errs = kernels_phase()
    knn_errs = knn_phase()
    grad_phase()
    kern, launches = main_path_phase()
    eval_launches, eval_rates = eval_phase()
    launches.update(eval_launches)
    skern, sframes, sstacked, serve_launches = serve_phase()
    launches.update(serve_launches)
    serve_rates, serve_lat, serve_walls = serve_timing_phase(skern, sframes, sstacked)
    del skern, sframes, sstacked
    torch.cuda.empty_cache()
    tkern, batch, train_launches, train_result = train_phase()
    launches.update(train_launches)
    trainer_launches, trainer_out = trainer_phase(errs)
    fused_launches, fused_out = fused_phase(trainer_out["train_ds"], errs)
    mixed_launches, mixed_out = mixed_phase(errs)
    for more in (trainer_launches, fused_launches, mixed_launches):
        launches.update(more)
    entry_times = entry_timing_phase(trainer_out, fused_out, mixed_out)
    graph_launches, graph_times = train_graphs_phase(tkern, batch, trainer_out,
                                                     fused_out, mixed_out)
    launches.update(graph_launches)
    torch.cuda.empty_cache()
    gather_entry, det = determinism_phase(tkern, batch, trainer_out, fused_out,
                                          mixed_out, launches)
    del trainer_out, fused_out, mixed_out
    torch.cuda.empty_cache()
    eval_walls = eval_entry_phase()
    frames, entries, est_profile = timing_phase(kern, launches, errs)
    kern.cast(torch.float32)
    tf32 = tf32_phase(kern)
    del kern
    train_times, knn_entries = train_timing_phase(tkern, batch, train_result,
                                                  launches, knn_errs)
    entries += knn_entries
    del tkern, batch, train_result
    torch.cuda.empty_cache()
    entries.append(quant_timing_phase(*quant_phase()))
    entries.append(gather_entry)
    torch.cuda.empty_cache()
    real_launches, real = real_data_phase(errs)
    add_real_launches(entries, real_launches, errs)
    torch.cuda.empty_cache()
    seg_launches, seg_table, seg = segmentation_phase(errs)
    add_seg_launches(entries, seg_launches, seg_table)
    torch.cuda.empty_cache()
    par_launches, par = parallel_phase()
    add_path_launches(entries, par_launches, "parallel")
    torch.cuda.empty_cache()
    tail_launches, tail = tail_phase(errs)
    add_path_launches(entries, tail_launches, "tail")
    for e in entries:  # the decoder's error now covers the segmenter's shapes
        kname, _, dt_name = e["name"].rpartition("_")
        if kname == "upconv3x3_prelu":
            e["max_abs_err"] = max(e["max_abs_err"], errs[(kname, dt_name)])
    print(f"summary ({smi}): build {build_s:.2f} s, total "
          f"{time.perf_counter() - t0:.2f} s, "
          f"frames/s {json.dumps({k: round(v, 1) for k, v in frames.items()})}, "
          f"train {json.dumps({k: round(v, 3) for k, v in train_times.items()})}, "
          f"train entry {json.dumps({k: round(v, 3) for k, v in entry_times.items()})}, "
          f"train graphs {json.dumps({k: round(v, 4) for k, v in graph_times.items()})}, "
          f"determinism {json.dumps({k: round(v, 3) for k, v in det.items()})}, "
          f"eval samples/s {json.dumps({k: round(v, 2) for k, v in eval_rates.items()})}, "
          f"eval CLI walls s {json.dumps({k: round(v, 2) for k, v in eval_walls.items()})}, "
          f"serve frames/s {json.dumps({k: round(v, 1) for k, v in serve_rates.items()})}, "
          f"serve ms {json.dumps({k: round(v, 3) for k, v in serve_lat.items()})}, "
          f"serve CLI walls s {json.dumps({k: round(v, 2) for k, v in serve_walls.items()})}, "
          f"tf32 {json.dumps({k: round(v, 6) for k, v in tf32.items()})}, "
          f"real data {json.dumps({k: round(v, 4) for k, v in real.items()})}, "
          f"segmentation {json.dumps({k: round(v, 4) for k, v in seg.items()})}, "
          f"parallel {json.dumps({k: round(v, 4) for k, v in par.items()})}, "
          f"tail {json.dumps({k: round(v, 4) for k, v in tail.items()})}, "
          f"estimate profiles {json.dumps({d: {k: round(v, 3) for k, v in p.items()} for d, p in est_profile.items()})}")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
