#!/usr/bin/env python3
"""Drive the PyTorch port (dbw_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [-v]

Phases, one line each (or a few):
1. device: the card's name and power limit;
2. build: compile the CUDA kernels of dbw_torch/csrc with nvcc (-v: print
   ptxas register and spill info);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the flagship shapes of every path that launches it (the blocks and env
   passes of the main path, the joint path's one scene, K3 also at the
   band path's; the blend's pair K6 at the blocks and env passes' K on
   seeded colours and alphas with exact 0s and 1s; the LPIPS pair K7 at the
   five VGG16 slice shapes of each benchmark cell's views, 20 renders
   against 4 targets; the quad sample's forward K8, bit for bit, on the
   passes' own fragments and at each benchmark cell's blocks and env
   passes, 20 views, with uv ramps over the views), with both times (CUDA
   events around runs of 20 calls), K3's, K5's, K6's, K7's and K8's device
   time per launch from a profiler trace, the kernel's bound (the larger of its
   bytes over the card's memory rate and its operations over the float32
   rate) and, for K4 and K5, the time of one PyTorch ``index_add_`` that
   computes the same sums;
4. main path: configs/synthetic/dtu_shaped.yml as shipped (decoupled env
   pass, 300x400, 4 views, K=10, 10 blocks, 256 texels, the VGG16
   features in their bfloat16 default) takes 10 Adam steps; every kernel
   must launch in every step. The same step with float32 features, timed
   in the same call, and the card's bfloat16 features held against its
   float32 ones. Then a few steps split into the layers of
   ``dbw_torch.utils.profiling`` (each forward and backward leaf's stream
   ms), and a torch.profiler trace of 3 steps: the device's idle share and
   where its time goes;
5. joint path: the same config with decouple_rendering=False, 3 steps;
5b. band path: the config's predict in 2 row bands (0-149, 150-299) and in
   3 bands of 100 rows against the full predict; K1's band output bitwise
   the full raster's rows (kernel against kernel) and within the near-tie
   rule of the plain band, at the env and blocks shapes; one forward and
   backward of one band whose rec_gather places it among the other bands'
   renders, its losses against the full forward's and its gradients against
   the same band step through the plain twins of K3, K4 and K5; the band
   path's launches are counted alone;
6. train: the port's synthetic ground truth of the config (49 views at
   300x400) rendered on the card, one epoch (13 batches of 4 in the
   loader's order, the scheduler's LRs), then a model.pkl round trip that
   must reproduce the next step;
7. reference: a small model run on the card agrees with the same model run
   on the CPU (plain versions), losses and gradients, decoupled and joint,
   both with float32 VGG features;
8. trainer: dbw_torch.train.trainer.Trainer on the shipped config at full
   width (only n_epoches, the stat intervals and the final eval's video
   knobs overridden) in a temporary run directory: every artifact of the
   JAX Trainer's synthetic run, finite losses and scores, a resume from its
   model.pkl at the next epoch, every kernel launched in the run (the
   supersampled hard selection of the viz and eval renders, K1-hard at 4x,
   counted on its own); its throughput, the time of one val interval and
   of the final eval. Phase 3 holds K1-hard at 4x (1200x1600, the scene's
   1,248 faces and the blocks' 800) bitwise against its plain twin;
9. dtu: a DTU scan written into a temporary directory in the IDR layout at
   DTU's shapes (49 views of the port's synthetic scene rendered on the
   card as 300x400 PNGs, cameras.npz at the raw 1200x1600 with a
   millimetre scale matrix, ~1 M GT points in mm, an ObsMask grid and a
   ground plane), then the Trainer on configs/dtu/scan24.yml at full width
   (only dataset.root, n_epoches, the stat intervals, the final eval's
   video knobs and the blocks' initial opacity overridden) through the
   final eval's DTU branch: every artifact, dtu_scores.tsv (acc comp avg,
   finite), every kernel launched; its steps/s, the final eval's seconds
   and the protocol's split;
10. mesh: MeshEvaluator at its real size (100,000 points, 100 ICP steps,
   normals) on the card on phase 8's exported block mesh and synthetic GT;
   the card's 1-NN against the CPU's on a 20,000 x 20,000 cloud;
11. protocol: dbw_torch.train.multi_seed.MultiSeedTrainer on the shipped
   config at full width with seeds 11 22 33 44 55 (only n_epoches, the
   stat intervals and the final eval's video knobs overridden: 2 epochs,
   26 iterations, one val interval and save), under the default seed
   executor, batched (the 5 slots' 20 views in one step, one launch of
   each kernel): three uninterrupted runs (their largest spread over the
   seeds sets the tolerance: K3-K5's atomics add in any order), a fourth
   killed after its save and resumed, which must end within that
   tolerance of the first; the first's final evaluation and its whole run
   directory, every kernel launched in it; a fifth run under
   DBW_SEED_EXEC=map (the slots one after the other), whose final losses
   must lie within the tolerance of the first's. The batched loop must
   launch each kernel as often a iteration as phase 4's step does, the
   map loop 5 times that. The step alone, batched and map (5 steps on
   phase 4's inputs, then a profiler trace of 3: ms, seed-steps/s, peak
   memory, the device's idle share). Each kernel against its plain twin
   at the batched step's shapes (blocks and env pass of 20 views; the
   plain twins timed by one call). A 1-seed protocol against the Trainer
   with the same seed over the same 10 logged steps; seed-steps/s of both
   executors beside phase 8's steps/s, peak memory, the launch counts and
   seed_selection.tsv;
12. scenes: dbw_torch.train.multi_scene.MultiSceneTrainer on two synthetic
   scenes of the shipped config (dataset seeds 3 and 5, two training
   seeds), full width, 1 seed each, 2 epochs, evaluate(quali=False), both
   scenes in one batched (scene, seed) step: each run directory's files,
   finite losses that differ between the scenes, seed-steps/s, one launch
   of each kernel a iteration (phase 4's step's counts);
13. lit: the shipped config at full width with only the renderer's
   shading_type (flat, gouraud, phong), lights (directional, point) and
   cameras (fov) overridden takes 3 Adam steps of each lit type: finite
   losses, K1 (soft and hard), K4, K8 and the blend (K6) launched in
   every step and no other kernel (the lit path interpolates in tensor
   code, as the JAX package does); K1, K4 and K8 against their plain twins
   at the lit path's shapes (blocks pass: K1 soft slot for slot, K4, K8;
   env pass: K1 hard, K4, K8; K4 and K8 on the valid fragments, which are
   all that the lit path shades) and a profiler trace of the phong step;
   then 3 steps with each of the six other optimizers, 2 steps with each
   RGB criterion, and a model.pkl resume of adamw that reproduces the next
   step;
14. nerfstudio: a capture in nerfstudio's transforms.json layout written
   into a temporary directory (49 views of the port's synthetic scene
   rendered on the card at 600x800, OpenGL camera-to-world matrices,
   fl_x/fl_y/cx/cy and a point_cloud.ply), then the Trainer on
   configs/nerfstudio/campanile.yml at full width (only dataset.root,
   n_epoches, the stat intervals and the final eval's video knobs
   overridden; downscale_factor 2 gives 300x400) through the final eval:
   every artifact, finite losses and scores, every kernel launched;
15. device mesh: the JAX package's device mesh over torch.distributed, on
   this one card: 2 ranks (spawned processes) under gloo, NCCL refusing two
   ranks on one device. The main path's step (5 Adam steps of one seed on
   the flagship inputs) on (seed=1, data=2) and (seed=1, sp=2), each rank's
   losses and parameters against two one-card runs of the same steps in
   this call (4x their gap, floored at the parity budget), every kernel
   launched in every step on every rank, each rank's K1 selections
   covering its own rows only (the band (k Hb, Hb), Hb = ceil(H / 2), at sp
   coordinate k on the sp layout, the whole image otherwise: read from
   their pix_to_face), the gradient all_reduce and the band gather timed
   alone; then
   the 5-seed protocol on its default layout (seed=2: 6 slots, 1 padded,
   each rank's 3 slots batched: phase 4's launches a iteration), 26
   iterations with a save, uninterrupted and killed after the save and
   resumed, its seeds' final losses against phase 11's run A within phase
   11's tolerance; steps/s and seed-steps/s beside one card's. A rank that
   fails fails the phase. Rehearse it here with 2 gloo ranks on the CPU:
   ``phase_device_mesh(cfg, torch.device("cpu"), numbers, step, setup=fn)``, fn
   setting ``IMG_SIZE`` (30, 40), ``CONFIG`` (a small copy of the shipped
   config) and the protocol's val interval (9), stubbing
   ``torch.cuda.synchronize`` and counting the dispatchers (renderer's
   ``rasterize``, ``frag_fwd``, ``frag_bwd``, ``quad_maps_grad``,
   ``small_table_scatter_add``) as launches; ``numbers`` from a one-rank
   ``protocol_run`` (about 2 min);
16. bench: ``python -m dbw_torch.bench`` (bench.py's workload: 4 views at
   300x400, K=10, the full loss stack, forward, backward and Adam; 20
   steps in calls of 5 after a warm-up until two calls agree within 10%)
   in its own process at 10 and at 50 blocks, each JSON line printed on a
   line of its own: it must exit 0 on the card with finite numbers and
   launch K1, K1-hard, K2, K3 and K5 once and K4, K6's forward and K6's
   backward twice a step. K1 (soft, every slot equal), K2, K3 and K4
   against their plain twins on the blocks pass at 50 blocks (4,000
   faces); the trace twin
   (scripts/torch_trace_bench.py) of the bench step at both widths: its
   top 10 device ops and the blend's scans' share of device time; the
   requant twin (scripts/torch_requant_run.py) on phase 8's model.pkl and
   final_scores.tsv: the Trainer's header, its unrounded scores within a
   relative 1e-5, the provenance note written; the viz probe
   (scripts/torch_viz_probe.py) on that run: each viz stream's ms.
   Rehearse it here by running ``phase_bench(torch.device("cpu"), run,
   scores)`` on a tiny Trainer run with the ``*_cuda`` wrappers pointed at
   their plain twins, ``cuda_ms`` stubbed, ``dbw_torch.bench.make_model``
   at 30x40, the bench processes given ``--cpu --img-size 30 40`` and
   their lines' backend and launches rewritten as the card's, and the two
   scripts' ``DEFAULT_DEVICE`` set to the CPU (about 2 min).
The last two lines are a JSON object per kernel and the result line.
Exits non-zero, with no result line, when there is no CUDA device or any
phase fails.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "synthetic" / "dtu_shaped.yml"
IMG_SIZE = (300, 400)
N_VIEWS = 4
N_STEPS = 10
N_JOINT_STEPS = 3
N_SPLIT_STEPS = 4
N_PROFILE_STEPS = 3
# dataset-style NDC intrinsics of the flagship bench model
K_NDC = np.zeros((4, 4), np.float32)
K_NDC[0, 0], K_NDC[1, 1] = 2.8, 2.1
K_NDC[0, 2] = K_NDC[1, 2] = 0.02
K_NDC[2, 3] = K_NDC[3, 2] = 1.0

SOURCES = {
    "K1_select": ("dbw_torch/csrc/raster.cu",
                  "dbw_tpu/render/rasterize_pallas.py:97"),
    "K1_select_hard": ("dbw_torch/csrc/raster.cu",
                       "dbw_tpu/render/rasterize_pallas.py:166"),
    "K1_select_hard_ss": ("dbw_torch/csrc/raster.cu",
                          "dbw_tpu/render/rasterize_pallas.py:166"),
    "K2_frag_fwd": ("dbw_torch/csrc/fragment.cu",
                    "dbw_tpu/render/fragment_fused.py:190"),
    "K3_frag_bwd": ("dbw_torch/csrc/fragment.cu",
                    "dbw_tpu/render/fragment_fused.py:218"),
    "K4_texel_grad": ("dbw_torch/csrc/texel.cu",
                      "dbw_tpu/ops/segment_sum_pallas.py:54"),
    "K5_small_scatter": ("dbw_torch/csrc/scatter.cu",
                         "dbw_tpu/ops/segment_sum_pallas.py:169"),
    # no TPU kernel: the JAX blend is XLA's cumprod
    "K6_blend_fwd": ("dbw_torch/csrc/blend.cu", "dbw_tpu/render/blend.py:40 (XLA)"),
    "K6_blend_bwd": ("dbw_torch/csrc/blend.cu", "dbw_tpu/render/blend.py:40 (XLA)"),
    # no TPU kernel: the JAX LPIPS distance is XLA's
    "K7_lpips_fwd": ("dbw_torch/csrc/lpips.cu", "dbw_tpu/losses/vgg.py:231 (XLA)"),
    "K7_lpips_bwd": ("dbw_torch/csrc/lpips.cu", "dbw_tpu/losses/vgg.py:231 (XLA)"),
    # no TPU kernel: the JAX quad sample's forward is XLA's gather
    "K8_quad_fwd": ("dbw_torch/csrc/texel.cu", "dbw_tpu/render/meshes.py:195 (XLA)"),
}
# the kernels of the training step (the main path's); the viz and eval
# renders add K1_select_hard_ss, the hard selection at 4x supersampling
STEP_KERNELS = tuple(k for k in SOURCES if k != "K1_select_hard_ss")
# the trainer phase: the shipped config with these keys overridden only.
# 16 epochs of 13 batches are 208 steps in groups of steps_per_call 5; the
# val interval fires at iterations 50 (the first of a ragged tail), 100
# (inside a full group, so at 101), 150 and 200, the log interval at 8
# more; the final eval renders trajectory videos of 10 frames for 1 view
TRAINER_OVERRIDES = dict(n_epoches=16, train_stat_interval=25, val_stat_interval=50,
                         eval=dict(n_traj_videos=1, NV=10))
# the dtu phase: configs/dtu/scan24.yml (over its default.yml) with these
# training keys and dataset.root overridden; 3 epochs of 13 batches are 39
# steps, the val interval fires at iteration 26 (inside a group of 5, so at
# 30). One model key too: the final eval scores the blocks whose opacity
# passes 0.5, and from the shipped 0.5 the parsimony loss takes every
# block below it in the first epochs (r5's first block crossed 0.5 at
# epoch 8), which would leave the protocol an empty mesh
DTU_CONFIG = ROOT / "configs" / "dtu" / "scan24.yml"
DTU_OVERRIDES = dict(n_epoches=3, train_stat_interval=13, val_stat_interval=26,
                     eval=dict(n_traj_videos=1, NV=10))
DTU_MESH_OVERRIDES = dict(opacity_init=0.9)
# the protocol phase: the shipped config, 5 seeds, these training keys
# overridden. 2 epochs of 13 batches are 26 iterations in groups of 5; the
# val interval (and the save) fires at 20 (inside the group 19-23, so at
# 23), the log interval at 10 (at 13) and 20 (at 23)
PROTOCOL_SEEDS = (11, 22, 33, 44, 55)
PROTOCOL_OVERRIDES = dict(n_epoches=2, train_stat_interval=10, val_stat_interval=20,
                          eval=dict(n_traj_videos=1, NV=10))
# a 1-seed protocol against the Trainer: one epoch one step at a time, the
# losses of its first 10 steps
SLOT_OVERRIDES = dict(n_epoches=1, steps_per_call=1, train_stat_interval=5,
                      val_stat_interval=1000)
N_SLOT_STEPS = 10
# the resumed run's per-seed final losses against the uninterrupted run's:
# within the larger of 4x the spread of three uninterrupted runs (the
# largest gap of two of them over the seeds) and the per-step loss rtol of
# the parity checks (ROADMAP.md). The atomics' drift differs by seed (1e-7
# to 5e-6 on the card) and two runs of a seed may agree closely by chance:
# against one pair per seed, a resumed run that drifts like the others
# fails about a third of the time; against three runs pooled, well under
# one in a hundred
PROTOCOL_SPREAD_FACTOR = 4.0
PROTOCOL_RTOL_FLOOR = 2e-5
# the protocol's step alone, batched and map, on the main path's inputs:
# steps timed after a warm-up step, then a profiler trace of 3 more
N_PROBE_STEPS = 5
# the scenes phase: two synthetic scenes of the shipped config
SCENE_DATASET_SEEDS = (3, 5)
SCENES_OVERRIDES = dict(n_epoches=2, train_stat_interval=10, val_stat_interval=20)
# the lit phase: the shipped config with the renderer's shading_type, lights
# and cameras overridden; 3 steps of each (shading, light) case. The lit path
# launches K1 (soft blocks, hard env), K4, the blend (K6) and LPIPS (K7) only
LIT_CASES = (("flat", "directional"), ("gouraud", "point"), ("phong", "directional"))
LIT_LIGHTS = {"directional": dict(name="directional", direction=[[1.0, 0.25, -1.0]]),
              "point": dict(name="point", location=[[0.5, 2.0, -2.5]])}
LIT_KERNELS = ("K1_select", "K1_select_hard", "K4_texel_grad", "K6_blend_fwd",
               "K6_blend_bwd", "K7_lpips_fwd", "K7_lpips_bwd", "K8_quad_fwd")
N_LIT_STEPS = 3
OTHER_OPTIMIZERS = ("sgd", "adamw", "adamax", "rmsprop", "adagrad", "adadelta")
CRITERIA = ("bce", "mse", "l2", "l1", "huber", "perceptual", "lpips", "ssim")
N_CRITERION_STEPS = 2
RESUME_OPTIMIZER = "adamw"
# the nerfstudio phase: configs/nerfstudio/campanile.yml with these training
# keys and dataset.root overridden; 49 views written at 600x800 load at
# 300x400 (downscale_factor 2); 2 epochs of 13 batches are 26 steps, one at
# a time (the config sets no steps_per_call), the val interval at 20
NS_CONFIG = ROOT / "configs" / "nerfstudio" / "campanile.yml"
NS_CAPTURE_SIZE = (600, 800)
NS_OVERRIDES = dict(n_epoches=2, train_stat_interval=10, val_stat_interval=20,
                    eval=dict(n_traj_videos=1, NV=10))
# the written scan: a millimetre world (DTU's scale matrices scale by ~200
# and move the origin by a few hundred mm), ~1 M GT points
DTU_SCALE_MAT = np.array([[200.0, 0, 0, -10.0], [0, 200.0, 0, 35.0],
                          [0, 0, 200.0, 620.0], [0, 0, 0, 1]])
DTU_GT_POINTS = 1_000_000
# the card's bfloat16 VGG16 features against its float32 ones, per slice
# output: the largest difference within 3e-2 of the largest feature and the
# mean within 2e-2 of the mean feature (bfloat16 keeps 8 bits, 3.9e-3,
# through 13 layers; the CPU shows 8e-3 and 7e-3)
VGG_BF16_MAX_REL = 3e-2
VGG_BF16_MEAN_REL = 2e-2
N_F32_STEPS = 6
# the 1-NN of phase 10: a 20,000 x 20,000 cloud; a point whose two nearest
# squared distances differ by at most 1e-5 of the expansion's scale
# (|x|^2 + |y|^2) is a near-tie, where float32 may pick either
NN_POINTS = 20_000
NN_TIE_REL = 1e-5
# kernels of the joint-rendering path (no env pass)
JOINT_KERNELS = ("K1_select", "K2_frag_fwd", "K3_frag_bwd", "K4_texel_grad",
                 "K6_blend_fwd", "K6_blend_bwd", "K7_lpips_fwd", "K7_lpips_bwd",
                 "K8_quad_fwd")
# kernels of the backward, held against their plain twins in the band phase
BACKWARD_KERNELS = ("K3_frag_bwd", "K4_texel_grad", "K5_small_scatter")
# the pixel bands of the band phase: (row0, Hb) of 2 and of 3 bands
BAND_SPLITS = {"2 bands": ((0, 150), (150, 150)),
               "3 bands": ((0, 100), (100, 100), (200, 100))}
# the bound of a kernel: the larger of its bytes (each input read once, each
# output written once) over the memory rate and its operations over the
# float32 rate of one H100 SXM (NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# floating-point operations per fragment (K2, K3, K4, K8), row (K5) or
# pixel slot (K6) or rendered feature value (K7), counted from the
# expressions of csrc/fragment.cu, texel.cu, scatter.cu, blend.cu and
# lpips.cu; K1's per pixel-face pair is rasterize.FLOPS_PER_PAIR, from
# csrc/raster.cu
FLOPS_PER_ITEM = {"K2_frag_fwd": 140, "K3_frag_bwd": 260, "K4_texel_grad": 32,
                  "K5_small_scatter": 12, "K6_blend_fwd": 9, "K6_blend_bwd": 28,
                  "K7_lpips_fwd": 11, "K7_lpips_bwd": 26, "K8_quad_fwd": 30}
# kernels whose device time per launch phase 3 also reads from a profiler
# trace, by the name of their device kernel
DEVICE_KERNELS = {"K3_frag_bwd": "frag_bwd_kernel", "K5_small_scatter": "small_scatter_kernel",
                  "K6_blend_fwd": "blend_fwd_kernel", "K6_blend_bwd": "blend_bwd_kernel",
                  "K7_lpips_fwd": "lpips_fwd_kernel", "K7_lpips_bwd": "lpips_bwd_kernel",
                  "K8_quad_fwd": "quad_sample_fwd_kernel"}
# K7's checks: the five VGG16 slice shapes (C channels, the view halved by
# each pool) of each benchmark cell's views, 20 renders (5 slots of 4
# views) against the 4 targets they share
LPIPS_CELLS = {"campanile": (540, 960), "dtu24": (300, 400), "gundam50": (288, 384)}
LPIPS_SLICE_CHANNELS = (64, 128, 256, 512, 512)
LPIPS_RENDERS, LPIPS_TARGETS = 20, 4
# K8's checks at the benchmark cells' shapes: 20 views (5 slots of 4) of
# LPIPS_CELLS' sizes through the blocks pass (K = 10, each slot's blocks'
# maps) and the env pass (K = 1, each slot's dome and ground maps), every
# slot's maps stacked in one atlas of QUAD_ATLAS_HW maps
QUAD_BLOCKS = {"campanile": 10, "dtu24": 10, "gundam50": 50}
QUAD_SLOTS, QUAD_ATLAS_HW = 5, (256, 279)
# the mesh phase: MESH_RANKS ranks on card 0 under gloo (NCCL refuses two
# ranks on one device). Each layout takes MESH_STEPS Adam steps of seed
# MESH_SEED on the main path's inputs; the 5-seed protocol takes its
# default layout, factor_devices(2, 5) = (seed=2, data=1): 6 slots, 1 padded
MESH_RANKS = 2
MESH_STEPS = 5
MESH_SEED = 11
MESH_LAYOUTS = {"seed=1, data=2": dict(n_seed=1, n_data=2),
                "seed=1, sp=2": dict(n_seed=1, n_data=1, n_spatial=2)}
# a layout's losses are held to the protocol phase's rule (4x the spread of
# two one-card runs, floored at the loss rtol 2e-5); its parameters to 4x
# the two runs' largest parameter gap, floored at the ROADMAP's atol 3e-4
MESH_PARAM_ATOL = 3e-4
MESH_TIMEOUT_S = 900
# the collectives timed alone: calls per timing
N_COLLECTIVE_REPS = 20
# the bench phase: `python -m dbw_torch.bench` with these flags at each
# block count (10, the flagship, and 50, the reference's largest and the
# width of configs/bmvs/gundam_50.yml), each in its own process; every
# kernel of the decoupled step must launch these many times a step
BENCH_ARGS = ("--steps", "20", "--steps-per-call", "5", "--max-warmup-calls", "10",
              "--max-warmup-s", "120")
BENCH_BLOCKS = (10, 50)
BENCH_TIMEOUT_S = 300
BENCH_STEP_LAUNCHES = {"K1_select": 1, "K1_select_hard": 1, "K2_frag_fwd": 1,
                       "K3_frag_bwd": 1, "K4_texel_grad": 2, "K5_small_scatter": 1,
                       "K6_blend_fwd": 2, "K6_blend_bwd": 2, "K7_lpips_fwd": 5,
                       "K7_lpips_bwd": 5, "K8_quad_fwd": 2}
# the bench trace (scripts/torch_trace_bench.py): steps traced, ops listed
N_TRACE_STEPS = 3
TRACE_TOP = 10
# the requant twin's scores against the Trainer's own, relative
REQUANT_RTOL = 1e-5


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, runs=20, pairs=5):
    """Time of one fn() call: a CUDA-event pair around ``runs`` back-to-back
    calls, over ``runs``; the median of ``pairs`` such pairs (after one
    warm-up call)."""
    fn()
    times = []
    for _ in range(pairs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(runs):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / runs)
    return float(np.median(times))


def device_ms(fn, kernel, runs=20, tries=3):
    """The device time of one launch of the device kernel whose name holds
    ``kernel``, as torch.profiler (CUPTI) records it over ``runs`` calls of
    fn(): the summed kernel durations over their count (after one warm-up
    call). Host work inside fn() is not in it. CUPTI may hand a short trace
    no device records (it drops those it cannot place inside the trace's
    window), so the calls sit between idle gaps of 10 ms and a trace without
    a launch is taken again, up to ``tries`` times; after that the time is
    None ("not measured"): it is a reading, not a check."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for i in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if spans:
            if i:
                say("kernels", f"device time of {kernel}: read in profiler trace "
                    f"{i + 1} of {tries}")
            return float(sum(spans)) / len(spans) / 1e3
    say("kernels", f"device time of {kernel}: not measured (none of {tries} profiler "
        "traces held a launch of it)")
    return None


def load_cfg():
    from dbw_torch.utils.config import load_yaml

    cfg = load_yaml(CONFIG)
    say("config", f"{CONFIG.relative_to(ROOT)} as shipped (decouple_rendering="
        f"{cfg['model']['rend_optim']['decouple_rendering']})")
    return cfg


def make_model(cfg, device, img_size=None, mesh=None, renderer=None,
               rend_optim=None, K=K_NDC, vgg_dtype=None, loss=None):
    """BlocksWorld from the config's model section (+ overrides of its mesh,
    renderer, rend_optim and loss keys) with the flagship camera; VGG16
    features in ``vgg_dtype`` (None: the device's default)."""
    from dbw_torch.losses.vgg import VGG16Features
    from dbw_torch.models.dbw import BlocksWorld

    m = copy.deepcopy(cfg["model"])
    m.pop("name", None)
    m["mesh"].update(mesh or {})
    m["renderer"].update(renderer or {})
    m["rend_optim"].update(rend_optim or {})
    m["loss"].update(loss or {})
    vgg = None
    if vgg_dtype is not None:
        vgg = VGG16Features.from_env_or_random(
            seed=m.get("loss", {}).get("vgg_filter_seed", 0),
            path=m.get("loss", {}).get("vgg_weights"), device=device, dtype=vgg_dtype)
    model = BlocksWorld(img_size or IMG_SIZE, device=device, vgg=vgg, **m)
    model.set_camera(K)
    return model


def cameras(n, device):
    from dbw_torch.ops.rotations import look_at_rotation

    R, T = look_at_rotation(3.0, 25.0, torch.linspace(-40.0, 40.0, n))
    return R.to(device), T.to(device)


def check_selection(label, got, ref, packed, blur, rcfg, row_range=None, exact=False):
    """K1: slot-for-slot equality with the plain version, except near-ties
    (at most 0.1% of slots, each within |dz| < 1e-5); ``exact``: no slot
    may differ."""
    from dbw_torch.render import rasterize as rz
    from dbw_torch.render.cameras import ndc_pixel_centers

    mism = got != ref
    n_mis = int(mism.sum())
    dz = 0.0
    if n_mis:
        b, i, j, k = torch.nonzero(mism, as_tuple=True)
        xs, ys = ndc_pixel_centers(rcfg.image_size, got.device, row_range=row_range)
        px, py = xs[j][:, None], ys[i][:, None]
        za, zb = (rz._score(px, py, packed[b, sel[b, i, j, k].long().clamp(min=0)][:, None],
                            blur, rcfg.z_clip, True, True) for sel in (got, ref))
        dz = float((za - zb).abs().max())
    ok = n_mis == 0 if exact else n_mis / got.numel() <= 1e-3 and dz < 1e-5
    rule = "none" if exact else "<= 0.1% of slots, near-ties |dz| < 1e-5"
    say("kernels", f"{label}: {n_mis} of {got.numel()} slots differ (max |dz| "
        f"{dz:.3g}; tolerance: {rule}); valid slots {int((got >= 0).sum())}")
    return dz, ok


def check_close(label, got, ref, rel, note="atomics sum in another order"):
    """Float agreement within ``rel`` of the plain result's max."""
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    say("kernels", f"{label}: max |d| {err:.3g} of max {scale:.3g} (tolerance: "
        f"{rel:g} of max; {note})")
    return err, err <= rel * scale


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, **counts):
    """The least time of the card for the work: bytes over the memory rate
    against operations over the float32 rate, the larger of the two."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_counts=dict(bytes=int(n_bytes), flops=int(flops), **counts))


def bbox_pairs(packed, blur, rcfg, row_range=None):
    """The pixel-face pairs that lie inside each valid face's bbox inflated
    by the blur radius: the pairs K1 evaluates at most, counted on the card."""
    from dbw_torch.render.cameras import ndc_pixel_centers

    xs, ys = ndc_pixel_centers(rcfg.image_size, packed.device, row_range=row_range)
    r = max(float(blur), 0.0) ** 0.5
    valid = packed[..., 9] > 0.5
    nx = ((xs >= packed[..., 10:11] - r) & (xs <= packed[..., 11:12] + r)).sum(-1)
    ny = ((ys >= packed[..., 12:13] - r) & (ys <= packed[..., 13:14] + r)).sum(-1)
    return int((nx * ny * valid).sum())


def k1_bound(packed, out, blur, rcfg, row_range=None):
    from dbw_torch.render.rasterize import FLOPS_PER_PAIR

    pairs = bbox_pairs(packed, blur, rcfg, row_range)
    return bound(nbytes(packed, out), pairs * FLOPS_PER_PAIR, pairs=pairs,
                 flops_per_pair=FLOPS_PER_PAIR)


def record(checks, name, path, err, ok, fn, plain_fn, work, library_fn=None,
           plain_runs=20):
    """One check of kernel ``name`` at ``path``: its error, the times of the
    kernel's wrapper, its plain twin and its library call, and, for the
    kernels of DEVICE_KERNELS, the profiler's device time of one launch.
    ``plain_runs`` 1: the plain twin timed by one call after its warm-up
    (the batched shapes, where it takes up to a second)."""
    plain_ms = (cuda_ms(plain_fn) if plain_runs > 1
                else cuda_ms(plain_fn, runs=1, pairs=1))
    checks.setdefault(name, []).append(dict(
        path=path, max_abs_err=err, ms=cuda_ms(fn), plain_ms=plain_ms, plain_calls=plain_runs,
        library_ms=None if library_fn is None else cuda_ms(library_fn),
        device_ms=device_ms(fn, DEVICE_KERNELS[name]) if name in DEVICE_KERNELS else None,
        **work, ok=ok))


def index_add_call(idx, vals, n_rows):
    """The one PyTorch call that computes a scatter-add kernel's sums (the
    kernels' yardstick, never called by the port): vals (M, C) added at rows
    idx (M,) int64 of a zeroed (n_rows, C) table."""
    return lambda: torch.zeros((n_rows, vals.shape[1]), device=vals.device).index_add_(
        0, idx, vals)


def k4_library_call(id00, wx, wy, g, R, TW):
    """index_add_ over the 4 corners' rows and weighted values, prepared
    here, outside the timed call."""
    from dbw_torch.ops.texel_grad import corner_weights

    t = torch.cat([id00.long() + off for off in (0, 1, TW, TW + 1)])
    v = torch.cat([g * w[:, None] for w in corner_weights(wx, wy)])
    keep = t < R
    return index_add_call(t[keep], v[keep].contiguous(), R)


def check_soft_pass(checks, path, model, scene, phase, R, T, gen, plain_runs=20,
                    exact_k1=False):
    """K1 soft, K2, K3 and K4 against their plain versions on one scene of
    the soft renderer, at the shapes the path ``path`` gives them (a
    slot-batched scene: its S * B views, R and T per view); ``exact_k1``:
    K1 must equal its twin in every slot."""
    from dbw_torch.render import fragment as fr
    from dbw_torch.render import rasterize as rz
    from dbw_torch.render.renderer import fragment_streams

    rend = model.renderer
    sigma, blur = rend.sigma_blur(phase.sigma)
    geom = rz.project_faces(scene.verts, scene.faces, R, T, rend.camera,
                            z_clip=rend.config.z_clip)
    packed = rz.pack_faces(geom)
    rcfg = rend.config.raster_config()
    rcfg_plain = rcfg._replace(row_chunk=50)

    # K1 soft
    p2f = rz.rasterize_cuda(packed, blur, rcfg)
    ref = rz.rasterize_plain(packed, blur, rcfg_plain)
    dz, ok = check_selection(f"K1 select [{path}, F={packed.shape[1]}, "
                             f"K={rcfg.faces_per_pixel}]", p2f, ref, packed, blur, rcfg,
                             exact=exact_k1)
    record(checks, "K1_select", path, dz, ok,
           lambda: rz.rasterize_cuda(packed, blur, rcfg),
           lambda: rz.rasterize_plain(packed, blur, rcfg_plain),
           k1_bound(packed, p2f, blur, rcfg), plain_runs=plain_runs)

    # K2
    table, ids, vld, px, py = fragment_streams(scene, geom, p2f)
    M, TH, TW = scene.atlas.maps.shape[:3]
    flags = fr.FragFlags(True, True, rend.config.clip_inside, TH, TW)
    out = fr.frag_fwd_cuda(table, ids, vld, px, py, sigma, flags)
    refo = fr.frag_fwd_plain(table, ids, vld, px, py, sigma, flags)
    id_eq = float((out[0] == refo[0]).float().mean())
    err2 = max(float((a - b).abs().max()) for a, b in zip(out[1:], refo[1:]))
    say("kernels", f"K2 frag fwd [{path}, N={ids.numel()}]: id00 equal on {id_eq:.6f}, "
        f"max |d| of wx/wy/alpha {err2:.3g} (tolerance: id00 exact, 1e-5)")
    N = ids.numel()
    record(checks, "K2_frag_fwd", path, err2, id_eq == 1.0 and err2 <= 1e-5,
           lambda: fr.frag_fwd_cuda(table, ids, vld, px, py, sigma, flags),
           lambda: fr.frag_fwd_plain(table, ids, vld, px, py, sigma, flags),
           bound(nbytes(table, ids, vld, px, py, *out), N * FLOPS_PER_ITEM["K2_frag_fwd"],
                 items=N), plain_runs=plain_runs)

    check_frag_bwd(checks, path, table, ids, vld, px, py, sigma, flags,
                   rcfg.faces_per_pixel, gen, plain_runs)
    check_quad_sample(checks, path, scene.atlas.maps.reshape(-1, 3), *out[:3], TW, plain_runs)

    # K4, in the pass's (P, K) fragment layout
    g = torch.randn((ids.numel(), 3), generator=gen, device=ids.device) * vld[:, None]
    check_texel_grad(checks, path, out[0], out[1], out[2], g, M * TH * TW, TW,
                     rcfg.faces_per_pixel, plain_runs)


def check_frag_bwd(checks, path, table, ids, vld, px, py, sigma, flags, K, gen,
                   plain_runs=20):
    """K3 against its plain twin on one pass's fragment streams (N = P * K
    fragments in the layout n = pixel * K + slot), with a seeded cotangent
    of alpha on the valid fragments."""
    from dbw_torch.render import fragment as fr

    d_alpha = torch.randn(ids.shape, generator=gen, device=ids.device) * vld
    args3 = (table, ids, vld, px, py, d_alpha, sigma, flags.clip_inside, K)
    got3 = fr.frag_bwd_cuda(*args3)
    err3, ok3 = check_close(f"K3 frag bwd [{path}, N={ids.numel()}, K={K}]: d-table",
                            got3, fr.frag_bwd_plain(*args3), 1e-4)
    N = ids.numel()
    record(checks, "K3_frag_bwd", path, err3, ok3,
           lambda: fr.frag_bwd_cuda(*args3), lambda: fr.frag_bwd_plain(*args3),
           bound(nbytes(table, ids, vld, px, py, d_alpha, got3),
                 N * FLOPS_PER_ITEM["K3_frag_bwd"], items=N), plain_runs=plain_runs)


def check_band_frag_bwd(checks, model, scene, phase, R, T, gen):
    """K3 at the band path's shapes: the blocks pass of the middle band of
    3, whose backward the band phase runs."""
    from dbw_torch.render import fragment as fr
    from dbw_torch.render import rasterize as rz
    from dbw_torch.render.renderer import fragment_streams

    rend = model.renderer
    sigma, blur = rend.sigma_blur(phase.sigma)
    geom = rz.project_faces(scene.verts, scene.faces, R, T, rend.camera,
                            z_clip=rend.config.z_clip)
    rcfg = rend.config.raster_config()
    band = BAND_SPLITS["3 bands"][1]
    p2f = rz.rasterize_cuda(rz.pack_faces(geom), blur, rcfg, row_range=band)
    streams = fragment_streams(scene, geom, p2f, image_size=rcfg.image_size, row0=band[0])
    M, TH, TW = scene.atlas.maps.shape[:3]
    flags = fr.FragFlags(True, True, rend.config.clip_inside, TH, TW)
    check_frag_bwd(checks, "band", *streams, sigma, flags, rcfg.faces_per_pixel, gen)


def check_quad_sample(checks, path, maps_flat, id00, wx, wy, TW, plain_runs=20):
    """K8 against its plain twin, bit for bit, and its bound: 24 bytes a
    fragment (id00, wx, wy read, the colour written)."""
    from dbw_torch.render import meshes

    args = (maps_flat, id00, wx, wy, TW)
    got = meshes.quad_forward_cuda(*args)
    ref = meshes.quad_forward_plain(*args)
    same = torch.equal(got, ref)
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    N = id00.numel()
    say("kernels", f"K8 quad sample [{path}, N={N}, R={maps_flat.shape[0]}]: equal to the "
        f"plain twin {same}, max |d| {err:.3g} (tolerance: none, bitwise)")
    record(checks, "K8_quad_fwd", path, err, same,
           lambda: meshes.quad_forward_cuda(*args), lambda: meshes.quad_forward_plain(*args),
           bound(nbytes(id00, wx, wy, got), N * FLOPS_PER_ITEM["K8_quad_fwd"], items=N),
           plain_runs=plain_runs)


def quad_cell_inputs(H, W, K, M, gen):
    """A pass's K8 inputs at a cell's shapes: QUAD_SLOTS * 4 views of H x W
    pixels, K slots a pixel, in the layout n = pixel * K + slot; an atlas of
    M maps (each view's slot of the batch samples its own M / QUAD_SLOTS).
    Slot k of a view samples one map with uv a ramp over the view (about a
    texel a pixel, as a block face filling the view), shifted by the slot
    and the view, so that neighbouring pixels share texels as a render's
    do; the last view's pixels sample the atlas's last rows (uv 1 and 0 of
    the last map)."""
    from dbw_torch.render.fragment import texel_coords

    dev = gen.device
    TH, TW = QUAD_ATLAS_HW
    V = QUAD_SLOTS * 4
    v = torch.arange(V, device=dev)[:, None, None, None]
    y = torch.arange(H, device=dev)[None, :, None, None]
    x = torch.arange(W, device=dev)[None, None, :, None]
    k = torch.arange(K, device=dev)[None, None, None, :]
    per_slot = M // QUAD_SLOTS
    mi = (v // 4) * per_slot + (k + v) % per_slot
    jitter = torch.rand((V, 1, 1, K, 2), generator=gen, device=dev)
    u = torch.remainder(x / TW + jitter[..., 0], 1.0)
    w = torch.remainder(y / TH + jitter[..., 1], 1.0)
    u = torch.where(v == V - 1, torch.ones_like(u), u)
    w = torch.where(v == V - 1, torch.zeros_like(w), w)
    mi = torch.where(v == V - 1, torch.full_like(mi, M - 1), mi)
    shape = (V, H, W, K)
    id00, wx, wy = texel_coords(u.expand(shape).reshape(-1), w.expand(shape).reshape(-1),
                                mi.expand(shape).reshape(-1), TH, TW)
    maps_flat = torch.rand((M * TH * TW, 3), generator=gen, device=dev)
    return maps_flat, id00, wx, wy


def check_quad_cells(checks, gen):
    """K8 against its plain twin at each benchmark cell's blocks and env
    pass shapes (``quad_cell_inputs``)."""
    TW = QUAD_ATLAS_HW[1]
    for cell, (H, W) in LPIPS_CELLS.items():
        for label, K, M in (("blocks pass", 10, QUAD_SLOTS * QUAD_BLOCKS[cell]),
                            ("env pass", 1, QUAD_SLOTS * 2)):
            args = quad_cell_inputs(H, W, K, M, gen)
            check_quad_sample(checks, f"{cell} {label}", *args, TW)
            del args
            torch.cuda.empty_cache()


def check_texel_grad(checks, path, id00, wx, wy, g, R, TW, K, plain_runs=20):
    """K4 against its plain version, its bound and its index_add_ call."""
    from dbw_torch.ops import texel_grad as tg

    args4 = (id00, wx, wy, g, R, TW)
    got = tg.quad_maps_grad_cuda(*args4, K)
    err4, ok4 = check_close(f"K4 texel grad [{path}, N={id00.numel()}, K={K}, R={R}]: "
                            "d_maps", got, tg.quad_maps_grad_plain(*args4), 1e-5)
    N = id00.numel()
    record(checks, "K4_texel_grad", path, err4, ok4,
           lambda: tg.quad_maps_grad_cuda(*args4, K), lambda: tg.quad_maps_grad_plain(*args4),
           bound(nbytes(id00, wx, wy, g, got), N * FLOPS_PER_ITEM["K4_texel_grad"],
                 items=N),
           k4_library_call(id00, wx, wy, g, R, TW), plain_runs=plain_runs)


def check_env_pass(checks, model, params, phase, R, T, gen, path="env pass", plain_runs=20):
    """K1 hard, K4 and K5 against their plain versions on the env pass's
    own inputs (dome + ground, K=1), formed as Renderer.shade forms them
    (stacked params: the S slots' S * B views, R and T per view)."""
    from dbw_torch.ops import scatter as sc
    from dbw_torch.render import rasterize as rz
    from dbw_torch.render.fragment import bary_uv, texel_coords
    from dbw_torch.render.renderer import fragment_streams

    env, _ = model.build_env(params, phase)
    erend = model.renderer_env
    egeom = rz.project_faces(env.verts, env.faces, R, T, erend.camera,
                             z_clip=erend.config.z_clip)
    epacked = rz.pack_faces(egeom)
    ecfg = erend.config.raster_config()
    ecfg_plain = ecfg._replace(row_chunk=50)

    # K1 hard
    ep2f = rz.rasterize_cuda(epacked, 0.0, ecfg, hard=True)
    eref = rz.rasterize_plain(epacked, 0.0, ecfg_plain)
    dz, ok = check_selection(f"K1 select hard [{path}, F={epacked.shape[1]}, K=1]",
                             ep2f, eref, epacked, 0.0, ecfg)
    record(checks, "K1_select_hard", path, dz, ok,
           lambda: rz.rasterize_cuda(epacked, 0.0, ecfg, hard=True),
           lambda: rz.rasterize_plain(epacked, 0.0, ecfg_plain),
           k1_bound(epacked, ep2f, 0.0, ecfg), plain_runs=plain_runs)

    # the gathered face rows of the real selection and their texel coords
    etable, eids, evld, epx, epy = fragment_streams(env, egeom, ep2f, detach_z=False)
    eidx = torch.where(evld > 0, eids, torch.full_like(eids, -1))
    rows = etable[eidx.clamp(min=0).long()]
    uv_u, uv_v = bary_uv(rows, epx, epy, ecfg.perspective_correct, ecfg.clip_barycentric)
    M, TH, TW = env.atlas.maps.shape[:3]
    id00, wx, wy = texel_coords(uv_u, uv_v, rows[:, 18], TH, TW)
    N = eidx.numel()
    check_quad_sample(checks, path, env.atlas.maps.reshape(-1, 3), id00, wx, wy, TW,
                      plain_runs)

    # K4 (the d_maps of sample_quad_diff), K = 1
    g = torch.randn((N, 3), generator=gen, device=eidx.device) * evld[:, None]
    check_texel_grad(checks, path, id00, wx, wy, g, M * TH * TW, TW, 1, plain_runs)

    # K5: a seeded cotangent of the (N, 20) gathered rows, its first 12
    # columns added into the first 12 of a zeroed (F, 20) gradient, as the
    # gather's backward passes them. A dome face sums up to ~80,000
    # fragments, so the float32 rounding of both versions scales with the
    # summed |upd| of an entry, not with its sum: the tolerance is 1e-6 of
    # that, and a float64 sum shows each version's own error.
    n_rows = etable.shape[0]
    upd = torch.randn((N, etable.shape[1]), generator=gen, device=eidx.device)[:, :12]
    d_table = torch.zeros(etable.shape, device=eidx.device)
    got5 = sc.small_table_scatter_add_cuda(eidx, upd, n_rows, out=d_table)
    ref5 = sc.small_table_scatter_add_plain(eidx, upd, n_rows)
    exact = sc.small_table_scatter_add_plain(eidx, upd.double(), n_rows)
    abs_sum = float(sc.small_table_scatter_add_plain(eidx, upd.abs(), n_rows).max())
    err5 = float((got5 - ref5).abs().max())
    ok5 = err5 <= 1e-6 * abs_sum and not d_table[:, 12:].any()
    say("kernels", f"K5 small scatter [{path}, N={N} (valid {int((eidx >= 0).sum())}), "
        f"table ({n_rows}, 12)]: max |d| {err5:.3g} (tolerance: 1e-6 of the largest "
        f"summed |upd|, {abs_sum:.4g}); to the float64 sum: kernel "
        f"{float((got5.double() - exact).abs().max()):.3g}, plain "
        f"{float((ref5.double() - exact).abs().max()):.3g}; max |sum| "
        f"{float(ref5.abs().max()):.3g}; columns 12-19 of the (F, 20) gradient "
        f"zero {not d_table[:, 12:].any()}")
    keep = eidx >= 0
    record(checks, "K5_small_scatter", path, err5, ok5,
           lambda: sc.small_table_scatter_add_cuda(eidx, upd, n_rows),
           lambda: sc.small_table_scatter_add_plain(eidx, upd, n_rows),
           bound(nbytes(eidx, upd, got5), N * FLOPS_PER_ITEM["K5_small_scatter"], items=N),
           index_add_call(eidx[keep].long(), upd[keep].contiguous(), n_rows),
           plain_runs=plain_runs)


def check_blend(checks, model, B, gen, prefix="", plain_runs=20):
    """K6's forward and backward against the plain twin on B views of the
    image at the blocks pass's K and the env pass's (1), with each
    renderer's background: colours and alphas from ``gen``, a fifth of the
    alphas exactly 0 and a fifth exactly 1. The forward within 1e-6 of the
    plain twin's max (its scans' order against the kernel's serial loop),
    the backward within 1e-5 of the max of the plain twin's autograd in
    float64; the plain backward is timed as autograd over a kept graph."""
    from dbw_torch.render import blend

    dev = gen.device
    with torch.enable_grad():
        for path, rend in (("blocks pass", model.renderer), ("env pass", model.renderer_env)):
            K = rend.config.faces_per_pixel
            bg = blend._background(rend.config.background_color)
            shape = (B,) + IMG_SIZE
            colors = torch.rand(shape + (K, 3), generator=gen, device=dev)
            u = torch.rand(shape + (K,), generator=gen, device=dev)
            alpha = torch.rand(shape + (K,), generator=gen, device=dev)
            alpha = torch.where(u < 0.2, 0.0, torch.where(u > 0.8, 1.0, alpha))
            g = torch.randn(shape + (4,), generator=gen, device=dev)
            n = alpha.numel()
            label = f"[{prefix}{path}, P={n // K}, K={K}, background {bg}]"
            out = blend.layered_blend_fwd_cuda(colors, alpha, bg)
            err_f, ok_f = check_close(
                f"K6 blend forward {label}: RGBA", out,
                blend.layered_blend_plain(colors, alpha, bg), 1e-6,
                note="the plain twin's scans against a serial loop")
            d_c, d_a = blend.layered_blend_bwd_cuda(colors, alpha, g, bg)
            c64, a64 = (t.double().requires_grad_(True) for t in (colors, alpha))
            r_c, r_a = torch.autograd.grad(blend.layered_blend_plain(c64, a64, bg),
                                           (c64, a64), g.double())
            note = "against the plain twin in float64"
            err_c, ok_c = check_close(f"K6 blend backward {label}: d_colors",
                                      d_c.double(), r_c, 1e-5, note=note)
            err_a, ok_a = check_close(f"K6 blend backward {label}: d_alpha",
                                      d_a.double(), r_a, 1e-5, note=note)
            del c64, a64, r_c, r_a
            record(checks, "K6_blend_fwd", prefix + path, err_f, ok_f,
                   lambda: blend.layered_blend_fwd_cuda(colors, alpha, bg),
                   lambda: blend.layered_blend_plain(colors, alpha, bg),
                   bound(nbytes(colors, alpha, out), n * FLOPS_PER_ITEM["K6_blend_fwd"],
                         items=n), plain_runs=plain_runs)
            c32, a32 = (t.clone().requires_grad_(True) for t in (colors, alpha))
            graph = blend.layered_blend_plain(c32, a32, bg)
            record(checks, "K6_blend_bwd", prefix + path, max(err_c, err_a), ok_c and ok_a,
                   lambda: blend.layered_blend_bwd_cuda(colors, alpha, g, bg),
                   lambda: torch.autograd.grad(graph, (c32, a32), g, retain_graph=True),
                   bound(nbytes(colors, alpha, g, d_c, d_a),
                         n * FLOPS_PER_ITEM["K6_blend_bwd"], items=n),
                   plain_runs=plain_runs)
            del colors, alpha, g, out, d_c, d_a, c32, a32, graph


def check_lpips(checks, gen, plain_runs=20):
    """K7's forward and backward against the plain twin (the float32 LPIPS
    glue) at each LPIPS_CELLS view's five slice shapes: bfloat16 ReLU
    features from ``gen`` (about half of them 0), channels last as the
    trunk leaves them, LPIPS_RENDERS renders against LPIPS_TARGETS targets
    shared by index. The forward within 1e-5 of the plain twin's max (its
    float32 sums in another order); the backward bit for bit the plain
    twin's autograd (all-zero pixels, NaN there, left out); the plain
    backward is timed as autograd over a kept graph. The bound counts each
    byte once: the renders' and the targets' features read, the distances
    (forward) and the gradient (backward) written."""
    from dbw_torch.losses import vgg

    dev = gen.device

    def features(n, C, H, W):
        x = torch.randn((n, H, W, C), generator=gen, device=dev)
        return torch.relu(x).to(torch.bfloat16).permute(0, 3, 1, 2)

    with torch.enable_grad():
        for cell, (H, W) in LPIPS_CELLS.items():
            for level, C in enumerate(LPIPS_SLICE_CHANNELS):
                h, w = H >> level, W >> level
                f2 = features(LPIPS_RENDERS, C, h, w)
                f1 = features(LPIPS_TARGETS, C, h, w)
                g = torch.randn(LPIPS_RENDERS, generator=gen, device=dev)
                n = f2.numel()
                path = f"{cell} slice {level + 1}"
                label = f"[{path}, {LPIPS_RENDERS} x {C} x {h} x {w}]"
                out = vgg.lpips_slice_fwd_cuda(f2, f1)
                err_f, ok_f = check_close(
                    f"K7 lpips forward {label}: distances", out,
                    vgg.lpips_slice_plain(f2, f1), 1e-5,
                    note="the plain twin's float32 sums in another order")
                grad = vgg.lpips_slice_bwd_cuda(f2, f1, None, g)
                x = f2.detach().clone().requires_grad_(True)
                graph = vgg.lpips_slice_plain(x, f1)
                (d,) = torch.autograd.grad(graph, x, g, retain_graph=True)
                finite = torch.isfinite(d)
                err_b = float((grad != d)[finite].sum())
                ok_b = err_b == 0
                say("kernels", f"K7 lpips backward {label}: {int(err_b)} of "
                    f"{int(finite.sum())} values differ from the plain twin's autograd "
                    f"(tolerance: none, bitwise; {int((~finite).sum())} values of all-zero "
                    "pixels, NaN on the plain route, left out)")
                record(checks, "K7_lpips_fwd", path, err_f, ok_f,
                       lambda: vgg.lpips_slice_fwd_cuda(f2, f1),
                       lambda: vgg.lpips_slice_plain(f2, f1),
                       bound(nbytes(f2, f1, out), n * FLOPS_PER_ITEM["K7_lpips_fwd"],
                             items=n), plain_runs=plain_runs)
                record(checks, "K7_lpips_bwd", path, err_b, ok_b,
                       lambda: vgg.lpips_slice_bwd_cuda(f2, f1, None, g),
                       lambda: torch.autograd.grad(graph, x, g, retain_graph=True),
                       bound(nbytes(f2, f1, g, grad), n * FLOPS_PER_ITEM["K7_lpips_bwd"],
                             items=n), plain_runs=plain_runs)
                del f2, f1, g, out, grad, x, graph, d, finite
            torch.cuda.empty_cache()


def check_viz_selection(checks, model, params, R, T):
    """K1-hard at 4x supersampling, at the shapes of the viz and eval
    renders: the eval scene (dome, ground and blocks, 1,248 faces: the
    quantitative eval and the edge overlays) and the blocks alone (800
    faces: the flat-lit synthetic renders), 4 views of 1200x1600. The
    kernel's selection must equal its plain twin's bit for bit (hard K=1
    selection has no near-ties to excuse)."""
    from dbw_torch.models.dbw import Phase
    from dbw_torch.render import rasterize as rz
    from dbw_torch.render.cameras import ndc_pixel_centers

    phase = Phase.eval_phase(filter_transparent=True)
    rend = model.renderer_viz
    rcfg = rend.config.raster_config()
    rcfg_plain = rcfg._replace(row_chunk=20)
    for path, scene in (("viz/eval scene", model.build_scene(params, phase)[0]),
                        ("viz/eval blocks", model.build_blocks(params, phase)[0])):
        geom = rz.project_faces(scene.verts, scene.faces, R, T, rend.camera,
                                z_clip=rend.config.z_clip)
        packed = rz.pack_faces(geom)
        got = rz.rasterize_cuda(packed, 0.0, rcfg, hard=True)
        t0 = time.perf_counter()
        ref = rz.rasterize_plain(packed, 0.0, rcfg_plain)
        torch.cuda.synchronize()
        mism = got != ref
        n_mis = int(mism.sum())
        for b, i, j, _ in torch.nonzero(mism)[:5].tolist():
            # a differing slot: both faces' depth keys at the pixel
            xs, ys = ndc_pixel_centers(rcfg.image_size, got.device)
            faces = [int(got[b, i, j, 0]), int(ref[b, i, j, 0])]
            keys = rz._score(xs[j].view(1, 1), ys[i].view(1, 1),
                             packed[b, [max(f, 0) for f in faces]][None], 0.0,
                             rcfg.z_clip, True, True)[0].tolist()
            say("kernels", f"  view {b} pixel ({i}, {j}): kernel face {faces[0]}, plain "
                f"face {faces[1]}, their depth keys {keys}")
        say("kernels", f"K1 select hard at 4x [{path}, F={packed.shape[1]}, "
            f"{tuple(got.shape)}]: {n_mis} of {got.numel()} slots differ from the plain "
            f"twin (tolerance: none, bitwise); valid slots {int((got >= 0).sum())}; "
            f"plain twin {time.perf_counter() - t0:.1f} s")
        checks.setdefault("K1_select_hard_ss", []).append(dict(
            path=path, max_abs_err=float(n_mis),
            ms=cuda_ms(lambda: rz.rasterize_cuda(packed, 0.0, rcfg, hard=True)),
            plain_ms=cuda_ms(lambda: rz.rasterize_plain(packed, 0.0, rcfg_plain),
                             runs=1, pairs=1),
            plain_calls=1, library_ms=None, device_ms=None, ok=n_mis == 0,
            **k1_bound(packed, got, 0.0, rcfg)))
        del got, ref


def phase_kernels(model, device):
    """Each kernel against its plain version on the card, at the shapes of
    every path that launches it: the main path's blocks and env passes, and
    the joint path's one scene. The first check of each kernel is at the
    main path's shapes; its times go into the kernels line."""
    params = model.init_params(seed=0)
    phase = model.phase_for_epoch(0)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(1)
    checks = {}
    with torch.no_grad():
        noise = torch.randn((model.n_blocks,), generator=gen, device=device)
        blocks, _ = model.build_blocks(params, phase, noise=noise)
        check_soft_pass(checks, "blocks pass", model, blocks, phase, R, T, gen)
        check_env_pass(checks, model, params, phase, R, T, gen)
        check_blend(checks, model, N_VIEWS, gen)
        check_lpips(checks, gen)
        check_quad_cells(checks, gen)
        joint, _, _ = model.build_scene(params, phase, noise=noise)
        check_soft_pass(checks, "joint", model, joint, phase, R, T, gen)
        check_band_frag_bwd(checks, model, blocks, phase, R, T, gen)
        check_viz_selection(checks, model, params, R, T)
    report_checks("kernels", checks)
    return {n: dict(max_abs_err=max(c["max_abs_err"] for c in cs),
                    **{k: cs[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "bound_counts", "library_ms", "device_ms")},
                    checks=cs) for n, cs in checks.items()}


def report_checks(phase, checks):
    """Print each kernel check's times and bound; fail if one disagreed."""
    for name, cs in checks.items():
        for c in cs:
            lib = "" if c["library_ms"] is None else f", index_add_ {c['library_ms']:.4f} ms"
            dev = "" if name not in DEVICE_KERNELS else (
                "; device time of one launch not measured" if c["device_ms"] is None
                else f"; device time of one launch {c['device_ms']:.4f} ms (profiler)")
            plain = ("" if c["plain_calls"] > 1
                     else "; the plain twin's one call after a warm-up")
            say(phase, f"{name} [{c['path']}]: kernel {c['ms']:.4f} ms, plain "
                f"{c['plain_ms']:.4f} ms{lib} (CUDA events around 20 calls, median of "
                f"5{plain}){dev}; bound {c['bound_ms']:.4f} ms by {c['bound_by']} "
                f"{c['bound_counts']}, {c['bound_ms'] / c['ms']:.3f} of it")
    bad = [f"{n} [{c['path']}]" for n, cs in checks.items() for c in cs if not c.pop("ok")]
    if bad:
        raise SystemExit(f"kernel check failed: {bad}")


def run_steps(tag, model, params, opt, n_steps, kernel_names, device):
    """n_steps flagship Adam steps through model.forward; every kernel of
    kernel_names must launch in every step, no other kernel may launch.
    Returns (launch counts, per-step seconds)."""
    from dbw_torch import kernels

    phase = model.phase_for_epoch(0, training=True)
    imgs = torch.from_numpy(np.random.default_rng(0).random(
        (N_VIEWS,) + IMG_SIZE + (3,), np.float32)).to(device)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for step in range(n_steps):
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        losses = model.forward(params, phase, imgs, R, T, generator=gen)
        losses["total"].backward()
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        vals = {k: float(v.detach()) for k, v in losses.items()}
        missing = [k for k in kernel_names if kernels.LAUNCHES[k] == before[k]]
        stray = [k for k in kernels.LAUNCHES
                 if k not in kernel_names and kernels.LAUNCHES[k] != before[k]]
        say(tag, f"step {step}: " + " ".join(f"{k}={v:.6g}" for k, v in vals.items())
            + f" ({times[-1] * 1e3:.1f} ms)")
        if not all(math.isfinite(v) for v in vals.values()):
            raise SystemExit(f"{tag}: non-finite loss at step {step}")
        if missing or stray:
            raise SystemExit(f"{tag} step {step}: kernels not launched {missing}, "
                             f"launched off the path {stray}")
        for k, p in params.items():
            if not torch.isfinite(p).all():
                raise SystemExit(f"{tag}: non-finite parameter {k} after step {step}")
    launches = dict(kernels.LAUNCHES)
    with torch.no_grad():
        rec, _ = model.predict(params, phase, R, T, noise=torch.zeros(
            model.n_blocks, device=device))
    if rec.shape != (N_VIEWS,) + IMG_SIZE + (3,) or not torch.isfinite(rec).all() \
            or rec.min() < -1e-6 or rec.max() > 1 + 1e-5:
        raise SystemExit(f"{tag}: bad render: shape {tuple(rec.shape)}")
    say(tag, f"render after {n_steps} steps: {tuple(rec.shape)}, finite, in "
        f"[{float(rec.min()):.3g}, {float(rec.max()):.3g}]")
    med = float(np.median(times[1:]))
    say(tag, f"median step {med * 1e3:.2f} ms ({1.0 / med:.3f} steps/s, steps "
        f"1-{n_steps - 1}, host clock around synchronized steps); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(tag, f"launches: {launches}")
    return launches, times


def phase_main(cfg, device):
    """The shipped config's train step (decoupled env pass), N_STEPS times,
    through model.forward; then the step split into its layers, and a
    profiler trace of a few steps."""
    from dbw_torch.train.optimizer import create_optimizer

    model = make_model(cfg, device)
    params = model.init_params(seed=0)
    opt = create_optimizer(cfg, params)
    say("main", "optimizer: Adam, lrs " + ", ".join(
        f"{g['name']} {g['lr']}" for g in opt.param_groups))
    launches, times = run_steps("main", model, params, opt, N_STEPS, STEP_KERNELS,
                                device)
    vgg = vgg_dtype_check(cfg, model, times, device)
    split_step(model, params, opt, device)
    profile_steps(model, params, opt, device)
    return launches, vgg


def vgg_dtype_check(cfg, model, bf16_times, device):
    """The main step with float32 VGG16 features (N_F32_STEPS steps) beside
    the bfloat16 default's in this call, and the card's bfloat16 features
    against its float32 ones on the LPIPS input of 4 random views."""
    from dbw_torch.losses.vgg import _LPIPS_SCALE, _LPIPS_SHIFT
    from dbw_torch.train.optimizer import create_optimizer

    m32 = make_model(cfg, device, vgg_dtype=torch.float32)
    p32 = m32.init_params(seed=0)
    _, f32_times = run_steps("main f32", m32, p32, create_optimizer(cfg, p32),
                             N_F32_STEPS, STEP_KERNELS, device)
    vb, vf = model.perceptual_loss.vgg, m32.perceptual_loss.vgg
    x = np.random.default_rng(5).random((N_VIEWS,) + IMG_SIZE + (3,), np.float32)
    x = torch.from_numpy((x * 2 - 1 - _LPIPS_SHIFT) / _LPIPS_SCALE).to(device)
    with torch.no_grad():
        gaps = [(float((b - f).abs().max() / f.abs().max()),
                 float((b - f).abs().mean() / f.abs().mean()))
                for b, f in zip(vb(x, 5), vf(x, 5))]
    ok = (vb.dtype == torch.bfloat16 and vf.dtype == torch.float32
          and all(a <= VGG_BF16_MAX_REL and m <= VGG_BF16_MEAN_REL for a, m in gaps))
    out = dict(bf16_step_ms=1e3 * float(np.median(bf16_times[1:])),
               f32_step_ms=1e3 * float(np.median(f32_times[1:])),
               feature_gaps=gaps)
    say("vgg", f"the step with {vb.dtype} features (the default on the card) "
        f"{out['bf16_step_ms']:.2f} ms (median of steps 1-{N_STEPS - 1}), with "
        f"{vf.dtype} features {out['f32_step_ms']:.2f} ms (median of steps "
        f"1-{N_F32_STEPS - 1}), same call; bfloat16 vs float32 features per slice "
        "(max |d|/max|f32|, mean |d|/mean|f32|): "
        + ", ".join(f"{a:.3g}/{m:.3g}" for a, m in gaps)
        + f" (tolerances {VGG_BF16_MAX_REL}, {VGG_BF16_MEAN_REL})")
    if not ok:
        raise SystemExit("vgg: the bfloat16 features disagree with the float32 ones")
    return out


# device kernels by family, matched on their names
KERNEL_FAMILIES = {
    "convolution": ("conv", "fft", "xmma", "cudnn", "dgrad", "wgrad", "gemm",
                    "region_transform"),
    "scan (cumprod blend)": ("scan",),
    "hand-written": ("select_kernel", "frag_fwd_kernel", "frag_bwd_kernel",
                     "texel_grad_kernel", "small_scatter_kernel", "blend_fwd_kernel",
                     "blend_bwd_kernel"),
}


def family_shares(totals):
    """Each KERNEL_FAMILIES family's share of the summed device time, from
    {device kernel name: its summed time}."""
    total = sum(totals.values())
    return {fam: sum(t for n, t in totals.items() if any(k in n for k in keys)) / total
            for fam, keys in KERNEL_FAMILIES.items()}


def device_events(prof):
    """A profiler's device records (kernels and copies)."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy(events):
    """(busy, span) of device records, in the profiler's microseconds: the
    union of their intervals, and the span from the first one's start to
    the last one's end."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def profile_steps(model, params, opt, device):
    """torch.profiler over N_PROFILE_STEPS decoupled steps (after one
    warm-up): the device's busy time (the union of its kernel and copy
    intervals) against the span from the first one's start to the last
    one's end, each family's share of the summed device time, and the
    kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    phase = model.phase_for_epoch(0, training=True)
    imgs = torch.from_numpy(np.random.default_rng(3).random(
        (N_VIEWS,) + IMG_SIZE + (3,), np.float32)).to(device)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(3)

    def step():
        opt.zero_grad(set_to_none=True)
        model.forward(params, phase, imgs, R, T, generator=gen)["total"].backward()
        opt.step()

    step()
    torch.cuda.synchronize()
    for i in range(2):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(N_PROFILE_STEPS):
                step()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / N_PROFILE_STEPS
        dev = device_events(prof)
        if dev:
            if i:
                say("profile", "device records read in profiler trace 2 of 2")
            break
    else:
        # a reading, not a check: see device_ms
        say("profile", "idle share and device time: not measured (neither of 2 "
            "profiler traces held device records)")
        return
    busy, span = device_busy(dev)
    per_name = {}
    for e in dev:
        per_name[e.name] = per_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    total = sum(per_name.values())
    say("profile", f"{N_PROFILE_STEPS} decoupled steps under torch.profiler, "
        f"{wall:.2f} ms a step on the host clock: device busy {busy / 1e3:.2f} ms "
        f"of a {span / 1e3:.2f} ms span, idle share {1.0 - busy / span:.3f}; "
        f"summed device time {total / 1e3:.2f} ms")
    shares = family_shares(per_name)
    say("profile", "share of summed device time: " + ", ".join(
        f"{fam} {v:.3f}" for fam, v in shares.items()))
    for n, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:15]:
        say("profile", f"{t / 1e3:9.3f} ms {t / total:.3f}  {n[:110]}")


def split_step(model, params, opt, device):
    """The decoupled step's layers on the stream: the leaves of
    ``dbw_torch.utils.profiling`` forward and backward, recorded under
    ``recording()`` over N_SPLIT_STEPS steps. Median over the last
    N_SPLIT_STEPS - 1 steps."""
    from dbw_torch.parallel.seeds import train_step
    from dbw_torch.utils import profiling

    phase = model.phase_for_epoch(0, training=True)
    imgs = torch.from_numpy(np.random.default_rng(1).random(
        (N_VIEWS,) + IMG_SIZE + (3,), np.float32)).to(device)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(2)
    profiling.reset()
    with profiling.recording():
        for _ in range(N_SPLIT_STEPS):
            with profiling.step():
                train_step(model, opt, params, phase, (imgs, R, T), gen)
    steps = profiling.summary()[1:N_SPLIT_STEPS]
    profiling.reset()
    # stream ms on the card, host ms where no CUDA event was taken
    kind = "stream_ms" if steps[0]["stream_ms"] else "host_ms"
    names = [n for n in steps[0][kind]
             if n in profiling.LEAVES or n.startswith(profiling.BACKWARD)]
    med = {n: float(np.median([s[kind].get(n, 0.0) for s in steps])) for n in names}
    step_ms = float(np.median([s[kind]["dbw.step"] for s in steps]))
    say("split", f"decoupled step's leaves, {kind} (profiling.summary, median of "
        f"{len(steps)}): " + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items())
        + f"; sum {sum(med.values()):.2f} ms of dbw.step's {step_ms:.2f} ms")


def phase_joint(cfg, device):
    """The joint-rendering path: the same config with decouple_rendering=False."""
    from dbw_torch.train.optimizer import create_optimizer

    model = make_model(cfg, device, rend_optim=dict(decouple_rendering=False))
    params = model.init_params(seed=0)
    opt = create_optimizer(cfg, params)
    launches, _ = run_steps("joint", model, params, opt, N_JOINT_STEPS,
                            JOINT_KERNELS, device)
    return launches


def check_band_selection(label, packed, blur, rcfg, hard):
    """K1 in row bands: each split's bands, concatenated and cropped, are the
    kernel's full raster bit for bit, and each band agrees with the plain
    band (the near-tie rule of check_selection)."""
    from dbw_torch.render import rasterize as rz

    H = rcfg.image_size[0]
    full = rz.rasterize_cuda(packed, blur, rcfg, hard=hard)
    mid = BAND_SPLITS["3 bands"][1]

    def band_fn():
        return rz.rasterize_cuda(packed, blur, rcfg, hard=hard, row_range=mid)

    work = k1_bound(packed, band_fn(), blur, rcfg, row_range=mid)
    say("band", f"{label}: band {mid} kernel {cuda_ms(band_fn):.4f} ms (CUDA events "
        f"around 20 calls, median of 5), bound {work['bound_ms']:.4f} ms by {work['bound_by']} "
        f"{work['bound_counts']}")
    ok = True
    for split, bands in BAND_SPLITS.items():
        got = [rz.rasterize_cuda(packed, blur, rcfg, hard=hard, row_range=rr)
               for rr in bands]
        same = torch.equal(torch.cat(got, dim=1)[:, :H], full)
        say("band", f"{label}, {split}: bands = full raster's rows bitwise {same}")
        ok &= same
        for rr, band in zip(bands, got):
            ref = rz.rasterize_plain(packed, blur, rcfg._replace(row_chunk=50), row_range=rr)
            ok &= check_selection(f"{label} band {rr} vs plain", band, ref, packed, blur,
                                  rcfg, row_range=rr)[1]
    return ok


def band_case(cfg, device):
    """The band phase's model and seeded inputs: a namespace of model,
    params, phase, R, T, noise, imgs and ou (the overlap draws)."""
    # float32 features: the band checks hold the band entry points and the
    # kernels, whose differences bfloat16 rounding would magnify
    model = make_model(cfg, device, vgg_dtype=torch.float32)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(4)
    noise = torch.randn((model.n_blocks,), generator=gen, device=device)
    return types.SimpleNamespace(
        model=model, params=model.init_params(seed=0),
        phase=model.phase_for_epoch(0, training=True), R=R, T=T, noise=noise,
        imgs=torch.from_numpy(np.random.default_rng(4).random(
            (N_VIEWS,) + IMG_SIZE + (3,), np.float32)).to(device),
        ou=torch.rand((model.n_blocks, 1000, 3), generator=gen, device=device))


def band_step(c, band, others):
    """One forward and backward of the band (row0, Hb) whose rec_gather
    places it between the renders ``others`` of the bands before and after
    it, as an all-gather over the bands would on one card:
    ({loss: value}, {leaf: gradient})."""
    H = IMG_SIZE[0]

    def rec_gather(rec):
        return torch.cat([others[0], rec, others[1]], dim=1)[:, :H]

    for p in c.params.values():
        p.grad = None
    losses = c.model.forward(c.params, c.phase, c.imgs, c.R, c.T, opacity_noise=c.noise,
                             overlap_u=c.ou, row_range=band, rec_gather=rec_gather)
    losses["total"].backward()
    torch.cuda.synchronize()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {k: p.grad.clone() for k, p in c.params.items() if p.grad is not None})


def phase_band(cfg, device):
    """The pixel-band entry points on the shipped config: K1's band against
    the full raster and the plain band at the env and blocks shapes; then,
    with the launch counts set to 0 after the full predict and forward,
    predict in the bands of BAND_SPLITS against the full predict (rec within
    1e-6) and one forward and backward of the middle band of 3 whose
    rec_gather places it among the other bands' renders (losses within 1e-6
    relative of the full forward's); last, that band's losses and gradients
    against the same band step with the kernels of its backward (K3, K4,
    K5) routed to their plain twins. Returns the band path's launch
    counts."""
    from dbw_torch import kernels
    from dbw_torch.render import rasterize as rz

    c = band_case(cfg, device)
    model, params, phase, R, T, noise = c.model, c.params, c.phase, c.R, c.T, c.noise
    H = IMG_SIZE[0]
    ok = True
    with torch.no_grad():
        for label, scene, rend, hard in (
                ("env pass", model.build_env(params, phase)[0], model.renderer_env, True),
                ("blocks pass", model.build_blocks(params, phase, noise=noise)[0],
                 model.renderer, False)):
            _, blur = rend.sigma_blur(None if hard else phase.sigma)
            geom = rz.project_faces(scene.verts, scene.faces, R, T, rend.camera,
                                    z_clip=rend.config.z_clip)
            ok &= check_band_selection(f"K1 [{label}, F={scene.faces.shape[0]}]",
                                       rz.pack_faces(geom), blur,
                                       rend.config.raster_config(), hard)
        full, _ = model.predict(params, phase, R, T, noise=noise)
        full_losses = model.forward(params, phase, c.imgs, R, T, opacity_noise=noise,
                                    overlap_u=c.ou)
    # the band path alone from here: its predicts, its forward and backward
    kernels.reset_launches()
    with torch.no_grad():
        recs = {}
        for split, bands in BAND_SPLITS.items():
            recs[split] = [model.predict(params, phase, R, T, noise=noise, row_range=rr)[0]
                           for rr in bands]
            err = float((torch.cat(recs[split], dim=1)[:, :H] - full).abs().max())
            say("band", f"predict, {split}: max |band - full| {err:.3g} (tolerance 1e-6)")
            ok &= err <= 1e-6
    band = BAND_SPLITS["3 bands"][1]
    others = recs["3 bands"][0], recs["3 bands"][2]
    losses, grads = band_step(c, band, others)
    launches = dict(kernels.LAUNCHES)
    say("band", f"launches of the band path: {launches}")
    missing = [k for k in STEP_KERNELS if not launches[k]]
    rel = max(abs(losses[k] - float(full_losses[k])) / max(abs(float(full_losses[k])), 1e-30)
              for k in full_losses)
    finite = all(torch.isfinite(g).all() for g in grads.values())
    say("band", f"forward of band {band} with rec_gather: losses max rel to the full "
        f"forward {rel:.3g} (tolerance 1e-6), total {losses['total']:.9g} vs "
        f"{float(full_losses['total']):.9g}; gradients finite {finite}")
    ok &= rel <= 1e-6 and finite

    # the band's backward held: the same band step with K3, K4 and K5 routed
    # to their plain twins; K1 and K2, held above, keep the forward. Losses
    # within rtol 1e-6, each leaf's gradient within 1e-5 of its max. (K2
    # stays: the ground's gradients are small, as the blocks hide most of
    # it, and K2's 1e-7 rounding moves them by up to 6e-4 of their max;
    # scripts/torch_band_grad_gaps.py shows it.)
    twins = plain_twins()
    with routed(twins[k] for k in BACKWARD_KERNELS):
        plain_losses, plain_grads = band_step(c, band, others)
    stray = [k for k in BACKWARD_KERNELS if kernels.LAUNCHES[k] != launches[k]]
    loss_rel = max(abs(losses[k] - plain_losses[k]) / max(abs(plain_losses[k]), 1e-30)
                   for k in plain_losses)
    gaps = grad_gap(grads, plain_grads) if grads.keys() == plain_grads.keys() else {}
    leaf = max(gaps, key=gaps.get, default=None)
    say("band", f"band {band} backward, kernels vs plain twins of K3, K4, K5: losses "
        f"max rel {loss_rel:.3g} (tolerance 1e-6), grads max |d|/max|g| "
        f"{gaps.get(leaf, math.inf):.3g} at {leaf} over {len(gaps)} leaves (tolerance "
        f"1e-5); kernels launched by the twins' run {stray}")
    ok &= (bool(gaps) and not stray and loss_rel <= 1e-6
           and max(gaps.values()) <= 1e-5)
    if missing or not ok:
        raise SystemExit(f"band phase failed (kernels not launched: {missing})")
    return launches


def plain_twins():
    """Kernel name -> (module, dispatcher, plain twin) for the kernels of
    the fragment stage and the backward. Routing a dispatcher to its twin
    runs the twin for CUDA tensors too, launching nothing."""
    from dbw_torch.ops import scatter, texel_grad
    from dbw_torch.render import fragment, meshes

    return {"K2_frag_fwd": (fragment, "frag_fwd", fragment.frag_fwd_plain),
            "K3_frag_bwd": (fragment, "frag_bwd", fragment.frag_bwd_plain),
            # the plain twin takes no K: the layout does not change its sums
            "K4_texel_grad": (meshes, "quad_maps_grad",
                              lambda *a: texel_grad.quad_maps_grad_plain(*a[:-1])),
            "K5_small_scatter": (scatter, "small_table_scatter_add",
                                 scatter.small_table_scatter_add_plain),
            "K8_quad_fwd": (meshes, "quad_forward", meshes.quad_forward_plain)}


@contextlib.contextmanager
def routed(swaps):
    """Set each (module, attribute, function) of ``swaps`` while the block
    runs, and restore the attributes after it."""
    swaps = list(swaps)
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_train(cfg, device):
    """One epoch on the port's synthetic ground truth of the config, then a
    model.pkl round trip that must reproduce the next step."""
    from dbw_torch.data import create_train_val_test_loader
    from dbw_torch.train import checkpoint as ck
    from dbw_torch.train.optimizer import create_optimizer
    from dbw_torch.train.scheduler import base_lrs, create_scheduler, set_lrs

    t0 = time.perf_counter()
    train, val, test = create_train_val_test_loader(cfg, device=device)
    torch.cuda.synchronize()
    ds = train.dataset
    say("train", f"synthetic GT rendered on the card: train {ds.imgs.shape}, val "
        f"{val.dataset.imgs.shape}, test {test.dataset.imgs.shape}, "
        f"{len(ds.pc_gt)} GT points, {time.perf_counter() - t0:.1f} s")
    if not (np.isfinite(ds.imgs).all() and ds.imgs.std() > 0.05):
        raise SystemExit("train: bad synthetic ground truth")
    model = make_model(cfg, device, img_size=ds.img_size, K=ds.K[0])
    params = model.init_params(seed=cfg["training"]["seed"])
    opt = create_optimizer(cfg, params)
    sched = create_scheduler(cfg, base_lrs(opt))
    imgs_all = torch.from_numpy(ds.imgs).to(device)
    R_all, T_all = torch.from_numpy(ds.R).to(device), torch.from_numpy(ds.T).to(device)
    bs = train.batch_size
    gen = torch.Generator(device=device).manual_seed(cfg["training"]["seed"])

    def batch(ids):
        # a ragged last batch repeats its last view, as the JAX trainer does
        ids = np.concatenate([ids, np.repeat(ids[-1:], bs - len(ids))])
        idx = torch.from_numpy(ids.astype(np.int64)).to(device)
        return imgs_all[idx], R_all[idx], T_all[idx]

    epoch = 0
    phase = model.phase_for_epoch(epoch, training=True)
    set_lrs(opt, sched.lrs(epoch))
    order = list(train.iter_indices())
    totals = []
    t0 = time.perf_counter()
    for ids in order:
        opt.zero_grad(set_to_none=True)
        losses = model.forward(params, phase, *batch(ids), generator=gen)
        losses["total"].backward()
        opt.step()
        totals.append(float(losses["total"].detach()))
    torch.cuda.synchronize()
    if not all(math.isfinite(v) for v in totals):
        raise SystemExit(f"train: non-finite loss in the epoch: {totals}")
    say("train", f"epoch {epoch}: {len(order)} batches of {bs} (loader order "
        f"{[list(map(int, o)) for o in order[:2]]}...), lrs "
        f"{ {g['name']: g['lr'] for g in opt.param_groups} }, total loss "
        f"{totals[0]:.6g} -> {totals[-1]:.6g}, {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory() as run_dir:
        path = ck.save_checkpoint(Path(run_dir) / "model.pkl", params, opt,
                                  epoch + 1, len(order),
                                  model_kwargs=cfg["model"])
        state = ck.load_checkpoint(path)
        size = path.stat().st_size
    params2 = model.init_params(seed=1)
    opt2 = create_optimizer(cfg, params2)
    set_lrs(opt2, sched.lrs(epoch + 1))
    set_lrs(opt, sched.lrs(epoch + 1))
    ck.restore(state, params2, opt2)
    same = all(torch.equal(params[k], params2[k]) for k in params) and all(
        torch.equal(opt.state[params[k]][f], opt2.state[params2[k]][f])
        for k in params for f in ("step", "exp_avg", "exp_avg_sq"))
    if not same:
        raise SystemExit("train: reloaded state differs from the saved one")

    # the next step from both states: the same batch and random draws
    imgs, R, T = batch(next(iter(train.iter_indices())))
    noise = torch.randn((model.n_blocks,), generator=gen, device=device)
    ou = torch.rand((model.n_blocks, 1000, 3), generator=gen, device=device)
    phase = model.phase_for_epoch(epoch + 1, training=True)
    out = []
    for p, o in ((params, opt), (params2, opt2)):
        o.zero_grad(set_to_none=True)
        losses = model.forward(p, phase, imgs, R, T, opacity_noise=noise, overlap_u=ou)
        losses["total"].backward()
        out.append({k: float(v.detach()) for k, v in losses.items()})
    grad_rel = max(float((params2[k].grad - params[k].grad).abs().max())
                   / max(float(params[k].grad.abs().max()), 1e-30) for k in params)
    # the gradients pass through atomics, whose order varies from run to
    # run: the optimizer states are held exactly by stepping both from the
    # in-memory run's gradient
    for k in params:
        params2[k].grad = params[k].grad.clone()
    opt.step()
    opt2.step()
    same_params = all(torch.equal(params[k], params2[k]) for k in params)
    say("train", f"model.pkl ({size} bytes) round trip: state equal; next step "
        f"losses equal {out[0] == out[1]} (total {out[0]['total']:.9g} vs "
        f"{out[1]['total']:.9g}), grads max |d|/max|g| {grad_rel:.3g} "
        f"(tolerance 1e-5, atomics), params after the step equal {same_params}")
    if out[0] != out[1] or grad_rel > 1e-5 or not same_params:
        raise SystemExit("train: the reloaded checkpoint does not reproduce the step")


def reference_step(cfg, device, decouple):
    """The small reference model's loss and gradient on ``device``, from a
    seeded init and seeded draws: ({loss: value}, {leaf: grad on the CPU})."""
    from dbw_torch.convert import scene_params_from_numpy

    small = dict(mesh=dict(n_blocks=3, txt_size=32, T_range=[0.2, 0.2, 0.2]),
                 renderer=dict(faces_per_pixel=5))
    # float32 features on both devices: the phase holds the render and the
    # kernels, not the features' dtype
    model = make_model(cfg, device, img_size=(48, 64), **small,
                       rend_optim=dict(decouple_rendering=decouple),
                       vgg_dtype=torch.float32)
    params = scene_params_from_numpy(model.init_params_numpy(0), device)
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.random((2, 48, 64, 3), np.float32)).to(device)
    noise = torch.from_numpy(rng.standard_normal(3).astype(np.float32)).to(device)
    ou = torch.from_numpy(rng.random((3, 1000, 3), np.float32)).to(device)
    R, T = cameras(2, device)
    losses = model.forward(params, model.phase_for_epoch(0), imgs, R, T,
                           opacity_noise=noise, overlap_u=ou)
    losses["total"].backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {k: p.grad.cpu() for k, p in params.items()})


def grad_gap(ga, gb):
    """Per leaf, max |ga - gb| over max |gb|."""
    return {k: float((ga[k] - gb[k]).abs().max()) / max(float(gb[k].abs().max()), 1e-30)
            for k in gb}


def phase_reference(cfg, device):
    """A small model on the card (kernels) against the same model on the CPU
    (plain versions), both with float32 VGG features: losses rtol 1e-4,
    gradients 1e-3 of each leaf's max; decoupled (as configured) and
    joint."""
    for decouple in (True, False):
        (lg, gg), (lc, gc) = (reference_step(cfg, d, decouple) for d in (device, "cpu"))
        worst_l = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
        rel_g = grad_gap(gg, gc)
        leaf = max(rel_g, key=rel_g.get)
        worst_g = rel_g[leaf]
        mode = "decoupled" if decouple else "joint"
        say("reference", f"{mode}: 48x64, 3 blocks, K=5, 2 views, card vs CPU: "
            f"losses max rel {worst_l:.3g} (tolerance 1e-4), grads max |d|/max|g| "
            f"{worst_g:.3g} at {leaf} (tolerance 1e-3); total {lg['total']:.6g} vs "
            f"{lc['total']:.6g}")
        if not (worst_l <= 1e-4 and worst_g <= 1e-3):
            raise SystemExit(f"card and CPU disagree on the small {mode} model")


def timed(fn, spans):
    """fn, with the host-clock seconds of each call appended to ``spans``
    (the card synchronized before and after)."""
    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return out
    return wrapper


def counted(fn, counts, name="K1_select_hard_ss"):
    """fn, with the launches of kernel ``name`` made by each call appended
    to ``counts``."""
    from dbw_torch import kernels

    def wrapper(*args, **kw):
        before = kernels.LAUNCHES[name]
        out = fn(*args, **kw)
        counts.append(kernels.LAUNCHES[name] - before)
        return out
    return wrapper


def quali_names(n_views):
    """The files qualitative_eval writes for each of n_views test views."""
    return [f"{i}_{s}.png" for i in range(n_views)
            for s in ("inp", "rec", "rec_col", "rec_col_inp", "rec_syn_nobkg",
                      "rec_syn_nobkg_edged")]


def check_run_dir(run, n_blocks_kept, n_blocks):
    """Every artifact the JAX Trainer writes for a synthetic run; the
    per-view renders exist when a block survives the eval's filter (the
    JAX package writes none otherwise). Returns the missing ones."""
    want = ["train_metrics.tsv", "val_metrics.tsv", "model.pkl", "final_scores.tsv",
            "quali_eval/mesh.obj", "quali_eval/mesh.mtl", "quali_eval/mesh.png",
            "quali_eval/mesh_full.obj", "quali_eval/gt.ply", "quali_eval/index.html",
            "quali_eval/textures/bkg.png", "quali_eval/textures/ground.png",
            "txt_blocks/img0/final.png"]
    want += [f"quali_eval/textures/block_{k:02d}.png" for k in range(n_blocks)]
    for stream in ("reconstructions", "reconstructions_hard", "reconstructions_syn"):
        want += [f"{stream}/img{k}/{f}" for k in range(4) for f in ("input.png", "final.png")]
    stems = ["quali_eval/rotated_mesh"] + [f"{st}/img{k}/evolution" for k in range(4)
                                           for st in ("reconstructions", "reconstructions_hard",
                                                      "reconstructions_syn")]
    if n_blocks_kept:
        want += [f"quali_eval/{n}" for n in quali_names(10)]
        stems += ["quali_eval/0_rec_traj", "quali_eval/0_rec_traj_syn"]
    missing = [w for w in want if not (run / w).exists()]
    missing += [st + ".*" for st in stems
                if not list((run / st).parent.glob(Path(st).name + ".*"))]
    return missing


def phase_trainer(device, keep):
    """The port's Trainer on the shipped config at full width (300x400, 49
    views, 10 blocks, K=10, 256 texels, steps_per_call 5, decoupled env
    pass), only TRAINER_OVERRIDES changed, in a temporary run directory.
    The launch counts are set to 0 just before Trainer.run and read just
    after. The run's model.pkl and final_scores.tsv, with its config
    dumped as the Trainer's CLI dumps it, are copied to ``keep`` (the bench
    phase's tools read them). Returns (launches, the K1-hard-at-4x launches
    of one val interval's viz and of the final eval, the phase's numbers,
    with the final eval's scores unrounded)."""
    from dbw_torch import kernels
    from dbw_torch.eval import quali, quant
    from dbw_torch.eval.metrics import Metrics
    from dbw_torch.train.trainer import Trainer
    from dbw_torch.utils.config import dump_yaml, load_yaml

    cfg = load_yaml(CONFIG)
    cfg["training"].update(copy.deepcopy(TRAINER_OVERRIDES))
    seed = cfg["training"]["seed"]
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp) / "run"
        t0 = time.perf_counter()
        tr = Trainer(copy.deepcopy(cfg), run, device=device, seed=seed)
        torch.cuda.synchronize()
        say("trainer", f"Trainer built in {time.perf_counter() - t0:.1f} s (synthetic GT "
            f"{tr.dataset.imgs.shape} rendered on the card), {tr.n_batches} batches an "
            f"epoch, steps_per_call {tr.steps_per_call}, overrides {TRAINER_OVERRIDES}")
        spans = {k: [] for k in ("val", "viz", "save", "quant", "quali")}
        viz_ss, eval_ss = [], []
        tr.run_val_and_log = timed(tr.run_val_and_log, spans["val"])
        tr.log_visualizations = counted(timed(tr.log_visualizations, spans["viz"]), viz_ss)
        tr.save = timed(tr.save, spans["save"])
        tr.evaluate = counted(tr.evaluate, eval_ss)
        t_train = []
        plots = tr.save_metric_plots
        tr.save_metric_plots = lambda: (t_train.append(time.perf_counter()), plots())[1]
        quant_scores, quant_eval = [], quant.quantitative_eval
        with routed([(quant, "quantitative_eval", timed(
                         lambda *a, **k: quant_scores.append(quant_eval(*a, **k))
                         or quant_scores[-1], spans["quant"])),
                     (quali, "qualitative_eval", timed(quali.qualitative_eval,
                                                       spans["quali"]))]):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            tr.run(seed=seed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        n_steps = tr.n_epoches * tr.n_batches
        say("trainer", f"run in {wall:.1f} s: {n_steps} steps and "
            f"{len(spans['val'])} val intervals in {t_train[0] - t0:.1f} s, then plots, "
            f"final viz and videos, final eval; launches {launches}")

        log = Metrics(log_file=run / "train_metrics.tsv", append=True).read_log()
        vals = np.stack([v for k, v in log.items() if k.startswith("loss")])
        scores_txt = (run / "final_scores.tsv").read_text().splitlines()
        scores = dict(zip(scores_txt[0].split("\t"), map(float, scores_txt[1].split("\t"))))
        r5 = (ROOT / "runs" / "synthetic" / "dtu_shaped_r5" / "final_scores.tsv")
        r5_header = r5.read_text().splitlines()[0].split("\t")
        missing = check_run_dir(run, int(scores["n_blocks"]), tr.model.n_blocks)
        tpi = log["time/img"]
        steady = float(np.median(tpi[1:]))
        # time/img is per real view: an epoch's steps take len(dataset) views
        views_per_step = len(tr.dataset) / tr.n_batches
        say("trainer", f"train_metrics.tsv: {len(tpi)} rows at iterations "
            f"{[int(i) for i in log['iteration']]}; loss_total "
            f"{log['loss_total'][0]:.6f} -> {log['loss_total'][-1]:.6f}; median time/img "
            f"{float(np.median(tpi)):.6f} s of all windows, {steady:.6f} s past the first "
            f"(its window holds the first viz): {1.0 / (views_per_step * steady):.3f} steps/s "
            f"at {views_per_step:.3f} real views a step; "
            f"{n_steps / (t_train[0] - t0):.3f} steps/s over the whole training loop "
            "(every interval's work included)")
        say("trainer", "one val interval (host clock, card synchronized): opacity check "
            f"{1e3 * float(np.median(spans['val'])):.1f} ms, viz "
            f"{1e3 * float(np.median(spans['viz'][1:-1])):.1f} ms, save "
            f"{1e3 * float(np.median(spans['save'][:-1])):.1f} ms (medians over "
            f"{len(spans['val'])}); K1-hard at 4x launches: {viz_ss[1]} a viz, "
            f"{eval_ss[0]} in the final eval")
        say("trainer", f"final eval: quantitative {spans['quant'][0]:.2f} s, qualitative "
            f"{spans['quali'][0]:.2f} s; final_scores {scores}")
        say("trainer", f"final_scores.tsv header equals r5's {scores_txt[0].split(chr(9)) == r5_header}"
            f"; blocks kept by the eval filter {int(scores['n_blocks'])}; missing artifacts "
            f"{missing}")

        tr2 = Trainer(dict(copy.deepcopy(cfg), training=dict(
            cfg["training"], resume=str(run / "model.pkl"),
            n_epoches=tr.n_epoches + 1)), Path(tmp) / "resumed", device=device, seed=seed)
        say("trainer", f"resumed from model.pkl: epoch_start {tr2.epoch_start}, "
            f"batch_start {tr2.batch_start}, step counter {tr2._step_ctr} (want "
            f"{tr.n_epoches + 1}, 1, {n_steps})")
        ok = (np.isfinite(vals).all() and all(math.isfinite(v) for v in scores.values())
              and scores_txt[0].split("\t") == r5_header and not missing
              and (tr2.epoch_start, tr2.batch_start, tr2._step_ctr)
              == (tr.n_epoches + 1, 1, n_steps))
        not_launched = [k for k in SOURCES if not launches[k]]
        if not ok or not_launched:
            raise SystemExit(f"trainer phase failed (kernels not launched: {not_launched})")
        mesh = export_scored_mesh(tr.model, tr.params) + (np.asarray(tr.dataset.pc_gt),)
        for name in ("model.pkl", "final_scores.tsv"):
            (keep / name).write_bytes((run / name).read_bytes())
        dump_yaml(cfg, keep / CONFIG.name)
    numbers = dict(steps_per_s=n_steps / (t_train[0] - t0),
                   steady_steps_per_s=1.0 / (views_per_step * steady),
                   val_interval_ms=1e3 * float(np.median(spans["val"]) + np.median(
                       spans["viz"][1:-1]) + np.median(spans["save"][:-1])),
                   quant_s=spans["quant"][0], quali_s=spans["quali"][0],
                   final_scores={k: float(v) for k, v in quant_scores[0].items()})
    return launches, viz_ss[1], eval_ss[0], numbers, mesh


def export_scored_mesh(model, params):
    """The run's block mesh as the mesh scorer exports it (the blocks that
    pass the eval's opacity filter); all blocks when none passes, so that
    the mesh phase still has a mesh. -> (verts, faces, label)."""
    from dbw_torch.eval.export import export_blocks_mesh

    verts, faces = export_blocks_mesh(model, params, filter_transparent=True)
    if len(faces):
        return verts, faces, "the blocks that pass the eval filter"
    verts, faces = export_blocks_mesh(model, params, filter_transparent=False)
    return verts, faces, "every block (none passes the eval filter)"


def write_dtu_scan(root, device):
    """scan24 in the IDR layout under ``root``: 49 views of the port's
    synthetic scene rendered on the card at IMG_SIZE, cameras.npz at DTU's
    raw 1200x1600 with DTU_SCALE_MAT, DTU_GT_POINTS GT points in mm, an
    all-observed ObsMask grid of at most 32 MB and a ground plane below."""
    from dbw_torch.data.scan_writer import write_idr_scan
    from dbw_torch.data.synthetic import make_synthetic_scene, sample_gt_points

    t0 = time.perf_counter()
    ds, model, params = make_synthetic_scene(IMG_SIZE, n_views=49, seed=3, device=device)
    with torch.no_grad():
        pts = sample_gt_points(model, params, n_points=DTU_GT_POINTS, seed=1)
    write_idr_scan(root, 24, ds.imgs, ds.K[0], ds.R, ds.T, DTU_SCALE_MAT,
                   points=pts.cpu().numpy())
    obs = root / "ObsMask" / "ObsMask24_10.mat"
    say("dtu", f"scan24 written in {time.perf_counter() - t0:.1f} s: {len(ds)} PNGs of "
        f"{IMG_SIZE}, cameras.npz for 1200x1600, {len(pts)} GT points in mm "
        f"({(root / 'Points' / 'stl' / 'stl024_total.ply').stat().st_size >> 20} MiB), "
        f"ObsMask {obs.stat().st_size >> 20} MiB")


def phase_dtu(device):
    """The Trainer on configs/dtu/scan24.yml at full width on a written
    scan, DTU_OVERRIDES, DTU_MESH_OVERRIDES and dataset.root only, through
    the final eval's DTU
    branch (the official protocol's dtu_scores.tsv). The launch counts are
    set to 0 just before Trainer.run and read just after. Returns
    (launches, the phase's numbers)."""
    import functools

    from dbw_torch import kernels
    from dbw_torch.eval import dtu_eval
    from dbw_torch.train.trainer import Trainer
    from dbw_torch.utils.config import load_yaml

    cfg = load_yaml(DTU_CONFIG)
    seed = cfg["training"]["seed"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "DTU"
        write_dtu_scan(root, device)
        cfg["dataset"]["root"] = str(root)
        cfg["training"].update(copy.deepcopy(DTU_OVERRIDES))
        cfg["model"]["mesh"].update(DTU_MESH_OVERRIDES)
        run = Path(tmp) / "run"
        t0 = time.perf_counter()
        tr = Trainer(copy.deepcopy(cfg), run, device=device, seed=seed)
        ds = tr.dataset
        say("dtu", f"Trainer built in {time.perf_counter() - t0:.1f} s on "
            f"{DTU_CONFIG.relative_to(ROOT)} over its default.yml: dataset {ds.name} "
            f"{ds.tag} {ds.imgs.shape}, {len(ds.pc_gt)} GT points, model "
            f"{cfg['model']['mesh']['n_blocks']} blocks, K="
            f"{cfg['model']['renderer']['faces_per_pixel']}, txt_size "
            f"{cfg['model']['mesh']['txt_size']}, R_world {cfg['model']['mesh']['R_world']}, "
            f"S_world {cfg['model']['mesh']['S_world']}, decouple_rendering "
            f"{cfg['model']['rend_optim']['decouple_rendering']}; overrides "
            f"{DTU_OVERRIDES}, model.mesh {DTU_MESH_OVERRIDES} and dataset.root")
        spans = {"eval": [], "protocol": []}
        timings = {}
        tr.evaluate = timed(tr.evaluate, spans["eval"])
        t_train = []
        plots = tr.save_metric_plots
        tr.save_metric_plots = lambda: (t_train.append(time.perf_counter()), plots())[1]
        protocol = timed(functools.partial(dtu_eval.evaluate_mesh, timings=timings),
                         spans["protocol"])
        with routed([(dtu_eval, "evaluate_mesh", protocol)]):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            tr.run(seed=seed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        n_steps = tr.n_epoches * tr.n_batches
        scores_txt = (run / "final_scores.tsv").read_text().splitlines()
        scores = dict(zip(scores_txt[0].split("\t"), map(float, scores_txt[1].split("\t"))))
        dtu_txt = (run / "dtu_scores.tsv").read_text().splitlines() \
            if (run / "dtu_scores.tsv").exists() else ["", ""]
        dtu = dict(zip(dtu_txt[0].split("\t"), map(float, dtu_txt[1].split("\t")))) \
            if dtu_txt[1] else {}
        missing = check_run_dir(run, int(scores["n_blocks"]), tr.model.n_blocks)
        missing += [] if (run / "dtu_scores.tsv").exists() else ["dtu_scores.tsv"]
        numbers = dict(steps_per_s=n_steps / (t_train[0] - t0), eval_s=spans["eval"][0],
                       protocol_s=spans["protocol"][0], protocol_split_s=dict(timings),
                       dtu_scores=dtu, n_blocks_kept=int(scores["n_blocks"]))
        say("dtu", f"run in {wall:.1f} s: {n_steps} steps in {t_train[0] - t0:.1f} s "
            f"({numbers['steps_per_s']:.3f} steps/s over the training loop, interval "
            f"work included), final eval {numbers['eval_s']:.2f} s, of which the "
            f"official protocol {numbers['protocol_s']:.2f} s (sampling "
            f"{timings.get('sample', math.nan):.2f}, downsampling "
            f"{timings.get('downsample', math.nan):.2f}, KD-tree data->GT "
            f"{timings.get('d2s', math.nan):.2f}, GT->data {timings.get('s2d', math.nan):.2f})")
        say("dtu", f"final_scores {scores}; dtu_scores.tsv header {dtu_txt[0].split(chr(9))}, "
            f"{dtu}; missing artifacts {missing}; launches {launches}")
        not_launched = [k for k in SOURCES if not launches[k]]
        ok = (dtu_txt[0] == "acc\tcomp\tavg" and len(dtu) == 3
              and all(math.isfinite(v) for v in dtu.values())
              and all(math.isfinite(v) for v in scores.values()) and not missing)
        if not ok or not_launched:
            raise SystemExit(f"dtu phase failed (kernels not launched: {not_launched})")
    return launches, numbers


def nn_top2_cpu(x, y, chunk=2000):
    """The two smallest squared distances of each row of x to y, by the
    same expansion as nn_dist2_idx, on the CPU: ((P1, 2) values, (P1,)
    scale |x|^2 + |y_best|^2)."""
    y2 = (y * y).sum(-1)
    vals, scales = [], []
    for s in range(0, len(x), chunk):
        xc = x[s:s + chunk]
        x2 = (xc * xc).sum(-1, keepdim=True)
        d2 = (x2 + y2[None]).addmm_(xc, y.T, alpha=-2.0)
        v, i = torch.topk(d2, 2, dim=-1, largest=False)
        vals.append(v)
        scales.append(x2[:, 0] + y2[i[:, 0]])
    return torch.cat(vals), torch.cat(scales)


def phase_mesh(mesh, device):
    """MeshEvaluator at its real size on the card: phase 8's exported block
    mesh against the synthetic GT points, then against 100,000 samples
    with normals of the synthetic scene's GT blocks (the normal scores and
    an ICP of 100,000 x 100,000 clouds); then the card's nn_dist2_idx
    against the CPU's on NN_POINTS x NN_POINTS clouds: the same neighbour
    wherever the CPU's two nearest are no near-tie, squared distances
    within 1e-5 of the expansion's scale. Returns the phase's numbers."""
    from dbw_torch.data.synthetic import make_synthetic_scene
    from dbw_torch.eval.export import export_blocks_mesh
    from dbw_torch.eval.metrics import MeshEvaluator, sample_points_from_mesh
    from dbw_torch.losses.chamfer import nn_dist2_idx

    verts, faces, label, pc_gt = mesh
    ev = MeshEvaluator(device=device)
    _, gt_model, gt_params = make_synthetic_scene((8, 8), n_views=2, seed=3, device=device)
    gv, gf = export_blocks_mesh(gt_model, gt_params)
    gt_pts, gt_nrm = sample_points_from_mesh(gv, gf, ev.N, np.random.default_rng(7),
                                             return_normals=True)
    out = {}
    for name, gt, nrm in (("synthetic GT points", pc_gt, None),
                          ("GT block samples with normals", gt_pts, gt_nrm)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = ev.evaluate(verts, faces, gt, nrm)
        torch.cuda.synchronize()
        out[name] = dict(seconds=time.perf_counter() - t0, scores=dict(scores))
        say("mesh", f"MeshEvaluator (N {ev.N}, {ev.n_iter} ICP steps) on phase 8's "
            f"mesh ({label}: {len(verts)} vertices, {len(faces)} faces) against {len(gt)} "
            f"{name}: {out[name]['seconds']:.2f} s, {dict(scores)}")
        if not scores or not all(math.isfinite(v) for v in scores.values()):
            raise SystemExit("mesh: non-finite mesh scores")

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((NN_POINTS, 3)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((NN_POINTS, 3)).astype(np.float32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_card, i_card = nn_dist2_idx(x.to(device), y.to(device))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    d_cpu, i_cpu = nn_dist2_idx(x, y)
    top2, scale = nn_top2_cpu(x, y)
    tie = (top2[:, 1] - top2[:, 0]) <= NN_TIE_REL * scale
    wrong = int(((i_card.cpu() != i_cpu) & ~tie).sum())
    d_gap = float(((d_card.cpu() - d_cpu).abs() / scale).max())
    out["nn"] = dict(points=NN_POINTS, near_ties=int(tie.sum()), other_neighbour=wrong,
                     max_dist2_gap=d_gap, card_s=t_card)
    say("mesh", f"nn_dist2_idx {NN_POINTS} x {NN_POINTS}, card vs CPU: another neighbour "
        f"at {wrong} points that are no near-tie ({int(tie.sum())} near-ties, two nearest "
        f"within {NN_TIE_REL} of the scale; {int((i_card.cpu() != i_cpu).sum())} differ "
        f"in all); max |d2 card - d2 CPU| / scale {d_gap:.3g} (tolerance 1e-5); card "
        f"{1e3 * t_card:.1f} ms")
    if wrong or d_gap > 1e-5:
        raise SystemExit("mesh: the card's 1-NN disagrees with the CPU's")
    return out


def launch_diff(fn, counts):
    """fn, with the launches of every kernel made by each call added into
    the dict ``counts``."""
    from dbw_torch import kernels

    def wrapper(*args, **kw):
        before = dict(kernels.LAUNCHES)
        out = fn(*args, **kw)
        for k, v in kernels.LAUNCHES.items():
            counts[k] = counts.get(k, 0) + v - before[k]
        return out
    return wrapper


def record_step_losses(t, pick):
    """Wrap the ``_train_step`` of a Trainer or protocol so that each step
    appends ``pick(t)`` (its loss, a device scalar) to the returned list."""
    out, step = [], t._train_step

    def wrapper(*args, **kw):
        step(*args, **kw)
        out.append(pick(t))
    t._train_step = wrapper
    return out


def read_losses(path):
    """A metric TSV as {column: array}."""
    from dbw_torch.eval.metrics import Metrics

    return Metrics(log_file=path, append=True).read_log()


def protocol_run(cfg, run, device, kill_after_save=False, world_size=None):
    """One MultiSeedTrainer run of PROTOCOL_SEEDS (on the ranks of the
    process group, unless ``world_size`` says otherwise); with
    ``kill_after_save`` it dies right after its first save and is resumed
    from multi_model.pkl. Returns (trainer, final per-seed losses, seconds
    of the loop, launches of its run)."""
    from dbw_torch import kernels
    from dbw_torch.train.multi_seed import MultiSeedTrainer

    tr = MultiSeedTrainer(copy.deepcopy(cfg), run, PROTOCOL_SEEDS, device=device,
                          world_size=world_size)
    if kill_after_save:
        save = tr.save

        def save_and_die(epoch, batch):
            save(epoch, batch)
            raise KeyboardInterrupt("killed after the save")

        tr.save = save_and_die
        try:
            tr.run()
        except KeyboardInterrupt:
            pass
        else:
            raise SystemExit("protocol phase failed: the run was not killed")
        import torch.distributed as dist

        if dist.is_initialized():
            dist.barrier()  # rank 0's checkpoint on disk before any rank resumes
        tr = MultiSeedTrainer(copy.deepcopy(cfg), run, resume=True, device=device,
                              world_size=world_size)
        say("protocol", f"killed after the save, resumed at epoch {tr.epoch_start} "
            f"batch {tr.batch_start}, step counter {tr._step_ctr}")
    val_counts = {}
    tr._val_and_log = launch_diff(tr._val_and_log, val_counts)
    tr.val_counts = val_counts
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, _, losses = tr.run()
    torch.cuda.synchronize()
    return tr, np.asarray(losses), time.perf_counter() - t0, dict(kernels.LAUNCHES)


def check_protocol_dir(run, seeds, n_blocks):
    """The JAX protocol's run directory after evaluate(): the missing
    files."""
    want = ["train_metrics.tsv", "seed_selection.tsv", "multi_model.pkl", "model.pkl",
            "final_scores.tsv", "quali_eval/mesh.obj", "quali_eval/index.html",
            "quali_eval/textures/bkg.png"]
    want += [f"quali_eval/textures/block_{k:02d}.png" for k in range(n_blocks)]
    want += [f"seed{s}/{f}" for s in seeds
             for f in ("model.pkl", "val_metrics.tsv", "final_scores.tsv")]
    want += [f"reconstructions_best/img{k}/input.png" for k in range(4)]
    missing = [w for w in want if not (run / w).exists()]
    missing += [f"reconstructions_best/img{k}/evolution.*" for k in range(4)
                if not list((run / "reconstructions_best" / f"img{k}").glob("evolution.*"))]
    missing += [f"seed{s}/quali_eval" for s in seeds if (run / f"seed{s}" / "quali_eval").exists()]
    return missing


@contextlib.contextmanager
def seed_exec(mode):
    """The seed executor ``DBW_SEED_EXEC`` set to ``mode`` inside the
    block."""
    old = os.environ.get("DBW_SEED_EXEC")
    os.environ["DBW_SEED_EXEC"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("DBW_SEED_EXEC")
        else:
            os.environ["DBW_SEED_EXEC"] = old


def per_iteration(tr, loop_launches, n_iter):
    """A protocol run's launches per iteration of its loop, its val
    intervals' work left out."""
    return {k: (loop_launches[k] - tr.val_counts.get(k, 0)) / n_iter for k in SOURCES}


def protocol_step_probe(cfg, device, mode, n_steps=N_PROBE_STEPS):
    """The protocol's step alone under the seed executor ``mode``:
    PROTOCOL_SEEDS' slots through MultiSeedRunner on one rank, on the main
    path's inputs (4 seeded images and the flagship cameras). After a
    warm-up step, ``n_steps`` steps on the host clock (synchronized), the
    launches of each, the peak memory, and the device's idle share over 3
    more steps under torch.profiler."""
    from dbw_torch import kernels
    from dbw_torch.parallel.mesh import make_mesh
    from dbw_torch.parallel.seeds import MultiSeedRunner, stacked_leaves
    from dbw_torch.train.optimizer import create_optimizer
    from dbw_torch.train.trainer import step_seed

    model = make_model(cfg, device)
    params = stacked_leaves([model.init_params(seed=s) for s in PROTOCOL_SEEDS])
    runner = MultiSeedRunner(model, create_optimizer(cfg, params),
                             make_mesh(1, 1, world_size=1))
    imgs, R, T = mesh_inputs(device)
    phase = model.phase_for_epoch(0, training=True)

    def step(k):
        gens = [torch.Generator(device=device).manual_seed(step_seed(s, k))
                for s in PROTOCOL_SEEDS]
        return runner.step(params, phase, imgs, R, T, gens)

    with seed_exec(mode):
        step(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_step = []
        t0 = time.perf_counter()
        for k in range(1, n_steps + 1):
            before = dict(kernels.LAUNCHES)
            step(k)
            per_step.append({n: kernels.LAUNCHES[n] - before[n] for n in STEP_KERNELS})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = device_breakdown(lambda: step(n_steps + 1)) or {}
    out = dict(mode=mode, ms_per_step=ms, seed_steps_per_s=len(PROTOCOL_SEEDS) * 1e3 / ms,
               per_step=per_step, peak_gib=peak, idle_share=prof.get("idle_share"),
               device_busy_ms=prof.get("busy_ms"), device_shares=prof.get("shares"))
    say("protocol", f"the step alone, {mode}: {len(PROTOCOL_SEEDS)} seeds in {ms:.2f} ms "
        f"({out['seed_steps_per_s']:.3f} seed-steps/s), peak memory {peak:.2f} GiB; under "
        f"torch.profiler (3 steps; not measured where None) device idle share "
        f"{out['idle_share']}, device busy {out['device_busy_ms']} ms a step, shares of "
        f"device time {out['device_shares']}; launches of each step {per_step[0]}")
    del model, params, runner
    torch.cuda.empty_cache()
    return out


def check_batched_kernels(cfg, device):
    """Each kernel of the protocol's step against its plain twin at the
    batched step's shapes: PROTOCOL_SEEDS' 5 slots on 4 views, the blocks
    pass and the env pass of 20 views in one launch (the plain twins timed
    by one call). -> the checks."""
    from dbw_torch.parallel.seeds import stack_params

    model = make_model(cfg, device)
    S = len(PROTOCOL_SEEDS)
    params = stack_params([model.init_params(seed=s) for s in PROTOCOL_SEEDS])
    phase = model.phase_for_epoch(0)
    R, T = cameras(N_VIEWS, device)
    R, T = R.repeat(S, 1, 1), T.repeat(S, 1)
    gen = torch.Generator(device=device).manual_seed(2)
    checks = {}
    with torch.no_grad():
        noise = torch.randn((S, model.n_blocks), generator=gen, device=device)
        blocks, _ = model.build_blocks(params, phase, noise=noise)
        check_soft_pass(checks, "protocol blocks pass", model, blocks, phase, R, T, gen,
                        plain_runs=1)
        check_env_pass(checks, model, params, phase, R, T, gen, path="protocol env pass",
                       plain_runs=1)
        check_blend(checks, model, S * N_VIEWS, gen, prefix="protocol ", plain_runs=1)
    del model, params, blocks
    torch.cuda.empty_cache()
    report_checks("protocol", checks)
    return checks


def phase_protocol(device, trainer_steps_per_s, step_launches):
    """The multi-seed protocol on the shipped config at full width with
    PROTOCOL_SEEDS, only PROTOCOL_OVERRIDES changed, under the default
    (batched) seed executor: run A (counts set to 0 just before its run,
    read after its final evaluation), runs B and D (the spread), run C
    killed after its save and resumed; run M under DBW_SEED_EXEC=map, the
    comparison (counts set to 0 before its run). A's loop must launch each
    kernel as often a iteration as the main path does a step
    (``step_launches``), M's 5 times that, and M's final losses must lie
    within the spread tolerance of A's. Then the step alone batched and
    map (``protocol_step_probe``), each kernel against its plain twin at
    the batched shapes, and a 1-seed protocol against the Trainer.
    Returns (launches, numbers, the batched shapes' kernel checks)."""
    from dbw_torch import kernels
    from dbw_torch.train.trainer import Trainer
    from dbw_torch.utils.config import load_yaml

    cfg = load_yaml(CONFIG)
    cfg["training"].update(copy.deepcopy(PROTOCOL_OVERRIDES))
    S = len(PROTOCOL_SEEDS)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a, loss_a, wall_a, loop_launches = protocol_run(cfg, Path(tmp) / "a", device)
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        a.evaluate(quali_kwargs=copy.deepcopy(PROTOCOL_OVERRIDES["eval"]))
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        run_launches = dict(kernels.LAUNCHES)
        n_iter = a.n_epoches * a.n_batches
        seed_steps = S * n_iter / wall_a
        n_val = len(read_losses(Path(tmp) / "a" / f"seed{PROTOCOL_SEEDS[0]}"
                                / "val_metrics.tsv")["iteration"])
        per_val = {k: a.val_counts.get(k, 0) / max(n_val, 1) for k in SOURCES}
        per_iter = per_iteration(a, loop_launches, n_iter)
        say("protocol", f"run A: {n_iter} iterations of {S} seeds in {wall_a:.2f} s: "
            f"{seed_steps:.3f} seed-steps/s over the loop (interval work included) "
            f"against phase 8's {trainer_steps_per_s:.3f} single-seed steps/s in this "
            f"call ({seed_steps / trainer_steps_per_s:.3f}x); peak memory {peak:.2f} GiB; "
            f"final eval {eval_s:.2f} s")
        say("protocol", f"launches, loop {loop_launches}; per iteration {per_iter}; per "
            f"val interval ({n_val}) {per_val}; loop and final eval {run_launches}")
        sel = (Path(tmp) / "a" / "seed_selection.tsv").read_text()
        print(sel, end="", flush=True)
        scores_txt = (Path(tmp) / "a" / "final_scores.tsv").read_text().splitlines()
        scores = [float(v) for v in scores_txt[1].split("\t")]
        missing = check_protocol_dir(Path(tmp) / "a", PROTOCOL_SEEDS, a.model.n_blocks)
        tsv = read_losses(Path(tmp) / "a" / "train_metrics.tsv")
        say("protocol", f"train_metrics.tsv columns {list(tsv)}, iterations "
            f"{[int(i) for i in tsv['iteration']]}; missing files {missing}")
        del a
        _, loss_b, wall_b, _ = protocol_run(cfg, Path(tmp) / "b", device)
        _, loss_d, _, _ = protocol_run(cfg, Path(tmp) / "d", device)
        c, loss_c, wall_c, _ = protocol_run(cfg, Path(tmp) / "c", device,
                                            kill_after_save=True)
        resumed_iters = len(read_losses(Path(tmp) / "c" / "train_metrics.tsv")["iteration"])
        del c
        runs = (loss_a, loss_b, loss_d)
        spread = np.max([np.abs(x - y) for i, x in enumerate(runs) for y in runs[i + 1:]],
                        axis=0)
        tol = np.maximum(PROTOCOL_SPREAD_FACTOR * spread.max(),
                         PROTOCOL_RTOL_FLOOR * np.abs(loss_a))
        gap = np.abs(loss_c - loss_a)
        say("protocol", f"final per-seed losses A {loss_a.tolist()}, B {loss_b.tolist()}, "
            f"D {loss_d.tolist()}, resumed C {loss_c.tolist()}; the largest gap of two "
            f"of A, B, D {spread.tolist()}, |C - A| {gap.tolist()}, tolerance "
            f"{tol.tolist()}; loops {wall_b:.2f} s (B), {wall_c:.2f} s (C after the "
            "resume)")
        torch.cuda.empty_cache()

        # run M: the map executor, the slots one after the other
        with seed_exec("map"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            m, loss_m, wall_m, launches_m = protocol_run(cfg, Path(tmp) / "m", device)
            peak_m = torch.cuda.max_memory_allocated() / 2**30
        per_iter_m = per_iteration(m, launches_m, n_iter)
        seed_steps_m = S * n_iter / wall_m
        gap_m = np.abs(loss_m - loss_a)
        del m
        torch.cuda.empty_cache()
        want = {k: step_launches[k] for k in SOURCES}
        batched_ok = per_iter == want
        map_ok = per_iter_m == {k: S * v for k, v in want.items()}
        say("protocol", f"run M (DBW_SEED_EXEC=map): {n_iter} iterations of {S} seeds in "
            f"{wall_m:.2f} s: {seed_steps_m:.3f} seed-steps/s against the batched run A's "
            f"{seed_steps:.3f} ({seed_steps / seed_steps_m:.3f}x) and phase 8's "
            f"{trainer_steps_per_s:.3f} steps/s; peak memory {peak_m:.2f} GiB (A: "
            f"{peak:.2f}); final losses {loss_m.tolist()}, |M - A| {gap_m.tolist()} "
            f"(tolerance {tol.tolist()})")
        say("protocol", f"launches per iteration: batched (A) {per_iter}, map (M) "
            f"{per_iter_m}; the main path's per step {want}: A launches each kernel as "
            f"often as one step {batched_ok}, M {S} times that {map_ok}")
        cfg_step = load_yaml(CONFIG)
        probe_b = protocol_step_probe(cfg_step, device, "vmap")
        probe_m = protocol_step_probe(cfg_step, device, "map")
        batched_checks = check_batched_kernels(cfg_step, device)

        slot_cfg = load_yaml(CONFIG)
        slot_cfg["training"].update(copy.deepcopy(SLOT_OVERRIDES))
        slot_cfg["training"]["seed"] = PROTOCOL_SEEDS[0]
        from dbw_torch.train.multi_seed import MultiSeedTrainer

        one = MultiSeedTrainer(copy.deepcopy(slot_cfg), Path(tmp) / "one",
                               PROTOCOL_SEEDS[:1], device=device)
        one.viz = False
        la = record_step_losses(one, lambda t: t._loss_buffer[-1][0][0])
        one.run()
        tr = Trainer(copy.deepcopy(slot_cfg), Path(tmp) / "trainer", device=device,
                     seed=PROTOCOL_SEEDS[0])
        tr.log_visualizations = lambda it: None
        tr.save_metric_plots = lambda: None
        tr.evaluate = lambda: None
        total = tr._loss_keys.index("total")
        lb = record_step_losses(tr, lambda t: t._loss_buffer[-1][0][total])
        tr.run(seed=PROTOCOL_SEEDS[0])
        n = N_SLOT_STEPS
        la, lb = np.array([float(v) for v in la[:n]]), np.array([float(v) for v in lb[:n]])
        slot_tol = np.maximum(PROTOCOL_SPREAD_FACTOR * spread.max(), PROTOCOL_RTOL_FLOOR * lb)
        pgap = max(float((one.params[k][0] - p).detach().abs().max())
                   for k, p in tr.params.items())
        say("protocol", f"1-seed protocol against the Trainer (seed {PROTOCOL_SEEDS[0]}), "
            f"the losses of steps 1-{n}: largest |d| {np.abs(la - lb).max():.3e}, largest "
            f"|d| / tolerance {(np.abs(la - lb) / slot_tol).max():.3f}; largest parameter "
            f"gap after {one.n_batches} steps {pgap:.3e}")
    not_launched = [k for k in SOURCES if not run_launches[k]]
    probes_ok = all(st == {k: n * want[k] for k in STEP_KERNELS}
                    for pr, n in ((probe_b, 1), (probe_m, S)) for st in pr["per_step"])
    ok = (np.isfinite(loss_a).all() and np.isfinite(loss_c).all()
          and np.isfinite(scores).all() and not missing and resumed_iters == len(tsv["iteration"])
          and (gap <= tol).all() and len(la) == len(lb) == N_SLOT_STEPS
          and (np.abs(la - lb) <= slot_tol).all() and np.isfinite(loss_m).all()
          and (gap_m <= tol).all() and batched_ok and map_ok and probes_ok)
    if not ok or not_launched:
        raise SystemExit(f"protocol phase failed (kernels not launched: {not_launched}; "
                         f"batched launches {batched_ok}, map launches {map_ok}, the step "
                         f"alone {probes_ok})")
    numbers = dict(seed_steps_per_s=seed_steps, trainer_steps_per_s=trainer_steps_per_s,
                   loop_s=wall_a, eval_s=eval_s, peak_gib=peak, seeds=S,
                   iterations=n_iter, final_losses=loss_a.tolist(),
                   spread=spread.tolist(), resume_gap=gap.tolist(),
                   slot_vs_trainer_max=float(np.abs(la - lb).max()),
                   map=dict(seed_steps_per_s=seed_steps_m, loop_s=wall_m, peak_gib=peak_m,
                            final_losses=loss_m.tolist(), gap_to_batched=gap_m.tolist(),
                            launches_per_iteration=per_iter_m),
                   step_alone={pr["mode"]: {k: v for k, v in pr.items() if k != "mode"}
                               for pr in (probe_b, probe_m)})
    launches = {"run": run_launches, "per_iteration": per_iter, "per_val_interval": per_val,
                "map_per_iteration": per_iter_m}
    return launches, numbers, batched_checks


def mesh_inputs(device):
    """The mesh phase's B views: seeded images and the flagship cameras."""
    imgs = torch.from_numpy(np.random.default_rng(7).random(
        (N_VIEWS,) + IMG_SIZE + (3,), np.float32)).to(device)
    return (imgs,) + cameras(N_VIEWS, device)


def timed_ms(fn, reps=N_COLLECTIVE_REPS):
    """ms of one fn() call: after a warm-up call and a barrier of every rank,
    the host clock around ``reps`` calls, synchronized."""
    import torch.distributed as dist

    fn()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def collective_ms(mesh, params, band_shape):
    """The step's collectives on this rank, timed alone at the step's sizes:
    the all_reduce of every gradient (one buffer, averaged over the seed
    column) and, on an sp axis, the band gather with its transpose."""
    from dbw_torch.parallel.seeds import band_gather

    n = sum(p.numel() for p in params.values()) + 1
    buf = torch.zeros(n, device=next(iter(params.values())).device)
    out = {"allreduce_bytes": 4 * n, "allreduce_ranks": mesh.axis("reduce").size,
           "allreduce_ms": timed_ms(lambda: mesh.mean([buf]))}
    if mesh.shape.get("sp", 1) > 1:
        band = torch.zeros(band_shape, device=buf.device, requires_grad=True)
        axis = mesh.axis("sp")
        out["band_gather_ms"] = timed_ms(
            lambda: band_gather(band, axis, IMG_SIZE[0]).sum().backward())
        out["band_bytes"] = 4 * band.numel()
    return out


def device_breakdown(fn, n=N_PROFILE_STEPS):
    """n calls of fn() under torch.profiler: the device's idle share (1 -
    the union of its kernel and copy intervals over the span from the first
    one's start to the last one's end), its busy ms a call, and each
    KERNEL_FAMILIES family's share of the summed device time (None: no
    device record)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = device_events(prof)
    if not dev:
        return None
    busy, span = device_busy(dev)
    per_name = {}
    for e in dev:
        per_name[e.name] = per_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return dict(idle_share=1.0 - busy / span, busy_ms=busy / 1e3 / n,
                shares=family_shares(per_name))


def device_idle_share(fn, n=N_PROFILE_STEPS):
    """The device's idle share over n calls of fn() (``device_breakdown``;
    None: no device record)."""
    out = device_breakdown(fn, n)
    return None if out is None else out["idle_share"]


@contextlib.contextmanager
def raster_rows():
    """The (row0, rows) of every face selection (K1) the renderer makes
    inside the block: row0 from its ``row_range``, rows from its
    pix_to_face."""
    from dbw_torch.render import renderer

    seen, inner = set(), renderer.rasterize

    def record(*args, row_range=None, **kw):
        p2f = inner(*args, row_range=row_range, **kw)
        seen.add((0 if row_range is None else int(row_range[0]), int(p2f.shape[1])))
        return p2f

    renderer.rasterize = record
    try:
        yield seen
    finally:
        renderer.rasterize = inner


def mesh_steps(cfg, device, layout=None, idle=False, n_steps=MESH_STEPS):
    """``n_steps`` Adam steps of MESH_SEED on the main path's inputs through
    MultiSeedRunner on the ``layout`` mesh of the process group (None: a
    mesh of one rank, the one-card step). -> dict of the (n_steps,) losses,
    the parameters (on the CPU), the launches of each step, the (row0,
    rows) of this rank's face selections (``rows``), the steps/s of steps
    2 on, the collectives' ms and, with
    ``idle``, the device's idle share over 3 more steps."""
    from dbw_torch import kernels
    from dbw_torch.parallel.mesh import make_mesh
    from dbw_torch.parallel.seeds import MultiSeedRunner, stacked_leaves
    from dbw_torch.train.optimizer import create_optimizer
    from dbw_torch.train.trainer import step_seed

    model = make_model(cfg, device)
    mesh = make_mesh(**layout) if layout else make_mesh(1, 1, world_size=1)
    params = stacked_leaves([model.init_params(seed=MESH_SEED)])
    opt = create_optimizer(cfg, params)
    runner = MultiSeedRunner(model, opt, mesh)
    v = mesh.data_slice(N_VIEWS)
    imgs, R, T = (x[v] for x in mesh_inputs(device))
    phase = model.phase_for_epoch(0, training=True)

    def step(k):
        gens = [torch.Generator(device=device).manual_seed(step_seed(MESH_SEED, k))]
        return runner.step(params, phase, imgs, R, T, gens)

    losses, per_step = [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with raster_rows() as rows:
        for k in range(n_steps):
            if k == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            before = dict(kernels.LAUNCHES)
            losses.append(step(k))
            per_step.append({n: kernels.LAUNCHES[n] - before[n] for n in STEP_KERNELS})
        torch.cuda.synchronize()
    H, W = IMG_SIZE
    Hb = -(-H // mesh.shape.get("sp", 1))
    out = dict(losses=torch.cat(losses).cpu(), per_step=per_step,
               launches=dict(kernels.LAUNCHES),
               steps_per_s=(n_steps - 1) / (time.perf_counter() - t0),
               params={k: p.detach().cpu() for k, p in params.items()}, rows=sorted(rows))
    if mesh.world_size > 1:
        out.update(collective_ms(mesh, params, (len(imgs), Hb, W, 3)))
    if idle:
        out["idle_share"] = device_idle_share(lambda: step(n_steps))
    return out


def mesh_spread(refs):
    """Tolerances from two one-card runs of mesh_steps: the losses' (4x
    their gap, floored at 2e-5 relative) and the parameters' (4x their
    largest gap, floored at MESH_PARAM_ATOL)."""
    a, b = refs
    gap_l = float((a["losses"] - b["losses"]).abs().max())
    gap_p = max(float((a["params"][k] - b["params"][k]).abs().max()) for k in a["params"])
    tol_l = np.maximum(PROTOCOL_SPREAD_FACTOR * gap_l,
                       PROTOCOL_RTOL_FLOOR * a["losses"].abs().numpy())
    return gap_l, gap_p, tol_l, max(PROTOCOL_SPREAD_FACTOR * gap_p, MESH_PARAM_ATOL)


def mesh_gaps(out, ref):
    """A layout's largest loss gap (each step) and parameter gap to the
    one-card run."""
    gap_l = (out["losses"] - ref["losses"]).abs().numpy()
    gap_p = max(float((out["params"][k] - ref["params"][k]).abs().max())
                for k in ref["params"])
    return gap_l, gap_p


def own_rows(out, layout, rank):
    """Whether every face selection of rank ``rank``'s mesh_steps on the
    ``layout`` covered its own rows and only those: on an sp axis of n_sp
    ranks the band (k Hb, Hb), Hb = ceil(H / n_sp), at k = rank % n_sp
    (sp is the innermost axis); the whole image without one."""
    H, n_sp = IMG_SIZE[0], layout.get("n_spatial", 1)
    Hb = -(-H // n_sp)
    return out["rows"] == [(rank % n_sp * Hb, Hb)]


def mesh_rank(rank, tmp, device, setup=None):
    """Rank ``rank`` of the mesh phase (a spawned process): joins the group
    of MESH_RANKS ranks on card 0, runs each MESH_LAYOUTS layout's steps
    and the protocol on its default layout, uninterrupted (run M) and
    killed after its save and resumed (run K); saves its results in
    ``tmp``. ``setup``: called first (the CPU rehearsal's swaps)."""
    import torch.distributed as dist

    from dbw_torch.parallel.mesh import close_distributed, init_distributed
    from dbw_torch.utils.config import load_yaml

    if setup is not None:
        setup()
    device = init_distributed(device, cards=1, init_method=f"file://{tmp}/store", rank=rank,
                              world_size=MESH_RANKS)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out = {"backend": dist.get_backend(), "device": str(device)}
        cfg = load_yaml(CONFIG)
        for name, layout in MESH_LAYOUTS.items():
            out[name] = mesh_steps(cfg, device, layout)
        pcfg = load_yaml(CONFIG)
        pcfg["training"].update(copy.deepcopy(PROTOCOL_OVERRIDES))
        m, loss_m, wall_m, launches_m = protocol_run(pcfg, Path(tmp) / "m", device)
        _, loss_k, _, _ = protocol_run(pcfg, Path(tmp) / "k", device, kill_after_save=True)
        n_iter = m.n_epoches * m.n_batches
        out["protocol"] = dict(losses_m=loss_m, losses_k=loss_k, wall_s=wall_m,
                               launches=launches_m, slots=len(m.seeds), n_valid=m.n_valid,
                               mesh=dict(m.mesh.shape), iterations=n_iter,
                               per_iteration=per_iteration(m, launches_m, n_iter))
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        close_distributed()


def run_ranks(target, args, n, timeout):
    """target(rank, *args) in ``n`` spawned processes; every one of them is
    stopped on return. -> their exit codes (None: killed at the timeout)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r,) + tuple(args)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [p.exitcode for p in procs]


def phase_device_mesh(cfg, device, protocol_numbers, step_launches, setup=None):
    """The device mesh on one card: MESH_RANKS ranks under gloo. Each
    MESH_LAYOUTS layout's losses and parameters against two one-card runs
    of the same steps (their spread sets the tolerance), every kernel
    launched in every step on every rank, each rank's K1 selections on its
    own rows only (``own_rows``); the 5-seed protocol's valid slots (runs M and K) against phase
    11's run A within phase 11's tolerance, each rank's 3 slots batched: its
    loop launches each kernel as often a iteration as the main path does a
    step (``step_launches``). Returns (launches per layout and rank,
    numbers)."""
    refs = [mesh_steps(cfg, device) for _ in range(2)]
    gap_l, gap_p, tol_l, tol_p = mesh_spread(refs)
    say("device mesh", f"one card, {MESH_STEPS} steps of seed {MESH_SEED} twice: "
        f"{refs[0]['steps_per_s']:.3f} steps/s; the two runs' largest loss gap "
        f"{gap_l:.3e}, parameter gap {gap_p:.3e}; tolerances: losses {tol_l.max():.3e}, "
        f"parameters {tol_p:.3e}")
    torch.cuda.empty_cache()
    loss_a = np.asarray(protocol_numbers["final_losses"])
    tol_a = np.maximum(PROTOCOL_SPREAD_FACTOR * max(protocol_numbers["spread"]),
                       PROTOCOL_RTOL_FLOOR * np.abs(loss_a))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        codes = run_ranks(mesh_rank, (tmp, device.type, setup), MESH_RANKS, MESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        say("device mesh", f"{MESH_RANKS} ranks exited with {codes} after {wall:.1f} s")
        if codes != [0] * MESH_RANKS:
            raise SystemExit(f"device mesh phase failed: rank exit codes {codes}")
        outs = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(MESH_RANKS)]
    ok = all(o["backend"] == "gloo" for o in outs) and all(own_rows(x, {}, 0) for x in refs)
    launches, numbers = {}, {"ranks": MESH_RANKS, "backend": outs[0]["backend"],
                             "one_card_steps_per_s": refs[0]["steps_per_s"],
                             "loss_tolerance": float(tol_l.max()), "param_tolerance": tol_p}
    for name in MESH_LAYOUTS:
        launches[name] = [o[name]["launches"] for o in outs]
        rows = []
        for r, o in enumerate(outs):
            lg, pg = mesh_gaps(o[name], refs[0])
            every = all(all(v > 0 for v in st.values()) for st in o[name]["per_step"])
            own_band = own_rows(o[name], MESH_LAYOUTS[name], r)
            ok &= bool((lg <= tol_l).all()) and pg <= tol_p and every and own_band
            rows.append(dict(steps_per_s=o[name]["steps_per_s"],
                             allreduce_ms=o[name]["allreduce_ms"],
                             allreduce_bytes=o[name]["allreduce_bytes"],
                             band_gather_ms=o[name].get("band_gather_ms"),
                             loss_gap=float(lg.max()), param_gap=pg,
                             every_kernel_every_step=every, k1_rows=o[name]["rows"],
                             own_band=own_band))
            say("device mesh", f"{name}, rank {r} ({o['device']}, {o['backend']}): "
                f"{o[name]['steps_per_s']:.3f} steps/s; losses {o[name]['losses'].tolist()}, "
                f"largest gap to one card {lg.max():.3e}, parameters {pg:.3e}; every "
                f"kernel in every step {every}; K1's (row0, rows) {o[name]['rows']}, its own "
                f"band {own_band}; launches {o[name]['launches']}; "
                f"all_reduce {o[name]['allreduce_ms']:.3f} ms for "
                f"{o[name]['allreduce_bytes']} B; band gather "
                f"{o[name].get('band_gather_ms')} ms")
        numbers[name] = rows
    prot = [o["protocol"] for o in outs]
    pm = prot[0]
    gaps_m = [float(np.abs(np.asarray(q["losses_m"]) - loss_a).max()) for q in prot]
    gaps_k = [float(np.abs(np.asarray(q["losses_k"]) - loss_a).max()) for q in prot]
    ok &= all((np.abs(np.asarray(q["losses_m"]) - loss_a) <= tol_a).all()
              and (np.abs(np.asarray(q["losses_k"]) - loss_a) <= tol_a).all() for q in prot)
    ok &= pm["mesh"] == {"seed": 2, "data": 1} and pm["slots"] == 6
    want = {k: step_launches[k] for k in SOURCES}
    batched = [q["per_iteration"] == want for q in prot]
    ok &= all(batched)
    seed_steps = pm["n_valid"] * pm["iterations"] / pm["wall_s"]
    launches["protocol"] = [q["launches"] for q in prot]
    say("device mesh", f"protocol on {pm['mesh']}: {pm['n_valid']} seeds in {pm['slots']} slots, "
        f"{pm['iterations']} iterations in {pm['wall_s']:.2f} s on rank 0: {seed_steps:.3f} "
        f"seed-steps/s against phase 11's {protocol_numbers['seed_steps_per_s']:.3f}; "
        f"final losses M {pm['losses_m'].tolist()}, resumed K {pm['losses_k'].tolist()}; "
        f"largest gap to phase 11's run A, M {max(gaps_m):.3e}, K {max(gaps_k):.3e} "
        f"(tolerance {tol_a.max():.3e}); launches per iteration on each rank "
        f"{[q['per_iteration'] for q in prot]}, one step's {batched}")
    numbers["protocol"] = dict(seed_steps_per_s=seed_steps, loop_s=pm["wall_s"],
                               slots=pm["slots"], seeds=pm["n_valid"],
                               final_losses=pm["losses_m"].tolist(),
                               resumed_losses=pm["losses_k"].tolist(),
                               gap_m=max(gaps_m), gap_k=max(gaps_k),
                               launches_per_iteration=[q["per_iteration"] for q in prot])
    if not ok:
        raise SystemExit("device mesh phase failed")
    return launches, numbers


def phase_scenes(device, step_launches):
    """MultiSceneTrainer on two synthetic scenes of the shipped config at
    full width, 1 seed each, 2 epochs, evaluate(quali=False); its loop runs
    both scenes as one batched (scene, seed) step, so it must launch each
    kernel as often a iteration as the main path does a step
    (``step_launches``). Returns its numbers."""
    from dbw_torch import kernels
    from dbw_torch.train.multi_scene import MultiSceneTrainer
    from dbw_torch.utils.config import load_yaml

    cfgs = []
    for k, ds_seed in enumerate(SCENE_DATASET_SEEDS):
        cfg = load_yaml(CONFIG)
        cfg["training"].update(copy.deepcopy(SCENES_OVERRIDES))
        cfg["training"]["seed"] += k
        cfg["dataset"].update(seed=ds_seed, tag=f"scene{ds_seed}")
        cfgs.append(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [Path(tmp) / f"scene{s}" for s in SCENE_DATASET_SEEDS]
        tr = MultiSceneTrainer(copy.deepcopy(cfgs), dirs, n_seeds=1, device=device)
        tr.val_counts = {}
        tr._val_and_log = launch_diff(tr._val_and_log, tr.val_counts)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        _, _, losses = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loop_launches = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        tr.evaluate(quali=False)
        eval_s = time.perf_counter() - t0
        n_iter = tr.n_epoches * tr.n_batches
        want = ["train_metrics.tsv", "val_metrics.tsv", "model.pkl", "final_scores.tsv"]
        missing = [f"{d.name}/{w}" for d in dirs for w in want if not (d / w).exists()]
        missing += [f"{d.name}/quali_eval" for d in dirs if (d / "quali_eval").exists()]
        if not (dirs[0] / "multi_scene_model.pkl").exists():
            missing.append("multi_scene_model.pkl")
        logs = [read_losses(d / "train_metrics.tsv") for d in dirs]
        cols = [np.asarray(lg[f"loss_s{c['training']['seed']}"]) for lg, c in zip(logs, cfgs)]
        seed_steps = len(dirs) * n_iter / wall
        per_iter = per_iteration(tr, loop_launches, n_iter)
        one_step = per_iter == {k: step_launches[k] for k in SOURCES}
        say("scenes", f"{len(dirs)} scenes x 1 seed, {n_iter} iterations in {wall:.2f} s: "
            f"{seed_steps:.3f} seed-steps/s; final losses {losses.ravel().tolist()}; "
            f"logged losses {[c.tolist() for c in cols]}; evaluate(quali=False) "
            f"{eval_s:.2f} s; n_seen {tr.n_seen.tolist()}; missing files {missing}; "
            f"launches per iteration {per_iter}, one step's {one_step}")
    ok = (np.isfinite(losses).all() and all(np.isfinite(c).all() for c in cols)
          and not np.array_equal(cols[0], cols[1]) and losses[0, 0] != losses[1, 0]
          and not missing and one_step)
    if not ok:
        raise SystemExit("scenes phase failed")
    return dict(seed_steps_per_s=seed_steps, loop_s=wall, eval_s=eval_s,
                iterations=n_iter, final_losses=losses.ravel().tolist(),
                launches_per_iteration=per_iter)


def check_lit_pass(checks, path, rend, scene, R, T, gen, sigma=None):
    """K1 (soft, or hard for the env renderer), K8 and K4 against their
    plain twins on the fragments of a lit renderer's pass, formed as
    Renderer.shade_lit forms them (the valid fragments' flat attributes, the
    uv interpolated from the corner table, the texel coordinates). The plain
    K1 twin is timed over fewer calls (it takes ~0.1 s a call)."""
    from dbw_torch.render import rasterize as rz
    from dbw_torch.render.fragment import texel_coords
    from dbw_torch.render.interpolate import interp_corner_table, interpolate_fragments_flat

    hard = sigma is None and float(rend.config.sigma) == 0.0
    _, blur = rend.sigma_blur(sigma)
    geom = rz.project_faces(scene.verts, scene.faces, R, T, rend.camera,
                            z_clip=rend.config.z_clip)
    packed = rz.pack_faces(geom)
    rcfg = rend.config.raster_config()
    rcfg_plain = rcfg._replace(row_chunk=50)
    K = rcfg.faces_per_pixel
    name = "K1_select_hard" if hard else "K1_select"
    p2f = rz.rasterize_cuda(packed, blur, rcfg, hard=hard)
    ref = rz.rasterize_plain(packed, blur, rcfg_plain)
    dz, ok = check_selection(f"K1 select{' hard' if hard else ''} [{path}, "
                             f"F={packed.shape[1]}, K={K}]", p2f, ref, packed, blur, rcfg)
    checks.setdefault(name, []).append(dict(
        path=path, max_abs_err=dz, ok=ok,
        ms=cuda_ms(lambda: rz.rasterize_cuda(packed, blur, rcfg, hard=hard)),
        plain_ms=cuda_ms(lambda: rz.rasterize_plain(packed, blur, rcfg_plain),
                         runs=2, pairs=3),
        library_ms=None, device_ms=None, **k1_bound(packed, p2f, blur, rcfg)))

    # the valid fragments only, in the K = 1 layout, as shade_lit shades them
    sel = torch.nonzero(p2f.reshape(-1) >= 0).squeeze(1)
    ff = interpolate_fragments_flat(p2f, geom, rcfg, detach_bary=True, select=sel)
    F = scene.faces.shape[0]
    uv = interp_corner_table(ff, scene.uv_verts[scene.uv_faces].reshape(F, 6))
    M, TH, TW = scene.atlas.maps.shape[:3]
    id00, wx, wy = texel_coords(uv[:, 0], uv[:, 1], scene.map_idx[ff.idx], TH, TW)
    check_quad_sample(checks, path, scene.atlas.maps.reshape(-1, 3), id00.contiguous(),
                      wx.contiguous(), wy.contiguous(), TW)
    g = torch.randn((id00.numel(), 3), generator=gen, device=id00.device)
    check_texel_grad(checks, path, id00.contiguous(), wx.contiguous(), wy.contiguous(), g,
                     M * TH * TW, TW, 1)


def resume_step_check(cfg, device, name):
    """2 steps with optimizer ``name``, a model.pkl round trip into fresh
    parameters and optimizer, then the next step from both (the same
    gradient): the state equal after the reload, the parameters equal
    after the step."""
    from dbw_torch.train import checkpoint as ck
    from dbw_torch.train.optimizer import create_optimizer

    ocfg = copy.deepcopy(cfg)
    ocfg["training"]["optimizer"]["name"] = name
    model = make_model(cfg, device)
    params = model.init_params(seed=0)
    opt = create_optimizer(ocfg, params)
    run_steps(f"lit resume {name}", model, params, opt, 2, STEP_KERNELS, device)
    with tempfile.TemporaryDirectory() as tmp:
        path = ck.save_checkpoint(Path(tmp) / "model.pkl", params, opt, 1, 2,
                                  model_kwargs=cfg["model"])
        state = ck.load_checkpoint(path)
    params2 = model.init_params(seed=1)
    opt2 = create_optimizer(ocfg, params2)
    ck.restore(state, params2, opt2)
    same_state = all(torch.equal(params[k], params2[k]) for k in params) and all(
        (torch.equal(v, opt2.state[params2[k]][f]) if torch.is_tensor(v)
         else v == opt2.state[params2[k]][f])
        for k in params for f, v in opt.state[params[k]].items())
    imgs = torch.from_numpy(np.random.default_rng(5).random(
        (N_VIEWS,) + IMG_SIZE + (3,), np.float32)).to(device)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(5)
    opt.zero_grad(set_to_none=True)
    model.forward(params, model.phase_for_epoch(0), imgs, R, T, generator=gen)["total"].backward()
    for k in params:
        params2[k].grad = params[k].grad.clone()
    opt.step()
    opt2.step()
    same_params = all(torch.equal(params[k], params2[k]) for k in params)
    say("lit", f"model.pkl round trip with {name} ({type(opt).__name__}, state fields "
        f"{sorted(opt.state[params['T']])}): state equal {same_state}; the next step's "
        f"parameters equal {same_params}")
    if not (same_state and same_params):
        raise SystemExit(f"lit: the {name} checkpoint does not reproduce the step")


def phase_lit(cfg, device):
    """The lit config surface at full width: each lit (shading, light) case
    with the fov camera for N_LIT_STEPS steps, K1 and K4 held at the lit
    path's shapes, the six other optimizers, the RGB criteria and a
    non-Adam resume. Returns (the lit steps' launches summed, their step
    count, the lit checks, the phase's numbers)."""
    from dbw_torch.train.optimizer import create_optimizer

    t_phase = time.perf_counter()
    launches = {k: 0 for k in SOURCES}
    checks, numbers = {}, {"step_ms": {}}
    for shading, light in LIT_CASES:
        model = make_model(cfg, device, renderer=dict(
            shading_type=shading, lights=copy.deepcopy(LIT_LIGHTS[light]),
            cameras=dict(name="fov")))
        rc = model.renderer.config
        say("lit", f"{shading} shading, {light} light ({rc.light_type}, ambient "
            f"{rc.ambient_color}, diffuse {rc.diffuse_color}), camera {model.camera} (fov "
            f"60, the dataset K ignored); env and viz renderers {model.renderer_env.config.shading}"
            f"/{model.renderer_viz.config.shading}")
        params = model.init_params(seed=0)
        opt = create_optimizer(cfg, params)
        got, times = run_steps(f"lit {shading}", model, params, opt, N_LIT_STEPS,
                               LIT_KERNELS, device)
        numbers["step_ms"][shading] = 1e3 * float(np.median(times[1:]))
        for k in launches:
            launches[k] += got[k]
        if shading == "phong":
            say("lit", "the phong lit step under torch.profiler ([profile] lines):")
            profile_steps(model, params, opt, device)
            gen = torch.Generator(device=device).manual_seed(13)
            R, T = cameras(N_VIEWS, device)
            phase = model.phase_for_epoch(0)
            with torch.no_grad():
                noise = torch.randn((model.n_blocks,), generator=gen, device=device)
                blocks, _ = model.build_blocks(params, phase, noise=noise)
                check_lit_pass(checks, "lit blocks pass", model.renderer, blocks, R, T, gen,
                               sigma=phase.sigma)
                env, _ = model.build_env(params, phase)
                check_lit_pass(checks, "lit env pass", model.renderer_env, env, R, T, gen)
        del model, params, opt
    for name, cs in checks.items():
        for c in cs:
            lib = "" if c["library_ms"] is None else f", index_add_ {c['library_ms']:.4f} ms"
            say("lit", f"{name} [{c['path']}]: kernel {c['ms']:.4f} ms, plain "
                f"{c['plain_ms']:.4f} ms{lib}; bound {c['bound_ms']:.4f} ms by "
                f"{c['bound_by']} {c['bound_counts']}, {c['bound_ms'] / c['ms']:.3f} of it")
    bad = [f"{n} [{c['path']}]" for n, cs in checks.items() for c in cs if not c.pop("ok")]
    if bad:
        raise SystemExit(f"lit: kernel check failed: {bad}")
    say("lit", f"lit steps' launches ({len(LIT_CASES) * N_LIT_STEPS} steps): {launches}")

    model = make_model(cfg, device)
    for name in OTHER_OPTIMIZERS:
        ocfg = copy.deepcopy(cfg)
        ocfg["training"]["optimizer"]["name"] = name
        params = model.init_params(seed=0)
        opt = create_optimizer(ocfg, params)
        say("lit", f"optimizer {name}: {type(opt).__name__}")
        run_steps(f"lit optimizer {name}", model, params, opt, N_LIT_STEPS, STEP_KERNELS,
                  device)
    del model
    for name in CRITERIA:
        model = make_model(cfg, device, loss=dict(name=name))
        params = model.init_params(seed=0)
        say("lit", f"criterion {name}")
        run_steps(f"lit criterion {name}", model, params, create_optimizer(cfg, params),
                  N_CRITERION_STEPS, STEP_KERNELS, device)
        del model, params
    resume_step_check(cfg, device, RESUME_OPTIMIZER)
    numbers["phase_s"] = time.perf_counter() - t_phase
    return launches, len(LIT_CASES) * N_LIT_STEPS, checks, numbers


def phase_nerfstudio(device):
    """The Trainer on configs/nerfstudio/campanile.yml at full width on a
    written capture, NS_OVERRIDES and dataset.root only, through the final
    eval. The launch counts are set to 0 just before Trainer.run and read
    just after. Returns (launches, the phase's numbers)."""
    from dbw_torch import kernels
    from dbw_torch.data.scan_writer import write_nerfstudio_capture
    from dbw_torch.data.synthetic import make_synthetic_scene
    from dbw_torch.train.trainer import Trainer
    from dbw_torch.utils.config import load_yaml

    t_phase = time.perf_counter()
    cfg = load_yaml(NS_CONFIG)
    seed = cfg["training"]["seed"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ds, _, _ = make_synthetic_scene(NS_CAPTURE_SIZE, n_views=49, seed=3, device=device)
        cap = write_nerfstudio_capture(Path(tmp) / "ns", cfg["dataset"]["tag"], ds.imgs,
                                       ds.K[0], ds.R, ds.T, points=ds.pc_gt)
        say("nerfstudio", f"capture {cap.name} written in {time.perf_counter() - t0:.1f} s: "
            f"{len(ds)} PNGs of {NS_CAPTURE_SIZE}, transforms.json, point_cloud.ply of "
            f"{len(ds.pc_gt)} points")
        cfg["dataset"]["root"] = str(Path(tmp) / "ns")
        cfg["training"].update(copy.deepcopy(NS_OVERRIDES))
        run = Path(tmp) / "run"
        tr = Trainer(copy.deepcopy(cfg), run, device=device, seed=seed)
        say("nerfstudio", f"Trainer on {NS_CONFIG.relative_to(ROOT)}: dataset {tr.dataset.name} "
            f"{tr.dataset.tag} {tr.dataset.imgs.shape} (downscale_factor "
            f"{cfg['dataset']['downscale_factor']}), val views {len(tr.val_loader.dataset)}, "
            f"test views {len(tr.test_loader.dataset)}, camera {tr.model.camera}, "
            f"R_world {cfg['model']['mesh']['R_world']}; overrides {NS_OVERRIDES} and "
            "dataset.root")
        t_train = []
        plots = tr.save_metric_plots
        tr.save_metric_plots = lambda: (t_train.append(time.perf_counter()), plots())[1]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        tr.run(seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        n_steps = tr.n_epoches * tr.n_batches
        log = tr.train_metrics.read_log()
        vals = np.stack([v for k, v in log.items() if k.startswith("loss")])
        scores_txt = (run / "final_scores.tsv").read_text().splitlines()
        scores = dict(zip(scores_txt[0].split("	"), map(float, scores_txt[1].split("	"))))
        missing = check_run_dir(run, int(scores["n_blocks"]), tr.model.n_blocks)
        numbers = dict(steps_per_s=n_steps / (t_train[0] - t0), run_s=wall, steps=n_steps,
                       n_blocks_kept=int(scores["n_blocks"]),
                       loss_total=[float(log["loss_total"][0]), float(log["loss_total"][-1])])
        say("nerfstudio", f"run in {wall:.1f} s: {n_steps} steps in {t_train[0] - t0:.1f} s "
            f"({numbers['steps_per_s']:.3f} steps/s over the training loop); loss_total "
            f"{numbers['loss_total']}; final_scores {scores}; missing artifacts {missing}; "
            f"launches {launches}")
        not_launched = [k for k in SOURCES if not launches[k]]
        ok = (tr.dataset.img_size == IMG_SIZE and len(tr.val_loader.dataset) == 0
              and np.isfinite(vals).all() and all(math.isfinite(v) for v in scores.values())
              and not missing)
        if not ok or not_launched:
            raise SystemExit(f"nerfstudio phase failed (kernels not launched: {not_launched})")
    numbers["phase_s"] = time.perf_counter() - t_phase
    return launches, numbers


def bench_line(n_blocks):
    """`python -m dbw_torch.bench` at ``n_blocks`` in its own process: its
    JSON line, printed on a line of its own; fails unless the run exits 0
    with finite numbers on the card and every kernel of the decoupled step
    launched BENCH_STEP_LAUNCHES times a step."""
    cmd = [sys.executable, "-m", "dbw_torch.bench", *BENCH_ARGS, "--blocks", str(n_blocks)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"bench: {' '.join(cmd[1:])} exited {proc.returncode}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(line), flush=True)
    extra = line["extra"]
    numbers = [line["value"]] + [v for v in extra.values()
                                 if isinstance(v, (int, float)) and not isinstance(v, bool)]
    launches = extra["launches_per_step"]
    wrong = {k: launches.get(k) for k, n in BENCH_STEP_LAUNCHES.items() if launches.get(k) != n}
    say("bench", f"{n_blocks} blocks: {line['value']} steps/s, vs_baseline "
        f"{line['vs_baseline']}, warmup {extra['warmup_calls']} calls (stable "
        f"{extra['warmup_stable']}, {extra['cold_start_s']} s), peak "
        f"{extra['peak_memory_gib']:.3f} GiB, launches per step {launches} "
        f"(process {time.perf_counter() - t0:.1f} s)")
    if (extra["backend"] != "cuda" or wrong
            or not all(math.isfinite(v) for v in numbers + list(launches.values()))):
        raise SystemExit(f"bench at {n_blocks} blocks: backend {extra['backend']}, "
                         f"launches off the step's {wrong}, or a number not finite")
    return line


def check_bench_kernels(n_blocks, device):
    """K1 (soft, exact), K2, K3 and K4 against their plain twins on the
    blocks pass of the bench model at ``n_blocks`` (the plain twins timed by
    one call). -> the checks."""
    from dbw_torch.bench import make_model as bench_model

    model = bench_model(n_blocks=n_blocks, device=device)
    params = model.init_params(seed=0)
    phase = model.phase_for_epoch(0)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(5)
    checks = {}
    with torch.no_grad():
        noise = torch.randn((model.n_blocks,), generator=gen, device=device)
        blocks, _ = model.build_blocks(params, phase, noise=noise)
        check_soft_pass(checks, f"blocks pass, {n_blocks} blocks", model, blocks, phase,
                        R, T, gen, plain_runs=1, exact_k1=True)
    del model, params, blocks
    torch.cuda.empty_cache()
    report_checks("bench", checks)
    return checks


def trace_shares(n_blocks, device):
    """The trace twin's top TRACE_TOP device ops of the bench step at
    ``n_blocks``, and the shares of device time of KERNEL_FAMILIES."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_trace_bench as trace

    say("trace", f"{n_blocks} blocks, {N_TRACE_STEPS} bench steps under torch.profiler:")
    ops = trace.op_times(trace.capture(N_TRACE_STEPS, n_blocks, device=device), True)
    trace.print_table(ops, N_TRACE_STEPS, TRACE_TOP, "device")
    total = sum(ms for ms, _ in ops.values())
    if not total:
        # a reading, not a check: see device_ms
        say("trace", "device time: not measured (the trace held no device record)")
        return None
    shares = family_shares({n: ms for n, (ms, _) in ops.items()})
    say("trace", f"{n_blocks} blocks: {total / N_TRACE_STEPS:.3f} ms of device time a "
        "step; shares: " + ", ".join(f"{fam} {v:.3f}" for fam, v in shares.items())
        + " (the scans were the blend's cumprod before K6, 0.300 of the shipped step's "
        "device time)")
    return dict(device_ms_per_step=total / N_TRACE_STEPS, **shares)


def phase_bench(device, run, trainer_scores):
    """The bench twin at 10 and 50 blocks in their own processes; the 50-block
    blocks pass's kernels against their plain twins; the trace twin at both
    widths; the requant twin on a copy of phase 8's run (its scores against
    the Trainer's, within REQUANT_RTOL); the viz probe on that run."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_requant_run
    import torch_viz_probe

    t0 = time.perf_counter()
    lines = {n: bench_line(n) for n in BENCH_BLOCKS}
    checks = check_bench_kernels(max(BENCH_BLOCKS), device)
    traces = {n: trace_shares(n, device) for n in BENCH_BLOCKS}

    old_tsv = (run / "final_scores.tsv").read_text()
    scores = torch_requant_run.main(["--run", str(run)])
    new_tsv = (run / "final_scores.tsv").read_text()
    note = (run / "final_scores.requant.txt").read_text()
    gaps = {k: abs(float(v) - trainer_scores[k]) / max(abs(trainer_scores[k]), 1e-30)
            for k, v in scores.items()}
    header_ok = new_tsv.splitlines()[0] == old_tsv.splitlines()[0]
    say("requant", f"scripts/torch_requant_run.py on phase 8's model.pkl: header equals "
        f"the Trainer's {header_ok}, TSV equal {new_tsv == old_tsv}; largest relative gap "
        f"to the Trainer's unrounded scores {max(gaps.values()):.3g} (tolerance "
        f"{REQUANT_RTOL:g}); provenance note written {old_tsv in note and new_tsv in note}")
    if not (header_ok and set(gaps) == set(trainer_scores)
            and max(gaps.values()) <= REQUANT_RTOL and old_tsv in note and new_tsv in note):
        raise SystemExit(f"requant: scores or note off: gaps {gaps}")

    say("viz", "scripts/torch_viz_probe.py on phase 8's run:")
    viz_ms, ckpt_bytes = torch_viz_probe.main(["--run", str(run)])
    if not all(math.isfinite(v) for v in viz_ms.values()):
        raise SystemExit(f"viz probe: a time not finite: {viz_ms}")
    numbers = dict(lines={str(n): line for n, line in lines.items()}, trace=traces,
                   requant_max_rel_gap=max(gaps.values()), viz_ms=viz_ms,
                   ckpt_snapshot_bytes=ckpt_bytes, phase_s=time.perf_counter() - t0)
    say("bench", f"phase in {numbers['phase_s']:.1f} s")
    return numbers, checks


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dbw_torch import kernels

    t_start = time.perf_counter()
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say("device", f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = kernels.build(verbose="-v" in sys.argv)
    kernels.library()
    say("build", f"{lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")

    cfg = load_cfg()
    model = make_model(cfg, device)
    results = phase_kernels(model, device)
    del model
    torch.cuda.empty_cache()
    launches, vgg = phase_main(cfg, device)
    per_step = {"blocks pass": {n: launches[n] / N_STEPS for n in SOURCES}}
    per_step["env pass"] = per_step["blocks pass"]
    joint = phase_joint(cfg, device)
    per_step["joint"] = {n: joint[n] / N_JOINT_STEPS for n in SOURCES}
    band = phase_band(cfg, device)
    per_step["band"] = band
    phase_train(cfg, device)
    phase_reference(cfg, device)
    keep = tempfile.TemporaryDirectory()
    trainer, viz_ss, eval_ss, numbers, mesh = phase_trainer(device, Path(keep.name))
    t0 = time.perf_counter()
    dtu, dtu_numbers = phase_dtu(device)
    say("dtu", f"phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_numbers = phase_mesh(mesh, device)
    say("mesh", f"phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    protocol, protocol_numbers, protocol_checks = phase_protocol(
        device, numbers["steps_per_s"], per_step["blocks pass"])
    protocol_numbers["phase_s"] = time.perf_counter() - t0
    say("protocol", f"phase in {protocol_numbers['phase_s']:.1f} s")
    t0 = time.perf_counter()
    scenes_numbers = phase_scenes(device, per_step["blocks pass"])
    scenes_numbers["phase_s"] = time.perf_counter() - t0
    say("scenes", f"phase in {scenes_numbers['phase_s']:.1f} s")
    lit, n_lit_steps, lit_checks, lit_numbers = phase_lit(cfg, device)
    say("lit", f"phase in {lit_numbers['phase_s']:.1f} s")
    ns, ns_numbers = phase_nerfstudio(device)
    say("nerfstudio", f"phase in {ns_numbers['phase_s']:.1f} s")
    t0 = time.perf_counter()
    dm_launches, dm_numbers = phase_device_mesh(cfg, device, protocol_numbers,
                                                per_step["blocks pass"])
    dm_numbers["phase_s"] = time.perf_counter() - t0
    say("device mesh", f"phase in {dm_numbers['phase_s']:.1f} s")
    with keep:
        bench, bench_checks = phase_bench(device, Path(keep.name), numbers["final_scores"])
    say("done", f"all phases in {time.perf_counter() - t_start:.1f} s")

    for n, cs in (list(lit_checks.items()) + list(protocol_checks.items())
                  + list(bench_checks.items())):
        results[n]["checks"] += cs
        results[n]["max_abs_err"] = max(c["max_abs_err"] for c in results[n]["checks"])
    per_step["lit blocks pass"] = per_step["lit env pass"] = {
        n: lit[n] / n_lit_steps for n in SOURCES}
    per_step["protocol blocks pass"] = per_step["protocol env pass"] = protocol["per_iteration"]
    bench_launches = {n: line["extra"]["launches_per_step"]
                      for n, line in bench["lines"].items()}
    for n in BENCH_BLOCKS:
        per_step[f"blocks pass, {n} blocks"] = bench_launches[str(n)]

    per_step["viz/eval scene"] = per_step["viz/eval blocks"] = {
        n: 0.0 for n in SOURCES}
    # K8's checks at the cells' shapes: the step launches K8 in both passes
    for cell in LPIPS_CELLS:
        per_step[f"{cell} blocks pass"] = per_step[f"{cell} env pass"] = per_step["blocks pass"]
    # K7's checks are a slice each: the step launches K7 once a slice
    for cell in LPIPS_CELLS:
        for k in range(len(LPIPS_SLICE_CHANNELS)):
            per_step[f"{cell} slice {k + 1}"] = {
                n: v / len(LPIPS_SLICE_CHANNELS) for n, v in per_step["blocks pass"].items()}
    for n, r in results.items():
        for c in r["checks"]:
            c["launches_per_step"] = per_step[c["path"]][n]
    # the main path's counts (the trainer phase's for the viz selection,
    # which the training step does not launch)
    main_launches = dict(launches, K1_select_hard_ss=trainer["K1_select_hard_ss"])
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n][0],
         "replaces": SOURCES[n][1], "launches": main_launches[n],
         "launches_per_step": launches[n] / N_STEPS, "band_launches": band[n],
         "trainer_launches": trainer[n], "dtu_trainer_launches": dtu[n],
         "protocol_launches": protocol["run"][n],
         "protocol_launches_per_iteration": protocol["per_iteration"][n],
         "protocol_map_launches_per_iteration": protocol["map_per_iteration"][n],
         "protocol_launches_per_val_interval": protocol["per_val_interval"][n],
         "scenes_launches_per_iteration": scenes_numbers["launches_per_iteration"][n],
         "lit_launches": lit[n], "nerfstudio_trainer_launches": ns[n],
         "bench_launches_per_step": {b: bl[n] for b, bl in bench_launches.items()},
         "mesh_launches": {path: [c[n] for c in per_rank]
                           for path, per_rank in dm_launches.items()},
         **results[n]}
        for n in SOURCES], "trainer": numbers, "dtu": dtu_numbers, "mesh": mesh_numbers,
        "vgg": vgg, "protocol": protocol_numbers, "scenes": scenes_numbers,
        "lit": lit_numbers, "nerfstudio": ns_numbers, "device_mesh": dm_numbers,
        "bench": bench}
    line["kernels"][list(SOURCES).index("K1_select_hard_ss")].update(
        launches_per_val_interval=viz_ss, launches_per_final_eval=eval_ss)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
