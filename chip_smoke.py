"""GPU smoke run of the PyTorch port: builds the five CUDA kernels (K2-K4 in
f32 and bf16), holds each against its plain PyTorch version at the serving,
training and HDR-Real shapes, serves a few requests through the port's HTTP
server, trains the joint configuration through the ``joint_train`` CLI,
trains on a data mesh (two ranks on the card; the CLIs at ``--mesh 1``),
infers and trains with image rows split over a spatial mesh (two and four
ranks on the card),
runs the HDR-Real path (record conversion, finetune, whole and tiled
inference, evaluation, HDR-Synth validation) through its CLIs, carries the
trained checkpoints through the reference TF2 format and back, trains
with rematerialised forwards, and drives the recipe tools (the quality
anchor through its stage processes, serve_load, measure_feed), all at the
full published widths, in f32 and in the JAX package's bf16 compute dtype,
and checks each path against the CPU plain path or the plain step.

  python3 chip_smoke.py          (from the root of a checkout, one CUDA card)

Phases (each prints its own lines; any failure exits non-zero):
  1 device   card name and power limit (nvidia-smi); TF32 off, true f32
  2 build    nvcc build of singlehdr_tpu_torch/csrc into build/kernels/ (one
             nvcc per source, in parallel); K2/K4's conv kernels and K3's
             kernel hold tensor-core instructions in their SASS: TF32 in the
             f32 instantiations, BF16 HGMMA (wgmma) and, for the 16-channel
             stems, BF16 HMMA (mma.sync) in the bf16 ones; K3 HGMMA in both;
             no bf16 conv instantiation spills (cuobjdump -res-usage)
  3 kernels  K1..K4 vs plain at batch 4, 576x576 (512 + the 32 px pad), K3 at
             an odd [1, 3, 37, 53] and K4 at an odd [1, 64, 37, 53] (the ceil
             edge of its SAME pool), in f32 and (K2-K4) in bf16: K1 bit-equal;
             f32 K2..K4 max|err| / max|plain| <= 1e-4; bf16 K2..K4 within 4
             bf16 ulps of max|plain| and >= 95 % of the outputs equal (the two
             sum the same exact products in another order); each case's
             kernel ms, plain ms, bound ms and share of the bound; the library
             routes (grid_sample for K1; cuDNN's convs + the pool, f32 or bf16,
             for K2 and K4; cuDNN's stride-2 conv over the stack built
             beforehand for K3) held to the plain versions and timed; K1,
             grid_sample and the bf16 K2-K4 also timed with the L2 flushed
             before each call; each bf16 K2/K4 conv launch timed alone by
             layer (ms, TFLOP/s, share of its bound)
  4 serving  seeded ReverseCameraPipeline on the card behind make_server;
             4 client threads POST 8 JPEG 512x512 images; f32, then bf16
             (build_pipeline(dtype=torch.bfloat16))
  5 parity   one 512x512 image on the card vs the CPU plain path: f32 within
             1e-4 of max|ref|; bf16 PSNR >= 40 dB against the CPU f32 output;
             bf16 at 1 x 128^2 vs the CPU bf16 plain path within 4 % of max|ref|
  6 launches every kernel counted during phase 4, by dtype, per batch K1 x1
             (f32), K2 x6, K3 x1, K4 x2 in the pipeline's dtype and none in
             the other
  7 timing   p50 latency and img/s at batch 1 and 8, per-net times at batch
             8, for each dtype
  8 K1-bwd   vs plain at [16, 3*256^2] and [4, 3*576^2], and with every
             x = 1.0 at [16, 3*256^2]: gx bit-equal (also gx alone), grf
             max|err| / max|plain| <= 1e-5 against the plain version in
             float64 and the same bits on three launches (gx + grf twice,
             grf alone); times warm and with the L2 flushed, with the share
             of the bound (12 bytes a pixel; 8 for grf alone); the library
             route (grid_sample's backward) held to the plain version and
             timed; a curve longer than the kernel's plan raises
  9 training cli.joint_train.run at batch 16, 256^2 on synthetic .hdr files:
             6 steps, then a resume to 8; the same CLI with --dtype bfloat16
             for 3 steps; K1-bwd once per step, K2..K4 never; one cli.train
             --lin step
  10 parity  one joint step, card vs CPU, at 2 x 64^2, every gradient tensor
             within 2e-3 of its own max + 1e-3 of its net's max, and planted
             faults (a zeroed or sign-flipped gradient) flagged by that bound;
             the same step in bf16, each net's gradients held to the CPU f32
             ones as the CPU bf16 step's are (distance, cosine; deq within
             3 % of its norm), a zeroed or sign-flipped net's failing;
             one finetune step at 4 x 256^2 on the card (K1-bwd's gx branch)
  11 timing  joint step at batch 16, 256^2: forward + loss, backward, Adam;
             K1-bwd's share of the step; f32, then bf16
  12 real    the HDR-Real path through its CLIs, each path's launches counted
             alone: convert_records (two seeded 512x768 HDR_gt/LDR_in pairs,
             90 records of 256^2); finetune one epoch at batch 4 (23 steps,
             the tail of 2 trained) from phase 9's joint checkpoint, f32 then
             bf16, K1 = K1-bwd = steps and K2-K4 none; infer on two 1024x1536
             photos, whole (K1 x1, K2 x6, K3 x1, K4 x2 an image) and tiled in
             512^2 tiles, halo 64 (K2 x3 + K3 x1 for the 256^2 invCRF view,
             K1 x1, K2 x6, K4 x2 a tile); evaluate (K1, K2 x6, K3, K4 x2 a
             batch of 4); validate_synth on phase 9's files and joint
             checkpoint; tiled vs whole in tile interiors, tiled and
             evaluate vs the CPU plain path; K1-K4 vs plain at [4, *, 256^2]
             and [1, *, 1088x1600] in f32 and bf16, K1-bwd on a finetune
             step's C_pred and on 8-bit LDR input (grf bin by bin against
             each bin's mass); one invCRF view's launches counted alone; the
             finetune step in rounds of synchronised calls (wall, host
             enqueue, the thread's CPU, other threads' CPU); batch and image
             times
  13 interop cli.export_weights on phase 9's joint checkpoint (deq, lin,
             hal) and phase 12's f32 finetune (ref): the .npz and one
             reference TF2 bundle a net, each bundle read back bit-equal;
             cli.import_reference of the bundles, rgb (equal to the export)
             and bgr; cli.infer on phase 12's two photos from the slots and
             from the imported .npz (the same .hdr bytes; K1 x1, K2 x6, K3
             x1, K4 x2 an image), the two pipelines within 1e-6 of max|ref|,
             the bgr import on the channel-flipped photo against the flipped
             rgb output within 1e-4, the serve CLI's slot loading on one
             512^2 request within 1e-6 of infer's
  14 remat   a finetune step at batch 4 (phase 12's records) and a joint
             step at batch 16, 256^2, f32 and bf16, with remat False, True
             and 'convs' from one snapshot: with cuDNN's deterministic
             algorithms, loss and new BN statistics within 1e-6 of the plain
             step's and every gradient within phase 10's bound of it (the
             bit-equal tensors counted); as run by default, peak memory
             (True below the plain step, 'convs' not above) and step time
             in synchronised rounds; K1 and K1-bwd once a step and K2-K4
             never; cli.finetune --remat (one epoch, bf16) and
             cli.joint_train --remat (2 steps); phase 10's bf16 check with
             cuDNN free to choose its algorithms: the bf16 joint step at 2 x
             64^2 with remat False, True and 'convs' against the CPU f32
             step (as phase 10), and at 16 x 256^2 each remat mode against
             the card's f32 plain step as the plain bf16 step is; each
             mode's kernels by name (the profiler's) against the plain
             step's, and the tensor farthest from the plain bf16 step
  15 multi   (a) two gloo ranks on the one card (CUDA tensors; subprocesses
             of this script, ``--mesh-rank``, under a timeout): the joint
             step at 16 x 256^2 (8 a rank) in f32, float64 and bf16 and the
             finetune step at 4 x 256^2 (2 a rank) in f32 and float64, each
             against the single-process step on the full batch from one
             snapshot by phase 10's criteria (float64: within 1e-10; the
             f32 finetune step by its distance from float64 against
             one-process runs one ulp of input apart), the ranks'
             parameters bit-equal, the step's time (two
             processes sharing one card: not a scaling figure); (b)
             cli.joint_train (2 steps) and cli.finetune (2 epochs of one
             batch of 4, no tail) with --mesh 1, a process group of one over
             NCCL, against the same CLI without it: logged losses,
             parameters and BN statistics after step 1, final parameters; (c) the joint step with --mesh 1 against
             without (f32, bf16, in turns) and the gradient all-reduce's
             time; K1 and K1-bwd counted on the mesh runs, K2-K4 never
  16 spatial (a) two gloo ranks on the one card, D=1 x S=2 (rows split in
             two bands): tiled.shard_spatial on phase 12's first photo
             (1024x1536, bands of 512 rows), f32 and bf16, against the
             one-process whole-photo forward: f32 within 1e-4 of max|ref|,
             bf16 PSNR >= 40 dB against the f32 whole photo; each rank's
             launches a forward (K1 x1, K2 x6, K3 x1, K4 x2) and the height
             of every K2-K4 input (its band + the even halo of each inner
             side); (b) K2, K4 (each stage of phase 3's cases) and K3 at
             [4, *, 576^2] on the top, a middle and the bottom band of 4,
             f32 and bf16: the kernel on the extended band against its plain
             version there, and its output cropped to the band against the
             rows of the plain version on the whole tensor, by phase 3's
             criteria; (c), (d) phase 15's joint (16 x 256^2, f32, float64,
             bf16) and finetune (4 x 256^2, f32, float64) steps on D=1 x
             S=2, (e) the f32 joint step on D=2 x S=2 (four ranks), each by
             phase 15's criteria against the same one-process steps, but
             the f32 joint step as the f32 finetune step (the comment at
             MESH_F64_REL_TOL says why); (f) their
             launches: K1 and K1-bwd, K2-K4 never; (g) each spatial step's
             time and the share of it its halo exchanges take (each timed
             alone, synchronised); two or four processes share one card, so
             no time here is a scaling figure
  17 tools   the recipe tools (singlehdr_tpu_torch/tools): (a)
             quality_anchor in bf16 at b16 @ 256^2 with 20 pretrain steps a
             net, 20 joint steps, 8 HDR-Synth scenes and 6 pairs (2 finetune,
             4 test), one finetune epoch, through its stage processes; every
             stage exits 0, the three metrics finite; its ck_ref checkpoints
             re-evaluated in this process on its test records within 1e-3 dB
             and 1e-4 SSIM of its evaluate stage (less half the step its
             printed line rounds to), K1 x1, K2 x6, K3 x1, K4 x2 (f32) a
             batch; (b) serve_load in bf16 on 384x512, 512x512 and 256x384
             with 8 clients, max batch 8, 50 requests: all 50 answered, no
             error, every bucket warm at b1 and b8, batches formed, in the
             timed window K1 x1 (f32), K2 x6, K3 x1, K4 x2 (bf16) a device
             batch; p50/p90/p99 overall and per bucket; then at each
             bucket's padded shape (448x576, 576x576, 320x448) at b8, K1
             (f32) and K2-K4 (bf16) against their plain versions by phase
             3's criteria; (c)
             measure_feed at b16 @ 256^2 over 12 scenes (native codec if
             built, cv2, prefetched x2; K1 launched by the capture), beside
             phase 11's bf16 joint step in img/s
The second-to-last line is the kernels' JSON record, one entry a (kernel,
dtype): K2-K4's bf16 kernels as ``unet_stage2_bf16``, ``lin_feature_stem_bf16``
and ``encoder_stage2_bf16`` (with each kernel's launches by path and per
serving batch, training step, finetune step, evaluate batch, whole image and
tile, its bound, the library route's time, and ``hdr_real_cases``, phase
12's cases), the last the result.  K2 and K4 count one launch a stage call, which makes two launches
of the conv kernel (``kernel_launches_per_stage``).

Kernel, plain and library times (phases 3 and 8) are device times of
back-to-back calls with the host kept ahead (``device_ms``): K1 runs for less
time than its wrapper's host work, which a plain CUDA-event loop would time
instead.  Per-net times (phase 7) are CUDA-event times of whole nets.

A kernel's bound is the least time the card could take for its work: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its FLOP over the tensor cores' rate for its products: 165
TFLOP/s for f32-accurate products (three TF32 products each, 495 / 3; the 67
TFLOP/s of f32 on the CUDA cores is printed beside it) and 989 TFLOP/s for
bf16 products (dense).  For the bf16 K2/K4 the bound of the two launches as
built (conv1's activation written and read back) is printed beside it.
Peaks: NVIDIA's H100 SXM data sheet.
"""

from __future__ import annotations

import contextlib
import copy
import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

SERVE_HW = 512
MAX_BATCH = 8
N_REQUESTS = 8
N_CLIENTS = 4
KERNEL_BATCH = 4
KERNEL_REL_TOL = 1e-4   # f32 sum order differs between the kernels and cuDNN
PATH_REL_TOL = 1e-4     # the whole served path vs the CPU plain path (f32 sum order)
# bf16 kernels vs their plain versions: both sum the same exact bf16 products
# in f32, in another order, and round where the Pallas kernels round; an
# output differs only where the two sums straddle a rounding boundary (one
# ulp, and conv1's flips moving conv2's sum).  Bound: 4 bf16 ulps of
# max|plain| (2^-6), with at least 95 % of the outputs bit-equal
KERNEL_BF16_REL_TOL = 2.0 ** -6
KERNEL_BF16_MIN_EQUAL = 0.95
PATH_BF16_MIN_PSNR_DB = 40.0  # the card's bf16 hdr vs the CPU f32 path (peak max|ref|)
PATH_BF16_HW = 128            # the card's bf16 path vs the CPU bf16 plain path, 1 x 128^2
PATH_BF16_REL_TOL = 4e-2      # of max|ref|: cuDNN's and the CPU's bf16 convs round apart
BF16_JOINT_STEPS = 3          # phase 9: joint steps of the --dtype bfloat16 run
SEED = 0
TRAIN_BATCH = 16        # the reference's joint configuration: batch 16 at 256^2
TRAIN_HW = 256
JOINT_RUNS = ((6, 0), (8, 6))  # phase 9: (iterations, resumed from)
TRAIN_STEPS = sum(n - start for n, start in JOINT_RUNS) + 1  # + one cli.train --lin step
BWD_SHAPES = ((TRAIN_BATCH, 3 * TRAIN_HW * TRAIN_HW), (KERNEL_BATCH, 3 * 576 * 576))
BWD_REL_TOL = 1e-5      # grf vs the float64 plain version: f32 sums in the kernel's order
STEP_LOSS_REL_TOL = 1e-4
# card vs CPU gradients, per tensor: max|g_card - g_cpu| <= STEP_GRAD_OWN_TOL
# of the tensor's own max|g_cpu| + STEP_GRAD_NET_TOL of its net's largest
# max|g_cpu|.  cuDNN's f32 backward algorithms (FFT among them) and the f32
# batch-norm reductions move the card's hal and lin gradients by up to ~9e-4
# of the net's scale (the CPU accumulates batch norm in double).  The net term
# covers a bias in front of a batch-statistic normalisation, whose true
# gradient is 0, so that its own maximum is no scale.
STEP_GRAD_OWN_TOL = 2e-3
STEP_GRAD_NET_TOL = 1e-3
STEP_STATS_REL_TOL = 1e-4
# the bf16 joint step, per net (Frobenius over its gradients, relative to the
# CPU f32 norm): bf16 rounding moves lin's and hal's gradients by about half
# their norm on the CPU (tests/test_torch_bf16.py says why), and the card's
# cuDNN sums round elsewhere, so the card is held to the CPU f32 gradients as
# the CPU bf16 step is: distance <= 1.5 x the CPU bf16 step's + 0.02, cosine
# >= the CPU bf16 step's - 0.2 and >= 0.5; deq (no batch norm, 0.007 on the
# CPU) within 0.03
BF16_STEP_NOISE_FACTOR = 1.5
BF16_STEP_COS_SLACK, BF16_STEP_COS_MIN = 0.2, 0.5
BF16_STEP_DEQ_TOL = 0.03
BF16_STEP_LOSS_REL_TOL = 1e-3
# the bf16 step's new BatchNorm statistics, two processes against one: their
# inputs are bf16, where the two sum orders of the statistics flip ulps that
# the deeper layers carry (lin's res4-res5 running means 2.2e-3 of their max
# on the CPU at 4 x 32^2, measured); two bf16 ulps of the max
BF16_STATS_REL_TOL = 2.0 ** -7
# tensors whose gradient, zeroed or sign-flipped on the card's side, the bound
# must flag: small ones (BN scale and shift) and lin's dense head
PLANTED_FAULTS = ("lin.crf_feature_net.stem_bn.weight", "lin.crf_feature_net.stem_bn.bias",
                  "lin.pca_head.weight", "hal.dec1.bn.bias")

# per batch of the pipeline: launches of each kernel
PER_BATCH = {"apply_rf": 1, "unet_stage2": 6, "lin_feature_stem": 1, "encoder_stage2": 2}
# phase 12, the HDR-Real path at the reference finetune configuration (batch
# 4 at 256^2 patches, lr 1e-5): two paired 512x768 HDR_gt/LDR_in images give
# 45 patches each at stride 64, every one informative (levels 12-242)
REAL_HW = (512, 768)
REAL_PAIRS = 2
REAL_RECORDS = 90
REAL_BATCH = 4
REAL_STEPS = -(-REAL_RECORDS // REAL_BATCH)   # the short tail batch is trained
EVAL_BATCHES = REAL_RECORDS // REAL_BATCH     # and skipped by evaluate
PHOTO_HW = (1024, 1536)   # two seeded photos through infer, whole and tiled
N_PHOTOS = 2
TILE, HALO = 512, 64
# tiled vs whole (HdrPredictor) in tile interiors, max|err| / max|whole|: the
# two differ by their inverse CRFs (a 256^2 INTER_AREA view against the whole
# padded photo) and by context beyond the halo; on the CPU, 512x768 in 256^2
# tiles with a seeded pipeline, 5.9e-3 (curves 1.7e-3 apart)
TILED_WHOLE_REL_TOL = 2e-2
# tiles of the global invCRF view (deq, then lin) and of each tile (deq, hal, ref)
PER_VIEW = {"apply_rf": 0, "unet_stage2": 3, "lin_feature_stem": 1, "encoder_stage2": 0}
PER_TILE = {"apply_rf": 1, "unet_stage2": 6, "lin_feature_stem": 0, "encoder_stage2": 2}
# phase 12's finetune step alone: rounds of synchronised calls
STEP_ROUNDS, STEP_CALLS = 5, 5
# validate_synth: 2 batches of 8 at 512^2; K1 twice a batch (the capture's
# CRF and B_pred), deq's K2 stages and lin's K3
VALIDATE_BATCHES = 2
PER_VALIDATE_BATCH = {"apply_rf": 2, "unet_stage2": 3, "lin_feature_stem": 1, "encoder_stage2": 0}
# the card's tiled TiledPredictor vs the CPU plain path's: 256x320 in 128^2
# tiles, halo 32, a 64^2 view (6 tiles); the bound is PATH_REL_TOL's
TILED_SMALL = ((256, 320), 128, 32, 64)
EVAL_DB_TOL = 1e-3      # evaluate's PSNRs, card vs CPU plain path, first two batches
EVAL_SSIM_TOL = 1e-4
# phase 13, interop: the same weights through the checkpoint slots and
# through export -> import give the same numbers from the same kernels
INTEROP_REL_TOL = 1e-6
# the bgr import on a channel-flipped photo against the flipped rgb output:
# exact in real numbers, the kernels sum the permuted channels in another order
INTEROP_BGR_REL_TOL = PATH_REL_TOL
SERVE_REQUEST_HW = 512
INTEROP_IMAGES = 2 * N_PHOTOS + 6  # two infer runs; four photo and two request forwards
# phase 14, remat: one step of each (step, dtype, mode) from one snapshot;
# loss and new BatchNorm statistics against the plain step's, gradients
# within phase 10's bound of the plain step's
REMAT_MODES = (False, True, "convs")
REMAT_REL_TOL = 1e-6
REMAT_ROUNDS, REMAT_CALLS = 2, 3
REMAT_CLI_ITERATIONS = 2
# phase 15, multi-device on the one card: two gloo ranks (CUDA tensors, one
# card), each case's step held to the single-process step on the full batch
# by phase 10's criteria; the CLIs at --mesh 1 over NCCL against their
# meshless runs; the mesh's cost at world 1
MESH_RANKS = 2
MESH_RANK_TIMEOUT_S = 600
MESH_TIMED_STEPS = 3      # a case's steps timed on the ranks after the compared one
MESH_CLI_ITERATIONS = 2
# cli.finetune: one epoch of MESH_FT_STEPS steps on phase 12's pairs cut at
# MESH_FT_STRIDE (30 records of 256^2, batches of MESH_FT_BATCH: no tail to
# pad); over 15 steps --mesh 1 and the meshless run drift apart by more than
# phase 10's one-step bounds, so each reading may also reach MESH_CLI_SLACK
# times the farthest witness's, each a meshless run that rounds otherwise:
# from the same checkpoint with every weight moved by one ulp (seeded), once
# at the start ("ulp0", "ulp1"), and with cuDNN held to its deterministic
# algorithms, which round every conv otherwise at every step, as the mesh's
# BatchNorm does its statistics ("cudnn_det")
MESH_FT_STRIDE = 128
MESH_FT_BATCH = 2
MESH_FT_STEPS = 15
MESH_CLI_WITNESSES = ("ulp0", "ulp1", "cudnn_det")
MESH_CLI_SLACK = 2.0
# the finetune step at 4 x 256^2 (2 a rank) is held in two ways.  In float64
# the two ranks are the one-process step but for rounding: every gradient
# within MESH_F64_REL_TOL of its net's largest, the loss within it too.  In
# f32 phase 10's per-tensor bound does not hold for this step even between
# two one-process runs that differ only by rounding (its L1 signs, clips and
# LUT bins), so each net's distance from the float64 step is held to
# MESH_F32_SLACK times the farthest of MESH_F32_WITNESSES +
# MESH_F32_WEIGHT_WITNESSES + 2 one-process f32 steps: the step itself, again,
# on inputs moved by one ulp each and from weights moved by one ulp each,
# seeded.  Weights one ulp apart round every layer otherwise, as the bands'
# other shapes do (other cuDNN algorithms): on phase 12's batch they spread
# as far from float64 as two bands do, where inputs one ulp apart did not
# (PERF.md, section 6, PR 12); one draw of such a spread is heavy-tailed, so
# several are taken.
# The joint step is held in float64 the same way; in f32 by phase 10's
# per-tensor bound on a data mesh, and on a spatial mesh (phase 16) as the
# finetune step: there its hal encoder's weight gradients move past that
# bound between one-process runs one ulp of input apart as well (PERF.md,
# section 6, PR 12)
MESH_F64_REL_TOL = 1e-10
MESH_F32_WITNESSES = 3
MESH_F32_WEIGHT_WITNESSES = 6
MESH_F32_SLACK = 2.0
# phase 16, the spatial axis: bands of the ranks' meshes, forwards timed after
# the compared one, and bands of phase 3's cases for K2-K4 on extended bands
SPATIAL_BANDS = 2
SPATIAL_TIMED_FORWARDS = 3
SPATIAL_KERNEL_BANDS = 4
# phase 17, the recipe tools: the quality anchor at full width and reduced
# depth (its last 4 pairs are the test set: 4 x 15 records of 256^2 at stride
# 128), serve_load (50 requests over 8 clients: 50 % 8 = 2 clients send one
# more), measure_feed at the joint configuration
ANCHOR_ARGS = ("--dtype", "bfloat16", "--batch", str(TRAIN_BATCH), "--steps", "20", "--joint_steps", "20",
               "--finetune_epochs", "1", "--n_train", "8", "--n_test", "6")
ANCHOR_STAGES = ("pretrain_deq", "pretrain_lin", "pretrain_hal", "joint", "records_train", "records_test",
                 "finetune", "evaluate")
LOAD_SHAPES = "384x512,512x512,256x384"
LOAD_CLIENTS, LOAD_BATCH, LOAD_REQUESTS = 8, 8, 50
FEED_SCENES = 12
HBM_BYTES_PER_S = 3.35e12
SLEEP_CYCLES_PER_S = 2.0e9  # device_ms's lead: at least the SM clock (1.98 GHz at most)
F32_TENSOR_FLOPS = 495e12 / 3   # 3xTF32
BF16_TENSOR_FLOPS = 989e12      # dense bf16
F32_SIMT_FLOPS = 67e12
ODD_K4_SHAPE = (1, 64, 37, 53)  # hal enc2's widths at odd H, W
ODD_K3_SHAPE = (1, 3, 37, 53)   # ragged tiles, odd SAME pads, REFLECT at every edge
# the library route of each kernel (library_ms): K1 and K1-bwd are grid_sample
# and its backward, K2 and K4 their plain versions (cuDNN's f32 convs + the
# pool), K3 cuDNN's f32 stride-2 conv + ReLU over the feature stack built
# beforehand.  A library route is held to its kernel's plain version within
# LIBRARY_REL_TOL: grid_sample rounds 2x - 1, its backward sums the curve
# gradient in its own atomic order, and cuDNN sums in its own order
LIBRARY_REL_TOL = 1e-4
# K2 and K4 count one launch a stage call; each call makes this many launches
# of the conv kernel (conv1, then conv2 with the pool)
KERNEL_LAUNCHES_PER_STAGE = {"unet_stage2": 2, "encoder_stage2": 2}
SOURCES = {
    "apply_rf": ("singlehdr_tpu_torch/csrc/apply_rf.cu",
                 "singlehdr_tpu/ops/pallas/apply_rf_pallas.py:159"),
    "apply_rf_bwd": ("singlehdr_tpu_torch/csrc/apply_rf.cu",
                     "singlehdr_tpu/ops/pallas/apply_rf_pallas.py:188"),
    "unet_stage2": ("singlehdr_tpu_torch/csrc/conv2_pool.cu",
                    "singlehdr_tpu/ops/pallas/unet_stage_pallas.py:263"),
    "lin_feature_stem": ("singlehdr_tpu_torch/csrc/lin_stem.cu",
                         "singlehdr_tpu/ops/pallas/lin_stem_pallas.py:303"),
    "encoder_stage2": ("singlehdr_tpu_torch/csrc/conv2_pool.cu",
                       "singlehdr_tpu/ops/pallas/enc_pool_pallas.py:306"),
}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events, warmed)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def enqueue_s(fn) -> float:
    """Host seconds one call of ``fn`` takes to enqueue its work (warmed, on
    an idle stream)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs with the
    host kept ahead: a sleep kernel holds the stream while the host enqueues
    the runs, so the wrappers' host work between launches (argument checks,
    ctypes) is not counted (CUDA events, warmed).  For kernels whose run is
    shorter than their host work, ``cuda_ms`` measures the host instead."""
    lead_s = 2 * iters * enqueue_s(fn) + 1e-3
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * lead_s))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cold_l2_ms(fn, iters: int = 10) -> float:
    """Mean device time of one call of ``fn`` with the 50 MB L2 flushed first
    (a 128 MB write before each call; host kept ahead as in ``device_ms``):
    the time a caller whose inputs come from device memory would see."""
    junk = torch.empty(32 * 2**20, device=torch.cuda.current_device())
    lead_s = 2 * enqueue_s(fn) + 1e-4
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for start, stop in ev:
        junk.zero_()
        torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * lead_s))
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(stop) for start, stop in ev) / iters


def check_tensor_core_sass() -> None:
    """Phase 2: K2/K4's conv kernels and K3's kernels run on the tensor
    cores, and the bf16 kernels do not spill.  In the SASS of the built
    library (cuobjdump): every f32 conv instantiation (``conv_gemm_kernel``)
    holds TF32 HMMA (mma.sync) or HGMMA (wgmma) instructions; every bf16 one
    (``conv_gemm_bf16_kernel``) BF16 HGMMA where a block is 32 channels or
    more and BF16 HMMA (or HGMMA) in the 16-channel stems; K3's f32 kernel
    (``lin_stem_kernel``) TF32 HGMMA and its bf16 kernel
    (``lin_stem_bf16_kernel``) BF16 HGMMA.  In ``cuobjdump -res-usage``:
    every bf16 conv instantiation and the bf16 K3 kernel have no stack frame
    and no local memory, so no spill stores."""
    import re
    from pathlib import Path

    from singlehdr_tpu_torch.ops.cuda import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    lib = str(_build.build())
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    functions = [(f.split()[0], f) for f in sass.split("Function : ")[1:]]

    def mma(body: str, kind: str, precision: str) -> int:
        """Tensor-core instructions of ``kind`` of this precision: BF16 ones
        carry ``.BF16``; the f32 kernels' TF32 ones (``.TF32``) carry no BF16."""
        lines = [ln for ln in body.splitlines() if f" {kind}." in ln]
        if precision == "BF16":
            return sum(".BF16" in ln for ln in lines)
        return sum(".BF16" not in ln for ln in lines)

    kinds = (("conv_gemm_kernel", "TF32"), ("conv_gemm_bf16_kernel", "BF16"),
             ("lin_stem_kernel", "TF32"), ("lin_stem_bf16_kernel", "BF16"))
    for kernel, precision in kinds:
        # the mangled name: the kernel's, then its template arguments (I) or its end (E)
        insts = [(name, body) for name, body in functions
                 if f"{kernel}I" in name or f"{kernel}E" in name]
        counts = [(mma(body, "HMMA", precision), mma(body, "HGMMA", precision), name)
                  for name, body in insts]
        print(f"  {kernel} {precision}: {len(insts)} instantiation(s); HMMA.{precision} "
              f"{sum(c[0] for c in counts)}, HGMMA.{precision} {sum(c[1] for c in counts)}",
              flush=True)
        if not insts or not all(h + g > 0 for h, g, _ in counts):
            raise AssertionError(f"{kernel}: a {precision} instantiation without {precision} "
                                 "tensor-core instructions in its SASS")
        for hmma, hgmma, name in counts:
            stem = "ELi16ELNS" in name  # BN = 16
            if kernel.startswith("lin_stem") and not hgmma:
                raise AssertionError(f"K3 ({precision}) has no HGMMA in its SASS")
            if kernel == "conv_gemm_bf16_kernel" and not (hmma + hgmma if stem else hgmma):
                raise AssertionError(f"{name}: no {'HMMA' if stem else 'HGMMA'}.BF16")

    usage = subprocess.run([str(tool), "-res-usage", lib], capture_output=True, text=True,
                           check=True).stdout
    rows = re.findall(r"Function (\S+):\s+REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", usage)
    for kernel in ("conv_gemm_bf16_kernel", "lin_stem_bf16_kernel"):
        bf16 = [(name, int(reg), int(stack), int(local)) for name, reg, stack, local in rows
                if kernel in name]
        spilled = [name for name, _, stack, local in bf16 if stack or local]
        regs = [r for _, r, _, _ in bf16] or [0]
        print(f"  {kernel}: {len(bf16)} instantiation(s), registers {min(regs)}-{max(regs)}, "
              f"{len(spilled)} with a stack frame or local memory (spill stores)", flush=True)
        if not bf16 or spilled:
            raise AssertionError(f"{kernel} instantiations that spill: {spilled or 'none found'}")


def kernel_cases(pipe, dev, dtype=torch.float32, b: int = KERNEL_BATCH, hw=(SERVE_HW + 64,) * 2,
                 odd: bool = True):
    """(kernel name, case label, wrapper args) at the main path's shapes (the
    serving path's [b, 3, 576, 576] unless ``b`` and ``hw`` say otherwise),
    with the pipeline's own conv weights; inputs of a later stage are the
    plain outputs of the stage before it.  The seeded init has zero biases,
    so the cases add seeded biases to exercise the kernels' bias path.  For
    bf16 the same cases of K2-K4 with x and the weights rounded to bf16 (the
    biases stay f32), as a bf16 net hands them over.  ``odd`` adds K3 and K4
    at odd shapes."""
    cases = _kernel_cases_f32(pipe, dev, b, hw, odd)
    if dtype == torch.float32:
        return cases
    bf16 = []
    for name, label, args in cases:
        if name == "apply_rf":  # K1 is f32 in every compute dtype
            continue
        if name == "lin_feature_stem":
            x, k7, b7 = args
            args = (x.to(dtype), k7.to(dtype), b7)
        else:
            x, w1, b1, w2, b2 = args
            args = (x.to(dtype), w1.to(dtype).contiguous(), b1, w2.to(dtype).contiguous(), b2)
        bf16.append((name, label, args))
    return bf16


def _kernel_cases_f32(pipe, dev, b: int, hw: tuple, odd: bool):
    from singlehdr_tpu_torch.ops import color
    from singlehdr_tpu_torch.ops.curves import monotonic_rf
    from singlehdr_tpu_torch.ops.cuda.enc_pool_cuda import encoder_stage2_plain
    from singlehdr_tpu_torch.ops.cuda.unet_stage_cuda import unet_stage2_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    img = torch.rand(b, 3, *hw, generator=g, device=dev)
    cases = []

    x = img * 1.4 - 0.2  # includes inputs outside [0, 1]
    raw = torch.rand(b, 1024, generator=g, device=dev)
    cases.append(("apply_rf", f"{tuple(x.shape)}", (x.contiguous(), monotonic_rf(raw).contiguous())))

    def bias(n):
        return (torch.randn(n, generator=g, device=dev) * 0.1).contiguous()

    for net, cin in (("deq", 3), ("ref", 9)):
        unet = getattr(pipe, net).unet
        h = torch.rand(b, cin, *hw, generator=g, device=dev)
        stages = [(unet.stem1, unet.stem2, "stem")]
        stages += [(getattr(unet, n).conv1, getattr(unet, n).conv2, n) for n in ("down2", "down3")]
        for c1, c2, label in stages:
            args = (h.contiguous(), c1.weight, bias(c1.bias.numel()), c2.weight,
                    bias(c2.bias.numel()))
            cases.append(("unet_stage2", f"{net}.{label} {tuple(h.shape)}", args))
            h, _ = unet_stage2_plain(*args)

    crf = pipe.lin.crf_feature_net
    scale, shift = crf.stem_bn.folded()
    k7 = (crf.stem.weight * scale[:, None, None, None]).contiguous()
    b7 = (crf.stem.bias * scale + shift + bias(scale.numel())).contiguous()
    cases.append(("lin_feature_stem", f"lin.stem {tuple(img.shape)}", (img, k7, b7)))

    h = color.vgg_preprocess(img, pipe.hal.preproc_mean).contiguous()
    for name in ("enc1", "enc2"):
        enc = getattr(pipe.hal, name)
        args = (h, enc.conv1.weight, bias(enc.conv1.bias.numel()), enc.conv2.weight,
                bias(enc.conv2.bias.numel()))
        cases.append(("encoder_stage2", f"hal.{name} {tuple(h.shape)}", args))
        h, _ = encoder_stage2_plain(*args)
        h = h.contiguous()
    if not odd:
        return cases
    enc = pipe.hal.enc2
    odd = torch.rand(*ODD_K4_SHAPE, generator=g, device=dev) * 50
    cases.append(("encoder_stage2", f"hal.enc2 odd {ODD_K4_SHAPE}",
                  (odd, enc.conv1.weight, bias(enc.conv1.bias.numel()), enc.conv2.weight,
                   bias(enc.conv2.bias.numel()))))
    odd = torch.rand(*ODD_K3_SHAPE, generator=g, device=dev)
    cases.append(("lin_feature_stem", f"lin.stem odd {ODD_K3_SHAPE}", (odd, k7, b7)))
    return cases


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def kernel_flop(name: str, args) -> float:
    """FLOP of one call: the convs' multiply-adds (x2); K1's lerp, 3 a value."""
    if name in ("unet_stage2", "encoder_stage2"):
        x, w1, _, w2, _ = args
        b, c, h, w = x.shape
        f, _, k, _ = w1.shape
        return 2.0 * b * h * w * f * k * k * (c + f)
    if name == "lin_feature_stem":
        x, k7, _ = args
        b, _, h, w = x.shape
        f, c, k, _ = k7.shape
        return 2.0 * b * -(-h // 2) * -(-w // 2) * f * c * k * k
    return 3.0 * args[0].numel()


def bound(flop: float, moved: int, dtype=torch.float32) -> tuple:
    """(bound ms, what sets it, the f32 CUDA-core bound ms) at the tensor
    cores' rate for ``dtype``'s products."""
    rate = BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else F32_TENSOR_FLOPS
    ops_ms, bytes_ms = flop / rate * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes",
            max(flop / F32_SIMT_FLOPS * 1e3, bytes_ms))


def two_launch_bound_ms(name: str, args, want, dtype) -> float:
    """K2's and K4's bound as built, two launches a stage: each launch's
    max(FLOP / rate, bytes / 3.35 TB/s), conv1's activation written by the
    first and read by the second."""
    x, w1, b1, w2, b2 = args
    b, c, h, w = x.shape
    f, _, k, _ = w1.shape
    mid = b * f * h * w * x.element_size()
    conv1 = bound(2.0 * b * h * w * f * k * k * c, nbytes((x, w1, b1)) + mid, dtype)[0]
    conv2 = bound(2.0 * b * h * w * f * k * k * f, mid + nbytes((w2, b2)) + nbytes(want), dtype)[0]
    return conv1 + conv2


def conv_launches(name: str, args) -> list:
    """The two conv launches of one K2/K4 stage call, each as (conv, fn, FLOP,
    bytes moved): conv1 reads x and stores conv1's activation (NCHW in f32,
    channel-blocked in bf16), conv2 reads it and stores the skip and the
    pool, into buffers made here.  Called outside the stage wrapper, they add
    nothing to its launch count."""
    from singlehdr_tpu_torch.ops.cuda import conv_gemm

    x, w1, b1, w2, b2 = args
    b, c, h, w = x.shape
    f, _, k, _ = w1.shape
    if name == "unet_stage2":
        modes, ph, pw = (conv_gemm.LEAKY_STORE, conv_gemm.LEAKY_AVG_POOL), h // 2, w // 2
    else:
        modes, ph, pw = (conv_gemm.RELU_STORE, conv_gemm.RELU_MAX_POOL), (h + 1) // 2, (w + 1) // 2
    mid = conv_gemm.mid_like(x, f)
    act = torch.empty((b, f, h, w), dtype=x.dtype, device=x.device)
    pooled = torch.empty((b, f, ph, pw), dtype=x.dtype, device=x.device)
    macs = 2.0 * b * h * w * f * k * k
    return [("conv1", lambda: conv_gemm.conv_gemm(x, w1, b1, mid, None, modes[0]), macs * c,
             nbytes((x, w1, b1, mid))),
            ("conv2", lambda: conv_gemm.conv_gemm(mid, w2, b2, act, pooled, modes[1]), macs * f,
             nbytes((mid, w2, b2, act, pooled)))]


def conv_stage_library(name: str, x, w1, b1, w2, b2) -> tuple:
    """K2's or K4's function as PyTorch calls in x's dtype (the library route
    for bf16: cuDNN's bf16 convs, bias in bf16, and the pool, all in bf16)."""
    F = torch.nn.functional
    k = w1.shape[-1]
    if name == "unet_stage2":
        y = F.leaky_relu(F.conv2d(x, w1, b1.to(x.dtype), padding=k // 2), 0.1)
        y = F.leaky_relu(F.conv2d(y, w2, b2.to(x.dtype), padding=k // 2), 0.1)
        return F.avg_pool2d(y, 2), y
    y = F.relu(F.conv2d(x, w1, b1.to(x.dtype), padding=1))
    y = F.relu(F.conv2d(y, w2, b2.to(x.dtype), padding=1))
    return F.max_pool2d(y, 2, 2, ceil_mode=True), y


def rf_grid(x: torch.Tensor) -> torch.Tensor:
    """K1's x [b, ...] as grid_sample's sampling grid [b, 1, n, 2]: (2x - 1, 0)."""
    u = x.reshape(x.shape[0], 1, -1, 1) * 2 - 1
    return torch.cat([u, torch.zeros_like(u)], dim=-1).contiguous()


def apply_rf_library(rf: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """K1's function as one PyTorch call: the curve as a [b, 1, 1, k] image,
    sampled bilinearly at ``rf_grid(x)``.  align_corners maps x = 0 and 1 to
    its first and last samples, and border padding is the clip of both lerp
    indices.  Returns [b, 1, 1, n]."""
    b, k = rf.shape
    return torch.nn.functional.grid_sample(rf.view(b, 1, 1, k), grid, mode="bilinear",
                                           padding_mode="border", align_corners=True)


def apply_rf_bwd_library(rf: torch.Tensor, grid: torch.Tensor, g: torch.Tensor) -> tuple:
    """K1-bwd's function as one PyTorch call, grid_sample's backward (bilinear,
    border, align_corners): (the grid's gradient [b, 1, n, 2], the curve's
    [b, 1, 1, k]).  gx is twice the grid gradient's first part (grid = 2x - 1)."""
    b, k = rf.shape
    grf, ggrid = torch.ops.aten.grid_sampler_2d_backward(
        g.view(b, 1, 1, -1), rf.view(b, 1, 1, k), grid, 0, 1, True, [True, True])
    return ggrid, grf


def k1_library_error(x: torch.Tensor, rf: torch.Tensor, want: torch.Tensor) -> float:
    """max|err| / max|plain| of K1's library route against K1's plain output."""
    got = apply_rf_library(rf, rf_grid(x)).reshape(x.shape)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    if not rel <= LIBRARY_REL_TOL:
        raise AssertionError(f"grid_sample is not K1's function: rel err {rel:.3e}")
    return rel


def k1_bwd_library_error(x, rf, g, gx_plain, grf_ref) -> tuple:
    """(grf's and gx's max|err| / max|ref|, pixels left out of gx's) of
    K1-bwd's library route.  grf is held to the plain version in float64.
    gx is held to the f32 plain version away from the kinks of the lerp, where
    the two take different one-sided derivatives: y = (k-1) x within 1e-3 of
    an integer, x = 0 among them, and bins that grid_sample's rounding of
    2x - 1 moves."""
    b, k = rf.shape
    ggrid, grf = apply_rf_bwd_library(rf, rf_grid(x), g)
    grf_rel = ((grf.view(b, k) - grf_ref).abs().max() / grf_ref.abs().max()).item()
    y = x * (k - 1)
    away = (y - y.round()).abs() > 1e-3
    gx = 2 * ggrid[..., 0].reshape(x.shape)
    gx_rel = ((gx - gx_plain)[away].abs().max() / gx_plain.abs().max()).item()
    if not (grf_rel <= LIBRARY_REL_TOL and gx_rel <= LIBRARY_REL_TOL):
        raise AssertionError(f"grid_sample's backward is not K1-bwd's function: grf rel "
                             f"{grf_rel:.3e}, gx rel {gx_rel:.3e}")
    return grf_rel, gx_rel, int((~away).sum())


def lin_stem_features(x: torch.Tensor) -> torch.Tensor:
    """K3's 93-channel stack of x, SAME-padded for the 7x7/2 stem (the input
    of K3's library route, built beforehand)."""
    from singlehdr_tpu_torch.ops.histogram import linearization_features
    from singlehdr_tpu_torch.ops.resize import same_pads

    pt, pb = same_pads(x.shape[2], 7, 2)
    pl, pr = same_pads(x.shape[3], 7, 2)
    return torch.nn.functional.pad(linearization_features(x), (pl, pr, pt, pb))


def lin_stem_library(feats: torch.Tensor, k7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """K3's conv as one PyTorch call on the prebuilt stack: cuDNN's stride-2
    conv in the stack's dtype (f32 with TF32 off in phase 1, or bf16 with the
    bias in bf16), then ReLU."""
    return torch.relu(torch.nn.functional.conv2d(feats, k7, b7.to(feats.dtype), stride=2))


def k3_library_error(feats, k7, b7, want: torch.Tensor) -> float:
    """max|err| / max|plain| of K3's library route against K3's plain output
    (f32 within LIBRARY_REL_TOL; bf16 within KERNEL_BF16_REL_TOL: cuDNN rounds
    its bf16 output apart from the plain version's f32 sum)."""
    got = lin_stem_library(feats, k7, b7)
    rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    tol = KERNEL_BF16_REL_TOL if want.dtype == torch.bfloat16 else LIBRARY_REL_TOL
    if not rel <= tol:
        raise AssertionError(f"the conv over the prebuilt stack is not K3's function: rel {rel:.3e}")
    return rel


def plain_versions() -> dict:
    """{kernel name: (wrapper, plain version)} of K1-K4."""
    from singlehdr_tpu_torch.ops.cuda import apply_rf_cuda, enc_pool_cuda, lin_stem_cuda, unet_stage_cuda

    return {
        "apply_rf": (apply_rf_cuda.apply_rf, apply_rf_cuda.apply_rf_plain),
        "unet_stage2": (unet_stage_cuda.unet_stage2, unet_stage_cuda.unet_stage2_plain),
        "lin_feature_stem": (lin_stem_cuda.lin_feature_stem, lin_stem_cuda.lin_feature_stem_plain),
        "encoder_stage2": (enc_pool_cuda.encoder_stage2, enc_pool_cuda.encoder_stage2_plain),
    }


def compare_kernel(name: str, label: str, kernel, ref, args, dtype) -> tuple:
    """One case of a kernel against its plain version: K1 bit-equal, f32
    K2-K4 within KERNEL_REL_TOL of max|plain|, bf16 within
    KERNEL_BF16_REL_TOL with KERNEL_BF16_MIN_EQUAL of the outputs bit-equal;
    raises otherwise.  Returns (the plain outputs, max|err|, max|err| /
    max|plain|, the share of outputs bit-equal)."""
    got, want = kernel(*args), ref(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, w in zip(got, want):
        if a.shape != w.shape or a.dtype != w.dtype:
            raise AssertionError(f"{name} {label}: {tuple(a.shape)} {a.dtype} != "
                                 f"{tuple(w.shape)} {w.dtype}")
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} {label}: non-finite output")
        if not w.abs().max() > 0:
            raise AssertionError(f"{name} {label}: all-zero reference, nothing compared")
    abs_err = max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want))
    rel_err = max(((a.float() - w.float()).abs().max() / w.float().abs().max()).item()
                  for a, w in zip(got, want))
    equal = min((a == w).float().mean().item() for a, w in zip(got, want))
    if name == "apply_rf":
        if not all(torch.equal(a, w) for a, w in zip(got, want)):
            raise AssertionError(f"apply_rf {label}: not bit-equal (max err {abs_err})")
    elif dtype == torch.bfloat16:
        if not (rel_err <= KERNEL_BF16_REL_TOL and equal >= KERNEL_BF16_MIN_EQUAL):
            raise AssertionError(f"{name} bf16 {label}: rel err {rel_err:.3e} (bound "
                                 f"{KERNEL_BF16_REL_TOL:.3e}), {equal:.2%} equal (bound "
                                 f"{KERNEL_BF16_MIN_EQUAL:.0%})")
    elif not rel_err <= KERNEL_REL_TOL:
        raise AssertionError(f"{name} {label}: rel err {rel_err:.3e} > {KERNEL_REL_TOL}")
    return want, abs_err, rel_err, equal


def check_kernels(pipe, dev) -> dict:
    """Phase 3, both dtypes: the report is keyed by kernel name, with ``_bf16``
    after the bf16 kernels' names."""
    plain = plain_versions()
    report, main_path = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        suffix = "_bf16" if dtype == torch.bfloat16 else ""
        # made outside inference mode, so that the kernels' weight packing is
        # cached on the bf16 weights as it is on a net's (``cached_on``)
        with torch.no_grad():
            cases = kernel_cases(pipe, dev, dtype)
        with torch.inference_mode():
            for name, label, args in cases:
                kernel, ref = plain[name]
                want, abs_err, rel_err, equal = compare_kernel(name, label, kernel, ref, args, dtype)
                ms, plain_ms = device_ms(lambda: kernel(*args)), device_ms(lambda: ref(*args), 5)
                library = ""
                if name == "apply_rf":  # grid_sample, timed on a grid built beforehand
                    lib_rel = k1_library_error(*args, want[0])
                    grid = rf_grid(args[0])
                    lib_ms = device_ms(lambda: apply_rf_library(args[1], grid))
                    library = (f"  library (grid_sample) {lib_ms:.4f} ms, rel {lib_rel:.3e}; L2 flushed "
                               f"before each call: kernel {cold_l2_ms(lambda: kernel(*args)):.4f} ms, "
                               f"grid_sample {cold_l2_ms(lambda: apply_rf_library(args[1], grid)):.4f} ms")
                elif name == "lin_feature_stem":  # cuDNN's conv over the stack built beforehand
                    feats = lin_stem_features(args[0])
                    lib_rel = k3_library_error(feats, *args[1:], want[0])
                    lib_ms = device_ms(lambda: lin_stem_library(feats, *args[1:]), 5)
                    library = (f"  library (cuDNN conv on the prebuilt stack) {lib_ms:.3f} ms, "
                               f"rel {lib_rel:.3e}")
                    del feats
                elif dtype == torch.float32:
                    lib_ms = plain_ms  # K2, K4: the plain version is cuDNN's f32 convs + the pool
                else:  # K2, K4 in bf16: cuDNN's bf16 convs + the pool, in bf16
                    lib = conv_stage_library(name, *args)
                    lib_rel = max(((a.float() - w.float()).abs().max() / w.float().abs().max()).item()
                                  for a, w in zip(lib, want))
                    if not lib_rel <= KERNEL_BF16_REL_TOL:
                        raise AssertionError(f"{name} bf16 {label}: the library route is not its "
                                             f"function: rel {lib_rel:.3e}")
                    lib_ms = device_ms(lambda: conv_stage_library(name, *args), 5)
                    library = f"  library (cuDNN bf16 convs + pool) {lib_ms:.3f} ms, rel {lib_rel:.3e}"
                flop, moved = kernel_flop(name, args), nbytes(args) + nbytes(want)
                bound_ms, bound_by, simt_ms = bound(flop, moved, dtype)
                if dtype == torch.bfloat16 and name != "lin_feature_stem":
                    built_ms = two_launch_bound_ms(name, args, want, dtype)
                    other = f"as built, two launches {built_ms:.4f}"
                else:
                    other = f"f32 CUDA cores {simt_ms:.3f}"
                if dtype == torch.bfloat16:
                    library += f"; L2 flushed before each call: kernel {cold_l2_ms(lambda: kernel(*args)):.4f} ms"
                r = report.setdefault(name + suffix, {
                    "dtype": str(dtype).removeprefix("torch."), "max_abs_err": 0.0, "max_rel_err": 0.0,
                    "min_equal": 1.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_bound_ms": 0.0,
                    "simt_bound_ms": 0.0, "library_ms": 0.0})
                r["max_abs_err"] = max(r["max_abs_err"], abs_err)
                r["max_rel_err"] = max(r["max_rel_err"], rel_err)
                r["min_equal"] = min(r["min_equal"], equal)
                r["ms"] += ms
                r["plain_ms"] += plain_ms
                r["library_ms"] += lib_ms
                r["bound_ms"] += bound_ms
                r["ops_bound_ms"] += bound_ms if bound_by == "operations" else 0.0
                r["simt_bound_ms"] += simt_ms
                if "odd" not in label:
                    m = main_path.setdefault(name + suffix, [0.0, 0.0])
                    m[0] += ms
                    m[1] += bound_ms
                print(f"  {name + suffix:22s} {label:36s} max_abs_err {abs_err:.3e} rel {rel_err:.3e} "
                      f"equal {equal:.2%} kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  bound "
                      f"{bound_ms:.4f} ms ({bound_by}; {other})  share {bound_ms / ms:.1%}  "
                      f"{flop / 1e9:.1f} GFLOP {moved / 1e6:.1f} MB  {flop / ms / 1e9:.1f} TFLOP/s"
                      f"{library}", flush=True)
                if dtype == torch.bfloat16 and name in KERNEL_LAUNCHES_PER_STAGE:
                    for conv, fn, conv_flop, conv_moved in conv_launches(name, args):
                        conv_ms = device_ms(fn)
                        conv_bound = bound(conv_flop, conv_moved, dtype)[0]
                        print(f"    {label} {conv}: {conv_ms:.4f} ms  {conv_flop / conv_ms / 1e9:.1f} "
                              f"TFLOP/s  bound {conv_bound:.4f} ms  share {conv_bound / conv_ms:.1%}",
                              flush=True)
        torch.cuda.synchronize()
    # each (kernel, dtype) over its main-path cases (the odd shapes left out)
    for name, (ms, bound_ms) in main_path.items():
        print(f"  {name:22s} main path: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms, "
              f"{bound_ms / ms:.1%} of its bound", flush=True)
    return report


def jpeg_bodies(n: int) -> list:
    import cv2

    rs = np.random.RandomState(SEED)
    bodies = []
    for _ in range(n):
        img = (rs.rand(SERVE_HW, SERVE_HW, 3) * 255).astype(np.uint8)
        ok, buf = cv2.imencode(".jpg", img)
        if not ok:
            raise RuntimeError("JPEG encode failed")
        bodies.append(buf.tobytes())
    return bodies


def decode_hdr(body: bytes) -> np.ndarray:
    import cv2

    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise AssertionError("response is not a decodable Radiance image")
    return img[:, :, ::-1]


def serve_requests(predictor) -> tuple:
    """Phase 4: POST N_REQUESTS JPEGs from N_CLIENTS threads; returns (stats,
    launches by kernel and dtype)."""
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.serve import make_server

    server = make_server(predictor, "127.0.0.1", 0, max_batch=MAX_BATCH, batch_window_s=0.05)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    bodies = jpeg_bodies(N_REQUESTS)
    results, errors = [None] * N_REQUESTS, []
    start = threading.Barrier(N_CLIENTS)

    def client(k: int) -> None:
        try:
            start.wait(timeout=60)
            for i in range(k, N_REQUESTS, N_CLIENTS):
                req = urllib.request.Request(url + "/predict", data=bodies[i], method="POST")
                with urllib.request.urlopen(req, timeout=300) as r:
                    results[i] = (r.status, r.read())
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(repr(e))

    try:
        kernels.reset_launches()
        clients = [threading.Thread(target=client, args=(k,)) for k in range(N_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        torch.cuda.synchronize()
        launches = kernels.launch_counts_by_dtype()
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if errors or any(c.is_alive() for c in clients):
        raise AssertionError(f"client failures: {errors}")
    for i, (status, body) in enumerate(results):
        if status != 200:
            raise AssertionError(f"request {i}: HTTP {status}")
        hdr = decode_hdr(body)
        if hdr.shape != (SERVE_HW, SERVE_HW, 3) or not np.isfinite(hdr).all():
            raise AssertionError(f"request {i}: bad HDR {hdr.shape}")
    print(f"  {N_REQUESTS} x HTTP 200, HDR {SERVE_HW}x{SERVE_HW}x3 finite; "
          f"device_batches {stats['device_batches']} max_batch {stats['max_batch']} "
          f"p50 {stats['latency'].get('p50_s')} s", flush=True)
    if stats["max_batch"] < 2:
        raise AssertionError("no request batch larger than 1")
    return stats, launches


def check_launches(stats: dict, launches: dict, dtype) -> None:
    """Phase 6: per batch K1 x1 in f32 and K2 x6, K3 x1, K4 x2 in the
    pipeline's compute dtype, none of them in the other dtype."""
    batches = stats["device_batches"]
    name_of = str(dtype).removeprefix("torch.")
    print(f"  {name_of} pipeline: launches {launches} over {batches} device batches", flush=True)
    for name, per in PER_BATCH.items():
        want = "float32" if name == "apply_rf" else name_of
        counts = dict(launches[name])
        if counts.pop(want, 0) != per * batches or any(counts.values()):
            raise AssertionError(f"{name}: launches {launches[name]}, expected {per} x {batches} "
                                 f"batches in {want} and none in another dtype")


def path_parity(pipe) -> tuple:
    """Phase 5 (f32): the served output of one image on the card vs the CPU
    plain path; returns (the image, the CPU f32 output, the CPU pipeline, the
    card's f32 output)."""
    from singlehdr_tpu_torch.inference import HdrPredictor
    from singlehdr_tpu_torch.models import ReverseCameraPipeline

    cpu_pipe = ReverseCameraPipeline()
    cpu_pipe.load_state_dict({k: v.cpu() for k, v in pipe.state_dict().items()})
    img = np.random.RandomState(SEED + 1).rand(SERVE_HW, SERVE_HW, 3).astype(np.float32)
    t0 = time.perf_counter()
    want = HdrPredictor(cpu_pipe.eval())(img)
    cpu_s = time.perf_counter() - t0
    got = HdrPredictor(pipe)(img)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"bad served output {got.shape}")
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"  f32: card vs CPU plain: max_abs_err {np.abs(got - want).max():.3e} "
          f"max|ref| {np.abs(want).max():.4f} rel {rel:.3e} (bound {PATH_REL_TOL}); "
          f"CPU forward {cpu_s:.1f} s", flush=True)
    if not rel <= PATH_REL_TOL:
        raise AssertionError(f"served path differs from the CPU plain path: rel {rel:.3e}")
    return img, want, cpu_pipe, got


def psnr_db(got: np.ndarray, ref: np.ndarray) -> float:
    """PSNR of ``got`` against ``ref`` with max|ref| as the peak."""
    return float(10 * np.log10(np.abs(ref).max() ** 2 / np.mean((got - ref) ** 2)))


def path_parity_bf16(pipe16, img, want_f32, cpu_pipe, got_f32) -> dict:
    """Phase 5 (bf16): the card's bf16 output of phase 5's image against the
    CPU f32 output (PSNR, peak max|ref|), and, at 1 x PATH_BF16_HW^2, the
    card's bf16 path against the CPU bf16 plain path (the same rounding
    rules, with cuDNN's and the CPU's bf16 convs rounding apart)."""
    from singlehdr_tpu_torch.inference import HdrPredictor
    from singlehdr_tpu_torch.models import ReverseCameraPipeline

    got = HdrPredictor(pipe16)(img)
    if got.shape != want_f32.shape or not np.isfinite(got).all() or got.dtype != np.float32:
        raise AssertionError(f"bad bf16 served output {got.shape} {got.dtype}")
    db = psnr_db(got, want_f32)
    f32_db = psnr_db(got_f32, want_f32)
    print(f"  bf16: card vs CPU f32 path, {SERVE_HW}^2: PSNR {db:.2f} dB (bound >= "
          f"{PATH_BF16_MIN_PSNR_DB} dB; the card's f32 path {f32_db:.2f} dB); max_abs_err "
          f"{np.abs(got - want_f32).max():.3e} max|ref| {np.abs(want_f32).max():.4f}", flush=True)
    if not db >= PATH_BF16_MIN_PSNR_DB:
        raise AssertionError(f"bf16 served path PSNR {db:.2f} dB < {PATH_BF16_MIN_PSNR_DB} dB")
    cpu16 = ReverseCameraPipeline(torch.bfloat16)
    cpu16.load_state_dict(cpu_pipe.state_dict())
    small = np.random.RandomState(SEED + 5).rand(PATH_BF16_HW, PATH_BF16_HW, 3).astype(np.float32)
    t0 = time.perf_counter()
    want16 = HdrPredictor(cpu16.eval())(small)
    cpu_s = time.perf_counter() - t0
    got16 = HdrPredictor(pipe16)(small)
    rel = float(np.abs(got16 - want16).max() / np.abs(want16).max())
    print(f"  bf16: card vs CPU bf16 plain path, 1 x {PATH_BF16_HW}^2: max_abs_err "
          f"{np.abs(got16 - want16).max():.3e} max|ref| {np.abs(want16).max():.4f} rel {rel:.3e} "
          f"(bound {PATH_BF16_REL_TOL}), PSNR {psnr_db(got16, want16):.2f} dB; CPU forward "
          f"{cpu_s:.1f} s", flush=True)
    if not rel <= PATH_BF16_REL_TOL:
        raise AssertionError(f"bf16 served path differs from the CPU bf16 plain path: rel {rel:.3e}")
    return {"psnr_db_vs_cpu_f32": db, "rel_vs_cpu_bf16": rel}


def timings(predictor, pipe, card: str) -> dict:
    """Phase 7 for one pipeline (its compute dtype in the lines)."""
    label = str(pipe.dtype).removeprefix("torch.")
    out = {}
    rs = np.random.RandomState(SEED + 2)
    imgs = [rs.rand(SERVE_HW, SERVE_HW, 3).astype(np.float32) for _ in range(MAX_BATCH)]
    for n, reps in ((1, 20), (MAX_BATCH, 8)):
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            predictor.predict_batch(imgs[:n])
            lat.append(time.perf_counter() - t0)
        p50 = float(np.median(lat))
        out[f"b{n}_p50_ms"] = p50 * 1e3
        print(f"  {label} b{n} @ {SERVE_HW}^2: p50 {p50 * 1e3:.1f} ms/request batch, "
              f"{n / p50:.2f} img/s  [{card}]", flush=True)
    # per-net device times at batch MAX_BATCH (576^2 after the pad)
    hw = SERVE_HW + 64
    x = torch.rand(MAX_BATCH, 3, hw, hw, device=pipe.deq.unet.stem1.weight.device)
    from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf

    with torch.inference_mode():
        c = pipe.deq(x).clamp(0, 1)
        invcrf = pipe.lin(c)
        bp = apply_rf(c, invcrf)
        abc = torch.cat([bp, bp, c], dim=1)
        nets = {
            "deq": lambda: pipe.deq(x),
            "lin": lambda: pipe.lin(c),
            "apply_rf": lambda: apply_rf(c, invcrf),
            "hal": lambda: pipe.hal(bp),
            "ref": lambda: pipe.ref(abc),
            "pipeline": lambda: pipe(x),
        }
        per_net = {k: cuda_ms(f, 3) for k, f in nets.items()}
    print("  %s per-net ms at b%d: %s  [%s]" % (
        label, MAX_BATCH, ", ".join(f"{k} {v:.2f}" for k, v in per_net.items()), card), flush=True)
    out["per_net_ms"] = per_net
    return out


def k1_bwd_inputs(dev, b: int, n: int, seed: int):
    """x with values below 0 and above 1, exact 0.0 and 1.0 (the saturated
    pixels of an LDR), and values on bin edges; a monotone curve; seeded g."""
    from singlehdr_tpu_torch.ops.curves import monotonic_rf

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(b, n, generator=g, device=dev) * 1.4 - 0.2
    x[:, : n // 5] = 1.0
    x[:, n // 5: n // 4] = 0.0
    edges = torch.randint(0, 1024, (b, n // 20), generator=g, device=dev).float() / 1023.0
    x[:, n // 4: n // 4 + n // 20] = edges
    rf = monotonic_rf(torch.rand(b, 1024, generator=g, device=dev)).contiguous()
    return x.contiguous(), rf, torch.randn(b, n, generator=g, device=dev)


def check_k1_bwd(dev) -> dict:
    """Phase 8: K1-bwd vs apply_rf_bwd_plain at the training and serving
    shapes, and on an all-saturated input (every x = 1.0) at the training
    shape: gx bit-equal, grf within BWD_REL_TOL of the plain version in
    float64 and bit-identical across launches (and with or without gx);
    times warm and with the L2 flushed, beside the bound.  The report sums
    the two shapes; the saturated case is printed only."""
    from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import BWD_MAX_BINS, apply_rf_bwd, apply_rf_bwd_plain

    report = {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "bound_ms": 0.0, "ops_bound_ms": 0.0, "rf_only_ms": None, "rf_only_plain_ms": None}
    cases = [(f"[{b}, {n}]", k1_bwd_inputs(dev, b, n, SEED + i)) for i, (b, n) in enumerate(BWD_SHAPES)]
    b, n = BWD_SHAPES[0]
    x, rf, g = k1_bwd_inputs(dev, b, n, SEED + len(BWD_SHAPES))
    cases.append((f"[{b}, {n}] every x = 1.0", (x.fill_(1.0), rf, g)))
    for i, (label, (x, rf, g)) in enumerate(cases):
        gx, grf = apply_rf_bwd(x, rf, g, True, True)
        _, grf_again = apply_rf_bwd(x, rf, g, True, True)
        only_gx, only_grf = apply_rf_bwd(x, rf, g, False, True)
        gx_alone, no_grf = apply_rf_bwd(x, rf, g, True, False)
        pgx, pgrf = apply_rf_bwd_plain(x, rf, g, True, True)
        # the curve gradient sums ~n/5 terms into the saturated bin; both f32
        # versions round that sum in their own order, so grf is held to the
        # plain version evaluated in float64
        _, ref = apply_rf_bwd_plain(x.double(), rf.double(), g.double(), False, True)
        torch.cuda.synchronize()
        if not (torch.equal(gx, pgx) and torch.equal(gx_alone, pgx)):
            raise AssertionError(f"apply_rf_bwd {label}: gx not bit-equal "
                                 f"(max err {(gx - pgx).abs().max().item():.3e})")
        if only_gx is not None or no_grf is not None:
            raise AssertionError("apply_rf_bwd: a gradient produced that was not asked for")
        scale = ref.abs().max().item()
        if not (scale > 0 and torch.isfinite(grf).all()):
            raise AssertionError(f"apply_rf_bwd {label}: bad curve gradient")
        if not (torch.equal(grf, grf_again) and torch.equal(grf, only_grf)):
            raise AssertionError(f"apply_rf_bwd {label}: grf differs between launches on the same "
                                 f"input (max {(grf - grf_again).abs().max().item():.3e}, grf only "
                                 f"{(grf - only_grf).abs().max().item():.3e})")
        abs_err = (grf - ref).abs().max().item()
        rel_err = abs_err / scale
        plain_rel = (pgrf - ref).abs().max().item() / scale
        if not rel_err <= BWD_REL_TOL:
            raise AssertionError(f"apply_rf_bwd {label}: grf rel err {rel_err:.3e} > {BWD_REL_TOL}")
        ms = device_ms(lambda: apply_rf_bwd(x, rf, g, True, True))
        cold_ms = cold_l2_ms(lambda: apply_rf_bwd(x, rf, g, True, True))
        plain_ms = device_ms(lambda: apply_rf_bwd_plain(x, rf, g, True, True), 5)
        rf_ms = device_ms(lambda: apply_rf_bwd(x, rf, g, False, True))
        rf_cold_ms = cold_l2_ms(lambda: apply_rf_bwd(x, rf, g, False, True))
        rf_plain_ms = device_ms(lambda: apply_rf_bwd_plain(x, rf, g, False, True), 5)
        bound_ms, _, _ = bound(0.0, nbytes((x, rf, g, pgx, pgrf)))
        rf_bound_ms, _, _ = bound(0.0, nbytes((x, rf, g, pgrf)))  # 8 bytes a pixel
        library = ""
        if i < len(BWD_SHAPES):
            # every pixel of the saturated case sits on a kink of the lerp,
            # where grid_sample's backward takes the other one-sided gx
            lib_grf_rel, lib_gx_rel, kinks = k1_bwd_library_error(x, rf, g, pgx, ref)
            grid = rf_grid(x)
            lib_ms = device_ms(lambda: apply_rf_bwd_library(rf, grid, g), 5)
            library = (f"; library (grid_sample's backward) {lib_ms:.3f} ms, grf rel {lib_grf_rel:.3e}, "
                       f"gx rel {lib_gx_rel:.3e} off {kinks} kink pixels")
            report["max_abs_err"] = max(report["max_abs_err"], abs_err)
            report["max_rel_err"] = max(report["max_rel_err"], rel_err)
            report["ms"] += ms
            report["plain_ms"] += plain_ms
            report["library_ms"] += lib_ms
            report["bound_ms"] += bound_ms
            if i == 0:  # the joint step's case: x = ldr needs no gradient
                report["rf_only_ms"], report["rf_only_plain_ms"] = rf_ms, rf_plain_ms
        print(f"  apply_rf_bwd {label}: gx bit-equal; grf the same bits on 3 launches; grf vs float64 "
              f"plain: max_abs_err {abs_err:.3e} rel {rel_err:.3e} (f32 plain: rel {plain_rel:.3e}; "
              f"max|grf| {scale:.1f}); gx+grf: kernel {ms:.4f} ms, L2 flushed {cold_ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes), share {bound_ms / ms:.1%} "
              f"(flushed {bound_ms / cold_ms:.1%}); grf only: kernel {rf_ms:.4f} ms, flushed "
              f"{rf_cold_ms:.4f} ms, plain {rf_plain_ms:.3f} ms, bound {rf_bound_ms:.4f} ms, share "
              f"{rf_bound_ms / rf_ms:.1%} (flushed {rf_bound_ms / rf_cold_ms:.1%}){library}", flush=True)
    # a curve longer than the kernel's shared-memory plan raises, on the card
    x = torch.zeros(1, 64, device=dev)
    try:
        apply_rf_bwd(x, torch.zeros(1, BWD_MAX_BINS + 1, device=dev), x, True, True)
    except ValueError as e:
        print(f"  k = {BWD_MAX_BINS + 1} raises: {e}", flush=True)
    else:
        raise AssertionError(f"apply_rf_bwd took a curve of {BWD_MAX_BINS + 1} samples")
    return report


def write_hdr_files(root: str, n: int = 4) -> None:
    """Seeded smooth radiance maps, 512 x 768 (short side 512), as .hdr files."""
    import cv2

    rs = np.random.RandomState(SEED)
    for i in range(n):
        coarse = (rs.rand(32, 48, 3).astype(np.float32) * 4) ** 2
        rgb = np.kron(coarse, np.ones((16, 16, 1), np.float32))
        path = os.path.join(root, f"synth{i:02d}.hdr")
        if not cv2.imwrite(path, np.ascontiguousarray(rgb[:, :, ::-1])):  # cv2 writes BGR
            raise RuntimeError(f"failed to write {path}")


def logged_losses(root: str, tag: str) -> list:
    losses = []
    for dirpath, _, files in os.walk(os.path.join(root, "tensorboard")):
        if "events.jsonl" in files:
            with open(os.path.join(dirpath, "events.jsonl")) as f:
                losses += [json.loads(line)[tag] for line in f if tag in line]
    return losses


def check_train_launches(counts: dict, steps: int, label: str) -> None:
    print(f"  {label}: launches {counts} over {steps} steps", flush=True)
    if counts["apply_rf_bwd"] != steps:
        raise AssertionError(f"{label}: K1-bwd launched {counts['apply_rf_bwd']} times, "
                             f"expected once per step ({steps})")
    if counts["apply_rf"] < 2 * steps:  # lin's B_pred and the capture's CRF, per step
        raise AssertionError(f"{label}: K1 launched {counts['apply_rf']} times for {steps} steps")
    for name in ("unet_stage2", "lin_feature_stem", "encoder_stage2"):
        if counts[name]:
            raise AssertionError(f"{label}: {name} launched in train mode")


def _add_counts(total: dict, by_dtype: dict) -> None:
    for name, counts in by_dtype.items():
        for dtype, n in counts.items():
            total.setdefault(name, {}).setdefault(dtype, 0)
            total[name][dtype] += n


def joint_training(card: str, root: str) -> dict:
    """Phase 9: the joint configuration through cli.joint_train.run, then a
    resume, then one cli.train --lin step, then the joint configuration with
    ``--dtype bfloat16``, under ``root`` (phase 12 reads its .hdr files,
    ``root/hdr``, and its f32 joint checkpoint, ``root/checkpoints/jnt``).
    Returns the summed launch counts by kernel and dtype."""
    from singlehdr_tpu_torch.cli import joint_train, train
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.train.checkpoint import CheckpointManager

    cwd = os.getcwd()
    total = {name: {} for name in kernels.KERNELS}
    try:
        data = os.path.join(root, "hdr")
        os.makedirs(data)
        write_hdr_files(data)
        os.chdir(root)  # the CLIs write their run directories under the cwd
        ck = {n: os.path.join(root, "checkpoints", n) for n in ("deq", "lin", "hal", "jnt")}
        base = ["--dir", data, "--batch_size", str(TRAIN_BATCH), "--patch_size", str(TRAIN_HW),
                "--ckpt_every", "3", "--log_every", "1", "--workers", "8",
                "--deq_ckpt", ck["deq"], "--lin_ckpt", ck["lin"], "--hal_ckpt", ck["hal"],
                "--jnt_ckpt", ck["jnt"]]
        for iterations, start in JOINT_RUNS:
            kernels.reset_launches()
            t0 = time.perf_counter()
            state = joint_train.run(joint_train.build_parser().parse_args(
                base + ["--iterations", str(iterations)]))
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            if state.step != iterations:
                raise AssertionError(f"joint run ended at step {state.step}, not {iterations}")
            check_train_launches(counts, iterations - start, f"joint steps {start}->{iterations}")
            _add_counts(total, kernels.launch_counts_by_dtype())
            print(f"  joint_train.run to step {iterations} (from {start}): "
                  f"{time.perf_counter() - t0:.1f} s wall incl. set-up  [{card}]", flush=True)
        saved = CheckpointManager(ck["jnt"]).steps()
        if not {3, 6, 8} <= set(saved):
            raise AssertionError(f"joint checkpoints {saved}, expected 3, 6 and 8")
        losses = logged_losses(root, "jnt/loss")
        if len(losses) != 8 or not np.isfinite(losses).all():
            raise AssertionError(f"joint losses logged: {losses}")
        print(f"  checkpoints at steps {saved}; losses {[round(v, 4) for v in losses]}", flush=True)

        kernels.reset_launches()
        train.run(train.build_parser().parse_args(
            ["--hdrdir", data, "--lin", "true", "--lin_ckpt", ck["lin"], "--iterations", "1",
             "--batch_size", str(TRAIN_BATCH), "--patch_size", str(TRAIN_HW), "--workers", "8"]))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check_train_launches(counts, 1, "train --lin step")
        _add_counts(total, kernels.launch_counts_by_dtype())
        lin_losses = logged_losses(root, "lin/loss")
        if CheckpointManager(ck["lin"]).steps() != [1] or not np.isfinite(lin_losses).all():
            raise AssertionError(f"lin run: checkpoints {CheckpointManager(ck['lin']).steps()}, "
                                 f"losses {lin_losses}")

        # the joint configuration in bf16, from the same pretrained nets, in a
        # run directory of its own
        bf16_root = os.path.join(root, "bf16")
        os.makedirs(bf16_root)
        os.chdir(bf16_root)
        kernels.reset_launches()
        t0 = time.perf_counter()
        args = base[:-1] + [os.path.join(bf16_root, "jnt"), "--iterations", str(BF16_JOINT_STEPS),
                            "--dtype", "bfloat16"]
        state = joint_train.run(joint_train.build_parser().parse_args(args))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        if state.step != BF16_JOINT_STEPS or state.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 joint run: step {state.step}, dtype {state.dtype}")
        check_train_launches(counts, BF16_JOINT_STEPS, "bf16 joint steps")
        _add_counts(total, kernels.launch_counts_by_dtype())
        losses = logged_losses(bf16_root, "jnt/loss")
        if len(losses) != BF16_JOINT_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"bf16 joint losses logged: {losses}")
        print(f"  joint_train.run --dtype bfloat16, {BF16_JOINT_STEPS} steps: "
              f"{time.perf_counter() - t0:.1f} s wall incl. set-up; losses "
              f"{[round(v, 4) for v in losses]}; launches by dtype "
              f"{kernels.launch_counts_by_dtype()}  [{card}]", flush=True)
    finally:
        os.chdir(cwd)
    return total


def joint_batch(dev, b: int, hw: int, seed: int) -> list:
    """Seeded inputs of the joint step: ldr, jpeg, clipped_hdr_t, hdr_t, mask, invcrf."""
    from singlehdr_tpu_torch.ops.curves import monotonic_rf

    g = torch.Generator().manual_seed(seed)
    ldr = torch.rand(b, 3, hw, hw, generator=g)
    jpeg = (ldr + 0.02 * torch.randn(b, 3, hw, hw, generator=g)).clamp(0, 1)
    clipped = torch.rand(b, 3, hw, hw, generator=g)
    hdr_t = clipped * (1 + torch.rand(b, 1, 1, 1, generator=g))
    invcrf = monotonic_rf(torch.rand(b, 1024, generator=g))
    return [t.to(dev) for t in (ldr, jpeg, clipped, hdr_t, torch.ones(b, 1, 1, 1), invcrf)]


def step_parity(dev) -> tuple:
    """Phase 10: one joint step on the card vs the same step on the CPU, then
    one finetune step on the card.  Returns the CPU f32 and CPU bf16 joint
    steps' gradients (float64 CPU tensors by name), phase 14's references."""
    from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.train import steps
    from singlehdr_tpu_torch.train.state import init_multi_state

    grads, stats, losses = {}, {}, {}
    for label, where in (("cpu", "cpu"), ("card", dev)):
        state = init_multi_state(("deq", "lin", "hal"), 1e-5, seed=SEED, device=where)
        losses[label], _ = steps.make_joint_train_step(Vgg16Features().to(where))(
            state, *joint_batch(where, 2, 64, SEED))
        grads[label] = {n: p.grad.double().cpu() for n, p in state.nets.named_parameters()}
        stats[label] = {n: b.double().cpu() for n, b in state.nets.named_buffers()
                        if n.endswith(("running_mean", "running_var"))}
    torch.cuda.synchronize()
    card, cpu = grads["card"], grads["cpu"]
    loss_rel = abs(losses["card"].item() - losses["cpu"].item()) / abs(losses["cpu"].item())
    stats_rel = max(((stats["card"][n] - b).abs().max() / b.abs().max()).item()
                    for n, b in stats["cpu"].items())

    net_max = {}
    for name, g in cpu.items():
        net = name.split(".")[0]
        net_max[net] = max(net_max.get(net, 0.0), g.abs().max().item())
    own = {name: g.abs().max().item() for name, g in cpu.items()}
    bound = {name: STEP_GRAD_OWN_TOL * own[name] + STEP_GRAD_NET_TOL * net_max[name.split(".")[0]]
             for name in cpu}

    def excess(name: str, got: torch.Tensor) -> float:
        """max|got - g_cpu| of one tensor over its bound; > 1 fails."""
        return (got - cpu[name]).abs().max().item() / bound[name]

    ratio = {name: excess(name, g) for name, g in card.items()}
    failures = [f"{name}: non-finite" for name, g in card.items() if not torch.isfinite(g).all()]
    failures += [f"{name}: max|dg| {r * bound[name]:.3e} > bound {bound[name]:.3e}"
                 for name, r in ratio.items() if not r <= 1]
    print(f"  joint step 2x64^2, card vs CPU: loss rel {loss_rel:.3e} (bound {STEP_LOSS_REL_TOL}); "
          f"BN stats rel {stats_rel:.3e} (bound {STEP_STATS_REL_TOL}); gradients vs bound "
          f"{STEP_GRAD_OWN_TOL} own max + {STEP_GRAD_NET_TOL} net max, worst:", flush=True)
    for name in sorted(ratio, key=ratio.get, reverse=True)[:4]:
        err = ratio[name] * bound[name]
        net = net_max[name.split(".")[0]]
        print(f"    {name}: {ratio[name]:.3f} of bound; max|dg| {err:.3e} = {err / own[name]:.3e} own "
              f"max = {err / net:.3e} net max; own max {own[name] / net:.3e} net max", flush=True)
    for net in sorted(net_max):
        worst = max((r * bound[n] for n, r in ratio.items() if n.startswith(net + ".")))
        print(f"    {net}: worst max|dg| / net max {worst / net_max[net]:.3e}", flush=True)
    if not loss_rel <= STEP_LOSS_REL_TOL:
        raise AssertionError(f"joint step loss differs from the CPU step: rel {loss_rel:.3e}")
    if failures:
        raise AssertionError("joint step gradients differ from the CPU step:\n  " + "\n  ".join(failures))
    if not stats_rel <= STEP_STATS_REL_TOL:
        raise AssertionError(f"joint step BN statistics differ from the CPU step: rel {stats_rel:.3e}")

    # planted faults on the card's gradients: the bound must separate them
    planted = {(name, fault): excess(name, bad) for name, g in card.items()
               for fault, bad in (("zeroed", torch.zeros_like(g)), ("sign-flipped", -g))}
    missed = sorted({name for (name, _), r in planted.items() if not r > 1},
                    key=lambda n: own[n] / net_max[n.split(".")[0]])
    for name in PLANTED_FAULTS:
        print(f"    planted: {name} (own max {own[name] / net_max[name.split('.')[0]]:.3e} net max) "
              f"zeroed {planted[name, 'zeroed']:.1f}x bound, sign-flipped "
              f"{planted[name, 'sign-flipped']:.1f}x bound", flush=True)
        if not (planted[name, "zeroed"] > 1 and planted[name, "sign-flipped"] > 1):
            raise AssertionError(f"the gradient bound does not flag a planted fault in {name}")
    print(f"    both faults are flagged in {len(card) - len(missed)} of "
          f"{len(card)} tensors; not in {len(missed)}, whose own max is at most "
          f"{max((own[n] / net_max[n.split('.')[0]] for n in missed), default=0):.2e} of "
          f"their net's: {', '.join(missed)}", flush=True)

    cpu16 = bf16_step_parity(dev, cpu)

    state = init_multi_state(("deq", "lin", "hal", "ref"), 1e-5, seed=SEED, device=dev)
    g = torch.Generator().manual_seed(SEED + 3)
    ldr = torch.rand(4, 3, TRAIN_HW, TRAIN_HW, generator=g).to(dev)
    hdr = (2 * torch.rand(4, 3, TRAIN_HW, TRAIN_HW, generator=g)).to(dev)
    kernels.reset_launches()
    loss, _ = steps.make_finetune_train_step()(state, ldr, hdr)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    deq_grads = [p.grad for p in state.nets["deq"].parameters()]
    if counts["apply_rf_bwd"] != 1 or not torch.isfinite(loss):
        raise AssertionError(f"finetune step: loss {loss.item()}, launches {counts}")
    if not all(torch.isfinite(gr).all() for gr in deq_grads) or not any(gr.abs().max() > 0 for gr in deq_grads):
        raise AssertionError("finetune step: the gradient reaching deq is not finite and non-zero")
    print(f"  finetune step 4x{TRAIN_HW}^2 on the card: loss {loss.item():.2f}, deq max|g| "
          f"{max(gr.abs().max().item() for gr in deq_grads):.3e}, launches {counts}", flush=True)
    return cpu, cpu16


def net_distance(d: dict, ref: dict, net: str) -> tuple:
    """(|d - ref| / |ref|, cos(d, ref)) over one net's gradient tensors."""
    keys = [k for k in ref if k.startswith(net + ".")]
    norm = sum(float((ref[k] ** 2).sum()) for k in keys) ** 0.5
    own = sum(float((d[k] ** 2).sum()) for k in keys) ** 0.5
    dist = sum(float(((d[k] - ref[k]) ** 2).sum()) for k in keys) ** 0.5 / norm
    dot = sum(float((d[k] * ref[k]).sum()) for k in keys)
    return dist, dot / (own * norm) if own > 0 else 0.0


def bf16_net_failures(net: str, got: dict, ref: dict, cpu16: dict) -> list:
    """The phase-10 bf16 bounds that one net's card gradients ``got`` break,
    against the CPU f32 gradients ``ref`` and the CPU bf16 ones ``cpu16``."""
    dist, cos = net_distance(got, ref, net)
    if net == "deq":
        return [] if dist <= BF16_STEP_DEQ_TOL else [f"deq: distance {dist:.4f}"]
    cpu_dist, cpu_cos = net_distance(cpu16, ref, net)
    out = []
    if not dist <= BF16_STEP_NOISE_FACTOR * cpu_dist + 0.02:
        out.append(f"{net}: distance {dist:.3f}, the CPU bf16 step's {cpu_dist:.3f}")
    if not cos >= max(BF16_STEP_COS_MIN, cpu_cos - BF16_STEP_COS_SLACK):
        out.append(f"{net}: cosine {cos:.3f}, the CPU bf16 step's {cpu_cos:.3f}")
    return out


def bf16_step_parity(dev, ref: dict) -> dict:
    """Phase 10, bf16: one joint step on the card and on the CPU in bf16, from
    phase 10's weights and batch, each net's gradients held to the CPU f32
    step's ``ref`` (float64 CPU tensors) by ``bf16_net_failures``.  Returns
    the CPU bf16 step's gradients."""
    from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
    from singlehdr_tpu_torch.train import steps
    from singlehdr_tpu_torch.train.state import init_multi_state

    grads, losses = {}, {}
    for label, where in (("cpu", "cpu"), ("card", dev)):
        state = init_multi_state(("deq", "lin", "hal"), 1e-5, seed=SEED, device=where,
                                 dtype=torch.bfloat16)
        losses[label], _ = steps.make_joint_train_step(Vgg16Features().to(where), torch.bfloat16)(
            state, *joint_batch(where, 2, 64, SEED))
        grads[label] = {n: p.grad.double().cpu() for n, p in state.nets.named_parameters()}
    card, cpu16 = grads["card"], grads["cpu"]
    loss_rel = abs(losses["card"].item() - losses["cpu"].item()) / abs(losses["cpu"].item())
    report = []
    for net in ("deq", "lin", "hal"):
        (dist, cos), (cpu_dist, cpu_cos) = net_distance(card, ref, net), net_distance(cpu16, ref, net)
        report.append(f"{net} {dist:.4f} (cos {cos:.3f}) / {cpu_dist:.4f} (cos {cpu_cos:.3f})")
    print(f"  bf16 joint step 2x64^2: loss card vs CPU bf16 rel {loss_rel:.3e} (bound "
          f"{BF16_STEP_LOSS_REL_TOL}); gradients' distance from the CPU f32 step's, card / CPU "
          f"bf16: {'; '.join(report)}", flush=True)
    failures = [f"{name}: non-finite" for name, g in card.items() if not torch.isfinite(g).all()]
    if not loss_rel <= BF16_STEP_LOSS_REL_TOL:
        failures.append(f"loss differs from the CPU bf16 step: rel {loss_rel:.3e}")
    for net in ("deq", "lin", "hal"):
        failures += bf16_net_failures(net, card, ref, cpu16)
        for fault, sign in (("zeroed", 0.0), ("sign-flipped", -1.0)):
            planted = {k: sign * g if k.startswith(net + ".") else g for k, g in card.items()}
            if not bf16_net_failures(net, planted, ref, cpu16):
                failures.append(f"{net}: a {fault} gradient passes the bf16 bounds")
    if failures:
        raise AssertionError("bf16 joint step:\n  " + "\n  ".join(failures))
    return cpu16


def train_timings(dev, card: str, bwd_report: dict, dtype=torch.float32) -> float:
    """Phase 11: the joint step at batch 16, 256^2, with the nets computing in
    ``dtype`` (the VGG of the perceptual loss f32, as in the CLI), split with
    CUDA events; returns the median step's device ms."""
    from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
    from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf_bwd
    from singlehdr_tpu_torch.train import steps
    from singlehdr_tpu_torch.train.state import init_multi_state

    state = init_multi_state(("deq", "lin", "hal"), 1e-5, seed=SEED, device=dev, dtype=dtype)
    vgg = Vgg16Features().to(dev)
    batch = joint_batch(dev, TRAIN_BATCH, TRAIN_HW, SEED + 4)
    state.nets.train()
    torch.cuda.reset_peak_memory_stats(dev)
    rows = []
    for i in range(2 + 7):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        loss, _ = steps.joint_loss(state.nets, vgg, *batch)
        ev[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        state.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if i >= 2:
            rows.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                         ev[2].elapsed_time(ev[3]), ev[0].elapsed_time(ev[3]), wall))
        if not torch.isfinite(loss):
            raise AssertionError(f"timing step {i}: loss {loss.item()}")
    fwd, bwd, opt, total, wall = (float(np.median(c)) for c in zip(*rows))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # K1-bwd as the joint step calls it (curve gradient only, x = this batch's
    # ldr), and on phase 8's input, 20 % of whose pixels sit in the hot bin 1023
    ldr, invcrf = batch[0].reshape(TRAIN_BATCH, -1), batch[5].contiguous()
    g = torch.randn_like(ldr)
    step_bwd_ms = device_ms(lambda: apply_rf_bwd(ldr, invcrf, g, False, True))
    hot_bwd_ms = bwd_report["rf_only_ms"]
    print(f"  joint step b{TRAIN_BATCH} @ {TRAIN_HW}^2 {str(dtype).removeprefix('torch.')}, median of "
          f"{len(rows)}: {total:.2f} ms device "
          f"({wall:.2f} ms wall), {TRAIN_BATCH / total * 1e3:.2f} img/s; forward+loss {fwd:.2f} ms, "
          f"backward {bwd:.2f} ms, optimizer.step {opt:.2f} ms; peak memory {peak:.2f} GiB; "
          f"K1-bwd on this step's ldr {step_bwd_ms:.4f} ms = {100 * step_bwd_ms / total:.4f} % of the "
          f"step, on phase 8's saturated input {hot_bwd_ms:.4f} ms = {100 * hot_bwd_ms / total:.4f} %  "
          f"[{card}]", flush=True)
    return total


def radiance_map(rs, h: int, w: int) -> np.ndarray:
    """A seeded radiance map: a smooth field of 32 px cells (cubic), mean
    near 1, with 20 % fine texture."""
    import cv2

    coarse = (rs.rand(h // 32 + 1, w // 32 + 1, 3).astype(np.float32) * 2) ** 2
    hdr = np.clip(cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC), 0.01, None)
    return hdr * (1 + 0.2 * rs.rand(h, w, 3).astype(np.float32))


def camera_ldr(hdr: np.ndarray) -> np.ndarray:
    """The 8-bit LDR of a radiance map: exposed to twice its mean, a gamma
    1/2.2 curve, levels 12..242 (no patch is over- or under-exposed)."""
    x = np.clip(hdr / (2.0 * hdr.mean()), 0.0, 1.0) ** (1 / 2.2)
    return np.round(12 + 230 * x).astype(np.uint8)


def write_real_pairs(root: str, n: int = REAL_PAIRS) -> None:
    """A paired HDR-Real stand-in: ``HDR_gt/*.hdr`` and their ``LDR_in/*.jpg``
    (``camera_ldr``, JPEG quality 95), REAL_HW each, written with cv2."""
    import cv2

    rs = np.random.RandomState(SEED + 20)
    for sub in ("HDR_gt", "LDR_in"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        hdr = radiance_map(rs, *REAL_HW)
        ok = cv2.imwrite(os.path.join(root, "HDR_gt", f"real{i:02d}.hdr"),
                         np.ascontiguousarray(hdr[:, :, ::-1]))
        ok &= cv2.imwrite(os.path.join(root, "LDR_in", f"real{i:02d}.jpg"),
                          np.ascontiguousarray(camera_ldr(hdr)[:, :, ::-1]),
                          [cv2.IMWRITE_JPEG_QUALITY, 95])
        if not ok:
            raise RuntimeError(f"failed to write pair {i} under {root}")


def write_photos(root: str, n: int = N_PHOTOS) -> list:
    """``n`` seeded PHOTO_HW JPEGs (``camera_ldr`` of ``radiance_map``)."""
    import cv2

    rs = np.random.RandomState(SEED + 21)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        paths.append(os.path.join(root, f"photo{i:02d}.jpg"))
        ldr = camera_ldr(radiance_map(rs, *PHOTO_HW))
        if not cv2.imwrite(paths[-1], np.ascontiguousarray(ldr[:, :, ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 95]):
            raise RuntimeError(f"failed to write {paths[-1]}")
    return paths


def tile_interior(hw: tuple, tile: int, halo: int) -> np.ndarray:
    """[h, w] bool: the pixels one tile alone covers, out of its feather (at
    least ``halo`` from every edge of it): where a tiled output is that one
    tile's, far from any seam."""
    from singlehdr_tpu_torch.tiled import tile_origins

    cover = np.zeros(hw, np.int32)
    inner = np.zeros(hw, np.int32)
    for y in tile_origins(hw[0], tile, tile - 2 * halo):
        for x in tile_origins(hw[1], tile, tile - 2 * halo):
            cover[y:y + tile, x:x + tile] += 1
            inner[y + halo:y + tile - halo, x + halo:x + tile - halo] += 1
    return (cover == 1) & (inner == 1)


def check_counts(label: str, counts: dict, want: dict) -> None:
    """Launch counts of a path (every dtype) against the expected counts."""
    print(f"  {label}: launches {counts}", flush=True)
    bad = {n: (counts[n], w) for n, w in want.items() if counts[n] != w}
    if bad:
        raise AssertionError(f"{label}: launches (counted, expected) {bad}")


def timed_s(fn) -> float:
    """Host seconds of one call of ``fn``, to a synchronised device."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def other_threads_cpu_s() -> float:
    """CPU seconds used so far by this process's threads other than the
    calling one, ended threads included (the process's CPU clock less the
    calling thread's)."""
    return time.process_time() - time.thread_time()


def cpu_s_by_thread_name() -> dict:
    """{name: CPU seconds so far} over this process's live threads, by the
    names the kernel knows them by (/proc/self/task/*/stat: Python's threads
    share the process's name; PyTorch names its autograd threads)."""
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
        except OSError:  # the thread ended
            continue
        name, fields = stat[stat.index("(") + 1:stat.rindex(")")], stat[stat.rindex(")") + 1:].split()
        out[name] = out.get(name, 0.0) + (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    return out


def step_times(fn, rounds: int = STEP_ROUNDS, steps: int = STEP_CALLS) -> dict:
    """``fn`` (a train step) timed in ``rounds`` rounds of ``steps`` calls,
    each call from and to a synchronised device (one warm-up call first).
    Per call: the host wall to the synchronised device, the host's enqueue
    time (until ``fn`` returns) and the CUDA-event time around it; per round:
    its median wall and, a call, the calling thread's CPU time and the other
    threads'; over the rounds, the CPU time of the busiest threads by name,
    and the live Python threads.  An enqueue as long as the wall says the
    host sets the step's pace; the calling thread's and the other threads'
    CPU together against the enqueue say whether the host computed or
    waited, and which threads did the work."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    named0, rows, per_round = cpu_s_by_thread_name(), [], []
    for _ in range(rounds):
        walls, own0, other0 = [], time.thread_time(), other_threads_cpu_s()
        for _ in range(steps):
            t0 = time.perf_counter()
            start.record()
            fn()
            stop.record()
            enqueue = time.perf_counter() - t0
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rows.append((walls[-1] * 1e3, enqueue * 1e3, start.elapsed_time(stop)))
        per_round.append((float(np.median(walls)) * 1e3, (time.thread_time() - own0) / steps * 1e3,
                          (other_threads_cpu_s() - other0) / steps * 1e3))
    named = {k: v - named0.get(k, 0.0) for k, v in cpu_s_by_thread_name().items()}
    wall, enqueue, event = (float(np.median(col)) for col in zip(*rows))
    return {"wall_ms": wall, "enqueue_ms": enqueue, "event_ms": event, "rounds": per_round,
            "busiest_threads_s": sorted(named.items(), key=lambda kv: -kv[1])[:4],
            "python_threads": len(threading.enumerate())}


def real_kernel_cases(pipe, dev) -> dict:
    """K1-K4 against their plain versions at the HDR-Real path's shapes, f32
    and bf16 (K1 f32 only): [4, *, 256, 256] (finetune, evaluate) and the
    whole 1024x1536 photo after its 32 px pad, [1, *, 1088, 1600]; each timed
    with its plain version and its bound.  Returns {kernel(_bf16): [cases]}."""
    plain = plain_versions()
    shapes = ((REAL_BATCH, (TRAIN_HW, TRAIN_HW)), (1, (PHOTO_HW[0] + 64, PHOTO_HW[1] + 64)))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        suffix = "_bf16" if dtype == torch.bfloat16 else ""
        for b, hw in shapes:
            with torch.no_grad():
                cases = kernel_cases(pipe, dev, dtype, b=b, hw=hw, odd=False)
            with torch.inference_mode():
                for name, label, args in cases:
                    kernel, ref = plain[name]
                    want, abs_err, rel_err, equal = compare_kernel(name, label, kernel, ref, args, dtype)
                    ms, plain_ms = device_ms(lambda: kernel(*args)), device_ms(lambda: ref(*args), 5)
                    bound_ms, bound_by, _ = bound(kernel_flop(name, args), nbytes(args) + nbytes(want),
                                                  dtype)
                    out.setdefault(name + suffix, []).append({
                        "case": label, "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by})
                    print(f"  {name + suffix:22s} {label:36s} rel {rel_err:.3e} equal {equal:.2%} "
                          f"kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  bound {bound_ms:.4f} ms "
                          f"({bound_by})  share {bound_ms / ms:.1%}", flush=True)
            del cases
        torch.cuda.empty_cache()
    return out


def k1_bwd_term_sums(x: torch.Tensor, k: int, g: torch.Tensor) -> tuple:
    """K1-bwd's curve gradient as float64 sums of its own f32 terms, and each
    bin's mass: [b, k] float64 each.  A pixel adds (1 - frac) g to bin i0 and
    frac g to bin i1, both products rounded to f32 as the kernel and its
    plain version round them (y = (k - 1) x, i0 = clip(floor y), i1 =
    clip(floor y + 1)); the mass is the sum of those terms' magnitudes.  A
    kernel that forms the same terms differs from these sums by its order of
    summation alone, a small fraction of each bin's mass."""
    y = x * (k - 1)
    y0 = torch.floor(y)
    frac = y - y0
    i0 = y0.to(torch.int64).clamp(0, k - 1)
    i1 = (y0.to(torch.int64) + 1).clamp(0, k - 1)
    w0, w1 = ((1 - frac) * g).double(), (frac * g).double()
    zero = torch.zeros(x.shape[0], k, dtype=torch.float64, device=x.device)
    sums = zero.clone().scatter_add_(1, i0, w0).scatter_add_(1, i1, w1)
    mass = zero.scatter_add_(1, i0, w0.abs()).scatter_add_(1, i1, w1.abs())
    return sums, mass


def bin_rel_error(grf: torch.Tensor, sums: torch.Tensor, mass: torch.Tensor) -> float:
    """The largest error of a curve gradient over its bins, each bin's error
    over that bin's own mass (``k1_bwd_term_sums``), so that a lost, doubled
    or misplaced term shows in a small bin beside a saturated one; a bin that
    no term reaches must be exactly 0."""
    err = (grf.double() - sums).abs()
    reached = mass > 0
    scaled = torch.where(reached, err / torch.where(reached, mass, 1.0),
                         torch.where(err > 0, float("inf"), 0.0))
    return scaled.max().item()


def real_k1_bwd_cases(state, batch) -> list:
    """K1-bwd against its plain version on a finetune step's inputs: x =
    C_pred (deq's clipped output) and lin's curve, as the finetune backward
    calls it (gx and grf), and x = the batch's 8-bit LDR itself (levels j /
    255, many lanes of a warp in one bin); g seeded.  gx bit-equal, grf the
    same bits on two launches and, bin by bin, within max(BWD_REL_TOL, twice
    the f32 plain version's own error) of its bin's mass
    (``bin_rel_error``); timed warm and L2-flushed beside the bound (12
    bytes a pixel)."""
    from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf_bwd, apply_rf_bwd_plain

    ldr, _ = batch
    b = ldr.shape[0]
    with torch.no_grad():
        c_pred = torch.clamp(state.nets["deq"](ldr), 0.0, 1.0)
        rf = state.nets["lin"](c_pred).contiguous()
    g = torch.randn(ldr.shape, generator=torch.Generator(device=ldr.device).manual_seed(SEED + 22),
                    device=ldr.device).reshape(b, -1)
    out = []
    for label, x in (("finetune C_pred", c_pred), ("8-bit LDR", ldr)):
        x = x.reshape(b, -1).contiguous()
        gx, grf = apply_rf_bwd(x, rf, g, True, True)
        _, grf_again = apply_rf_bwd(x, rf, g, True, True)
        pgx, pgrf = apply_rf_bwd_plain(x, rf, g, True, True)
        sums, mass = k1_bwd_term_sums(x, rf.shape[1], g)
        torch.cuda.synchronize()
        if not torch.equal(gx, pgx):
            raise AssertionError(f"apply_rf_bwd {label}: gx not bit-equal "
                                 f"(max err {(gx - pgx).abs().max().item():.3e})")
        if not torch.equal(grf, grf_again):
            raise AssertionError(f"apply_rf_bwd {label}: grf differs between launches")
        abs_err = (grf - sums).abs().max().item()
        # each bin against its own mass: orders of summation differ by a small
        # fraction of a bin's mass however many terms it sums (the pixels deq
        # clips to 1.0 all land in bin 1023), while one lost or misplaced term
        # errs by a large fraction of a small bin's mass
        rel_err, plain_rel = bin_rel_error(grf, sums, mass), bin_rel_error(pgrf, sums, mass)
        tol = max(BWD_REL_TOL, 2 * plain_rel)
        if not rel_err <= tol:
            raise AssertionError(f"apply_rf_bwd {label}: grf per-bin rel err {rel_err:.3e} > {tol:.3e}")
        ms = device_ms(lambda: apply_rf_bwd(x, rf, g, True, True))
        cold_ms = cold_l2_ms(lambda: apply_rf_bwd(x, rf, g, True, True))
        plain_ms = device_ms(lambda: apply_rf_bwd_plain(x, rf, g, True, True), 5)
        bound_ms = bound(0.0, nbytes((x, rf, g, pgx, pgrf)))[0]
        levels = torch.unique(x).numel()
        out.append({"case": f"{label} {tuple(x.shape)}", "max_abs_err": abs_err, "ms": ms,
                    "cold_ms": cold_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes"})
        print(f"  apply_rf_bwd {label} {tuple(x.shape)} ({levels} distinct x): gx bit-equal; grf "
              f"per bin {rel_err:.3e} of its mass from the float64 sums (bound {tol:.3e}; f32 plain "
              f"{plain_rel:.3e}; {int((mass > 0).sum())} bins reached), "
              f"the same bits twice; kernel {ms:.4f} ms, L2 "
              f"flushed {cold_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes), "
              f"share {bound_ms / ms:.1%} (flushed {bound_ms / cold_ms:.1%})", flush=True)
    return out


def hdr_real_path(dev, card: str, work: str, train_root: str) -> tuple:
    """Phase 12: the HDR-Real path through its entry points: convert_records,
    finetune (f32, then bf16; deq/lin/hal from phase 9's joint checkpoint),
    infer whole and tiled on two 1024x1536 photos, evaluate, validate_synth
    on phase 9's .hdr files and joint checkpoint; each path's launches
    counted alone; card vs CPU checks; K1-K4 and K1-bwd at the path's shapes.
    Returns ({path: {kernel: {dtype: launches}}}, {path: units}, {kernel:
    cases at the path's shapes}, {kernel: {dtype: launches}} of one invCRF
    view, counted alone, {"records", "photos", "finetune_ckpt": paths}, which
    phases 13 and 14 read)."""
    from singlehdr_tpu_torch.cli import DTYPES, convert_records, evaluate, finetune, infer, validate_synth
    from singlehdr_tpu_torch.data.hdr_io import read_hdr, read_ldr
    from singlehdr_tpu_torch.data.real import HdrRealPipeline
    from singlehdr_tpu_torch.data.records import RecordDataset
    from singlehdr_tpu_torch.inference import HdrPredictor
    from singlehdr_tpu_torch.models import ReverseCameraPipeline
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.tiled import TiledPredictor, tile_origins
    from singlehdr_tpu_torch.train.checkpoint import CheckpointManager
    from singlehdr_tpu_torch.train.loop import upload_pair
    from singlehdr_tpu_torch.train.steps import make_finetune_train_step

    root = os.path.join(work, "real")
    write_real_pairs(root)
    jnt = os.path.join(train_root, "checkpoints", "jnt")
    launches, units, cwd = {}, {}, os.getcwd()

    def counted(path: str, fn):
        kernels.reset_launches()
        result = fn()
        torch.cuda.synchronize()
        launches[path] = kernels.launch_counts_by_dtype()
        return result, kernels.launch_counts()

    t0 = time.perf_counter()
    records = os.path.join(root, "records")
    n = convert_records.run(convert_records.build_parser().parse_args(["--dir", root, "--out", records]))
    ds = RecordDataset(records)
    hdr0, ldr0 = ds[len(ds) - 1]
    if not (n == len(ds) == REAL_RECORDS and hdr0.shape == ldr0.shape == (TRAIN_HW, TRAIN_HW, 3)
            and ldr0.dtype == np.uint8 and np.isfinite(hdr0).all()):
        raise AssertionError(f"records: {n} written, {len(ds)} read, {hdr0.shape} {ldr0.dtype}")
    print(f"  convert_records: {n} records of {TRAIN_HW}^2 from {REAL_PAIRS} pairs of {REAL_HW} in "
          f"{time.perf_counter() - t0:.1f} s; read back", flush=True)

    ckpt, states = {}, {}
    for dtype in ("float32", "bfloat16"):
        run_dir = os.path.join(root, f"finetune_{dtype}")
        os.makedirs(run_dir)
        ckpt[dtype] = os.path.join(run_dir, "ref")
        os.chdir(run_dir)  # the CLI writes its run directories under the cwd
        t0 = time.perf_counter()
        try:
            states[dtype], counts = counted(f"finetune_{dtype}", lambda: finetune.run(
                finetune.build_parser().parse_args(
                    ["--records", records, "--epochs", "1", "--batch_size", str(REAL_BATCH),
                     "--dtype", dtype, "--deq_ckpt", jnt, "--lin_ckpt", jnt, "--hal_ckpt", jnt,
                     "--ref_ckpt", ckpt[dtype]])))
        finally:
            os.chdir(cwd)
        wall = time.perf_counter() - t0
        losses = logged_losses(run_dir, "ref/loss")
        saved = CheckpointManager(ckpt[dtype]).steps()
        if states[dtype].step != REAL_STEPS or saved != [REAL_STEPS] or len(losses) != 1 \
                or not np.isfinite(losses).all():
            raise AssertionError(f"finetune {dtype}: step {states[dtype].step}, checkpoints {saved}, "
                                 f"losses {losses}")
        check_counts(f"finetune {dtype}, {REAL_STEPS} steps", counts,
                     {"apply_rf": REAL_STEPS, "apply_rf_bwd": REAL_STEPS, "unet_stage2": 0,
                      "lin_feature_stem": 0, "encoder_stage2": 0})
        # the step alone, on the first batch of a seeded epoch (it goes on
        # training the CLI's state: the same work each step)
        batch = upload_pair(*next(HdrRealPipeline(records, REAL_BATCH, seed=SEED).epoch()), dev)
        step = make_finetune_train_step(DTYPES[dtype])
        t = step_times(lambda: step(states[dtype], *batch))
        back_to_back = cuda_ms(lambda: step(states[dtype], *batch))
        rounds = "; ".join(f"{w:.2f} ms, CPU {own:.1f} + {other:.1f} ms" for w, own, other in t["rounds"])
        busiest = ", ".join(f"{name} {sec:.3f} s" for name, sec in t["busiest_threads_s"])
        print(f"  finetune {dtype}: epoch loss {losses[0]:.5f}, checkpoint at step {saved[0]}; "
              f"CLI {wall:.1f} s wall incl. set-up ({wall / REAL_STEPS * 1e3:.1f} ms a step)\n"
              f"    step b{REAL_BATCH} @ {TRAIN_HW}^2, each synchronised, median of "
              f"{STEP_ROUNDS} x {STEP_CALLS}: wall {t['wall_ms']:.2f} ms "
              f"({REAL_BATCH / t['wall_ms'] * 1e3:.2f} img/s), host enqueue {t['enqueue_ms']:.2f} ms, "
              f"events {t['event_ms']:.2f} ms; back to back {back_to_back:.2f} ms (mean of 10)\n"
              f"    rounds (median wall; CPU a call, this thread + the others): {rounds}\n"
              f"    busiest threads over the rounds: {busiest}; {t['python_threads']} Python threads "
              f"alive  [{card}]", flush=True)
    units["finetune_step"] = 2 * REAL_STEPS
    k1_bwd = real_k1_bwd_cases(states["float32"], batch)
    del states

    photos = write_photos(os.path.join(root, "photos"))
    slots = [a for n in ("deq", "lin", "hal", "ref") for a in (f"--{n}_ckpt", ckpt["float32"])]
    base = ["--dir", os.path.dirname(photos[0]), *slots]
    tiles = len(tile_origins(PHOTO_HW[0], TILE, TILE - 2 * HALO)) * \
        len(tile_origins(PHOTO_HW[1], TILE, TILE - 2 * HALO))
    for mode, extra, want in (
            ("infer_whole", [], {k: N_PHOTOS * v for k, v in PER_BATCH.items()}),
            ("infer_tiled", ["--tiled", "--tile", str(TILE), "--halo", str(HALO)],
             {k: N_PHOTOS * (PER_VIEW[k] + tiles * PER_TILE[k]) for k in PER_TILE})):
        out_dir = os.path.join(root, mode)
        t0 = time.perf_counter()
        written, counts = counted(mode, lambda: infer.run(infer.build_parser().parse_args(
            base + ["--output_path", out_dir] + extra)))
        check_counts(f"{mode}, {N_PHOTOS} photos of {PHOTO_HW}" + (f", {tiles} tiles each" if extra else ""),
                     counts, {**want, "apply_rf_bwd": 0})
        for path in written:
            hdr = read_hdr(path)
            if hdr.shape != (*PHOTO_HW, 3) or not np.isfinite(hdr).all():
                raise AssertionError(f"{mode}: {path} {hdr.shape}")
        print(f"  {mode}: {len(written)} .hdr files {PHOTO_HW} finite, {time.perf_counter() - t0:.1f} s "
              f"wall incl. set-up", flush=True)
    units["infer_image"] = N_PHOTOS
    units["tiled_tile"] = N_PHOTOS * tiles

    args = infer.build_parser().parse_args(base)
    pipe = infer.load_pipeline(args, dev)
    img = read_ldr(photos[0]).astype(np.float32) / 255.0
    whole_pred, tiled_pred = HdrPredictor(pipe), TiledPredictor(pipe, tile=TILE, halo=HALO)
    # the tiled runs' launches less their invCRF views' give the per-tile
    # counts: one view's launches, counted alone
    kernels.reset_launches()
    tiled_pred.global_invcrf(img)
    torch.cuda.synchronize()
    view_launches = kernels.launch_counts_by_dtype()
    check_counts(f"one invCRF view of a {PHOTO_HW} photo", kernels.launch_counts(),
                 {**PER_VIEW, "apply_rf_bwd": 0})
    whole, tiled = whole_pred(img), tiled_pred(img)
    inner = tile_interior(PHOTO_HW, TILE, HALO)
    diff = np.abs(tiled - whole)[inner]
    rel = float(diff.max() / np.abs(whole[inner]).max())
    whole_ms = float(np.median([timed_s(lambda: whole_pred(img)) for _ in range(3)])) * 1e3
    tiled_ms = float(np.median([timed_s(lambda: tiled_pred(img)) for _ in range(3)])) * 1e3
    print(f"  tiled vs whole, {PHOTO_HW}, tile interiors ({inner.mean():.1%} of the pixels): max|err| "
          f"{diff.max():.3e} mean {diff.mean():.3e}, rel {rel:.3e} of max|whole| (bound "
          f"{TILED_WHOLE_REL_TOL}); whole {whole_ms:.1f} ms, tiled {tiled_ms:.1f} ms an image "
          f"(host clock, H2D and D2H included)  [{card}]", flush=True)
    if not rel <= TILED_WHOLE_REL_TOL:
        raise AssertionError(f"tiled output differs from the whole image in tile interiors: {rel:.3e}")

    cpu_pipe = ReverseCameraPipeline()
    cpu_pipe.load_state_dict({k: v.cpu() for k, v in pipe.state_dict().items()})
    cpu_pipe.eval()
    hw, tile, halo, view = TILED_SMALL
    small = np.ascontiguousarray(img[:hw[0], :hw[1]])
    got = TiledPredictor(pipe, tile=tile, halo=halo, invcrf_view=view)(small)
    want = TiledPredictor(cpu_pipe, tile=tile, halo=halo, invcrf_view=view)(small)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"  tiled {hw}, tile {tile}, halo {halo}, view {view}: card vs CPU plain path rel {rel:.3e} "
          f"(bound {PATH_REL_TOL})", flush=True)
    if not (got.shape == (*hw, 3) and rel <= PATH_REL_TOL):
        raise AssertionError(f"tiled path differs from the CPU plain path: rel {rel:.3e}")

    out, counts = counted("evaluate", lambda: evaluate.run(evaluate.build_parser().parse_args(
        ["--records", records, "--batch_size", str(REAL_BATCH), *slots])))
    check_counts(f"evaluate, {EVAL_BATCHES} batches", counts,
                 {**{k: EVAL_BATCHES * v for k, v in PER_BATCH.items()}, "apply_rf_bwd": 0})
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"evaluate: {out}")
    units["evaluate_batch"] = EVAL_BATCHES
    card_m = evaluate.evaluate(pipe, HdrRealPipeline(records, REAL_BATCH, training=False),
                               REAL_BATCH, max_batches=2)
    cpu_m = evaluate.evaluate(cpu_pipe, HdrRealPipeline(records, REAL_BATCH, training=False),
                              REAL_BATCH, max_batches=2)
    delta = {k: abs(card_m[k] - cpu_m[k]) for k in card_m}
    batch = upload_pair(*next(HdrRealPipeline(records, REAL_BATCH, training=False).epoch()), dev)
    eval_ms = cuda_ms(lambda: evaluate.batch_metrics(pipe, *batch, 1.0))
    print(f"  evaluate {out}; first two batches card {card_m}, CPU {cpu_m}, |diff| {delta} (bounds "
          f"{EVAL_DB_TOL} dB, SSIM {EVAL_SSIM_TOL}); a batch b{REAL_BATCH} @ {TRAIN_HW}^2 "
          f"{eval_ms:.2f} ms (mean of 10)  [{card}]", flush=True)
    if not (delta["psnr_linear_db"] <= EVAL_DB_TOL and delta["psnr_mu_db"] <= EVAL_DB_TOL
            and delta["ssim_mu"] <= EVAL_SSIM_TOL):
        raise AssertionError(f"evaluate differs from the CPU plain path: {delta}")
    del cpu_pipe

    out, counts = counted("validate_synth", lambda: validate_synth.run(
        validate_synth.build_parser().parse_args(
            ["--hdrdir", os.path.join(train_root, "hdr"), "--deq_ckpt", jnt, "--lin_ckpt", jnt,
             "--size", "512", "--batches", str(VALIDATE_BATCHES)])))
    check_counts(f"validate_synth, {VALIDATE_BATCHES} batches", counts,
                 {**{k: VALIDATE_BATCHES * v for k, v in PER_VALIDATE_BATCH.items()}, "apply_rf_bwd": 0})
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"validate_synth: {out}")
    print(f"  validate_synth: {out}", flush=True)

    cases = real_kernel_cases(pipe, dev)
    cases["apply_rf_bwd"] = k1_bwd
    files = {"records": records, "photos": os.path.dirname(photos[0]), "finetune_ckpt": ckpt["float32"]}
    return launches, units, cases, view_launches, files


def interop_path(dev, card: str, work: str, train_root: str, files: dict) -> dict:
    """Phase 13: the four slots phases 9 and 12 trained (deq, lin and hal
    from the joint checkpoint, ref from the f32 finetune) through
    cli.export_weights (the .npz and one reference TF2 bundle a net), the
    bundles back through cli.import_reference (rgb and bgr), and cli.infer on
    phase 12's photos from the slots and from the imported .npz; the serve
    CLI's slot loading on one request.  Returns the phase's launches, {kernel:
    {dtype: n}}."""
    from singlehdr_tpu_torch.cli import export_weights, import_reference, infer
    from singlehdr_tpu_torch.cli import serve as cli_serve
    from singlehdr_tpu_torch.convert import flat_variables
    from singlehdr_tpu_torch.data.hdr_io import read_ldr
    from singlehdr_tpu_torch.inference import HdrPredictor
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.train.tensorbundle import read_bundle
    from singlehdr_tpu_torch.train.weight_import import reference_keys_to_tree

    root = os.path.join(work, "interop")
    jnt = os.path.join(train_root, "checkpoints", "jnt")
    slots = ["--deq_ckpt", jnt, "--lin_ckpt", jnt, "--hal_ckpt", jnt, "--ref_ckpt", files["finetune_ckpt"]]
    nets = ("deq", "lin", "hal", "ref")
    os.makedirs(root)
    kernels.reset_launches()
    t0 = time.perf_counter()
    exported_npz = os.path.join(root, "exported.npz")
    exported = export_weights.run(export_weights.build_parser().parse_args(
        ["--out", exported_npz, "--reference_out", os.path.join(root, "tf"), *slots]))
    bundles = {net: os.path.join(root, "tf", net, "ckpt-1") for net in nets}
    for net, prefix in bundles.items():
        back = flat_variables(reference_keys_to_tree(net, read_bundle(prefix)))
        want = flat_variables({"params": exported["params"][net],
                               "batch_stats": exported["batch_stats"].get(net, {})})
        want.pop("batch_stats/preproc_mean", None)  # no reference checkpoint holds it
        if set(back) != set(want) or not all(
                back[k].dtype == want[k].dtype and np.array_equal(back[k], want[k]) for k in want):
            raise AssertionError(f"{prefix}: the bundle does not read back to the exported {net} arrays")
    imported = {}
    for order in ("rgb", "bgr"):
        imported[order] = os.path.join(root, f"imported_{order}.npz")
        import_reference.run(import_reference.build_parser().parse_args(
            ["--out", imported[order], "--channel_order", order,
             *[a for net in nets for a in (f"--{net}", bundles[net])]]))
    with np.load(exported_npz) as a, np.load(imported["rgb"]) as b:
        if set(a.files) != set(b.files) or not all(np.array_equal(a[k], b[k]) for k in a.files):
            raise AssertionError("export -> import does not give back the exported arrays")
    print(f"  export_weights -> {len(bundles)} reference bundles -> import_reference (rgb, bgr): "
          f"{len(exported['params'])} nets, every bundle read back bit-equal, the rgb import equal "
          f"to the export, {time.perf_counter() - t0:.1f} s (host)", flush=True)

    written = {}
    for label, extra in (("slots", slots), ("weights", ["--weights", imported["rgb"]])):
        before = kernels.launch_counts()
        written[label] = infer.run(infer.build_parser().parse_args(
            ["--dir", files["photos"], "--output_path", os.path.join(root, f"infer_{label}"), *extra]))
        torch.cuda.synchronize()
        counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        check_counts(f"infer from the {label}, {N_PHOTOS} photos", counts,
                     {**{k: N_PHOTOS * v for k, v in PER_BATCH.items()}, "apply_rf_bwd": 0})
    same = [filecmp.cmp(a, b, shallow=False) for a, b in zip(written["slots"], written["weights"])]
    if len(same) != N_PHOTOS or not all(same):
        raise AssertionError(f"infer's .hdr files differ between the slots and the imported npz: {same}")

    def pipeline(*argv):
        return infer.load_pipeline(infer.build_parser().parse_args(list(argv)), dev)

    pipes = {"slots": pipeline(*slots), "weights": pipeline("--weights", imported["rgb"]),
             "bgr": pipeline("--weights", imported["bgr"])}
    img = read_ldr(os.path.join(files["photos"], sorted(os.listdir(files["photos"]))[0])).astype(np.float32) / 255.0
    want = HdrPredictor(pipes["slots"])(img)
    got = HdrPredictor(pipes["weights"])(img)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    flipped = HdrPredictor(pipes["weights"])(np.ascontiguousarray(img[..., ::-1]))[..., ::-1]
    bgr = HdrPredictor(pipes["bgr"])(img)
    rel_bgr = float(np.abs(bgr - flipped).max() / np.abs(flipped).max())
    request = np.ascontiguousarray(img[:SERVE_REQUEST_HW, :SERVE_REQUEST_HW])
    served = cli_serve.make_predictor(cli_serve.build_parser().parse_args(["--warmup", "", *slots]))
    want_req = HdrPredictor(pipes["slots"])(request)
    rel_serve = float(np.abs(served(request) - want_req).max() / np.abs(want_req).max())
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"  {PHOTO_HW} photo, f32: imported npz vs the slots max|err| / max|ref| {rel:.3e} (bound "
          f"{INTEROP_REL_TOL}); bgr import on the flipped photo vs the flipped rgb output {rel_bgr:.3e} "
          f"(bound {INTEROP_BGR_REL_TOL}); serve CLI's slots vs infer's on a {SERVE_REQUEST_HW}^2 "
          f"request {rel_serve:.3e} (bound {INTEROP_REL_TOL}); the two infer runs' .hdr files "
          f"byte-identical  [{card}]", flush=True)
    check_counts(f"interop, {INTEROP_IMAGES} images", counts,
                 {**{k: INTEROP_IMAGES * v for k, v in PER_BATCH.items()}, "apply_rf_bwd": 0})
    if not (rel <= INTEROP_REL_TOL and rel_serve <= INTEROP_REL_TOL):
        raise AssertionError(f"imported or served weights give other numbers: {rel:.3e}, {rel_serve:.3e}")
    if not rel_bgr <= INTEROP_BGR_REL_TOL:
        raise AssertionError(f"the bgr import is not the channel-flipped rgb pipeline: {rel_bgr:.3e}")
    del pipes, served
    torch.cuda.empty_cache()
    return kernels.launch_counts_by_dtype()


def _snapshot(state) -> tuple:
    return ({k: v.clone() for k, v in state.nets.state_dict().items()},
            copy.deepcopy(state.optimizer.state_dict()), state.step)


def _restore(state, snap: tuple) -> None:
    state.nets.load_state_dict(snap[0])
    state.optimizer.load_state_dict(snap[1])
    state.step = snap[2]
    for p in state.nets.parameters():
        p.grad = None


def _rel_max(got: dict, want: dict) -> float:
    return max(float((got[k] - w).abs().max() / w.abs().max()) for k, w in want.items())


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to its deterministic algorithms within the block."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def remat_steps(dev, card: str, files: dict) -> tuple:
    """Phase 14, the steps: a finetune step at batch 4 (phase 12's first
    record batch) and a joint step at batch 16 (seeded), 256^2, in f32 and
    bf16, each from one snapshot of a warmed state with remat False, True
    and 'convs'.  One step of each mode with cuDNN's deterministic
    algorithms: the loss, the new BatchNorm statistics and every gradient
    against the plain step's (with cuDNN free to choose, the f32 backward
    differs from run to run, and a remat step can get other algorithms
    than the plain one, which moves bf16 gradients by an ulp); one step of
    each as it runs by default: its peak memory; then each mode's step time
    in synchronised rounds; K1 and K1-bwd once a step.  The bf16 joint
    step's default runs are also held by phase 10's bf16 check, each remat
    mode's gradients against the f32 plain step's as the plain bf16 step's
    are (``bf16_remat_report``), and the plain bf16 step runs once more by
    default, which reads its own run-to-run spread.  Returns the launches {kernel: {dtype: n}}
    and the number of steps."""
    from singlehdr_tpu_torch.data.real import HdrRealPipeline
    from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.train import steps
    from singlehdr_tpu_torch.train.loop import upload_pair
    from singlehdr_tpu_torch.train.state import init_multi_state

    vgg = Vgg16Features().to(dev)
    batches = {"finetune": upload_pair(*next(HdrRealPipeline(files["records"], REAL_BATCH, seed=SEED).epoch()),
                                       dev),
               "joint": joint_batch(dev, TRAIN_BATCH, TRAIN_HW, SEED + 4)}
    factories = {"finetune": lambda dtype, remat: steps.make_finetune_train_step(dtype, remat=remat),
                 "joint": lambda dtype, remat: steps.make_joint_train_step(vgg, dtype, remat=remat)}
    nets = {"finetune": ("deq", "lin", "hal", "ref"), "joint": ("deq", "lin", "hal")}
    total, n_steps = {}, 0
    one_step = {"apply_rf": 1, "apply_rf_bwd": 1, "unet_stage2": 0, "lin_feature_stem": 0,
                "encoder_stage2": 0}
    for name, batch in batches.items():
        b = batch[0].shape[0]
        for dtype in (torch.float32, torch.bfloat16):
            label = f"{name} b{b} @ {TRAIN_HW}^2 {str(dtype).removeprefix('torch.')}"
            state = init_multi_state(nets[name], 1e-5, seed=SEED, device=dev, dtype=dtype)
            kernels.reset_launches()
            factories[name](dtype, False)(state, *batch)  # Adam's state, cuDNN's choices
            snap = _snapshot(state)
            got = {}
            for remat in REMAT_MODES:
                step = factories[name](dtype, remat)
                _restore(state, snap)
                before = kernels.launch_counts()
                with cudnn_deterministic():
                    loss, _ = step(state, *batch)
                torch.cuda.synchronize()
                check_counts(f"{label} remat={remat!r}, one step",
                             {k: v - before[k] for k, v in kernels.launch_counts().items()}, one_step)
                got[remat] = {"loss": loss.item(),
                              "grads": {n: p.grad.double().cpu() for n, p in state.nets.named_parameters()},
                              "stats": {n: v.double().cpu() for n, v in state.nets.named_buffers()
                                        if n.endswith(("running_mean", "running_var"))}}
                _restore(state, snap)
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                if name == "joint" and dtype == torch.bfloat16:  # and its kernels, by name
                    got[remat]["kernels"] = card_kernel_names(lambda: step(state, *batch))
                    got[remat]["default_grads"] = {n: p.grad.double().cpu()
                                                   for n, p in state.nets.named_parameters()}
                else:
                    step(state, *batch)
                torch.cuda.synchronize()
                got[remat]["peak"] = torch.cuda.max_memory_allocated(dev)
                got[remat]["over"] = got[remat]["peak"] - base
            plain = got[False]
            if name == "joint" and dtype == torch.float32:
                joint_f32 = plain["grads"]
            checked = name == "joint" and dtype == torch.bfloat16
            if checked:  # the plain bf16 step once more as run by default: its own run-to-run spread
                _restore(state, snap)
                factories[name](dtype, False)(state, *batch)
                again = grad_bound_ratio({n: p.grad.double().cpu() for n, p in state.nets.named_parameters()},
                                         plain["default_grads"])
                farthest = max(again, key=again.get)
                print(f"  {label}, the plain step twice, default algorithms: farthest tensor {farthest} at "
                      f"{again[farthest]:.3f} of phase 10's per-tensor bound", flush=True)
            net_max = {}
            for n, g in plain["grads"].items():
                net_max[n.split(".")[0]] = max(net_max.get(n.split(".")[0], 0.0), g.abs().max().item())
            times = {}
            for remat in REMAT_MODES:
                _restore(state, snap)
                step = factories[name](dtype, remat)
                times[remat] = step_times(lambda: step(state, *batch), REMAT_ROUNDS, REMAT_CALLS)
            counts = kernels.launch_counts()
            steps_here = 1 + len(REMAT_MODES) * (3 + REMAT_ROUNDS * REMAT_CALLS) + int(checked)
            n_steps += steps_here
            check_counts(f"{label}, {steps_here} steps", counts,
                         {k: v * steps_here for k, v in one_step.items()})
            _add_counts(total, kernels.launch_counts_by_dtype())
            failures = []
            for remat in REMAT_MODES:
                r, t = got[remat], times[remat]
                loss_rel = abs(r["loss"] - plain["loss"]) / abs(plain["loss"])
                stats_rel = _rel_max(r["stats"], plain["stats"])
                ratio = max((r["grads"][n] - g).abs().max().item()
                            / (STEP_GRAD_OWN_TOL * g.abs().max().item()
                               + STEP_GRAD_NET_TOL * net_max[n.split(".")[0]])
                            for n, g in plain["grads"].items())
                equal = sum(torch.equal(r["grads"][n], g) for n, g in plain["grads"].items())
                print(f"  {label} remat={remat!r}: peak {r['peak'] / 2**30:.2f} GiB ({r['over'] / 2**30:.2f} "
                      f"over the state), step {t['wall_ms']:.2f} ms wall (median of {REMAT_ROUNDS} x "
                      f"{REMAT_CALLS}, synchronised; events {t['event_ms']:.2f}, host enqueue "
                      f"{t['enqueue_ms']:.2f}); vs plain: loss rel {loss_rel:.3e}, BN statistics rel "
                      f"{stats_rel:.3e} (bound {REMAT_REL_TOL}), worst gradient {ratio:.3f} of phase 10's "
                      f"bound, {equal}/{len(plain['grads'])} gradient tensors bit-equal  [{card}]", flush=True)
                if not (loss_rel <= REMAT_REL_TOL and stats_rel <= REMAT_REL_TOL and ratio <= 1):
                    failures.append(f"remat={remat!r}: loss {loss_rel:.3e}, stats {stats_rel:.3e}, "
                                    f"gradients {ratio:.3f} of the bound")
            if checked:
                # phase 10's bf16 check with cuDNN free to choose: each remat
                # mode against the f32 plain step, as the plain bf16 step is
                for remat in REMAT_MODES[1:]:
                    failures += bf16_remat_report(
                        f"{label} remat={remat!r}, default algorithms, vs the f32 plain step",
                        got[remat]["default_grads"], joint_f32, plain["default_grads"],
                        plain["default_grads"], got[remat]["kernels"], plain["kernels"])
            if not got[True]["peak"] < plain["peak"]:
                failures.append(f"remat=True peaks at {got[True]['peak']}, not below {plain['peak']}")
            if not got["convs"]["peak"] <= plain["peak"]:
                failures.append(f"remat='convs' peaks at {got['convs']['peak']}, above {plain['peak']}")
            if failures:
                raise AssertionError(f"{label}: " + "; ".join(failures))
            del state, snap, got
            torch.cuda.empty_cache()
    return total, n_steps


def card_kernel_names(fn) -> set:
    """The names of the device kernels one call of ``fn`` runs (the
    profiler's), cuDNN's algorithms among them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:  # the exported trace's device kernels
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}


def bf16_remat_report(label: str, got: dict, ref: dict, noise: dict, plain: dict, kernels: set,
                      plain_kernels: set) -> list:
    """Prints one bf16 remat step's gradients ``got`` against phase 10's bf16
    bounds (``bf16_net_failures``: distance and cosine to the f32 ``ref``
    against those of a bf16 step's ``noise``), the tensor farthest from the
    plain bf16 step's gradients ``plain`` by phase 10's per-tensor f32
    bound, and the kernels the step ran that the plain step did not and the
    other way round (cuDNN's algorithms show by name); returns the
    failures."""
    parts, worst_net, failures = [], (0.0, ""), []
    for net in ("deq", "lin", "hal"):
        dist, cos = net_distance(got, ref, net)
        noise_dist, noise_cos = net_distance(noise, ref, net)
        bound = BF16_STEP_DEQ_TOL if net == "deq" else BF16_STEP_NOISE_FACTOR * noise_dist + 0.02
        worst_net = max(worst_net, (dist / bound, net))
        parts.append(f"{net} {dist:.4f} of bound {bound:.4f} (cos {cos:.4f}; plain {noise_dist:.4f}, "
                     f"cos {noise_cos:.4f})")
        failures += bf16_net_failures(net, got, ref, noise)
    ratio = grad_bound_ratio(got, plain)
    tensor = max(ratio, key=ratio.get)
    added, gone = sorted(kernels - plain_kernels), sorted(plain_kernels - kernels)
    print(f"  {label}: distance from the f32 step: {'; '.join(parts)}; worst net {worst_net[1]} at "
          f"{worst_net[0]:.3f} of its bound; farthest tensor from the plain bf16 step {tensor} at "
          f"{ratio[tensor]:.3f} of phase 10's per-tensor bound; {len(kernels)} kernels by name, "
          f"{len(added)} not in the plain step, {len(gone)} of the plain step not run", flush=True)
    for tag, names in (("+", added), ("-", gone)):
        for name in names[:6]:
            print(f"    {tag} {name[:160]}", flush=True)
    return [f"{label}: {f}" for f in failures]


def remat_bf16_parity(dev, card: str, cpu_grads: tuple) -> None:
    """Phase 14, bf16 under remat with cuDNN's own algorithms: phase 10's
    bf16 joint step (2 x 64^2, its weights and batch) on the card with
    remat False, True and 'convs', each as it runs by default (no
    ``cudnn.deterministic``), held to the CPU f32 step by phase 10's bf16
    check (``bf16_net_failures`` against the CPU f32 and CPU bf16 steps'
    gradients ``cpu_grads``), with each mode's kernels against the plain
    step's."""
    from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
    from singlehdr_tpu_torch.train import steps
    from singlehdr_tpu_torch.train.state import init_multi_state

    ref, cpu16 = cpu_grads
    vgg = Vgg16Features().to(dev)
    batch = joint_batch(dev, 2, 64, SEED)
    plain, plain_kernels, failures = None, None, []
    for remat in REMAT_MODES:
        state = init_multi_state(("deq", "lin", "hal"), 1e-5, seed=SEED, device=dev, dtype=torch.bfloat16)
        step = steps.make_joint_train_step(vgg, torch.bfloat16, remat=remat)
        names = card_kernel_names(lambda: step(state, *batch))
        got = {n: p.grad.double().cpu() for n, p in state.nets.named_parameters()}
        if remat is False:
            plain, plain_kernels = got, names
        failures += bf16_remat_report(f"bf16 joint step 2x64^2 remat={remat!r}, default algorithms, vs "
                                      f"the CPU f32 step", got, ref, cpu16, plain, names, plain_kernels)
    print(f"  [{card}]", flush=True)
    if failures:
        raise AssertionError("bf16 remat steps with cuDNN's own algorithms:\n  " + "\n  ".join(failures))


def remat_clis(card: str, work: str, train_root: str, files: dict) -> dict:
    """Phase 14, the entry points: cli.finetune --remat for one epoch on
    phase 12's records (bf16, from phase 9's joint checkpoint) and
    cli.joint_train --remat for REMAT_CLI_ITERATIONS steps on phase 9's .hdr
    files.  Returns their launches, {kernel: {dtype: n}}."""
    from singlehdr_tpu_torch.cli import finetune, joint_train
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.train.checkpoint import CheckpointManager

    root, cwd = os.path.join(work, "remat"), os.getcwd()
    jnt = os.path.join(train_root, "checkpoints", "jnt")
    total = {}
    os.makedirs(root)
    os.chdir(root)  # the CLIs write their run directories under the cwd
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        state = finetune.run(finetune.build_parser().parse_args(
            ["--records", files["records"], "--epochs", "1", "--batch_size", str(REAL_BATCH),
             "--dtype", "bfloat16", "--remat", "--deq_ckpt", jnt, "--lin_ckpt", jnt, "--hal_ckpt", jnt,
             "--ref_ckpt", os.path.join(root, "ref")]))
        torch.cuda.synchronize()
        losses = logged_losses(root, "ref/loss")
        if state.step != REAL_STEPS or len(losses) != 1 or not np.isfinite(losses).all():
            raise AssertionError(f"finetune --remat: step {state.step}, losses {losses}")
        check_counts(f"finetune --remat --dtype bfloat16, {REAL_STEPS} steps", kernels.launch_counts(),
                     {"apply_rf": REAL_STEPS, "apply_rf_bwd": REAL_STEPS, "unet_stage2": 0,
                      "lin_feature_stem": 0, "encoder_stage2": 0})
        _add_counts(total, kernels.launch_counts_by_dtype())
        print(f"  finetune --remat --dtype bfloat16: one epoch, loss {losses[0]:.5f}, "
              f"{time.perf_counter() - t0:.1f} s wall incl. set-up  [{card}]", flush=True)

        kernels.reset_launches()
        t0 = time.perf_counter()
        ck = os.path.join(train_root, "checkpoints")
        state = joint_train.run(joint_train.build_parser().parse_args(
            ["--dir", os.path.join(train_root, "hdr"), "--batch_size", str(TRAIN_BATCH), "--patch_size",
             str(TRAIN_HW), "--workers", "8", "--log_every", "1", "--remat",
             "--iterations", str(REMAT_CLI_ITERATIONS), "--deq_ckpt", os.path.join(ck, "deq"),
             "--lin_ckpt", os.path.join(ck, "lin"), "--hal_ckpt", os.path.join(ck, "hal"),
             "--jnt_ckpt", os.path.join(root, "jnt")]))
        torch.cuda.synchronize()
        losses = logged_losses(root, "jnt/loss")
        if state.step != REMAT_CLI_ITERATIONS or len(losses) != REMAT_CLI_ITERATIONS \
                or not np.isfinite(losses).all():
            raise AssertionError(f"joint_train --remat: step {state.step}, losses {losses}")
        if CheckpointManager(os.path.join(root, "jnt")).latest_step != REMAT_CLI_ITERATIONS:
            raise AssertionError("joint_train --remat saved no final checkpoint")
        check_train_launches(kernels.launch_counts(), REMAT_CLI_ITERATIONS, "joint_train --remat")
        _add_counts(total, kernels.launch_counts_by_dtype())
        print(f"  joint_train --remat: {REMAT_CLI_ITERATIONS} steps, losses "
              f"{[round(v, 4) for v in losses]}, {time.perf_counter() - t0:.1f} s wall incl. set-up  "
              f"[{card}]", flush=True)
    finally:
        os.chdir(cwd)
    return total


def mesh_rank(rank: int, work: str) -> int:
    """Phases 15 (a) and 16, one rank: joins a gloo group of the spec's
    ``world`` processes on the parent's device, the one card (``file://``
    rendezvous under ``work``), and for each case of ``work``/cases.json, on
    the case's mesh (``[D, S]``; a data mesh of the world by default):
    a step case replicates the snapshot, takes its share of the global
    batch (its samples, on a spatial mesh its band of their rows), runs one
    step (rank 0 saves the loss, the gradients and the BatchNorm
    statistics; every rank a digest of its new parameters), then
    MESH_TIMED_STEPS more, timed (a float64 case, ``float64_steps``, is not
    timed), and on a spatial mesh MESH_TIMED_STEPS more with every halo
    exchange timed (``halo_share``); a ``shard_spatial`` case runs
    ``spatial_forward``.  Saves its launch counts."""
    import hashlib

    import torch.distributed as dist

    from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.parallel import make_mesh, replicate, shard_batch
    from singlehdr_tpu_torch.precision import use_full_f32
    from singlehdr_tpu_torch.train import steps
    from singlehdr_tpu_torch.train.state import init_multi_state

    use_full_f32()
    with open(os.path.join(work, "cases.json")) as f:
        spec = json.load(f)
    dev, cases, world = torch.device(spec["device"]), spec["cases"], spec.get("world", MESH_RANKS)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dist.init_process_group("gloo", init_method=f"file://{work}/rdzv", world_size=world, rank=rank)
    meshes = {}
    vgg, vgg64 = Vgg16Features().to(dev), None
    kernels.reset_launches()
    out, rank_steps = {}, 0
    for case in cases:
        shape = tuple(case.get("mesh", (world, 1)))
        if shape not in meshes:  # every rank makes the meshes' groups in one order
            meshes[shape] = make_mesh(*shape, device=dev)
        mesh = meshes[shape]
        before = kernels.launch_counts_by_dtype()
        if case.get("kind") == "shard_spatial":
            out[case["label"]] = spatial_forward(mesh, dev, case, sync)
            out[case["label"]]["case_launches"] = counts_since(before)
            continue
        dtype = getattr(torch, case["dtype"])
        f64 = dtype == torch.float64
        state = init_multi_state(case["nets"], 1e-5, seed=SEED, device=dev,
                                 dtype=torch.float32 if f64 else dtype)
        state.nets.load_state_dict(torch.load(os.path.join(work, case["snapshot"]), map_location=dev))
        if f64:
            float64_nets(state.nets)
        replicate(mesh, state)
        batch = shard_batch(mesh, torch.load(os.path.join(work, case["batch"])), spatial_dim=2)
        if f64:
            batch = [t.double() for t in batch]
        if f64 and case["step"] == "joint" and vgg64 is None:
            vgg64 = float64_nets(Vgg16Features().to(dev))
        step = (steps.make_finetune_train_step(dtype) if case["step"] == "finetune"
                else steps.make_joint_train_step(vgg64 if f64 else vgg, dtype))
        with float64_steps() if f64 else contextlib.nullcontext():
            loss, _ = step(state, *batch)
        sync()
        digest = hashlib.sha256()
        for _, p in sorted(state.nets.named_parameters()):
            digest.update(p.detach().float().cpu().numpy().tobytes())
        result = {"digest": digest.hexdigest()}
        if rank == 0:
            result.update(loss=loss.item(),
                          grads={n: p.grad.double().cpu() for n, p in state.nets.named_parameters()},
                          stats={n: v.double().cpu() for n, v in state.nets.named_buffers()
                                 if n.endswith(("running_mean", "running_var"))})
        walls = [float("nan")] if f64 else []
        for _ in range(0 if f64 else MESH_TIMED_STEPS):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            step(state, *batch)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        result["step_ms"] = float(np.median(walls))
        rank_steps += 0 if f64 else 1 + MESH_TIMED_STEPS  # float64 launches no kernel
        if mesh.spatial > 1 and not f64:
            result["halo"] = halo_share(lambda: step(state, *batch), sync)
            rank_steps += MESH_TIMED_STEPS
        result["case_launches"] = counts_since(before)
        result["case_steps"] = (0 if f64 else 1 + MESH_TIMED_STEPS) + ("halo" in result) * MESH_TIMED_STEPS
        out[case["label"]] = result
        del state, batch
        sync()
    out["launches"], out["rank_steps"] = kernels.launch_counts_by_dtype(), rank_steps
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def counts_since(before: dict) -> dict:
    """Each kernel's launches by dtype since ``before`` (a
    ``launch_counts_by_dtype``)."""
    from singlehdr_tpu_torch.ops import cuda as kernels

    return {k: {dt: n - before.get(k, {}).get(dt, 0) for dt, n in v.items()}
            for k, v in kernels.launch_counts_by_dtype().items()}


def halo_share(run_step, sync) -> dict:
    """Phase 16 (g): MESH_TIMED_STEPS steps with every halo exchange timed
    alone (``parallel.mesh._exchange`` wrapped, the card synchronised before
    and after it, so its time includes waiting for the other band):
    {"step_ms": the median step, "halo_ms": the median step's exchanges,
    "exchanges": a step's count, "bytes": a step's bytes each band sends}."""
    import torch.distributed as dist

    from singlehdr_tpu_torch.parallel import mesh as pm

    exchange, spent, sent = pm._exchange, [], []

    def timed(rows, mesh):
        sync()
        t0 = time.perf_counter()
        got = exchange(rows, mesh)
        sync()
        spent.append((time.perf_counter() - t0) * 1e3)
        sent.append(rows.numel() * rows.element_size())
        return got

    pm._exchange = timed
    walls, halos = [], []
    try:
        for _ in range(MESH_TIMED_STEPS):
            dist.barrier()
            sync()
            spent.clear()
            sent.clear()
            t0 = time.perf_counter()
            run_step()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
            halos.append(sum(spent))
    finally:
        pm._exchange = exchange
    i = int(np.argsort(walls)[len(walls) // 2])
    return {"step_ms": walls[i], "halo_ms": halos[i], "exchanges": len(spent), "bytes": sum(sent)}


def spatial_forward(mesh, dev, case: dict, sync) -> dict:
    """Phase 16 (a), one rank: ``tiled.shard_spatial`` of the seeded
    pipeline (``case["dtype"]``) on the photo, once with each kernel's
    launches and the height of every K2-K4 input recorded (the models'
    wrappers wrapped), then SPATIAL_TIMED_FORWARDS times, synchronised.
    Returns the output (rank 0), the first forward's launches and input
    heights, and the median forward's ms."""
    import torch.distributed as dist

    from singlehdr_tpu_torch.models import build_pipeline, hallucination, linearization, unet
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.tiled import shard_spatial

    pipe = build_pipeline(seed=SEED, device=dev, dtype=getattr(torch, case["dtype"]))
    img = np.load(case["photo"])
    heights = {}
    wrapped = [(unet, "unet_stage2"), (linearization, "lin_feature_stem"), (hallucination, "encoder_stage2")]
    originals = [getattr(module, name) for module, name in wrapped]

    def recording(name, fn):
        def call(x, *args):
            heights.setdefault(name, []).append(int(x.shape[2]))
            return fn(x, *args)
        return call

    for (module, name), fn in zip(wrapped, originals):
        setattr(module, name, recording(name, fn))
    before = kernels.launch_counts()
    try:
        out = shard_spatial(pipe, img, mesh)
    finally:
        for (module, name), fn in zip(wrapped, originals):
            setattr(module, name, fn)
    sync()
    after = kernels.launch_counts()
    walls = []
    for _ in range(SPATIAL_TIMED_FORWARDS):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        shard_spatial(pipe, img, mesh)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    del pipe
    torch.cuda.empty_cache()
    return {"out": torch.from_numpy(out) if mesh.rank == 0 else None, "heights": heights, "band": img.shape[0] // mesh.spatial,
            "launches": {k: after[k] - before[k] for k in after}, "ms": float(np.median(walls)),
            "forwards": 1 + SPATIAL_TIMED_FORWARDS}


def run_mesh_ranks(work: str, n: int = MESH_RANKS) -> list:
    """Starts the ``n`` rank processes (``chip_smoke.py --mesh-rank``) and
    waits for all under MESH_RANK_TIMEOUT_S; a failed or hung rank fails
    the phase.  Returns each rank's results."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r), work],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"mesh rank {r} exited {p.returncode}:\n{text[-4000:]}")
    return [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(n)]


def grad_bound_ratio(got: dict, want: dict) -> dict:
    """max|got - want| of each gradient tensor over phase 10's bound (its own
    max|want| times STEP_GRAD_OWN_TOL + its net's largest times
    STEP_GRAD_NET_TOL); > 1 fails."""
    net_max = {}
    for n, g in want.items():
        net_max[n.split(".")[0]] = max(net_max.get(n.split(".")[0], 0.0), g.abs().max().item())
    return {n: (got[n] - g).abs().max().item()
            / (STEP_GRAD_OWN_TOL * g.abs().max().item() + STEP_GRAD_NET_TOL * net_max[n.split(".")[0]])
            for n, g in want.items()}


@contextlib.contextmanager
def float64_steps():
    """Within the block a train step of float64 nets (``float64_nets``)
    runs in float64: the steps' ``apply_rf`` becomes its plain version (K1
    takes f32 only); the port's BatchNorm takes its statistics in its
    input's precision.  A reference for chip_smoke's checks, not a path of
    the port."""
    from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf_plain
    from singlehdr_tpu_torch.train import steps

    rf = steps.apply_rf
    steps.apply_rf = apply_rf_plain
    try:
        yield
    finally:
        steps.apply_rf = rf


def float64_nets(nets):
    """``nets`` in float64: parameters and buffers, and every layer's
    compute dtype (lin's head is f32 in every dtype of the port)."""
    nets.double()
    for m in nets.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = torch.float64
    return nets


def float64_step(dev, case: dict, snapshot: dict, batch: list) -> dict:
    """One step (``case``'s joint or finetune) of the nets in ``snapshot``
    on the card in float64 (``float64_steps``; the joint step's VGG in
    float64 too): its loss, gradients and new BatchNorm statistics, as
    float64 CPU tensors."""
    from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
    from singlehdr_tpu_torch.train import steps
    from singlehdr_tpu_torch.train.state import init_multi_state

    state = init_multi_state(case["nets"], 1e-5, seed=SEED, device=dev)
    state.nets.load_state_dict(snapshot)
    float64_nets(state.nets)
    step = (steps.make_finetune_train_step(torch.float64) if case["step"] == "finetune"
            else steps.make_joint_train_step(float64_nets(Vgg16Features().to(dev)), torch.float64))
    with float64_steps():
        loss, _ = step(state, *[t.to(dev, torch.float64) for t in batch])
    torch.cuda.synchronize()
    out = {"loss": loss.item(), "grads": {n: p.grad.double().cpu() for n, p in state.nets.named_parameters()},
           "stats": {n: v.double().cpu() for n, v in state.nets.named_buffers()
                     if n.endswith(("running_mean", "running_var"))}}
    del state
    torch.cuda.empty_cache()
    return out


def ulp_moved(batch: list, seed: int) -> list:
    """``batch`` with every element moved by one f32 ulp, up or down at
    random (seeded)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for t in batch:
        up = (torch.rand(t.shape, generator=g) < 0.5).to(t.device)
        out.append(torch.where(up, torch.nextafter(t, torch.tensor(float("inf"), device=t.device)),
                               torch.nextafter(t, torch.tensor(float("-inf"), device=t.device))))
    return out


def f64_ratio(got: dict, want: dict) -> dict:
    """Each net's worst max|got - want| over its largest |want|."""
    largest, worst = {}, {}
    for n, w in want.items():
        largest[n.split(".")[0]] = max(largest.get(n.split(".")[0], 0.0), w.abs().max().item())
    for n, w in want.items():
        net = n.split(".")[0]
        worst[net] = max(worst.get(net, 0.0), (got[n] - w).abs().max().item() / largest[net])
    return worst


def mesh_references(dev, files: dict, work: str) -> dict:
    """Phases 15 (a) and 16's cases and what their rank steps are held to:
    the joint step at batch 16, 256^2, and the finetune step at batch 4
    (phase 12's first record batch), each in f32, float64 and (joint) bf16,
    each the single-process step on the full batch from the snapshot of a
    seeded state (the f32 steps with their witnesses, ``mesh_ranks_vs_one``
    says why).  Returns {"root", "cases", "single"}, the snapshots and
    batches written under "root"."""
    from singlehdr_tpu_torch.data.real import HdrRealPipeline
    from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
    from singlehdr_tpu_torch.train import steps
    from singlehdr_tpu_torch.train.loop import upload_pair
    from singlehdr_tpu_torch.train.state import init_multi_state

    root = os.path.join(work, "mesh_ranks")
    os.makedirs(root)
    vgg = Vgg16Features().to(dev)
    joint = [t.cpu() for t in joint_batch(dev, TRAIN_BATCH, TRAIN_HW, SEED + 5)]
    finetune = [t.cpu() for t in upload_pair(
        *next(HdrRealPipeline(files["records"], REAL_BATCH, seed=SEED).epoch()), dev)]
    all_nets = ["deq", "lin", "hal", "ref"]
    cases = [{"label": "joint f32", "step": "joint", "dtype": "float32", "nets": ["deq", "lin", "hal"],
              "batch": "joint.pt"},
             {"label": "joint f64", "step": "joint", "dtype": "float64", "nets": ["deq", "lin", "hal"],
              "batch": "joint.pt", "snapshot": "joint_float32.pt"},
             {"label": "joint bf16", "step": "joint", "dtype": "bfloat16", "nets": ["deq", "lin", "hal"],
              "batch": "joint.pt"},
             {"label": "finetune f32", "step": "finetune", "dtype": "float32", "nets": all_nets,
              "batch": "finetune.pt"},
             {"label": "finetune f64", "step": "finetune", "dtype": "float64", "nets": all_nets,
              "batch": "finetune.pt", "snapshot": "finetune_float32.pt"}]
    torch.save(joint, os.path.join(root, "joint.pt"))
    torch.save(finetune, os.path.join(root, "finetune.pt"))
    single = {}
    for case in cases:
        if case["dtype"] == "float64":
            single[case["label"]] = float64_step(dev, case, torch.load(os.path.join(root, case["snapshot"])),
                                                 finetune if case["step"] == "finetune" else joint)
            continue
        dtype = getattr(torch, case["dtype"])
        case["snapshot"] = f"{case['step']}_{case['dtype']}.pt"
        step = (steps.make_finetune_train_step(dtype) if case["step"] == "finetune"
                else steps.make_joint_train_step(vgg, dtype))
        moved_inputs = 1 + MESH_F32_WITNESSES  # the step, again, then on ulp-moved inputs
        witnesses = moved_inputs + MESH_F32_WEIGHT_WITNESSES if case["dtype"] == "float32" else 0
        runs = []
        for i in range(1 + witnesses):  # then from ulp-moved weights
            state = init_multi_state(case["nets"], 1e-5, seed=SEED, device=dev, dtype=dtype)
            if i == 0:
                torch.save({k: v.cpu() for k, v in state.nets.state_dict().items()},
                           os.path.join(root, case["snapshot"]))
            if i > moved_inputs:
                sd = state.nets.state_dict()
                names = [k for k, v in sd.items() if v.is_floating_point()]
                state.nets.load_state_dict({**sd, **dict(zip(names, ulp_moved([sd[k] for k in names],
                                                                             SEED + 30 + i)))})
            batch = [t.to(dev) for t in (finetune if case["step"] == "finetune" else joint)]
            loss, _ = step(state, *(ulp_moved(batch, SEED + 10 + i) if 1 < i <= moved_inputs else batch))
            torch.cuda.synchronize()
            runs.append({"loss": loss.item(),
                         "grads": {n: p.grad.double().cpu() for n, p in state.nets.named_parameters()},
                         "stats": {n: v.double().cpu() for n, v in state.nets.named_buffers()
                                   if n.endswith(("running_mean", "running_var"))}})
            del state, batch
            torch.cuda.empty_cache()
        single[case["label"]] = {**runs[0], "witnesses": [r["grads"] for r in runs]}
        if case["label"] == "finetune f32":  # the kernels a rank's share of the batch changes, one process
            names = {}
            for b in (REAL_BATCH, REAL_BATCH // MESH_RANKS):
                state = init_multi_state(case["nets"], 1e-5, seed=SEED, device=dev, dtype=dtype)
                names[b] = card_kernel_names(lambda: step(state, *[t[:b].to(dev) for t in finetune]))
                del state
            short = {b: sorted({n.removeprefix("void ").split("<")[0].split("(")[0] for n in ns - names[other]})
                     for (b, ns), other in zip(names.items(), reversed(names))}
            print(f"  {case['label']}, one process: {len(names[REAL_BATCH])} kernels by name at b{REAL_BATCH}, "
                  f"{len(names[REAL_BATCH // MESH_RANKS])} at b{REAL_BATCH // MESH_RANKS}; only at b{REAL_BATCH}: "
                  f"{short[REAL_BATCH]}; only at b{REAL_BATCH // MESH_RANKS}: {short[REAL_BATCH // MESH_RANKS]}",
                  flush=True)
            torch.cuda.empty_cache()
    return {"root": root, "cases": cases, "single": single}


def mesh_ranks_vs_one(dev, card: str, refs: dict, shape: tuple = (MESH_RANKS, 1), labels=None,
                      extra: tuple = ()) -> tuple:
    """Phase 15 (a) (a data mesh of MESH_RANKS) and phase 16 (c)-(e) (D=1 x
    S=2, D=2 x S=2): ``refs``' cases (those of ``labels``, all for None) on
    D x S gloo ranks sharing the one card (CUDA tensors; NCCL needs a card
    a rank), each against the single-process step on the full batch from
    the same snapshot.  The joint steps by phase 10's criteria: loss within
    STEP_LOSS_REL_TOL (bf16 BF16_STEP_LOSS_REL_TOL), each gradient within
    phase 10's bound (bf16: ``bf16_net_failures`` against the
    single-process f32 and bf16 steps), the new BatchNorm statistics within
    STEP_STATS_REL_TOL (bf16: BF16_STATS_REL_TOL).  Both steps in float64:
    loss, gradients and statistics within MESH_F64_REL_TOL.  The finetune
    step in f32, and on a spatial mesh the joint step too: loss and
    statistics as above, each net's gradient distance from the float64 step
    within MESH_F32_SLACK times its witnesses' farthest (the comment at
    MESH_F64_REL_TOL says why).  Every case: the
    ranks' parameters bit-equal.  ``extra`` cases (``shard_spatial``) run
    on the same ranks first.  Returns the ranks' launches, rank-steps and
    results."""
    d, sp = shape
    root, single = refs["root"], refs["single"]
    cases = [dict(c, mesh=[d, sp], snapshot=os.path.join(root, c["snapshot"]),
                  batch=os.path.join(root, c["batch"]))
             for c in refs["cases"] if labels is None or c["label"] in labels]
    run = os.path.join(root, f"mesh_{d}x{sp}")
    os.makedirs(run)
    with open(os.path.join(run, "cases.json"), "w") as f:
        json.dump({"device": str(dev), "world": d * sp,
                   "cases": [*(dict(c, mesh=[d, sp]) for c in extra), *cases]}, f)
    t0 = time.perf_counter()
    ranks = run_mesh_ranks(run, d * sp)
    where = f"on D={d} x S={sp} ({d * sp} gloo ranks on the one card)"
    print(f"  {where}: {time.perf_counter() - t0:.1f} s wall incl. start-up", flush=True)
    failures = []
    for case in cases:
        label = case["label"]
        got, want = ranks[0][label], single[label]
        loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        stats_rel = _rel_max(got["stats"], want["stats"])
        equal = len({r[label]["digest"] for r in ranks}) == 1
        if not equal:
            failures.append(f"{label}: the ranks' parameters differ")
        if case["dtype"] == "float64":
            worst = f64_ratio(got["grads"], want["grads"])
            print(f"  {label} {where} vs one process on the full batch: loss rel {loss_rel:.3e}; "
                  f"BN statistics rel {stats_rel:.3e}; worst gradient error over its net's largest: "
                  f"{'; '.join(f'{net} {r:.3e}' for net, r in sorted(worst.items()))} (bound "
                  f"{MESH_F64_REL_TOL:.0e} each); ranks' parameters bit-equal: {equal}  [{card}]", flush=True)
            failures += [f"{label}: {what} {r:.3e}" for what, r in
                         [("loss rel", loss_rel), ("statistics rel", stats_rel)] + sorted(worst.items())
                         if not r <= MESH_F64_REL_TOL]
            continue
        bf16 = case["dtype"] == "bfloat16"
        if bf16:
            ref, noise = single["joint f32"]["grads"], want["grads"]
            report = []
            for net in ("deq", "lin", "hal"):
                dist, cos = net_distance(got["grads"], ref, net)
                noise_dist, _ = net_distance(noise, ref, net)
                bound = BF16_STEP_DEQ_TOL if net == "deq" else BF16_STEP_NOISE_FACTOR * noise_dist + 0.02
                report.append(f"{net} {dist / bound:.3f} (distance {dist:.4f}, cos {cos:.4f}; one process "
                              f"{noise_dist:.4f})")
                failures += [f"{label}: {f}" for f in bf16_net_failures(net, got["grads"], ref, noise)]
            grads = "; ".join(report)
        else:
            ratio = grad_bound_ratio(got["grads"], want["grads"])
            worst = {}
            for n, r in ratio.items():
                worst[n.split(".")[0]] = max(worst.get(n.split(".")[0], (0.0, "")), (r, n))
            grads = "; ".join(f"{net} {r:.3f} ({n})" for net, (r, n) in sorted(worst.items()))
            if label == "finetune f32" or sp > 1:
                ref = single[f"{case['step']} f64"]["grads"]
                moved_inputs = 2 + MESH_F32_WITNESSES
                again = max(grad_bound_ratio(want["witnesses"][1], want["grads"]).values())
                spread = max(max(grad_bound_ratio(w, want["grads"]).values())
                             for w in want["witnesses"][2:moved_inputs])
                moved_weights = max(max(grad_bound_ratio(w, want["grads"]).values())
                                    for w in want["witnesses"][moved_inputs:])
                report = []
                for net in sorted(worst):
                    dist, cos = net_distance(got["grads"], ref, net)
                    seen = [net_distance(w, ref, net)[0] for w in want["witnesses"]]
                    bound = MESH_F32_SLACK * max(seen)
                    report.append(f"{net} {dist:.3e} (cos {cos:.6f}; {dist / bound:.3f} of its bound; one process, "
                                  f"again, on moved inputs {', '.join(f'{d:.3e}' for d in seen[:moved_inputs])}, "
                                  f"from moved weights {', '.join(f'{d:.3e}' for d in seen[moved_inputs:])})")
                    if not dist <= bound:
                        failures.append(f"{label}: {net} distance {dist:.3e} > {MESH_F32_SLACK} x {max(seen):.3e}")
                grads += (f" (not held: the one-process step run again reads {again:.3f} from it, on inputs one ulp "
                          f"apart up to {spread:.3f}, from weights one ulp apart up to {moved_weights:.3f}); "
                          f"distance from the float64 step by net: " + "; ".join(report))
            else:
                failures += [f"{label}: {n} at {r:.3f} of phase 10's bound" for n, r in ratio.items()
                             if not r <= 1]
        loss_tol = BF16_STEP_LOSS_REL_TOL if bf16 else STEP_LOSS_REL_TOL
        stats_tol = BF16_STATS_REL_TOL if bf16 else STEP_STATS_REL_TOL
        halo = ranks[0][label].get("halo")
        halo = (f"; with each halo exchange timed alone (synchronised, so it holds the wait for the other "
                f"band): step {halo['step_ms']:.2f} ms, of it {halo['halo_ms']:.2f} ms in {halo['exchanges']} "
                f"exchanges ({halo['halo_ms'] / halo['step_ms']:.1%}), {halo['bytes'] / 2**20:.2f} MiB a band "
                f"sends" if halo else "")
        print(f"  {label} {where} vs one process on the full batch: loss rel {loss_rel:.3e} "
              f"(bound {loss_tol}); BN statistics rel {stats_rel:.3e} (bound {stats_tol:.3g}); worst "
              f"gradient ratio to the bound by net: {grads}; ranks' parameters bit-equal: {equal}; "
              f"step {ranks[0][label]['step_ms']:.2f} ms wall (median of {MESH_TIMED_STEPS}; {d * sp} processes "
              f"sharing one card over gloo, which copies through the host: not a scaling figure){halo}  "
              f"[{card}]", flush=True)
        if not loss_rel <= loss_tol:
            failures.append(f"{label}: loss rel {loss_rel:.3e}")
        if not stats_rel <= stats_tol:
            failures.append(f"{label}: BN statistics rel {stats_rel:.3e}")
    if failures:
        raise AssertionError(f"ranks {where} vs one process:\n  " + "\n  ".join(failures))
    launches = {}
    for r in ranks:
        _add_counts(launches, r["launches"])
    return launches, sum(r["rank_steps"] for r in ranks), ranks


class ExtendedBand:
    """Band ``band`` of ``spatial`` of a global [b, c, H, w] tensor as a
    mesh to the band-aware ops in one process: its halo rows are cut from
    the tensor, as ``halo_rows`` receives them (nothing beyond the image's
    edges); an op that asks for the halo of rows other than the band's own
    fails."""

    def __init__(self, whole: torch.Tensor, band: int, spatial: int):
        self.whole, self.band, self.spatial = whole, band, spatial
        self.rows = whole.shape[2] // spatial

    def own(self) -> torch.Tensor:
        return self.whole[:, :, self.band * self.rows:(self.band + 1) * self.rows].contiguous()

    def halo(self, x, top, bottom):
        r0 = self.band * self.rows
        if not torch.equal(x, self.whole[:, :, r0:r0 + self.rows]):
            raise AssertionError("a band op asked for the halo of rows not its band's")
        lo = r0 - top if self.band > 0 else r0
        hi = r0 + self.rows + bottom if self.band < self.spatial - 1 else r0 + self.rows
        return self.whole[:, :, lo:hi].contiguous()


def band_halo(name: str, args) -> int:
    """The even halo each inner side of a band gets for K2-K4."""
    from singlehdr_tpu_torch.models import hallucination, linearization

    return {"unet_stage2": 2 * (args[1].shape[-1] // 2), "lin_feature_stem": linearization.K3_HALO,
            "encoder_stage2": hallucination.K4_HALO}[name]


def band_kernels(pipe, dev) -> dict:
    """Phase 16 (b): K2, K4 (each stage of phase 3's cases) and K3 on the top
    band, a middle band and the bottom band of SPATIAL_KERNEL_BANDS at
    [KERNEL_BATCH, *, 576^2], in f32 and bf16: the kernel on the band
    extended by its even halo against its plain version on the same
    extended band, and its output cropped back to the band
    (``on_extended_band``) against the rows of the plain version on the
    whole tensor, both by phase 3's criteria (``compare_kernel``).  Returns
    the worst reading of each (kernel, dtype)."""
    from singlehdr_tpu_torch.parallel.mesh import on_extended_band

    plain = plain_versions()
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():  # as phase 3's: the packing is cached on the bf16 weights
            cases = kernel_cases(pipe, dev, dtype, odd=False)
        for name, label, args in cases:
            if name == "apply_rf":
                continue
            kernel, ref = plain[name]
            x, rest, halo = args[0], args[1:], band_halo(name, args)
            with torch.inference_mode():
                whole = ref(x, *rest)
            whole = whole if isinstance(whole, tuple) else (whole,)
            for band in (0, 1, SPATIAL_KERNEL_BANDS - 1):
                sim = ExtendedBand(x, band, SPATIAL_KERNEL_BANDS)
                ext = sim.halo(sim.own(), halo, halo)
                with torch.inference_mode():
                    _, _, rel_ext, eq_ext = compare_kernel(
                        name, f"{label} band {band} extended {tuple(ext.shape)}", kernel, ref, (ext, *rest), dtype)
                    got = on_extended_band(lambda t: kernel(t, *rest), sim.own(), halo, sim)
                got = got if isinstance(got, tuple) else (got,)
                want = tuple(w[:, :, band * w.shape[2] // sim.spatial:(band + 1) * w.shape[2] // sim.spatial]
                             for w in whole)
                _, _, rel_crop, eq_crop = compare_kernel(name, f"{label} band {band} cropped", lambda: got,
                                                         lambda: want, (), dtype)
                key = (name, str(dtype).removeprefix("torch."))
                seen = worst.setdefault(key, {"rel_extended": 0.0, "rel_cropped": 0.0, "equal": 1.0, "cases": 0})
                seen["rel_extended"] = max(seen["rel_extended"], rel_ext)
                seen["rel_cropped"] = max(seen["rel_cropped"], rel_crop)
                seen["equal"] = min(seen["equal"], eq_ext, eq_crop)
                seen["cases"] += 1
    for (name, dt), r in worst.items():
        print(f"  {name} {dt} on bands 0, 1, {SPATIAL_KERNEL_BANDS - 1} of {SPATIAL_KERNEL_BANDS} "
              f"({r['cases']} cases): kernel vs plain on the extended band, max rel err {r['rel_extended']:.3e}; "
              f"cropped vs the whole plain output's rows {r['rel_cropped']:.3e}; least share bit-equal "
              f"{r['equal']:.2%} (bounds: phase 3's)", flush=True)
    return worst


def spatial_path(dev, card: str, files: dict, work: str, refs: dict) -> tuple:
    """Phase 16: the spatial mesh axis on the one card (gloo ranks sharing
    it).  (a) ``tiled.shard_spatial`` on phase 12's first photo, 2 bands of
    512 rows, f32 and bf16, against the one-process whole-photo forward of
    the same seeded pipeline: f32 within PATH_REL_TOL of max|ref|, bf16
    PSNR >= PATH_BF16_MIN_PSNR_DB against the f32 whole photo; each rank's
    launches a forward (PER_BATCH) and the height of every K2-K4 input (its
    band + the halo of each inner side); (b) ``band_kernels``; (c), (d) the
    joint step (16 x 256^2, f32 and bf16) and the finetune step (4 x 256^2,
    f32 and float64) on D=1 x S=2, (e) the f32 joint step on D=2 x S=2,
    each held as phase 15 holds its ranks (``mesh_ranks_vs_one``); (f)
    their launches: K1 and K1-bwd, K2-K4 never; (g) each spatial step's
    time and its halo exchanges' share.  Returns the path's launches (the
    ranks') and rank-forwards of (a), and its launches and rank-steps of
    (c)-(e)."""
    from singlehdr_tpu_torch.data.hdr_io import read_ldr
    from singlehdr_tpu_torch.models import build_pipeline

    photo = read_ldr(os.path.join(files["photos"], sorted(os.listdir(files["photos"]))[0])).astype(np.float32) / 255.0
    root = os.path.join(work, "spatial")
    os.makedirs(root)
    np.save(os.path.join(root, "photo.npy"), photo)
    pipe = build_pipeline(seed=SEED, device=dev)
    with torch.inference_mode():
        whole = pipe(torch.from_numpy(photo).to(dev).permute(2, 0, 1)[None].contiguous()).hdr
        whole = whole[0].permute(1, 2, 0).cpu().numpy()
    extra = [{"kind": "shard_spatial", "label": f"shard_spatial {dt}", "dtype": dt,
              "photo": os.path.join(root, "photo.npy")} for dt in ("float32", "bfloat16")]

    print("  (b) K2-K4 on extended bands", flush=True)
    band_kernels(pipe, dev)
    del pipe
    torch.cuda.empty_cache()

    print("  (a), (c), (d) on D=1 x S=2", flush=True)
    _, _, ranks = mesh_ranks_vs_one(dev, card, refs, (1, SPATIAL_BANDS), extra=extra)
    print("  (e) on D=2 x S=2", flush=True)
    _, _, ranks22 = mesh_ranks_vs_one(dev, card, refs, (2, SPATIAL_BANDS), labels=("joint f32",))
    forward_launches, step_launches, n_forwards, n_steps, failures = {}, {}, 0, 0, []
    for r in (*ranks, *ranks22):
        for label, res in r.items():
            if label.startswith("shard_spatial"):
                _add_counts(forward_launches, res["case_launches"])
            elif isinstance(res, dict) and "case_steps" in res:
                _add_counts(step_launches, res["case_launches"])
                n_steps += res["case_steps"]
                per = {k: sum(v.values()) for k, v in res["case_launches"].items()}
                if res["case_steps"] and not (per["apply_rf"] > 0 and per["apply_rf_bwd"] > 0 and not any(
                        per[k] for k in ("unet_stage2", "lin_feature_stem", "encoder_stage2"))):
                    failures.append(f"{label}: a spatial step's launches {per}")
    print(f"  (f) the spatial steps' launches {step_launches} over {n_steps} rank-steps "
          f"(K1 and K1-bwd, K2-K4 never)", flush=True)
    for case in extra:
        label = case["label"]
        got = ranks[0][label]["out"].numpy()
        if got.shape != whole.shape or not np.isfinite(got).all():
            raise AssertionError(f"{label}: output {got.shape}, finite {np.isfinite(got).all()}")
        if not all(torch.equal(r[label]["out"], ranks[0][label]["out"]) for r in ranks if r[label]["out"] is not None):
            failures.append(f"{label}: the ranks' outputs differ")
        rel, db = float(np.abs(got - whole).max() / np.abs(whole).max()), psnr_db(got, whole)
        if case["dtype"] == "float32":
            held, bound = rel <= PATH_REL_TOL, f"rel <= {PATH_REL_TOL}"
        else:
            held, bound = db >= PATH_BF16_MIN_PSNR_DB, f"PSNR >= {PATH_BF16_MIN_PSNR_DB} dB"
        if not held:
            failures.append(f"{label}: rel {rel:.3e}, PSNR {db:.2f} dB ({bound})")
        for s, r in enumerate(ranks):
            res = r[label]
            want_counts = {k: PER_BATCH.get(k, 0) for k in res["launches"]}
            if res["launches"] != want_counts:
                failures.append(f"{label} rank {s}: launches a forward {res['launches']} != {want_counts}")
            band, sides = res["band"], (s > 0) + (s < SPATIAL_BANDS - 1)
            want_h = {"unet_stage2": [band // f + sides * 2 * (k // 2) for f, k in ((1, 7), (2, 5), (4, 3))] * 2,
                      "lin_feature_stem": [band + sides * 4], "encoder_stage2": [band + sides * 2, band // 2 + sides * 2]}
            if res["heights"] != want_h:
                failures.append(f"{label} rank {s}: K2-K4 input heights {res['heights']} != {want_h}")
            n_forwards += res["forwards"]
        print(f"  {label} on {SPATIAL_BANDS} bands of {ranks[0][label]['band']} rows vs the whole photo "
              f"{photo.shape[:2]} in one process: max_abs_err {np.abs(got - whole).max():.3e}, rel {rel:.3e}, "
              f"PSNR {db:.2f} dB ({bound}); launches a forward a rank {[r[label]['launches'] for r in ranks]}; "
              f"K2-K4 input heights (rank 0) {ranks[0][label]['heights']}, widest "
              f"{ {k: max(v) for k, v in ranks[0][label]['heights'].items()} } for a band of "
              f"{ranks[0][label]['band']}; forward {ranks[0][label]['ms']:.2f} ms wall (median of "
              f"{SPATIAL_TIMED_FORWARDS}; {SPATIAL_BANDS} processes sharing one card: not a scaling figure)  "
              f"[{card}]", flush=True)
    if failures:
        raise AssertionError("the spatial path:\n  " + "\n  ".join(failures))
    return forward_launches, n_forwards, step_launches, n_steps


def checkpoint_tensors(directory: str, step=None) -> tuple:
    """(parameters, BatchNorm statistics) of the checkpoint of ``step`` (the
    latest for None) under ``directory``, by net-prefixed name, as float64
    CPU tensors."""
    from singlehdr_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(directory)
    saved = mgr.load(mgr.latest_step if step is None else step, "cpu")["nets"]
    flat = {f"{net}.{k}": v.double() for net, sd in saved.items() for k, v in sd.items()}
    stats = {k: v for k, v in flat.items() if k.endswith(("running_mean", "running_var"))}
    return {k: v for k, v in flat.items() if k not in stats and not k.endswith("num_batches_tracked")}, stats


def ulp_moved_checkpoint(src: str, dst: str, seed: int) -> None:
    """The latest checkpoint under ``src`` written under ``dst`` with every
    float tensor of its nets moved by one f32 ulp, up or down at random
    (``ulp_moved``)."""
    from singlehdr_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(src)
    payload = mgr.load(mgr.latest_step, "cpu")
    keys = [(net, k) for net in sorted(payload["nets"]) for k, v in sorted(payload["nets"][net].items())
            if v.is_floating_point()]
    for (net, k), v in zip(keys, ulp_moved([payload["nets"][net][k] for net, k in keys], seed)):
        payload["nets"][net][k] = v
    os.makedirs(dst)
    torch.save(payload, os.path.join(dst, os.path.basename(mgr.path(mgr.latest_step))))


def mesh_clis(card: str, work: str, train_root: str, files: dict) -> tuple:
    """Phase 15 (b): cli.joint_train (MESH_CLI_ITERATIONS steps, from phase
    9's per-net checkpoints) and cli.finetune (one epoch of MESH_FT_STEPS
    steps on phase 12's two pairs cut at MESH_FT_STRIDE, batches of
    MESH_FT_BATCH, so that the epoch has no tail, which the mesh pads and
    the meshless loop does not; from phase 9's joint checkpoint), each run
    with --mesh 1 (a process group of one over NCCL, the mesh's collectives)
    and without, against each other.  joint_train: every logged loss within
    STEP_LOSS_REL_TOL, the step-1 checkpoints (one step, as phase 10) by
    their parameters within phase 10's bound (the parameters' own max and
    their net's largest) and BatchNorm statistics within STEP_STATS_REL_TOL,
    and the final parameters within phase 10's bound.  finetune: the
    epoch's logged loss, the final parameters and BatchNorm statistics each
    within those bounds or MESH_CLI_SLACK times the farthest witness's
    reading (MESH_CLI_WITNESSES: meshless runs from the joint checkpoint
    moved by one ulp, ``ulp_moved_checkpoint``, or with cuDNN's
    deterministic algorithms): Adam's first steps move each parameter by
    about lr times the sign of its gradient, so a gradient within rounding
    of zero moves a parameter 2 lr apart between two runs, and 15 steps
    carry such differences on.  Both joint_train runs use one loader worker
    and one prefetch producer, so that they train on the same batches (with
    more, the order in which threads deliver samples differs between runs).
    Returns the mesh runs' launches and steps."""
    import functools

    from singlehdr_tpu_torch.cli import convert_records, finetune, joint_train
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.train.loop import LoopConfig

    root, cwd = os.path.join(work, "mesh_clis"), os.getcwd()
    ck = os.path.join(train_root, "checkpoints")
    jnt = os.path.join(ck, "jnt")
    witnesses = MESH_CLI_WITNESSES
    records = os.path.join(root, "records")
    n_records = convert_records.run(convert_records.build_parser().parse_args(
        ["--dir", os.path.dirname(files["records"]), "--out", records, "--patch_stride", str(MESH_FT_STRIDE)]))
    if n_records != MESH_FT_STEPS * MESH_FT_BATCH:
        raise AssertionError(f"{n_records} records at stride {MESH_FT_STRIDE}, not "
                             f"{MESH_FT_STEPS} x {MESH_FT_BATCH}")
    for i, w in enumerate(w for w in witnesses if w.startswith("ulp")):
        ulp_moved_checkpoint(jnt, os.path.join(root, f"jnt_{w}"), SEED + 20 + i)
    runs = {
        "joint_train": (joint_train, "jnt/loss", "jnt", MESH_CLI_ITERATIONS, ("", "1"), lambda out, src: [
            "--dir", os.path.join(train_root, "hdr"), "--batch_size", str(TRAIN_BATCH), "--patch_size",
            str(TRAIN_HW), "--workers", "1", "--log_every", "1", "--iterations", str(MESH_CLI_ITERATIONS),
            "--deq_ckpt", os.path.join(ck, "deq"), "--lin_ckpt", os.path.join(ck, "lin"),
            "--hal_ckpt", os.path.join(ck, "hal"), "--jnt_ckpt", out]),
        "finetune": (finetune, "ref/loss", "ref", MESH_FT_STEPS, ("", "1", *witnesses), lambda out, src: [
            "--records", records, "--epochs", "1", "--batch_size", str(MESH_FT_BATCH),
            "--deq_ckpt", src, "--lin_ckpt", src, "--hal_ckpt", src, "--ref_ckpt", out]),
    }
    launches, n_steps, failures = {}, 0, []
    one_producer = functools.partial(LoopConfig, prefetch_producers=1)
    prev_config = joint_train.LoopConfig
    joint_train.LoopConfig = one_producer
    try:
        for name, (cli, tag, unit, n, variants, argv) in runs.items():
            got = {}
            for variant in variants:
                mesh = "1" if variant == "1" else ""
                here = os.path.join(root, f"{name}_{'mesh1' if mesh else variant or 'meshless'}")
                os.makedirs(here)
                os.chdir(here)  # the CLIs write their run directories under the cwd
                kernels.reset_launches()
                t0 = time.perf_counter()
                src = os.path.join(root, f"jnt_{variant}") if variant.startswith("ulp") else jnt
                with cudnn_deterministic() if variant == "cudnn_det" else contextlib.nullcontext():
                    state = cli.run(cli.build_parser().parse_args(
                        argv(os.path.join(here, unit), src) + (["--mesh", mesh] if mesh else [])))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if mesh:
                    if state.mesh is None or state.mesh.world != 1:
                        raise AssertionError(f"{name} --mesh 1 trained without a mesh of one")
                    _add_counts(launches, kernels.launch_counts_by_dtype())
                    n_steps += n
                params, stats = checkpoint_tensors(os.path.join(here, unit))
                got[variant] = {"losses": logged_losses(here, tag), "params": params, "stats": stats,
                                "step": state.step, "wall": wall}
                if name == "joint_train":
                    got[variant]["first"] = checkpoint_tensors(os.path.join(here, unit), 1)

            def readings(run: dict) -> dict:
                plain = got[""]
                return {"losses": max(abs(a - b) / abs(b) for a, b in zip(run["losses"], plain["losses"])),
                        "params": max(grad_bound_ratio(run["params"], plain["params"]).values()),
                        "stats": _rel_max(run["stats"], plain["stats"]),
                        "stats_at": max(plain["stats"], key=lambda k: float(
                            (run["stats"][k] - plain["stats"][k]).abs().max() / plain["stats"][k].abs().max()))}

            plain, meshed = got[""], got["1"]
            read = readings(meshed)
            moved_max = max((meshed["params"][k] - v).abs().max().item() for k, v in plain["params"].items())
            bounds = {"losses": STEP_LOSS_REL_TOL, "params": 1.0, "stats": STEP_STATS_REL_TOL}
            if name == "joint_train":
                first_ratio = max(grad_bound_ratio(meshed["first"][0], plain["first"][0]).values())
                first_stats = _rel_max(meshed["first"][1], plain["first"][1])
                held = (f"after step 1: parameters {first_ratio:.3e} of phase 10's bound, BN statistics rel "
                        f"{first_stats:.3e} (bound {STEP_STATS_REL_TOL}); final parameters "
                        f"{read['params']:.3e} of phase 10's bound, BN statistics rel {read['stats']:.3e} "
                        f"(not held)")
                if not (first_ratio <= 1 and first_stats <= STEP_STATS_REL_TOL):
                    failures.append(f"{name} after step 1: parameters {first_ratio:.3e}, statistics "
                                    f"{first_stats:.3e}")
                bounds["stats"] = float("inf")
            else:
                seen = [readings(got[w]) for w in witnesses]
                bounds = {k: max(b, MESH_CLI_SLACK * max(r[k] for r in seen)) for k, b in bounds.items()}
                held = (f"final parameters {read['params']:.3e} of phase 10's bound, BN statistics rel "
                        f"{read['stats']:.3e} ({read['stats_at']}); the witnesses read "
                        + "; ".join(f"{w}: losses {r['losses']:.3e}, parameters {r['params']:.3e}, statistics "
                                    f"{r['stats']:.3e} ({r['stats_at']})" for w, r in zip(witnesses, seen))
                        + f"; bounds {', '.join(f'{k} {b:.3e}' for k, b in bounds.items())}")
            print(f"  {name} --mesh 1 (NCCL, a group of one) vs without: {meshed['step']} / {plain['step']} "
                  f"steps; logged losses {[round(v, 5) for v in meshed['losses']]} vs "
                  f"{[round(v, 5) for v in plain['losses']]}, worst rel {read['losses']:.3e}; {held}; max|dp| "
                  f"{moved_max:.3e} ({moved_max / 1e-5:.2f} lr); wall {meshed['wall']:.1f} / "
                  f"{plain['wall']:.1f} s incl. set-up  [{card}]", flush=True)
            if not (meshed["step"] == plain["step"] == n and len(meshed["losses"]) == len(plain["losses"]) > 0):
                failures.append(f"{name}: steps {meshed['step']} / {plain['step']}, losses "
                                f"{meshed['losses']} / {plain['losses']}")
            failures += [f"{name}: {k} {read[k]:.3e} > {b:.3e}" for k, b in bounds.items() if not read[k] <= b]
    finally:
        joint_train.LoopConfig = prev_config
        os.chdir(cwd)
    if failures:
        raise AssertionError("--mesh 1 vs meshless:\n  " + "\n  ".join(failures))
    return launches, n_steps


def mesh_timings(dev, card: str) -> tuple:
    """Phase 15 (c): the joint step at batch 16, 256^2 (f32, bf16) on a mesh
    of one over NCCL against the meshless step, in turns (plain, mesh, mesh,
    plain; synchronised rounds), and the gradient all-reduce alone (CUDA
    events).  Returns the mesh steps' launches and steps."""
    import torch.distributed as dist

    from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.parallel import initialize_multihost, make_mesh, replicate
    from singlehdr_tpu_torch.parallel.mesh import all_reduce_gradients
    from singlehdr_tpu_torch.train import steps
    from singlehdr_tpu_torch.train.state import init_multi_state

    device = initialize_multihost(None, 1, 0, dev, mesh=True)
    launches, n_steps = {}, 0
    try:
        if device.type == "cuda" and dist.get_backend() != "nccl":
            raise AssertionError(f"a CUDA mesh took {dist.get_backend()}, not NCCL")
        mesh = make_mesh(1, device=device)
        vgg = Vgg16Features().to(dev)
        batch = joint_batch(dev, TRAIN_BATCH, TRAIN_HW, SEED + 6)
        for dtype in (torch.float32, torch.bfloat16):
            states = {"plain": init_multi_state(("deq", "lin", "hal"), 1e-5, seed=SEED, device=dev, dtype=dtype),
                      "mesh": replicate(mesh, init_multi_state(("deq", "lin", "hal"), 1e-5, seed=SEED,
                                                               device=dev, dtype=dtype))}
            step = steps.make_joint_train_step(vgg, dtype)
            times = {"plain": [], "mesh": []}
            for which in ("plain", "mesh", "mesh", "plain"):
                state = states[which]
                if which == "mesh":
                    kernels.reset_launches()
                t = step_times(lambda: step(state, *batch), REMAT_ROUNDS, REMAT_CALLS)
                if which == "mesh":
                    _add_counts(launches, kernels.launch_counts_by_dtype())
                    n_steps += 1 + REMAT_ROUNDS * REMAT_CALLS
                times[which].append(t["wall_ms"])
            params = list(states["mesh"].nets.parameters())
            n_bytes = sum(p.numel() * p.element_size() for p in params)
            reduce_ms = cuda_ms(lambda: all_reduce_gradients(mesh, params), 10)
            print(f"  joint step b{TRAIN_BATCH} @ {TRAIN_HW}^2 {str(dtype).removeprefix('torch.')}: meshless "
                  f"{times['plain'][0]:.2f}, {times['plain'][1]:.2f} ms; --mesh 1 (NCCL) {times['mesh'][0]:.2f}, "
                  f"{times['mesh'][1]:.2f} ms (median of {REMAT_ROUNDS} x {REMAT_CALLS} synchronised calls, in "
                  f"turns); the gradient all-reduce alone {reduce_ms:.3f} ms for {n_bytes / 2**20:.1f} MiB of "
                  f"f32 gradients (CUDA events, mean of 10)  [{card}]", flush=True)
            del states
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return launches, n_steps


def load_kernel_cases(dev, warm: dict, report: dict) -> None:
    """Phase 17 (b)'s kernels at serve_load's own shapes: each bucket as the
    pipeline runs it (the 32 px pad on every side) at the load's largest
    batch, K1 in f32 and K2-K4 in bf16 from serve_load's seeded weights,
    each against its plain version by phase 3's criteria.  Their max|err|
    joins the kernels' lines in ``report``."""
    from singlehdr_tpu_torch.inference import PAD
    from singlehdr_tpu_torch.models import build_pipeline

    plain = plain_versions()
    pipe = build_pipeline(seed=0, device=dev)  # serve_load's; the bf16 cases round its weights
    for bucket, sizes in warm.items():
        bh, bw = map(int, bucket.split("x"))
        hw, b = (bh + 2 * PAD, bw + 2 * PAD), max(sizes)
        with torch.no_grad():
            cases = [(torch.float32, c) for c in kernel_cases(pipe, dev, b=b, hw=hw, odd=False)
                     if c[0] == "apply_rf"]
            cases += [(torch.bfloat16, c) for c in kernel_cases(pipe, dev, torch.bfloat16, b=b, hw=hw,
                                                                 odd=False)]
        worst = {}
        with torch.inference_mode():
            for dtype, (name, label, args) in cases:
                _, abs_err, rel_err, equal = compare_kernel(name, label, *plain[name], args, dtype)
                key = name + ("_bf16" if dtype == torch.bfloat16 else "")
                report[key]["max_abs_err"] = max(report[key]["max_abs_err"], abs_err)
                w = worst.setdefault(key, [0.0, 1.0])
                w[0], w[1] = max(w[0], rel_err), min(w[1], equal)
        del cases
        print(f"  (b) kernels vs plain at bucket {bucket} ({b} x {hw[0]}x{hw[1]}): "
              + "; ".join(f"{k} rel {r:.3e}, {e:.2%} equal" for k, (r, e) in worst.items()), flush=True)
    del pipe
    torch.cuda.empty_cache()


def recipe_tools(dev, card: str, work: str, joint_bf16_ms: float, report: dict) -> dict:
    """Phase 17: the port's recipe tools on the card.  (a) the quality anchor
    at full width and reduced depth through its stage processes, then its
    final checkpoints re-evaluated in this process; (b) serve_load in bf16,
    then each kernel at its buckets' shapes against its plain version; (c)
    measure_feed at the joint configuration, beside phase 11's bf16 joint
    step.  Returns the in-process launches of the three, {kernel: {dtype: n}}
    (not (b)'s comparisons)."""
    from singlehdr_tpu_torch.cli import evaluate, infer
    from singlehdr_tpu_torch.data.real import HdrRealPipeline
    from singlehdr_tpu_torch.data.records import RecordDataset
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.tools import measure_feed, quality_anchor, serve_load

    total: dict = {}

    def counted(fn):
        kernels.reset_launches()
        result = fn()
        torch.cuda.synchronize()
        _add_counts(total, kernels.launch_counts_by_dtype())
        return result, kernels.launch_counts()

    t0 = time.perf_counter()
    root = os.path.join(work, "anchor")
    q = quality_anchor.main([*ANCHOR_ARGS, "--workdir", root, "--out", os.path.join(root, "quality.json")])
    stages = "; ".join(f"{name} {s['wall_s']} s" + (f", loss {s['first_loss']} -> {s['last_loss']}"
                                                    if s["first_loss"] else "")
                       for name, s in q["stages"].items())
    print(f"  (a) quality_anchor {' '.join(ANCHOR_ARGS)}: mu-PSNR {q['psnr_mu']} dB, mu-SSIM {q['ssim_mu']}, "
          f"linear PSNR {q['psnr_linear']} dB in {q['wall_s']} s; stages: {stages}  [{q['device']}]",
          flush=True)
    metrics = {"psnr_mu_db": q["psnr_mu"], "ssim_mu": q["ssim_mu"], "psnr_linear_db": q["psnr_linear"]}
    if sorted(q["stages"]) != sorted(ANCHOR_STAGES) or not all(
            v is not None and np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"quality_anchor: stages {sorted(q['stages'])}, metrics {metrics}")
    ref = os.path.join(root, "ck_ref")
    records = os.path.join(root, "records")
    pipe = infer.load_pipeline(infer.build_parser().parse_args(
        [a for n in ("deq", "lin", "hal", "ref") for a in (f"--{n}_ckpt", ref)]), dev)
    n_batches = len(RecordDataset(records, prefix="test")) // REAL_BATCH
    again, counts = counted(lambda: evaluate.evaluate(
        pipe, HdrRealPipeline(records, REAL_BATCH, training=False, prefix="test"), REAL_BATCH))
    check_counts(f"anchor evaluate in this process, {n_batches} batches", counts,
                 {**{k: n_batches * v for k, v in PER_BATCH.items()}, "apply_rf_bwd": 0})
    # the stage's line rounds as the JAX CLI does (dB to 1e-3, SSIM to 1e-4):
    # within the bound less half that step of it, the unrounded metrics are
    # within the bound
    delta = {k: abs(again[k] - metrics[k]) for k in metrics}
    bounds = {"psnr_linear_db": EVAL_DB_TOL - 0.5e-3, "psnr_mu_db": EVAL_DB_TOL - 0.5e-3,
              "ssim_mu": EVAL_SSIM_TOL - 0.5e-4}
    print(f"  (a) its ck_ref re-evaluated here: {again}, |diff| from the stage's rounded line {delta} "
          f"(bounds {bounds}: phase 12's {EVAL_DB_TOL} dB, SSIM {EVAL_SSIM_TOL} less the line's half "
          f"step); {time.perf_counter() - t0:.1f} s", flush=True)
    if not all(delta[k] <= bounds[k] for k in bounds):
        raise AssertionError(f"the anchor's evaluate stage and this process disagree: {delta}")
    del pipe
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    load, _ = counted(lambda: serve_load.main(
        ["--dtype", "bfloat16", "--shapes", LOAD_SHAPES, "--clients", str(LOAD_CLIENTS),
         "--batch", str(LOAD_BATCH), "--requests", str(LOAD_REQUESTS)]))
    buckets = load["latency_per_bucket"]
    pct = lambda d: f"p50 {d['p50_s'] * 1e3:.1f} / p90 {d['p90_s'] * 1e3:.1f} / p99 {d['p99_s'] * 1e3:.1f} ms"
    print(f"  (b) serve_load bf16, {LOAD_SHAPES}, {LOAD_CLIENTS} clients, max batch {LOAD_BATCH}: "
          f"{load['answered']} of {load['requests']} answered, {load['errors']} errors, "
          f"{load['device_batches']} device batches (largest {load['max_batch']}), {load['req_s']} req/s; "
          f"warm {load['warm']}; overall {pct(load['latency'])}; "
          + "; ".join(f"{b} (n {d['n']}) {pct(d)}" for b, d in buckets.items())
          + f"; {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    shapes = LOAD_SHAPES.split(",")
    if not (load["requests"] == load["answered"] == LOAD_REQUESTS and load["errors"] == 0
            and load["latency"]["n"] == LOAD_REQUESTS and len(buckets) == len(shapes)
            and all(d["n"] > 0 for d in buckets.values()) and load["max_batch"] > 1
            and all(v == [1, LOAD_BATCH] for v in load["warm"].values()) and len(load["warm"]) == len(shapes)):
        raise AssertionError(f"serve_load: {load}")
    # its timed window alone: K1 x1 (f32), K2 x6, K3 x1, K4 x2 (bf16) a batch
    check_launches({"device_batches": load["device_batches"]}, load["launches"], torch.bfloat16)
    if any(load["launches"]["apply_rf_bwd"].values()):
        raise AssertionError(f"serve_load launched K1-bwd: {load['launches']}")
    load_kernel_cases(dev, load["warm"], report)

    t0 = time.perf_counter()
    feed, counts = counted(lambda: measure_feed.main(
        ["--batch", str(TRAIN_BATCH), "--size", str(TRAIN_HW), "--scenes", str(FEED_SCENES),
         "--workdir", os.path.join(work, "feed")]))
    step_img_s = TRAIN_BATCH / joint_bf16_ms * 1e3
    rates = {k.removeprefix("feed_img_s_"): feed[k] for k in
             ("feed_img_s_native", "feed_img_s_cv2", "feed_img_s_prefetched") if k in feed}
    print(f"  (c) measure_feed b{TRAIN_BATCH} @ {TRAIN_HW}^2 over {FEED_SCENES} scenes, {feed['workers']} "
          f"loader workers, {feed['host_cores']} host cores: JPEG round trip ms a batch "
          f"{feed['jpeg_ms_per_batch']}; feed img/s {rates} (prefetched x{feed['producers']}); launches "
          f"{counts}; phase 11's bf16 joint step {joint_bf16_ms:.2f} ms = {step_img_s:.2f} img/s; feed / "
          f"device {feed['feed_img_s'] / step_img_s:.3f} (prefetched), {feed['feed_img_s_cv2'] / step_img_s:.3f} "
          f"(cv2, one producer); {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    if not (counts["apply_rf"] > 0 and all(v > 0 for v in rates.values())):
        raise AssertionError(f"measure_feed: launches {counts}, rates {rates}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    phase("1 device")
    card = card_line()
    print(card, flush=True)
    from singlehdr_tpu_torch.precision import use_full_f32

    use_full_f32()
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(dev)} x{torch.cuda.device_count()}", flush=True)

    phase("2 build")
    from singlehdr_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.lib()
    print(f"  kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.1f} s)",
          flush=True)
    check_tensor_core_sass()

    from singlehdr_tpu_torch.inference import HdrPredictor
    from singlehdr_tpu_torch.models import build_pipeline

    pipes = {torch.float32: build_pipeline(seed=SEED, device=dev),
             torch.bfloat16: build_pipeline(seed=SEED, device=dev, dtype=torch.bfloat16)}

    phase("3 kernels vs plain")
    report = check_kernels(pipes[torch.float32], dev)

    phase("4 serving")
    predictors, served = {}, {}
    for dtype, pipe in pipes.items():
        predictors[dtype] = HdrPredictor(pipe)
        t0 = time.perf_counter()
        predictors[dtype].warmup([(SERVE_HW, SERVE_HW)], batch_sizes=(1, MAX_BATCH))
        torch.cuda.synchronize()
        print(f"  {str(dtype).removeprefix('torch.')}: warmed {SERVE_HW}x{SERVE_HW} at b1, "
              f"b{MAX_BATCH} in {time.perf_counter() - t0:.1f} s", flush=True)
        served[dtype] = serve_requests(predictors[dtype])

    phase("5 whole path vs CPU plain")
    img, want, cpu_pipe, got = path_parity(pipes[torch.float32])
    path_parity_bf16(pipes[torch.bfloat16], img, want, cpu_pipe, got)
    del cpu_pipe

    phase("6 launch counters")
    for dtype, (stats, launches) in served.items():
        check_launches(stats, launches, dtype)

    phase("7 timings")
    for dtype, pipe in pipes.items():
        timings(predictors[dtype], pipe, card)
    torch.cuda.synchronize()
    del predictors, pipes
    torch.cuda.empty_cache()

    phase("8 K1-bwd vs plain")
    report["apply_rf_bwd"] = check_k1_bwd(dev)
    report["apply_rf_bwd"]["dtype"] = "float32"

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_training_and_real_paths(dev, card, report, served, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_training_and_real_paths(dev, card: str, report: dict, served: dict, work: str) -> int:
    """Phases 9-17 and the last two lines, with phase 9's and phase 12's
    files and checkpoints under ``work`` until phases 13-16 have read
    them (phase 17 writes its own there)."""
    train_root = os.path.join(work, "train")
    os.makedirs(train_root)
    phase("9 joint training through the entry point")
    train_launches = joint_training(card, train_root)

    phase("10 one-step parity, card vs CPU")
    cpu_grads = step_parity(dev)

    phase("11 training timings")
    step_ms = {dtype: train_timings(dev, card, report["apply_rf_bwd"], dtype)
               for dtype in (torch.float32, torch.bfloat16)}
    print(f"  joint step b{TRAIN_BATCH} @ {TRAIN_HW}^2: f32 {step_ms[torch.float32]:.2f} ms, bf16 "
          f"{step_ms[torch.bfloat16]:.2f} ms ({step_ms[torch.float32] / step_ms[torch.bfloat16]:.2f}x)"
          f"  [{card}]", flush=True)
    torch.cuda.synchronize()

    phase("12 HDR-Real path through the entry points")
    real_launches, real_units, real_cases, view_launches, files = hdr_real_path(dev, card, work, train_root)
    torch.cuda.synchronize()

    phase("13 checkpoint interop through the entry points")
    t0 = time.perf_counter()
    interop_launches = interop_path(dev, card, work, train_root, files)
    print(f"  phase 13: {time.perf_counter() - t0:.1f} s", flush=True)

    phase("14 remat: steps and entry points")
    t0 = time.perf_counter()
    remat_bf16_parity(dev, card, cpu_grads)
    remat_launches, remat_n = remat_steps(dev, card, files)
    remat_step_launches = {k: dict(v) for k, v in remat_launches.items()}
    _add_counts(remat_launches, remat_clis(card, work, train_root, files))
    print(f"  phase 14: {time.perf_counter() - t0:.1f} s", flush=True)

    phase("15 multi-device: two ranks on the card, --mesh 1 over NCCL")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    refs = mesh_references(dev, files, work)
    mesh_launches, mesh_steps, _ = mesh_ranks_vs_one(dev, card, refs)
    for launches, n in (mesh_clis(card, work, train_root, files), mesh_timings(dev, card)):
        _add_counts(mesh_launches, launches)
        mesh_steps += n
    path_kernels = {k: sum(mesh_launches.get(k, {}).values()) for k in SOURCES}
    print(f"  multi-device path launches {path_kernels} over {mesh_steps} rank-steps; phase 15: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not (path_kernels["apply_rf"] > 0 and path_kernels["apply_rf_bwd"] > 0
            and not any(path_kernels[k] for k in ("unet_stage2", "lin_feature_stem", "encoder_stage2"))):
        raise AssertionError(f"the multi-device path's launches: {path_kernels}")

    phase("16 spatial: bands of rows on ranks sharing the card")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    spatial_fwd, spatial_forwards, spatial_step, spatial_steps = spatial_path(dev, card, files, work, refs)
    print(f"  spatial path launches: forwards {spatial_fwd} over {spatial_forwards} rank-forwards, steps "
          f"{spatial_step} over {spatial_steps} rank-steps; phase 16: {time.perf_counter() - t0:.1f} s",
          flush=True)

    phase("17 recipe tools: quality anchor, serve_load, measure_feed")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    tools_launches = recipe_tools(dev, card, work, step_ms[torch.bfloat16], report)
    print(f"  tools path launches {tools_launches}; phase 17: {time.perf_counter() - t0:.1f} s", flush=True)

    # launches: the serving paths' (phase 4, both dtypes), the training
    # paths' (phase 9, both dtypes), the HDR-Real paths' (phase 12), the
    # interop path's (phase 13), the remat path's (phase 14, its steps and
    # CLIs) and the multi-device path's (phase 15: the ranks' steps, the
    # --mesh 1 CLI runs and the mesh steps timed; not the meshless runs they
    # are compared with) and the spatial path's (phase 16: its ranks'
    # forwards and steps, not the one-process runs they are compared with nor
    # the extended-band checks) and the tools' (phase 17, in this process: the
    # anchor's re-evaluation, serve_load's warm-up and timed window and the
    # feed's captures; not the anchor's stage processes), of each (kernel,
    # dtype); per serving batch of that
    # dtype's pipeline, per training step, per finetune step (f32 and bf16
    # runs), evaluate batch, whole photo and tile (the tiled runs less their
    # invCRF views), per phase 14 step (its CLIs not included) and per
    # multi-device rank-step (a step on one rank; the joint_train feed's
    # captures count K1 too)
    train_steps = TRAIN_STEPS + BF16_JOINT_STEPS
    kernels = []
    for name, r in report.items():
        base = name.removesuffix("_bf16")
        dt = r["dtype"]
        serve = {str(d).removeprefix("torch."): launches[base].get(dt, 0)
                 for d, (_, launches) in served.items()}
        batches = {str(d).removeprefix("torch."): stats["device_batches"]
                   for d, (stats, _) in served.items()}
        n_serve, n_train = sum(serve.values()), train_launches[base].get(dt, 0)
        real = {path: counts[base].get(dt, 0) for path, counts in real_launches.items()}
        views = N_PHOTOS * view_launches[base].get(dt, 0)
        n_interop = interop_launches[base].get(dt, 0)
        n_remat = remat_launches.get(base, {}).get(dt, 0)
        n_mesh = mesh_launches.get(base, {}).get(dt, 0)
        n_spatial_fwd = spatial_fwd.get(base, {}).get(dt, 0)
        n_spatial_step = spatial_step.get(base, {}).get(dt, 0)
        n_tools = tools_launches.get(base, {}).get(dt, 0)
        entry = {
            "name": name, "dtype": dt, "route": "cuda", "source": SOURCES[base][0],
            "replaces": SOURCES[base][1],
            "launches": (n_serve + n_train + sum(real.values()) + n_interop + n_remat + n_mesh
                         + n_spatial_fwd + n_spatial_step + n_tools),
            "launches_by_path": {"serving": n_serve, "training": n_train, **real, "interop": n_interop,
                                 "remat": n_remat, "multi_device": n_mesh,
                                 "spatial": n_spatial_fwd + n_spatial_step, "tools": n_tools},
            "launches_per_batch": {
                **{f"serving_{d}": serve[d] / batches[d] for d in serve},
                "training_step": n_train / train_steps,
                "finetune_step": (real["finetune_float32"] + real["finetune_bfloat16"])
                / real_units["finetune_step"],
                "evaluate_batch": real["evaluate"] / real_units["evaluate_batch"],
                "infer_image": real["infer_whole"] / real_units["infer_image"],
                "tiled_tile": (real["infer_tiled"] - views) / real_units["tiled_tile"],
                "interop_image": n_interop / INTEROP_IMAGES,
                "remat_step": remat_step_launches.get(base, {}).get(dt, 0) / remat_n,
                "multi_device_step": n_mesh / mesh_steps,
                "spatial_forward": n_spatial_fwd / spatial_forwards,
                "spatial_step": n_spatial_step / spatial_steps},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "operations" if r["ops_bound_ms"] >= r["bound_ms"] / 2 else "bytes",
            "library_ms": r["library_ms"],
            "hdr_real_cases": real_cases.get(name, [])}
        if base in KERNEL_LAUNCHES_PER_STAGE:
            entry["kernel_launches_per_stage"] = KERNEL_LAUNCHES_PER_STAGE[base]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # phase 15's rank processes
        sys.exit(mesh_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
