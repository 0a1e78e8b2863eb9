"""GPU smoke run of the PyTorch port: builds the five CUDA kernels, holds each
against its plain PyTorch version at the serving and training shapes, serves
a few requests through the port's HTTP server and trains the joint
configuration through the ``joint_train`` CLI, both at the full published
widths, and checks each path against the CPU plain path.

  python3 chip_smoke.py          (from the root of a checkout, one CUDA card)

Phases (each prints its own lines; any failure exits non-zero):
  1 device   card name and power limit (nvidia-smi); TF32 off, true f32
  2 build    nvcc build of singlehdr_tpu_torch/csrc into build/kernels/ (one
             nvcc per source, in parallel); K2/K4's conv kernel and K3's
             kernel hold tensor-core instructions in their SASS (K3: HGMMA)
  3 kernels  K1..K4 vs plain at batch 4, 576x576 (512 + the 32 px pad), K3 at
             an odd [1, 3, 37, 53] and K4 at an odd [1, 64, 37, 53] (the ceil
             edge of its SAME pool): K1 bit-equal; K2..K4 max|err| /
             max|plain| <= 1e-4; each case's kernel ms, plain ms, bound ms and
             share of the bound; the library routes of K1 (grid_sample) and
             K3 (cuDNN's f32 conv over the stack built beforehand) held to the
             plain versions and timed; K1 and grid_sample also timed with the
             L2 flushed before each call
  4 serving  seeded ReverseCameraPipeline on the card behind make_server;
             4 client threads POST 8 JPEG 512x512 images
  5 parity   one 512x512 image on the card vs the CPU plain path
  6 launches every kernel counted during phase 4, per batch K1 x1, K2 x6,
             K3 x1, K4 x2
  7 timing   p50 latency and img/s at batch 1 and 8, per-net times at batch 8
  8 K1-bwd   vs plain at [16, 3*256^2] and [4, 3*576^2], and with every
             x = 1.0 at [16, 3*256^2]: gx bit-equal (also gx alone), grf
             max|err| / max|plain| <= 1e-5 against the plain version in
             float64 and the same bits on three launches (gx + grf twice,
             grf alone); times warm and with the L2 flushed, with the share
             of the bound (12 bytes a pixel; 8 for grf alone); the library
             route (grid_sample's backward) held to the plain version and
             timed; a curve longer than the kernel's plan raises
  9 training cli.joint_train.run at batch 16, 256^2 on synthetic .hdr files:
             6 steps, then a resume to 8; K1-bwd once per step, K2..K4 never;
             one cli.train --lin step
  10 parity  one joint step, card vs CPU, at 2 x 64^2, every gradient tensor
             within 2e-3 of its own max + 1e-3 of its net's max, and planted
             faults (a zeroed or sign-flipped gradient) flagged by that bound;
             one finetune step at 4 x 256^2 on the card (K1-bwd's gx branch)
  11 timing  joint step at batch 16, 256^2: forward + loss, backward, Adam;
             K1-bwd's share of the step
The second-to-last line is the kernels' JSON record (with each kernel's
launches per serving batch and per training step, its bound, and the library
route's time where PyTorch computes the same function: grid_sample for K1,
its backward for K1-bwd, cuDNN's convs + the pool for K2 and K4, cuDNN's
stride-2 conv + ReLU over the 93-channel stack built beforehand for K3), the
last the result.  K2 and K4 count one launch a stage call, which
makes two launches of the conv kernel (``kernel_launches_per_stage``).

Kernel, plain and library times (phases 3 and 8) are device times of
back-to-back calls with the host kept ahead (``device_ms``): K1 runs for less
time than its wrapper's host work, which a plain CUDA-event loop would time
instead.  Per-net times (phase 7) are CUDA-event times of whole nets.

A kernel's bound is the least time the card could take for its work: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its FLOP over 165 TFLOP/s, the rate of f32-accurate products on
the tensor cores (three TF32 products each, 495 / 3); the 67 TFLOP/s of f32 on
the CUDA cores is printed beside it.  Peaks: NVIDIA's H100 SXM data sheet.
"""

from __future__ import annotations

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
# tensors whose gradient, zeroed or sign-flipped on the card's side, the bound
# must flag: small ones (BN scale and shift) and lin's dense head
PLANTED_FAULTS = ("lin.crf_feature_net.stem_bn.weight", "lin.crf_feature_net.stem_bn.bias",
                  "lin.pca_head.weight", "hal.dec1.bn.bias")

# per batch of the pipeline: launches of each kernel
PER_BATCH = {"apply_rf": 1, "unet_stage2": 6, "lin_feature_stem": 1, "encoder_stage2": 2}
HBM_BYTES_PER_S = 3.35e12
SLEEP_CYCLES_PER_S = 2.0e9  # device_ms's lead: at least the SM clock (1.98 GHz at most)
F32_TENSOR_FLOPS = 495e12 / 3   # 3xTF32
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
    """Phase 2: K2/K4's conv kernel and K3's kernel run on the tensor cores:
    every conv instantiation's SASS (cuobjdump of the built library) holds
    HMMA (mma.sync) or HGMMA (wgmma) instructions, and K3's holds HGMMA."""
    from pathlib import Path

    from singlehdr_tpu_torch.ops.cuda import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build.build())], capture_output=True,
                          text=True, check=True).stdout
    functions = sass.split("Function : ")[1:]
    convs = [f for f in functions if "conv_gemm_kernel" in f.split()[0]]
    counts = [(f.count(" HMMA."), f.count(" HGMMA.")) for f in convs]
    per = [hmma + hgmma for hmma, hgmma in counts]
    print(f"  conv_gemm_kernel: {len(convs)} instantiations; tensor-core instructions in SASS: "
          f"HMMA {sum(c[0] for c in counts)}, HGMMA {sum(c[1] for c in counts)} "
          f"(per instantiation {min(per, default=0)}..{max(per, default=0)})", flush=True)
    if not convs or not min(per) > 0:
        raise AssertionError("K2/K4's conv kernel has instantiations without tensor-core "
                             "instructions in its SASS")
    stems = [f for f in functions if "lin_stem_kernel" in f.split()[0]]
    hgmma = sum(f.count(" HGMMA.") for f in stems)
    print(f"  lin_stem_kernel: {len(stems)} function(s); HGMMA {hgmma}", flush=True)
    if not stems or not hgmma > 0:
        raise AssertionError("K3's kernel has no HGMMA (wgmma) instructions in its SASS")


def kernel_cases(pipe, dev):
    """(kernel name, case label, wrapper args) at the main path's shapes, with
    the pipeline's own conv weights; inputs of a later stage are the plain
    outputs of the stage before it.  The seeded init has zero biases, so the
    cases add seeded biases to exercise the kernels' bias path."""
    from singlehdr_tpu_torch.ops import color
    from singlehdr_tpu_torch.ops.curves import monotonic_rf
    from singlehdr_tpu_torch.ops.cuda.enc_pool_cuda import encoder_stage2_plain
    from singlehdr_tpu_torch.ops.cuda.unet_stage_cuda import unet_stage2_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    hw = SERVE_HW + 64
    b = KERNEL_BATCH
    img = torch.rand(b, 3, hw, hw, generator=g, device=dev)
    cases = []

    x = img * 1.4 - 0.2  # includes inputs outside [0, 1]
    raw = torch.rand(b, 1024, generator=g, device=dev)
    cases.append(("apply_rf", f"{tuple(x.shape)}", (x.contiguous(), monotonic_rf(raw).contiguous())))

    def bias(n):
        return (torch.randn(n, generator=g, device=dev) * 0.1).contiguous()

    for net, cin in (("deq", 3), ("ref", 9)):
        unet = getattr(pipe, net).unet
        h = torch.rand(b, cin, hw, hw, generator=g, device=dev)
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


def bound(flop: float, moved: int) -> tuple:
    """(bound ms, what sets it, the f32 CUDA-core bound ms)."""
    ops_ms, bytes_ms = flop / F32_TENSOR_FLOPS * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes",
            max(flop / F32_SIMT_FLOPS * 1e3, bytes_ms))


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
    """K3's conv as one PyTorch call on the prebuilt stack: cuDNN's f32
    stride-2 conv (TF32 off in phase 1), then ReLU."""
    return torch.relu(torch.nn.functional.conv2d(feats, k7, b7, stride=2))


def k3_library_error(feats, k7, b7, want: torch.Tensor) -> float:
    """max|err| / max|plain| of K3's library route against K3's plain output."""
    got = lin_stem_library(feats, k7, b7)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    if not rel <= LIBRARY_REL_TOL:
        raise AssertionError(f"the conv over the prebuilt stack is not K3's function: rel {rel:.3e}")
    return rel


def check_kernels(pipe, dev) -> dict:
    from singlehdr_tpu_torch.ops.cuda import apply_rf_cuda, enc_pool_cuda, lin_stem_cuda, unet_stage_cuda

    plain = {
        "apply_rf": (apply_rf_cuda.apply_rf, apply_rf_cuda.apply_rf_plain),
        "unet_stage2": (unet_stage_cuda.unet_stage2, unet_stage_cuda.unet_stage2_plain),
        "lin_feature_stem": (lin_stem_cuda.lin_feature_stem, lin_stem_cuda.lin_feature_stem_plain),
        "encoder_stage2": (enc_pool_cuda.encoder_stage2, enc_pool_cuda.encoder_stage2_plain),
    }
    report = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "ops_bound_ms": 0.0, "simt_bound_ms": 0.0,
                  "library_ms": 0.0} for n in plain}
    with torch.inference_mode():
        for name, label, args in kernel_cases(pipe, dev):
            kernel, ref = plain[name]
            got, want = kernel(*args), ref(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, w in zip(got, want):
                if a.shape != w.shape:
                    raise AssertionError(f"{name} {label}: shape {tuple(a.shape)} != {tuple(w.shape)}")
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{name} {label}: non-finite output")
                if not w.abs().max() > 0:
                    raise AssertionError(f"{name} {label}: all-zero reference, nothing compared")
            abs_err = max((a - w).abs().max().item() for a, w in zip(got, want))
            rel_err = max(((a - w).abs().max() / w.abs().max()).item() for a, w in zip(got, want))
            if name == "apply_rf":
                if not all(torch.equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(f"apply_rf {label}: not bit-equal (max err {abs_err})")
            elif not rel_err <= KERNEL_REL_TOL:
                raise AssertionError(f"{name} {label}: rel err {rel_err:.3e} > {KERNEL_REL_TOL}")
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
                library = f"  library (cuDNN conv on the prebuilt stack) {lib_ms:.3f} ms, rel {lib_rel:.3e}"
                del feats
            else:
                lib_ms = plain_ms  # K2, K4: cuDNN's convs + the pool
            flop, moved = kernel_flop(name, args), nbytes(args) + nbytes(want)
            bound_ms, bound_by, simt_ms = bound(flop, moved)
            r = report[name]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            r["max_rel_err"] = max(r["max_rel_err"], rel_err)
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["library_ms"] += lib_ms
            r["bound_ms"] += bound_ms
            r["ops_bound_ms"] += bound_ms if bound_by == "operations" else 0.0
            r["simt_bound_ms"] += simt_ms
            print(f"  {name:17s} {label:36s} max_abs_err {abs_err:.3e} rel {rel_err:.3e} "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  bound {bound_ms:.4f} ms "
                  f"({bound_by}; f32 CUDA cores {simt_ms:.3f})  share {bound_ms / ms:.1%}  "
                  f"{flop / 1e9:.1f} GFLOP {moved / 1e6:.1f} MB  {flop / ms / 1e9:.1f} TFLOP/s"
                  f"{library}", flush=True)
    torch.cuda.synchronize()
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
    """Phase 4: POST N_REQUESTS JPEGs from N_CLIENTS threads; returns (stats, launches)."""
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
        launches = kernels.launch_counts()
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


def check_launches(stats: dict, launches: dict) -> None:
    batches = stats["device_batches"]
    print(f"  launches {launches} over {batches} device batches", flush=True)
    for name, per in PER_BATCH.items():
        if launches[name] != per * batches:
            raise AssertionError(
                f"{name}: {launches[name]} launches, expected {per} x {batches} batches"
            )


def path_parity(pipe) -> None:
    """Phase 5: the served output of one image on the card vs the CPU plain path."""
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
    print(f"  card vs CPU plain: max_abs_err {np.abs(got - want).max():.3e} "
          f"max|ref| {np.abs(want).max():.4f} rel {rel:.3e} (bound {PATH_REL_TOL}); "
          f"CPU forward {cpu_s:.1f} s", flush=True)
    if not rel <= PATH_REL_TOL:
        raise AssertionError(f"served path differs from the CPU plain path: rel {rel:.3e}")


def timings(predictor, pipe, card: str) -> None:
    rs = np.random.RandomState(SEED + 2)
    imgs = [rs.rand(SERVE_HW, SERVE_HW, 3).astype(np.float32) for _ in range(MAX_BATCH)]
    for n, reps in ((1, 20), (MAX_BATCH, 8)):
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            predictor.predict_batch(imgs[:n])
            lat.append(time.perf_counter() - t0)
        p50 = float(np.median(lat))
        print(f"  b{n} @ {SERVE_HW}^2: p50 {p50 * 1e3:.1f} ms/request batch, "
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
    print("  per-net ms at b%d: %s  [%s]" % (
        MAX_BATCH, ", ".join(f"{k} {v:.2f}" for k, v in per_net.items()), card), flush=True)


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


def joint_training(card: str) -> dict:
    """Phase 9: the joint configuration through cli.joint_train.run, then a
    resume, then one cli.train --lin step.  Returns the summed launch counts."""
    from singlehdr_tpu_torch.cli import joint_train, train
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.train.checkpoint import CheckpointManager

    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cwd = os.getcwd()
    total = dict.fromkeys(kernels.KERNELS, 0)
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
            total = {k: total[k] + counts[k] for k in total}
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
        total = {k: total[k] + counts[k] for k in total}
        lin_losses = logged_losses(root, "lin/loss")
        if CheckpointManager(ck["lin"]).steps() != [1] or not np.isfinite(lin_losses).all():
            raise AssertionError(f"lin run: checkpoints {CheckpointManager(ck['lin']).steps()}, "
                                 f"losses {lin_losses}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
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


def step_parity(dev) -> None:
    """Phase 10: one joint step on the card vs the same step on the CPU, then
    one finetune step on the card."""
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


def train_timings(dev, card: str, bwd_report: dict) -> None:
    """Phase 11: the joint step at batch 16, 256^2, split with CUDA events."""
    from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
    from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf_bwd
    from singlehdr_tpu_torch.train import steps
    from singlehdr_tpu_torch.train.state import init_multi_state

    state = init_multi_state(("deq", "lin", "hal"), 1e-5, seed=SEED, device=dev)
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
    print(f"  joint step b{TRAIN_BATCH} @ {TRAIN_HW}^2 f32, median of {len(rows)}: {total:.2f} ms device "
          f"({wall:.2f} ms wall), {TRAIN_BATCH / total * 1e3:.2f} img/s; forward+loss {fwd:.2f} ms, "
          f"backward {bwd:.2f} ms, optimizer.step {opt:.2f} ms; peak memory {peak:.2f} GiB; "
          f"K1-bwd on this step's ldr {step_bwd_ms:.4f} ms = {100 * step_bwd_ms / total:.4f} % of the "
          f"step, on phase 8's saturated input {hot_bwd_ms:.4f} ms = {100 * hot_bwd_ms / total:.4f} %  "
          f"[{card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    phase("1 device")
    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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

    pipe = build_pipeline(seed=SEED, device=dev)

    phase("3 kernels vs plain")
    report = check_kernels(pipe, dev)

    phase("4 serving")
    predictor = HdrPredictor(pipe)
    t0 = time.perf_counter()
    predictor.warmup([(SERVE_HW, SERVE_HW)], batch_sizes=(1, MAX_BATCH))
    torch.cuda.synchronize()
    print(f"  warmed {SERVE_HW}x{SERVE_HW} at b1, b{MAX_BATCH} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    stats, launches = serve_requests(predictor)

    phase("5 whole path vs CPU plain")
    path_parity(pipe)

    phase("6 launch counters")
    check_launches(stats, launches)

    phase("7 timings")
    timings(predictor, pipe, card)
    torch.cuda.synchronize()
    del predictor, pipe
    torch.cuda.empty_cache()

    phase("8 K1-bwd vs plain")
    report["apply_rf_bwd"] = check_k1_bwd(dev)

    phase("9 joint training through the entry point")
    train_launches = joint_training(card)

    phase("10 one-step parity, card vs CPU")
    step_parity(dev)

    phase("11 training timings")
    train_timings(dev, card, report["apply_rf_bwd"])
    torch.cuda.synchronize()

    # launches: the serving path's (phase 4) plus the training path's (phase 9);
    # per serving batch and per training step as counted in those runs
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": launches.get(name, 0) + train_launches[name],
         "launches_by_path": {"serving": launches.get(name, 0), "training": train_launches[name]},
         "launches_per_batch": {"serving": launches.get(name, 0) / stats["device_batches"],
                                "training_step": train_launches[name] / TRAIN_STEPS},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"],
         "bound_by": "operations" if r["ops_bound_ms"] >= r["bound_ms"] / 2 else "bytes",
         "library_ms": r["library_ms"]}
        for name, r in report.items()
    ]
    for k in kernels:
        if k["name"] in KERNEL_LAUNCHES_PER_STAGE:
            k["kernel_launches_per_stage"] = KERNEL_LAUNCHES_PER_STAGE[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
