"""Profile the serving forward (or a train step) on the card: where a batch's
time goes.

  python3 -m singlehdr_tpu_torch.tools.serve_trace [--batch 8] [--steps 3] [--out DIR]
      [--dtype {float32,bfloat16}] [--train | --finetune]

Builds the seeded pipeline on the card in the compute ``--dtype`` (f32 with
TF32 off by default), warms ``predict_batch`` at the batch size and 512^2
(``--size`` x ``--width``),
then records ``--steps`` batches with ``torch.profiler`` (CPU and CUDA
activities) and exports the chrome trace to ``DIR/serve_trace.json``.  With
``--train`` it records ``--steps`` joint train steps instead (deq + lin + hal
in ``--dtype``, the f32 VGG loss, Adam; ``chip_smoke.joint_batch`` inputs at
``--batch`` x ``--size``^2, e.g. ``--batch 16 --size 256``) into
``DIR/train_trace.json``; with ``--finetune``, HDR-Real finetune steps (all
four nets in ``--dtype``, Adam; seeded 8-bit LDR and HDR at ``--batch`` x
``--size``^2, e.g. ``--batch 4 --size 256``) into
``DIR/finetune_trace.json``.  From the exported trace it prints, per batch: the
span (first to last event of the recorded window), the device's busy time
(the union of kernel, memcpy and memset intervals), the idle share, and the
busy time by kind of kernel, then the ten kernels that took the most time.
Run from the root of a checkout; it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel name fragment -> kind, first match wins
KINDS = (
    ("apply_rf", "hand K1"),
    ("conv_gemm", "hand K2 + K4"),  # conv_gemm_kernel (f32), conv_gemm_bf16_kernel
    ("lin_stem", "hand K3"),  # lin_stem_kernel (f32), lin_stem_bf16_kernel
    ("fft", "cuDNN FFT convs"),
    ("xmma", "cuDNN convs"),
    ("implicit", "cuDNN convs"),
    ("conv", "cuDNN convs"),
    ("cudnn", "cuDNN convs"),
    ("cutlass", "GEMM / convs (CUTLASS)"),
    ("gemm", "GEMM / convs (CUTLASS)"),
    ("batch_norm", "BatchNorm"),
    ("bn_", "BatchNorm"),
    ("CatArray", "cat / copies"),
    ("copy", "cat / copies"),
    ("elementwise", "elementwise"),
    ("reduce", "reductions and pools"),
    ("pool", "reductions and pools"),
)


def kind(name: str, cat: str) -> str:
    if cat != "kernel":
        return "H2D / D2H / memset"
    low = name.lower()
    for frag, label in KINDS:
        if frag.lower() in low:
            return label
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (us)."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(trace: dict, steps: int) -> dict:
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        raise RuntimeError("the trace holds no device activity")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy = busy_us([(e["ts"], e["ts"] + e["dur"]) for e in device])
    by_kind, by_name = {}, {}
    for e in device:
        k = kind(e["name"], e["cat"])
        by_kind[k] = by_kind.get(k, 0.0) + e["dur"]
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    per = 1e3 * steps  # us over the window -> ms a batch
    return {
        "span_ms": (t1 - t0) / per, "busy_ms": busy / per, "idle_share": 1 - busy / (t1 - t0),
        "device_events": len(device) / steps,
        "by_kind_ms": {k: v / per for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": {k[:120]: v / per for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:10]},
    }


def _train_steps(cs, dev, dtype, batch: int, size: int):
    """One joint train step as a callable (warmed by the caller's first call)."""
    from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
    from singlehdr_tpu_torch.train import steps
    from singlehdr_tpu_torch.train.state import init_multi_state

    state = init_multi_state(("deq", "lin", "hal"), 1e-5, seed=cs.SEED, device=dev, dtype=dtype)
    step = steps.make_joint_train_step(Vgg16Features().to(dev), dtype)
    inputs = cs.joint_batch(dev, batch, size, cs.SEED + 4)
    return lambda: step(state, *inputs)


def _finetune_steps(cs, dev, dtype, batch: int, size: int):
    """One HDR-Real finetune step as a callable: 8-bit LDR levels and a
    radiance in [0, 2), seeded."""
    from singlehdr_tpu_torch.train import steps
    from singlehdr_tpu_torch.train.state import init_multi_state

    state = init_multi_state(("deq", "lin", "hal", "ref"), 1e-5, seed=cs.SEED, device=dev,
                             dtype=dtype)
    step = steps.make_finetune_train_step(dtype)
    g = torch.Generator().manual_seed(cs.SEED + 3)
    ldr = (torch.rand(batch, 3, size, size, generator=g) * 255).round() / 255
    hdr = 2 * torch.rand(batch, 3, size, size, generator=g)
    ldr, hdr = ldr.to(dev), hdr.to(dev)
    return lambda: step(state, ldr, hdr)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--width", type=int, default=None,
                   help="serving image width (default --size: square images)")
    p.add_argument("--out", default="build/trace", help="directory of the exported trace")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="the nets' compute dtype")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true", help="trace joint train steps instead")
    mode.add_argument("--finetune", action="store_true",
                      help="trace HDR-Real finetune steps instead")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("serve_trace: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from singlehdr_tpu_torch.inference import HdrPredictor
    from singlehdr_tpu_torch.models import build_pipeline

    from singlehdr_tpu_torch.precision import use_full_f32

    use_full_f32()
    dtype = getattr(torch, args.dtype)
    dev = torch.device("cuda", 0)
    if args.train:
        run = _train_steps(cs, dev, dtype, args.batch, args.size)
    elif args.finetune:
        run = _finetune_steps(cs, dev, dtype, args.batch, args.size)
    else:
        predictor = HdrPredictor(build_pipeline(seed=cs.SEED, device=dev, dtype=dtype))
        hw = (args.size, args.width or args.size)
        predictor.warmup([hw], batch_sizes=(args.batch,))
        rs = np.random.RandomState(cs.SEED + 2)
        imgs = [rs.rand(*hw, 3).astype(np.float32) for _ in range(args.batch)]

        def run():
            predictor.predict_batch(imgs)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
    os.makedirs(args.out, exist_ok=True)
    what, name = (("joint train step", "train_trace.json") if args.train else
                  ("finetune step", "finetune_trace.json") if args.finetune else
                  ("serving", "serve_trace.json"))
    path = os.path.join(args.out, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        summary = summarize(json.load(f), args.steps)
    summary.update(card=cs.card_line(), batch=args.batch, size=args.size, width=args.width,
                   steps=args.steps, dtype=args.dtype, train=args.train, finetune=args.finetune)
    shape = f"{args.size}x{args.width}" if args.width else f"{args.size}^2"
    print(f"{what} {args.dtype} b{args.batch} @ {shape}, {args.steps} batches "
          f"[{summary['card']}]: "
          f"span {summary['span_ms']:.2f} ms a batch, busy {summary['busy_ms']:.2f} ms, "
          f"idle share {100 * summary['idle_share']:.2f} %, "
          f"{summary['device_events']:.0f} device events a batch")
    for k, v in summary["by_kind_ms"].items():
        print(f"  {k:24s} {v:9.3f} ms  {100 * v / summary['busy_ms']:5.1f} % of busy")
    print("  top kernels (ms a batch):")
    for k, v in summary["top_kernels_ms"].items():
        print(f"    {v:8.3f}  {k}")
    print("SUMMARY " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
