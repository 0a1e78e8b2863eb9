"""HDR-Synth validation CLI: held-out deq and lin metrics (counterpart of
``singlehdr_tpu.cli.validate_synth``; the reference builds validation splits,
dataset.py:279-310, that no driver consumes).

Forward-only metrics over the validation split: deq PSNR on quantized inputs,
the linearized irradiance's PSNR and the inverse-CRF MSE, on held-out CRFs
and a 5-step exposure ladder.  Each batch's capture is simulated on the
device from a generator seeded with the batch index:

  python -m singlehdr_tpu_torch.cli.validate_synth --hdrdir /data/HDR-Synth

deq and lin come from one-net or multi-net (joint) checkpoints.  Runs on
CUDA, f32 with TF32 off; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from singlehdr_tpu_torch.cli import cli_device
from singlehdr_tpu_torch.data.loader import RandomSampleLoader
from singlehdr_tpu_torch.data.synth import get_validation_dataset
from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf
from singlehdr_tpu_torch.ops.degradation import CaptureSim, simulate_capture
from singlehdr_tpu_torch.train.checkpoint import load_pretrained_nets
from singlehdr_tpu_torch.train.loop import LaggedReadback, to_nchw, upload_packed
from singlehdr_tpu_torch.train.metrics import Mean, psnr
from singlehdr_tpu_torch.train.state import init_nets

METRICS = ("deq_psnr", "lin_psnr", "crf_mse")
INIT_SEED = 0


def build_parser() -> argparse.ArgumentParser:
    cwd = os.getcwd()
    p = argparse.ArgumentParser(description="Validate deq/lin on held-out HDR-Synth")
    p.add_argument("--hdrdir", type=str, required=True)
    p.add_argument("--deq_ckpt", type=str, default=os.path.join(cwd, "checkpoints/deq"))
    p.add_argument("--lin_ckpt", type=str, default=os.path.join(cwd, "checkpoints/lin"))
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--batches", type=int, default=16)
    p.add_argument("--size", type=int, default=512,
                   help="center-crop validation patches to this size")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def synth_metrics(nets, sim: CaptureSim, invcrf: torch.Tensor) -> torch.Tensor:
    """[3] on the device: deq PSNR on the quantized capture against its LDR,
    the linearized irradiance's PSNR against the clipped exposure, and the
    inverse CRF's MSE."""
    with torch.inference_mode():
        jpeg = sim.quantized_u8.float() / 255.0  # quantization only
        c_pred = torch.clamp(nets["deq"](jpeg), 0.0, 1.0)
        pred_invcrf = nets["lin"](sim.ldr)
        b_pred = apply_rf(sim.ldr, pred_invcrf)
        return torch.stack([psnr(c_pred, sim.ldr), psnr(b_pred, sim.clipped_hdr_t),
                            torch.mean(torch.square(pred_invcrf - invcrf))])


def run(args) -> dict:
    """Validate; prints and returns the means, rounded as the JAX CLI rounds them."""
    device = cli_device(args.device)
    nets = init_nets(("deq", "lin"), seed=INIT_SEED, device=device).eval()
    load_pretrained_nets(nets, {"deq": args.deq_ckpt, "lin": args.lin_ckpt})
    pending = LaggedReadback(lag=3)
    with RandomSampleLoader(get_validation_dataset(args.hdrdir), args.batch_size,
                            n_workers=8) as loader:
        for i in range(args.batches):
            hdr, crf, invcrf, t = loader.read_batch()
            if hdr.shape[1] > args.size:
                off = (hdr.shape[1] - args.size) // 2
                hdr = hdr[:, off:off + args.size, off:off + args.size]
            hdr, crf, invcrf, t = upload_packed(
                [np.asarray(a, np.float32) for a in (hdr, crf, invcrf, t)], device)
            sim = simulate_capture(torch.Generator(device=device).manual_seed(i), to_nchw(hdr),
                                   crf, t)
            pending.push(synth_metrics(nets, sim, invcrf))
    means = {k: Mean(k) for k in METRICS}
    for values in pending.drain():
        for k, v in zip(METRICS, values):
            means[k].update(float(v))
    results = {k: round(m.result(), 4) for k, m in means.items()}
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    run(build_parser().parse_args())
