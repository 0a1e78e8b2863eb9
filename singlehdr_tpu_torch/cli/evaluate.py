"""Quality evaluation CLI: PSNR / SSIM of the full pipeline on HDR-Real
records (counterpart of ``singlehdr_tpu.cli.evaluate``).

Linear-domain and mu-tonemapped PSNR plus mu-tonemapped SSIM over a record
set, the prediction renormalised to mean 0.5 as the ground truth is
(finetune_real_dataset.py:47,173):

  python -m singlehdr_tpu_torch.cli.evaluate --records ./records --ref_ckpt ...

Prints one JSON line ``{"psnr_linear_db", "psnr_mu_db", "ssim_mu"}``.  Each
batch goes to the device in one packed upload and its three metrics come
back a few batches behind the newest.  Runs on CUDA, f32 with TF32 off;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from singlehdr_tpu_torch.cli import cli_device
from singlehdr_tpu_torch.cli.infer import add_pipeline_args, load_pipeline
from singlehdr_tpu_torch.data.real import HdrRealPipeline
from singlehdr_tpu_torch.ops.tonemap import mu_tonemap
from singlehdr_tpu_torch.train.loop import LaggedReadback, upload_pair
from singlehdr_tpu_torch.train.metrics import Mean, psnr, ssim

METRICS = ("psnr_linear_db", "psnr_mu_db", "ssim_mu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate pipeline PSNR/SSIM")
    p.add_argument("--records", type=str, required=True)
    p.add_argument("--prefix", type=str, default="train")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_batches", type=int, default=0, help="0 = full set")
    p.add_argument(
        "--linear_peak", type=float, default=1.0,
        help="fixed peak for linear-domain PSNR; both pred and gt are mean-0.5 "
        "renormalized, so any fixed constant gives run-comparable numbers "
        "(a per-batch gt.max() would make the metric depend on batch composition)",
    )
    add_pipeline_args(p)
    return p


def batch_metrics(pipe, ldr: torch.Tensor, gt: torch.Tensor, linear_peak: float) -> torch.Tensor:
    """[3] on the device: linear PSNR, mu PSNR and mu SSIM of one NCHW batch."""
    with torch.inference_mode():
        out = pipe(ldr).hdr
        pred = out / (1e-6 + torch.mean(out, dim=(1, 2, 3), keepdim=True)) * 0.5
        pred_mu, gt_mu = mu_tonemap(pred), mu_tonemap(gt)
        return torch.stack([psnr(pred, gt, max_val=linear_peak), psnr(pred_mu, gt_mu),
                            ssim(pred_mu, gt_mu)])


def evaluate(pipe, data: HdrRealPipeline, batch_size: int, max_batches: int = 0,
             linear_peak: float = 1.0) -> dict:
    """Mean metrics over ``data``'s full batches (the short tail is skipped)."""
    device = next(pipe.parameters()).device
    pending = LaggedReadback(lag=3)
    for i, (ldr, hdr) in enumerate(data.epoch()):
        if max_batches and i >= max_batches:
            break
        if ldr.shape[0] != batch_size:
            continue
        pending.push(batch_metrics(pipe, *upload_pair(ldr, hdr, device), linear_peak))
    means = {k: Mean(k) for k in METRICS}
    for values in pending.drain():
        for k, v in zip(METRICS, values):
            means[k].update(float(v))
    return {k: m.result() for k, m in means.items()}


def run(args) -> dict:
    """Evaluate; prints and returns the metrics, rounded as the JAX CLI rounds them."""
    pipe = load_pipeline(args, cli_device(args.device))
    data = HdrRealPipeline(args.records, batch_size=args.batch_size, training=False,
                           prefix=args.prefix)
    means = evaluate(pipe, data, args.batch_size, args.max_batches, args.linear_peak)
    results = {k: round(v, 4 if k == "ssim_mu" else 3) for k, v in means.items()}
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    run(build_parser().parse_args())
