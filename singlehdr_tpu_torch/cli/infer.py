"""Inference CLI: LDR JPEGs / PNGs -> HDR .hdr files (counterpart of
``singlehdr_tpu.cli.infer``; the reference's test_real_refinement.py).

  python -m singlehdr_tpu_torch.cli.infer --dir photos --output_path out [--tiled]

The weights come from ``--weights``, the JAX package's consolidated .npz
(bridged by ``convert.load_jax_variables``), or else from the four per-net
checkpoint directories of the port's own training; a finetune checkpoint
holds all four nets, so every slot may point at it.  Empty slots keep the
seeded initialisation.  Runs on CUDA, f32 with TF32 off; ``--device cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from singlehdr_tpu_torch.cli import cli_device
from singlehdr_tpu_torch.convert import load_jax_variables
from singlehdr_tpu_torch.data.hdr_io import read_ldr, write_hdr
from singlehdr_tpu_torch.inference import HdrPredictor
from singlehdr_tpu_torch.models import ReverseCameraPipeline, build_pipeline
from singlehdr_tpu_torch.tiled import TiledPredictor
from singlehdr_tpu_torch.train.checkpoint import load_pretrained_nets

NETS = ("deq", "lin", "hal", "ref")
INIT_SEED = 0


def add_pipeline_args(p: argparse.ArgumentParser) -> None:
    """The four checkpoint slots, ``--weights`` and ``--device``, shared with the
    evaluate and serve CLIs."""
    cwd = os.getcwd()
    for name in NETS:
        p.add_argument(f"--{name}_ckpt", type=str, default=os.path.join(cwd, f"checkpoints/{name}"))
    p.add_argument("--weights", type=str, default=None,
                   help="consolidated JAX .npz weights (overrides the per-net ckpt dirs)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")


def build_parser() -> argparse.ArgumentParser:
    cwd = os.getcwd()
    p = argparse.ArgumentParser(description="Single-image HDR inference")
    p.add_argument("--dir", type=str, default=os.path.join(cwd, "testImg/HDR-Real-input"))
    p.add_argument("--output_path", type=str, default="HDR-Real-output")
    p.add_argument("--bucket", type=int, default=64, help="pad sizes to this multiple")
    p.add_argument("--tiled", action="store_true",
                   help="constant-shape tiled inference for very large images")
    p.add_argument("--tile", type=int, default=512)
    p.add_argument("--halo", type=int, default=64)
    add_pipeline_args(p)
    return p


def load_weights(weights: str | None, device) -> ReverseCameraPipeline:
    """The pipeline in eval mode on ``device`` from a consolidated JAX .npz
    (the seeded init without one), bridged by ``convert.load_jax_variables``."""
    pipe = build_pipeline(seed=INIT_SEED, device="cpu")
    if weights:
        with np.load(weights) as z:
            load_jax_variables(pipe, {k: z[k] for k in z.files})
    return pipe.to(device).eval()


def load_pipeline(args, device) -> ReverseCameraPipeline:
    """The pipeline in eval mode on ``device``: from ``--weights`` if given,
    else the seeded init with whatever checkpoints the four slots hold."""
    if args.weights:
        return load_weights(args.weights, device)
    pipe = build_pipeline(seed=INIT_SEED, device=device)
    load_pretrained_nets({name: getattr(pipe, name) for name in NETS},
                         {name: getattr(args, f"{name}_ckpt") for name in NETS})
    return pipe.eval()


def run(args) -> list:
    """Reconstruct every image; returns the written .hdr paths."""
    device = cli_device(args.device)
    out_dir = os.path.abspath(args.output_path)
    os.makedirs(out_dir, exist_ok=True)
    pipe = load_pipeline(args, device)
    if args.tiled:
        predictor = TiledPredictor(pipe, tile=args.tile, halo=args.halo)
    else:
        predictor = HdrPredictor(pipe, bucket_multiple=args.bucket)

    paths = sorted(glob.glob(os.path.join(args.dir, "*.jpg")))
    paths += sorted(glob.glob(os.path.join(args.dir, "*.png")))
    if not paths:
        raise FileNotFoundError(f"no .jpg/.png under {args.dir}")
    written = []
    for path in paths:
        t0 = time.perf_counter()
        rgb = read_ldr(path).astype(np.float32) / 255.0
        hdr = predictor(rgb)
        name = os.path.splitext(os.path.basename(path))[0] + ".hdr"
        written.append(os.path.join(out_dir, name))
        write_hdr(written[-1], hdr)
        print(f"{name}: {rgb.shape[1]}x{rgb.shape[0]} in {time.perf_counter() - t0:.2f}s")
    return written


if __name__ == "__main__":
    run(build_parser().parse_args())
