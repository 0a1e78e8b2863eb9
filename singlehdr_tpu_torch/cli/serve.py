"""Serving CLI: HTTP endpoint for single-image HDR reconstruction on the GPU
(counterpart of ``singlehdr_tpu.cli.serve``).

  python -m singlehdr_tpu_torch.cli.serve --port 8080 [--weights pipeline.npz]

POST an LDR JPEG/PNG to /predict and receive a Radiance .hdr body.  Without
``--weights`` the pipeline is initialised from a fixed seed.  ``--weights``
takes the JAX package's consolidated .npz (``cli.export_weights``), bridged
by ``convert.from_jax_variables``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from singlehdr_tpu_torch.cli import cli_device
from singlehdr_tpu_torch.convert import load_jax_variables
from singlehdr_tpu_torch.inference import HdrPredictor
from singlehdr_tpu_torch.models import build_pipeline
from singlehdr_tpu_torch.serve import make_server

INIT_SEED = 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve HDR reconstruction over HTTP")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--weights", type=str, default=None,
                   help="consolidated JAX .npz weights (default: seeded init)")
    p.add_argument("--bucket", type=int, default=64,
                   help="pad request sizes to this multiple (bounds the shapes run)")
    p.add_argument("--max_batch", type=int, default=32,
                   help="largest device batch the micro-batcher assembles")
    p.add_argument("--batch_window_ms", type=float, default=10.0,
                   help="gather window for coalescing same-bucket requests")
    p.add_argument("--warmup", type=str, default="512x512",
                   help="comma-separated HxW sizes to run at startup "
                        "(batch 1 and --max_batch each); '' disables")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def parse_sizes(spec: str):
    sizes = []
    for part in filter(None, (s.strip() for s in spec.split(","))):
        h, w = part.lower().split("x")
        sizes.append((int(h), int(w)))
    return sizes


def load_pipeline(weights: str | None, device) -> torch.nn.Module:
    pipe = build_pipeline(seed=INIT_SEED, device="cpu")
    if weights:
        with np.load(weights) as z:
            load_jax_variables(pipe, {k: z[k] for k in z.files})
    return pipe.to(device).eval()


def run(args) -> None:
    predictor = HdrPredictor(load_pipeline(args.weights, cli_device(args.device)),
                             bucket_multiple=args.bucket)
    sizes = parse_sizes(args.warmup)
    if sizes:
        print(f"warming {len(sizes)} bucket(s) at batch 1 and {args.max_batch}...")
        predictor.warmup(sizes, batch_sizes=(1, args.max_batch))
    server = make_server(predictor, args.host, args.port, max_batch=args.max_batch,
                         batch_window_s=args.batch_window_ms / 1e3)
    print(f"serving on http://{args.host}:{server.server_address[1]}  (POST /predict)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    run(build_parser().parse_args())
