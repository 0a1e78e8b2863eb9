"""Serving CLI: HTTP endpoint for single-image HDR reconstruction on the GPU
(counterpart of ``singlehdr_tpu.cli.serve``).

  python -m singlehdr_tpu_torch.cli.serve --port 8080 \
      --deq_ckpt ... --lin_ckpt ... --hal_ckpt ... --ref_ckpt ...

POST an LDR JPEG/PNG to /predict and receive a Radiance .hdr body.  The
weights are loaded as the infer CLI loads them (``cli.infer.load_pipeline``):
the four per-net checkpoint slots of the port's training (a finetune
checkpoint holds all four nets), empty slots at the seeded initialisation,
or ``--weights``, a consolidated JAX .npz (``cli.export_weights``,
``cli.import_reference``).
"""

from __future__ import annotations

import argparse

from singlehdr_tpu_torch.cli import cli_device
from singlehdr_tpu_torch.cli.infer import add_pipeline_args, load_pipeline
from singlehdr_tpu_torch.inference import HdrPredictor
from singlehdr_tpu_torch.serve import make_server


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve HDR reconstruction over HTTP")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--bucket", type=int, default=64,
                   help="pad request sizes to this multiple (bounds the shapes run)")
    p.add_argument("--max_batch", type=int, default=32,
                   help="largest device batch the micro-batcher assembles")
    p.add_argument("--batch_window_ms", type=float, default=10.0,
                   help="gather window for coalescing same-bucket requests")
    p.add_argument("--warmup", type=str, default="512x512",
                   help="comma-separated HxW sizes to run at startup "
                        "(batch 1 and --max_batch each); '' disables")
    add_pipeline_args(p)
    return p


def parse_sizes(spec: str):
    sizes = []
    for part in filter(None, (s.strip() for s in spec.split(","))):
        h, w = part.lower().split("x")
        sizes.append((int(h), int(w)))
    return sizes


def make_predictor(args) -> HdrPredictor:
    """The predictor the CLI serves, on ``--device``, weights as ``load_pipeline``
    loads them."""
    return HdrPredictor(load_pipeline(args, cli_device(args.device)), bucket_multiple=args.bucket)


def run(args) -> None:
    predictor = make_predictor(args)
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
