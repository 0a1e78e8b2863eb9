"""Mixed-shape serving load test: latency percentiles per bucket.

Drives the port's HTTP server (``serve.make_server`` over
``inference.HdrPredictor``) with concurrent clients posting JPEGs of mixed
sizes, then prints the ``/stats`` snapshot (p50/p90/p99 overall and per
padded bucket) as one JSON line.  The JAX package's ``tools/serve_load.py``
driving the port, with three of its faults fixed:

- every bucket is warmed at batch 1 and at ``--batch`` before the timed
  window, as the serve CLI warms (the predictor pads a group up to a warm
  size, so those two cover every group); the JAX tool warmed batch 1 only;
- ``--dtype`` sets the pipeline's compute dtype (the JAX tool ignored it);
- the first ``--requests % --clients`` clients send one request more, so
  exactly ``--requests`` are sent (the JAX tool dropped the remainder).

    python -m singlehdr_tpu_torch.tools.serve_load --requests 96 --clients 8 \
        --shapes 384x512,512x512,256x384

The pipeline is the seeded initialisation (``build_pipeline(seed=0)``).  The
record also gives the warm batch sizes of each bucket (``warm``) and each
kernel's launches by dtype in the timed window (``launches``).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request

import numpy as np


def client_counts(requests: int, clients: int) -> list:
    """Requests per client, summing to ``requests``."""
    return [requests // clients + (i < requests % clients) for i in range(clients)]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--requests", type=int, default=96, help="total requests")
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--shapes", default="384x512,512x512,256x384")
    p.add_argument("--batch", type=int, default=8,
                   help="micro-batcher max batch")
    p.add_argument("--bucket_multiple", type=int, default=64)
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="bfloat16")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)

    import cv2

    from singlehdr_tpu_torch.cli import DTYPES, cli_device
    from singlehdr_tpu_torch.cli.serve import parse_sizes
    from singlehdr_tpu_torch.inference import HdrPredictor
    from singlehdr_tpu_torch.models import build_pipeline
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.serve import make_server

    shapes = parse_sizes(args.shapes)
    pipe = build_pipeline(seed=0, device=cli_device(args.device), dtype=DTYPES[args.dtype])
    predictor = HdrPredictor(pipe, bucket_multiple=args.bucket_multiple)
    predictor.warmup(shapes, batch_sizes=(1, args.batch))
    warm = {"x".join(map(str, k)): v for k, v in predictor.warm_sizes().items()}
    rng = np.random.RandomState(0)
    bodies = []
    for h, w in shapes:
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        ok, buf = cv2.imencode(".jpg", img)
        if not ok:
            raise RuntimeError(f"JPEG encode of a {h}x{w} image failed")
        bodies.append(buf.tobytes())

    answered = [0] * args.clients
    per = client_counts(args.requests, args.clients)
    srv = make_server(predictor, "127.0.0.1", 0, max_batch=args.batch)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        def client(idx: int, n: int):
            r = np.random.RandomState(idx)
            for _ in range(n):
                body = bodies[r.randint(len(bodies))]
                try:
                    urllib.request.urlopen(
                        urllib.request.Request(f"{url}/predict", data=body), timeout=600
                    ).read()
                    answered[idx] += 1
                except OSError:  # an error reply; /stats counts it too
                    pass

        threads = [threading.Thread(target=client, args=(i, n)) for i, n in enumerate(per)]
        before = kernels.launch_counts_by_dtype()
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t0
        after = kernels.launch_counts_by_dtype()
        stats = json.loads(
            urllib.request.urlopen(f"{url}/stats", timeout=60).read()
        )
    finally:
        srv.shutdown()
        srv.server_close()
    out = {
        "requests": sum(per),
        "answered": sum(answered),
        "errors": stats.get("errors"),
        "clients": args.clients,
        "shapes": args.shapes,
        "dtype": args.dtype,
        "wall_s": round(wall, 2),
        "req_s": round(sum(answered) / wall, 2),
        "latency": stats.get("latency", {}),
        "latency_per_bucket": stats.get("latency_per_bucket", {}),
        "device_batches": stats.get("device_batches"),
        "max_batch": stats.get("max_batch"),
        "warm": warm,
        "launches": {k: {dt: n - before[k].get(dt, 0) for dt, n in v.items()}
                     for k, v in after.items()},
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
