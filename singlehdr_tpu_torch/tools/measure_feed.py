"""Host input-pipeline feed rate of the port at the training shapes.

Measures what the HDR-Synth feed delivers, so that a training run's pace can
be read as feed-bound or device-bound.  It times:

  * the JPEG batch round trip alone: the native C++ codec (``native/``, when
    built) and the cv2 thread pool, on the same uint8 batch;
  * the port's full ``SynthBatchPipeline.next_batch`` (loader -> one packed
    upload -> capture simulation on ``--device``, K1 for the CRF -> host
    JPEG -> loss mask) with the codec on and off, and through the training
    loop's ``_Prefetcher`` with ``--producers`` threads, which is what the
    train step sees.

It is the JAX package's ``tools/measure_feed.py`` on the port.  Prints one
JSON line and writes it to ``--out`` only when one is given.

    python -m singlehdr_tpu_torch.tools.measure_feed --batch 16 --size 256
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def time_jpeg_roundtrip(batch, size, iters=8):
    """Native codec vs cv2 pool on the same uint8 batch (ms/batch each)."""
    from singlehdr_tpu_torch.data import jpeg as jpeg_mod
    from singlehdr_tpu_torch.data import native_jpeg
    from singlehdr_tpu_torch.ops.degradation import jpeg_quality_ladder

    rng = np.random.RandomState(0)
    u8 = (rng.rand(batch, size, size, 3) * 255).astype(np.uint8)
    qualities = jpeg_quality_ladder(batch)

    out = {}
    paths = [("cv2", False)]
    if native_jpeg.available():
        paths.append(("native", True))
    for name, use_native in paths:
        fn = (
            (lambda: native_jpeg.jpeg_roundtrip_batch_native(u8, qualities))
            if use_native
            else (
                lambda: np.stack(
                    [
                        jpeg_mod._pool()
                        .submit(jpeg_mod._roundtrip_one, u8[i], q)
                        .result()
                        for i, q in enumerate(qualities)
                    ]
                )
            )
        )
        fn()  # warm (pool spin-up / codec init)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out[name] = (time.perf_counter() - t0) / iters * 1000.0
    return out


def time_pipeline(synth_dir, batch, size, workers, n_batches, native,
                  producers=1, device="cuda"):
    """Full feed rate (img/s) with the codec on/off.

    ``producers=1`` times raw sequential next_batch calls; ``producers>1``
    times consumption through the training loop's _Prefetcher, which is what
    the train step actually sees (the producers overlap the per-batch
    transfer latency)."""
    from singlehdr_tpu_torch.data import native_jpeg
    from singlehdr_tpu_torch.data.synth import get_train_dataset
    from singlehdr_tpu_torch.train.loop import (
        LoopConfig,
        SynthBatchPipeline,
        _Prefetcher,
    )

    device = torch.device(device)
    orig = native_jpeg.available
    if not native:
        native_jpeg.available = lambda: False
    try:
        dataset = get_train_dataset(synth_dir, patch_size=size)
        pipe = SynthBatchPipeline(
            dataset,
            LoopConfig(batch_size=batch, n_workers=workers, use_jpeg=True),
            device,
        )
        prefetcher = None
        try:
            next_fn = pipe.next_batch
            if producers > 1:
                prefetcher = _Prefetcher(pipe.next_batch, depth=2,
                                         producers=producers)
                next_fn = prefetcher.next
            for _ in range(2 * producers):  # warm: fills the loader and the queues
                next_fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(n_batches):
                b = next_fn()
                # the consumer's view: mask is the last host-side product
                b["mask"].cpu()
            dt = time.perf_counter() - t0
            return batch * n_batches / dt
        finally:
            if prefetcher is not None:
                prefetcher.close()
            pipe.close()
    finally:
        native_jpeg.available = orig


def write_scenes(workdir: str, n: int) -> str:
    """``n`` quality-anchor scenes (seed 7) under ``workdir/synth``; a file
    already there is kept."""
    from singlehdr_tpu_torch.data.hdr_io import write_hdr
    from singlehdr_tpu_torch.tools.quality_anchor import synth_scene

    synth = os.path.join(workdir, "synth")
    os.makedirs(synth, exist_ok=True)
    rng = np.random.RandomState(7)
    for i in range(n):
        path = os.path.join(synth, f"s{i:03d}.hdr")
        if not os.path.exists(path):
            write_hdr(path, synth_scene(rng, 512, 768))
    return synth


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--producers", type=int, default=2)
    p.add_argument("--n_batches", type=int, default=12)
    p.add_argument("--scenes", type=int, default=12)
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "shdr_feed_bench"))
    p.add_argument("--out", default=None, help="also write the record to this JSON file")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu: where the capture runs")
    args = p.parse_args(argv)

    from singlehdr_tpu_torch.cli import cli_device
    from singlehdr_tpu_torch.data import native_jpeg

    device = str(cli_device(args.device))
    synth = write_scenes(args.workdir, args.scenes)

    jpeg_ms = time_jpeg_roundtrip(args.batch, args.size)
    print(
        "jpeg round-trip ms/batch:",
        {k: round(v, 1) for k, v in jpeg_ms.items()},
        flush=True,
    )

    rec = {
        "batch": args.batch,
        "size": args.size,
        "workers": args.workers,
        "device": device,
        "host_cores": os.cpu_count(),
        "jpeg_ms_per_batch": {k: round(v, 2) for k, v in jpeg_ms.items()},
        "native_available": native_jpeg.available(),
    }
    for native in ([True] if native_jpeg.available() else []) + [False]:
        img_s = time_pipeline(
            synth, args.batch, args.size, args.workers, args.n_batches, native,
            device=device,
        )
        key = "feed_img_s_native" if native else "feed_img_s_cv2"
        rec[key] = round(img_s, 2)
        print(f"feed rate ({'native' if native else 'cv2'}): {img_s:.1f} img/s",
              flush=True)
    # what the train loop consumes: prefetcher with concurrent producers
    img_s = time_pipeline(
        synth, args.batch, args.size, args.workers, args.n_batches,
        native_jpeg.available(), producers=args.producers, device=device,
    )
    rec["feed_img_s_prefetched"] = round(img_s, 2)
    rec["producers"] = args.producers
    print(f"feed rate (prefetched x{args.producers}): {img_s:.1f} img/s",
          flush=True)
    rec["feed_img_s"] = rec["feed_img_s_prefetched"]

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
