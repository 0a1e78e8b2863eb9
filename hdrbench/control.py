"""The controls of the checks: the reference put in the program's place in
the precision just below the configuration's (``reference.precision``),
read by the cell's own check at the cell's sizes, one reading a seed.

  python3 -m hdrbench.control --workload <cell> --seeds 1,2,3 [--out FILE]

The benchmark's runs do not run it.  ``batch``: the first ``check_images``
images of the run's pool, TF32 against float32.  ``serve``: ``check_per_size``
JPEGs of each size's pool, the TF32 output encoded as the server encodes,
against float32.  ``train``: ``checked_steps`` batches from the program's
feed at the cell's settings, the reference's steps in float8 against
float32 (loss, gradient and change gaps as the run's check takes them).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from hdrbench import scenes, system
from hdrbench.harness import Cell, full_f32, load_json
from hdrbench.reference import capture, geometry
from hdrbench.reference import nets as R
from hdrbench.reference import precision
from hdrbench.run import resolve
from hdrbench.weights import generator


def _pipeline(cell, wts, tf32: bool):
    refine = cell.config["use_refinement"]

    def run(x):
        if tf32:
            with precision.tf32():
                return R.pipeline(R.F32, x, wts, refine_output=refine)
        return R.pipeline(R.F32, x, wts, refine_output=refine)
    return run


def batch_control(cell) -> dict:
    from hdrbench.drivers.batch import POOL_TAG

    t = cell.traffic
    wts = system.weights(cell)
    imgs = scenes.ldr_images(generator(cell.seed, cell.device, POOL_TAG), t["check_images"],
                             t["height"], t["width"], cell.device)
    imgs = [im.astype(np.float32) * np.float32(1 / 255) for im in imgs]
    full_f32()
    ref = geometry.forward_images(_pipeline(cell, wts, False), imgs, cell.device)
    low = geometry.forward_images(_pipeline(cell, wts, True), imgs, cell.device)
    return {"hdr_rel_err": max(geometry.rel_err(a, b) for a, b in zip(low, ref))}


def serve_control(cell) -> dict:
    import cv2

    from hdrbench.drivers.serve import POOL_TAG, rgbe_mismatch

    t = cell.traffic
    wts = system.weights(cell)
    gen = generator(cell.seed, cell.device, POOL_TAG)
    worst = 0.0
    full_f32()
    for h, w in t["sizes"]:
        for im in scenes.ldr_images(gen, t["pool_per_size"], h, w, cell.device)[:t["check_per_size"]]:
            body = cv2.imencode(".jpg", np.ascontiguousarray(im[..., ::-1]),
                                [int(cv2.IMWRITE_JPEG_QUALITY), t["jpeg_quality"]])[1]
            rgb = cv2.imdecode(body, cv2.IMREAD_COLOR)[:, :, ::-1]
            x = [np.ascontiguousarray(rgb, np.float32) / np.float32(255)]
            (ref,) = geometry.forward_images(_pipeline(cell, wts, False), x, cell.device)
            (low,) = geometry.forward_images(_pipeline(cell, wts, True), x, cell.device)
            reply = cv2.imencode(".hdr", np.ascontiguousarray(low[:, :, ::-1], np.float32))[1].tobytes()
            worst = max(worst, rgbe_mismatch(reply, ref))
    return {"rgbe_mismatch": worst}


def _half_batch(batch: dict) -> dict:
    """The fault "half of the batch left out, the mean taken over the rest":
    the first half's samples twice."""
    out = {}
    for k, v in batch.items():
        half = v[: v.shape[0] // 2]
        out[k] = torch.cat([half, half])
    return out


def train_control(cell) -> dict:
    """The float8 control and the half-batch fault, each read against the
    float32 reference as the run's check reads the program.  (A state left
    unchanged reads 1 on the change and the gradient with no run.)"""
    from singlehdr_tpu_torch.data.synth import get_train_dataset
    from singlehdr_tpu_torch.train.loop import LoopConfig, SynthBatchPipeline

    from hdrbench.drivers.train import LOADER_TAG, RecordedDataset, step_gaps, write_scenes
    from hdrbench.weights import sub_seed

    t = cell.traffic
    work = tempfile.mkdtemp(prefix="hdrbench-control-")
    try:
        write_scenes(cell, work)
        dataset = RecordedDataset(get_train_dataset(work, patch_size=t["patch"]))
        cfg = LoopConfig(batch_size=t["batch"], n_workers=t["workers"], use_jpeg=t["jpeg"],
                         seed=sub_seed(cell.seed, LOADER_TAG) % 2**32)
        feed = SynthBatchPipeline(dataset, cfg, cell.device)
        try:
            raw = [feed.next_batch() for _ in range(t["checked_steps"])]
        finally:
            feed.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    full_f32()
    batches = []
    for b in raw:
        crf = torch.from_numpy(np.stack([dataset.crf[r.tobytes()] for r in b["invcrf"].cpu().numpy()]))
        batches.append(capture.feed_batch(b["hdr_t"], crf.to(cell.device), b["invcrf"]))
    wts, vgg_w = system.weights(cell), system.vgg_weights(cell)
    lr = cell.config["learning_rate"]

    def steps(compute, feed):
        params = {k: v.clone() for k, v in wts.items()}
        terms, first = R.train_steps(compute, params, vgg_w, feed, lr)
        return terms, first, params

    ref = steps(R.F32, batches)
    out = {}
    for name, run in (("fp8", (precision.Fp8(), batches)), ("half_batch", (R.F32, [_half_batch(b) for b in batches]))):
        terms, first, params = steps(*run)
        g = step_gaps(terms, first, params, ref[0], ref[1], ref[2], wts)
        out[name] = {k: v for k, v in g.items() if k.endswith("_gap")}
    return out


CONTROLS = {"batch": batch_control, "serve": serve_control, "train": train_control}


def control(workload: str, seed: int, device, traffic_overrides=None) -> dict:
    bench = load_json(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "BENCHMARK.json")
    entry, config, traffic = resolve(bench, workload)
    traffic.update(traffic_overrides or {})
    cell = Cell(name=workload, config=config, traffic=traffic, chips=entry["chips"], seed=seed,
                seconds=0.0, trace=False, t0=0.0, device=device)
    return CONTROLS[traffic["driver"]](cell)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    readings = {}
    for s in args.seeds.split(","):
        readings[s] = control(args.workload, int(s), dev)
        print(json.dumps({"workload": args.workload, "seed": int(s), "control": readings[s]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": torch.cuda.get_device_name(dev),
                       "readings": readings}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
