"""Open-loop serving through the program's HTTP server (``serve.make_server``
around ``HdrPredictor``, the serve CLI's settings).

Traffic keys: ``sizes`` (request images, h x w, in equal shares),
``rate_rps`` (Poisson arrivals at this fixed rate), ``lead_s`` (arrivals
before the window, so that it opens on a running queue; set-up),
``jpeg_quality``, ``pool_per_size`` (distinct JPEGs a size), ``max_batch``
and ``batch_window_ms`` (the server's), ``check_per_size`` (replies held
against the reference, drawn from the seed among those due in the
window), ``trace_s`` (profiled from a third of the window on),
``grace_s`` (how long after the window a reply is waited for) and
``limits``.

Every seed sends the same requests: the same count of each size and the
same set of gaps between arrivals (the exponential distribution's
quantiles), in an order drawn from the seed.  A generator process sends
each request at its due time on a connection of its own; latency runs from
the due time to the reply's last byte, and a request that fails or never
answers counts above every percentile.

Checked: the sampled replies (Radiance RGBE) against the reference's
output for the same JPEG bytes, decoded by the reference and encoded as
the server encodes: the share of pixels whose RGBE codes differ, the worst
reply; a sampled request without a reply counts 1.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from hdrbench import scenes, system
from hdrbench.harness import ROOT, Outcome, free, full_f32, memory_peak, reset_peak, since
from hdrbench.reference import geometry
from hdrbench.reference import nets as R
from hdrbench.trace import Tracer
from hdrbench.weights import generator, sub_seed

POOL_TAG, ORDER_TAG = 30, 31


class CountingPredictor:
    """The predictor the server is handed: the program's, with each
    ``predict_batch`` call's span and real image count kept."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []  # (start, end, images) on time.monotonic

    def bucket_key(self, shape):
        return self.inner.bucket_key(shape)

    def predict_batch(self, images):
        t0 = time.monotonic()
        try:
            return self.inner.predict_batch(images)
        finally:
            self.calls.append((t0, time.monotonic(), len(images)))


def schedule(cell, n_pool: int):
    """[(due_s, size index, pool index)] over lead + window, and the indices
    of the requests due in the window."""
    t = cell.traffic
    span = t["lead_s"] + cell.seconds
    n = int(round(t["rate_rps"] * span))
    rng = np.random.default_rng(sub_seed(cell.seed, ORDER_TAG))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / t["rate_rps"]
    due = np.cumsum(rng.permutation(gaps))
    due *= span / due[-1] if n else 1.0
    sizes = rng.permutation(np.arange(n) % len(t["sizes"]))
    pool = rng.integers(0, n_pool, size=n)
    window = [i for i in range(n) if t["lead_s"] <= due[i] < span]
    return list(zip(due.tolist(), sizes.tolist(), pool.tolist())), window


def rgbe_mismatch(reply: bytes, ref_rgb: np.ndarray) -> float:
    """The share of pixels whose RGBE codes differ between the reply and the
    reference's output encoded as the server encodes it."""
    import cv2

    got = cv2.imdecode(np.frombuffer(reply, np.uint8), cv2.IMREAD_UNCHANGED)
    ok, buf = cv2.imencode(".hdr", np.ascontiguousarray(ref_rgb[:, :, ::-1], np.float32))
    want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    if got is None or got.shape != want.shape:
        return 1.0
    return float(np.any(got != want, axis=2).mean())


def p95(latencies) -> float:
    """Nearest-rank 95th percentile; None (a failure) ranks above all."""
    vals = sorted(math.inf if v is None else v for v in latencies)
    return vals[max(0, math.ceil(0.95 * len(vals)) - 1)]


def run(cell) -> Outcome:
    import cv2

    from singlehdr_tpu_torch.serve import make_server

    t, dev = cell.traffic, cell.device
    sizes = [tuple(s) for s in t["sizes"]]
    reset_peak(dev)
    wts = system.weights(cell)
    pred = system.predictor(cell, wts)
    pred.warmup(sizes, batch_sizes=(1, t["max_batch"]))
    gen = generator(cell.seed, dev, POOL_TAG)
    pools = []
    for h, w in sizes:
        imgs = scenes.ldr_images(gen, t["pool_per_size"], h, w, dev)
        pools.append([cv2.imencode(".jpg", np.ascontiguousarray(im[..., ::-1]),
                                   [int(cv2.IMWRITE_JPEG_QUALITY), t["jpeg_quality"]])[1].tobytes()
                      for im in imgs])
    plan, window = schedule(cell, t["pool_per_size"])
    rng = np.random.default_rng(sub_seed(cell.seed, ORDER_TAG, 1))
    keep = set()
    for s in range(len(sizes)):
        of_size = [i for i in window if plan[i][1] == s]
        keep.update(rng.choice(of_size, size=min(t["check_per_size"], len(of_size)), replace=False).tolist())

    counting = CountingPredictor(pred)
    server = make_server(counting, "127.0.0.1", 0, max_batch=t["max_batch"],
                         batch_window_s=t["batch_window_ms"] / 1e3)
    serving = threading.Thread(target=server.serve_forever, name="http", daemon=True)
    serving.start()
    work = tempfile.mkdtemp(prefix="hdrbench-serve-")
    tracer = Tracer(cell.trace, dev)
    client = None
    try:
        offsets, blob = {}, bytearray()
        for s, pool in enumerate(pools):
            for j, body in enumerate(pool):
                offsets[(s, j)] = (len(blob), len(body))
                blob += body
        with open(os.path.join(work, "bodies.bin"), "wb") as f:
            f.write(blob)
        deadline = t["lead_s"] + cell.seconds + t["grace_s"]
        with open(os.path.join(work, "payload.json"), "w") as f:
            json.dump({"port": server.server_address[1], "deadline": deadline,
                       "schedule": [(due, *offsets[(s, j)], i in keep) for i, (due, s, j) in enumerate(plan)]}, f)
        result_path = os.path.join(work, "result.json")
        client = subprocess.Popen(
            [sys.executable, "-m", "hdrbench.drivers.client", os.path.join(work, "payload.json"),
             os.path.join(work, "bodies.bin"), result_path],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        if client.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        go = time.monotonic() + 0.2
        client.stdin.write(f"go {go!r}\n")
        client.stdin.flush()
        w0, w1 = go + t["lead_s"], go + t["lead_s"] + cell.seconds
        setup_s = since(cell.t0) + (w0 - time.monotonic())
        if cell.trace:
            time.sleep(max(0.0, w0 + cell.seconds / 3 - time.monotonic()))
            tracer.start()
            time.sleep(t["trace_s"])
            tracer.stop_recording()
        client.wait(timeout=deadline + 60)
        with open(result_path) as f:
            results = json.load(f)
        kept = {i: open(f"{result_path}.{i}", "rb").read() for i, r in enumerate(results) if r.get("kept")}
    finally:
        if client is not None and client.poll() is None:
            client.kill()
            client.wait()
        server.shutdown()
        server.server_close()
        serving.join()
        shutil.rmtree(work, ignore_errors=True)
    peak = memory_peak(dev)
    from singlehdr_tpu_torch.ops.cuda import launch_counts_by_dtype

    launches = launch_counts_by_dtype()
    calls = [c for c in counting.calls if w0 <= c[0] < w1]
    busy = sum(max(0.0, min(e, w1) - max(s, w0)) for s, e, _ in counting.calls)
    counting.inner = None  # the server's batcher thread keeps the wrapper
    del pred
    free(dev)
    tracer.summarize()

    # the reference, on the kept replies
    full_f32()
    mismatch, refine = 0.0, cell.config["use_refinement"]
    for i in sorted(keep):
        if i not in kept:
            mismatch = 1.0
            continue
        due, s, j = plan[i]
        rgb = cv2.imdecode(np.frombuffer(pools[s][j], np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]
        (ref,) = geometry.forward_images(lambda x: R.pipeline(R.F32, x, wts, refine_output=refine),
                                         [np.ascontiguousarray(rgb, np.float32) / np.float32(255)], dev)
        mismatch = max(mismatch, rgbe_mismatch(kept[i], ref))

    lat = [results[i]["latency_s"] if results[i]["status"] == 200 else None for i in window]
    tail = p95(lat)
    if math.isinf(tail):  # past the wait: censored at the wait's end
        tail = max(deadline - plan[i][0] for i in window)
    failed = sum(v is None for v in lat)
    late = sorted(results[i]["late_s"] for i in window)
    done = [plan[i][0] + v for i, v in zip(window, lat) if v is not None]
    half = len(window) // 2
    ok_first = sorted(v for v in lat[:half] if v is not None)
    ok_second = sorted(v for v in lat[half:] if v is not None)
    counters = {"done_in_window": sum(t["lead_s"] <= d < t["lead_s"] + cell.seconds for d in done),
                "p50_first_half_s": ok_first[len(ok_first) // 2] if ok_first else None,
                "p50_second_half_s": ok_second[len(ok_second) // 2] if ok_second else None,
                "requests": len(window), "batches": len(calls),
                "batch_mean": sum(c[2] for c in calls) / len(calls) if calls else None,
                "predict_busy_pct": 100.0 * busy / cell.seconds}
    return Outcome(
        metrics={"serve_p95_ms": 1e3 * tail, "setup_s": setup_s},
        checks=[("rgbe_mismatch", mismatch, cell.limits["rgbe_mismatch"])],
        attempted=len(window), failed=failed, memory_peak_bytes=peak, counters=counters,
        trace=tracer.summary,
        notes=[f"{len(window)} requests due in the window at {t['rate_rps']} req/s, {failed} failed; "
               f"{len(calls)} batches, {counters['batch_mean']} images a batch",
               f"generator late by p50 {1e3 * late[len(late) // 2]:.3f} ms, max {1e3 * late[-1]:.3f} ms",
               f"replies ending in the window {counters['done_in_window']}; p50 of the first half "
               f"{counters['p50_first_half_s']} s, of the second {counters['p50_second_half_s']} s",
               f"launches by dtype: {launches}"])
