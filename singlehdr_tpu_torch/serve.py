"""HTTP inference server: LDR images in, Radiance HDR out (counterpart of
``singlehdr_tpu.serve``).

A dependency-free serving path (stdlib http.server) for the full 4-net
pipeline.  Requests are decoded on handler threads; device work goes through
a micro-batcher: concurrent requests whose images round to the same padded
bucket are stacked into one device batch, with a short gather window so a
lone request is never held long.  The predictor is duck-typed: anything with
``bucket_key(shape)`` and ``predict_batch(images)``.

  POST /predict      body: JPEG/PNG bytes -> 200, body: Radiance .hdr bytes
  GET  /healthz      -> 200 "ok"
  GET  /stats        -> JSON request counters/latencies/batching

Run:  python -m singlehdr_tpu_torch.cli.serve --port 8080
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from singlehdr_tpu_torch.data import hdr_io

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


class _Stats:
    # sliding window per bucket for percentile estimates
    WINDOW = 4096

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.total_latency = 0.0
        self.device_batches = 0
        self.max_batch = 0
        self.latencies: "dict[str, deque]" = {}

    def record(self, latency: float, error: bool, bucket=None) -> None:
        with self.lock:
            self.requests += 1
            self.errors += int(error)
            self.total_latency += latency
            if not error:
                key = "x".join(map(str, bucket)) if bucket else "unbucketed"
                self.latencies.setdefault(key, deque(maxlen=self.WINDOW)).append(latency)

    def record_batch(self, size: int) -> None:
        with self.lock:
            self.device_batches += 1
            self.max_batch = max(self.max_batch, size)

    @staticmethod
    def _percentiles(samples) -> dict:
        arr = np.sort(np.asarray(samples, np.float64))
        pick = lambda q: float(arr[min(len(arr) - 1, int(q * len(arr)))])
        return {
            "n": len(arr),
            "p50_s": round(pick(0.50), 4),
            "p90_s": round(pick(0.90), 4),
            "p99_s": round(pick(0.99), 4),
            "max_s": round(float(arr[-1]), 4),
        }

    def snapshot(self) -> dict:
        with self.lock:
            mean = self.total_latency / self.requests if self.requests else 0.0
            per_bucket = {k: self._percentiles(v) for k, v in self.latencies.items() if v}
            all_lat = [x for v in self.latencies.values() for x in v]
            return {
                "requests": self.requests,
                "errors": self.errors,
                "mean_latency_s": round(mean, 4),
                "latency": self._percentiles(all_lat) if all_lat else {},
                "latency_per_bucket": per_bucket,
                "device_batches": self.device_batches,
                "max_batch": self.max_batch,
            }


class MicroBatcher:
    """Groups concurrent same-bucket requests into one device batch.

    Requests land in per-bucket FIFO queues stamped with a global arrival
    sequence number.  One worker thread serves the bucket whose head request
    is oldest, waits up to ``window_s`` for more same-bucket requests (up to
    ``max_batch``), runs them as one batched forward and resolves each
    request's Future.
    """

    def __init__(self, predictor, stats: _Stats, max_batch: int = 32, window_s: float = 0.01):
        self._predictor = predictor
        self._stats = stats
        self._max_batch = max_batch
        self._window = window_s
        self._cv = threading.Condition()
        self._pending: "dict[tuple, deque]" = {}
        self._seq = 0
        self._thread = threading.Thread(target=self._loop, daemon=True, name="batcher")
        self._thread.start()

    def bucket_key(self, shape) -> tuple:
        return self._predictor.bucket_key(shape)

    def predict(self, rgb01: np.ndarray) -> np.ndarray:
        fut: "Future[np.ndarray]" = Future()
        key = self._predictor.bucket_key(rgb01.shape)
        with self._cv:
            self._pending.setdefault(key, deque()).append((self._seq, rgb01, fut))
            self._seq += 1
            self._cv.notify()
        return fut.result()

    def _oldest_bucket(self):
        best_key, best_seq = None, None
        for k, d in self._pending.items():
            if d and (best_seq is None or d[0][0] < best_seq):
                best_key, best_seq = k, d[0][0]
        return best_key

    def _loop(self) -> None:
        while True:
            with self._cv:
                key = self._oldest_bucket()
                while key is None:
                    self._cv.wait()
                    key = self._oldest_bucket()
                group = []
                d = self._pending[key]
                while d and len(group) < self._max_batch:
                    group.append(d.popleft())
            deadline = time.perf_counter() + self._window
            while len(group) < self._max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                with self._cv:
                    d = self._pending.get(key)
                    if not d:
                        self._cv.wait(timeout)
                        d = self._pending.get(key)
                    while d and len(group) < self._max_batch:
                        group.append(d.popleft())
            self._stats.record_batch(len(group))
            try:
                outs = self._predictor.predict_batch([im for _, im, _ in group])
                for (_, _, f), out in zip(group, outs):
                    f.set_result(out)
            except Exception as e:  # noqa: BLE001 — fail the whole group, keep serving
                for _, _, f in group:
                    if not f.done():
                        f.set_exception(e)


def _decode_ldr(body: bytes) -> np.ndarray:
    if not _HAS_CV2:  # pragma: no cover
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("could not decode image body")
    return np.ascontiguousarray(img[:, :, ::-1])


def _encode_hdr(hdr_rgb: np.ndarray) -> bytes:
    if _HAS_CV2:
        ok, buf = cv2.imencode(".hdr", np.ascontiguousarray(hdr_rgb[:, :, ::-1]))
        if ok:
            return buf.tobytes()
    data = hdr_io.rgbe_encode(hdr_rgb)  # pure-numpy flat RGBE fallback
    h, w, _ = hdr_rgb.shape
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    return header + data.tobytes()


def make_server(predictor, host: str = "127.0.0.1", port: int = 8080,
                max_batch: int = 32, batch_window_s: float = 0.01):
    """Build (not start) the HTTP server around a predictor."""
    stats = _Stats()
    batcher = MicroBatcher(predictor, stats, max_batch=max_batch, window_s=batch_window_s)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str = "application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, b"ok", "text/plain")
            elif self.path == "/stats":
                self._reply(200, json.dumps(stats.snapshot()).encode(), "application/json")
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, b"not found", "text/plain")
                return
            t0 = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length <= 0 or length > 256 << 20:
                    raise ValueError("missing or oversized body")
                rgb = _decode_ldr(self.rfile.read(length)).astype(np.float32) / 255.0
                bucket = batcher.bucket_key(rgb.shape)
                body = _encode_hdr(batcher.predict(rgb))
                stats.record(time.perf_counter() - t0, error=False, bucket=bucket)
                self._reply(200, body, "image/vnd.radiance")
            except Exception as e:  # noqa: BLE001 — map any failure to 400
                stats.record(time.perf_counter() - t0, error=True)
                self._reply(400, f"error: {e}".encode(), "text/plain")

    server = ThreadingHTTPServer((host, port), Handler)
    server.stats = stats
    return server
