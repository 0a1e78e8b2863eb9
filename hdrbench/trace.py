"""The device trace of a traced run, reduced to what the metrics read.

``Tracer`` records ``torch.profiler`` (CPU and CUDA activities) over a
steady sub-window of the measured window, exports the chrome trace to a
temporary file, reads it back and deletes it.  ``summarize``:

  busy_s     the union of kernel, memcpy and memset intervals (a copy of
             the port's ``tools/serve_trace.busy_us``)
  window_s   first to last event of the recorded window
  kernel_s   device seconds by kernel name
  breakdown  the ten device operations that took most time, and the idle
             gaps between device work summed by the innermost host event
             (annotation, operator or runtime call) running at each gap's
             middle
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver", "python_function")


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (us)."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _gap_labels(gaps, host):
    """{label: us} of the gaps, each under the innermost host event covering
    its middle (the latest-started of those covering it)."""
    host = sorted(host, key=lambda e: e[0])
    starts = [h[0] for h in host]
    out = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        label = "no host event"
        for j in range(i - 1, max(-1, i - 4000), -1):
            hs, he, name = host[j]
            if he >= mid:
                label = name
                break
        out[label] = out.get(label, 0.0) + (e - s)
    return out


def summarize(trace: dict) -> dict:
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        return {}
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    by_name = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    merged = _merged(intervals)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    if merged:
        gaps = [(t0, merged[0][0])] + gaps + [(merged[-1][1], t1)]
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events if e.get("cat") in HOST_CATS]
    labels = _gap_labels([g for g in gaps if g[1] > g[0]], host)
    top = lambda d: [[k[:160], v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {
        "busy_s": busy_us(intervals) / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "kernel_s": {k: v / 1e6 for k, v in by_name.items()},
        "device_events": len(device),
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(labels)},
    }


class Tracer:
    """``start()`` and ``stop_recording()`` a profiler over part of a
    window, ``summarize()`` once the window has closed (the export and its
    reading cost seconds); ``summary`` then holds ``summarize``'s dict.
    Does nothing unless enabled."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.summary: dict = {}
        self._prof = None
        self.active = False

    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        if not self.enabled or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self.active = True

    def stop_recording(self) -> None:
        if not self.active:
            return
        self._sync()
        self._prof.__exit__(None, None, None)
        self.active = False

    def summarize(self) -> None:
        self.stop_recording()
        if self._prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.summary = summarize(json.load(f))
        finally:
            os.unlink(path)
            self._prof = None
