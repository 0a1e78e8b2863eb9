"""What every driver shares: the cell it runs, what it hands back, and the
few steps of a run that do not depend on the traffic.

A driver (``hdrbench/drivers/<name>.py``, named by the traffic file's
``driver``) exposes ``run(cell) -> Outcome``.  It builds the program from
the configuration, warms it on the cell's shapes, measures for
``cell.seconds``, reads the peak memory, frees the program, and then holds
what the timed path produced against the reference (``Outcome.checks``:
name, number, limit; a run is correct when every number is at most its
limit).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time
from typing import Any

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "hdrbench")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    t0: float                 # process start on the host clock (time.perf_counter)
    device: Any = None        # torch.device the program runs on
    limits: dict = dataclasses.field(default_factory=dict)  # check name -> limit


@dataclasses.dataclass
class Outcome:
    metrics: dict                       # end-to-end name -> value
    checks: list                        # [(name, value, limit)]
    attempted: int
    failed: int
    memory_peak_bytes: int
    counters: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    trace: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v == v and v <= lim for _, v, lim in self.checks)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def note(msg: str) -> None:
    print(f"[hdrbench] {msg}", file=sys.stderr, flush=True)


def since(t0: float) -> float:
    return time.perf_counter() - t0


def synchronize(device) -> None:
    import torch

    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device) -> None:
    """Return what the program held before the reference runs."""
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def dtype_of(name: str):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def full_f32() -> None:
    """float32 with TF32 off, for the program and the reference alike."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
