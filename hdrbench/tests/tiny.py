"""Cells shrunk to what a CPU test run holds: the traffic overrides of
each, and a helper that runs one on the CPU (the chip check skipped)."""

from __future__ import annotations

import torch

TRAFFIC = {
    "batch-f32-512": {"batch": 2, "height": 64, "width": 64, "check_images": 3, "check_batches": 2,
                      "pool_img_s": 4, "trace_batches": 1},
    "joint-bf16-256": {"batch": 2, "patch": 64, "scenes": 4, "scene_hw": [64, 96], "workers": 2,
                       "warm_steps": 4, "checked_steps": 3, "trace_steps": 1},
    "serve-f32-mixed": {"sizes": [[64, 64], [64, 128]], "rate_rps": 16, "lead_s": 1, "max_batch": 4,
                        "pool_per_size": 3, "check_per_size": 8, "grace_s": 30, "trace_s": 1},
}
SECONDS = {"batch-f32-512": 1.0, "joint-bf16-256": 1.5, "serve-f32-mixed": 3.0}


def run_tiny(workload: str, seed: int = 2**31 + 7, trace: bool = False, config=None):
    """(exit code, result line, outcome) of ``workload`` shrunk, on the CPU."""
    from hdrbench.run import execute

    torch.set_num_threads(4)
    return execute(workload, seed, SECONDS[workload], trace, torch.device("cpu"),
                   dict(TRAFFIC[workload]), config)
