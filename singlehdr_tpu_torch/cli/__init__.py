"""Command-line entry points of the port."""

from __future__ import annotations

import torch


def cli_device(name: str) -> torch.device:
    """The device a CLI runs on: CUDA unless ``cpu`` is asked for explicitly;
    f32 convolutions and matmuls with TF32 off."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return device
