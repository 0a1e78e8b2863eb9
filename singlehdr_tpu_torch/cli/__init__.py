"""Command-line entry points of the port."""

from __future__ import annotations

import torch

from singlehdr_tpu_torch.precision import use_full_f32


def cli_device(name: str) -> torch.device:
    """The device a CLI runs on: CUDA unless ``cpu`` is asked for explicitly;
    f32 convolutions and matmuls with TF32 off."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
        use_full_f32()
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return device


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def add_dtype_arg(parser) -> None:
    """``--dtype {float32,bfloat16}``: the nets' compute dtype (parameters,
    losses and the perceptual VGG stay f32), as the JAX CLIs take it."""
    parser.add_argument("--dtype", choices=tuple(DTYPES), default="float32",
                        help="compute dtype of the nets (default float32)")
