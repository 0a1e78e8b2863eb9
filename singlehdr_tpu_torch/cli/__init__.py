"""Command-line entry points of the port."""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from singlehdr_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, parse_mesh
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


def add_mesh_args(parser) -> None:
    """The JAX training CLIs' multi-device flags.  One port process drives
    one device: a mesh of D x S is D * S processes, each started with its
    ``--process_id`` (rank d * S + s is data index d, band s)."""
    parser.add_argument("--mesh", type=str, default="",
                        help="'D' or 'D,S': data(,spatial) mesh axes over devices")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of process 0 for multi-host runs")
    parser.add_argument("--num_processes", type=int, default=1)
    parser.add_argument("--process_id", type=int, default=0)


@contextlib.contextmanager
def process_mesh(args, device: torch.device):
    """Within the block, (this process's device, its mesh or None) from
    ``add_mesh_args``' flags: joins the run's process group
    (``initialize_multihost``; NCCL on CUDA, gloo on the CPU), makes the
    mesh, and leaves the group at the end.  More than one process without a
    mesh (each would train the whole batch and write the same checkpoints)
    raises before any process group is made; a mesh of another size than
    the processes raises in ``make_mesh``."""
    spec = parse_mesh(args.mesh)
    if spec is None and args.num_processes > 1:
        raise ValueError(f"--num_processes {args.num_processes} needs --mesh {args.num_processes}: "
                         "the processes train one data mesh, one device each")
    rank_device = initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                       device, mesh=spec is not None)
    try:
        device = rank_device or device
        yield device, None if spec is None else make_mesh(*spec, device=device)
    finally:
        if rank_device is not None:
            dist.destroy_process_group()
