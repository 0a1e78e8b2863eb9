"""Data-parallel training over ``torch.distributed`` (counterpart of
``singlehdr_tpu.parallel.mesh``).

One process drives one device.  A data mesh of D is D processes, the ranks
of one process group: NCCL when the ranks' tensors are on CUDA devices,
gloo when they are on the CPU.  Each rank holds a full copy of the train
state (``replicate``) and 1/D of every global batch (``shard_batch``), and
a step on the mesh is the single-process step on the global batch, as on a
JAX mesh.  Where XLA inserts the collectives for JAX, the port writes each
one:

  * the gradients are all-reduced with a SUM (``all_reduce_gradients``): the
    scalar a step differentiates is the sum of the per-sample losses, so the
    gradient of the global batch is the sum of the ranks' gradients (DDP's
    mean would divide it by D);
  * train-mode BatchNorm statistics and hal's TV term are reductions over
    the whole batch, so they are taken over every rank (``global_sum``,
    ``global_var_mean``), and so is their gradient;
  * the logged scalars are the global batch's (``global_scalars``).

The spatial axis (image rows split over devices) needs a halo exchange
around every conv, pool and resize, which XLA SPMD gives JAX and torch does
not: ``make_mesh`` raises for it.
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

SPATIAL_UNSUPPORTED = (
    "a spatial mesh axis (S > 1) splits image rows over devices and needs a halo exchange "
    "around every conv, pool and resize, and lin's pooled features all-reduced; the JAX "
    "package gets these from XLA SPMD (singlehdr_tpu/tiled.py, shard_spatial), the port has "
    "none yet (ROADMAP.md, Queue 1): pass --mesh D for a data mesh")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A data mesh: this process's rank in a group of ``world`` processes,
    one device each."""

    group: Any
    rank: int
    world: int
    device: torch.device


def parse_mesh(spec: str) -> Optional[tuple]:
    """A ``--mesh`` flag, 'D' or 'D,S', as (D, S); None for ''."""
    if not spec:
        return None
    parts = [int(x) for x in spec.split(",")]
    if len(parts) > 2 or min(parts) < 1:
        raise ValueError(f"--mesh takes 'D' or 'D,S' with positive sizes, got {spec!r}")
    return parts[0], parts[1] if len(parts) > 1 else 1


def _free_local_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device(process_id: int, device) -> torch.device:
    """The device of rank ``process_id``: ``cuda:{process_id % device_count}``
    on CUDA, the CPU on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a CUDA rank: pass --device cpu to run on the CPU")
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None, process_id: Optional[int] = None,
                         device="cuda", mesh: bool = False) -> Optional[torch.device]:
    """Join this process to the run's process group and return its device.

    With ``num_processes`` > 1 the group is made at ``tcp://{coordinator_address}``
    (process 0's host:port) with this process as rank ``process_id``.  With
    one process and ``mesh`` set, it is a group of one on a free local port,
    so that a mesh of 1 runs the same collectives as a mesh of N.  Without
    either it does nothing and returns None, as the JAX function does for
    one host.  The backend follows ``device``: NCCL for CUDA, gloo for the
    CPU; a CUDA rank takes ``cuda:{process_id % device_count}``."""
    n = num_processes or 1
    if n <= 1 and not mesh:
        return None
    pid = process_id or 0
    if n > 1:
        if not coordinator_address:
            raise ValueError(f"{n} processes need --coordinator host:port (process 0's)")
        if not 0 <= pid < n:
            raise ValueError(f"--process_id {pid} is not in [0, {n})")
        init_method = f"tcp://{coordinator_address}"
    else:
        init_method = f"tcp://127.0.0.1:{_free_local_port()}"
    device = _rank_device(pid, device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init_method,
                            world_size=n, rank=pid)
    return device


def make_mesh(data: int, spatial: int = 1, device=None) -> DataMesh:
    """The data mesh over this run's process group: ``data`` must be its
    size (one process a device); ``device`` is this rank's device.  A
    spatial axis raises (``SPATIAL_UNSUPPORTED``)."""
    if spatial != 1:
        raise ValueError(SPATIAL_UNSUPPORTED)
    if device is None:
        raise ValueError("make_mesh needs this rank's device (initialize_multihost returns it)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_multihost first")
    world = dist.get_world_size()
    if data != world:
        raise ValueError(f"a data mesh of {data} needs {data} processes, one a device; the group "
                         f"has {world}")
    return DataMesh(dist.group.WORLD, dist.get_rank(), world, torch.device(device))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def local_rows(mesh: DataMesh, batch: Any) -> Any:
    """This rank's rows of every leaf of rank >= 1 (numpy arrays or tensors,
    left where they are): rows [r b / w, (r + 1) b / w) of b; scalars whole."""
    def rows(x):
        if np.ndim(x) == 0:
            return x
        b = x.shape[0]
        if b % mesh.world:
            raise ValueError(f"a batch of {b} does not split over a data mesh of {mesh.world}")
        n = b // mesh.world
        return x[mesh.rank * n:(mesh.rank + 1) * n]

    return _map(rows, batch)


def shard_batch(mesh: DataMesh, batch: Any) -> Any:
    """``local_rows`` of a global batch, as tensors on this rank's device."""
    def put(x):
        if not isinstance(x, torch.Tensor):
            a = np.asarray(x)
            x = torch.as_tensor(a if a.flags.c_contiguous else a.copy())
        return x.to(mesh.device)

    return _map(put, local_rows(mesh, batch))


def _broadcast_(mesh: DataMesh, tensors: Sequence[torch.Tensor]) -> None:
    for t in tensors:
        if t.device == mesh.device:
            dist.broadcast(t, 0, group=mesh.group)
        else:  # Adam keeps its step count on the CPU
            on = t.to(mesh.device)
            dist.broadcast(on, 0, group=mesh.group)
            t.copy_(on)


def replicate(mesh: DataMesh, state):
    """Rank 0's train state on every rank: parameters, buffers (the
    BatchNorm statistics), Adam's state and the step are broadcast from it,
    and the mesh is recorded on the state, whose steps then run on it."""
    with torch.no_grad():
        _broadcast_(mesh, [p.data for p in state.nets.parameters()])
        _broadcast_(mesh, list(state.nets.buffers()))
        for p in state.nets.parameters():
            moments = state.optimizer.state.get(p, {})
            _broadcast_(mesh, [moments[k] for k in sorted(moments) if torch.is_tensor(moments[k])])
    step = torch.tensor([state.step], dtype=torch.int64, device=mesh.device)
    dist.broadcast(step, 0, group=mesh.group)
    state.step = int(step.item())
    state.mesh = mesh
    return state


class _GlobalSum(torch.autograd.Function):
    """All-reduce SUM whose backward is an all-reduce SUM of the incoming
    gradient: y = sum_r x_r is on every rank, and every rank's loss depends
    on it, so dL/dx_r = sum_r' dL_r'/dy."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_sum(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, differentiable; ``x`` itself
    without a mesh."""
    return x if mesh is None else _GlobalSum.apply(x, mesh.group)


def global_var_mean(x: torch.Tensor, dims: tuple, mesh: DataMesh) -> tuple:
    """(biased variance, mean) of ``x`` over ``dims`` and over every rank's
    ``x`` (equal shapes on every rank, as ``shard_batch`` gives), in two
    passes: the mean from the global sum, then the variance from the global
    sum of squared deviations from it.  Differentiable."""
    n = math.prod(x.shape[d] for d in dims) * mesh.world
    mean = global_sum(x.sum(dims), mesh) / n
    shape = [1] * x.dim()
    shape[1] = -1
    var = global_sum(torch.square(x - mean.view(shape)).sum(dims), mesh) / n
    return var, mean


def global_scalars(mesh: Optional[DataMesh], sums: dict, means: dict) -> tuple:
    """Logged values of the global batch, in one all-reduce: each of
    ``sums`` summed over the ranks, each of ``means`` (a mean over the
    rank's equal share) averaged, in at least f32.  Detached; unchanged
    without a mesh."""
    if mesh is None:
        return sums, means
    keys = list(sums) + list(means)
    values = torch.stack([v.detach().reshape(()).to(torch.promote_types(v.dtype, torch.float32))
                          for v in (*sums.values(), *means.values())])
    dist.all_reduce(values, group=mesh.group)
    out = dict(zip(keys, values.unbind()))
    return ({k: out[k] for k in sums}, {k: out[k] / mesh.world for k in means})


def all_reduce_gradients(mesh: DataMesh, params) -> None:
    """Every parameter's ``.grad`` summed over the ranks, in one coalesced
    all-reduce SUM; afterwards each rank holds the gradient of the global
    batch's summed loss."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
