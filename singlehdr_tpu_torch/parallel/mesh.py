"""Data- and spatial-parallel training and inference over ``torch.distributed``
(counterpart of ``singlehdr_tpu.parallel.mesh``).

One process drives one device.  A mesh of D x S is D * S processes, the
ranks of one process group: NCCL when the ranks' tensors are on CUDA
devices, gloo when they are on the CPU.  Rank ``d * S + s`` is data index d
and band s (JAX's ``reshape(n // spatial, spatial)``).  Each rank holds a
full copy of the train state (``replicate``), 1/D of every global batch and,
of each image of it, band s of S equal bands of rows (``shard_batch``); a
step on the mesh is the single-process step on the global batch, as on a
JAX mesh.  Where XLA inserts the collectives for JAX, the port writes each
one:

  * the gradients are all-reduced with a SUM over every rank
    (``all_reduce_gradients``): the scalar a step differentiates is the sum
    of the per-sample losses, each rank differentiating its share of it, so
    the gradient of the global batch is the sum of the ranks' gradients
    (DDP's mean would divide it by D * S);
  * train-mode BatchNorm statistics and hal's TV term are reductions over
    the whole batch, so they are taken over every rank (``global_sum``,
    ``global_var_mean``), and so is their gradient;
  * the logged scalars are the global batch's (``global_scalars``).

With S > 1 a band needs rows of its neighbours around every stencil: an op
whose TF SAME padding on the global height is (low, high) takes ``low``
rows from the band above and ``high`` from the band below (``halo_rows``;
a band at the image's edge pads that side as the whole op does,
``extend_rows``) and runs VALID in H.  Per-sample reductions over pixels and
lin's pooled features are sums over the data index's S bands
(``spatial_sum``).  With S = 1 nothing of this runs: no spatial group is
made and nothing is exchanged.

Every exchange is an all-reduce SUM of a zero buffer into which each rank
writes its own rows (exact: each element is one rank's value plus zeros),
because gloo, which two ranks sharing one card must use, has no
point-to-point ops on CUDA tensors while NCCL and gloo both all-reduce
them; the rows exchanged are few.  Every rank issues the collectives of a
forward and of its backward in one order, as they depend on shapes alone.
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"



@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A (data, spatial) mesh: this process's rank in a group of ``world``
    processes, one device each, ``spatial`` bands of rows to a data index,
    and the group of this rank's data index (its S bands; None for S = 1)."""

    group: Any
    rank: int
    world: int
    device: torch.device
    spatial: int = 1
    spatial_group: Any = None

    @property
    def data(self) -> int:
        """D, the number of data indices."""
        return self.world // self.spatial

    @property
    def data_rank(self) -> int:
        """This rank's data index d."""
        return self.rank // self.spatial

    @property
    def band(self) -> int:
        """This rank's band s, counted from the image's top."""
        return self.rank % self.spatial

    def halo(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """``halo_rows`` of ``x`` on this mesh."""
        return halo_rows(x, top, bottom, self)


def bands(mesh: Optional[DataMesh]) -> int:
    """S of ``mesh``; 1 without one."""
    return 1 if mesh is None else mesh.spatial


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
    """The ``data`` x ``spatial`` mesh over this run's process group, whose
    size must be ``data * spatial`` (one process a device); ``device`` is
    this rank's device.  For S > 1 every rank makes each data index's group
    of S ranks, in one order (``dist.new_group``)."""
    if device is None:
        raise ValueError("make_mesh needs this rank's device (initialize_multihost returns it)")
    if min(data, spatial) < 1:
        raise ValueError(f"mesh axes must be positive, got data {data}, spatial {spatial}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_multihost first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * spatial != world:
        raise ValueError(f"a mesh of {data} x {spatial} needs {data * spatial} processes, one a "
                         f"device; the group has {world}")
    if spatial == 1:
        return DataMesh(dist.group.WORLD, rank, world, torch.device(device))
    groups = [dist.new_group(list(range(d * spatial, (d + 1) * spatial))) for d in range(data)]
    return DataMesh(dist.group.WORLD, rank, world, torch.device(device), spatial,
                    groups[rank // spatial])


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def band_rows(mesh: DataMesh, batch: Any, spatial_dim: int = 1) -> Any:
    """This rank's band of every rank-4 leaf whose dim ``spatial_dim`` (H:
    1 for host NHWC arrays, 2 for NCHW tensors) divides by S and is > 1:
    rows [s h / S, (s + 1) h / S); every other leaf whole, as JAX's
    ``shard_batch`` shards (the [b, 1, 1, 1] masks, the [b, k] curves)."""
    if bands(mesh) == 1:
        return batch

    def rows(x):
        h = x.shape[spatial_dim] if np.ndim(x) == 4 else 0
        if h <= 1 or h % mesh.spatial:
            return x
        n = h // mesh.spatial
        index = [slice(None)] * 4
        index[spatial_dim] = slice(mesh.band * n, (mesh.band + 1) * n)
        return x[tuple(index)]

    return _map(rows, batch)


def local_rows(mesh: DataMesh, batch: Any, spatial_dim: int = 1) -> Any:
    """This rank's share of a global batch (numpy arrays or tensors, left
    where they are): of every leaf of rank >= 1 the samples [d b / D,
    (d + 1) b / D) of b, of their images its band (``band_rows``); scalars
    whole."""
    def rows(x):
        if np.ndim(x) == 0:
            return x
        b = x.shape[0]
        if b % mesh.data:
            raise ValueError(f"a batch of {b} does not split over a data mesh of {mesh.data}")
        n = b // mesh.data
        return x[mesh.data_rank * n:(mesh.data_rank + 1) * n]

    return band_rows(mesh, _map(rows, batch), spatial_dim)


def shard_batch(mesh: DataMesh, batch: Any, spatial_dim: int = 1) -> Any:
    """``local_rows`` of a global batch, as tensors on this rank's device."""
    def put(x):
        if not isinstance(x, torch.Tensor):
            a = np.asarray(x)
            x = torch.as_tensor(a if a.flags.c_contiguous else a.copy())
        return x.to(mesh.device)

    return _map(put, local_rows(mesh, batch, spatial_dim))


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


def spatial_sum(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """The sum of ``x`` over this data index's S bands, differentiable (the
    backward sums the bands' incoming gradients, as ``global_sum``'s);
    ``x`` itself for S = 1."""
    return x if bands(mesh) == 1 else _GlobalSum.apply(x, mesh.spatial_group)


def _exchange(rows: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """[S, *rows.shape]: every band's ``rows``, by band, on every band of the
    data index (an all-reduce of a zero buffer holding this band's slot;
    16-bit floats travel as f32, exact both ways, so that gloo's sums need
    not take bf16)."""
    buf = torch.zeros((mesh.spatial, *rows.shape), dtype=torch.promote_types(rows.dtype, torch.float32),
                      device=rows.device)
    buf[mesh.band] = rows
    dist.all_reduce(buf, group=mesh.spatial_group)
    return buf.to(rows.dtype)


class _HaloRows(torch.autograd.Function):
    """Forward: [top rows of the band above; x; bottom rows of the band
    below] along H (dim 2), nothing from beyond the image's edges.
    Backward: the gradient of the received rows goes back to their owner,
    which adds it to its own boundary rows."""

    @staticmethod
    def forward(ctx, x, top, bottom, mesh):
        s, last, h = mesh.band, mesh.spatial - 1, x.shape[2]
        ctx.top, ctx.bottom, ctx.mesh = top, bottom, mesh
        # to the band below: the last `top` rows; to the band above: the first `bottom`
        got = _exchange(torch.cat([x[:, :, h - top:], x[:, :, :bottom]], 2), mesh)
        parts = ([got[s - 1][:, :, :top]] if s > 0 else []) + [x]
        parts += [got[s + 1][:, :, top:]] if s < last else []
        return torch.cat(parts, 2)

    @staticmethod
    def backward(ctx, g):
        top, bottom, mesh = ctx.top, ctx.bottom, ctx.mesh
        s, last = mesh.band, mesh.spatial - 1
        lo = top if s > 0 else 0
        h = g.shape[2] - lo - (bottom if s < last else 0)
        sent = torch.zeros_like(g[:, :, :top + bottom])
        if s > 0:
            sent[:, :, :top] = g[:, :, :top]
        if s < last:
            sent[:, :, top:] = g[:, :, lo + h:]
        got = _exchange(sent, mesh)
        gx = g[:, :, lo:lo + h].clone()
        if s < last:  # the band below took our last `top` rows
            gx[:, :, h - top:] += got[s + 1][:, :, :top]
        if s > 0:  # the band above took our first `bottom` rows
            gx[:, :, :bottom] += got[s - 1][:, :, top:]
        return gx, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, mesh: DataMesh) -> torch.Tensor:
    """``x`` ([b, c, h, w], this rank's band) with the last ``top`` rows of
    the band above and the first ``bottom`` rows of the band below around
    it; a band at the image's edge receives nothing on that side.
    Differentiable; ``x`` itself when both are 0.  A halo wider than a band
    raises."""
    if top > x.shape[2] or bottom > x.shape[2]:
        raise ValueError(f"a halo of ({top}, {bottom}) rows is wider than a band of {x.shape[2]}")
    if top == 0 and bottom == 0:
        return x
    return _HaloRows.apply(x, top, bottom, mesh)


def extend_rows(x: torch.Tensor, top: int, bottom: int, mesh, mode: str = "constant",
                value: float = 0.0) -> torch.Tensor:
    """``x`` with exactly ``top`` rows above and ``bottom`` below: the
    neighbouring bands' (``mesh.halo``), and at the image's edge the whole
    op's padding there (``F.pad``'s ``mode``: zeros or ``value`` for
    'constant', 'reflect', 'replicate')."""
    y = mesh.halo(x, top, bottom)
    at_top = top if mesh.band == 0 else 0
    at_bottom = bottom if mesh.band == mesh.spatial - 1 else 0
    if not (at_top or at_bottom):
        return y
    if mode == "constant":
        return F.pad(y, (0, 0, at_top, at_bottom), value=value)
    return F.pad(y, (0, 0, at_top, at_bottom), mode=mode)


def on_extended_band(fn, x: torch.Tensor, halo: int, mesh) -> Any:
    """``fn`` (a fused stage: a tensor or a tuple of tensors at strides 1 or
    2 of its input's rows) on this band extended by ``halo`` rows on each
    inner side, its outputs cropped back to the band.  ``halo`` covers the
    stage's reach and is even, so a stride-2 output grid of the extended
    band is the global one; ``fn``'s own padding at the extended band's
    inner rims falls inside the crop, at the image's edges it is the whole
    stage's."""
    if halo % 2:
        raise ValueError(f"an extended band's halo must be even, got {halo}")
    h = x.shape[2]
    top = halo if mesh.band > 0 else 0
    out = fn(mesh.halo(x, halo, halo))
    h_ext = h + top + (halo if mesh.band < mesh.spatial - 1 else 0)

    def crop(y):
        r = h_ext // y.shape[2]
        return y[:, :, top // r:(top + h) // r]

    return tuple(crop(y) for y in out) if isinstance(out, tuple) else crop(out)


def check_same_on_bands(mesh: DataMesh, tensors: Sequence[torch.Tensor]) -> None:
    """Raises unless every band of this data index holds the same
    ``tensors`` (by their sums and sums of squares in float64, compared with
    a MAX and a MIN all-reduce): the bands of one data index must cut their
    rows from one batch."""
    sums = torch.stack([v for t in tensors for v in (t.double().sum(), t.double().square().sum())])
    hi, lo = sums.clone(), sums.clone()
    dist.all_reduce(hi, dist.ReduceOp.MAX, group=mesh.spatial_group)
    dist.all_reduce(lo, dist.ReduceOp.MIN, group=mesh.spatial_group)
    if not torch.equal(hi, lo):
        raise RuntimeError(f"the bands of a data index were fed different batches: checksums "
                           f"{hi.tolist()} (max over the bands) vs {lo.tolist()} (min)")


def gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The whole image of this data index from its bands ([b, c, h, w] on
    each rank -> [b, c, S h, w] on every rank of the group)."""
    if bands(mesh) == 1:
        return x
    got = _exchange(x, mesh)
    return torch.cat(list(got.unbind(0)), 2)


def global_var_mean(x: torch.Tensor, dims: tuple, mesh: DataMesh) -> tuple:
    """(biased variance, mean) of ``x`` over ``dims`` and over every rank's
    ``x`` (equal shapes on every rank, as ``shard_batch`` gives: a band of
    each image is 1/S of its rows, so the local count times D * S is the
    global batch's), in two
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
