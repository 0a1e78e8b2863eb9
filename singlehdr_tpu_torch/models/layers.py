"""Layer primitives with Keras semantics (counterpart of
``singlehdr_tpu.models.layers``).

  * ``Conv2d``: TF 'SAME' padding (asymmetric where TF pads asymmetrically,
    e.g. 2 low / 3 high for a 7x7 stride-2 conv on an even extent), OIHW
    weights, glorot-uniform kernel and zero bias at init.
  * ``BatchNorm``: Keras constants (eps 1e-3, momentum 0.99, i.e. torch
    momentum 0.01), running statistics updated with the biased batch
    variance as Flax does.  It holds exactly weight, bias, running_mean and
    running_var, so its state maps one to one onto Flax's scale, bias, mean
    and var.
  * ``Dense``: glorot-uniform weight [out, in], zero bias.
  * ``UpsampleConv``: ``conv3x3(resize_bilinear_x2(x))``.

Compute dtype (the Flax modules' ``dtype``): parameters stay f32 and each
layer computes in its ``dtype``.  A conv or dense layer casts its input and
its weight and bias to it when it runs; a conv, as Flax's, rounds its
product to it before adding the bias in it (in f32 the fused bias computes
the same);
BatchNorm normalises in f32 with its f32 parameters and statistics (batch
statistics reduced in f32) and returns its input's dtype, as Flax's does, and
in train mode in a narrow dtype is composed as Flax's, so that its backward
rounds where JAX's does.  One f32 state_dict serves every dtype.

On a mesh (``bind_mesh``, which each train step of a replicated state
calls) train-mode BatchNorm takes its batch statistics over every rank's
batch, as Flax's do over a batch sharded on a JAX mesh.  On a spatial mesh
(S > 1: each rank holds a band of image rows) a conv takes its halo rows
from the neighbouring bands, the SAME padding of the global height (zeros
at the image's edges), and runs VALID in H (``conv2d_same``); the
bilinear resize of ``UpsampleConv`` takes one row each side.

Module attribute names follow the Flax module names, so state_dict keys are
the JAX parameter paths with dots (see ``convert.py``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from singlehdr_tpu_torch.ops.cuda.conv_gemm import cached_on
from singlehdr_tpu_torch.parallel.mesh import bands, extend_rows, global_var_mean
from singlehdr_tpu_torch.ops.resize import band_pads, resize_bilinear_x2, same_pads

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.01  # torch convention; Keras momentum 0.99
LEAKY_SLOPE = 0.1


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def cast_param(module: nn.Module, name: str, dtype: torch.dtype):
    """``module``'s parameter ``name`` in ``dtype``: under autograd a cast in
    the graph, otherwise the cast kept by ``cached_on``, so an eval forward
    casts each weight once."""
    p = getattr(module, name)
    if p is None or p.dtype == dtype:
        return p
    return cached_on(module, f"{name}:{dtype}", (p,), lambda: p.to(dtype))


def conv2d_same(x, weight, bias=None, stride: int = 1, mesh=None):
    """F.conv2d with TF 'SAME' padding; on a spatial ``mesh`` of the global
    height, ``x`` being this rank's band."""
    kh, kw = weight.shape[-2:]
    if bands(mesh) > 1:
        x = extend_rows(x, *band_pads(x, kh, stride, mesh), mesh)
        if stride == 1 and kw % 2:
            return F.conv2d(x, weight, bias, padding=(0, kw // 2))
        pl, pr = same_pads(x.shape[3], kw, stride)
        return F.conv2d(F.pad(x, (pl, pr, 0, 0)) if pl or pr else x, weight, bias, stride=stride)
    if stride == 1 and kh % 2 and kw % 2:
        return F.conv2d(x, weight, bias, padding=(kh // 2, kw // 2))
    pt, pb = same_pads(x.shape[2], kh, stride)
    pl, pr = same_pads(x.shape[3], kw, stride)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(x, weight, bias, stride=stride)


class Conv2d(nn.Module):
    mesh = None  # bound by ``bind_mesh``; read on a spatial mesh

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        if bias:
            self.bias = nn.Parameter(torch.empty(cout))
        else:
            self.register_parameter("bias", None)

    def compute_weight(self) -> torch.Tensor:
        """The kernel in the compute dtype (``cast_param``)."""
        return cast_param(self, "weight", self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, bias = x.to(self.dtype), self.compute_weight(), cast_param(self, "bias", self.dtype)
        if bias is None or self.dtype == torch.float32:
            return conv2d_same(x, w, bias, self.stride, self.mesh)
        # Flax rounds the conv's output to the compute dtype, then adds the bias in it
        return conv2d_same(x, w, None, self.stride, self.mesh) + bias[:, None, None]


class UpsampleConv(Conv2d):
    """``conv3x3(resize_bilinear_x2(x))`` — the decoder's resize + conv pair;
    the resize runs in the compute dtype, as in Flax."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(resize_bilinear_x2(x.to(self.dtype), self.mesh))


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), cast_param(self, "weight", self.dtype),
                        cast_param(self, "bias", self.dtype))


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or as it is where its dtype is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm(nn.Module):
    """Keras BatchNormalization over dim 1 of NCHW (or [b, c]) tensors, in the
    compute dtype: the input is cast to ``dtype``, normalised in f32 with the
    f32 parameters, and returned in ``dtype``.  In train mode the running
    statistics move once a forward, unless ``update_stats`` is off
    (``running_stats_frozen``).  With a ``mesh`` (``bind_mesh``) the batch
    statistics in train mode are the global batch's."""

    mesh = None

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.update_stats = True
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, BN_MOMENTUM, BN_EPSILON,
            )
        if self.mesh is not None or self.dtype != torch.float32:
            return self._train_as_flax(x)
        # Flax/Keras keep the BIASED batch variance in the running average;
        # torch's own update would store the unbiased one (n / (n - 1)).  The
        # statistics are reduced in f32 whatever the compute dtype, as Flax's.
        if self.update_stats:
            with torch.no_grad():
                dims = (0,) + tuple(range(2, x.dim()))
                var, mean = torch.var_mean(x.float(), dim=dims, unbiased=False)
                self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, BN_EPSILON)

    def _train_as_flax(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode composed as Flax's BatchNorm is: the batch statistics
        from one cast of ``x`` to at least f32, the normalisation in that
        precision from another, rounded once.  In a narrow dtype autograd
        then rounds the gradient of each cast to the compute dtype and sums
        the two in it, where JAX's backward does.  (Flax takes the variance
        as E[x^2] - E[x]^2; the two-pass variance here differs from it only
        in rounding.)  On a data mesh the statistics are the global batch's
        (``global_var_mean``: two passes of all-reduced sums,
        differentiable)."""
        dims = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        var, mean = (torch.var_mean(at_least_f32(x), dim=dims, unbiased=False) if self.mesh is None
                     else global_var_mean(at_least_f32(x), dims, self.mesh))
        if self.update_stats:
            with torch.no_grad():  # the biased variance, as Flax keeps it
                self._update_running(mean, var)
        mul = torch.rsqrt(var + BN_EPSILON) * self.weight
        y = (at_least_f32(x) - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
        self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Eval BN as an affine map: y = x * scale + shift, per channel."""
        scale = self.weight / torch.sqrt(self.running_var + BN_EPSILON)
        return scale, self.bias - self.running_mean * scale


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Within the block, ``module``'s BatchNorm layers normalise with their
    batch statistics in train mode but leave their running statistics as they
    are: a checkpointed forward recomputed in the backward must not apply the
    momentum a second time."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


def bind_mesh(module: nn.Module, mesh) -> None:
    """Every layer of ``module`` that has a ``mesh`` runs on ``mesh`` (a
    ``parallel.DataMesh``): BatchNorm takes its train-mode statistics over
    every rank, and on a spatial mesh the convs, pools, resizes and fused
    stages work on this rank's band; None unbinds."""
    for m in module.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh


@contextlib.contextmanager
def mesh_bound(module: nn.Module, mesh):
    """``module`` bound to ``mesh`` (``bind_mesh``) within the block, unbound
    after it."""
    bind_mesh(module, mesh)
    try:
        yield module
    finally:
        bind_mesh(module, None)


def _glorot_(w: torch.Tensor, generator: torch.Generator) -> None:
    receptive = w[0][0].numel() if w.dim() > 2 else 1
    fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.copy_(torch.rand(w.shape, generator=generator, dtype=w.dtype) * (2 * limit) - limit)


def keras_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Keras-default init in module order: glorot-uniform conv/dense kernels,
    zero biases, BN scale 1 / shift 0 / mean 0 / var 1.  ``generator`` is a
    CPU generator; initialise before moving the module to its device."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv2d, Dense)):
                _glorot_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return module
