"""The reference in the precision just below the one a configuration
states, for the controls that a check has to fail:

  float32 with TF32 off  ->  TF32 (``tf32``: cuDNN and cuBLAS with TF32 on)
  bfloat16               ->  float8 (``Fp8``): in the nets' compute-dtype
                             parts, the output of every operation rounded
                             to e4m3 (as the bf16 program rounds every
                             output to bf16), each convolution's input and
                             weights too, and the gradient flowing back
                             through each convolution to e5m2; one scale a
                             tensor (its largest magnitude to the format's
                             largest); products summed in float32; lin's
                             head and curve, the losses and the VGG stay
                             float32, as the configuration keeps them
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hdrbench.reference.nets import Compute, conv_same

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).clamp(-top, top).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


class _RoundOutputs(TorchDispatchMode):
    """Every floating output of an operation that is not a view, rounded to
    e4m3 (below autograd: the backward sees the rounded values)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._schema.is_mutable or getattr(func, "is_view", False):
            return out
        if isinstance(out, (tuple, list)):  # a result and its statistics: the result alone
            return type(out)([_rounded(out[0]), *out[1:]])
        return _rounded(out)


def _rounded(t):
    """``t`` rounded, unless it holds infinities (a max pool's padding)."""
    if isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.numel() > 1 \
            and bool(torch.isfinite(t).all()):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)
    return t


class Fp8(Compute):
    def scope(self):
        return _RoundOutputs()

    def conv(self, x, w, b=None, stride=1):
        y = fp8(conv_same(fp8(x), fp8(w), None, stride))
        return y if b is None else y + b[:, None, None]


@contextlib.contextmanager
def tf32():
    """Within the block, float32 convolutions and matrix products in TF32."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
