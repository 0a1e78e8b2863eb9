"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
import threading

import torch

_count_lock = threading.Lock()


def count_launch(wrapper, dtype: torch.dtype = torch.float32) -> None:
    """Add one to ``wrapper``'s count for ``dtype`` in ``wrapper.launches_by_dtype``
    (wrappers run on the training loop's feed threads and on autograd's
    device thread as well as the caller's)."""
    with _count_lock:
        by = wrapper.launches_by_dtype
        name = str(dtype).removeprefix("torch.")
        by[name] = by.get(name, 0) + 1


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def cuda_tensor(name: str, t: torch.Tensor, device: torch.device, ndim: int,
                dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank ``ndim`` on ``device``."""
    require(t.device == device, f"{name}: on {t.device}, expected {device}")
    require(t.dtype == dtype, f"{name}: dtype {t.dtype}, expected {dtype}")
    require(t.dim() == ndim, f"{name}: rank {t.dim()}, expected {ndim}")
    require(t.is_contiguous(), f"{name}: must be contiguous")


def cuda_f32(name: str, t: torch.Tensor, device: torch.device, ndim: int) -> None:
    """``cuda_tensor`` in f32: K1 and K1-bwd are the LUT math, f32 in every
    compute dtype, so a bf16 tensor reaching them is a missed cast."""
    cuda_tensor(name, t, device, ndim, torch.float32)


# the compute dtypes K2-K4 take: every operand in it but the f32 biases
CONV_DTYPES = (torch.float32, torch.bfloat16)


def conv_dtype(name: str, x: torch.Tensor) -> torch.dtype:
    """The compute dtype of a K2-K4 call, read from its input ``x``."""
    require(x.dtype in CONV_DTYPES, f"{name}: dtype {x.dtype}, expected one of {CONV_DTYPES}")
    return x.dtype


def no_grad_needed(name: str, *tensors: torch.Tensor) -> None:
    """K2-K4 are forward-only, as in JAX (the nets' train mode takes plain convs)."""
    require(
        not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)),
        f"{name}: the CUDA kernel is forward-only; run it under no_grad/inference_mode",
    )


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
