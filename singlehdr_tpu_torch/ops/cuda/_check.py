"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
import threading

import torch

_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (wrappers run on the training loop's
    feed threads and on autograd's device thread as well as the caller's)."""
    with _count_lock:
        wrapper.launches += 1


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def cuda_f32(name: str, t: torch.Tensor, device: torch.device, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous f32 tensor of rank ``ndim`` on ``device``."""
    require(t.device == device, f"{name}: on {t.device}, expected {device}")
    require(t.dtype == torch.float32, f"{name}: dtype {t.dtype}, expected float32")
    require(t.dim() == ndim, f"{name}: rank {t.dim()}, expected {ndim}")
    require(t.is_contiguous(), f"{name}: must be contiguous")


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
