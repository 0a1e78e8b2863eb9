"""The package's float32 policy: convolutions and matrix products in full f32.

PyTorch's default lets cuDNN run f32 convolutions in TF32 (10 mantissa bits),
which is neither the JAX package's f32 nor the 3xTF32 accuracy of the port's
own conv kernels.  Everything that builds a model or a train state on its
device calls ``use_full_f32`` first, so a library caller gets the same
arithmetic as the CLIs.  The bf16 compute dtype is unaffected: its f32
islands (losses, batch-norm statistics, the plain kernel versions) are f32
only with TF32 off.
"""

from __future__ import annotations

import torch


def use_full_f32() -> None:
    """Turn TF32 off for cuDNN convolutions and CUDA matrix products."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
