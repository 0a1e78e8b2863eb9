"""Train state and optimizer (counterpart of ``singlehdr_tpu.train.state``).

One ``TrainState`` covers every configuration: one net (pretraining), the
deq + lin + hal trio under one optimizer (joint training) or all four nets
(finetune).  The nets sit in an ``nn.ModuleDict`` keyed 'deq'/'lin'/'hal'/
'ref', the names of the pipeline's submodules, so its ``state_dict`` keys are
the JAX multi-net parameter paths (``convert.py``).  Buffers (BatchNorm
statistics, hal's ``preproc_mean``) stay out of the optimizer.  The nets
compute in the state's ``dtype`` (f32 or bf16) with f32 parameters, so Adam
and its moments stay f32 in both.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import torch
import torch.nn as nn

from singlehdr_tpu_torch.models import (
    DequantizationNet,
    HallucinationNet,
    LinearizationNet,
    RefinementNet,
)
from singlehdr_tpu_torch.models.layers import keras_init_
from singlehdr_tpu_torch.precision import use_full_f32

# Keras Adam epsilon (the reference optimizer, tf_utils.py:172); torch's default is 1e-8.
ADAM_EPS = 1e-7

NETS = {
    "deq": DequantizationNet,
    "lin": LinearizationNet,
    "hal": HallucinationNet,
    "ref": RefinementNet,
}


def make_optimizer(params: Iterable[nn.Parameter], learning_rate: float) -> torch.optim.Adam:
    """Adam with Keras defaults (b1 .9, b2 .999, eps 1e-7), optax's update rule."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=ADAM_EPS)


@dataclasses.dataclass
class TrainState:
    """Nets + optimizer + step count of one training unit."""

    nets: nn.ModuleDict
    optimizer: torch.optim.Adam
    step: int = 0
    mesh: Any = None  # a parallel.DataMesh once replicated onto one (parallel.replicate)

    @property
    def device(self) -> torch.device:
        return next(self.nets.parameters()).device

    @property
    def learning_rate(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    @property
    def dtype(self) -> torch.dtype:
        """The nets' compute dtype."""
        (dtype,) = {net.dtype for net in self.nets.values()}
        return dtype


def init_multi_state(names: Iterable[str], learning_rate: float, seed: int = 0,
                     device="cuda", dtype: torch.dtype = torch.float32) -> TrainState:
    """Keras-initialised nets (in sorted name order, from one seeded CPU
    generator) computing in ``dtype``, in train mode on ``device``, under one
    Adam; f32 with TF32 off (``precision.use_full_f32``)."""
    nets = init_nets(names, seed, device, dtype).train()
    return TrainState(nets, make_optimizer(nets.parameters(), learning_rate))


def init_nets(names: Iterable[str], seed: int = 0, device="cuda",
              dtype: torch.dtype = torch.float32) -> nn.ModuleDict:
    """The nets of ``init_multi_state`` without an optimizer: Keras-initialised
    in sorted name order from one seeded CPU generator, on ``device``; f32
    with TF32 off (``precision.use_full_f32``)."""
    use_full_f32()
    generator = torch.Generator().manual_seed(seed)
    nets = nn.ModuleDict({n: keras_init_(NETS[n](dtype), generator) for n in sorted(names)})
    return nets.to(device)


def init_net_state(name: str, learning_rate: float, seed: int = 0, device="cuda",
                   dtype: torch.dtype = torch.float32) -> TrainState:
    """The state of one net, keyed by its name."""
    return init_multi_state([name], learning_rate, seed, device, dtype)
