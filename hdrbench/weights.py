"""Seeded weights for the program and the reference alike.

``make_weights`` fills every tensor of a ``reference.nets.param_spec`` from
one generator on the device, in two draws (one uniform, one normal), each
leaf a view of them scaled to its kind:

  conv, dense   glorot-uniform, as Keras initialises them
  bias          uniform in +-0.02 (trained nets have biases; zeros would
                leave the bias paths unchecked)
  bn_*          scale 1 +- 0.1, shift +- 0.05, running mean +- 0.05,
                running variance 1 +- 0.2
  vgg_conv      He normal, std sqrt(2 / (9 cin)) (the surrogate of
                vgg16.npy); VGG biases zero
  vgg_mean      the ImageNet BGR means

The same seed gives the same tensors on one kind of device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hdrbench.reference.nets import VGG_MEAN_BGR


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed drawn from (seed, *tags); any whole seed is taken."""
    state = np.random.SeedSequence([int(seed) & (2**128 - 1), *tags]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def generator(seed: int, device, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


_UNIFORM = {"conv", "dense", "bias", "bn_weight", "bn_bias", "bn_mean", "bn_var"}


def make_weights(spec: dict, seed: int, device, tag: int = 0) -> dict:
    """{key: float32 tensor on ``device``} for every entry of ``spec``."""
    gen = generator(seed, device, 1, tag)
    n_uniform = sum(math.prod(s) for kind, s in spec.values() if kind in _UNIFORM)
    n_normal = sum(math.prod(s) for kind, s in spec.values() if kind == "vgg_conv")
    u = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0  # U(-1, 1)
    z = torch.randn(n_normal, generator=gen, device=device)
    out, iu, iz = {}, 0, 0
    with torch.no_grad():
        for key, (kind, shape) in spec.items():
            n = math.prod(shape)
            if kind in _UNIFORM:
                t = u[iu:iu + n].view(shape)
                iu += n
                if kind in ("conv", "dense"):
                    recept = math.prod(shape[2:])
                    t = t * math.sqrt(6.0 / ((shape[0] + shape[1]) * recept))
                elif kind == "bias":
                    t = t * 0.02
                elif kind in ("bn_bias", "bn_mean"):
                    t = t * 0.05
                elif kind == "bn_weight":
                    t = 1.0 + 0.1 * t
                else:  # bn_var
                    t = 1.0 + 0.2 * t
            elif kind == "vgg_conv":
                t = z[iz:iz + n].view(shape) * math.sqrt(2.0 / (shape[1] * 9))
                iz += n
            elif kind == "vgg_mean":
                t = torch.tensor(VGG_MEAN_BGR, dtype=torch.float32, device=device)
            elif kind == "zero":
                t = torch.zeros(shape, device=device)
            else:
                raise ValueError(f"unknown kind {kind!r} of {key}")
            out[key] = t.contiguous()
    return out
