"""Frozen VGG16 feature extractor of the perceptual loss (counterpart of
``singlehdr_tpu.models.vgg16``).

conv1_1..conv3_3 with ReLU and 2x2/2 SAME max pools, returning (pool1,
pool2, pool3) of a VGG-preprocessed input.  The weights come from the
reference's ``vgg16.npy`` dict when the file exists, else from the JAX
package's seeded He surrogate, drawn in the same order from the same
``np.random.RandomState(42)`` so that both packages hold identical weights.
``dtype`` is the compute dtype of its convs (the CLIs keep it f32, as the JAX
package's do); the pools come out in it.  On a spatial mesh
(``layers.bind_mesh``) its convs exchange their halo rows; its 2x2 pools
need none.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from singlehdr_tpu_torch.models.layers import Conv2d
from singlehdr_tpu_torch.ops.color import VGG_MEAN_BGR, vgg_preprocess
from singlehdr_tpu_torch.ops.resize import max_pool

# (name, in_ch, out_ch) of the three stages the perceptual loss uses.
_LAYERS = (
    ("conv1_1", 3, 64),
    ("conv1_2", 64, 64),
    ("conv2_1", 64, 128),
    ("conv2_2", 128, 128),
    ("conv3_1", 128, 256),
    ("conv3_2", 256, 256),
    ("conv3_3", 256, 256),
)
_POOL_AFTER = ("conv1_2", "conv2_2", "conv3_3")

Params = Dict[str, Tuple[np.ndarray, np.ndarray]]


def load_vgg16_params(npy_path: str | None = None) -> Params:
    """{name: (kernel HWIO, bias)} from a vgg16.npy dict, or the He surrogate."""
    if npy_path and os.path.exists(npy_path):
        raw = np.load(npy_path, encoding="latin1", allow_pickle=True).item()
        return {
            name: (np.asarray(raw[name][0], np.float32), np.asarray(raw[name][1], np.float32))
            for name, _, _ in _LAYERS
        }
    rng = np.random.RandomState(42)
    params: Params = {}
    for name, cin, cout in _LAYERS:
        std = np.sqrt(2.0 / (3 * 3 * cin))
        params[name] = (
            (rng.randn(3, 3, cin, cout) * std).astype(np.float32),
            np.zeros((cout,), np.float32),
        )
    return params


class Vgg16Features(nn.Module):
    """rgb01 [b, 3, h, w] -> (pool1, pool2, pool3); frozen and always in eval."""

    mesh = None

    def __init__(self, params: Params | None = None, npy_path: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        params = params if params is not None else load_vgg16_params(npy_path)
        for name, cin, cout in _LAYERS:
            conv = Conv2d(cin, cout, 3, dtype=dtype)
            kernel, bias = params[name]
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(np.transpose(kernel, (3, 2, 0, 1))))
                conv.bias.copy_(torch.from_numpy(bias))
            self.add_module(name, conv)
        self.register_buffer("mean", torch.tensor(VGG_MEAN_BGR), persistent=False)
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True) -> "Vgg16Features":
        return super().train(False)

    def forward(self, rgb01: torch.Tensor):
        x = vgg_preprocess(rgb01, self.mean).to(self.dtype)
        pools = []
        for name, _, _ in _LAYERS:
            x = torch.relu(getattr(self, name)(x))
            if name in _POOL_AFTER:
                x = max_pool(x, 2, 2, self.mesh)
                pools.append(x)
        return tuple(pools)
