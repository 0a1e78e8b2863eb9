"""The system under test, built from a configuration and seeded weights:
the program's own classes, on the card, with the benchmark's weights
loaded as a checkpoint would load them.  Nothing here computes a result."""

from __future__ import annotations

import torch

from hdrbench.harness import dtype_of
from hdrbench.reference import nets as R
from hdrbench.weights import make_weights

WEIGHTS_TAG = 0   # the nets' weights
VGG_TAG = 1       # the perceptual VGG's


def weights(cell) -> dict:
    return make_weights(R.param_spec(cell.config["nets"]), cell.seed, cell.device, WEIGHTS_TAG)


def vgg_weights(cell) -> dict:
    return make_weights(R.param_spec(["vgg"]), cell.seed, cell.device, VGG_TAG)


def pipeline(cell, w: dict):
    """The serving pipeline in eval mode, computing in the configuration's
    dtype, f32 with TF32 off (``precision.use_full_f32``)."""
    from singlehdr_tpu_torch.models.pipeline import ReverseCameraPipeline
    from singlehdr_tpu_torch.precision import use_full_f32

    use_full_f32()
    with torch.device(cell.device):
        pipe = ReverseCameraPipeline(dtype_of(cell.config["compute_dtype"]),
                                     use_refinement=cell.config["use_refinement"])
    pipe = pipe.to(cell.device)
    pipe.load_state_dict(w, strict=True)
    return pipe.eval()


def predictor(cell, w: dict):
    from singlehdr_tpu_torch.inference import HdrPredictor

    return HdrPredictor(pipeline(cell, w), bucket_multiple=cell.config["bucket_multiple"],
                        use_refinement=cell.config["use_refinement"])


def train_state(cell, w: dict):
    """The joint train state (the nets in train mode, f32 parameters, one
    Adam at the configuration's rate) holding ``w``."""
    import torch.nn as nn

    from singlehdr_tpu_torch.precision import use_full_f32
    from singlehdr_tpu_torch.train.state import NETS, TrainState, make_optimizer

    use_full_f32()
    dtype = dtype_of(cell.config["compute_dtype"])
    with torch.device(cell.device):
        nets = nn.ModuleDict({n: NETS[n](dtype) for n in sorted(cell.config["nets"])})
    nets = nets.to(cell.device)
    nets.load_state_dict(w, strict=True)
    nets.train()
    return TrainState(nets, make_optimizer(nets.parameters(), cell.config["learning_rate"]))


def vgg(cell, w: dict):
    """The frozen perceptual VGG16 (f32, as the joint CLI keeps it)."""
    import numpy as np

    from singlehdr_tpu_torch.models.vgg16 import Vgg16Features

    shapes = {k[:-len(".weight")]: s for k, (_, s) in R.param_spec(["vgg"]).items() if k.endswith(".weight")}
    blank = {n: (np.zeros((3, 3, s[1], s[0]), np.float32), np.zeros(s[0], np.float32))
             for n, s in shapes.items()}
    net = Vgg16Features(params=blank).to(cell.device)
    net.load_state_dict(w, strict=True)
    return net
