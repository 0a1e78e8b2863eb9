"""Loss primitives with the reference's reduction semantics (counterpart of
``singlehdr_tpu.ops.losses``), on NCHW tensors.

Every helper returns the unreduced per-sample tensor [b, 1, 1, 1]; the
objective the train steps differentiate is its SUM, as TF's
``tape.gradient`` reduces a non-scalar target (``scalar_from_per_sample``).
The one batch-wide reduction, ``tv_loss``, takes a data ``mesh``: its sums
are then the global batch's, as on a JAX mesh.
"""

from __future__ import annotations

import torch

from singlehdr_tpu_torch.ops.tonemap import mu_tonemap
from singlehdr_tpu_torch.parallel.mesh import global_sum

_PER_SAMPLE = (1, 2, 3)


def masked_l2(pred, target, mask=None) -> torch.Tensor:
    """Per-sample mean squared error [b, 1, 1, 1], optionally masked."""
    loss = torch.mean(torch.square(pred - target), dim=_PER_SAMPLE, keepdim=True)
    return loss if mask is None else loss * mask


def masked_l1(pred, target, mask=None) -> torch.Tensor:
    """Per-sample mean absolute error [b, 1, 1, 1], optionally masked."""
    loss = torch.mean(torch.abs(pred - target), dim=_PER_SAMPLE, keepdim=True)
    return loss if mask is None else loss * mask


def tv_loss(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Anisotropic total variation of [b, c, h, w], a scalar: the sums of
    |vertical| and |horizontal| differences, each over b*c*h*w (the
    reference's symmetric-pad form, whose last difference is zero).  On a
    data ``mesh`` the sums and b are the global batch's (every rank's ``x``
    of one shape, as ``shard_batch`` gives), and so is the gradient."""
    n = x.numel() * (mesh.world if mesh is not None else 1)
    sums = global_sum(torch.stack([torch.sum(torch.abs(x[:, :, 1:] - x[:, :, :-1])),
                                   torch.sum(torch.abs(x[:, :, :, 1:] - x[:, :, :, :-1]))]), mesh)
    return sums[0] / n + sums[1] / n


def perceptual_l1(feats_a, feats_b) -> torch.Tensor:
    """Sum over feature pairs of the per-sample mean |a - b| -> [b, 1, 1, 1]."""
    total = 0.0
    for fa, fb in zip(feats_a, feats_b):
        total = total + torch.mean(torch.abs(fa - fb), dim=_PER_SAMPLE, keepdim=True)
    return total


def hallucination_loss(y, target, vgg, mask, perceptual_weight: float = 0.001,
                       tv_weight: float = 0.1, mesh=None) -> torch.Tensor:
    """L1 + perceptual + TV in the mu-tonemapped domain -> [b, 1, 1, 1]; the
    TV term is a scalar added to every sample's loss before masking, the
    global batch's on a data ``mesh``."""
    y_g = mu_tonemap(y)
    t_g = mu_tonemap(target)
    l1 = torch.mean(torch.abs(y_g - t_g), dim=_PER_SAMPLE, keepdim=True)
    perc = perceptual_l1(vgg(y_g), vgg(t_g))
    loss = l1 + perceptual_weight * perc + tv_weight * tv_loss(y_g, mesh)
    return loss if mask is None else loss * mask


def scalar_from_per_sample(loss: torch.Tensor) -> torch.Tensor:
    """The scalar the reference differentiates: the sum of the unreduced loss."""
    return torch.sum(loss)
