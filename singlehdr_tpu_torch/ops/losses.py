"""Loss primitives with the reference's reduction semantics (counterpart of
``singlehdr_tpu.ops.losses``), on NCHW tensors.

Every helper returns the unreduced per-sample tensor [b, 1, 1, 1]; the
objective the train steps differentiate is its SUM, as TF's
``tape.gradient`` reduces a non-scalar target (``scalar_from_per_sample``).
The one batch-wide reduction, ``tv_loss``, takes a ``mesh``: its sums are
then the global batch's, as on a JAX mesh.

On a spatial mesh (S > 1) the images are this rank's bands of rows: each
per-sample mean is the sum over the data index's bands over the global
count (``per_sample_mean``), so every band holds the global per-sample
loss, and ``scalar_from_per_sample`` takes 1/S of the sum: the S bands'
objectives add up to the sample's loss once, and so do their gradients.
"""

from __future__ import annotations

import torch

from singlehdr_tpu_torch.ops.tonemap import mu_tonemap
from singlehdr_tpu_torch.parallel.mesh import bands, global_sum, spatial_sum

_PER_SAMPLE = (1, 2, 3)


def per_sample_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The mean of each sample of ``x`` [b, ...] -> [b, 1, 1, 1]; on a
    spatial ``mesh`` over the whole image, its bands' sums summed."""
    if bands(mesh) == 1:
        return torch.mean(x, dim=_PER_SAMPLE, keepdim=True)
    return spatial_sum(x.sum(dim=_PER_SAMPLE, keepdim=True), mesh) / (x[0].numel() * mesh.spatial)


def masked_l2(pred, target, mask=None, mesh=None) -> torch.Tensor:
    """Per-sample mean squared error [b, 1, 1, 1], optionally masked."""
    loss = per_sample_mean(torch.square(pred - target), mesh)
    return loss if mask is None else loss * mask


def masked_l1(pred, target, mask=None, mesh=None) -> torch.Tensor:
    """Per-sample mean absolute error [b, 1, 1, 1], optionally masked."""
    loss = per_sample_mean(torch.abs(pred - target), mesh)
    return loss if mask is None else loss * mask


def tv_vertical(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The sum of |vertical differences| of [b, c, h, w]; on a spatial
    ``mesh`` this band's, the first row of the band below taken to close
    the last (the image's last row has none)."""
    if bands(mesh) > 1:
        x = mesh.halo(x, 0, 1)
    return torch.sum(torch.abs(x[:, :, 1:] - x[:, :, :-1]))


def tv_loss(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Anisotropic total variation of [b, c, h, w], a scalar: the sums of
    |vertical| and |horizontal| differences, each over b*c*h*w (the
    reference's symmetric-pad form, whose last difference is zero).  On a
    ``mesh`` the sums and b*c*h*w are the global batch's (every rank's ``x``
    of one shape, as ``shard_batch`` gives), and so is the gradient."""
    n = x.numel() * (mesh.world if mesh is not None else 1)
    sums = global_sum(torch.stack([tv_vertical(x, mesh),
                                   torch.sum(torch.abs(x[:, :, :, 1:] - x[:, :, :, :-1]))]), mesh)
    return sums[0] / n + sums[1] / n


def perceptual_l1(feats_a, feats_b, mesh=None) -> torch.Tensor:
    """Sum over feature pairs of the per-sample mean |a - b| -> [b, 1, 1, 1]."""
    total = 0.0
    for fa, fb in zip(feats_a, feats_b):
        total = total + per_sample_mean(torch.abs(fa - fb), mesh)
    return total


def hallucination_loss(y, target, vgg, mask, perceptual_weight: float = 0.001,
                       tv_weight: float = 0.1, mesh=None) -> torch.Tensor:
    """L1 + perceptual + TV in the mu-tonemapped domain -> [b, 1, 1, 1]; the
    TV term is a scalar added to every sample's loss before masking, the
    global batch's on a ``mesh``."""
    y_g = mu_tonemap(y)
    t_g = mu_tonemap(target)
    l1 = per_sample_mean(torch.abs(y_g - t_g), mesh)
    perc = perceptual_l1(vgg(y_g), vgg(t_g), mesh)
    loss = l1 + perceptual_weight * perc + tv_weight * tv_loss(y_g, mesh)
    return loss if mask is None else loss * mask


def scalar_from_per_sample(loss: torch.Tensor, mesh=None) -> torch.Tensor:
    """The scalar the reference differentiates: the sum of the unreduced
    loss; on a spatial ``mesh``, where every band holds it whole, this
    band's 1/S of it."""
    return torch.sum(loss) if bands(mesh) == 1 else torch.sum(loss) / mesh.spatial
