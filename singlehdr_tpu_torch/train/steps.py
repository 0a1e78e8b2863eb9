"""Train steps reproducing the reference drivers' objectives (counterpart of
``singlehdr_tpu.train.steps``; the same losses, weights and aux keys).

  pretrain deq:  sum_b mask * mean (clip(deq(jpeg)) - ldr)^2
  pretrain lin:  sum_b mask * (l2 + 0.1 crf_mse)
  pretrain hal:  sum_b mask * (l1_mu + 1e-3 perc + 0.1 tv)
  joint:         deq + (10 l2_lin + crf_mse) + hal under ONE Adam
  finetune:      sum |mu(renorm(ref_out)) - mu(hdr)| under ONE Adam over all four nets

Losses are unreduced per sample and the objective is their SUM, as TF's
``tape.gradient`` reduces a non-scalar target.  Like the JAX package, the
lin terms are paired per sample (the reference broadcast [b,1] against
[b,1,1,1]) and the finetune step feeds hal B_pred.

A step puts the nets in train mode (K2-K4 off, as in JAX), runs the loss
function, takes ONE ``backward()`` of the summed loss and one
``optimizer.step()``; BatchNorm statistics update in the forward.  After it
each parameter's ``.grad`` holds that step's gradient.  The loss functions
are public so that a caller can time forward, backward and optimizer apart.

Each factory takes the compute ``dtype``, as the JAX factories do; the nets
of the state it is called with must compute in it (``init_*_state(dtype=...)``;
a mismatch raises).  The nets return f32, so the losses are f32 in both.

The joint and finetune factories take ``remat``, as JAX's do (its ``_apply``):
each net's forward inside the loss is checkpointed and recomputed in the
backward, to trade work for memory.  ``True`` keeps only each net's input
(``torch.utils.checkpoint``); ``'convs'`` also keeps the outputs of the
convolutions and matmuls and recomputes what lies between them (selective
checkpointing, JAX's policy on ``conv_general_dilated``/``dot_general``).
``apply_rf``, the masks, the losses and Adam stay outside, as in JAX.  The
recompute leaves the BatchNorm running statistics alone
(``layers.running_stats_frozen``): they move once a step, as without remat.

On a mesh (a state that ``parallel.replicate`` put on one) a step is the
single-process step on the global batch, each rank holding its share:
the nets' BatchNorm layers take global statistics (``layers.bind_mesh``,
which binds the VGG of the perceptual loss too), hal's TV term is global
(each loss function takes the ``mesh``; the other reductions are per
sample), the gradients are all-reduced with a SUM between ``backward()``
and ``optimizer.step()``, and the returned loss and the aux means
(``crf_mse``, ``loss_ref``) are the global batch's.  Every rank runs the
same forward and backward, so their collectives, the halo exchanges and
the remat recompute's among them, come in one order.

On a spatial mesh (S > 1) the image tensors are this rank's bands of rows
and the nets work on bands (their layers exchange halo rows).  Each rank
differentiates its share of the global objective, the shares adding up to
it once: the per-sample losses are whole on every band (the means over
pixels are sums over the bands, ``losses.per_sample_mean``, and
``crf_mse``, lin's head and the TV scalar are whole anyway), so a band
takes 1/S of their sum (``losses.scalar_from_per_sample``); the spatial
sums' backward hands every band the gradient of the whole.  The finetune
objective is a sum over pixels: a band's own sum is its share.  The
returned aux tensors are this rank's (its samples, its band).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from singlehdr_tpu_torch.models.layers import bind_mesh, running_stats_frozen
from singlehdr_tpu_torch.ops.color import bgr_to_rgb
from singlehdr_tpu_torch.ops.curves import apply_rf
from singlehdr_tpu_torch.ops.losses import (
    hallucination_loss,
    masked_l2,
    per_sample_mean,
    scalar_from_per_sample,
)
from singlehdr_tpu_torch.ops.masks import clip, highlight_alpha
from singlehdr_tpu_torch.ops.tonemap import mu_tonemap
from singlehdr_tpu_torch.parallel.mesh import all_reduce_gradients, global_scalars
from singlehdr_tpu_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Weights that differ between the pretrain and joint configurations."""

    crf: float = 0.1           # 0.1 pretrain (train.py:191), 1.0 joint
    lin_l2: float = 1.0        # 1.0 pretrain, 10.0 joint (joint_training.py:160)
    perceptual: float = 0.001
    tv: float = 0.1


PRETRAIN_WEIGHTS = LossWeights()
JOINT_WEIGHTS = LossWeights(crf=1.0, lin_l2=10.0)


# the aux values that are means over the batch, logged as the global batch's on a mesh
GLOBAL_MEANS = ("crf_mse", "loss_ref")


class StepOutput(NamedTuple):
    loss: torch.Tensor
    aux: dict


def _crf_mse(pred_invcrf, invcrf_gt):
    return torch.mean(torch.square(pred_invcrf - invcrf_gt), dim=1).reshape(-1, 1, 1, 1)


def deq_loss(nets, ldr, jpeg, mask, mesh=None):
    pred = clip(nets["deq"](jpeg), 0.0, 1.0)
    per_sample = masked_l2(pred, ldr, mask, mesh)
    return scalar_from_per_sample(per_sample, mesh), {"loss_deq": per_sample}


def lin_loss(nets, ldr, clipped_hdr_t, mask, invcrf_gt, mesh=None):
    pred_invcrf = nets["lin"](ldr)
    pred_lin = apply_rf(ldr, pred_invcrf)
    crf_mse = _crf_mse(pred_invcrf, invcrf_gt)
    per_sample = (masked_l2(pred_lin, clipped_hdr_t, mesh=mesh) + PRETRAIN_WEIGHTS.crf * crf_mse) * mask
    return scalar_from_per_sample(per_sample, mesh), {"loss_lin": per_sample, "crf_mse": crf_mse.mean()}


def hal_loss(nets, vgg, hdr_t, clipped_hdr_t, mask, mesh=None):
    alpha = highlight_alpha(clipped_hdr_t)
    y = clipped_hdr_t + alpha * bgr_to_rgb(nets["hal"](clipped_hdr_t))
    per_sample = hallucination_loss(y, hdr_t, vgg, mask, perceptual_weight=PRETRAIN_WEIGHTS.perceptual,
                                    tv_weight=PRETRAIN_WEIGHTS.tv, mesh=mesh)
    return scalar_from_per_sample(per_sample, mesh), {"loss_hal": per_sample, "y_final": y}


def joint_loss(nets, vgg, ldr, jpeg, clipped_hdr_t, hdr_t, mask, invcrf_gt, mesh=None):
    alpha = highlight_alpha(clipped_hdr_t)
    c_pred = clip(nets["deq"](jpeg), 0.0, 1.0)
    loss_deq = masked_l2(c_pred, ldr, mask, mesh)
    pred_invcrf = nets["lin"](ldr)
    b_pred = apply_rf(ldr, pred_invcrf)
    crf_mse = _crf_mse(pred_invcrf, invcrf_gt)
    loss_lin = (JOINT_WEIGHTS.lin_l2 * masked_l2(b_pred, clipped_hdr_t, mesh=mesh)
                + JOINT_WEIGHTS.crf * crf_mse) * mask
    a_pred = clipped_hdr_t + alpha * bgr_to_rgb(nets["hal"](clipped_hdr_t))
    loss_hal = hallucination_loss(a_pred, hdr_t, vgg, mask, perceptual_weight=JOINT_WEIGHTS.perceptual,
                                  tv_weight=JOINT_WEIGHTS.tv, mesh=mesh)
    total = scalar_from_per_sample(loss_deq + loss_lin + loss_hal, mesh)
    aux = {"loss_deq": loss_deq, "loss_lin": loss_lin, "loss_hal": loss_hal,
           "crf_mse": crf_mse.mean(), "c_pred": c_pred, "b_pred": b_pred, "a_pred": a_pred,
           "alpha": alpha}
    return total, aux


def finetune_loss(nets, ldr, hdr, mesh=None):
    c_pred = clip(nets["deq"](ldr), 0.0, 1.0)
    pred_invcrf = nets["lin"](c_pred)
    b_pred = apply_rf(c_pred, pred_invcrf)
    alpha = highlight_alpha(b_pred)
    a_pred = b_pred + alpha * bgr_to_rgb(nets["hal"](b_pred))
    out = nets["ref"](torch.cat([a_pred, b_pred, c_pred], dim=1))
    # renormalise the output mean to 0.5 before the log-domain L1
    out = out / (1e-6 + per_sample_mean(out, mesh)) * 0.5
    loss_map = torch.abs(mu_tonemap(out) - mu_tonemap(hdr))
    aux = {"loss_ref": loss_map.mean(), "c_pred": c_pred, "b_pred": b_pred, "a_pred": a_pred,
           "out": out}
    return torch.sum(loss_map), aux


def apply_gradients(state: TrainState, loss: torch.Tensor) -> None:
    """One backward of the summed loss, the gradients summed over the
    state's mesh if it has one, one Adam step, step + 1."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if state.mesh is not None:
        all_reduce_gradients(state.mesh, state.nets.parameters())
    state.optimizer.step()
    state.step += 1


# the ops whose outputs remat='convs' keeps
SAVED_BY_CONVS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
                   torch.ops.aten.addmm.default)


def _save_convs_and_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in SAVED_BY_CONVS else CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _recompute(net: torch.nn.Module, policy_context):
    with policy_context, running_stats_frozen(net):
        yield


def _checkpointed(net: torch.nn.Module, remat) -> Callable:
    """``net``'s forward as the loss calls it under ``remat``."""
    if remat is False:
        return net

    def contexts():
        if remat == "convs":
            forward, recompute = create_selective_checkpoint_contexts(_save_convs_and_matmuls)
        else:
            forward, recompute = contextlib.nullcontext(), contextlib.nullcontext()
        return forward, _recompute(net, recompute)

    return functools.partial(checkpoint, net, use_reentrant=False, context_fn=contexts)


def _step(loss_fn: Callable, dtype: torch.dtype, *bound, remat=False) -> Callable[..., StepOutput]:
    if remat is not False and remat is not True and remat != "convs":
        raise ValueError(f"remat must be False, True or 'convs', got {remat!r}")

    def train_step(state: TrainState, *batch) -> StepOutput:
        if state.dtype != dtype:
            raise ValueError(f"a {dtype} train step called on nets that compute in {state.dtype}")
        state.nets.train()
        for module in (state.nets, *(b for b in bound if isinstance(b, torch.nn.Module))):
            bind_mesh(module, state.mesh)
        nets = {name: _checkpointed(net, remat) for name, net in state.nets.items()}
        loss, aux = loss_fn(nets, *bound, *batch, mesh=state.mesh)
        apply_gradients(state, loss)
        aux = {k: v.detach() for k, v in aux.items()}
        sums, means = global_scalars(state.mesh, {"loss": loss.detach()},
                                     {k: aux[k] for k in GLOBAL_MEANS if k in aux})
        return StepOutput(sums["loss"], {**aux, **means})

    return train_step


def make_deq_train_step(dtype: torch.dtype = torch.float32):
    """Dequantization pretraining: ``step(state, ldr, jpeg, mask)``."""
    return _step(deq_loss, dtype)


def make_lin_train_step(dtype: torch.dtype = torch.float32):
    """Linearization pretraining: ``step(state, ldr, clipped_hdr_t, mask, invcrf_gt)``."""
    return _step(lin_loss, dtype)


def make_hal_train_step(vgg, dtype: torch.dtype = torch.float32):
    """Hallucination pretraining: ``step(state, hdr_t, clipped_hdr_t, mask)``."""
    return _step(hal_loss, dtype, vgg)


def make_joint_train_step(vgg, dtype: torch.dtype = torch.float32, remat: bool | str = False):
    """Joint deq + lin + hal: ``step(state, ldr, jpeg, clipped_hdr_t, hdr_t, mask, invcrf_gt)``."""
    return _step(joint_loss, dtype, vgg, remat=remat)


def make_finetune_train_step(dtype: torch.dtype = torch.float32, remat: bool | str = False):
    """All four nets on HDR-Real: ``step(state, ldr, hdr)``."""
    return _step(finetune_loss, dtype, remat=remat)
