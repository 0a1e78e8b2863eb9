"""The composite reverse-camera pipeline: deq -> lin -> apply_rf -> hal -> ref
(counterpart of ``singlehdr_tpu.models.pipeline``).  NCHW throughout.

    C_pred = clip(deq(ldr), 0, 1)
    invcrf = lin(C_pred)
    B_pred = apply_rf(C_pred, invcrf)          (K1)
    alpha  = highlight_alpha(B_pred)
    A_pred = B_pred + alpha * bgr_to_rgb(hal(B_pred))
    hdr    = ref(concat[A_pred, B_pred, C_pred])   (A_pred without refinement)

hal is fed B_pred, as in the reference's inference script.  ``dtype`` is the
four nets' compute dtype (f32 or bf16): each net returns f32, so ``apply_rf``
(K1), the mask and the blend stay f32, and ``hdr`` is f32 in both.  On a spatial mesh (``layers.mesh_bound``) the
input is this rank's band of rows and so is every output but ``invcrf``,
which every band of an image holds whole.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from singlehdr_tpu_torch.models.dequantization import DequantizationNet
from singlehdr_tpu_torch.models.hallucination import HallucinationNet
from singlehdr_tpu_torch.models.layers import keras_init_
from singlehdr_tpu_torch.models.linearization import LinearizationNet
from singlehdr_tpu_torch.models.refinement import RefinementNet
from singlehdr_tpu_torch.ops.color import bgr_to_rgb
from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf
from singlehdr_tpu_torch.ops.masks import highlight_alpha
from singlehdr_tpu_torch.precision import use_full_f32


@dataclasses.dataclass
class PipelineOutputs:
    """Stage outputs named as in the reference's scripts (NCHW)."""

    c_pred: torch.Tensor   # dequantized LDR
    invcrf: torch.Tensor   # [b, 1024] inverse CRF
    b_pred: torch.Tensor   # linearized irradiance
    alpha: torch.Tensor    # highlight blend mask
    a_pred: torch.Tensor   # hallucinated HDR
    hdr: torch.Tensor      # refined output (a_pred when refinement is off)


class ReverseCameraPipeline(nn.Module):
    """Full 4-net single-image HDR reconstruction.  Without refinement
    (``use_refinement``, or the forward's argument) ``ref`` does not run and
    ``hdr`` is ``a_pred``; its weights stay, as in the Flax pipeline."""

    def __init__(self, dtype: torch.dtype = torch.float32, use_refinement: bool = True):
        super().__init__()
        self.dtype = dtype
        self.use_refinement = use_refinement
        self.deq = DequantizationNet(dtype)
        self.lin = LinearizationNet(dtype)
        self.hal = HallucinationNet(dtype)
        self.ref = RefinementNet(dtype)

    def forward(self, ldr: torch.Tensor, use_refinement: bool | None = None) -> PipelineOutputs:
        if use_refinement is None:
            use_refinement = self.use_refinement
        c_pred = torch.clamp(self.deq(ldr), 0.0, 1.0)
        invcrf = self.lin(c_pred)
        b_pred = apply_rf(c_pred, invcrf)
        alpha = highlight_alpha(b_pred)
        a_pred = b_pred + alpha * bgr_to_rgb(self.hal(b_pred))
        hdr = self.ref(torch.cat([a_pred, b_pred, c_pred], dim=1)) if use_refinement else a_pred
        return PipelineOutputs(c_pred, invcrf, b_pred, alpha, a_pred, hdr)


def build_pipeline(seed: int = 0, device="cuda",
                   dtype: torch.dtype = torch.float32) -> ReverseCameraPipeline:
    """A seeded, Keras-initialised pipeline in eval mode on ``device``,
    computing in ``dtype`` (f32 parameters either way); f32 with TF32 off
    (``precision.use_full_f32``)."""
    use_full_f32()
    pipe = ReverseCameraPipeline(dtype)
    keras_init_(pipe, torch.Generator().manual_seed(seed))
    return pipe.to(device).eval()
