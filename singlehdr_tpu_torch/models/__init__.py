"""``nn.Module`` counterparts of ``singlehdr_tpu.models``."""

from singlehdr_tpu_torch.models.dequantization import DequantizationNet
from singlehdr_tpu_torch.models.hallucination import HallucinationNet
from singlehdr_tpu_torch.models.linearization import LinearizationNet
from singlehdr_tpu_torch.models.pipeline import (
    PipelineOutputs,
    ReverseCameraPipeline,
    build_pipeline,
)
from singlehdr_tpu_torch.models.refinement import RefinementNet
from singlehdr_tpu_torch.models.unet import ResidualUNet
from singlehdr_tpu_torch.models.vgg16 import Vgg16Features

__all__ = [
    "DequantizationNet",
    "HallucinationNet",
    "LinearizationNet",
    "PipelineOutputs",
    "RefinementNet",
    "ResidualUNet",
    "ReverseCameraPipeline",
    "Vgg16Features",
    "build_pipeline",
]
