"""singlehdr_tpu_torch — the PyTorch/CUDA port of the single-image HDR pipeline.

The serving forward of ``singlehdr_tpu`` (deq -> lin -> apply_rf -> hal -> ref)
and its per-net and joint training, rewritten in PyTorch for an NVIDIA H100,
with the JAX package's Pallas kernels (four forward kernels and apply_rf's
backward) rewritten as hand CUDA C++ kernels for sm_90a (``csrc/``).  The JAX
package stays beside it as the reference the port is held against.

Subpackages mirror ``singlehdr_tpu``:

ops       Plain tensor ops (LUT application, Sobel, soft histograms, masks,
          TF-semantics resizing, tonemaps, losses, the capture simulator) and,
          under ``ops.cuda``, the kernel wrappers.
models    ``nn.Module`` counterparts of the four nets, the composite pipeline
          and the frozen VGG16 of the perceptual loss.
train     Train state, steps, checkpoints, metrics and the HDR-Synth loop.
cli       The serving, per-net training and joint training entry points.

Every kernel wrapper takes its plain PyTorch version for a tensor on the CPU
and launches its CUDA kernel, or raises, for a tensor on the GPU.

This package never imports JAX; it reuses only numpy-only modules of the JAX
package: ``calib``, ``utils``, and ``data`` (``hdr_io``, ``synth``,
``loader``, ``jpeg``).
"""

__version__ = "0.1.0"
