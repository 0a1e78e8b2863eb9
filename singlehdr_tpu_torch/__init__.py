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
calib     EMoR curves and the CRF bank; data: HDR IO, HDR-Synth, the loader.

Every kernel wrapper takes its plain PyTorch version for a tensor on the CPU
and launches its CUDA kernel, or raises, for a tensor on the GPU.

This package imports neither JAX nor anything of the JAX package.  The
numpy-only modules it needs from there (``calib``, ``data``: ``hdr_io``,
``synth``, ``loader``, ``jpeg``; ``utils``) are copied into it.
"""

__version__ = "0.1.0"
