"""singlehdr_tpu_torch — the PyTorch/CUDA port of the single-image HDR pipeline.

The serving forward of ``singlehdr_tpu`` (deq -> lin -> apply_rf -> hal -> ref)
rewritten in PyTorch for an NVIDIA H100, with the JAX package's four Pallas
kernels rewritten as hand CUDA C++ kernels for sm_90a (``csrc/``).  The JAX
package stays beside it as the reference the port is held against.

Subpackages mirror ``singlehdr_tpu``:

ops       Plain tensor ops (LUT application, Sobel, soft histograms, masks,
          TF-semantics resizing) and, under ``ops.cuda``, the kernel wrappers.
models    ``nn.Module`` counterparts of the four nets and the composite pipeline.
cli       The serving entry point.

Every kernel wrapper takes its plain PyTorch version for a tensor on the CPU
and launches its CUDA kernel, or raises, for a tensor on the GPU.

This package never imports JAX; it reuses only the numpy-only modules
``singlehdr_tpu.calib``, ``singlehdr_tpu.data.hdr_io`` and the npz reader in
``singlehdr_tpu.train.weight_import``.
"""

__version__ = "0.1.0"
