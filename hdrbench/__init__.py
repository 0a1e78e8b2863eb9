"""The benchmark of the PyTorch/CUDA port (``singlehdr_tpu_torch``) on one
NVIDIA H100: ``python3 -m hdrbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see README.md)."""
