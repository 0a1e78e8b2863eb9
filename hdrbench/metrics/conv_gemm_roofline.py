"""The conv_gemm kernel's share of its roofline over the traced batches: the
least time the card could take for the convolutions it implements (FLOPs
over the 3xTF32 peak or bytes over HBM bandwidth, the larger) over its
device time in the trace."""

from hdrbench.readers import roofline_pct


def read(out):
    return roofline_pct(out, "conv_gemm")
