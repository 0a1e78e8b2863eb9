"""The joint step's device span: CUDA events before and after each call of
the step in the window."""

from hdrbench.readers import span_ms


def read(out):
    return span_ms(out, "train.step")
