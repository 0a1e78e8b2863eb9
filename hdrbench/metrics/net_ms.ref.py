"""ref's device time a batch: CUDA events at its forward's entry and exit."""

from hdrbench.readers import span_ms


def read(out):
    return span_ms(out, "net_ms.ref")
