"""Host time of the loop between steps: from a step call's return to the
next call (the loss read back, logging, the feed's wait)."""

from hdrbench.readers import span_ms


def read(out):
    return span_ms(out, "train.loop_gap")
