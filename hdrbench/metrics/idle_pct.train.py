"""The device's idle share of the traced sub-window: 100 x (1 - busy / window)."""

from hdrbench.readers import idle_pct


def read(out):
    return idle_pct(out)
