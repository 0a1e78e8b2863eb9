"""The share of the window the batcher thread spent inside
``predict_batch`` calls."""


def read(out):
    return out.counters.get("predict_busy_pct")
