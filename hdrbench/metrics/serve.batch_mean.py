"""Real images a ``predict_batch`` call of the server's batcher, over the
calls that began in the window."""


def read(out):
    return out.counters.get("batch_mean")
