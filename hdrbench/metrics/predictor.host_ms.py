"""Host time a batch in ``HdrPredictor.predict_batch`` outside the
pipeline's device span: the wall time of the call less the span from
deq's first event to ref's last."""

from hdrbench.readers import span_ms


def read(out):
    return span_ms(out, "predictor.host")
