"""What the per-layer metric files share: each file under
``hdrbench/metrics/`` defines ``read(outcome)`` and returns a number, or
None where the run holds nothing to read (the metric is then left out)."""

from __future__ import annotations

from hdrbench.reference.flops import PEAK_FLOPS


def mean(values):
    values = list(values or ())
    return sum(values) / len(values) if values else None


def span_ms(out, name: str):
    m = mean(out.spans.get(name))
    return None if m is None else 1e3 * m


def idle_pct(out):
    t = out.trace
    if not t or t.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(out, kernel: str):
    """The least time the card could take for the traced calls of a hand
    kernel over their device time: 100 x bound / time, by the kernel name
    fragment ``kernel``."""
    t, bound = out.trace, out.counters.get(f"bound_s.{kernel}")
    if not t or bound is None:
        return None
    device_s = sum(s for name, s in t["kernel_s"].items() if kernel in name)
    if device_s <= 0:
        return None
    return 100.0 * bound * out.counters["traced_batches"] / device_s


def mfu_pct(out, flops_key: str, rate_key: str, dtype: str = "float32"):
    f, rate = out.counters.get(flops_key), out.counters.get(rate_key)
    if not f or not rate:
        return None
    return 100.0 * f * rate / PEAK_FLOPS[dtype]
