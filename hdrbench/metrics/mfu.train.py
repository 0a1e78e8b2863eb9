"""The joint step's share of the card's peak: each counted op's FLOPs over
the peak of its dtype (the nets' bf16, the VGG's f32), summed, over the
mean time a step of the untraced steps of the window."""


def read(out):
    peak_s, step_s = out.counters.get("peak_step_s"), out.counters.get("step_s_untraced")
    return None if not peak_s or not step_s else 100.0 * peak_s / step_s
