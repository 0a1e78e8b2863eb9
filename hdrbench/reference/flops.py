"""Operations and bytes of the reference at a cell's shapes, counted on the
``meta`` device (nothing is computed, nothing is allocated).

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over the
reference's own functions: convolutions and matrix products, forward and
backward, whatever implements them in the program.  A kernel's bytes count
each input (activations, weights, biases) read once and each output written
once, in float32.

Peaks of one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s bf16, 495
TF32, and 165 for float32 computed as three TF32 products (3xTF32, the
port's f32 kernels); 3.35 TB/s of HBM.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from hdrbench.reference import nets as R

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 165e12}
PEAK_BYTES_S = 3.35e12
META = torch.device("meta")


def count(fn, *args) -> int:
    """FLOPs of ``fn(*args)``."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def _meta(*shape):
    return torch.empty(shape, device=META)


def _params(nets):
    return {k: _meta(*s) for k, (_, s) in R.param_spec(nets).items()}


def _nbytes(*shapes) -> int:
    return 4 * sum(math.prod(s) for s in shapes)


def pipeline_flops(b: int, h: int, w: int) -> int:
    """The serving forward of ``b`` images of h x w (padded)."""
    p = _params(["deq", "lin", "hal", "ref"])
    emor = (torch.empty(1024), torch.empty(1024, 25))
    return count(lambda x: R.pipeline(R.F32, x, p, emor=emor), _meta(b, 3, h, w))


def _conv_pair(cin, cout, k, b, h, w, pooled_hw):
    """(FLOPs, bytes) of two same-size convs and a 2x2 pool: x, two kernels
    and biases in; the pooled map and the activation out."""
    w1, w2 = _meta(cout, cin, k, k), _meta(cout, cout, k, k)
    flops = count(lambda x: R.conv_same(R.conv_same(x, w1), w2), _meta(b, cin, h, w))
    ph, pw = pooled_hw
    byts = _nbytes((b, cin, h, w), w1.shape, w2.shape, (cout,), (cout,),
                   (b, cout, h, w), (b, cout, ph, pw))
    return flops, byts


def kernel_sections(b: int, h: int, w: int) -> dict:
    """{kernel: [(FLOPs, bytes), ...]} of the parts of one serving forward
    at b x h x w (padded) that the port's hand kernels implement: K2 (the
    U-Nets' stem pair, down2 and down3) and K4 (hal's enc1 and enc2), both
    ``conv_gemm``; K3 (lin's feature stack and 7x7/2 stem), ``lin_stem``."""
    conv_gemm = []
    for cin in (3, 9):  # deq, ref
        for ci, co, k, s in ((cin, 16, 7, 1), (16, 32, 5, 2), (32, 64, 3, 4)):
            conv_gemm.append(_conv_pair(ci, co, k, b, h // s, w // s, (h // (2 * s), w // (2 * s))))
    for ci, co, s in ((3, 64, 1), (64, 128, 2)):
        hh, ww = h // s, w // s
        conv_gemm.append(_conv_pair(ci, co, 3, b, hh, ww, (-(-hh // 2), -(-ww // 2))))
    stem = _meta(64, R.lin_features(_meta(1, 3, 2, 2)).shape[1], 7, 7)
    flops = count(lambda x: R.conv_same(R.lin_features(x), stem, None, 2), _meta(b, 3, h, w))
    oh, ow = -(-h // 2), -(-w // 2)
    lin_stem = [(flops, _nbytes((b, 3, h, w), stem.shape, (64,), (b, 64, oh, ow)))]
    return {"conv_gemm": conv_gemm, "lin_stem": lin_stem}


def bound_s(sections, dtype: str = "float32") -> float:
    """The least time the card could take over ``sections``: each part's
    larger of FLOPs over the dtype's peak and bytes over HBM bandwidth."""
    return sum(max(f / PEAK_FLOPS[dtype], by / PEAK_BYTES_S) for f, by in sections)


def joint_step_flops(b: int, size: int) -> dict:
    """{"nets": FLOPs, "vgg": FLOPs} of one joint step (forward and
    backward) at b x size^2: the three nets' part and the perceptual VGG's
    (its forward on the target, forward and backward to the input on the
    prediction)."""
    p = {k: t.requires_grad_(True) for k, t in _params(["deq", "lin", "hal"]).items()
         if not k.endswith(R.FROZEN)}
    p.update({k: t for k, t in _params(["deq", "lin", "hal"]).items() if k.endswith(R.FROZEN)})
    vgg = _params(["vgg"])
    img = lambda c=3: _meta(b, c, size, size)  # noqa: E731
    batch = {"ldr": img(), "jpeg": img(), "clipped_hdr_t": img(), "hdr_t": img(),
             "mask": _meta(b, 1, 1, 1), "invcrf": _meta(b, 1024)}
    emor = (torch.empty(1024), torch.empty(1024, 25))

    def step():
        loss = R.joint_loss(R.F32, p, vgg, batch, emor=emor)
        torch.autograd.grad(loss, [t for t in p.values() if t.requires_grad])

    def vgg_part():
        y = img().requires_grad_(True)
        pools = R.vgg_pools(R.F32, y, vgg) + R.vgg_pools(R.F32, img(), vgg)
        torch.autograd.grad(sum(t.sum() for t in pools), [y])

    total, v = count(step), count(vgg_part)
    return {"nets": total - v, "vgg": v}
