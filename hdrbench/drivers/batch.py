"""Closed-loop batch conversion through ``HdrPredictor.predict_batch``.

Traffic keys: ``batch``, ``height``, ``width`` (the images as the caller
holds them), ``pool_img_s`` (images made at set-up per second of window;
more are made in the window only if the program outruns it),
``warm_batches``, ``check_images`` sampled from the seed among the first
``check_batches`` batches, ``trace_batches`` profiled from a third of the
window on, and ``limits``.

Inputs are seeded smooth scenes tone-mapped to 8 bits (``scenes``), each
used once.  The caller's part of a batch, inside the window, is the
conversion of its 8-bit images to float32 in [0, 1]; ``predict_batch``
pads, stacks, uploads, runs, downloads and crops.  The rate is every image
returned in the window over the window's seconds.

Checked: the sampled images' HDR outputs against the reference pipeline on
the same 8-bit inputs (its own pad and crop), max |err| / max |ref|, the
worst image.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hdrbench import scenes, system
from hdrbench.harness import Outcome, free, full_f32, memory_peak, reset_peak, since, synchronize
from hdrbench.reference import flops as FL
from hdrbench.reference import geometry
from hdrbench.reference import nets as R
from hdrbench.trace import Tracer
from hdrbench.weights import generator, sub_seed

POOL_TAG, WARM_TAG, SAMPLE_TAG = 10, 11, 12
NETS = ("deq", "lin", "hal", "ref")


class NetTimer:
    """CUDA events at the entry and exit of each net's forward, and the
    pipeline's first and last; read after the batch has synchronised."""

    def __init__(self, pipe):
        self._hooks = []
        for name in NETS:
            net = getattr(pipe, name)
            self._hooks.append(net.register_forward_pre_hook(self._mark(name, 0)))
            self._hooks.append(net.register_forward_hook(self._mark(name, 1)))
        self.events = {}

    def _mark(self, name, end):
        def hook(*_):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events[(name, end)] = e
        return hook

    def read(self) -> dict:
        ev, self.events = self.events, {}
        out = {n: ev[(n, 0)].elapsed_time(ev[(n, 1)]) / 1e3 for n in NETS if (n, 1) in ev}
        out["pipeline"] = ev[(NETS[0], 0)].elapsed_time(ev[(NETS[-1], 1)]) / 1e3
        return out

    def close(self):
        for h in self._hooks:
            h.remove()


def run(cell) -> Outcome:
    t = cell.traffic
    b, h, w, dev = t["batch"], t["height"], t["width"], cell.device
    reset_peak(dev)
    wts = system.weights(cell)
    pred = system.predictor(cell, wts)
    pool_gen = generator(cell.seed, dev, POOL_TAG)
    n_pool = b * max(2, -(-int(t["pool_img_s"] * cell.seconds) // b))
    pool = scenes.ldr_images(pool_gen, n_pool, h, w, dev)
    pred.warmup([(h, w)], batch_sizes=(b,))
    warm = scenes.ldr_images(generator(cell.seed, dev, WARM_TAG), b, h, w, dev)
    for _ in range(t["warm_batches"]):
        pred.predict_batch(list(warm.astype(np.float32) * np.float32(1 / 255)))
    rng = np.random.default_rng(sub_seed(cell.seed, SAMPLE_TAG))
    picks = rng.choice(t["check_batches"] * b, size=t["check_images"], replace=False)
    keep = {int(i): None for i in picks}
    timer = NetTimer(pred.pipeline) if cell.trace and dev.type == "cuda" else None
    tracer = Tracer(cell.trace, dev)
    counters = {"extended_pool": 0}
    spans = {f"net_ms.{n}": [] for n in NETS}
    spans["predictor.host"] = []
    untraced_imgs, untraced_s, traced_from = 0, 0.0, None
    synchronize(dev)
    setup_s = since(cell.t0)
    t_start = time.perf_counter()
    t_prev, k = t_start, 0
    while True:
        if (k + 1) * b > len(pool):
            pool = np.concatenate([pool, scenes.ldr_images(pool_gen, b, h, w, dev)])
            counters["extended_pool"] += 1
        imgs = list(pool[k * b:(k + 1) * b].astype(np.float32) * np.float32(1 / 255))
        t_b = time.perf_counter()
        outs = pred.predict_batch(imgs)
        t_e = time.perf_counter()
        for j in range(b):
            if k * b + j in keep:
                keep[k * b + j] = outs[j].copy()
        if timer is not None:
            ms = timer.read()
            for n in NETS:
                spans[f"net_ms.{n}"].append(ms[n])
            spans["predictor.host"].append((t_e - t_b) - ms["pipeline"])
        k += 1
        if not tracer.active:
            untraced_imgs, untraced_s = untraced_imgs + b, untraced_s + (t_e - t_prev)
        t_prev = t_e
        if cell.trace and traced_from is None and t_e - t_start >= cell.seconds / 3:
            tracer.start()
            traced_from = k
        elif tracer.active and k - traced_from >= t["trace_batches"]:
            tracer.stop_recording()
            counters["traced_batches"] = k - traced_from
            t_prev = time.perf_counter()
        if t_e - t_start >= cell.seconds:
            break
    window_s = t_e - t_start
    if tracer.active:
        counters["traced_batches"] = k - traced_from
    tracer.stop_recording()
    if timer is not None:
        timer.close()
    images = k * b
    peak = memory_peak(dev)
    from singlehdr_tpu_torch.ops.cuda import launch_counts_by_dtype

    launches = launch_counts_by_dtype()
    del pred, outs
    free(dev)
    tracer.summarize()

    # the reference, on the sampled images
    full_f32()
    idx = sorted(i for i, v in keep.items() if v is not None)
    imgs = [pool[i].astype(np.float32) * np.float32(1 / 255) for i in idx]
    refine = cell.config["use_refinement"]
    refs = geometry.forward_images(lambda x: R.pipeline(R.F32, x, wts, refine_output=refine), imgs, dev)
    err = max(geometry.rel_err(keep[i], r) for i, r in zip(idx, refs))

    hp, wp = h + 2 * geometry.PAD, w + 2 * geometry.PAD
    sections = FL.kernel_sections(b, hp, wp)
    counters.update(images=images, batches=k,
                    flops_per_image=FL.pipeline_flops(1, hp, wp),
                    img_s_untraced=untraced_imgs / untraced_s if untraced_s else None,
                    **{f"bound_s.{kern}": FL.bound_s(s) for kern, s in sections.items()})
    return Outcome(
        metrics={"infer_img_s": images / window_s, "setup_s": setup_s},
        checks=[("hdr_rel_err", err, cell.limits["hdr_rel_err"])],
        attempted=images, failed=0, memory_peak_bytes=peak, counters=counters, spans=spans,
        trace=tracer.summary,
        notes=[f"{images} images in {k} batches of {b} in {window_s:.3f} s; "
               f"pool extended {counters['extended_pool']} times; checked {len(idx)} images",
               f"launches by dtype: {launches}"])
