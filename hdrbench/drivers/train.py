"""The joint training loop users run: ``train.loop.run_synth_training`` with
``make_joint_train_step(vgg, dtype)``, its ``SynthBatchPipeline`` and
prefetcher, on procedural HDR scenes.

Traffic keys: ``batch``, ``patch`` (the crop), ``scenes`` and ``scene_hw``
(the HDR files written at set-up), ``jpeg``, ``workers``, ``prefetch``,
``producers`` (the loop's settings), ``warm_steps`` (set-up steps, the
first ``checked_steps`` of them held against the reference),
``trace_steps`` and ``limits``.

The loop runs once.  Its steps go through a wrapper of the step function:
the first ``checked_steps`` keep their inputs and losses, the first keeps
Adam's first moment (the gradient, as the optimizer got it), and the entry
of step ``checked_steps + 1`` keeps the parameters; step ``warm_steps + 1``
opens the window, and the first call after ``--seconds`` closes it by an
exception of the benchmark's, after which the loop's ``finally`` closes the
feed.  The rate is the samples of every step in the window over its
seconds.  The only checkpoint the loop writes is step 1's, in set-up.

Checked, against the reference's float32 steps from the same weights on
inputs it works out again from each sample's exposed radiance and camera
curve: each step's loss, each leaf's gradient norm and parameter change
(by the worst leaf), the feed's curve application and its JPEG levels.
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from hdrbench import scenes, system
from hdrbench.harness import Outcome, free, full_f32, memory_peak, reset_peak, since, synchronize
from hdrbench.reference import capture
from hdrbench.reference import flops as FL
from hdrbench.reference import nets as R
from hdrbench.trace import Tracer
from hdrbench.weights import generator, sub_seed

SCENE_TAG, LOADER_TAG = 20, 21
ARGS = ("ldr", "jpeg", "clipped_hdr_t", "hdr_t", "mask", "invcrf")
ADAM_B1 = 0.9


class WindowClosed(Exception):
    """Raised from the step wrapper when the window's time is up."""


class RecordedDataset:
    """The training set, keeping each camera curve handed out by its inverse
    (the batch carries only the inverse)."""

    def __init__(self, dataset):
        self._dataset = dataset
        self.crf = {}

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, i):
        item = self._dataset[i]
        self.crf[np.asarray(item[2], np.float32).tobytes()] = np.asarray(item[1], np.float32)
        return item


class Steps:
    """The step function the loop calls: the program's step, with what the
    check and the metrics keep."""

    def __init__(self, step, cell):
        t = cell.traffic
        self.step, self.cell = step, cell
        self.checked, self.warm, self.trace_steps = t["checked_steps"], t["warm_steps"], t["trace_steps"]
        self.calls = 0
        self.batches, self.terms = [], []
        self.first_grad = self.params_after = None
        self.t_start = self.t_end = self.deadline = self.t_return = None
        self.setup_s = None
        self.entries, self.traced, self.gaps, self.events = [], set(), [], []
        self.tracer = Tracer(cell.trace, cell.device)
        self._trace_from = None

    def __call__(self, state, *args):
        n, dev = self.calls, self.cell.device
        now = time.perf_counter()
        if self.t_start is None and n == self.warm:
            synchronize(dev)
            self.setup_s = since(self.cell.t0)
            self.t_start = now = time.perf_counter()
            self.deadline = self.t_start + self.cell.seconds
        elif self.t_start is not None:
            self.gaps.append(now - self.t_return)
            if now >= self.deadline:
                synchronize(dev)
                self.t_end = time.perf_counter()
                self.tracer.stop_recording()
                raise WindowClosed
        in_window = self.t_start is not None
        if in_window:
            self.entries.append(now)
            if self.cell.trace and self._trace_from is None and now - self.t_start >= self.cell.seconds / 3:
                self.tracer.start()
                self._trace_from = n
            if self.tracer.active:
                self.traced.add(len(self.entries) - 1)
                if n - self._trace_from >= self.trace_steps:
                    self.tracer.stop_recording()
        if n < self.checked:
            self.batches.append([a.detach().clone() for a in args])
        if n == self.checked:
            self.params_after = {k: p.detach().clone() for k, p in state.nets.named_parameters()}
        timed = in_window and self.cell.trace and dev.type == "cuda"
        if timed:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        out = self.step(state, *args)
        if timed:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            self.events.append((e0, e1))
        if n < self.checked:
            self.terms.append({k: out.aux[f"loss_{k}"].detach().reshape(-1).clone()
                               for k in ("deq", "lin", "hal")})
        if n == 0:
            moments = state.optimizer.state
            self.first_grad = {k: moments[p]["exp_avg"].detach() / (1 - ADAM_B1) if p in moments
                               else torch.zeros_like(p) for k, p in state.nets.named_parameters()}
        self.calls += 1
        self.t_return = time.perf_counter()
        return out


def write_scenes(cell, root: str) -> None:
    import cv2

    t = cell.traffic
    h, w = t["scene_hw"]
    gen = generator(cell.seed, cell.device, SCENE_TAG)
    hdr = scenes.hdr_scenes(gen, t["scenes"], h, w, cell.device).permute(0, 2, 3, 1).cpu().numpy()
    for i, img in enumerate(hdr):
        if not cv2.imwrite(os.path.join(root, f"scene_{i:03d}.hdr"), np.ascontiguousarray(img[..., ::-1])):
            raise IOError("could not write a scene")


def leaf_gaps(prog: dict, ref: dict, keys) -> list:
    """[(gap, leaf)], worst first: each leaf's | ||prog|| - ||ref|| | over
    the larger of its ||ref|| and the median leaf's."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = statistics.median(rn.values())
    return sorted(((abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30), k) for k in keys), reverse=True)


def loss_gap(prog: list, ref: list) -> float:
    """The worst step's |prog loss - ref loss| / |ref loss| (each step's loss
    the sum of its per-sample terms)."""
    total = lambda t: float(sum(v.double().sum() for v in t.values()))  # noqa: E731
    return max(abs(total(p) - total(r)) / max(abs(total(r)), 1e-30) for p, r in zip(prog, ref))


def moved_leaves(first: dict) -> list:
    """The leaves the reference's first gradient moves: those whose norm is
    at least a thousandth of the median leaf's (a conv's bias before a
    train-mode BatchNorm has a gradient of rounding alone)."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in first.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= 1e-3 * med]


def net_loss_gap(prog: list, ref: list) -> float:
    """The worst step's and net's |prog - ref| / |ref| of the net's loss
    term summed over the batch."""
    return max(abs(float(p[k].double().sum()) - float(r[k].double().sum()))
               / max(abs(float(r[k].double().sum())), 1e-30)
               for p, r in zip(prog, ref) for k in ("deq", "lin", "hal"))


def step_gaps(terms, first_grad, params_after, ref_terms, ref_first, ref_params, start) -> dict:
    """The training numbers: the step losses, the first gradient's and the
    change's norms by leaf (the moved leaves alone), worst and median."""
    moved = moved_leaves(ref_first)
    grad = leaf_gaps(first_grad, ref_first, moved)
    update = leaf_gaps({k: params_after[k] - start[k] for k in moved},
                       {k: ref_params[k] - start[k] for k in moved}, moved)
    return {"loss_rel_gap": loss_gap(terms, ref_terms), "net_loss_gap": net_loss_gap(terms, ref_terms),
            "grad_norm_gap": grad[0][0], "grad_median_gap": statistics.median(g for g, _ in grad),
            "update_norm_gap": update[0][0], "update_median_gap": statistics.median(g for g, _ in update),
            "worst_grad": grad[:3], "worst_update": update[:3], "moved": len(moved),
            "leaves": len(ref_first)}


def compare(cell, steps: Steps, crf_of: dict, wts: dict, vgg_w: dict) -> tuple:
    """The checks of the first steps against the reference's."""
    full_f32()
    dev = cell.device
    params = {k: v.clone() for k, v in wts.items()}
    batches, capture_err, jpeg_mismatch = [], 0.0, 0.0
    for args in steps.batches:
        prog = dict(zip(ARGS, args))
        crf = torch.from_numpy(np.stack([crf_of[r.tobytes()] for r in prog["invcrf"].cpu().numpy()])).to(dev)
        ref = capture.feed_batch(prog["hdr_t"], crf, prog["invcrf"])
        capture_err = max(capture_err, float((prog["ldr"] - ref["ldr"]).abs().max()),
                          float((prog["clipped_hdr_t"] - ref["clipped_hdr_t"]).abs().max()))
        jpeg_mismatch = max(jpeg_mismatch, float((torch.round(prog["jpeg"] * 255)
                                                  != torch.round(ref["jpeg"] * 255)).float().mean()))
        batches.append(ref)
    ref_terms, ref_first = R.train_steps(R.F32, params, vgg_w, batches, cell.config["learning_rate"])
    g = step_gaps(steps.terms, steps.first_grad, steps.params_after, ref_terms, ref_first, params, wts)
    lim = cell.limits
    checks = [(k, g[k], lim[k]) for k in ("loss_rel_gap", "net_loss_gap", "grad_norm_gap", "update_norm_gap")]
    checks += [("capture_abs_err", capture_err, lim["capture_abs_err"]),
               ("jpeg_level_mismatch", jpeg_mismatch, lim["jpeg_level_mismatch"])]
    return checks, [f"losses program {[float(sum(v.sum() for v in t.values())) for t in steps.terms]} "
                    f"reference {[float(sum(v.sum() for v in t.values())) for t in ref_terms]}; "
                    f"{g['moved']} of {g['leaves']} leaves moved by the reference's gradient",
                    f"median leaves (not compared): grad_median_gap {g['grad_median_gap']!r} "
                    f"update_median_gap {g['update_median_gap']!r}",
                    f"worst gradient leaves {[(round(x, 5), k) for x, k in g['worst_grad']]}",
                    f"worst change leaves {[(round(x, 5), k) for x, k in g['worst_update']]}"]


def run(cell) -> Outcome:
    from singlehdr_tpu_torch.data.synth import get_train_dataset
    from singlehdr_tpu_torch.train.loop import LoopConfig, run_synth_training
    from singlehdr_tpu_torch.train.steps import make_joint_train_step

    t, dev = cell.traffic, cell.device
    reset_peak(dev)
    work = tempfile.mkdtemp(prefix="hdrbench-train-")
    try:
        os.makedirs(os.path.join(work, "scenes"))
        write_scenes(cell, os.path.join(work, "scenes"))
        dataset = RecordedDataset(get_train_dataset(os.path.join(work, "scenes"), patch_size=t["patch"]))
        wts, vgg_w = system.weights(cell), system.vgg_weights(cell)
        state = system.train_state(cell, wts)
        dtype = state.dtype
        steps = Steps(make_joint_train_step(system.vgg(cell, vgg_w), dtype), cell)
        cfg = LoopConfig(batch_size=t["batch"], iterations=10**12, ckpt_every=10**12,
                         log_every=10**12, image_log_every=10**12, n_workers=t["workers"],
                         seed=sub_seed(cell.seed, LOADER_TAG) % 2**32, use_jpeg=t["jpeg"],
                         prefetch=t["prefetch"], prefetch_producers=t["producers"])
        try:
            run_synth_training(module_name="jnt", state=state, step_fn=steps, dataset=dataset, cfg=cfg,
                               ckpt_dir=os.path.join(work, "ckpt"), log_dir=os.path.join(work, "log"),
                               batch_to_args=lambda b: tuple(b[k] for k in ARGS),
                               image_taps=("c_pred", "b_pred", "a_pred", "alpha"))
        except WindowClosed:
            pass
        if steps.t_end is None:
            raise RuntimeError("the training loop ended before the window closed")
        window_s = steps.t_end - steps.t_start
        n_steps = len(steps.entries)
        peak = memory_peak(dev)
        from singlehdr_tpu_torch.ops.cuda import launch_counts_by_dtype

        launches = launch_counts_by_dtype()
        step_ms = [a.elapsed_time(b) / 1e3 for a, b in steps.events]
        del state
        free(dev)
        steps.tracer.summarize()
        checks, notes = compare(cell, steps, dataset.crf, wts, vgg_w)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    ends = steps.entries[1:] + [steps.t_end]
    untraced = [e - s for i, (s, e) in enumerate(zip(steps.entries, ends)) if i not in steps.traced]
    f = FL.joint_step_flops(t["batch"], t["patch"])
    peak_s = f["nets"] / FL.PEAK_FLOPS[cell.config["compute_dtype"]] + f["vgg"] / FL.PEAK_FLOPS["float32"]
    counters = {"steps": n_steps, "peak_step_s": peak_s,
                "step_s_untraced": sum(untraced) / len(untraced) if untraced else None}
    return Outcome(
        metrics={"train_img_s": n_steps * t["batch"] / window_s, "setup_s": steps.setup_s},
        checks=checks, attempted=n_steps, failed=0, memory_peak_bytes=peak, counters=counters,
        spans={"train.step": step_ms, "train.loop_gap": steps.gaps},
        trace=steps.tracer.summary,
        notes=notes + [f"{n_steps} steps of {t['batch']} in {window_s:.3f} s",
                       f"launches by dtype: {launches}"])
