"""Time K1..K4, K1-bwd, the joint train step and the serving path of several
checkouts on one card, in turns, so that two versions of the kernels are
compared within one call.

  python3 -m singlehdr_tpu_torch.tools.kernel_ab PARENT . . PARENT [--out FILE]

Each argument is the root of a checkout (for the parent commit, a
``git archive`` unpacked into a git-ignored directory).  Each runs in its own
process with that root first on ``sys.path``, builds its kernels, builds the
seeded pipeline, and times with that checkout's own ``chip_smoke`` helpers:

- every K1..K4 case of ``chip_smoke.kernel_cases`` at batch 4, 576^2 (CUDA
  events over 20 launches after a warm-up, the host kept ahead by a sleep
  kernel, the same code for every checkout);
- K1-bwd on ``chip_smoke`` phase 8's inputs (``k1_bwd_inputs`` at
  ``BWD_SHAPES``), gx + grf and grf only, warm as above and with the L2
  flushed before each call (``chip_smoke.cold_l2_ms``), and grf only on the
  joint step's own ``ldr`` (``joint_batch``, as phase 11 calls it);
- the joint train step at batch 16, 256^2 (median device time of 5 steps
  after 2, CUDA events, ``chip_smoke.joint_batch`` inputs);
- the serving numbers of ``chip_smoke`` phase 7: p50 of ``predict_batch`` at
  batch 1 (20 runs) and batch 8 (8 runs), 512^2, and the per-net device times
  at batch 8.

Prints one line per checkout and case, and all numbers as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

WORKER = r'''
import json, time
import numpy as np
import torch
import chip_smoke as cs
from singlehdr_tpu_torch.inference import HdrPredictor
from singlehdr_tpu_torch.models import build_pipeline
from singlehdr_tpu_torch.ops import cuda as kernels
from singlehdr_tpu_torch.ops.cuda import _build
from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf, apply_rf_bwd
from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
from singlehdr_tpu_torch.train import steps
from singlehdr_tpu_torch.train.state import init_multi_state


def device_ms(fn, iters):
    """chip_smoke.device_ms, kept here so that every checkout is timed alike."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2.0e9 * (2 * iters * enqueue_s + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
_build.lib()
dev = torch.device("cuda", 0)
pipe = build_pipeline(seed=cs.SEED, device=dev)
out = {"card": cs.card_line(), "cases": [], "serving": {}, "per_net_ms_b8": {}, "joint_step_ms": None}
with torch.inference_mode():
    for name, label, args in cs.kernel_cases(pipe, dev):
        fn = getattr(kernels, name)
        out["cases"].append([name, label, device_ms(lambda: fn(*args), 20)])
for i, (b, n) in enumerate(cs.BWD_SHAPES):
    x, rf, g = cs.k1_bwd_inputs(dev, b, n, cs.SEED + i)
    for name, want in (("apply_rf_bwd", (True, True)), ("apply_rf_bwd grf only", (False, True))):
        fn = lambda: apply_rf_bwd(x, rf, g, *want)
        out["cases"].append([name, f"[{b}, {n}]", device_ms(fn, 20)])
        out["cases"].append([name + " L2 flushed", f"[{b}, {n}]", cs.cold_l2_ms(fn)])
torch.manual_seed(cs.SEED)
batch = cs.joint_batch(dev, cs.TRAIN_BATCH, cs.TRAIN_HW, cs.SEED + 4)
ldr, invcrf = batch[0].reshape(cs.TRAIN_BATCH, -1), batch[5].contiguous()
g = torch.randn_like(ldr)
out["cases"].append(["apply_rf_bwd grf only, step ldr", f"{tuple(ldr.shape)}",
                     device_ms(lambda: apply_rf_bwd(ldr, invcrf, g, False, True), 20)])
state = init_multi_state(("deq", "lin", "hal"), 1e-5, seed=cs.SEED, device=dev)
vgg = Vgg16Features().to(dev)
state.nets.train()
step_ms = []
for i in range(2 + 5):
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    loss, _ = steps.joint_loss(state.nets, vgg, *batch)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    stop.record()
    torch.cuda.synchronize()
    if i >= 2:
        step_ms.append(start.elapsed_time(stop))
out["joint_step_ms"] = float(np.median(step_ms))
del state, vgg, batch
torch.cuda.empty_cache()
predictor = HdrPredictor(pipe)
predictor.warmup([(cs.SERVE_HW, cs.SERVE_HW)], batch_sizes=(1, cs.MAX_BATCH))
rs = np.random.RandomState(cs.SEED + 2)
imgs = [rs.rand(cs.SERVE_HW, cs.SERVE_HW, 3).astype(np.float32) for _ in range(cs.MAX_BATCH)]
for n, reps in ((1, 20), (cs.MAX_BATCH, 8)):
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        predictor.predict_batch(imgs[:n])
        lat.append(time.perf_counter() - t0)
    p50 = float(np.median(lat))
    out["serving"][f"b{n}"] = {"p50_ms": p50 * 1e3, "img_per_s": n / p50}
hw = cs.SERVE_HW + 64
x = torch.rand(cs.MAX_BATCH, 3, hw, hw, device=dev)
with torch.inference_mode():
    c = pipe.deq(x).clamp(0, 1)
    invcrf = pipe.lin(c)
    bp = apply_rf(c, invcrf)
    abc = torch.cat([bp, bp, c], dim=1)
    nets = {"deq": lambda: pipe.deq(x), "lin": lambda: pipe.lin(c),
            "hal": lambda: pipe.hal(bp), "ref": lambda: pipe.ref(abc),
            "pipeline": lambda: pipe(x)}
    out["per_net_ms_b8"] = {k: cs.cuda_ms(f, 3) for k, f in nets.items()}
print("RESULT " + json.dumps(out))
'''


def run(root: str) -> dict:
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", WORKER], cwd=root, env=env,
                          capture_output=True, text=True, timeout=1200)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("roots", nargs="+", help="checkout roots, timed in this order")
    p.add_argument("--out", help="also write the numbers to this JSON file")
    args = p.parse_args()
    results = []
    for root in args.roots:
        r = run(root)
        r["root"] = root
        results.append(r)
        sums = {}
        for name, _, ms in r["cases"]:
            sums[name] = sums.get(name, 0.0) + ms
        print(f"{root}  [{r['card']}]", flush=True)
        for name, label, ms in r["cases"]:
            print(f"  {name:34s} {label:36s} {ms:.4f} ms", flush=True)
        print("  sums " + ", ".join(f"{k} {v:.4f} ms" for k, v in sums.items()) +
              f"; joint step b16 @ 256^2 {r['joint_step_ms']:.2f} ms; serving " + ", ".join(
            f"{b} p50 {v['p50_ms']:.2f} ms {v['img_per_s']:.2f} img/s"
            for b, v in r["serving"].items()) + "; per-net ms at b8 " + ", ".join(
            f"{k} {v:.2f}" for k, v in r["per_net_ms_b8"].items()), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
