"""Quality anchor: the full training recipe of the port at reduced scale.

Runs pretrain (deq, lin, hal) -> joint -> record conversion -> finetune ->
evaluate through the port's CLIs on procedurally synthesised HDR scenes, and
writes the trained pipeline's PSNR/SSIM as a reproducible anchor.  The stage
sequence, arguments and scenes are the JAX package's quality-anchor tool's
(``tools/quality_anchor.py``; the reference scripts train.py,
joint_training.py and finetune_real_dataset.py, SURVEY.md §3); only the data
is synthetic, so no dataset is needed.

    python -m singlehdr_tpu_torch.tools.quality_anchor --workdir /tmp/anchor \
        --steps 900 --joint_steps 4000 --n_train 64 --n_test 48 \
        --finetune_epochs 12

Each stage is a fresh process (clean device memory, as the CLIs run) in the
workdir, so its run directories (``tensorboard/``, ``outputImg/``) and the
CLIs' default ``vgg16.npy`` path are there; a missing ``vgg16.npy`` takes the
seeded surrogate.  Every stage that takes ``--device`` gets this tool's
(default ``cuda``, which fails without a card; ``--device cpu`` runs on the
CPU).

Writes ``QUALITY_TORCH_fresh.json`` at the repo root (``--out``): the JAX
tool's keys (``psnr_mu``, ``ssim_mu``, ``psnr_linear``, ``steps``, ``data``,
``wall_s``) plus ``run`` ("fresh"), ``dtype``, ``device`` (the card's name and
power limit as nvidia-smi gives them) and ``stages``: each stage's wall
seconds and its first and last logged loss.
``tests/test_torch_quality_anchor.py`` gates that artifact.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLI_PACKAGE = "singlehdr_tpu_torch.cli"
# the training loops' log lines: "[deq] step 100  loss 0.01234  (0.05s/step)"
# and "[ref] epoch 3  loss 0.08123  (12.3s)"
LOSS_LINE = re.compile(r"^\[(\w+)\] (?:step|epoch) (\d+)\s+loss (\S+)")


def synth_scene(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Structured HDR scene: low-frequency radiance + shapes + bright emitters.

    Gives the nets learnable structure (edges, smooth ramps, saturated
    highlight regions with plausible surroundings) rather than white noise.
    """
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    base = np.zeros((h, w, 3), np.float32)
    # smooth illumination: a few random 2-D sinusoids per channel
    for c in range(3):
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 4.0, 2)
            ph_y, ph_x = rng.uniform(0, 2 * math.pi, 2)
            base[..., c] += rng.uniform(0.1, 0.5) * (
                np.sin(2 * math.pi * fy * yy + ph_y)
                * np.sin(2 * math.pi * fx * xx + ph_x)
            )
    img = np.exp(base)  # positive, mid-range
    # matte rectangles and disks with random albedo
    for _ in range(rng.randint(6, 14)):
        cy, cx = rng.uniform(0, 1, 2)
        ry, rx = rng.uniform(0.03, 0.25, 2)
        albedo = rng.uniform(0.05, 1.5, 3).astype(np.float32)
        if rng.rand() < 0.5:
            m = (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
        else:
            m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        img[m] = img[m] * 0.3 + albedo * rng.uniform(0.5, 2.0)
    # bright emitters (windows/lamps): the content hal must hallucinate
    for _ in range(rng.randint(1, 4)):
        cy, cx = rng.uniform(0.1, 0.9, 2)
        ry, rx = rng.uniform(0.02, 0.12, 2)
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        img[m] = rng.uniform(8.0, 60.0) * rng.uniform(0.7, 1.0, 3)
        # soft glow around the emitter
        d2 = ((yy - cy) / (3 * ry)) ** 2 + ((xx - cx) / (3 * rx)) ** 2
        img += np.exp(-4.0 * d2)[..., None] * rng.uniform(0.5, 2.0)
    return img.astype(np.float32)


def write_real_pair(rng, test_curves, hdr, hdr_path: str, jpg_path: str):
    """Render one HDR-Real-style pair: an LDR exposure of ``hdr`` through a
    held-out CRF + JPEG, like the reference's HDR-Real capture chain."""
    import cv2

    from singlehdr_tpu_torch.data.hdr_io import write_hdr

    t = 0.5 / max(hdr.mean(), 1e-6)
    crf = test_curves[rng.randint(len(test_curves))]
    ldr_lin = np.clip(hdr * t * rng.uniform(0.7, 1.4), 0, 1)
    idx = np.clip((ldr_lin * (len(crf) - 1)), 0, len(crf) - 1)
    lo = np.floor(idx).astype(np.int32)
    hi = np.minimum(lo + 1, len(crf) - 1)
    ldr = crf[lo] * (1 - (idx - lo)) + crf[hi] * (idx - lo)
    u8 = np.clip(ldr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    write_hdr(hdr_path, hdr)
    cv2.imwrite(
        jpg_path, u8[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, int(rng.uniform(85, 100))]
    )


def make_dataset(workdir: str, n_train: int, n_test: int):
    """``n_train`` HDR-Synth-style scenes under ``synth/`` and ``n_test``
    HDR-Real-style pairs under ``real/`` (seed 7); returns the two dirs."""
    from singlehdr_tpu_torch.calib.crf import get_crf_bank
    from singlehdr_tpu_torch.data.hdr_io import write_hdr

    rng = np.random.RandomState(7)
    synth = os.path.join(workdir, "synth")
    os.makedirs(synth, exist_ok=True)
    for i in range(n_train):
        write_hdr(os.path.join(synth, f"s{i:03d}.hdr"), synth_scene(rng, 512, 768))
    real = os.path.join(workdir, "real")
    os.makedirs(os.path.join(real, "HDR_gt"), exist_ok=True)
    os.makedirs(os.path.join(real, "LDR_in"), exist_ok=True)
    test_curves = np.asarray(get_crf_bank().test_crf)  # held-out curves, as HDR-Real would be
    for i in range(n_test):
        write_real_pair(
            rng, test_curves, synth_scene(rng, 512, 768),
            os.path.join(real, "HDR_gt", f"{i}.hdr"),
            os.path.join(real, "LDR_in", f"{i}.jpg"),
        )
    return synth, real


@dataclasses.dataclass
class Stage:
    """What one stage printed, its wall seconds and its logged losses as
    (step or epoch, loss) in print order."""

    stdout: str
    wall_s: float
    losses: list

    def record(self) -> dict:
        return {"wall_s": round(self.wall_s, 1),
                "first_loss": list(self.losses[0]) if self.losses else None,
                "last_loss": list(self.losses[-1]) if self.losses else None}


def stage_command(module: str, argv) -> list:
    return [sys.executable, "-m", f"{CLI_PACKAGE}.{module}", *argv]


def logged_losses(stdout: str) -> list:
    """[(step or epoch, loss)] of the training loops' log lines."""
    found = (LOSS_LINE.match(line) for line in stdout.splitlines())
    return [(int(m.group(2)), float(m.group(3))) for m in found if m]


def run_stage(module: str, argv, cwd: str) -> Stage:
    """Run one CLI stage in a FRESH process in ``cwd``, echoing its standard
    output as it comes and keeping it; a stage that fails ends the run."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    t0 = time.time()
    proc = subprocess.Popen(stage_command(module, argv), cwd=cwd, env=env,
                            stdout=subprocess.PIPE, text=True)
    lines = []
    for line in proc.stdout:
        sys.stdout.write(line)
        sys.stdout.flush()
        lines.append(line)
    if proc.wait():
        raise SystemExit(f"{module} failed ({proc.returncode})")
    wall = time.time() - t0
    print(f"[{module}] done in {wall:.0f}s", flush=True)
    stdout = "".join(lines)
    return Stage(stdout, wall, logged_losses(stdout))


def parse_result_line(stdout: str) -> dict:
    return json.loads(
        [l for l in stdout.strip().splitlines() if l.startswith("{")][-1]
    )


def device_line(device: str) -> str:
    """The card's name and power limit (nvidia-smi), or ``cpu``."""
    if not device.startswith("cuda"):
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu, for every stage that takes it")


def main(argv=None) -> dict:
    from singlehdr_tpu_torch.cli import cli_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "shdr_anchor"))
    p.add_argument("--steps", type=int, default=1500, help="per pretrain stage")
    p.add_argument("--joint_steps", type=int, default=1500)
    p.add_argument("--finetune_epochs", type=int, default=2)
    p.add_argument("--n_train", type=int, default=60)
    p.add_argument("--n_test", type=int, default=12)
    p.add_argument("--out", default=os.path.join(REPO, "QUALITY_TORCH_fresh.json"))
    p.add_argument("--ckpt_every", type=int, default=600,
                   help="checkpoint cadence for every stage")
    add_common_args(p)
    args = p.parse_args(argv)
    cli_device(args.device)  # no card: raise before any work

    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    t_all = time.time()
    synth, real = make_dataset(workdir, args.n_train, args.n_test)
    print(f"[data] {args.n_train} train + {args.n_test} eval scenes", flush=True)

    dev = ["--device", args.device]
    ck = lambda n: os.path.join(workdir, "ck_" + n)
    common = [
        "--batch_size", str(args.batch),
        "--patch_size", "256",
        "--dtype", args.dtype,
        "--workers", str(args.workers),
        "--log_every", "100",
    ]
    stages = {}
    for net in ("deq", "lin", "hal"):
        # the JPEG round-trip only feeds the deq input (train.py:51-59); lin
        # and hal never consume it, so skip the host JPEG work for their runs
        jpeg = ["--jpeg", "true" if net == "deq" else "false"]
        stages[f"pretrain_{net}"] = run_stage("train",
            ["--hdrdir", synth, f"--{net}", "true",
             "--deq_ckpt", ck("deq"), "--lin_ckpt", ck("lin"),
             "--hal_ckpt", ck("hal"),
             "--iterations", str(args.steps),
             "--ckpt_every", str(args.ckpt_every),
             *jpeg, *common, *dev], workdir)
        print(f"[pretrain {net}] {args.steps} steps in {stages[f'pretrain_{net}'].wall_s:.0f}s",
              flush=True)

    stages["joint"] = run_stage("joint_train",
        ["--dir", synth,
         "--deq_ckpt", ck("deq"), "--lin_ckpt", ck("lin"),
         "--hal_ckpt", ck("hal"), "--jnt_ckpt", ck("jnt"),
         "--iterations", str(args.joint_steps),
         "--ckpt_every", str(args.ckpt_every),
         *common, *dev], workdir)
    print(f"[joint] {args.joint_steps} steps in {stages['joint'].wall_s:.0f}s", flush=True)

    records = os.path.join(workdir, "records")
    for prefix, lo, hi in (("train", 0, args.n_test - 4), ("test", args.n_test - 4, args.n_test)):
        sub = os.path.join(workdir, f"real_{prefix}")
        os.makedirs(os.path.join(sub, "HDR_gt"), exist_ok=True)
        os.makedirs(os.path.join(sub, "LDR_in"), exist_ok=True)
        for i in range(lo, hi):
            for d in ("HDR_gt", "LDR_in"):
                ext = ".hdr" if d == "HDR_gt" else ".jpg"
                src = os.path.join(real, d, f"{i}{ext}")
                dst = os.path.join(sub, d, f"{i}{ext}")
                if not os.path.exists(dst):
                    os.link(src, dst)
        stages[f"records_{prefix}"] = run_stage("convert_records",
            ["--dir", sub, "--out", records, "--prefix", prefix,
             "--patch_size", "256", "--patch_stride", "128"], workdir)
    print("[records] converted", flush=True)

    stages["finetune"] = run_stage("finetune",
        ["--records", records,
         "--deq_ckpt", ck("jnt"), "--lin_ckpt", ck("jnt"),
         "--hal_ckpt", ck("jnt"), "--ref_ckpt", ck("ref"),
         "--epochs", str(args.finetune_epochs),
         "--batch_size", "4", "--dtype", args.dtype, *dev], workdir)
    print(f"[finetune] {args.finetune_epochs} epochs in {stages['finetune'].wall_s:.0f}s",
          flush=True)

    stages["evaluate"] = run_stage("evaluate",
        ["--records", records, "--prefix", "test",
         "--deq_ckpt", ck("ref"), "--lin_ckpt", ck("ref"),
         "--hal_ckpt", ck("ref"), "--ref_ckpt", ck("ref"),
         "--batch_size", "4", *dev], workdir)
    results = parse_result_line(stages["evaluate"].stdout)
    summary = {
        "run": "fresh",
        "psnr_mu": results.get("psnr_mu_db"),
        "ssim_mu": results.get("ssim_mu"),
        "psnr_linear": results.get("psnr_linear_db"),
        "steps": {
            "pretrain_each": args.steps,
            "joint": args.joint_steps,
            "finetune_epochs": args.finetune_epochs,
        },
        "data": {"train_scenes": args.n_train, "eval_scenes": args.n_test},
        "dtype": args.dtype,
        "device": device_line(args.device),
        "stages": {name: stage.record() for name, stage in stages.items()},
        "wall_s": round(time.time() - t_all, 1),
    }
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
