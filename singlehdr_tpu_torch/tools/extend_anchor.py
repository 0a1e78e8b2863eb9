"""Continue a quality-anchor run from its checkpoints.

``quality_anchor`` runs the full recipe (pretrain -> joint -> records ->
finetune -> evaluate) from scratch; this tool resumes an existing workdir's
joint stage to more iterations (the loop restores its checkpoint), re-runs
finetune from the joint weights into a fresh ref dir, optionally on more
finetune scenes, then re-evaluates on the unchanged test records.  It is the
JAX package's ``tools/extend_anchor.py`` driving the port's CLIs.

    python -m singlehdr_tpu_torch.tools.extend_anchor --workdir /tmp/anchor \
        --joint_iters 4000 --finetune_epochs 12 --extra_scenes 24

Writes ``QUALITY_TORCH_extension.json`` at the repo root (``--out``) with the
JAX tool's keys plus ``run`` ("extension"), ``dtype``, ``device`` and
``stages``, as ``quality_anchor`` does; ``wall_s`` is this run's whole wall
time.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from singlehdr_tpu_torch.tools import quality_anchor as qa


def main(argv=None) -> dict:
    from singlehdr_tpu_torch.cli import cli_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "shdr_anchor"))
    p.add_argument("--joint_iters", type=int, default=4500,
                   help="total joint iterations (resumes from the checkpoint)")
    p.add_argument("--finetune_epochs", type=int, default=9,
                   help="finetune epochs (from scratch into --ref_name's dir)")
    p.add_argument("--ref_name", default="ref_ext",
                   help="finetune checkpoint dir name under the workdir; a "
                   "FRESH name makes finetune start from the extended joint "
                   "checkpoint (run_real_finetune otherwise restores the full "
                   "old state from an existing ref dir, discarding the new "
                   "joint weights); reuse a name to add epochs instead")
    p.add_argument("--extra_scenes", type=int, default=0,
                   help="generate this many ADDITIONAL HDR-Real-style train "
                   "scenes (fresh seed) and rebuild the train records from "
                   "old+new before finetuning.  Test records are untouched, so "
                   "evaluations stay comparable")
    p.add_argument("--out", default=os.path.join(qa.REPO, "QUALITY_TORCH_extension.json"))
    p.add_argument("--note", default="")
    qa.add_common_args(p)
    args = p.parse_args(argv)
    cli_device(args.device)  # no card: raise before any work

    t_all = time.time()
    W = os.path.abspath(args.workdir)
    ck = lambda n: os.path.join(W, "ck_" + n)
    synth = os.path.join(W, "synth")
    records = os.path.join(W, "records")
    for path in (synth, records, ck("jnt")):
        if not os.path.isdir(path):
            raise SystemExit(f"missing {path}: run the quality_anchor tool first")

    dev = ["--device", args.device]
    stages = {}
    if args.extra_scenes:
        from singlehdr_tpu_torch.calib.crf import get_crf_bank

        # old train pairs (hardlinks) + fresh scenes under a disjoint seed
        src = os.path.join(W, "real_train")
        ext = os.path.join(W, "real_train_ext")
        for d in ("HDR_gt", "LDR_in"):
            os.makedirs(os.path.join(ext, d), exist_ok=True)
            for f in sorted(os.listdir(os.path.join(src, d))):
                dst = os.path.join(ext, d, f)
                if not os.path.exists(dst):
                    os.link(os.path.join(src, d, f), dst)
        rng = np.random.RandomState(430)
        test_curves = np.asarray(get_crf_bank().test_crf)
        for i in range(args.extra_scenes):
            qa.write_real_pair(
                rng, test_curves, qa.synth_scene(rng, 512, 768),
                os.path.join(ext, "HDR_gt", f"x{i:03d}.hdr"),
                os.path.join(ext, "LDR_in", f"x{i:03d}.jpg"),
            )
        records_ext = os.path.join(W, "records_ext")
        os.makedirs(records_ext, exist_ok=True)
        stages["records_train"] = qa.run_stage("convert_records", [
            "--dir", ext, "--out", records_ext, "--prefix", "train",
            "--patch_size", "256", "--patch_stride", "128",
        ], W)
        for f in os.listdir(records):  # share the UNCHANGED test shards
            if f.startswith("test_") and not os.path.exists(
                os.path.join(records_ext, f)
            ):
                os.link(os.path.join(records, f), os.path.join(records_ext, f))
        records = records_ext
        print(f"[extra] +{args.extra_scenes} train scenes -> {records_ext}",
              flush=True)

    stages["joint"] = qa.run_stage("joint_train", [
        "--dir", synth,
        "--deq_ckpt", ck("deq"), "--lin_ckpt", ck("lin"),
        "--hal_ckpt", ck("hal"), "--jnt_ckpt", ck("jnt"),
        "--iterations", str(args.joint_iters), "--ckpt_every", "600",
        "--batch_size", str(args.batch), "--patch_size", "256",
        "--dtype", args.dtype, "--workers", str(args.workers),
        "--log_every", "100", *dev,
    ], W)
    print(f"[joint -> {args.joint_iters}] {stages['joint'].wall_s:.0f}s", flush=True)

    ref = ck(args.ref_name)
    stages["finetune"] = qa.run_stage("finetune", [
        "--records", records,
        "--deq_ckpt", ck("jnt"), "--lin_ckpt", ck("jnt"),
        "--hal_ckpt", ck("jnt"), "--ref_ckpt", ref,
        "--epochs", str(args.finetune_epochs),
        "--batch_size", "4", "--dtype", args.dtype, *dev,
    ], W)
    print(f"[finetune {args.finetune_epochs} ep] {stages['finetune'].wall_s:.0f}s",
          flush=True)

    stages["evaluate"] = qa.run_stage("evaluate", [
        "--records", records, "--prefix", "test",
        "--deq_ckpt", ref, "--lin_ckpt", ref,
        "--hal_ckpt", ref, "--ref_ckpt", ref,
        "--batch_size", "4", *dev,
    ], W)
    results = qa.parse_result_line(stages["evaluate"].stdout)
    summary = {
        "run": "extension",
        "psnr_mu": results.get("psnr_mu_db"),
        "ssim_mu": results.get("ssim_mu"),
        "psnr_linear": results.get("psnr_linear_db"),
        "steps": {"joint": args.joint_iters,
                  "finetune_epochs": args.finetune_epochs,
                  "extra_finetune_scenes": args.extra_scenes},
        "note": args.note or (
            "continuation of a quality_anchor run via the extend_anchor tool"
        ),
        "dtype": args.dtype,
        "device": qa.device_line(args.device),
        "stages": {name: stage.record() for name, stage in stages.items()},
        "wall_s": round(time.time() - t_all, 1),
    }
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
