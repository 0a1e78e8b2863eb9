"""Joint deq + lin + hal training CLI on HDR-Synth (counterpart of
``singlehdr_tpu.cli.joint_train``; the reference's joint_training.py).

Restores the per-net pretraining checkpoints, then trains the three nets
under one Adam(1e-5) with the joint weighting (10x lin L2 + crf MSE),
resuming from ``--jnt_ckpt`` when it holds a checkpoint.

  python -m singlehdr_tpu_torch.cli.joint_train --dir /data/HDR-Synth

Trains on CUDA, f32 with TF32 off; ``--device cpu`` trains on the CPU;
``--dtype bfloat16`` computes the nets in bf16 (f32 parameters and losses;
the perceptual VGG stays f32, as in the JAX CLI); ``--remat`` recomputes each
net's forward in the backward instead of keeping its activations
(``train.steps``); ``--mesh D,S`` trains on a mesh of D data indices x S
bands of image rows, D * S processes, one a device, each started with
``--num_processes D*S --process_id r --coordinator host:port``
(``parallel``; ``--mesh D`` is ``D,1``); ``--batch_size`` is the global
batch.
"""

from __future__ import annotations

import argparse
import os

from singlehdr_tpu_torch.cli import (DTYPES, add_dtype_arg, add_mesh_args, cli_device,
                                     process_mesh)
from singlehdr_tpu_torch.data.synth import get_train_dataset
from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
from singlehdr_tpu_torch.train.checkpoint import restore_pretrained_subnets
from singlehdr_tpu_torch.train.loop import LoopConfig, run_synth_training
from singlehdr_tpu_torch.train.state import init_multi_state
from singlehdr_tpu_torch.train.steps import make_joint_train_step
from singlehdr_tpu_torch.utils import create_run_dirs, str2bool

LEARNING_RATE = 1e-5  # joint_training.py:20
BATCH_SIZE = 16       # joint_training.py:21
INIT_SEED = 0


def build_parser() -> argparse.ArgumentParser:
    cwd = os.getcwd()
    p = argparse.ArgumentParser(description="Joint deq+lin+hal training")
    p.add_argument("--dir", type=str, required=True)
    p.add_argument("--deq_ckpt", type=str, default=os.path.join(cwd, "checkpoints/deq"))
    p.add_argument("--lin_ckpt", type=str, default=os.path.join(cwd, "checkpoints/lin"))
    p.add_argument("--hal_ckpt", type=str, default=os.path.join(cwd, "checkpoints/hal"))
    p.add_argument("--jnt_ckpt", type=str, default=os.path.join(cwd, "checkpoints/jnt"))
    p.add_argument("--vgg_ckpt", type=str, default=os.path.join(cwd, "vgg16.npy"))
    p.add_argument("--batch_size", type=int, default=BATCH_SIZE)
    p.add_argument("--lr", type=float, default=LEARNING_RATE)
    p.add_argument("--iterations", type=int, default=5_000_000)
    p.add_argument("--jpeg", type=str2bool, default=True)
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    add_dtype_arg(p)
    p.add_argument("--remat", action="store_true",
                   help="recompute each net's forward in the backward (less memory, more work)")
    add_mesh_args(p)
    return p


def run(args):
    """Train; returns the final ``TrainState``."""
    with process_mesh(args, cli_device(args.device)) as (device, mesh):
        return _run(args, device, mesh)


def _run(args, device, mesh):
    dtype = DTYPES[args.dtype]
    cfg = LoopConfig(batch_size=args.batch_size, iterations=args.iterations, use_jpeg=args.jpeg,
                     n_workers=args.workers, log_every=args.log_every,
                     ckpt_every=args.ckpt_every)
    dataset = get_train_dataset(args.dir, patch_size=args.patch_size)
    state = init_multi_state(("deq", "lin", "hal"), args.lr, seed=INIT_SEED, device=device,
                             dtype=dtype)
    state = restore_pretrained_subnets(
        state, {"deq": args.deq_ckpt, "lin": args.lin_ckpt, "hal": args.hal_ckpt})
    vgg = Vgg16Features(npy_path=args.vgg_ckpt).to(device)
    return run_synth_training(
        module_name="jnt",
        state=state,
        step_fn=make_joint_train_step(vgg, dtype, remat=args.remat),
        dataset=dataset,
        cfg=cfg,
        ckpt_dir=args.jnt_ckpt,
        log_dir=create_run_dirs(os.getcwd(), "jnt")["tensorboard"],
        batch_to_args=lambda b: (b["ldr"], b["jpeg"], b["clipped_hdr_t"], b["hdr_t"], b["mask"],
                                 b["invcrf"]),
        image_taps=("c_pred", "b_pred", "a_pred", "alpha"),
        mesh=mesh,
    )


if __name__ == "__main__":
    run(build_parser().parse_args())
