"""Per-net pretraining CLI on HDR-Synth (counterpart of
``singlehdr_tpu.cli.train``; the reference's train.py surface).

  python -m singlehdr_tpu_torch.cli.train --hdrdir /data/HDR-Synth --deq true
  python -m singlehdr_tpu_torch.cli.train --hdrdir /data/HDR-Synth --lin true --hal true

Trains on CUDA, f32 with TF32 off; ``--device cpu`` trains on the CPU;
``--dtype bfloat16`` computes the nets in bf16 (f32 parameters and losses).
``--mesh D,S`` trains on a mesh of D data indices x S bands of image rows,
D * S processes, one a device, each started with ``--num_processes D*S
--process_id r --coordinator host:port`` (``parallel``; ``--mesh D`` is
``D,1``); ``--batch_size`` is the global batch.
"""

from __future__ import annotations

import argparse
import os

from singlehdr_tpu_torch.cli import (DTYPES, add_dtype_arg, add_mesh_args, cli_device,
                                     process_mesh)
from singlehdr_tpu_torch.data.synth import get_train_dataset
from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
from singlehdr_tpu_torch.train import steps as steps_mod
from singlehdr_tpu_torch.train.loop import LoopConfig, run_synth_training
from singlehdr_tpu_torch.train.state import init_net_state
from singlehdr_tpu_torch.utils import create_run_dirs, str2bool

LEARNING_RATE = 1e-4  # train.py:20
BATCH_SIZE = 16       # train.py:19
INIT_SEED = 0


def build_parser() -> argparse.ArgumentParser:
    cwd = os.getcwd()
    p = argparse.ArgumentParser(description="Pretrain deq/lin/hal on HDR-Synth")
    p.add_argument("--hdrdir", "--dir", dest="hdrdir", type=str, required=True)
    p.add_argument("--deq", type=str2bool, default=False)
    p.add_argument("--lin", type=str2bool, default=False)
    p.add_argument("--hal", type=str2bool, default=False)
    p.add_argument("--deq_ckpt", type=str, default=os.path.join(cwd, "checkpoints/deq"))
    p.add_argument("--lin_ckpt", type=str, default=os.path.join(cwd, "checkpoints/lin"))
    p.add_argument("--hal_ckpt", type=str, default=os.path.join(cwd, "checkpoints/hal"))
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
    add_mesh_args(p)
    return p


def run(args) -> None:
    with process_mesh(args, cli_device(args.device)) as (device, mesh):
        _run(args, device, mesh)


def _run(args, device, mesh) -> None:
    dtype = DTYPES[args.dtype]
    cfg = LoopConfig(batch_size=args.batch_size, iterations=args.iterations, use_jpeg=args.jpeg,
                     n_workers=args.workers, log_every=args.log_every,
                     ckpt_every=args.ckpt_every)
    dataset = get_train_dataset(args.hdrdir, patch_size=args.patch_size)
    units = (
        ("deq", args.deq, args.deq_ckpt, lambda: steps_mod.make_deq_train_step(dtype),
         lambda b: (b["ldr"], b["jpeg"], b["mask"]), ()),
        ("lin", args.lin, args.lin_ckpt, lambda: steps_mod.make_lin_train_step(dtype),
         lambda b: (b["ldr"], b["clipped_hdr_t"], b["mask"], b["invcrf"]), ()),
        ("hal", args.hal, args.hal_ckpt,
         lambda: steps_mod.make_hal_train_step(Vgg16Features(npy_path=args.vgg_ckpt).to(device),
                                               dtype),
         lambda b: (b["hdr_t"], b["clipped_hdr_t"], b["mask"]), ("y_final",)),
    )
    for name, wanted, ckpt_dir, make_step, batch_to_args, taps in units:
        if not wanted:
            continue
        run_synth_training(
            module_name=name,
            state=init_net_state(name, args.lr, seed=INIT_SEED, device=device, dtype=dtype),
            step_fn=make_step(),
            dataset=dataset,
            cfg=cfg,
            ckpt_dir=ckpt_dir,
            log_dir=create_run_dirs(os.getcwd(), name)["tensorboard"],
            batch_to_args=batch_to_args,
            image_taps=taps,
            mesh=mesh,
        )


if __name__ == "__main__":
    run(build_parser().parse_args())
