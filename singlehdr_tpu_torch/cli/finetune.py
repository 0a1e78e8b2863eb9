"""HDR-Real finetune CLI: all four nets under one Adam (counterpart of
``singlehdr_tpu.cli.finetune``; the reference's finetune_real_dataset.py).

Restores deq / lin / hal from their pretraining (or joint) checkpoints, then
trains the full pipeline on HDR-Real records at the reference's batch 4 and
lr 1e-5, resuming from ``--ref_ckpt`` when it holds a checkpoint:

  python -m singlehdr_tpu_torch.cli.finetune --records ./records

Trains on CUDA, f32 with TF32 off; ``--device cpu`` trains on the CPU;
``--dtype bfloat16`` computes the nets in bf16 (f32 parameters and loss);
``--remat`` recomputes each net's forward in the backward instead of keeping
its activations (``train.steps``); ``--mesh D,S`` trains on a mesh of D
data indices x S bands of image rows, D * S processes, one a device, each
started with ``--num_processes D*S --process_id r --coordinator host:port``
(``parallel``; ``--mesh D`` is ``D,1``): ``--batch_size`` is the global
batch, and a short tail batch is padded to a multiple of D by repeating its
last sample, as in JAX (so with ``--mesh 1`` too).
"""

from __future__ import annotations

import argparse
import os

from singlehdr_tpu_torch.cli import (DTYPES, add_dtype_arg, add_mesh_args, cli_device,
                                     process_mesh)
from singlehdr_tpu_torch.data.real import HdrRealPipeline
from singlehdr_tpu_torch.train.checkpoint import restore_pretrained_subnets
from singlehdr_tpu_torch.train.loop import run_real_finetune
from singlehdr_tpu_torch.train.state import init_multi_state
from singlehdr_tpu_torch.train.steps import make_finetune_train_step
from singlehdr_tpu_torch.utils import create_run_dirs

LEARNING_RATE = 1e-5  # finetune_real_dataset.py:24
BATCH_SIZE = 4        # finetune_real_dataset.py:25
INIT_SEED = 0


def build_parser() -> argparse.ArgumentParser:
    cwd = os.getcwd()
    p = argparse.ArgumentParser(description="Finetune the full pipeline on HDR-Real")
    p.add_argument("--records", type=str, required=True,
                   help=".shdrec (or reference .tfrecords) directory")
    p.add_argument("--deq_ckpt", type=str, default=os.path.join(cwd, "checkpoints/deq"))
    p.add_argument("--lin_ckpt", type=str, default=os.path.join(cwd, "checkpoints/lin"))
    p.add_argument("--hal_ckpt", type=str, default=os.path.join(cwd, "checkpoints/hal"))
    p.add_argument("--ref_ckpt", type=str, default=os.path.join(cwd, "checkpoints/ref"))
    p.add_argument("--batch_size", type=int, default=BATCH_SIZE)
    p.add_argument("--lr", type=float, default=LEARNING_RATE)
    p.add_argument("--epochs", type=int, default=100_000)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    add_dtype_arg(p)
    p.add_argument("--remat", action="store_true",
                   help="recompute each net's forward in the backward (less memory, more work)")
    add_mesh_args(p)
    return p


def run(args):
    """Finetune; returns the final ``TrainState``."""
    with process_mesh(args, cli_device(args.device)) as (device, mesh):
        return _run(args, device, mesh)


def _run(args, device, mesh):
    dtype = DTYPES[args.dtype]
    pipeline = HdrRealPipeline(args.records, batch_size=args.batch_size, training=True)
    state = init_multi_state(("deq", "lin", "hal", "ref"), args.lr, seed=INIT_SEED, device=device,
                             dtype=dtype)
    state = restore_pretrained_subnets(
        state, {"deq": args.deq_ckpt, "lin": args.lin_ckpt, "hal": args.hal_ckpt})
    return run_real_finetune(
        state=state,
        step_fn=make_finetune_train_step(dtype, remat=args.remat),
        pipeline=pipeline,
        epochs=args.epochs,
        ckpt_dir=args.ref_ckpt,
        log_dir=create_run_dirs(os.getcwd(), "ref")["tensorboard"],
        mesh=mesh,
    )


if __name__ == "__main__":
    run(build_parser().parse_args())
