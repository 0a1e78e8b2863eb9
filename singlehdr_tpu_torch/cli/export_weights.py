"""Export trained checkpoints into one deployment .npz, all four nets
(counterpart of ``singlehdr_tpu.cli.export_weights``).

  python -m singlehdr_tpu_torch.cli.export_weights --out pipeline.npz \
      --deq_ckpt ... --lin_ckpt ... --hal_ckpt ... --ref_ckpt ... \
      [--reference_out tf_ckpts]

The slots take the port's checkpoint directories, as the infer CLI's do (a
joint or finetune checkpoint holds several nets, so several slots may point
at it); empty slots keep the seeded initialisation; ``--weights`` takes a
consolidated .npz instead.  The .npz has the JAX package's flat keys and
loads with ``--weights`` on the infer, evaluate and serve CLIs of both
packages.  ``--reference_out DIR`` also writes each net as a reference-format
TF2 checkpoint, ``DIR/<net>/ckpt-1`` (TensorBundle) plus its ``checkpoint``
state file.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import torch

from singlehdr_tpu_torch.cli import infer
from singlehdr_tpu_torch.convert import nest_variables, to_jax_variables
from singlehdr_tpu_torch.train.weight_import import export_reference_checkpoint, save_variables_npz

NETS = ("deq", "lin", "hal", "ref")


def build_parser() -> argparse.ArgumentParser:
    cwd = os.getcwd()
    p = argparse.ArgumentParser(description="Export pipeline weights to .npz")
    p.add_argument("--out", type=str, required=True)
    for name in NETS:
        p.add_argument(f"--{name}_ckpt", type=str, default=os.path.join(cwd, f"checkpoints/{name}"))
    p.add_argument("--weights", type=str, default=None,
                   help="consolidated .npz weights (overrides the per-net ckpt dirs)")
    p.add_argument("--reference_out", type=str, default=None,
                   help="also write per-net TF2-format checkpoints (TensorBundle, reference "
                        "key layout) under this directory as <net>/ckpt-1")
    return p


def run(args) -> dict:
    """Export; returns the exported variables (the nested Flax-layout tree)."""
    pipe = infer.load_pipeline(args, torch.device("cpu"))
    variables = nest_variables(to_jax_variables(pipe.state_dict()))
    n = save_variables_npz(variables, args.out)
    print(f"wrote {n} arrays ({os.path.getsize(args.out) / 1e6:.1f} MB) to {args.out}")
    if args.reference_out:
        for net in NETS:
            sub = {"params": variables["params"][net],
                   "batch_stats": variables["batch_stats"].get(net, {})}
            prefix = os.path.join(args.reference_out, net, "ckpt-1")
            count = export_reference_checkpoint(net, sub, prefix)
            print(f"{net}: {count} tensors -> {prefix}.index (+ data shard)")
    return variables


if __name__ == "__main__":
    run(build_parser().parse_args())
