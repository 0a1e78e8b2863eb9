"""Import reference (TF2 SingleHDR-tf2) checkpoints into deployment weights
(counterpart of ``singlehdr_tpu.cli.import_reference``).

  python -m singlehdr_tpu_torch.cli.import_reference --out pipeline.npz \
      --deq /path/deq_ckpt/ckpt-40 --lin ... --hal ... --ref ... \
      [--channel_order bgr]

Each ``--<net>`` is a raw ``tf.train.Checkpoint`` prefix (``<prefix>.index``
+ ``<prefix>.data-*``), read by the port's pure-Python TensorBundle parser
without TensorFlow, or an .npz dump of the checkpoint's {key: array}.
``--channel_order bgr`` applies the exact weight permutation for checkpoints
trained on the reference's cv2-BGR synth path (``train.weight_import.
adapt_channel_order``).

The output is the JAX package's flat .npz (keys like
``params/deq/unet/stem1/kernel``), which ``--weights`` loads on the infer,
evaluate and serve CLIs of both packages.  Nets without a supplied
checkpoint keep the port's seeded initialisation and are reported.  A host
file converter: it runs on the CPU and needs no card.
"""

from __future__ import annotations

import argparse
import os

from singlehdr_tpu_torch.convert import nest_variables, to_jax_variables
from singlehdr_tpu_torch.models import build_pipeline
from singlehdr_tpu_torch.train.weight_import import import_net_weights, save_variables_npz

NETS = ("deq", "lin", "hal", "ref")
INIT_SEED = 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert reference TF2 checkpoints to deployment .npz")
    p.add_argument("--out", type=str, required=True)
    for net in NETS:
        p.add_argument(f"--{net}", type=str, default=None,
                       help=f"reference checkpoint prefix or .npz dump for {net}")
    p.add_argument("--channel_order", choices=("rgb", "bgr"), default="rgb",
                   help="channel order the checkpoint was trained with")
    return p


def run(args) -> int:
    """Import every supplied net; returns the number of arrays written."""
    variables = nest_variables(to_jax_variables(build_pipeline(seed=INIT_SEED, device="cpu").state_dict()))
    params, stats = variables["params"], variables["batch_stats"]
    for net in NETS:
        path = getattr(args, net)
        if not path:
            print(f"{net}: no checkpoint supplied — left at init")
            continue
        target = {"params": params[net], "batch_stats": stats.get(net, {})}
        out = import_net_weights(net, path, target, channel_order=args.channel_order)
        s = out.pop("_import_stats")
        params[net] = out["params"]
        stats[net] = out["batch_stats"]
        print(f"{net}: imported {s['imported']} arrays, {s['kept']} kept at init")
        if s["kept"]:
            print(f"  WARNING: {s['kept']} arrays missing from {path}")
    n = save_variables_npz({"params": params, "batch_stats": stats}, args.out)
    print(f"wrote {n} arrays ({os.path.getsize(args.out) / 1e6:.1f} MB) to {args.out}")
    return n


if __name__ == "__main__":
    run(build_parser().parse_args())
