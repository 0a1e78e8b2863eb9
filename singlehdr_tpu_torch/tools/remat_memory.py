"""What a train step keeps for its backward, by net, and what each ``remat``
mode keeps instead.

  python3 -m singlehdr_tpu_torch.tools.remat_memory [--step joint|finetune]
      [--batch 16] [--size 256] [--probe 64] [--dtype {float32,bfloat16}] [--device cpu]

Runs the step's loss function once on seeded inputs with the nets in train
mode and counts, by the net that made them (or ``loss`` for the perceptual
VGG, ``apply_rf`` and the masks outside the nets):

  * ``saved``: the tensors autograd saves for the backward (unique storages,
    parameters excluded): what the plain step holds at the end of its
    forward;
  * ``convs``: the outputs of the convolutions and matmuls, which
    ``remat='convs'`` keeps;
  * ``input``: the net's input, which ``remat=True`` keeps.

Each count is a part fixed by the weights (a bf16 step saves its weight
casts) plus a part proportional to batch x pixels, so the step runs at
batch 1 and 2 at ``--probe``^2 (small enough for a CPU) and the two parts,
solved from the two runs, give the counts at ``--batch`` x ``--size``^2.
What stays through the forward is printed for each mode; a remat step's
peak adds to it about the largest net's recompute, also printed.  No kernel
launches here: the nets run in train mode.
"""

from __future__ import annotations

import argparse

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from singlehdr_tpu_torch.cli import DTYPES
from singlehdr_tpu_torch.train import steps
from singlehdr_tpu_torch.train.state import init_multi_state

NETS = {"joint": ("deq", "lin", "hal"), "finetune": ("deq", "lin", "hal", "ref")}


class _ConvOutputs(TorchDispatchMode):
    def __init__(self, on_output):
        super().__init__()
        self.on_output = on_output

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in steps.SAVED_BY_CONVS:
            self.on_output(out)
        return out


def kept_bytes(step: str, batch: int, size: int, dtype: torch.dtype, device) -> dict:
    """{region: {"saved", "convs", "input": bytes}} of one forward of ``step``."""
    state = init_multi_state(NETS[step], 1e-5, seed=0, device=device, dtype=dtype)
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.rand(*shape, generator=g).to(device)

    params = {p.untyped_storage().data_ptr() for p in state.nets.parameters()}
    seen, where = set(), ["loss"]
    out = {name: {"saved": 0, "convs": 0, "input": 0} for name in (*NETS[step], "loss")}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in params and ptr not in seen:
            seen.add(ptr)
            out[where[0]]["saved"] += t.untyped_storage().nbytes()
        return t

    def conv_output(t):
        out[where[0]]["convs"] += t.untyped_storage().nbytes()

    def enter(name):
        def hook(module, args):
            where[0] = name
            out[name]["input"] += sum(a.numel() * a.element_size() for a in args)
        return hook

    for name, net in state.nets.items():
        net.register_forward_pre_hook(enter(name))
        net.register_forward_hook(lambda *_: where.__setitem__(0, "loss"))
    state.nets.train()
    if step == "joint":
        from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
        from singlehdr_tpu_torch.ops.curves import monotonic_rf

        ldr, clipped = rand(batch, 3, size, size), rand(batch, 3, size, size)
        args = (Vgg16Features().to(device), ldr, (ldr + 0.02 * rand(batch, 3, size, size)).clamp(0, 1),
                clipped, clipped * (1 + rand(batch, 1, 1, 1)), torch.ones(batch, 1, 1, 1, device=device),
                monotonic_rf(rand(batch, 1024)))
        loss_fn = steps.joint_loss
    else:
        args = (torch.round(rand(batch, 3, size, size) * 255) / 255, rand(batch, 3, size, size) * 2)
        loss_fn = steps.finetune_loss
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), _ConvOutputs(conv_output):
        loss_fn(dict(state.nets.items()), *args)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--step", choices=tuple(NETS), default="joint")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    p.add_argument("--device", default="cpu")
    p.add_argument("--probe", type=int, default=64, help="side of the two runs")
    args = p.parse_args(argv)
    one, two = (kept_bytes(args.step, b, args.probe, DTYPES[args.dtype], torch.device(args.device))
                for b in (1, 2))
    scale = args.batch * (args.size / args.probe) ** 2
    out = {name: {k: (2 * one[name][k] - two[name][k]) + (two[name][k] - one[name][k]) * scale
                  for k in one[name]} for name in one}
    mib = 2.0 ** 20
    print(f"{args.step} step, b{args.batch} @ {args.size}^2, {args.dtype} (from b1 and b2 @ "
          f"{args.probe}^2 on {args.device}): MiB kept for the backward")
    for name, r in out.items():
        print(f"  {name:5s} saved {r['saved'] / mib:10.1f}  conv/matmul outputs {r['convs'] / mib:10.1f}"
              f"  input {r['input'] / mib:8.1f}")
    nets = [n for n in out if n != "loss"]
    loss = out["loss"]["saved"]
    plain = sum(r["saved"] for r in out.values())
    inputs = sum(out[n]["input"] for n in nets)
    convs = sum(out[n]["convs"] for n in nets)
    biggest = max(out[n]["saved"] for n in nets)
    print(f"  kept through the forward: plain {plain / mib:.1f}; remat=True {(inputs + loss) / mib:.1f} "
          f"(+ the largest net's recompute, {biggest / mib:.1f}); remat='convs' "
          f"{(inputs + convs + loss) / mib:.1f}")


if __name__ == "__main__":
    main()
