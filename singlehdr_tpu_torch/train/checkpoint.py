"""Checkpoint and resume of a ``TrainState`` (counterpart of
``singlehdr_tpu.train.checkpoint``, which keeps Orbax directories; the two
formats do not interchange).

One directory per training unit (deq / lin / hal / ref / jnt) holds up to
``max_to_keep`` step-numbered files ``step_00000123.pt``, each written by
``torch.save`` to a temporary name and renamed into place, so a reader never
sees half a file.  A file holds ``{step, nets: {name: state_dict},
optimizer: state_dict}``.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Mapping, Optional

import torch
import torch.nn as nn

from singlehdr_tpu_torch.train.state import TrainState, make_optimizer

MAX_TO_KEEP = 5
_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Save / auto-restore one ``TrainState`` under a directory.  Saves are
    synchronous, so ``wait`` and ``close`` do nothing; ``run_synth_training``
    calls them at shutdown in the order the JAX loop calls Orbax's, whose
    saves are asynchronous."""

    def __init__(self, directory: str, max_to_keep: int = MAX_TO_KEEP):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def save(self, state: TrainState) -> None:
        payload = {
            "step": state.step,
            "nets": {name: net.state_dict() for name, net in state.nets.items()},
            "optimizer": state.optimizer.state_dict(),
        }
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=self.directory)
        os.close(fd)
        try:
            torch.save(payload, tmp)
            os.replace(tmp, self.path(state.step))
        except BaseException:
            os.unlink(tmp)
            raise
        for step in self.steps()[:-self.max_to_keep]:
            os.unlink(self.path(step))

    def load(self, step: int, device=None) -> dict:
        return torch.load(self.path(step), map_location=device, weights_only=True)

    def restore(self, state: TrainState) -> TrainState:
        """Load the latest checkpoint into ``state`` in place (unchanged if
        there is none), as the reference restores when a checkpoint exists."""
        step = self.latest_step
        if step is None:
            return state
        saved = self.load(step, state.device)
        if set(saved["nets"]) != set(state.nets):
            raise ValueError(f"checkpoint {self.path(step)} holds nets {sorted(saved['nets'])}, "
                             f"the state {sorted(state.nets)}")
        for name, net in state.nets.items():
            net.load_state_dict(saved["nets"][name], strict=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        return state

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass


def load_pretrained_nets(nets: Mapping[str, nn.Module], directories: Mapping[str, str]) -> None:
    """Load each net of ``nets`` in place from the latest checkpoint of its own
    directory, onto the net's device.  A directory may hold a one-net
    checkpoint or a multi-net one (a joint or finetune state) that contains
    the net by name; the saved keys and shapes must be the net's.  Empty or
    missing directories are skipped, leaving the net as it was."""
    for name, directory in directories.items():
        if name not in nets:
            raise KeyError(f"no subnet {name!r} among {sorted(nets)}")
        if not os.path.isdir(directory):
            continue
        mgr = CheckpointManager(directory)
        step = mgr.latest_step
        if step is None:
            continue
        net = nets[name]
        saved = mgr.load(step, next(net.parameters()).device)["nets"]
        if name not in saved:
            raise ValueError(f"checkpoint {mgr.path(step)} holds nets {sorted(saved)}, not {name!r}")
        want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in saved[name].items()}
        if want != got:
            raise ValueError(f"checkpoint {mgr.path(step)} does not match subnet {name!r}")
        net.load_state_dict(saved[name], strict=True)


def restore_pretrained_subnets(state: TrainState, directories: Mapping[str, str]) -> TrainState:
    """``load_pretrained_nets`` into the state's nets, then a fresh combined
    Adam over all the nets (the joint and finetune drivers restore per-net
    pretraining and train with a new optimizer)."""
    load_pretrained_nets(state.nets, directories)
    state.optimizer = make_optimizer(state.nets.parameters(), state.learning_rate)
    return state
