"""Each cell, shrunk and on the CPU, run through the harness with the timed
path sound and then broken underneath: the sound run is correct, each
fault the cell can have makes ``correct`` false.  (The joint cell runs its
program in float32 here: at 64^2 and batch 2 the bf16 step's rounding is
not what the cell's limits were set from.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hdrbench.tests.tiny import run_tiny

F32 = {"compute_dtype": "float32"}


def _half_left_out(forward):
    """The predictor's forward with the second half of the batch left out:
    its outputs repeat the first half's."""
    def broken(self, batch):
        out = forward(self, batch[: max(1, len(batch) // 2)])
        return np.concatenate([out, out])[: len(batch)]
    return broken


def _altered(forward):
    """One output value altered where it is produced."""
    def broken(self, batch):
        out = forward(self, batch).copy()
        out[..., 0] *= 1.01
        return out
    return broken


@pytest.mark.parametrize("workload", ["batch-f32-512", "serve-f32-mixed"])
def test_forward_cells_sound_and_faulted(workload, monkeypatch):
    from singlehdr_tpu_torch.inference import HdrPredictor

    code, line, _ = run_tiny(workload)
    assert code == 0 and line["correct"], line["checks"]
    forward = HdrPredictor._forward
    for fault in (_half_left_out, _altered):
        monkeypatch.setattr(HdrPredictor, "_forward", fault(forward))
        code, line, _ = run_tiny(workload)
        assert code == 0 and not line["correct"], (fault.__name__, line["checks"])
        monkeypatch.setattr(HdrPredictor, "_forward", forward)


def test_joint_cell_sound_and_faulted(monkeypatch):
    import singlehdr_tpu_torch.train.steps as steps

    code, line, _ = run_tiny("joint-bf16-256", config=F32)
    assert code == 0 and line["correct"], line["checks"]

    def unchanged(state, loss):  # the step leaves its state as it was
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.step += 1

    monkeypatch.setattr(steps, "apply_gradients", unchanged)
    code, line, _ = run_tiny("joint-bf16-256", config=F32)
    assert code == 0 and not line["correct"], line["checks"]
    monkeypatch.undo()

    joint = steps.joint_loss

    def half_batch(nets, vgg, *batch, mesh=None):  # the mean over the first half, times b
        b = batch[0].shape[0]
        total, aux = joint(nets, vgg, *(x[: b // 2] for x in batch), mesh=mesh)
        return total * (b / (b // 2)), aux

    monkeypatch.setattr(steps, "joint_loss", half_batch)
    code, line, _ = run_tiny("joint-bf16-256", config=F32)
    assert code == 0 and not line["correct"], line["checks"]


def test_controls_run_at_a_tiny_size():
    """The control script's three readings run end to end; the float8
    joint step fails one of the joint cell's limits."""
    from hdrbench.control import control
    from hdrbench.harness import BENCH_DIR, load_json
    from hdrbench.tests.tiny import TRAFFIC

    torch.set_num_threads(4)
    cpu = torch.device("cpu")
    small = {"height": 64, "width": 64, "check_images": 2}
    assert set(control("batch-f32-512", 3, cpu, small)) == {"hdr_rel_err"}
    small = {"sizes": [[64, 64]], "pool_per_size": 2, "check_per_size": 1}
    assert set(control("serve-f32-mixed", 3, cpu, small)) == {"rgbe_mismatch"}
    got = control("joint-bf16-256", 3, cpu, TRAFFIC["joint-bf16-256"])
    limits = load_json(BENCH_DIR, "traffic", "joint-b16-256.json")["limits"]
    for reading in got.values():
        assert any(v > limits[k] for k, v in reading.items() if k in limits), got
