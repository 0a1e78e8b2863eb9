"""The port's training loop, checkpoints, metrics and CLIs on the CPU.

Checkpoints round-trip bit-exactly into a differently seeded state, keep
``max_to_keep`` files, and seed a joint state from one-net and multi-net
checkpoints; the joint and per-net CLIs train a few steps on synthetic
``.hdr`` files and resume; a deq run of 200 steps actually learns (the
port's counterpart of ``tests/test_train_smoke.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

from singlehdr_tpu.data.hdr_io import write_hdr
from singlehdr_tpu_torch.cli import cli_device, joint_train, train
from singlehdr_tpu_torch.ops import cuda as kernels
from singlehdr_tpu_torch.train import steps
from singlehdr_tpu_torch.train.checkpoint import CheckpointManager, restore_pretrained_subnets
from singlehdr_tpu_torch.train.metrics import Mean, MetricsWriter
from singlehdr_tpu_torch.train.state import init_multi_state, init_net_state


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    """A few .hdr files for HDR-Synth-style training (tests/test_cli.py's pattern)."""
    root = str(tmp_path_factory.mktemp("synth"))
    rng = np.random.RandomState(0)
    for i in range(4):
        img = (rng.rand(64, 64, 3).astype(np.float32) * 4) ** 2
        write_hdr(os.path.join(root, f"s{i:02d}.hdr"), np.kron(img, np.ones((8, 8, 1), np.float32)))
    return root


def _deq_batch(seed, b=2, hw=32):
    rs = np.random.RandomState(seed)
    ldr = torch.from_numpy(rs.rand(b, 3, hw, hw).astype(np.float32))
    return ldr, (ldr + 0.05 * torch.from_numpy(rs.randn(b, 3, hw, hw).astype(np.float32))).clamp(0, 1), \
        torch.ones(b, 1, 1, 1)


def _trained_state(names, seed, steps_taken=1):
    state = init_multi_state(names, 1e-4, seed=seed, device="cpu")
    if "deq" in names:
        step = steps.make_deq_train_step()
        for i in range(steps_taken):
            step(state, *_deq_batch(i))
    return state


def _assert_same_state(a, b):
    assert a.step == b.step
    sa, sb = a.nets.state_dict(), b.nets.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert set(oa["state"]) == set(ob["state"])
    for i, s in oa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    state = _trained_state(("deq",), seed=0, steps_taken=2)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step is None
    assert mgr.restore(init_net_state("deq", 1e-4, seed=5, device="cpu")).step == 0  # nothing to restore
    mgr.save(state)
    fresh = init_net_state("deq", 1e-4, seed=7, device="cpu")
    assert not torch.equal(fresh.nets["deq"].unet.stem1.weight, state.nets["deq"].unet.stem1.weight)
    restored = mgr.restore(fresh)
    _assert_same_state(restored, state)
    # training continues identically from the restored state
    batch = _deq_batch(9)
    loss_a, _ = steps.make_deq_train_step()(state, *batch)
    loss_b, _ = steps.make_deq_train_step()(restored, *batch)
    assert torch.equal(loss_a, loss_b)
    _assert_same_state(restored, state)


def test_checkpoint_keeps_max_to_keep(tmp_path):
    state = init_net_state("deq", 1e-4, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    for step in range(1, 8):
        state.step = step
        mgr.save(state)
    assert mgr.steps() == [5, 6, 7] and mgr.latest_step == 7
    assert sorted(os.listdir(mgr.directory)) == [f"step_{s:08d}.pt" for s in (5, 6, 7)]
    with pytest.raises(ValueError, match="holds nets"):
        mgr.restore(init_multi_state(("deq", "lin"), 1e-4, device="cpu"))


def test_restore_pretrained_subnets_from_solo_and_multi_checkpoints(tmp_path):
    solo = _trained_state(("deq",), seed=1)
    multi = _trained_state(("deq", "lin", "hal"), seed=2)
    CheckpointManager(str(tmp_path / "deq")).save(solo)
    CheckpointManager(str(tmp_path / "jnt")).save(multi)
    state = init_multi_state(("deq", "lin", "hal"), 3e-5, seed=3, device="cpu")
    state = restore_pretrained_subnets(state, {
        "deq": str(tmp_path / "deq"),         # one-net checkpoint
        "lin": str(tmp_path / "jnt"),         # multi-net checkpoint holding lin
        "hal": str(tmp_path / "missing"),     # nothing there: keeps its init
    })
    for name, source in (("deq", solo), ("lin", multi)):
        want = source.nets[name].state_dict()
        for k, v in state.nets[name].state_dict().items():
            assert torch.equal(v, want[k]), (name, k)
    hal_init = init_multi_state(("deq", "lin", "hal"), 3e-5, seed=3, device="cpu").nets["hal"].state_dict()
    for k, v in state.nets["hal"].state_dict().items():
        assert torch.equal(v, hal_init[k])
    # a fresh combined Adam over all three nets, at the state's learning rate
    assert not state.optimizer.state and state.learning_rate == 3e-5
    assert len(state.optimizer.param_groups[0]["params"]) == len(list(state.nets.parameters()))
    with pytest.raises(ValueError, match="holds nets"):
        restore_pretrained_subnets(init_multi_state(("hal",), 1e-5, device="cpu"), {"hal": str(tmp_path / "deq")})
    with pytest.raises(KeyError):
        restore_pretrained_subnets(init_multi_state(("hal",), 1e-5, device="cpu"), {"ref": str(tmp_path / "deq")})


def test_metrics_mean_and_writer(tmp_path):
    m = Mean()
    m.update(1.0)
    m.update(np.asarray([2.0, 3.0]))
    assert m.result() == pytest.approx(2.0)
    m.reset()
    assert m.result() == 0.0
    w = MetricsWriter(str(tmp_path / "tb"))
    w.scalar("loss", torch.tensor(0.5), 3)
    w.image("img", torch.rand(2, 3, 8, 8), 3)
    w.close()
    lines = (tmp_path / "tb" / "events.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["loss"] == 0.5 and json.loads(lines[0])["step"] == 3


@pytest.mark.parametrize("factory", [init_multi_state, init_net_state])
def test_state_constructors_default_to_the_card(factory, monkeypatch):
    """The port's entry points run on the card unless the CPU is asked for."""
    import inspect

    assert inspect.signature(factory).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((AssertionError, RuntimeError)):
        factory(("deq",) if factory is init_multi_state else "deq", 1e-4)


def test_training_device_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    assert cli_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_device("cuda")


def _run_joint(synth_dir, tmp_path, iterations):
    args = joint_train.build_parser().parse_args([
        "--dir", synth_dir, "--device", "cpu",
        "--deq_ckpt", str(tmp_path / "ck_deq"), "--lin_ckpt", str(tmp_path / "ck_lin"),
        "--hal_ckpt", str(tmp_path / "ck_hal"), "--jnt_ckpt", str(tmp_path / "ck_jnt"),
        "--batch_size", "2", "--patch_size", "64", "--iterations", str(iterations),
        "--workers", "2", "--ckpt_every", "2", "--log_every", "1",
    ])
    return joint_train.run(args)


def test_joint_train_cli_trains_and_resumes(synth_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    kernels.reset_launches()
    state = _run_joint(synth_dir, tmp_path, 2)
    assert state.step == 2
    mgr = CheckpointManager(str(tmp_path / "ck_jnt"))
    assert mgr.steps() == [1, 2]
    state = _run_joint(synth_dir, tmp_path, 3)
    assert state.step == 3 and mgr.steps() == [1, 2, 3]
    out = capsys.readouterr().out
    losses = [float(line.split("loss")[1].split()[0]) for line in out.splitlines()
              if line.startswith("[jnt] step")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "[jnt] step 3 " in out  # the second run resumed at step 2
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}  # CPU tensors
    assert os.path.isdir(tmp_path / "tensorboard" / "jnt")


def test_joint_train_cli_remat_reaches_the_step_factory(synth_dir, tmp_path, monkeypatch):
    made = []

    def factory(vgg, dtype, remat=False):
        made.append(remat)
        return steps.make_joint_train_step(vgg, dtype, remat=remat)

    monkeypatch.setattr(joint_train, "make_joint_train_step", factory)
    monkeypatch.chdir(tmp_path)
    state = joint_train.run(joint_train.build_parser().parse_args([
        "--dir", synth_dir, "--device", "cpu", "--remat",
        "--deq_ckpt", str(tmp_path / "ck_deq"), "--lin_ckpt", str(tmp_path / "ck_lin"),
        "--hal_ckpt", str(tmp_path / "ck_hal"), "--jnt_ckpt", str(tmp_path / "ck_jnt"),
        "--batch_size", "2", "--patch_size", "64", "--iterations", "1", "--workers", "2"]))
    assert made == [True] and state.step == 1
    assert CheckpointManager(str(tmp_path / "ck_jnt")).steps() == [1]


def test_train_cli_per_net_steps(synth_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = train.build_parser().parse_args([
        "--hdrdir", synth_dir, "--device", "cpu", "--deq", "true", "--lin", "true",
        "--deq_ckpt", str(tmp_path / "ck_deq"), "--lin_ckpt", str(tmp_path / "ck_lin"),
        "--batch_size", "2", "--patch_size", "64", "--iterations", "1", "--workers", "2",
        "--jpeg", "false",
    ])
    train.run(args)
    for name in ("deq", "lin"):
        assert CheckpointManager(str(tmp_path / f"ck_{name}")).steps() == [1]


def _smooth_images(rng, n, hw=32):
    """Random low-frequency images in [0, 1] (sums of 2-D cosines)."""
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    imgs = np.zeros((n, 3, hw, hw), np.float32)
    for i in range(n):
        img = np.zeros((3, hw, hw), np.float32)
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 3, 2)
            amp = rng.uniform(0.1, 0.5, 3) * np.cos(rng.uniform(0, 2 * np.pi, 3))
            img += amp[:, None, None] * np.cos(2 * np.pi * (fx * xx + fy * yy))[None]
        imgs[i] = (img - img.min()) / (img.max() - img.min() + 1e-6)
    return imgs


def test_deq_trainability():
    """200 Adam(1e-3) deq steps on 6-level-quantised smooth images
    (tests/test_train_smoke.py's task): the trained loss falls below a
    quarter of the first step's and clearly below the identity's (the
    quantisation error itself), i.e. the net learned to dequantise."""
    rng = np.random.RandomState(7)
    clean = _smooth_images(rng, 64)
    quant = np.round(clean * 5) / 5
    identity = 8 * float(np.mean((clean - quant) ** 2))  # per-step loss of returning the input
    state = init_net_state("deq", 1e-3, seed=0, device="cpu")
    step = steps.make_deq_train_step()
    mask = torch.ones(8, 1, 1, 1)
    losses = []
    for _ in range(200):
        idx = rng.randint(0, len(clean), 8)
        loss, _ = step(state, torch.from_numpy(clean[idx]), torch.from_numpy(quant[idx]), mask)
        losses.append(float(loss))
    trained = float(np.mean(losses[-10:]))
    assert np.isfinite(losses).all()
    # measured: first 0.072, identity 0.027, trained 0.015
    assert trained < 0.25 * losses[0], (losses[0], trained)
    assert trained < 0.75 * identity, (identity, trained)
