"""The port's data-parallel training (``singlehdr_tpu_torch.parallel``) on
the CPU: two gloo processes hold each mesh step to one process on the
global batch, and to the JAX package's single-device step where
``tests/test_parallel.py`` holds JAX's mesh to it.

One pair of rank processes (``_RANKS``, a script written to a temporary
directory; its rendezvous is a ``file://`` there, so parallel test workers
never share a port) runs every two-rank case of the module and saves each
rank's results; the tests compare them.  Both ranks save, so every case
also checks that the ranks agree bit for bit.  Batches are NHWC numpy
arrays made from seeds, moved to NCHW on each side.

Bounds, each the one ``tests/test_parallel.py`` or ``tests/test_torch_train.py``
uses for the same comparison:

  * deq against JAX: loss rtol 1e-5, parameters atol 1e-6 (test_parallel.py);
  * joint against JAX: loss rtol 1e-4, parameters after one Adam(1e-5) step
    atol 5e-5 (test_parallel.py: Adam's first step is ~lr sign(g), so a
    gradient within sum-order noise of 0 may move a parameter by 2 lr);
  * the port's own meshless step: loss rtol 1e-5, BatchNorm statistics atol
    1e-5, and each net's gradients within a relative (Frobenius) distance of
    1e-4 for deq and hal and 1e-2 for lin.  The mesh sums BatchNorm
    statistics in another order, and lin's ~50 BatchNorm layers amplify f32
    sum order: at this case the meshless port's lin gradients sit 3.0e-3
    from JAX's and the mesh's 2.4e-3 from the meshless port's, where deq and
    hal sit below 3e-5 (measured).  An averaged gradient is 0.5 away; a
    rank-local TV term or BatchNorm also lands beyond the bound (each fails
    this file when put into the code);
  * bf16 against the meshless bf16 step: bf16 rounds lin's and hal's
    gradients far from f32 at any CPU size (tests/test_torch_bf16.py), and
    the mesh adds another sum order before those roundings, so each net's
    gradients are held as chip_smoke.py phase 10 holds the card's: no
    farther from the f32 step's than 1.5 x the meshless bf16 step's + 0.02,
    cosine >= its cosine - 0.2 and >= 0.5, deq within 0.03; the new
    BatchNorm statistics within 2^-7 of their max (two bf16 ulps: the two
    sum orders flip ulps of the bf16 activations that deeper layers carry);
  * the finetune loop against JAX's on a mesh: parameters atol 5e-5, each
    step's loss rtol 1e-4, the tail step's from the parameters the ranks
    held before it; the tail step's gradients against the meshless step on
    the padded batch, each net within a distance of 1e-2 (measured 4e-4 to
    1e-3, the f32 step's own error);
  * the finetune step in float64: every gradient within 1e-10 of its net's
    largest, the loss rtol 1e-12 (measured 2e-13 and below): the mesh's
    arithmetic, rounding apart.  With the tail padded otherwise or skipped,
    or BatchNorm rank-local, the finetune tests fail.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn as nn

from singlehdr_tpu import models as jm
from singlehdr_tpu.ops import curves as jcurves
from singlehdr_tpu.parallel import make_mesh as jax_make_mesh
from singlehdr_tpu.train import loop as jloop
from singlehdr_tpu.train import steps as jsteps
from singlehdr_tpu.train.metrics import MetricsWriter as JaxMetricsWriter
from singlehdr_tpu.train.state import NetState
from singlehdr_tpu.train.state import make_optimizer as jax_make_optimizer
from singlehdr_tpu_torch import cli as port_cli
from singlehdr_tpu_torch import models as tm
from singlehdr_tpu_torch.convert import (
    from_jax_variables,
    load_jax_variables,
    nest_variables,
    to_jax_variables,
)
from singlehdr_tpu_torch.data.loader import DeviceFeeder
from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
from singlehdr_tpu_torch.ops.losses import tv_loss
from singlehdr_tpu_torch.parallel import (
    DATA_AXIS,
    SPATIAL_AXIS,
    DataMesh,
    initialize_multihost,
    make_mesh,
    shard_batch,
)
from singlehdr_tpu_torch.parallel.mesh import parse_mesh
from singlehdr_tpu_torch.train import loop, steps
from singlehdr_tpu_torch.train.state import TrainState, make_optimizer

from test_torch_models import seeded_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240
NETS = {"deq": (jm.DequantizationNet, tm.DequantizationNet, 3),
        "lin": (jm.LinearizationNet, tm.LinearizationNet, 3),
        "hal": (jm.HallucinationNet, tm.HallucinationNet, 3),
        "ref": (jm.RefinementNet, tm.RefinementNet, 9)}
JOINT = ("deq", "lin", "hal")
JOINT_KEYS = ("ldr", "jpeg", "clipped_hdr_t", "hdr_t", "mask", "invcrf")
DEQ_LR, JOINT_LR, FINETUNE_LR = 1e-4, 1e-5, 1e-5
# per sample: rank 0 keeps samples 0-1, rank 1 samples 2-3; rank 0's second
# sample is masked out, so the ranks' masked sums differ
JOINT_MASK = (1.0, 0.0, 1.0, 1.0)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _port_args(batch, keys):
    return [_nchw(batch[k]) if batch[k].ndim == 4 and k != "mask" else torch.from_numpy(batch[k])
            for k in keys]


def _joint_batch(seed, b=4, hw=64):
    rs = np.random.RandomState(seed)
    ldr = rs.rand(b, hw, hw, 3).astype(np.float32)
    clipped = rs.rand(b, hw, hw, 3).astype(np.float32)
    return {
        "ldr": ldr,
        "jpeg": np.clip(ldr + 0.03 * rs.randn(b, hw, hw, 3).astype(np.float32), 0, 1),
        "clipped_hdr_t": clipped,
        "hdr_t": clipped * rs.uniform(1.0, 2.0, (b, 1, 1, 1)).astype(np.float32),
        "mask": np.asarray(JOINT_MASK, np.float32).reshape(b, 1, 1, 1),
        "invcrf": np.asarray(jcurves.monotonic_rf(jnp.asarray(rs.rand(b, 1024).astype(np.float32)))),
    }


def _deq_batch(seed, b=8, hw=32):
    rs = np.random.RandomState(seed)
    ldr = rs.rand(b, hw, hw, 3).astype(np.float32)
    return {"ldr": ldr, "jpeg": np.clip(ldr + 0.05 * rs.randn(b, hw, hw, 3).astype(np.float32), 0, 1),
            "mask": np.ones((b, 1, 1, 1), np.float32)}


def _variables(names, seed):
    per = {n: seeded_variables(NETS[n][0](), (2, 32, 32, NETS[n][2]), seed=seed + i)
           for i, n in enumerate(names)}
    return {"params": {n: v["params"] for n, v in per.items()},
            "batch_stats": {n: v.get("batch_stats", {}) for n, v in per.items()}}


def _port_nets(names, variables, dtype=torch.float32):
    return load_jax_variables(nn.ModuleDict({n: NETS[n][1](dtype) for n in names}), variables)


def _jax_state(variables, lr):
    tx = jax_make_optimizer(lr)
    params = jax.tree.map(jnp.asarray, variables["params"])
    return NetState(step=jnp.zeros((), jnp.int32), params=params,
                    batch_stats=jax.tree.map(jnp.asarray, variables.get("batch_stats", {})),
                    opt_state=tx.init(params), tx=tx)


# --- the two rank processes ---------------------------------------------------

_RANKS = r"""
import hashlib, json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

torch.set_num_threads(2)
from singlehdr_tpu_torch import models as tm
from singlehdr_tpu_torch.data.synth import get_train_dataset
from singlehdr_tpu_torch.models.layers import bind_mesh
from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
from singlehdr_tpu_torch.ops.losses import tv_loss
from singlehdr_tpu_torch.parallel import make_mesh, replicate, shard_batch
from singlehdr_tpu_torch.train import loop, steps
from singlehdr_tpu_torch.train.state import TrainState, init_net_state, make_optimizer

NETS = {"deq": tm.DequantizationNet, "lin": tm.LinearizationNet, "hal": tm.HallucinationNet,
        "ref": tm.RefinementNet}
rank, work = int(sys.argv[2]), sys.argv[3]
with open(os.path.join(work, "spec.json")) as f:
    spec = json.load(f)
dist.init_process_group("gloo", init_method=spec["init"], world_size=2, rank=rank)
mesh = make_mesh(2, device="cpu")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def state_from(case, dtype=torch.float32):
    nets = nn.ModuleDict({n: NETS[n](dtype) for n in case["nets"]})
    nets.load_state_dict(torch.load(os.path.join(work, case["snapshot"])))
    if dtype == torch.float64:  # every layer computes in float64, lin's f32 head too
        nets.double()
        for m in nets.modules():
            if getattr(m, "dtype", None) == torch.float32:
                m.dtype = torch.float64
    return TrainState(nets, make_optimizer(nets.parameters(), case["lr"]))


def digest(tensors):
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()


def save(case, payload):
    # rank 0's results whole (but for what the case keeps as digests only); of
    # the other rank's parameters, buffers and gradients only their digests
    # (the tests hold the ranks equal by them)
    for key in ("params", "buffers", "grads"):
        if key in payload:
            payload[f"{key}_digest"] = digest(payload[key])
            if rank or key in case.get("digests_only", ()):
                del payload[key]
    torch.save(payload, os.path.join(work, f"{case['name']}.rank{rank}.pt"))


def leaves(state):
    return {"params": {n: p.detach() for n, p in state.nets.named_parameters()},
            "buffers": dict(state.nets.named_buffers()), "step": state.step}


class Batches:
    def __init__(self, batches):
        self._batches = batches

    def epoch(self):
        yield from self._batches


vgg = Vgg16Features()
for case in spec["cases"]:
    kind = case["kind"]
    if kind == "step":
        dtype = getattr(torch, case["dtype"])
        state = replicate(mesh, state_from(case, dtype))
        b = np.load(os.path.join(work, case["batch"]))
        args = shard_batch(mesh, [nchw(b[k]) if b[k].ndim == 4 and k != "mask" else torch.from_numpy(b[k])
                                  for k in case["keys"]])
        if dtype == torch.float64:
            args = [a.double() for a in args]
        factory = {"deq": lambda: steps.make_deq_train_step(),
                   "joint": lambda: steps.make_joint_train_step(vgg, dtype, remat=case["remat"]),
                   "finetune": lambda: steps.make_finetune_train_step(dtype)}
        loss, aux = factory[case["step"]]()(state, *args)
        save(case, {"loss": loss, "aux": {k: aux[k] for k in steps.GLOBAL_MEANS if k in aux},
                    "grads": {n: p.grad for n, p in state.nets.named_parameters()}, **leaves(state)})
    elif kind == "lin":
        lin = tm.LinearizationNet()
        lin.load_state_dict(torch.load(os.path.join(work, case["snapshot"])))
        bind_mesh(lin, mesh)
        lin.train()
        b = np.load(os.path.join(work, case["batch"]))
        x, r = shard_batch(mesh, (nchw(b["x"]), torch.from_numpy(b["r"])))
        x.requires_grad_(True)
        y = lin(x)
        (y * r).sum().backward()
        save(case, {"y": y.detach(), "gx": x.grad, "buffers": dict(lin.named_buffers())})
    elif kind == "tv":
        b = np.load(os.path.join(work, case["batch"]))
        x, mask = shard_batch(mesh, (torch.from_numpy(b["x"]), torch.from_numpy(b["mask"])))
        x.requires_grad_(True)
        tv = tv_loss(x, mesh)
        (mask * tv).sum().backward()
        save(case, {"tv": tv.detach(), "gx": x.grad})
    elif kind == "finetune_loop":
        state = state_from(case)
        b = np.load(os.path.join(work, case["batch"]))
        batches = [(b[f"ldr{i}"], b[f"hdr{i}"]) for i in range(case["n_batches"])]
        step, seen = steps.make_finetune_train_step(), {"loss_ref": []}

        def recorded(st, ldr, hdr):
            # each step's logged loss; the last (tail) step's parameters before it and gradients
            if rank == 0:
                seen["tail_params"] = {n: p.detach().clone() for n, p in st.nets.named_parameters()}
            out = step(st, ldr, hdr)
            seen["loss_ref"].append(float(out.aux["loss_ref"]))
            seen["grads"] = {n: p.grad.clone() for n, p in st.nets.named_parameters()}
            return out

        out = loop.run_real_finetune(state=state, step_fn=recorded,
                                     pipeline=Batches(batches), epochs=1,
                                     ckpt_dir=os.path.join(work, f"ft_ckpt{rank}"),
                                     log_dir=os.path.join(work, f"ft_log{rank}"), mesh=mesh)
        save(case, {**leaves(out), **seen})
    elif kind == "synth_loop":
        cfg = loop.LoopConfig(batch_size=4, iterations=2, ckpt_every=1, log_every=1,
                              image_log_every=1, n_workers=1, seed=0, prefetch_producers=1)
        out = loop.run_synth_training(
            module_name="deq", state=init_net_state("deq", 1e-4, seed=0, device="cpu"),
            step_fn=steps.make_deq_train_step(),
            dataset=get_train_dataset(case["hdr_dir"], patch_size=32), cfg=cfg,
            ckpt_dir=os.path.join(work, f"synth_ckpt{rank}"),
            log_dir=os.path.join(work, f"synth_log{rank}"),
            batch_to_args=lambda bt: (bt["ldr"], bt["jpeg"], bt["mask"]), mesh=mesh)
        save(case, leaves(out))
dist.destroy_process_group()
print("RANK DONE", rank, flush=True)
"""


def _run_ranks(work, script, args_of_rank, env=None):
    """Start two rank processes and wait for both; a hung rendezvous or
    collective fails the test after RANK_TIMEOUT_S instead of hanging it."""
    path = os.path.join(work, "ranks.py")
    with open(path, "w") as f:
        f.write(script)
    env = dict(os.environ, **(env or {}))
    procs = [subprocess.Popen([sys.executable, path, *args_of_rank(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the rank processes timed out (a rendezvous or a collective never completed)")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in outs]


@pytest.fixture(scope="module")
def ranks():
    """Inputs of every two-rank case, the rank processes' results (rank 0's
    and rank 1's, by case), and the inputs again for the comparisons.  The
    snapshots and results (some hundreds of MB) are deleted with the
    module's last test."""
    with tempfile.TemporaryDirectory(prefix="mesh_") as work:
        yield _run_cases(work)


def _run_cases(work):
    import chip_smoke

    inputs = {"deq_vars": seeded_variables(jm.DequantizationNet(), (2, 32, 32, 3), seed=70),
              "joint_vars": _variables(JOINT, seed=71),
              "ft_vars": seeded_variables(jm.ReverseCameraPipeline(), (1, 32, 32, 3), seed=72),
              "lin_vars": _variables(("lin",), seed=73)}
    deq = nn.ModuleDict({"deq": tm.DequantizationNet()})
    load_jax_variables(deq["deq"], inputs["deq_vars"])
    torch.save(deq.state_dict(), os.path.join(work, "deq.pt"))
    for dtype in ("float32", "bfloat16"):
        torch.save(_port_nets(JOINT, inputs["joint_vars"], getattr(torch, dtype)).state_dict(),
                   os.path.join(work, f"joint_{dtype}.pt"))
    torch.save(_port_nets(tuple(NETS), inputs["ft_vars"]).state_dict(), os.path.join(work, "ft.pt"))
    torch.save(_port_nets(("lin",), inputs["lin_vars"])["lin"].state_dict(), os.path.join(work, "lin.pt"))

    inputs["deq"] = _deq_batch(74)
    inputs["joint"] = _joint_batch(75)
    rs = np.random.RandomState(76)
    inputs["lin"] = {"x": rs.rand(4, 48, 48, 3).astype(np.float32),
                     "r": rs.randn(4, 1024).astype(np.float32)}
    inputs["tv"] = {"x": rs.rand(4, 3, 16, 20).astype(np.float32),
                    "mask": np.asarray([1.0, 1.0, 0.0, 0.0], np.float32).reshape(4, 1, 1, 1)}
    # two finetune batches: a full one of 4 and a tail of 3, padded to 4 on the mesh
    inputs["ft"] = [(rs.rand(n, 32, 32, 3).astype(np.float32), rs.rand(n, 32, 32, 3).astype(np.float32))
                    for n in (4, 3)]
    for name in ("deq", "joint", "lin", "tv"):
        np.savez(os.path.join(work, f"{name}_batch.npz"), **inputs[name])
    np.savez(os.path.join(work, "ft64_batch.npz"), ldr=inputs["ft"][0][0], hdr=inputs["ft"][0][1])
    np.savez(os.path.join(work, "ft_batch.npz"),
             **{f"{k}{i}": a for i, pair in enumerate(inputs["ft"]) for k, a in zip(("ldr", "hdr"), pair)})
    hdr_dir = os.path.join(work, "hdr")
    os.makedirs(hdr_dir)
    chip_smoke.write_hdr_files(hdr_dir, 2)

    joint = {"kind": "step", "step": "joint", "nets": list(JOINT), "keys": list(JOINT_KEYS),
             "batch": "joint_batch.npz", "lr": JOINT_LR}
    cases = [
        {"kind": "step", "name": "deq", "step": "deq", "nets": ["deq"], "keys": ["ldr", "jpeg", "mask"],
         "snapshot": "deq.pt", "batch": "deq_batch.npz", "lr": DEQ_LR, "dtype": "float32"},
        {**joint, "name": "joint", "snapshot": "joint_float32.pt", "dtype": "float32", "remat": False},
        {**joint, "name": "joint_remat", "snapshot": "joint_float32.pt", "dtype": "float32",
         "remat": True},
        {**joint, "name": "joint_bf16", "snapshot": "joint_bfloat16.pt", "dtype": "bfloat16",
         "remat": False},
        {"kind": "lin", "name": "lin", "snapshot": "lin.pt", "batch": "lin_batch.npz"},
        {"kind": "tv", "name": "tv", "batch": "tv_batch.npz"},
        {"kind": "step", "name": "finetune_f64", "step": "finetune", "nets": list(NETS),
         "keys": ["ldr", "hdr"], "snapshot": "ft.pt", "batch": "ft64_batch.npz", "lr": FINETUNE_LR,
         "dtype": "float64", "digests_only": ["params", "buffers"]},
        {"kind": "finetune_loop", "name": "finetune_loop", "nets": list(NETS), "snapshot": "ft.pt",
         "batch": "ft_batch.npz", "n_batches": 2, "lr": FINETUNE_LR},
        {"kind": "synth_loop", "name": "synth_loop", "hdr_dir": hdr_dir},
    ]
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump({"init": f"file://{work}/rdzv", "cases": cases}, f)
    outs = _run_ranks(work, _RANKS, lambda r: [ROOT, str(r), work])
    assert all(f"RANK DONE {r}" in out for r, out in enumerate(outs))
    results = {c["name"]: [torch.load(os.path.join(work, f"{c['name']}.rank{r}.pt")) for r in (0, 1)]
               for c in cases}
    # the loops' directories, for the tests that look at what each rank wrote
    written = {d: sorted(os.listdir(os.path.join(work, d))) if os.path.isdir(os.path.join(work, d)) else None
               for d in ("ft_ckpt0", "ft_ckpt1", "ft_log1", "synth_ckpt0", "synth_ckpt1", "synth_log1")}
    written["synth_log0_events"] = os.path.exists(os.path.join(work, "synth_log0", "events.jsonl"))
    return {"written": written, "inputs": inputs, "results": results}


def _assert_ranks_agree(pair):
    """Both ranks hold the same parameters and buffers after the step (by
    the digests the rank processes take)."""
    for key in ("params_digest", "buffers_digest"):
        if key in pair[0]:
            assert pair[0][key] == pair[1][key], key


def _net_distance(d, ref, net):
    """(|d - ref| / |ref|, cos(d, ref)) over one net's gradient tensors."""
    keys = [k for k in ref if k.startswith(net + ".")]
    norm = sum(float((ref[k].double() ** 2).sum()) for k in keys) ** 0.5
    own = sum(float((d[k].double() ** 2).sum()) for k in keys) ** 0.5
    dist_ = sum(float(((d[k].double() - ref[k].double()) ** 2).sum()) for k in keys) ** 0.5 / norm
    dot = sum(float((d[k].double() * ref[k].double()).sum()) for k in keys)
    return dist_, dot / (own * norm)


# each net's gradients, the mesh step against the meshless one (module docstring)
MESH_GRAD_DISTANCE = {"deq": 1e-4, "lin": 1e-2, "hal": 1e-4}


def _meshless_joint(variables, batch, dtype=torch.float32, remat=False):
    nets = _port_nets(JOINT, variables, dtype)
    state = TrainState(nets, make_optimizer(nets.parameters(), JOINT_LR))
    loss, aux = steps.make_joint_train_step(Vgg16Features(), dtype, remat=remat)(
        state, *_port_args(batch, JOINT_KEYS))
    return {"loss": loss, "aux": aux, "grads": {n: p.grad for n, p in nets.named_parameters()},
            "buffers": dict(nets.named_buffers())}


# --- mesh shapes, shard_batch, initialize_multihost -------------------------


def test_mesh_axes_and_their_errors(tmp_path):
    assert (DATA_AXIS, SPATIAL_AXIS) == ("data", "spatial")
    assert parse_mesh("") is None and parse_mesh("4") == (4, 1) and parse_mesh("2,3") == (2, 3)
    with pytest.raises(ValueError, match="D,S"):
        parse_mesh("2,2,2")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2, spatial=2, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, device="cpu")
        assert (mesh.rank, mesh.world, mesh.device) == (0, 1, torch.device("cpu"))
        assert (mesh.spatial, mesh.spatial_group, mesh.data, mesh.band) == (1, None, 1, 0)
        with pytest.raises(ValueError, match="needs 3 processes"):
            make_mesh(3, device="cpu")
        # D x S must be the group's size: a spatial axis of 2 over one process
        with pytest.raises(ValueError, match="a mesh of 2 x 2 needs 4 processes"):
            make_mesh(2, spatial=2, device="cpu")
        with pytest.raises(ValueError, match="a mesh of 1 x 2 needs 2 processes"):
            make_mesh(1, spatial=2, device="cpu")
        with pytest.raises(ValueError, match="device"):
            make_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_batch_keeps_this_ranks_rows(rank, rng):
    mesh = DataMesh(None, rank, 2, torch.device("cpu"))
    batch = {"img": rng.rand(4, 16, 16, 3).astype(np.float32),
             "crf": torch.from_numpy(rng.rand(4, 1024).astype(np.float32)),
             "t": np.float32(1.5)}
    out = shard_batch(mesh, batch)
    rows = slice(2 * rank, 2 * rank + 2)
    assert isinstance(out["img"], torch.Tensor) and out["img"].shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(out["img"].numpy(), batch["img"][rows])
    assert torch.equal(out["crf"], batch["crf"][rows])
    assert out["t"].dim() == 0 and float(out["t"]) == 1.5
    a, b = shard_batch(mesh, (np.arange(6.0), [np.arange(4.0)]))
    assert a.tolist() == [3 * rank, 3 * rank + 1, 3 * rank + 2] and b[0].tolist() == [2 * rank, 2 * rank + 1]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, np.zeros((3, 2)))


_MULTIHOST = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from singlehdr_tpu_torch.parallel import global_sum, initialize_multihost, make_mesh

pid = int(sys.argv[3])
device = initialize_multihost(sys.argv[2], 2, pid, "cpu")
assert device == torch.device("cpu") and dist.get_backend() == "gloo", dist.get_backend()
mesh = make_mesh(2, device=device)
x = torch.tensor(float(pid + 1), requires_grad=True)
y = global_sum(x, mesh)
(y * (pid + 1)).backward()
print("SUM", float(y), "GRAD", float(x.grad), flush=True)
dist.destroy_process_group()
"""


def test_initialize_multihost_two_process_global_sum(tmp_path):
    """Two processes join through ``initialize_multihost`` at a coordinator
    address; ``global_sum`` gives 1 + 2 = 3 on both, and its backward sums
    the ranks' incoming gradients (1 + 2).  One process without a mesh is
    JAX's no-op branch."""
    assert initialize_multihost(num_processes=1) is None and not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = _run_ranks(str(tmp_path), _MULTIHOST, lambda r: [ROOT, f"127.0.0.1:{port}", str(r)])
    assert all("SUM 3.0 GRAD 3.0" in out for out in outs), outs


def test_initialize_multihost_checks_its_arguments():
    with pytest.raises(ValueError, match="coordinator"):
        initialize_multihost(None, 2, 0, "cpu")
    with pytest.raises(ValueError, match="process_id"):
        initialize_multihost("127.0.0.1:1", 2, 2, "cpu")
    assert not dist.is_initialized()


# --- steps on two ranks --------------------------------------------------------


def test_deq_step_on_two_ranks_matches_jax_single_device(ranks):
    """test_parallel.py's data-parallel case: one deq step on the global
    batch of 8 (4 a rank) against JAX's single-device ``deq_train_step``."""
    pair = ranks["results"]["deq"]
    _assert_ranks_agree(pair)
    batch = ranks["inputs"]["deq"]
    jstate, jloss, _ = jsteps.deq_train_step(_jax_state(ranks["inputs"]["deq_vars"], DEQ_LR),
                                            *[jnp.asarray(batch[k]) for k in ("ldr", "jpeg", "mask")])
    np.testing.assert_allclose(float(pair[0]["loss"]), float(jloss), rtol=1e-5)
    want = from_jax_variables({"params": jax.device_get(jstate.params)})
    assert {f"deq.{k}" for k in want} == set(pair[0]["params"])
    for key, value in want.items():
        np.testing.assert_allclose(pair[0]["params"][f"deq.{key}"].numpy(), value.numpy(), atol=1e-6,
                                   err_msg=key)


def test_joint_step_on_two_ranks_matches_jax_single_device(ranks):
    """test_parallel.py's joint case at 4 x 64^2 (2 a rank), with a mask
    that zeroes one of rank 0's samples: a local TV term, local BatchNorm
    statistics or an averaged gradient would each move the result."""
    pair = ranks["results"]["joint"]
    _assert_ranks_agree(pair)
    batch = ranks["inputs"]["joint"]
    jstate, jloss, jaux = jsteps.make_joint_train_step(jm.Vgg16Features())(
        _jax_state(ranks["inputs"]["joint_vars"], JOINT_LR), *[jnp.asarray(batch[k]) for k in JOINT_KEYS])
    np.testing.assert_allclose(float(pair[0]["loss"]), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(pair[0]["aux"]["crf_mse"]), float(jaux["crf_mse"]), rtol=1e-4)
    want = from_jax_variables({"params": jax.device_get(jstate.params)})
    assert set(want) == set(pair[0]["params"])
    for key, value in want.items():
        np.testing.assert_allclose(pair[0]["params"][key].numpy(), value.numpy(), atol=5e-5,
                                   err_msg=key)
    stats = from_jax_variables({"batch_stats": jax.device_get(jstate.batch_stats)})
    for key, value in stats.items():
        np.testing.assert_allclose(pair[0]["buffers"][key].numpy(), value.numpy(), atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("case", ["joint", "joint_remat"])
def test_joint_step_on_two_ranks_equals_the_meshless_step(case, ranks):
    """The two-rank step, plain and under ``remat=True`` (whose recompute
    calls the BatchNorm all-reduces again in the backward, in the same
    order on both ranks: the case finishing shows no deadlock), against the
    port's meshless step on the global batch."""
    pair = ranks["results"][case]
    _assert_ranks_agree(pair)
    want = _meshless_joint(ranks["inputs"]["joint_vars"], ranks["inputs"]["joint"])
    np.testing.assert_allclose(float(pair[0]["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(pair[0]["aux"]["crf_mse"]), float(want["aux"]["crf_mse"]),
                               rtol=1e-5)
    assert set(pair[0]["grads"]) == set(want["grads"])
    for net, bound in MESH_GRAD_DISTANCE.items():
        distance, _ = _net_distance(pair[0]["grads"], want["grads"], net)
        assert distance <= bound, (net, distance)
    for key, value in want["buffers"].items():
        np.testing.assert_allclose(pair[0]["buffers"][key].numpy(), value.numpy(), atol=1e-5,
                                   err_msg=key)


def test_remat_on_two_ranks_equals_the_plain_mesh_step(ranks):
    """Under remat the mesh step recomputes each net's forward, collectives
    and all, and leaves every gradient and statistic bit-equal."""
    plain, remat = ranks["results"]["joint"][0], ranks["results"]["joint_remat"][0]
    assert torch.equal(plain["loss"], remat["loss"])
    for key in ("grads", "buffers"):
        for name, value in plain[key].items():
            assert torch.equal(remat[key][name], value), name


def test_bf16_joint_step_on_two_ranks_is_held_as_the_meshless_bf16_step(ranks):
    pair = ranks["results"]["joint_bf16"]
    _assert_ranks_agree(pair)
    variables, batch = ranks["inputs"]["joint_vars"], ranks["inputs"]["joint"]
    f32 = _meshless_joint(variables, batch)
    bf16 = _meshless_joint(variables, batch, torch.bfloat16)
    np.testing.assert_allclose(float(pair[0]["loss"]), float(bf16["loss"]), rtol=1e-3)
    for key, value in bf16["buffers"].items():
        if key.endswith(("running_mean", "running_var")):
            err = float((pair[0]["buffers"][key] - value).abs().max())
            assert err <= 2.0 ** -7 * float(value.abs().max()), (key, err)
    for net in JOINT:
        dist_, cos = _net_distance(pair[0]["grads"], f32["grads"], net)
        own_dist, own_cos = _net_distance(bf16["grads"], f32["grads"], net)
        if net == "deq":
            assert dist_ <= 0.03, (net, dist_)
        else:
            assert dist_ <= 1.5 * own_dist + 0.02, (net, dist_, own_dist)
            assert cos >= max(0.5, own_cos - 0.2), (net, cos, own_cos)


def test_lin_in_train_mode_on_two_ranks_equals_one_process(ranks):
    """lin's BatchNorm layers on a mesh: each rank's curves, its input
    gradient and the running statistics equal one process's on the global
    batch.  Bounds: the curves are in [0, 1] and the BatchNorm statistics
    are summed in another order, 1e-5; the input gradient 1e-4 of its max."""
    pair = ranks["results"]["lin"]
    _assert_ranks_agree(pair)
    lin = _port_nets(("lin",), ranks["inputs"]["lin_vars"])["lin"].train()
    x = _nchw(ranks["inputs"]["lin"]["x"]).requires_grad_(True)
    y = lin(x)
    (y * torch.from_numpy(ranks["inputs"]["lin"]["r"])).sum().backward()
    gmax = float(x.grad.abs().max())
    for r, got in enumerate(pair):
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(got["y"].numpy(), y.detach()[rows].numpy(), atol=1e-5)
        np.testing.assert_allclose(got["gx"].numpy(), x.grad[rows].numpy(), atol=1e-4 * gmax)
    for key, value in lin.named_buffers():
        np.testing.assert_allclose(pair[0]["buffers"][key].numpy(), value.numpy(), atol=1e-5,
                                   err_msg=key)


def test_tv_loss_on_two_ranks_is_the_global_batchs(ranks):
    """TV over the global batch, with rank 1's samples masked out: its
    pixels still get the gradient of rank 0's masked TV terms."""
    pair = ranks["results"]["tv"]
    x = torch.from_numpy(ranks["inputs"]["tv"]["x"]).requires_grad_(True)
    mask = torch.from_numpy(ranks["inputs"]["tv"]["mask"])
    tv = tv_loss(x)
    (mask * tv).sum().backward()
    for r, got in enumerate(pair):
        np.testing.assert_allclose(float(got["tv"]), float(tv), rtol=1e-6)
        np.testing.assert_allclose(got["gx"].numpy(), x.grad[2 * r:2 * r + 2].numpy(), rtol=1e-6,
                                   atol=1e-9)
    assert float(pair[1]["gx"].abs().max()) > 0


# --- the loops on two ranks ----------------------------------------------------


class _FakeRealPipeline:
    def __init__(self, batches):
        self._batches = batches

    def epoch(self):
        yield from self._batches


def test_finetune_loop_on_two_ranks_matches_jax_mesh(ranks, tmp_path):
    """test_parallel.py's finetune-loop and tail cases in one: an epoch of a
    full batch of 4 and a tail of 3, which both loops pad to 4 by repeating
    its last sample and train, not skip, against JAX's
    ``run_real_finetune(mesh=make_mesh(2))``: the parameters after the
    epoch within atol 5e-5 (two Adam(1e-5) steps) and each step's logged
    loss (the padded global batch's) within rtol 1e-4, the tail step's from
    the parameters the ranks held before it.  From the loops' own second
    states the tail losses differ by more without a fault: Adam's first step
    moves each parameter by ~lr sign(g), so a gradient within rounding of 0
    moves it 2 lr apart, and JAX's own mesh and single-device loops read the
    tail loss 1.6e-4 apart here (measured)."""
    pair = ranks["results"]["finetune_loop"]
    _assert_ranks_agree(pair)
    assert pair[0]["step"] == pair[1]["step"] == 2
    jstep, jlosses = jsteps.make_finetune_train_step(), []

    def recorded(state, ldr, hdr):
        out = jstep(state, ldr, hdr)
        jlosses.append(float(out[2]["loss_ref"]))
        return out

    jstate = jloop.run_real_finetune(
        state=_jax_state(ranks["inputs"]["ft_vars"], FINETUNE_LR),
        step_fn=recorded, pipeline=_FakeRealPipeline(ranks["inputs"]["ft"]),
        epochs=1, ckpt_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "log"),
        writer=JaxMetricsWriter(str(tmp_path / "log"), use_tensorboard=False),
        mesh=jax_make_mesh(2))
    assert int(jstate.step) == 2
    assert pair[0]["loss_ref"] == pair[1]["loss_ref"] and len(jlosses) == 2
    np.testing.assert_allclose(pair[0]["loss_ref"][0], jlosses[0], rtol=1e-4)
    tail = nest_variables(to_jax_variables(pair[0]["tail_params"]))
    _, _, jaux = jstep(_jax_state({"params": tail["params"],
                                   "batch_stats": ranks["inputs"]["ft_vars"]["batch_stats"]}, FINETUNE_LR),
                       *(jnp.asarray(np.concatenate([a, a[-1:]])) for a in ranks["inputs"]["ft"][1]))
    np.testing.assert_allclose(pair[0]["loss_ref"][1], float(jaux["loss_ref"]), rtol=1e-4)
    want = from_jax_variables({"params": jax.device_get(jstate.params)})
    for key, value in want.items():
        np.testing.assert_allclose(pair[0]["params"][key].numpy(), value.numpy(), atol=5e-5,
                                   err_msg=key)


# each net's gradients, the two-rank finetune tail step against the meshless
# step on the padded batch from the same parameters.  Measured 4.1e-4 (deq),
# 5.3e-4 (lin), 1.0e-3 (hal), 6.6e-7 (ref): the f32 step's own error, since
# the meshless step sits 1.5e-4 to 4.7e-4 from a float64 step and the two
# ranks agree with one process to 1e-13 in float64 (the test below).
FINETUNE_GRAD_DISTANCE = 1e-2


def test_finetune_tail_step_on_two_ranks_is_the_padded_batchs_step(ranks):
    """The tail step of the two-rank epoch (3 samples, the last repeated to
    4, 2 a rank) against the port's meshless step on that padded batch from
    the parameters the ranks held before it: loss and each net's gradients.
    A tail dropped, padded otherwise or trained with rank-local BatchNorm
    statistics moves them."""
    pair = ranks["results"]["finetune_loop"]
    assert pair[0]["grads_digest"] == pair[1]["grads_digest"]
    nets = _port_nets(tuple(NETS), ranks["inputs"]["ft_vars"])
    missing, unexpected = nets.load_state_dict(pair[0]["tail_params"], strict=False)
    assert not unexpected and set(missing) <= {n for n, _ in nets.named_buffers()}
    state = TrainState(nets, make_optimizer(nets.parameters(), FINETUNE_LR))
    ldr, hdr = (np.concatenate([a, a[-1:]]) for a in ranks["inputs"]["ft"][1])
    _, aux = steps.make_finetune_train_step()(state, _nchw(ldr), _nchw(hdr))
    np.testing.assert_allclose(pair[0]["loss_ref"][-1], float(aux["loss_ref"]), rtol=1e-5)
    grads = {n: p.grad for n, p in nets.named_parameters()}
    assert set(pair[0]["grads"]) == set(grads)
    for net in NETS:
        distance, _ = _net_distance(pair[0]["grads"], grads, net)
        assert distance <= FINETUNE_GRAD_DISTANCE, (net, distance)


def test_finetune_step_on_two_ranks_in_float64_equals_one_process(ranks):
    """Rounding apart, the two-rank finetune step is the one-process step on
    the global batch: in float64 (the port's BatchNorm takes its statistics
    in its input's precision, at least f32) every gradient agrees within
    1e-10 of its net's largest, the loss within rtol 1e-12.  In f32 the
    step's L1 signs, clips and LUT bins let sum order move gradients far
    more (chip_smoke.py phase 15)."""
    pair = ranks["results"]["finetune_f64"]
    _assert_ranks_agree(pair)
    nets = _port_nets(tuple(NETS), ranks["inputs"]["ft_vars"], torch.float64).double()
    for m in nets.modules():  # lin's head is f32 in every compute dtype
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = torch.float64
    state = TrainState(nets, make_optimizer(nets.parameters(), FINETUNE_LR))
    loss, _ = steps.make_finetune_train_step(torch.float64)(
        state, *(_nchw(a).double() for a in ranks["inputs"]["ft"][0]))
    np.testing.assert_allclose(float(pair[0]["loss"]), float(loss), rtol=1e-12)
    grads = {n: p.grad for n, p in nets.named_parameters()}
    assert all(g.dtype == torch.float64 for g in pair[0]["grads"].values())
    for net in NETS:
        keys = [k for k in grads if k.startswith(net + ".")]
        largest = max(float(grads[k].abs().max()) for k in keys)
        worst = max(float((pair[0]["grads"][k] - grads[k]).abs().max()) for k in keys)
        assert worst <= 1e-10 * largest, (net, worst / largest)
    written = ranks["written"]
    assert written["ft_ckpt0"] == ["step_00000002.pt"]
    assert written["ft_ckpt1"] == [] and written["ft_log1"] is None


def test_synth_loop_on_two_ranks_writes_on_rank_0_and_keeps_the_ranks_equal(ranks):
    pair = ranks["results"]["synth_loop"]
    _assert_ranks_agree(pair)
    assert pair[0]["step"] == pair[1]["step"] == 2
    written = ranks["written"]
    assert written["synth_ckpt0"] == ["step_00000001.pt", "step_00000002.pt"]
    assert written["synth_ckpt1"] == [] and written["synth_log1"] is None
    assert written["synth_log0_events"]


def test_tail_padding_is_jaxs_rule():
    a = np.arange(3)[:, None] * np.ones((3, 2))
    (out,) = loop.pad_tail((a,), 4, 2)
    np.testing.assert_array_equal(out[:, 0], [0, 1, 2, 2])
    (out,) = loop.pad_tail((a[:2],), 4, 1)  # a mesh of 1 pads too, as JAX's does
    np.testing.assert_array_equal(out[:, 0], [0, 1, 1, 1])
    (out,) = loop.pad_tail((a[:1],), 5, 2)
    assert len(out) == 6
    assert loop.pad_tail((a,), 3, 1)[0] is a


def test_rank_feed_splits_the_batch_and_seeds_the_ranks_apart():
    cfg = loop.LoopConfig(batch_size=16, seed=3)
    assert loop.rank_feed(cfg, None) is cfg
    feeds = [loop.rank_feed(cfg, DataMesh(None, r, 4, torch.device("cpu"))) for r in range(4)]
    assert [f.batch_size for f in feeds] == [4] * 4
    assert feeds[0].seed == 3 and len({f.seed for f in feeds}) == 4
    assert feeds[1].seed == loop.rank_feed(cfg, DataMesh(None, 1, 2, torch.device("cpu"))).seed
    with pytest.raises(ValueError, match="does not split"):
        loop.rank_feed(cfg, DataMesh(None, 0, 3, torch.device("cpu")))


# --- the CLIs' flags -------------------------------------------------------------


@pytest.mark.parametrize("cli", ["train", "joint_train", "finetune"])
def test_cli_mesh_flags_reach_initialize_multihost_and_the_loop(cli, monkeypatch, tmp_path):
    import importlib

    module = importlib.import_module(f"singlehdr_tpu_torch.cli.{cli}")
    seen = {}
    fake_mesh = DataMesh(None, 1, 2, torch.device("cpu"))

    def fake_init(coordinator, num_processes, process_id, device, mesh):
        seen["init"] = (coordinator, num_processes, process_id, str(device), mesh)
        return torch.device("cpu")

    def fake_make_mesh(data, spatial=1, device=None):
        seen["make_mesh"] = (data, spatial, str(device))
        return fake_mesh

    def fake_loop(**kw):
        seen["loop_mesh"] = kw["mesh"]
        seen["device"] = str(kw["state"].device)
        return kw["state"]

    monkeypatch.setattr(port_cli, "initialize_multihost", fake_init)
    monkeypatch.setattr(port_cli, "make_mesh", fake_make_mesh)
    monkeypatch.setattr(port_cli.dist, "destroy_process_group", lambda: seen.setdefault("left", True))
    loop_name = "run_real_finetune" if cli == "finetune" else "run_synth_training"
    monkeypatch.setattr(module, loop_name, fake_loop)
    monkeypatch.chdir(tmp_path)
    if cli == "finetune":
        monkeypatch.setattr(module, "HdrRealPipeline", lambda *a, **k: None)
        first = ["--records", str(tmp_path)]
    else:
        monkeypatch.setattr(module, "get_train_dataset", lambda *a, **k: None)
        first = (["--hdrdir", str(tmp_path), "--deq", "true"] if cli == "train"
                 else ["--dir", str(tmp_path)])
    flags = ["--device", "cpu", "--mesh", "2", "--coordinator", "10.0.0.1:1234",
             "--num_processes", "2", "--process_id", "1", "--vgg_ckpt", "/nonexistent"]
    if cli == "finetune":
        flags = flags[:-2]
    module.run(module.build_parser().parse_args(first + flags))
    assert seen["init"] == ("10.0.0.1:1234", 2, 1, "cpu", True)
    assert seen["make_mesh"] == (2, 1, "cpu")
    assert seen["loop_mesh"] is fake_mesh and seen["device"] == "cpu" and seen["left"]

    # a data 2 x spatial 2 mesh: four processes, and make_mesh(2, spatial=2)
    seen.clear()
    spatial = list(flags)
    spatial[spatial.index("--mesh") + 1] = "2,2"
    spatial[spatial.index("--num_processes") + 1] = "4"
    module.run(module.build_parser().parse_args(first + spatial))
    assert seen["init"] == ("10.0.0.1:1234", 4, 1, "cpu", True)
    assert seen["make_mesh"] == (2, 2, "cpu")
    assert seen["loop_mesh"] is fake_mesh and seen["left"]


@pytest.mark.parametrize("cli", ["train", "joint_train", "finetune"])
def test_cli_several_processes_without_a_mesh_raise(cli, monkeypatch, tmp_path):
    """N > 1 processes with no --mesh would each train the whole batch and
    write the same checkpoints: the CLI refuses before joining a group."""
    import importlib

    module = importlib.import_module(f"singlehdr_tpu_torch.cli.{cli}")
    monkeypatch.setattr(port_cli, "initialize_multihost",
                        lambda *a, **k: pytest.fail("joined a process group"))
    monkeypatch.chdir(tmp_path)
    first = {"finetune": ["--records", str(tmp_path)], "train": ["--hdrdir", str(tmp_path), "--deq", "true"],
             "joint_train": ["--dir", str(tmp_path)]}[cli]
    with pytest.raises(ValueError, match="needs --mesh 2"):
        module.run(module.build_parser().parse_args(
            first + ["--device", "cpu", "--coordinator", "10.0.0.1:1234", "--num_processes", "2",
                     "--process_id", "1"]))
    assert not dist.is_initialized()


def test_cli_without_mesh_makes_no_process_group(monkeypatch, tmp_path):
    from singlehdr_tpu_torch.cli import finetune

    seen = {}
    monkeypatch.setattr(finetune, "run_real_finetune", lambda **kw: seen.setdefault("mesh", kw["mesh"]))
    monkeypatch.setattr(finetune, "HdrRealPipeline", lambda *a, **k: None)
    monkeypatch.chdir(tmp_path)
    finetune.run(finetune.build_parser().parse_args(["--records", str(tmp_path), "--device", "cpu"]))
    assert seen == {"mesh": None} and not dist.is_initialized()


# --- DeviceFeeder --------------------------------------------------------------


def test_device_feeder_puts_transformed_batches_in_order():
    counter = iter(range(100))
    with DeviceFeeder(lambda: np.full((2,), next(counter), np.float32), put_fn=torch.from_numpy,
                      transform=lambda a: a * 10, depth=2) as feeder:
        got = [next(feeder) for _ in range(5)]
    assert [float(t[0]) for t in got] == [0.0, 10.0, 20.0, 30.0, 40.0]
    assert all(isinstance(t, torch.Tensor) for t in got)
    assert not feeder._thread.is_alive()


def test_device_feeder_defaults_to_this_ranks_shard():
    mesh = DataMesh(None, 1, 2, torch.device("cpu"))
    batch = {"x": np.arange(8, dtype=np.float32).reshape(4, 2)}
    with DeviceFeeder(lambda: batch, mesh=mesh) as feeder:
        out = next(feeder)
    assert out["x"].tolist() == [[4.0, 5.0], [6.0, 7.0]]
    with pytest.raises(ValueError, match="put_fn or a mesh"):
        DeviceFeeder(lambda: batch)


def test_device_feeder_raises_the_producers_exception():
    """The JAX copy's producer thread dies on an exception and leaves
    ``__next__`` blocked; the port's carries it to the consumer."""
    calls = iter(range(3))

    def produce():
        if next(calls) == 1:
            raise OSError("disk gone")
        return np.zeros(2)

    feeder = DeviceFeeder(produce, put_fn=lambda a: a)
    result = {}

    def consume():
        try:
            next(feeder)
            next(feeder)
        except OSError as e:
            result["error"] = e

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and str(result["error"]) == "disk gone"
    feeder.close()
    deadline = time.monotonic() + 10
    while feeder._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not feeder._thread.is_alive()
