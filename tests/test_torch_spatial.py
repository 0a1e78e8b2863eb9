"""The port's spatial mesh axis (image rows split over S bands, one rank
each) on the CPU.

Part 1 simulates the band index math in one process, with no process
group: each band is cut from the global tensor, and ``chip_smoke``'s
``ExtendedBand`` stands in for the mesh, handing a band its neighbours'
rows from that tensor as ``halo_rows`` would.  Every op of the halo rule (convs at stride 1 and 2,
the pools, the resize, Sobel, TV's vertical differences) and the plain
versions of the fused stages K2, K3 and K4 on their even-halo extended
bands, at S = 2 and 4 and every band position, reassemble bit-equal to the
whole op (the CPU's conv sums each output in one order whatever the
height).

Part 2 runs the exchange itself: one module-scoped harness of four gloo
rank processes (``file://`` rendezvous under a temporary directory, under
a timeout) runs every case and saves its results.  Bounds, each the one
the JAX package's own spatial tests or ``tests/test_torch_parallel.py``
use for the same comparison:

  * ``shard_spatial`` at S = 4 against JAX's ``shard_spatial`` at 256 x 64:
    atol 3e-5 (tests/test_tiled.py);
  * the deq forward at S = 4 against JAX's unsharded forward: atol 2e-5
    (tests/test_parallel.py);
  * the joint step at 4 x 128^2 on D=1 x S=4 and on D=2 x S=2 against
    JAX's single-device step, to which tests/test_parallel.py holds JAX's
    data 2 x spatial 4 mesh: loss rtol 1e-4, parameters atol 5e-5; under
    remat bit-equal to the plain mesh step;
  * the finetune step on D=1 x S=2 in float64 against one process: every
    gradient within 1e-10 of its net's largest, the loss rtol 1e-12 (a term
    counted S times, or a band's mean taken for the image's, lands far
    outside);
  * the deq, lin and hal steps on D=1 x S=2 in float64 against the
    meshless step: as the finetune step, and the BatchNorm statistics
    within 1e-12;
  * the finetune loop on D=1 x S=2 against the meshless loop: each step's
    logged loss rtol 1e-4, parameters after the epoch atol 5e-5
    (tests/test_torch_parallel.py's loop bounds);
  * ``cli.joint_train --mesh 1,2`` on two processes against the meshless
    CLI: logged losses rtol 1e-4, final parameters atol 5e-5.
"""

import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from singlehdr_tpu import models as jm
from singlehdr_tpu import tiled as jtiled
from singlehdr_tpu.train import steps as jsteps
from singlehdr_tpu_torch import models as tm
from singlehdr_tpu_torch.convert import from_jax_variables, load_jax_variables
from singlehdr_tpu_torch.models import hallucination, linearization, unet
from singlehdr_tpu_torch.models.layers import Conv2d, conv2d_same, keras_init_
from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
from singlehdr_tpu_torch.ops.histogram import linearization_features
from singlehdr_tpu_torch.ops.losses import tv_vertical
from singlehdr_tpu_torch.ops.resize import avg_pool_2x2, max_pool, resize_bilinear_x2
from singlehdr_tpu_torch.ops.sobel import sobel_edges
from singlehdr_tpu_torch.parallel.mesh import DataMesh, band_rows, local_rows
from singlehdr_tpu_torch.train import steps
from singlehdr_tpu_torch.train.state import TrainState, make_optimizer

from chip_smoke import ExtendedBand
from test_torch_models import seeded_variables
from test_torch_parallel import (
    JOINT,
    JOINT_KEYS,
    JOINT_LR,
    NETS,
    _jax_state,
    _joint_batch,
    _nchw,
    _net_distance,
    _port_nets,
    _variables,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- part 1: the band index math, simulated in one process ---------------------------


def _bands(op, x: torch.Tensor, spatial: int):
    """op(band, sim) for every band of ``x``, each output reassembled along
    H (a tuple op's outputs each)."""
    outs = [op(sim.own(), sim) for sim in (ExtendedBand(x, s, spatial) for s in range(spatial))]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, 2) for parts in zip(*outs))
    return torch.cat(outs, 2)


def _assert_bit_equal(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape, (g.shape, w.shape)
        assert torch.equal(g, w), float((g - w).abs().max())


def _seeded(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


SPATIAL = (2, 4)

# (kernel, stride, channels): the nets' and VGG's stride-1 convs, lin's 7x7/2
# stem, res4's 1x1/2 conv1 and proj_conv
CONVS = [(3, 1, 8), (5, 1, 8), (7, 1, 8), (7, 2, 93), (1, 2, 16)]


@pytest.mark.parametrize("spatial", SPATIAL)
@pytest.mark.parametrize("kernel,stride,channels", CONVS)
def test_band_conv_is_the_whole_conv(kernel, stride, channels, spatial):
    x = _seeded((2, channels, 32, 20), kernel)
    w, b = _seeded((6, channels, kernel, kernel), 1), _seeded((6,), 2)
    want = conv2d_same(x, w, b, stride)
    _assert_bit_equal(_bands(lambda t, sim: conv2d_same(t, w, b, stride, sim), x, spatial), want)


@pytest.mark.parametrize("spatial", SPATIAL)
@pytest.mark.parametrize("window,stride", [(3, 2), (2, 2)])
def test_band_max_pool_is_the_whole_pool(window, stride, spatial):
    x = _seeded((2, 5, 32, 18), 3)
    _assert_bit_equal(_bands(lambda t, sim: max_pool(t, window, stride, sim), x, spatial),
                      max_pool(x, window, stride))


@pytest.mark.parametrize("spatial", SPATIAL)
def test_band_avg_pool_and_resize_are_the_whole_ops(spatial):
    x = _seeded((2, 5, 16, 12), 4)
    _assert_bit_equal(_bands(lambda t, sim: avg_pool_2x2(t), x, spatial), avg_pool_2x2(x))
    _assert_bit_equal(_bands(lambda t, sim: resize_bilinear_x2(t, sim), x, spatial),
                      resize_bilinear_x2(x))


@pytest.mark.parametrize("spatial", SPATIAL)
def test_band_sobel_and_features_are_the_whole_ones(spatial):
    x = torch.rand((2, 3, 16, 12), generator=torch.Generator().manual_seed(5))
    _assert_bit_equal(_bands(lambda t, sim: sobel_edges(t, sim), x, spatial), sobel_edges(x))
    _assert_bit_equal(_bands(lambda t, sim: linearization_features(t, sim), x, spatial),
                      linearization_features(x))


@pytest.mark.parametrize("spatial", SPATIAL)
def test_band_tv_differences_add_up_to_the_whole(spatial):
    # eighths in [0, 2): every difference and sum is exact in f32
    x = torch.randint(0, 16, (2, 3, 16, 10), generator=torch.Generator().manual_seed(6)) / 8.0
    sims = [ExtendedBand(x, s, spatial) for s in range(spatial)]
    got = sum(float(tv_vertical(sim.own(), sim)) for sim in sims)
    assert got == float(tv_vertical(x))


def _conv(cin, cout, k, seed):
    conv = Conv2d(cin, cout, k)
    keras_init_(conv, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        conv.bias.copy_(_seeded((cout,), seed))
    return conv


@pytest.mark.parametrize("spatial", SPATIAL)
@pytest.mark.parametrize("kernel", (3, 5, 7))
def test_k2_on_extended_bands_is_the_whole_stage(kernel, spatial):
    """K2's plain version on each band extended by 2 (K // 2) rows, cropped:
    the pooled output and the activation of the whole stage."""
    conv1, conv2 = _conv(4, 16, kernel, 7), _conv(16, 16, kernel, 8)
    x = _seeded((2, 4, 32, 20), kernel)
    with torch.no_grad():
        want = unet._k2(x, conv1, conv2)
        got = _bands(lambda t, sim: unet._k2(t, conv1, conv2, sim), x, spatial)
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("spatial", SPATIAL)
def test_k3_on_extended_bands_is_the_whole_stem(spatial):
    """K3's plain version (features with Sobel REFLECT at the image's edges,
    the 7x7/2 stem, ReLU) on each band extended by K3_HALO rows, cropped to
    the band's stride-2 rows."""
    x = torch.rand((2, 3, 32, 22), generator=torch.Generator().manual_seed(9))
    k, b = _seeded((64, 93, 7, 7), 10) * 0.05, _seeded((64,), 11)
    with torch.no_grad():
        _assert_bit_equal(_bands(lambda t, sim: linearization.feature_stem(t, k, b, sim), x, spatial),
                          linearization.feature_stem(x, k, b))


@pytest.mark.parametrize("spatial", SPATIAL)
def test_k4_on_extended_bands_is_the_whole_stage(spatial):
    stage = hallucination.EncoderStage(3, 16, 2).eval()
    keras_init_(stage, torch.Generator().manual_seed(12))
    x = _seeded((2, 3, 32, 20), 13)
    with torch.no_grad():
        want = stage(x)
        got = []
        for s in range(spatial):
            sim = ExtendedBand(x, s, spatial)
            stage.mesh = sim
            got.append(stage(sim.own()))
        stage.mesh = None
    _assert_bit_equal(tuple(torch.cat(parts, 2) for parts in zip(*got)), want)


def test_extended_band_halo_must_be_even_and_a_halo_fit_a_band():
    from singlehdr_tpu_torch.parallel.mesh import halo_rows, on_extended_band

    x = _seeded((1, 2, 8, 8), 14)
    with pytest.raises(ValueError, match="even"):
        on_extended_band(lambda t: t, x[:, :, :4], 3, ExtendedBand(x, 0, 2))
    # raised before any exchange, so no process group is needed
    with pytest.raises(ValueError, match="wider"):
        halo_rows(x[:, :, :4], 1, 5, DataMesh(None, 0, 2, torch.device("cpu"), spatial=2))


# --- shard_batch / band_rows / make_mesh on the spatial axis -----------------------------


@pytest.mark.parametrize("rank", range(4))
def test_shard_batch_takes_the_data_index_and_the_band(rank, rng):
    """D=2 x S=2: rank d*2 + s keeps samples of data index d and band s of
    every rank-4 leaf whose H divides by S and is > 1; masks and curves
    split by data only; scalars whole (JAX's shard_batch)."""
    mesh = DataMesh(None, rank, 4, torch.device("cpu"), spatial=2)
    d, s = divmod(rank, 2)
    batch = {"img": rng.rand(4, 16, 6, 3).astype(np.float32),
             "mask": np.ones((4, 1, 1, 1), np.float32),
             "crf": rng.rand(4, 1024).astype(np.float32), "t": np.float32(2.0)}
    out = local_rows(mesh, batch)
    np.testing.assert_array_equal(out["img"], batch["img"][2 * d:2 * d + 2, 8 * s:8 * s + 8])
    assert out["mask"].shape == (2, 1, 1, 1) and out["crf"].shape == (2, 1024) and out["t"] == 2.0
    nchw = band_rows(mesh, {"x": torch.zeros(2, 3, 16, 6)}, spatial_dim=2)
    assert nchw["x"].shape == (2, 3, 8, 6)
    assert (mesh.data, mesh.data_rank, mesh.band) == (2, d, s)


def test_rank_feed_seeds_by_data_index_and_fixes_the_spatial_feeds_order():
    """The S ranks of a data index draw the same samples (the data index's
    seed and share of the batch) from one loader worker and one producer;
    a data mesh keeps its feed's threads."""
    from singlehdr_tpu_torch.train import loop

    cfg = loop.LoopConfig(batch_size=8, seed=3, n_workers=16, prefetch_producers=2)
    feeds = [loop.rank_feed(cfg, DataMesh(None, r, 4, torch.device("cpu"), spatial=2)) for r in range(4)]
    assert [f.batch_size for f in feeds] == [4] * 4
    assert feeds[0].seed == feeds[1].seed == 3 and feeds[2].seed == feeds[3].seed != 3
    assert feeds[2].seed == loop.rank_feed(cfg, DataMesh(None, 1, 2, torch.device("cpu"))).seed
    assert all((f.n_workers, f.prefetch_producers) == (1, 1) for f in feeds)
    data = loop.rank_feed(cfg, DataMesh(None, 1, 2, torch.device("cpu")))
    assert (data.n_workers, data.prefetch_producers) == (16, 2)


# --- part 2: the spatial mesh on four and two gloo ranks ---------------------------

RANK_TIMEOUT_S = 300
JOINT_HW, SPATIAL_HW = 128, 64

_RANKS = r"""
import hashlib, json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

torch.set_num_threads(1)
from singlehdr_tpu_torch import models as tm
from singlehdr_tpu_torch.models.layers import mesh_bound
from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
from singlehdr_tpu_torch.parallel import halo_rows, make_mesh, replicate, shard_batch
from singlehdr_tpu_torch.parallel.mesh import extend_rows
from singlehdr_tpu_torch.tiled import shard_spatial
from singlehdr_tpu_torch.train import loop, steps
from singlehdr_tpu_torch.train.state import TrainState, make_optimizer

NETS = {"deq": tm.DequantizationNet, "lin": tm.LinearizationNet, "hal": tm.HallucinationNet,
        "ref": tm.RefinementNet}
rank, work = int(sys.argv[2]), sys.argv[3]
with open(os.path.join(work, "spec.json")) as f:
    spec = json.load(f)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def float64(module):
    # every layer computes in float64, lin's f32 head too
    module.double()
    for m in module.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = torch.float64
    return module


def state_from(case, dtype=torch.float32):
    nets = nn.ModuleDict({n: NETS[n](dtype) for n in case["nets"]})
    nets.load_state_dict(torch.load(os.path.join(work, case["snapshot"])))
    if dtype == torch.float64:
        float64(nets)
    return TrainState(nets, make_optimizer(nets.parameters(), case["lr"]))


def digest(tensors):
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()


def leaves(state):
    return {"params": {n: p.detach() for n, p in state.nets.named_parameters()},
            "buffers": dict(state.nets.named_buffers()), "step": state.step}


def save(case, payload):
    # rank 0's parameters, buffers and gradients whole, the others' digests
    for key in ("params", "buffers", "grads"):
        if key in payload:
            payload[f"{key}_digest"] = digest(payload[key])
            if rank:
                del payload[key]
    torch.save(payload, os.path.join(work, f"{case['name']}.rank{rank}.pt"))


class Batches:
    def __init__(self, batches):
        self._batches = batches

    def epoch(self):
        yield from self._batches


vgg = Vgg16Features()
vgg64 = float64(Vgg16Features())
for world, init, cases in ((4, spec["init4"], spec["cases4"]), (2, spec["init2"], spec["cases2"])):
    if rank >= world:
        break
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    meshes = {}
    for case in cases:
        shape = tuple(case["mesh"])
        if shape not in meshes:  # every rank makes the meshes' groups in one order
            meshes[shape] = make_mesh(*shape, device="cpu")
        mesh, kind = meshes[shape], case["kind"]
        b = np.load(os.path.join(work, case["batch"])) if "batch" in case else None
        if kind == "halo":
            x = shard_batch(mesh, torch.from_numpy(b["x"]), spatial_dim=2).requires_grad_(True)
            z = halo_rows(x, 2, 3, mesh)
            r = torch.rand(z.shape, generator=torch.Generator().manual_seed(rank))
            (z * r).sum().backward()
            save(case, {"z": z.detach(), "gx": x.grad,
                        "ext": extend_rows(x.detach(), 2, 3, mesh, "replicate")})
        elif kind == "same_batch":
            from singlehdr_tpu_torch.parallel.mesh import check_same_on_bands

            check_same_on_bands(mesh, [torch.arange(6.0).reshape(2, 3) + mesh.data_rank])
            try:  # band 1 of each data index fed another batch
                check_same_on_bands(mesh, [torch.arange(6.0).reshape(2, 3) + mesh.band])
                raised = False
            except RuntimeError:
                raised = True
            save(case, {"raised": raised})
        elif kind == "shard_spatial":
            pipe = tm.ReverseCameraPipeline()
            pipe.load_state_dict(torch.load(os.path.join(work, case["snapshot"])))
            save(case, {"out": torch.from_numpy(shard_spatial(pipe, b["img"], mesh,
                                                              case["use_refinement"]))})
        elif kind == "deq_forward":
            deq = tm.DequantizationNet()
            deq.load_state_dict(torch.load(os.path.join(work, case["snapshot"])))
            x = nchw(shard_batch(mesh, b["x"]).numpy())
            with torch.no_grad(), mesh_bound(deq.eval(), mesh):
                save(case, {"y": deq(x)})
        elif kind == "step":
            dtype = getattr(torch, case["dtype"])
            state = replicate(mesh, state_from(case, dtype))
            args = shard_batch(mesh, [nchw(b[k]) if b[k].ndim == 4 and k != "mask" else torch.from_numpy(b[k])
                                      for k in case["keys"]], spatial_dim=2)
            if dtype == torch.float64:
                args = [a.double() for a in args]
            factory = {"deq": lambda: steps.make_deq_train_step(dtype),
                       "lin": lambda: steps.make_lin_train_step(dtype),
                       "hal": lambda: steps.make_hal_train_step(vgg64 if dtype == torch.float64 else vgg,
                                                                dtype),
                       "joint": lambda: steps.make_joint_train_step(vgg, dtype, remat=case.get("remat", False)),
                       "finetune": lambda: steps.make_finetune_train_step(dtype)}
            loss, aux = factory[case["step"]]()(state, *args)
            save(case, {"loss": loss, "aux": {k: aux[k] for k in steps.GLOBAL_MEANS if k in aux},
                        "grads": {n: p.grad for n, p in state.nets.named_parameters()}, **leaves(state)})
        elif kind == "finetune_loop":
            batches = [(b[f"ldr{i}"], b[f"hdr{i}"]) for i in range(case["n_batches"])]
            step, seen = steps.make_finetune_train_step(), {"loss_ref": []}

            def recorded(st, ldr, hdr):
                out = step(st, ldr, hdr)
                seen["loss_ref"].append(float(out.aux["loss_ref"]))
                return out

            out = loop.run_real_finetune(state=state_from(case), step_fn=recorded, pipeline=Batches(batches),
                                         epochs=1, ckpt_dir=os.path.join(work, f"ft_ckpt{rank}"),
                                         log_dir=os.path.join(work, f"ft_log{rank}"), mesh=mesh)
            save(case, {**leaves(out), **seen})
    dist.destroy_process_group()
print("RANK DONE", rank, flush=True)
"""


def _run_ranks(work, n):
    """Start ``n`` rank processes and wait for all; a hung rendezvous or
    collective fails the test after RANK_TIMEOUT_S instead of hanging it."""
    path = os.path.join(work, "ranks.py")
    with open(path, "w") as f:
        f.write(_RANKS)
    procs = [subprocess.Popen([sys.executable, path, ROOT, str(r), work], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(n)]
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
        assert "RANK DONE" in out


@pytest.fixture(scope="module")
def ranks():
    """Inputs of every case, the rank processes' results by case (one a
    rank), and the inputs again for the comparisons."""
    with tempfile.TemporaryDirectory(prefix="spatial_") as work:
        yield _run_cases(work)


def _run_cases(work):
    rs = np.random.RandomState(90)
    inputs = {"pipe_vars": seeded_variables(jm.ReverseCameraPipeline(), (1, 32, 32, 3), seed=91),
              "deq_vars": seeded_variables(jm.DequantizationNet(), (2, 32, 32, 3), seed=92),
              "joint_vars": _variables(JOINT, seed=93),
              "single_vars": {n: _variables((n,), seed=94 + i) for i, n in enumerate(JOINT)},
              "ft_vars": seeded_variables(jm.ReverseCameraPipeline(), (1, 32, 32, 3), seed=97)}
    pipe = load_jax_variables(tm.ReverseCameraPipeline(), inputs["pipe_vars"])
    torch.save(pipe.state_dict(), os.path.join(work, "pipe.pt"))
    deq = load_jax_variables(tm.DequantizationNet(), inputs["deq_vars"])
    torch.save(deq.state_dict(), os.path.join(work, "deq.pt"))
    torch.save(_port_nets(JOINT, inputs["joint_vars"]).state_dict(), os.path.join(work, "joint.pt"))
    for n in JOINT:
        torch.save(_port_nets((n,), inputs["single_vars"][n]).state_dict(), os.path.join(work, f"single_{n}.pt"))
    torch.save(_port_nets(tuple(NETS), inputs["ft_vars"]).state_dict(), os.path.join(work, "ft.pt"))

    inputs["halo"] = {"x": rs.randn(2, 3, 16, 5).astype(np.float32)}
    inputs["img"] = {"img": rs.rand(256, 64, 3).astype(np.float32)}
    inputs["deq_x"] = {"x": rs.rand(2, 64, 64, 3).astype(np.float32)}
    inputs["joint"] = _joint_batch(98, b=4, hw=JOINT_HW)
    single = _joint_batch(99, b=4, hw=SPATIAL_HW)
    inputs["single"] = {**single, "mask": np.ones((4, 1, 1, 1), np.float32)}
    inputs["ft"] = [(rs.rand(n, SPATIAL_HW, SPATIAL_HW, 3).astype(np.float32),
                     rs.rand(n, SPATIAL_HW, SPATIAL_HW, 3).astype(np.float32)) for n in (4, 3)]
    for name in ("halo", "img", "deq_x", "joint", "single"):
        np.savez(os.path.join(work, f"{name}.npz"), **inputs[name])
    np.savez(os.path.join(work, "ft64.npz"), ldr=inputs["ft"][0][0], hdr=inputs["ft"][0][1])
    np.savez(os.path.join(work, "ft_loop.npz"),
             **{f"{k}{i}": a for i, pair in enumerate(inputs["ft"]) for k, a in zip(("ldr", "hdr"), pair)})

    joint = {"kind": "step", "step": "joint", "nets": list(JOINT), "keys": list(JOINT_KEYS),
             "snapshot": "joint.pt", "batch": "joint.npz", "lr": JOINT_LR, "dtype": "float32"}
    single_keys = {"deq": ["ldr", "jpeg", "mask"], "lin": ["ldr", "clipped_hdr_t", "mask", "invcrf"],
                   "hal": ["hdr_t", "clipped_hdr_t", "mask"]}
    cases4 = [
        {"kind": "halo", "name": "halo", "mesh": [1, 4], "batch": "halo.npz"},
        {"kind": "same_batch", "name": "same_batch", "mesh": [2, 2]},
        {"kind": "shard_spatial", "name": "shard_spatial", "mesh": [1, 4], "batch": "img.npz",
         "snapshot": "pipe.pt", "use_refinement": True},
        {"kind": "deq_forward", "name": "deq_forward", "mesh": [1, 4], "batch": "deq_x.npz",
         "snapshot": "deq.pt"},
        {**joint, "name": "joint_1x4", "mesh": [1, 4]},
        {**joint, "name": "joint_2x2", "mesh": [2, 2]},
        {**joint, "name": "joint_2x2_remat", "mesh": [2, 2], "remat": True},
    ]
    cases2 = [
        {"kind": "step", "name": "finetune_f64", "mesh": [1, 2], "step": "finetune", "nets": list(NETS),
         "keys": ["ldr", "hdr"], "snapshot": "ft.pt", "batch": "ft64.npz", "lr": 1e-5, "dtype": "float64"},
        *[{"kind": "step", "name": n, "mesh": [1, 2], "step": n, "nets": [n], "keys": single_keys[n],
           "snapshot": f"single_{n}.pt", "batch": "single.npz", "lr": 1e-4, "dtype": "float64"} for n in JOINT],
        {"kind": "shard_spatial", "name": "shard_spatial_a", "mesh": [1, 2], "batch": "img.npz",
         "snapshot": "pipe.pt", "use_refinement": False},
        {"kind": "finetune_loop", "name": "finetune_loop", "mesh": [1, 2], "nets": list(NETS),
         "snapshot": "ft.pt", "batch": "ft_loop.npz", "n_batches": 2, "lr": 1e-5},
    ]
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump({"init4": f"file://{work}/rdzv4", "init2": f"file://{work}/rdzv2",
                   "cases4": cases4, "cases2": cases2}, f)
    _run_ranks(work, 4)
    results = {c["name"]: [torch.load(os.path.join(work, f"{c['name']}.rank{r}.pt"))
                           for r in range(c["mesh"][0] * c["mesh"][1])] for c in cases4 + cases2}
    written = {d: sorted(os.listdir(os.path.join(work, d))) if os.path.isdir(os.path.join(work, d)) else None
               for d in ("ft_ckpt0", "ft_ckpt1", "ft_log1")}
    return {"inputs": inputs, "results": results, "written": written}


def _assert_ranks_agree(results):
    for key in ("params_digest", "buffers_digest"):
        if key in results[0]:
            assert len({r[key] for r in results}) == 1, key


def test_halo_rows_forward_and_backward_on_four_ranks(ranks):
    """Each band's halo (2 rows above, 3 below, none beyond the image) is
    its neighbours' rows; the backward hands each received row's gradient
    back to its owner, so every band's input gradient is the global
    tensor's; ``extend_rows`` pads the image's edges as asked."""
    x = torch.from_numpy(ranks["inputs"]["halo"]["x"])
    got = ranks["results"]["halo"]
    h, gx = x.shape[2] // 4, torch.zeros_like(x)
    for s, res in enumerate(got):
        lo, hi = max(s * h - 2, 0), min((s + 1) * h + 3, x.shape[2])
        assert torch.equal(res["z"], x[:, :, lo:hi])
        r = torch.rand(res["z"].shape, generator=torch.Generator().manual_seed(s))
        gx[:, :, lo:hi] += r
        padded = F.pad(x, (0, 0, 2, 3), mode="replicate")
        assert torch.equal(res["ext"], padded[:, :, s * h:(s + 1) * h + 5])
    for s, res in enumerate(got):
        torch.testing.assert_close(res["gx"], gx[:, :, s * h:(s + 1) * h], rtol=0, atol=1e-6)


def test_bands_fed_different_batches_raise(ranks):
    """``check_same_on_bands``, which the HDR-Synth loop runs each step on a
    spatial mesh: equal batches on a data index's bands pass (the data
    indices' batches differ), a band fed another batch raises on every
    band."""
    assert [r["raised"] for r in ranks["results"]["same_batch"]] == [True] * 4


def test_shard_spatial_on_four_ranks_matches_jax(ranks):
    """tests/test_tiled.py's case: 256 x 64 on 4 bands of 64 rows, against
    the JAX package's ``shard_spatial`` (XLA's halo exchanges) within its
    bound; every rank returns the whole image."""
    img = ranks["inputs"]["img"]["img"]
    got = ranks["results"]["shard_spatial"]
    want = jtiled.shard_spatial(ranks["inputs"]["pipe_vars"], img, n_devices=4)
    for r in got:
        assert r["out"].shape == img.shape
        assert torch.equal(r["out"], got[0]["out"])
    np.testing.assert_allclose(got[0]["out"].numpy(), want, atol=3e-5)


def test_shard_spatial_without_refinement_is_a_pred(ranks):
    """``use_refinement=False`` on 2 bands: the hallucinated A_pred of the
    whole pipeline (the port's meshless forward), ``ref`` not run."""
    img = ranks["inputs"]["img"]["img"]
    pipe = load_jax_variables(tm.ReverseCameraPipeline(), ranks["inputs"]["pipe_vars"]).eval()
    with torch.no_grad():
        want = pipe(torch.from_numpy(img).permute(2, 0, 1)[None]).a_pred[0].permute(1, 2, 0).numpy()
    got = ranks["results"]["shard_spatial_a"]
    np.testing.assert_allclose(got[0]["out"].numpy(), want, atol=3e-5)
    assert torch.equal(got[1]["out"], got[0]["out"])


def test_shard_spatial_checks_the_height():
    from singlehdr_tpu_torch.tiled import shard_spatial

    mesh = DataMesh(None, 0, 4, torch.device("cpu"), spatial=4)
    with pytest.raises(ValueError, match="4 x 32"):
        shard_spatial(tm.ReverseCameraPipeline(), np.zeros((192, 64, 3), np.float32), mesh)


def test_deq_forward_on_four_bands_matches_jax(ranks):
    """tests/test_parallel.py's spatial forward: deq in eval (K2 on extended
    bands, the rest by halo) on 64^2 images in bands of 16 rows, against
    JAX's unsharded forward."""
    x = ranks["inputs"]["deq_x"]["x"]
    got = torch.cat([r["y"] for r in ranks["results"]["deq_forward"]], 2)
    want = np.asarray(jm.DequantizationNet().apply(ranks["inputs"]["deq_vars"], jnp.asarray(x)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=2e-5)


@pytest.fixture(scope="module")
def jax_joint(ranks):
    batch = ranks["inputs"]["joint"]
    jstate, jloss, jaux = jsteps.make_joint_train_step(jm.Vgg16Features())(
        _jax_state(ranks["inputs"]["joint_vars"], JOINT_LR), *[jnp.asarray(batch[k]) for k in JOINT_KEYS])
    return {"loss": float(jloss), "crf_mse": float(jaux["crf_mse"]),
            "params": from_jax_variables({"params": jax.device_get(jstate.params)}),
            "stats": from_jax_variables({"batch_stats": jax.device_get(jstate.batch_stats)})}


@pytest.mark.parametrize("case", ["joint_1x4", "joint_2x2"])
def test_joint_step_on_a_spatial_mesh_matches_jax(case, ranks, jax_joint):
    """tests/test_parallel.py's spatial case: the joint step at 4 x 128^2
    (bands of 32 rows shrinking to 1 at hal's latent), with one sample
    masked out, on D=1 x S=4 and D=2 x S=2 against JAX's single-device
    step: loss, crf_mse, parameters after one Adam(1e-5) step and the new
    BatchNorm statistics."""
    got = ranks["results"][case]
    _assert_ranks_agree(got)
    np.testing.assert_allclose(float(got[0]["loss"]), jax_joint["loss"], rtol=1e-4)
    np.testing.assert_allclose(float(got[0]["aux"]["crf_mse"]), jax_joint["crf_mse"], rtol=1e-4)
    assert set(jax_joint["params"]) == set(got[0]["params"])
    for key, value in jax_joint["params"].items():
        np.testing.assert_allclose(got[0]["params"][key].numpy(), value.numpy(), atol=5e-5, err_msg=key)
    for key, value in jax_joint["stats"].items():
        np.testing.assert_allclose(got[0]["buffers"][key].numpy(), value.numpy(), atol=1e-5, err_msg=key)


def test_remat_on_a_spatial_mesh_equals_the_plain_mesh_step(ranks):
    """Under remat the D=2 x S=2 joint step recomputes each net's forward in
    the backward, its halo exchanges and BatchNorm all-reduces with it, in
    one order on every rank (the case finishing shows no deadlock), and
    leaves the loss, every gradient and the statistics bit-equal."""
    plain, remat = ranks["results"]["joint_2x2"][0], ranks["results"]["joint_2x2_remat"][0]
    _assert_ranks_agree(ranks["results"]["joint_2x2_remat"])
    assert torch.equal(plain["loss"], remat["loss"])
    for key in ("grads", "buffers"):
        for name, value in plain[key].items():
            assert torch.equal(remat[key][name], value), name


def test_finetune_step_on_two_bands_in_float64_equals_one_process(ranks):
    """The float64 finetune step on D=1 x S=2 is the one-process step but
    for rounding: every gradient within 1e-10 of its net's largest and the
    loss within rtol 1e-12.  A term counted on both bands (the
    renormalisation mean, a per-band mean, lin's head) lands far outside."""
    got = ranks["results"]["finetune_f64"]
    _assert_ranks_agree(got)
    nets = _float64(_port_nets(tuple(NETS), ranks["inputs"]["ft_vars"], torch.float64))
    state = TrainState(nets, make_optimizer(nets.parameters(), 1e-5))
    loss, aux = steps.make_finetune_train_step(torch.float64)(
        state, *(_nchw(a).double() for a in ranks["inputs"]["ft"][0]))
    np.testing.assert_allclose(float(got[0]["loss"]), float(loss), rtol=1e-12)
    np.testing.assert_allclose(float(got[0]["aux"]["loss_ref"]), float(aux["loss_ref"]), rtol=1e-12)
    _assert_float64_grads(got[0]["grads"], {n: p.grad for n, p in nets.named_parameters()}, NETS)


def _float64(module):
    module.double()
    for m in module.modules():  # lin's head is f32 in every compute dtype
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = torch.float64
    return module


def _assert_float64_grads(got: dict, want: dict, names) -> None:
    """Every gradient within 1e-10 of its net's largest."""
    for net in names:
        keys = [k for k in want if k.startswith(net + ".")]
        largest = max(float(want[k].abs().max()) for k in keys)
        worst = max(float((got[k] - want[k]).abs().max()) for k in keys)
        assert worst <= 1e-10 * largest, (net, worst / largest)


@pytest.mark.parametrize("net", JOINT)
def test_pretrain_step_on_two_bands_in_float64_equals_one_process(net, ranks):
    """deq, lin and hal pretraining on D=1 x S=2 (bands of 32 rows; hal's
    latent a row a band) in float64 against the port's meshless step on the
    whole batch: the loss within rtol 1e-12, every gradient within 1e-10 of
    its net's largest, the new BatchNorm statistics within 1e-12.  (In f32
    hal's gradients at this size sit 6e-3 from float64's, a BatchNorm over
    eight latent values amplifying sum order, so f32 cannot tell a fault
    from rounding here; the joint step above is held in f32.)"""
    got = ranks["results"][net]
    _assert_ranks_agree(got)
    nets = _float64(_port_nets((net,), ranks["inputs"]["single_vars"][net], torch.float64))
    state = TrainState(nets, make_optimizer(nets.parameters(), 1e-4))
    batch = ranks["inputs"]["single"]
    factory = {"deq": steps.make_deq_train_step, "lin": steps.make_lin_train_step,
               "hal": lambda dtype: steps.make_hal_train_step(_float64(Vgg16Features()), dtype)}[net]
    keys = {"deq": ["ldr", "jpeg", "mask"], "lin": ["ldr", "clipped_hdr_t", "mask", "invcrf"],
            "hal": ["hdr_t", "clipped_hdr_t", "mask"]}[net]
    loss, _ = factory(torch.float64)(state, *[
        (_nchw(batch[k]) if batch[k].ndim == 4 and k != "mask" else torch.from_numpy(batch[k].copy())).double()
        for k in keys])
    np.testing.assert_allclose(float(got[0]["loss"]), float(loss), rtol=1e-12)
    _assert_float64_grads(got[0]["grads"], {n: p.grad for n, p in nets.named_parameters()}, (net,))
    for key, value in nets.named_buffers():
        np.testing.assert_allclose(got[0]["buffers"][key].numpy(), value.numpy(), rtol=1e-12, atol=1e-12,
                                   err_msg=key)


def test_finetune_loop_on_two_bands_equals_the_meshless_loop(ranks, tmp_path):
    """An epoch of a batch of 4 and a tail of 3 (padded to 4 on the mesh of
    D=1, JAX's rule) on D=1 x S=2 against the meshless loop on the padded
    batches: each step's logged loss and the parameters after the epoch;
    rank 0 alone writes."""
    from singlehdr_tpu_torch.train import loop

    got = ranks["results"]["finetune_loop"]
    _assert_ranks_agree(got)
    nets = _port_nets(tuple(NETS), ranks["inputs"]["ft_vars"])
    step, losses = steps.make_finetune_train_step(), []

    def recorded(st, ldr, hdr):
        out = step(st, ldr, hdr)
        losses.append(float(out.aux["loss_ref"]))
        return out

    class Batches:
        def epoch(self):
            yield from (loop.pad_tail(pair, 4, 1) for pair in ranks["inputs"]["ft"])

    out = loop.run_real_finetune(state=TrainState(nets, make_optimizer(nets.parameters(), 1e-5)),
                                 step_fn=recorded, pipeline=Batches(), epochs=1,
                                 ckpt_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "log"))
    np.testing.assert_allclose(got[0]["loss_ref"], losses, rtol=1e-4)
    for key, value in out.nets.named_parameters():
        np.testing.assert_allclose(got[0]["params"][key].numpy(), value.detach().numpy(), atol=5e-5,
                                   err_msg=key)
    assert ranks["written"]["ft_ckpt0"] == ["step_00000002.pt"]
    assert ranks["written"]["ft_ckpt1"] == [] and ranks["written"]["ft_log1"] is None


def test_joint_train_cli_on_two_bands_equals_the_meshless_cli(tmp_path, monkeypatch):
    """``cli.joint_train --device cpu --mesh 1,2`` on two processes (one
    data index of two bands, which draw the same batches and keep their
    rows) against the meshless CLI fed by one loader worker and one
    producer, as the spatial feed is: each step's logged loss rtol 1e-4,
    the final parameters atol 5e-5 (tests/test_torch_parallel.py's loop
    bounds); rank 1 writes nothing."""
    import functools
    import socket

    import chip_smoke
    from singlehdr_tpu_torch.cli import joint_train
    from singlehdr_tpu_torch.train.checkpoint import CheckpointManager
    from singlehdr_tpu_torch.train.loop import LoopConfig

    hdr = tmp_path / "hdr"
    hdr.mkdir()
    chip_smoke.write_hdr_files(str(hdr), 2)
    flags = ["--dir", str(hdr), "--device", "cpu", "--batch_size", "2", "--patch_size", "64",
             "--iterations", "2", "--workers", "2", "--log_every", "1", "--vgg_ckpt", "/nonexistent"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in (0, 1):
        cwd = tmp_path / f"rank{r}"
        cwd.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "singlehdr_tpu_torch.cli.joint_train", *flags, "--jnt_ckpt",
             str(cwd / "jnt"), "--mesh", "1,2", "--num_processes", "2", "--process_id", str(r),
             "--coordinator", f"127.0.0.1:{port}"],
            cwd=str(cwd), env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the --mesh 1,2 processes timed out")
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]

    here = tmp_path / "meshless"
    here.mkdir()
    monkeypatch.chdir(here)
    monkeypatch.setattr(joint_train, "LoopConfig", functools.partial(LoopConfig, prefetch_producers=1))
    state = joint_train.run(joint_train.build_parser().parse_args(
        flags + ["--jnt_ckpt", str(here / "jnt"), "--workers", "1"]))
    want = chip_smoke.logged_losses(str(here), "jnt/loss")
    got = chip_smoke.logged_losses(str(tmp_path / "rank0"), "jnt/loss")
    assert len(want) == 2 and len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    mgr = CheckpointManager(str(tmp_path / "rank0" / "jnt"))
    saved = mgr.load(mgr.latest_step, "cpu")["nets"]
    for net, sd in saved.items():
        for key, value in state.nets[net].state_dict().items():
            np.testing.assert_allclose(sd[key].numpy(), value.numpy(), atol=5e-5, err_msg=f"{net}.{key}")
    assert not (tmp_path / "rank1" / "jnt").exists() or not os.listdir(tmp_path / "rank1" / "jnt")
    assert chip_smoke.logged_losses(str(tmp_path / "rank1"), "jnt/loss") == []
