"""The port's checkpoint interop on the CPU against the JAX package.

The copies (TensorBundle reader and writer, object graph, key inventory,
weight import) must give the same bytes and the same arrays as the JAX
package's; the port's ``import_reference`` and ``export_weights`` CLIs must
write what the JAX package writes from the same checkpoints and variables.

Two sets of checkpoints, each written once a module:

  * fixture bundles: every key of a reference checkpoint (Adam slots,
    counters, the object graph) at full width, N(0, 0.05) values from
    ``ref_inventory.make_fixture_tensors``; they cover keys and shapes;
  * seeded bundles: the JAX package's ``export_reference_checkpoint`` over
    the realistic seeded variables of ``tests/test_torch_models.py`` (hal's
    preprocessing means at their constant, which no reference checkpoint
    carries); a pipeline loaded from them is held to the JAX one at 2e-5.

The JAX copy's crc32c is a per-byte Python loop, tens of seconds over a
full-width hal checkpoint; where the JAX package reads or writes those
bundles here, its module computes crc32c with the port's lane version, which
``test_crc32c_equals_the_jax_copy`` holds to it value for value.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlehdr_tpu import models as jm
from singlehdr_tpu.cli import import_reference as jax_import_reference
from singlehdr_tpu.ops.color import VGG_MEAN_BGR
from singlehdr_tpu.train import object_graph as jobject_graph
from singlehdr_tpu.train import ref_inventory as jref_inventory
from singlehdr_tpu.train import tensorbundle as jtensorbundle
from singlehdr_tpu.train import weight_import as jweight_import
from singlehdr_tpu_torch.cli import export_weights, import_reference, infer
from singlehdr_tpu_torch.cli import serve as cli_serve
from singlehdr_tpu_torch.convert import nest_variables, to_jax_variables
from singlehdr_tpu_torch.models import build_pipeline
from singlehdr_tpu_torch.train import object_graph, ref_inventory, tensorbundle, weight_import

from test_torch_models import ATOL, seeded_variables

NETS = ("deq", "lin", "hal", "ref")
JAX_CRC32C = jtensorbundle.crc32c  # the JAX copy's own, whatever a fixture sets later
GOLDEN_INDEX = os.path.join(os.path.dirname(__file__), "golden", "ref_index")
SHARD = ".data-00000-of-00001"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lane_crc_in_jax():
    """The JAX tensorbundle computes crc32c with the port's lane version."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jtensorbundle, "crc32c", tensorbundle.crc32c)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def fixture_bundles(tmp_path_factory):
    """{net: prefix} of one full-width fixture checkpoint a net, object graph
    included, written by the port's writer."""
    root = tmp_path_factory.mktemp("fixture")
    out = {}
    for net in NETS:
        tensors = ref_inventory.make_fixture_tensors(net)
        tensors[ref_inventory.OBJECT_GRAPH_KEY] = object_graph.build_object_graph(tensors)
        out[net] = str(root / net / "ckpt-1")
        tensorbundle.write_bundle(out[net], tensors)
    return out


@pytest.fixture(scope="module")
def seeded(tmp_path_factory, lane_crc_in_jax):
    """Realistic seeded pipeline variables (JAX layout): their flat npz, and
    the JAX package's reference-format export of each net."""
    variables = jax.tree.map(np.asarray, seeded_variables(jm.ReverseCameraPipeline(), (1, 64, 64, 3),
                                                          seed=5))
    variables["batch_stats"]["hal"]["preproc_mean"] = np.asarray(VGG_MEAN_BGR, np.float32)
    root = tmp_path_factory.mktemp("seeded")
    npz = str(root / "seeded.npz")
    jweight_import.save_variables_npz(variables, npz)
    bundles = {}
    for net in NETS:
        bundles[net] = str(root / "jax_export" / net / "ckpt-1")
        jweight_import.export_reference_checkpoint(net, _net_variables(variables, net), bundles[net])
    return {"variables": variables, "npz": npz, "bundles": bundles}


@pytest.fixture(scope="module")
def exported(seeded, tmp_path_factory):
    """The port's export CLI on the seeded npz: its output directory."""
    root = tmp_path_factory.mktemp("export")
    export_weights.run(export_weights.build_parser().parse_args(
        ["--weights", seeded["npz"], "--out", str(root / "port.npz"), "--reference_out",
         str(root / "ref")]))
    return root


def _net_variables(variables, net):
    return {"params": variables["params"][net], "batch_stats": variables["batch_stats"].get(net, {})}


def _flags(bundles, nets=NETS):
    return [a for net in nets for a in (f"--{net}", bundles[net])]


def _assert_npz_equal(got, want, keys=None):
    with np.load(got) as g, np.load(want) as w:
        assert set(g.files) == set(w.files)
        for key in keys if keys is not None else w.files:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _import_lines(out):
    return [line for line in out.splitlines() if not line.startswith("wrote ")]


# --- the copies -----------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 9, 1023, 64 * 1024, 64 * 1024 + 1, 3 * 65536 + 1023])
def test_crc32c_equals_the_jax_copy(n):
    data = np.random.RandomState(n).randint(0, 256, n, dtype=np.uint8).tobytes()
    for start in (0, 0x1234ABCD):
        assert tensorbundle.crc32c(data, start) == JAX_CRC32C(data, start)
    assert tensorbundle.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_write_bundle_writes_the_jax_writers_bytes(tmp_path, monkeypatch):
    """float32 arrays (one past the crc's lane threshold), int32 and int64
    scalars, a float64 array and the object-graph string tensor, over more
    keys than a table restart interval (16); the JAX writer with its own crc."""
    monkeypatch.setattr(jtensorbundle, "crc32c", JAX_CRC32C)
    rs = np.random.RandomState(0)
    tensors = {f"lin/layer{i:02d}/kernel/.ATTRIBUTES/VARIABLE_VALUE":
               np.asarray(rs.randn(*rs.randint(1, 5, size=i % 4)), np.float32) for i in range(40)}
    tensors["lin/big/kernel/.ATTRIBUTES/VARIABLE_VALUE"] = rs.randn(3, 3, 64, 128).astype(np.float32)
    tensors["lin/wide/bias/.ATTRIBUTES/VARIABLE_VALUE"] = rs.randn(7).astype(np.float64)
    tensors["epoch/.ATTRIBUTES/VARIABLE_VALUE"] = np.asarray(3, np.int32)
    tensors["save_counter/.ATTRIBUTES/VARIABLE_VALUE"] = np.asarray(1, np.int64)
    tensors[ref_inventory.OBJECT_GRAPH_KEY] = object_graph.build_object_graph(tensors)
    tensorbundle.write_bundle(str(tmp_path / "port" / "ckpt-1"), tensors)
    jtensorbundle.write_bundle(str(tmp_path / "jax" / "ckpt-1"), tensors)
    for suffix in (".index", SHARD):
        assert filecmp.cmp(tmp_path / "port" / f"ckpt-1{suffix}", tmp_path / "jax" / f"ckpt-1{suffix}",
                           shallow=False), suffix
    got = tensorbundle.read_bundle(str(tmp_path / "jax" / "ckpt-1"))
    assert set(got) == set(tensors) - {ref_inventory.OBJECT_GRAPH_KEY}
    for key, value in got.items():
        assert value.dtype == tensors[key].dtype, key
        np.testing.assert_array_equal(value, tensors[key], err_msg=key)


@pytest.mark.parametrize("net", NETS)
def test_reader_reads_the_golden_index_to_the_inventory(net):
    got = tensorbundle.BundleReader(os.path.join(GOLDEN_INDEX, net)).variable_to_shape_map()
    assert got == ref_inventory.checkpoint_keys(net)


@pytest.mark.parametrize("net", NETS)
def test_inventory_and_object_graph_equal_the_jax_copies(net):
    for with_optimizer in (True, False):
        assert ref_inventory.checkpoint_keys(net, with_optimizer) == \
            jref_inventory.checkpoint_keys(net, with_optimizer)
    got, want = ref_inventory.make_fixture_tensors(net, seed=2), jref_inventory.make_fixture_tensors(net, seed=2)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    assert object_graph.build_object_graph(got) == jobject_graph.build_object_graph(want)
    assert weight_import.NET_MAPS[net] == jweight_import.NET_MAPS[net]


# --- import ---------------------------------------------------------------------


@pytest.mark.parametrize("order, supplied", [("rgb", NETS), ("bgr", NETS), ("rgb", ("deq", "hal"))],
                         ids=["rgb", "bgr", "rgb-deq-hal"])
def test_import_cli_writes_the_jax_clis_arrays(order, supplied, fixture_bundles, lane_crc_in_jax,
                                               tmp_path, capsys):
    """Fixture bundles through both CLIs: the supplied nets' arrays bit-equal
    and every net imported with none kept at init; a net left out keeps each
    package's own seeded init (the port's: ``build_pipeline(seed=0)``)."""
    flags = _flags(fixture_bundles, supplied) + ["--channel_order", order]
    port, jax_npz = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    import_reference.run(import_reference.build_parser().parse_args(["--out", port, *flags]))
    port_out = capsys.readouterr().out
    jax_import_reference.run(jax_import_reference.build_parser().parse_args(["--out", jax_npz, *flags]))
    assert _import_lines(port_out) == _import_lines(capsys.readouterr().out)
    for net in NETS:
        assert (f"{net}: imported" in port_out) == (net in supplied)
    assert "WARNING" not in port_out and port_out.count(" 0 kept at init") == len(supplied)
    with np.load(port) as z:
        keys = [k for k in z.files if k.split("/")[1] in supplied]
        init = to_jax_variables(build_pipeline(seed=0, device="cpu").state_dict())
        for key in set(z.files) - set(keys):
            np.testing.assert_array_equal(z[key], init[key], err_msg=key)
    _assert_npz_equal(port, jax_npz, keys)


def test_imported_pipeline_matches_the_jax_pipeline(seeded, tmp_path):
    """The JAX package's export of realistic weights, imported by each
    package's CLI: the port's pipeline (loaded as the serve CLI loads
    ``--weights``) against the JAX pipeline at 1 x 64^2, within 2e-5."""
    port, jax_npz = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    import_reference.run(import_reference.build_parser().parse_args(
        ["--out", port, *_flags(seeded["bundles"])]))
    jax_import_reference.run(jax_import_reference.build_parser().parse_args(
        ["--out", jax_npz, *_flags(seeded["bundles"])]))
    _assert_npz_equal(port, jax_npz)
    x = np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32)
    want = jm.ReverseCameraPipeline().apply(jweight_import.load_variables_npz(jax_npz), jnp.asarray(x))
    args = cli_serve.build_parser().parse_args(["--weights", port, "--device", "cpu"])
    pipe = cli_serve.load_pipeline(args, "cpu")
    with torch.inference_mode():
        got = pipe(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.invcrf.numpy(), np.asarray(want.invcrf), atol=ATOL)
    np.testing.assert_allclose(got.hdr.numpy().transpose(0, 2, 3, 1), np.asarray(want.hdr), atol=ATOL)


# --- export ---------------------------------------------------------------------


@pytest.mark.parametrize("net", NETS)
def test_export_cli_bundles_are_the_jax_exports_bytes(net, seeded, exported):
    ours, theirs = exported / "ref" / net, os.path.dirname(seeded["bundles"][net])
    for name in ("ckpt-1.index", f"ckpt-1{SHARD}", "checkpoint"):
        assert filecmp.cmp(ours / name, os.path.join(theirs, name), shallow=False), name


def test_export_cli_npz_carries_the_weights(seeded, exported):
    _assert_npz_equal(str(exported / "port.npz"), seeded["npz"])


def test_export_then_import_round_trips_the_state_dict(seeded, exported, tmp_path, capsys):
    """Reference bundles written by the port, read back by the port: the
    pipeline's state_dict bit for bit; hal's preprocessing means are carried
    from the target (reference checkpoints do not hold them), as in JAX."""
    prefixes = {net: str(exported / "ref" / net / "ckpt-1") for net in NETS}
    npz = str(tmp_path / "back.npz")
    import_reference.run(import_reference.build_parser().parse_args(["--out", npz, *_flags(prefixes)]))
    assert capsys.readouterr().out.count(" 0 kept at init") == len(NETS)
    want = infer.load_weights(seeded["npz"], "cpu").state_dict()
    got = infer.load_weights(npz, "cpu").state_dict()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key

    target = _net_variables(nest_variables(to_jax_variables(build_pipeline(seed=0, device="cpu")
                                                            .state_dict())), "hal")
    stats = weight_import.import_net_weights("hal", prefixes["hal"], target)["_import_stats"]
    assert stats == jweight_import.import_net_weights("hal", prefixes["hal"], target)["_import_stats"]
    assert stats["carried"] == 1 and stats["kept"] == 0
