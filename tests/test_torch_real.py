"""The port's HDR-Real path on the CPU against the JAX package.

Copies (record shards, the TFRecord reader, the HDR-Real batch pipeline, the
HDR-Synth validation and test sets, ``read_ldr``) must give the same bytes and
the same arrays; ``psnr``/``ssim`` agree to 1e-5; the tiled predictor and the
finetune loop are held to the JAX ones on the same weights
(``convert.load_jax_variables``); validate_synth's metrics on one simulated
capture (``capture_chain`` with the JAX draw's noise) agree.  Inputs are made
from seeds with numpy; paired HDR_gt/LDR_in trees are written with cv2, as
tests/test_cli.py does for the JAX package.
"""

import filecmp
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from singlehdr_tpu import models as jm
from singlehdr_tpu.data import hdr_io as jhdr_io
from singlehdr_tpu.data import real as jreal
from singlehdr_tpu.data import records as jrecords
from singlehdr_tpu.data import synth as jsynth
from singlehdr_tpu.data import tfrecord as jtfrecord
from singlehdr_tpu.ops import curves as jcurves
from singlehdr_tpu.ops import degradation as jdeg
from singlehdr_tpu.tiled import TiledPredictor as JaxTiledPredictor
from singlehdr_tpu.tiled import _feather_weights as jax_feather_weights
from singlehdr_tpu.train import loop as jloop
from singlehdr_tpu.train import metrics as jmetrics
from singlehdr_tpu.train import steps as jsteps
from singlehdr_tpu.train.metrics import MetricsWriter as JaxMetricsWriter
from singlehdr_tpu.train.state import NetState
from singlehdr_tpu.train.state import make_optimizer as jax_make_optimizer
from singlehdr_tpu_torch import models as tm
from singlehdr_tpu_torch.cli.validate_synth import synth_metrics
from singlehdr_tpu_torch.convert import load_jax_variables
from singlehdr_tpu_torch.data import hdr_io, real, records, synth, tfrecord
from singlehdr_tpu_torch.ops import degradation
from singlehdr_tpu_torch.tiled import TiledPredictor, _feather_weights, tile_origins
from singlehdr_tpu_torch.train import loop, metrics, steps
from singlehdr_tpu_torch.train.checkpoint import CheckpointManager
from singlehdr_tpu_torch.train.state import NETS, TrainState, make_optimizer

from test_torch_models import ATOL, seeded_variables


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def write_real_tree(root, sizes, seed):
    """A paired HDR_gt/*.hdr + LDR_in/*.jpg tree: a smooth seeded radiance
    map, and its LDR through a gamma curve, 8-bit quantised and JPEG-coded."""
    import cv2

    os.makedirs(os.path.join(root, "HDR_gt"), exist_ok=True)
    os.makedirs(os.path.join(root, "LDR_in"), exist_ok=True)
    rs = np.random.RandomState(seed)
    for i, (h, w) in enumerate(sizes):
        coarse = (rs.rand(h // 16 + 1, w // 16 + 1, 3).astype(np.float32) * 1.5) ** 2
        hdr = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR) + 0.02
        hdr *= 1 + 0.1 * rs.rand(h, w, 3).astype(np.float32)
        ldr = np.round(np.clip(hdr / 2.0, 0, 1) ** (1 / 2.2) * 235 + 10).astype(np.uint8)
        jhdr_io.write_hdr(os.path.join(root, "HDR_gt", f"{i:02d}.hdr"), hdr)
        cv2.imwrite(os.path.join(root, "LDR_in", f"{i:02d}.jpg"), ldr[:, :, ::-1])
    return root


@pytest.fixture(scope="module")
def real_dir(tmp_path_factory):
    return write_real_tree(str(tmp_path_factory.mktemp("real")), [(300, 300), (256, 320)], 1)


def _pairs(d):
    return (sorted(glob.glob(os.path.join(d, "HDR_gt", "*.hdr"))),
            sorted(glob.glob(os.path.join(d, "LDR_in", "*.jpg"))))


@pytest.fixture(scope="module")
def record_dirs(real_dir, tmp_path_factory):
    """The same pairs converted at 64^2 patches by both packages."""
    out = {}
    for name, module in (("jax", jrecords), ("port", records)):
        d = str(tmp_path_factory.mktemp(f"records_{name}"))
        out[name] = (d, module.convert_hdr_real(*_pairs(real_dir), d, patch_size=64,
                                                patch_stride=64, log_every=0))
    return out


# --- copies -------------------------------------------------------------------


def test_read_ldr_equal(real_dir):
    for path in _pairs(real_dir)[1]:
        got, want = hdr_io.read_ldr(path), jhdr_io.read_ldr(path)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("patch", [(64, 64), (256, 64)])
def test_convert_hdr_real_writes_the_same_bytes_and_cross_reads(real_dir, tmp_path, patch):
    size, stride = patch
    dirs = {}
    for name, module in (("jax", jrecords), ("port", records)):
        dirs[name] = str(tmp_path / name)
        n = module.convert_hdr_real(*_pairs(real_dir), dirs[name], patch_size=size,
                                    patch_stride=stride, log_every=0)
        assert n > 0
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"]))
    assert any(n.endswith(".idx") for n in names) and any(n.endswith(".shdrec") for n in names)
    _, mismatch, errors = filecmp.cmpfiles(dirs["jax"], dirs["port"], names, shallow=False)
    assert not mismatch and not errors
    # each package reads the other's shards
    for reader, written in ((records.RecordDataset, "jax"), (jrecords.RecordDataset, "port")):
        ds, ref = reader(dirs[written]), jrecords.RecordDataset(dirs["jax"])
        assert len(ds) == len(ref)
        for i in (0, len(ds) // 2, len(ds) - 1):
            for a, b in zip(ds[i], ref[i]):
                assert a.dtype == b.dtype and a.shape == (size, size, 3)
                np.testing.assert_array_equal(a, b)


def test_patch_filter_and_origins_equal():
    rs = np.random.RandomState(2)
    for h, w in ((256, 256), (300, 300), (256, 320), (513, 700), (64, 65)):
        for size, stride in ((256, 64), (64, 64), (64, 32)):
            if h >= size and w >= size:
                assert list(records.iter_patch_origins(h, w, size, stride)) == \
                    list(jrecords.iter_patch_origins(h, w, size, stride))
    for scale in (1.0, 0.03, 40.0):  # mostly mid-grey, mostly dark, mostly saturated
        for _ in range(5):
            patch = np.clip(rs.rand(32, 32, 3) * 255 * scale, 0, 255).astype(np.uint8)
            assert records.patch_is_informative(patch) == jrecords.patch_is_informative(patch)


def test_tfrecord_copy_reads_and_writes_as_the_jax_one(record_dirs, tmp_path):
    rs = np.random.RandomState(3)
    blob = rs.bytes(1000)
    assert tfrecord.crc32c(blob) == jtfrecord.crc32c(blob)
    assert tfrecord.masked_crc(blob) == jtfrecord.masked_crc(blob)
    src = jrecords.RecordDataset(record_dirs["jax"][0])
    pairs = [src[i] for i in range(5)]
    for name, module in (("jax", jtfrecord), ("port", tfrecord)):
        module.write_reference_shards(str(tmp_path / name), pairs, records_per_shard=2)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    # gzip stamps the time: compare the uncompressed records
    for n in names:
        assert list(tfrecord.iter_tfrecord(str(tmp_path / "port" / n), verify=True)) == \
            list(jtfrecord.iter_tfrecord(str(tmp_path / "jax" / n), verify=True))
    got = tfrecord.TfrecordExampleDataset(str(tmp_path / "jax"))
    want = jtfrecord.TfrecordExampleDataset(str(tmp_path / "jax"))
    assert len(got) == len(want) == 5
    for i in range(5):
        for a, b, c in zip(got[i], want[i], pairs[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    assert isinstance(real.open_record_dataset(str(tmp_path / "jax")),
                      tfrecord.TfrecordExampleDataset)
    example = tfrecord.build_example({"a": b"xyz", "b": blob})
    assert example == jtfrecord.build_example({"a": b"xyz", "b": blob})
    assert tfrecord.parse_example(example) == {"a": b"xyz", "b": blob}


@pytest.mark.parametrize("training", [True, False])
def test_hdr_real_pipeline_yields_the_jax_batches(record_dirs, training):
    d, n = record_dirs["port"]
    got = real.HdrRealPipeline(d, batch_size=4, training=training, seed=5)
    want = jreal.HdrRealPipeline(d, batch_size=4, training=training, seed=5)
    assert len(got) == len(want) == n and got.steps_per_epoch() == want.steps_per_epoch()
    assert n % 4, "the records should leave a short tail batch"
    for _ in range(2):  # two epochs: the generator state carries over
        batches = list(zip(got.epoch(), want.epoch(), strict=True))
        assert len(batches) == want.steps_per_epoch()
        for (gl, gh), (wl, wh) in batches:
            assert gl.dtype == wl.dtype == np.float32 and gl.shape[-1] == 3
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gh, wh)
        assert batches[-1][0][0].shape[0] == n % 4


def test_validation_and_test_datasets_give_the_same_items(tmp_path):
    rs = np.random.RandomState(4)
    for i in range(21):  # every 20th file is held out: two test files
        img = (rs.rand(16, 24, 3).astype(np.float32) * 3) ** 2
        big = np.kron(img, np.ones((32, 32, 1), np.float32))
        jhdr_io.write_hdr(str(tmp_path / f"s{i:02d}.hdr"), big)
    for name in ("get_validation_dataset", "get_test_dataset"):
        got, want = getattr(synth, name)(str(tmp_path)), getattr(jsynth, name)(str(tmp_path))
        assert len(got) == len(want) > 0
        for i in (0, len(want) // 3, len(want) - 1):
            for a, b in zip(got[i], want[i], strict=True):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- metrics ------------------------------------------------------------------


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


@pytest.mark.parametrize("shape", [(2, 32, 48, 3), (1, 4, 3, 3), (2, 7, 12, 1), (1, 64, 64, 3)])
def test_psnr_and_ssim_match_jax(shape):
    """Within 1e-5 absolute; (1, 4, 3, 3) and (2, 7, 12, 1) are narrower than
    the 5-pixel symmetric pad, which reflects again off the far border."""
    rs = np.random.RandomState(sum(shape))
    a = rs.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.1 * rs.randn(*shape), 0, 1).astype(np.float32)
    for max_val in (1.0, 2.5):
        for fn, jfn in ((metrics.psnr, jmetrics.psnr), (metrics.ssim, jmetrics.ssim)):
            got = float(fn(_nchw(a), _nchw(b), max_val=max_val))
            want = float(jfn(jnp.asarray(a), jnp.asarray(b), max_val=max_val))
            assert abs(got - want) <= 1e-5, (fn.__name__, max_val, got, want)


def test_metrics_writer_logs_a_histogram(tmp_path):
    writer = metrics.MetricsWriter(str(tmp_path))
    writer.histogram("ref/out_histogram", torch.rand(2, 3, 8, 8), 1)
    writer.close()
    (event,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    with open(event, "rb") as f:
        assert b"ref/out_histogram" in f.read()


# --- tiled inference ----------------------------------------------------------


def test_feather_weights_and_tile_origins():
    for size, halo in ((8, 2), (64, 16), (512, 64), (16, 0)):
        np.testing.assert_array_equal(_feather_weights(size, halo), jax_feather_weights(size, halo))
    w = _feather_weights(8, 2)
    np.testing.assert_allclose(w[2:6], 1.0)
    assert w[0] < w[1] < 1.0
    assert tile_origins(1024, 512, 384) == [0, 384, 512]
    assert tile_origins(1536, 512, 384) == [0, 384, 768, 1024]
    assert tile_origins(192, 64, 32) == [0, 32, 64, 96, 128]


@pytest.fixture(scope="module")
def pipeline_pair():
    variables = seeded_variables(jm.ReverseCameraPipeline(), (1, 64, 64, 3), seed=7)
    return variables, load_jax_variables(tm.ReverseCameraPipeline(), variables).eval()


@pytest.mark.parametrize("hw, tile, halo", [((100, 140), 192, 16), ((128, 192), 64, 16)])
def test_tiled_predictor_matches_jax(pipeline_pair, hw, tile, halo):
    """One tile (100x140 padded to 192^2) and 15 tiles (tile 64, halo 16), each
    with the invCRF of a 64^2 view; within ATOL (tests/test_torch_models.py)."""
    variables, pipe = pipeline_pair
    img = np.random.RandomState(8).rand(*hw, 3).astype(np.float32)
    want = JaxTiledPredictor(variables, tile=tile, halo=halo, invcrf_view=64)(img)
    got = TiledPredictor(pipe, tile=tile, halo=halo, invcrf_view=64)(img)
    assert got.shape == want.shape == (*hw, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_tiled_predictor_rejects_a_tile_off_the_64_grid(pipeline_pair):
    with pytest.raises(ValueError, match="multiple of 64"):
        TiledPredictor(pipeline_pair[1], tile=100)


# --- the finetune loop --------------------------------------------------------


def test_run_real_finetune_matches_jax(tmp_path):
    """One epoch of both loops from the same weights over the same 64^2
    records (9 patches: two batches of 4 and a tail of 1, shuffled and
    augmented by the same seed).  The epoch loss (the mean of the steps'
    aux loss_ref) agrees within 1e-5 relative: the steps' losses agree to
    1e-5 (tests/test_torch_train.py), and each Adam step moves both sets
    of weights by ~lr = 1e-5 in the same direction."""
    d = write_real_tree(str(tmp_path / "real"), [(192, 192)], 9)
    rec = str(tmp_path / "records")
    assert records.convert_hdr_real(*_pairs(d), rec, patch_size=64, patch_stride=64,
                                    log_every=0) == 9
    lr = 1e-5
    variables = seeded_variables(jm.ReverseCameraPipeline(), (1, 64, 64, 3), seed=10)

    tx = jax_make_optimizer(lr)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = NetState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                      opt_state=tx.init(params), tx=tx)
    jloop.run_real_finetune(state=jstate, step_fn=jsteps.make_finetune_train_step(),
                            pipeline=jreal.HdrRealPipeline(rec, batch_size=4, seed=0), epochs=1,
                            ckpt_dir=str(tmp_path / "jax_ckpt"), log_dir=str(tmp_path / "jax_log"),
                            writer=JaxMetricsWriter(str(tmp_path / "jax_log"),
                                                    use_tensorboard=False))

    def port_state():
        nets = load_jax_variables(nn.ModuleDict({n: NETS[n]() for n in NETS}), variables)
        return TrainState(nets, make_optimizer(nets.parameters(), lr))

    state = port_state()
    loop.run_real_finetune(state=state, step_fn=steps.make_finetune_train_step(),
                           pipeline=real.HdrRealPipeline(rec, batch_size=4, seed=0), epochs=1,
                           ckpt_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "log"))

    def logged(log_dir, tag):
        with open(os.path.join(log_dir, "events.jsonl")) as f:
            return [json.loads(line)[tag] for line in f if tag in line]

    want, got = logged(tmp_path / "jax_log", "ref/loss"), logged(tmp_path / "log", "ref/loss")
    assert len(got) == len(want) == 1 and np.isfinite(got[0])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert state.step == 3  # the tail batch is trained
    assert CheckpointManager(str(tmp_path / "ckpt")).steps() == [3]
    assert len(logged(tmp_path / "log", "ref/epoch_time_s")) == 1
    (event,) = glob.glob(str(tmp_path / "log" / "events.out.tfevents.*"))
    with open(event, "rb") as f:
        body = f.read()
    assert b"ref/out_histogram" in body and b"ref/out/0" in body

    # a second call resumes from the checkpoint and trains one more epoch
    state2 = port_state()
    loop.run_real_finetune(state=state2, step_fn=steps.make_finetune_train_step(),
                           pipeline=real.HdrRealPipeline(rec, batch_size=4, seed=0), epochs=1,
                           ckpt_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "log2"))
    assert state2.step == 6 and CheckpointManager(str(tmp_path / "ckpt")).steps() == [3, 6]


def test_lagged_readback_keeps_order_and_lag():
    lag = loop.LaggedReadback(lag=2)
    for i in range(5):
        lag.push(torch.tensor([float(i), -float(i)]))
        assert len(lag._pending) == min(i + 1, 2)
    assert [v.tolist() for v in lag.drain()] == [[float(i), -float(i)] for i in range(5)]


# --- HDR-Synth validation -----------------------------------------------------


def test_synth_metrics_match_jax_on_one_capture():
    """validate_synth's three metrics on one capture, the same in both: the
    capture is JAX's simulate_capture, and the port's capture_chain given
    the fields that draw took (tests/test_torch_train_ops.py); deq and lin
    seeded and bridged.  PSNRs within 1e-4 dB, the curve MSE within 1e-5
    relative (f32 sum order)."""
    rs = np.random.RandomState(12)
    b, h, w = 2, 32, 32
    hdr = (rs.rand(b, h, w, 3) * 2).astype(np.float32)
    crf = np.asarray(jcurves.monotonic_rf(jnp.asarray(rs.rand(b, 1024).astype(np.float32))))
    invcrf = np.asarray(jcurves.monotonic_rf(jnp.asarray(rs.rand(b, 1024).astype(np.float32))))
    t = rs.uniform(0.5, 4, b).astype(np.float32)
    key = jax.random.PRNGKey(0)
    jsim = jdeg.simulate_capture(key, jnp.asarray(hdr), jnp.asarray(crf), jnp.asarray(t))
    k_s, k_c, k_ns, k_nc = jax.random.split(key, 4)
    noise = degradation.CaptureNoise(
        _nchw(np.asarray(jdeg.SHOT_SIGMA * jax.random.uniform(k_s, (b, 1, 1, 3)))),
        _nchw(np.asarray(jdeg.READ_SIGMA * jax.random.uniform(k_c, (b, 1, 1, 3)))),
        _nchw(np.asarray(jax.random.normal(k_ns, hdr.shape))),
        _nchw(np.asarray(jax.random.normal(k_nc, hdr.shape))))
    sim = degradation.capture_chain(_nchw(hdr), torch.from_numpy(crf), torch.from_numpy(t), noise)

    dv = seeded_variables(jm.DequantizationNet(), (b, h, w, 3), seed=13)
    lv = seeded_variables(jm.LinearizationNet(), (b, h, w, 3), seed=14)
    # the JAX CLI's metrics (singlehdr_tpu/cli/validate_synth.py), on its capture
    jpeg = jsim.quantized_u8.astype(jnp.float32) / 255.0
    c_pred = jnp.clip(jm.DequantizationNet().apply(dv, jpeg), 0.0, 1.0)
    pred_invcrf = jm.LinearizationNet().apply(lv, jsim.ldr)
    b_pred = jcurves.apply_rf(jsim.ldr, pred_invcrf)
    want = [float(jmetrics.psnr(c_pred, jsim.ldr)),
            float(jmetrics.psnr(b_pred, jsim.clipped_hdr_t)),
            float(jnp.mean(jnp.square(pred_invcrf - invcrf)))]

    nets = nn.ModuleDict({"deq": load_jax_variables(tm.DequantizationNet(), dv),
                          "lin": load_jax_variables(tm.LinearizationNet(), lv)}).eval()
    got = synth_metrics(nets, sim, torch.from_numpy(invcrf)).tolist()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
