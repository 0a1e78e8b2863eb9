"""CPU parity of the PyTorch port's ops and kernel plain versions against the
JAX package.

Inputs come from ``np.random.RandomState`` and go through both packages.
The four kernel wrappers (K1-K4) are held to the JAX package's own oracles:
``apply_rf`` (xla and the Pallas kernel in interpret mode) and the
``_xla_reference`` of the three Mosaic kernels, which do not run in the CPU
interpreter.  Tolerance is the golden 2e-5 absolute unless stated; K1 must
be bit-equal.
"""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlehdr_tpu.ops import curves as jcurves
from singlehdr_tpu.ops import histogram as jhist
from singlehdr_tpu.ops import masks as jmasks
from singlehdr_tpu.ops import resize as jresize
from singlehdr_tpu.ops.color import vgg_preprocess as j_vgg_preprocess
from singlehdr_tpu.ops.pallas import apply_rf_pallas as jk1
from singlehdr_tpu.ops.pallas import enc_pool_pallas as jk4
from singlehdr_tpu.ops.pallas import lin_stem_pallas as jk3
from singlehdr_tpu.ops.pallas import unet_stage_pallas as jk2
from singlehdr_tpu_torch import ops
from singlehdr_tpu_torch.ops import cuda as kernels
from singlehdr_tpu_torch.ops.cuda import apply_rf_cuda
from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf_plain
from singlehdr_tpu_torch.ops.cuda.enc_pool_cuda import encoder_stage2_plain
from singlehdr_tpu_torch.ops.cuda.lin_stem_cuda import lin_feature_stem_plain
from singlehdr_tpu_torch.ops.cuda.unet_stage_cuda import unet_stage2_plain

from test_torch_apply_rf_bwd import VEC as K1_VEC
from test_torch_apply_rf_bwd import k1_block_steps

ATOL = 2e-5  # tests/test_golden.py
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _hwio_to_oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def _glorot(rs, shape):
    fan = np.prod(shape[:-1]) + np.prod(shape[:-2]) * shape[-1]
    lim = np.sqrt(6.0 / fan)
    return rs.uniform(-lim, lim, shape).astype(np.float32)


def _curves(rs, b, k=1024):
    raw = rs.rand(b, k).astype(np.float32)
    return np.array(jcurves.monotonic_rf(jnp.asarray(raw)))


# --- K1: apply_rf ---------------------------------------------------------


def test_apply_rf_bit_equal_to_jax_xla_and_pallas_interpret():
    rs = np.random.RandomState(0)
    x = (rs.rand(2, 3, 17, 23) * 1.2 - 0.1).astype(np.float32)  # [-0.1, 1.1]
    rf = _curves(rs, 2)
    got = apply_rf_plain(torch.from_numpy(x), torch.from_numpy(rf)).numpy()
    want_xla = np.asarray(jcurves.apply_rf(jnp.asarray(x), jnp.asarray(rf), impl="xla"))
    want_pallas = np.asarray(
        jk1.apply_rf_pallas(jnp.asarray(x), jnp.asarray(rf), interpret=True)
    )
    np.testing.assert_array_equal(got, want_xla)
    # The interpreter lowers the Pallas kernel's lerp v0 + frac*(v1-v0) to an
    # FMA on the CPU (one rounding), where the xla form and the port round
    # each op: the two JAX forms themselves differ by 1 ulp on a few pixels.
    np.testing.assert_array_max_ulp(got, want_pallas, maxulp=1)
    assert (got != want_pallas).mean() < 0.01


def _k1_writes(b, n, bps, x_off, out_off):
    """Write count of every pixel in one K1 launch: the block -> pixel map of
    csrc/apply_rf.cu, which K1 and K1-bwd share (``k1_block_steps``), with x
    and out starting x_off and out_off floats past a 16-byte boundary."""
    counts = np.zeros((b, n), np.int64)
    for s in range(b):
        for bi in range(bps):
            for step in k1_block_steps(n, bps, bi, (x_off + s * n, out_off + s * n), K1_VEC):
                np.add.at(counts[s], step[step >= 0], 1)
    return counts


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_k1_block_map_writes_every_pixel_once(b, r):
    """For n % 4 = r, b samples (whose bases s * n move the alignment), x at a
    16-byte boundary or 4 and 8 bytes past it, out matching x or not, and the
    grid of ``blocks_per_sample`` as well as a few forced widths."""
    n = 3 * 40 * 40 + 4 * 4096 + r
    for bps in {apply_rf_cuda.blocks_per_sample(b, n, 132), 1, 7}:
        for x_off, out_off in ((0, 0), (1, 1), (2, 2), (1, 0)):
            counts = _k1_writes(b, n, bps, x_off, out_off)
            assert (counts == 1).all(), (bps, x_off, out_off)


def test_k1_grid_fills_the_card_and_spreads_each_curve_staging():
    """b4 at 576^2 on 132 SMs: 132 blocks a sample (4 a SM), each over ~7.5 k
    pixels; a tiny sample takes one block."""
    bps = apply_rf_cuda.blocks_per_sample
    assert bps(4, 3 * 576 * 576, 132) == 132
    assert bps(16, 3 * 256 * 256, 132) == 33
    assert bps(1, 100, 132) == 1 and bps(1024, 3 * 576 * 576, 132) == 1


def test_apply_rf_and_monotonic_rf_match_golden():
    x = np.random.RandomState(3).rand(2, 16, 16, 3).astype(np.float32) * 1.2 - 0.1
    raw = np.random.RandomState(4).rand(2, 1024).astype(np.float32)
    rf = ops.monotonic_rf(torch.from_numpy(raw))
    np.testing.assert_allclose(
        rf.numpy(), np.asarray(jcurves.monotonic_rf(jnp.asarray(raw))), atol=1e-6
    )
    got = ops.apply_rf(torch.from_numpy(x), rf).numpy()
    want = np.load(os.path.join(GOLDEN_DIR, "apply_rf.npz"))["value"]
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_decode_invcrf_matches_jax():
    from singlehdr_tpu.calib import load_inverse_emor

    inv = load_inverse_emor()
    w = np.random.RandomState(1).randn(3, 11).astype(np.float32)
    g0, hinv = inv.mean.astype(np.float32), inv.basis.astype(np.float32)
    got = ops.decode_invcrf(torch.from_numpy(w), torch.from_numpy(g0), torch.from_numpy(hinv))
    want = jcurves.decode_invcrf(jnp.asarray(w), jnp.asarray(g0), jnp.asarray(hinv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# --- elementwise / resampling ops ------------------------------------------


def test_linearization_features_match_golden():
    x = np.random.RandomState(3).rand(2, 16, 16, 3).astype(np.float32) * 1.2 - 0.1
    feats = ops.linearization_features(_nchw(np.clip(x, 0, 1)))
    want = np.load(os.path.join(GOLDEN_DIR, "lin_features.npz"))["value"]
    np.testing.assert_allclose(_nhwc(feats)[:, ::4, ::4, :], want, atol=ATOL)


def test_linearization_features_match_jax_odd_shape():
    x = np.random.RandomState(5).rand(1, 11, 14, 3).astype(np.float32)
    got = _nhwc(ops.linearization_features(_nchw(x)))
    want = np.asarray(jhist.linearization_features(jnp.asarray(x)))
    assert got.shape == want.shape == (1, 11, 14, 93)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("hw", [(8, 12), (5, 7)])
def test_resize_and_pools_match_jax(hw):
    x = np.random.RandomState(6).randn(2, *hw, 4).astype(np.float32)
    t = _nchw(x)
    np.testing.assert_allclose(
        _nhwc(ops.resize_bilinear_x2(t)),
        np.asarray(jresize.resize_bilinear_x2(jnp.asarray(x))), atol=ATOL,
    )
    np.testing.assert_allclose(
        _nhwc(ops.avg_pool_2x2(t)), np.asarray(jresize.avg_pool_2x2(jnp.asarray(x))),
        atol=ATOL,
    )
    for window, stride in ((3, 2), (2, 2)):
        np.testing.assert_array_equal(
            _nhwc(ops.max_pool(t, window, stride)),
            np.asarray(jresize.max_pool(jnp.asarray(x), window, stride, "SAME")),
        )


def test_color_and_highlight_alpha_match_jax():
    rs = np.random.RandomState(7)
    x = (rs.rand(2, 6, 5, 3) * 1.3).astype(np.float32)
    mean = np.asarray([103.939, 116.779, 123.68], np.float32)
    np.testing.assert_allclose(
        _nhwc(ops.vgg_preprocess(_nchw(x), torch.from_numpy(mean))),
        np.asarray(j_vgg_preprocess(jnp.asarray(x), jnp.asarray(mean))), atol=1e-4,
    )
    np.testing.assert_allclose(
        _nhwc(ops.highlight_alpha(_nchw(x))),
        np.asarray(jmasks.highlight_alpha(jnp.asarray(x))), atol=ATOL,
    )
    np.testing.assert_array_equal(_nhwc(ops.bgr_to_rgb(_nchw(x))), x[..., ::-1])


# --- K2, K3, K4 plain versions vs the JAX oracles ---------------------------


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("c", [3, 9, 16, 32])
def test_unet_stage2_plain_matches_jax_reference(k, c):
    rs = np.random.RandomState(10 * k + c)
    f = 16
    x = rs.rand(2, 12, 20, c).astype(np.float32)
    w1, w2 = _glorot(rs, (k, k, c, f)), _glorot(rs, (k, k, f, f))
    b1, b2 = (rs.randn(f) * 0.1).astype(np.float32), (rs.randn(f) * 0.1).astype(np.float32)
    want_pool, want_act = jk2._xla_reference(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2)
    )
    pooled, act = unet_stage2_plain(
        _nchw(x), _hwio_to_oihw(w1), torch.from_numpy(b1), _hwio_to_oihw(w2),
        torch.from_numpy(b2),
    )
    np.testing.assert_allclose(_nhwc(act), np.asarray(want_act), atol=ATOL)
    np.testing.assert_allclose(_nhwc(pooled), np.asarray(want_pool), atol=ATOL)


@pytest.mark.parametrize("c,hw", [(3, (12, 20)), (64, (13, 9))])
def test_encoder_stage2_plain_matches_jax_reference(c, hw):
    rs = np.random.RandomState(c)
    f = 16
    x = (rs.rand(1, *hw, c) * 50).astype(np.float32)
    w1, w2 = _glorot(rs, (3, 3, c, f)), _glorot(rs, (3, 3, f, f))
    b1, b2 = (rs.randn(f) * 0.1).astype(np.float32), (rs.randn(f) * 0.1).astype(np.float32)
    want_pool, want_act = jk4._xla_reference(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2)
    )
    pooled, act = encoder_stage2_plain(
        _nchw(x), _hwio_to_oihw(w1), torch.from_numpy(b1), _hwio_to_oihw(w2),
        torch.from_numpy(b2),
    )
    # |values| ~ 1e2 here: 2e-5 relative to the output scale
    scale = float(np.abs(want_act).max())
    np.testing.assert_allclose(_nhwc(act), np.asarray(want_act), atol=ATOL * scale)
    np.testing.assert_allclose(_nhwc(pooled), np.asarray(want_pool), atol=ATOL * scale)


@pytest.mark.parametrize("hw", [(40, 56), (37, 50)])
def test_lin_feature_stem_plain_matches_jax_reference(hw):
    rs = np.random.RandomState(hw[0])
    x = rs.rand(2, *hw, 3).astype(np.float32)
    k7 = _glorot(rs, (7, 7, 93, 64))
    bias = (rs.randn(64) * 0.1).astype(np.float32)
    want = np.asarray(jk3._xla_reference(jnp.asarray(x), jnp.asarray(k7), jnp.asarray(bias)))
    got = _nhwc(lin_feature_stem_plain(_nchw(x), _hwio_to_oihw(k7), torch.from_numpy(bias)))
    assert got.shape == want.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 64)
    # the border rows/cols carry the reflect-Sobel and zero-stack rules
    for sl in (np.s_[:, :3], np.s_[:, -3:], np.s_[:, :, :3], np.s_[:, :, -3:]):
        np.testing.assert_allclose(got[sl], want[sl], atol=ATOL)
    np.testing.assert_allclose(got, want, atol=ATOL)


# --- dispatch rules ---------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    kernels.reset_launches()
    rs = np.random.RandomState(11)
    x = torch.from_numpy(rs.rand(1, 3, 8, 8).astype(np.float32))
    rf = torch.from_numpy(_curves(rs, 1))
    w1, w2 = torch.randn(16, 3, 3, 3), torch.randn(16, 16, 3, 3)
    b = torch.zeros(16)
    assert torch.equal(kernels.apply_rf(x, rf), apply_rf_plain(x, rf))
    for wrapper, plain in (
        (kernels.unet_stage2, unet_stage2_plain),
        (kernels.encoder_stage2, encoder_stage2_plain),
    ):
        for got, want in zip(wrapper(x, w1, b, w2, b), plain(x, w1, b, w2, b)):
            assert torch.equal(got, want)
    k7, b64 = torch.randn(64, 93, 7, 7) * 0.01, torch.zeros(64)
    assert torch.equal(kernels.lin_feature_stem(x, k7, b64), lin_feature_stem_plain(x, k7, b64))
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


def test_non_cpu_non_cuda_tensors_raise():
    x = torch.empty(1, 3, 8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.apply_rf(x, torch.empty(1, 1024, device="meta"))
    w = torch.empty(16, 3, 3, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.unet_stage2(x, w, w[:, 0, 0, 0], w, w[:, 0, 0, 0])


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import singlehdr_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(singlehdr_tpu_torch.__path__, 'singlehdr_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'singlehdr_tpu_torch.tools.quality_anchor', 'singlehdr_tpu_torch.precision'} <= set(names)\n"
        "singlehdr_tpu_torch.calib.get_crf_bank()\n"
        "singlehdr_tpu_torch.data.native_jpeg.available()\n"
        "import tempfile\n"
        "import chip_smoke\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    chip_smoke.write_hdr_files(d, 1)\n"
        "    chip_smoke.write_real_pairs(d, 1)\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'tensorflow') if m in sys.modules]\n"
        "bad += [m for m in sys.modules if m == 'singlehdr_tpu' or m.startswith('singlehdr_tpu.')]\n"
        "assert not bad, bad\n"
    )
    # the smoke script itself names no module of the JAX package
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    named = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    named += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in named if m.split(".")[0] in ("singlehdr_tpu", "jax", "flax", "optax",
                                                       "tensorflow")]
    # nor does any string of the tools (a stage's module name is a string the
    # imports above cannot see)
    tools = os.path.join(ROOT, "singlehdr_tpu_torch", "tools")
    for name in sorted(os.listdir(tools)):
        if name.endswith(".py"):
            with open(os.path.join(tools, name)) as f:
                tree = ast.parse(f.read())
            strings = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)]
            assert not [s for s in strings if "singlehdr_tpu." in s], name
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("b,n,seed", [(2, 3 * 32 * 32, 0), (4, 3 * 48 * 40, 1)])
def test_chip_smoke_k1_library_route_is_k1(b, n, seed):
    """The library route that chip_smoke times beside K1 (grid_sample) computes
    ``apply_rf_plain`` on the smoke run's own K1-bwd inputs (values outside
    [0, 1], exact 0 and 1, bin edges)."""
    from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf_plain

    cs = _chip_smoke()
    x, rf, _ = cs.k1_bwd_inputs(torch.device("cpu"), b, n, seed)
    assert cs.k1_library_error(x, rf, apply_rf_plain(x, rf)) <= 1e-6


@pytest.mark.parametrize("b,n,seed", [(2, 3 * 32 * 32, 0), (4, 3 * 48 * 40, 1), (16, 3 * 16 * 16, 2)])
def test_chip_smoke_k1_bwd_library_route_is_k1_bwd(b, n, seed):
    """The library route that chip_smoke times beside K1-bwd (grid_sample's
    backward) gives the curve gradient of ``apply_rf_bwd_plain`` within 1e-5
    of float64, and its gx away from the lerp's kinks within 1e-6."""
    from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf_bwd_plain

    cs = _chip_smoke()
    x, rf, g = cs.k1_bwd_inputs(torch.device("cpu"), b, n, seed)
    gx, _ = apply_rf_bwd_plain(x, rf, g, True, False)
    _, grf = apply_rf_bwd_plain(x.double(), rf.double(), g.double(), False, True)
    grf_rel, gx_rel, kinks = cs.k1_bwd_library_error(x, rf, g, gx, grf)
    assert grf_rel <= 1e-5 and gx_rel <= 1e-6
    assert kinks < x.numel() // 2  # most pixels are compared


@pytest.mark.parametrize("fault", [None, "lost", "misplaced", "doubled"])
@pytest.mark.parametrize("inputs", ["clipped", "8-bit"])
def test_chip_smoke_k1_bwd_bin_check_flags_a_term_in_a_small_bin(inputs, fault):
    """Phase 12's K1-bwd check (``bin_rel_error`` against
    ``k1_bwd_term_sums``): the f32 plain version's curve gradient is within
    BWD_REL_TOL of each bin's mass, and one term lost, moved to the next bin
    or added twice, in the least-filled bin below the top, breaks that bound
    beside a bin 1023 that holds a fifth of the pixels (as on a finetune
    C_pred) or with 8-bit input."""
    from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf_bwd_plain

    cs = _chip_smoke()
    rs = np.random.RandomState(7)
    b, n, k = 2, 3 * 64 * 64, 1024
    x = rs.rand(b, n).astype(np.float32)
    if inputs == "clipped":
        x[:, : n // 5] = 1.0
    else:
        x = np.round(x * 255).astype(np.float32) / 255
    x = torch.from_numpy(x)
    rf = torch.from_numpy(np.cumsum(rs.rand(b, k), 1).astype(np.float32))
    rf = rf / rf[:, -1:]
    g = torch.from_numpy(rs.randn(b, n).astype(np.float32))
    _, grf = apply_rf_bwd_plain(x, rf, g, False, True)
    sums, mass = cs.k1_bwd_term_sums(x, k, g)
    if fault is None:
        assert cs.bin_rel_error(grf, sums, mass) <= cs.BWD_REL_TOL
        return
    i0 = torch.floor(x[0] * (k - 1)).long()
    counts = torch.bincount(i0, minlength=k).double()
    counts[counts == 0] = np.inf
    counts[k - 1] = np.inf
    k0 = int(counts.argmin())
    members = (i0 == k0).nonzero()[:, 0]
    w0 = (1 - (x[0, members] * (k - 1) - k0)) * g[0, members]
    w = w0[w0.abs().argmax()]
    bad = grf.clone()
    bad[0, k0] += {"lost": -w, "misplaced": -w, "doubled": w}[fault]
    if fault == "misplaced":
        bad[0, k0 + 1] += w
    assert cs.bin_rel_error(bad, sums, mass) > max(cs.BWD_REL_TOL, 2 * cs.bin_rel_error(grf, sums, mass))


@pytest.mark.parametrize("hw", [(37, 53), (40, 56)])
def test_chip_smoke_k3_library_route_is_k3(hw):
    """The library route that chip_smoke times beside K3 (the conv over the
    93-channel stack built beforehand, SAME-padded) computes
    ``lin_feature_stem_plain``."""
    rs = np.random.RandomState(hw[1])
    x = torch.from_numpy(rs.rand(1, 3, *hw).astype(np.float32))
    k7 = _hwio_to_oihw(_glorot(rs, (7, 7, 93, 64)))
    b7 = torch.from_numpy((rs.randn(64) * 0.1).astype(np.float32))
    cs = _chip_smoke()
    feats = cs.lin_stem_features(x)
    assert feats.shape[1] == 93
    assert cs.k3_library_error(feats, k7, b7, lin_feature_stem_plain(x, k7, b7)) <= 1e-6


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device (this machine), in the checkout and alone in a
    directory: a non-zero exit and no result line."""
    import shutil

    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd, script in ((ROOT, "chip_smoke.py"), (str(tmp_path), str(alone))):
        proc = subprocess.run(
            [sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
