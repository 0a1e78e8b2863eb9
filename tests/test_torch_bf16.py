"""The port's bf16 compute dtype on the CPU, against the JAX package in bf16.

The JAX package's main configuration computes in bf16: bf16 activations and
conv operands, f32 parameters, f32 accumulation and f32 LUT math.  The port
follows it with a ``dtype`` on every net; K2, K3 and K4 have bf16 kernels
(``csrc/conv2_pool.cu``, ``csrc/lin_stem.cu``) whose plain versions compute
what the kernels compute.  Here, on seeded inputs and weights carried across
by ``convert.py``:

  (a) the bf16 plain versions of K2, K3, K4 against the JAX functions in
      bf16 (``_xla_reference``, as the JAX package's own CPU tests run
      them), and K2's pool taken before the rounding (at most one bf16 ulp
      from pooling the rounded skip);
  (b) each net in bf16 against the Flax net in bf16, and the f32 outputs;
  (c) the pipeline: PSNR(port bf16, JAX f32) >= PSNR(JAX bf16, JAX f32) - 3 dB;
  (d) the bf16 backward: each layer kind's VJP against Flax's (they round at
      the same points), a bias gradient summed in f32, and one bf16 joint
      step against ``make_joint_train_step(vgg, jnp.bfloat16)``;
  (e) the bf16 kernels' index maps in numpy: K padded to 16, the core
      matrices as wgmma and mma.sync read them, the packing of two bf16 into
      an A register, the staged tile's banks, and a lane-by-lane launch of
      K2/K4 and of K3 held to the plain versions;
  (f) ``--dtype bfloat16`` through the two training CLIs;
  (g) the argument checks: mixed dtypes and a bf16 tensor at K1 raise.

A bf16 value carries 8 significant bits: one ulp is 2^-8 to 2^-7 of its
magnitude.  Each bound below is stated in those terms with what was measured.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from singlehdr_tpu import models as jm
from singlehdr_tpu.models import hallucination as jhal
from singlehdr_tpu.models import layers as jl
from singlehdr_tpu.models import linearization as jlin
from singlehdr_tpu.models.vgg16 import Vgg16Features as JVgg16Features
from singlehdr_tpu.ops import curves as jcurves
from singlehdr_tpu.ops import histogram as jhist
from singlehdr_tpu.ops.pallas import enc_pool_pallas as jk4
from singlehdr_tpu.ops.pallas import lin_stem_pallas as jk3
from singlehdr_tpu.ops.pallas import unet_stage_pallas as jk2
from singlehdr_tpu.train import steps as jsteps
from singlehdr_tpu_torch import models as tm
from singlehdr_tpu_torch.models import hallucination as thal
from singlehdr_tpu_torch.models import layers as tl
from singlehdr_tpu_torch.models import linearization as tlin
from singlehdr_tpu_torch.convert import from_jax_variables, load_jax_variables
from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
from singlehdr_tpu_torch.ops import cuda as kernels
from singlehdr_tpu_torch.ops.cuda import apply_rf_cuda
from singlehdr_tpu_torch.ops.cuda import conv_gemm as cg
from singlehdr_tpu_torch.ops.cuda import lin_stem_cuda as k3
from singlehdr_tpu_torch.ops.cuda.enc_pool_cuda import encoder_stage2_plain
from singlehdr_tpu_torch.ops.cuda.unet_stage_cuda import check_stage, unet_stage2_plain
from singlehdr_tpu_torch.ops.histogram import N_FEATURES, linearization_features
from singlehdr_tpu_torch.ops.resize import same_pads
from singlehdr_tpu_torch.train import steps
from singlehdr_tpu_torch.train.state import TrainState, make_optimizer

from test_torch_lin_stem_gemm import _feature, _gather_offsets, _reflect_clamp
from test_torch_models import seeded_variables
from test_torch_train import _jax_state, _port_args, _recording_tx, _variables

BF16 = torch.bfloat16
ULP = 2.0 ** -8  # a bf16 ulp relative to a value in [1, 2): 2^-7; bounds use 2^-8 of a max


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _hwio_to_oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def _glorot(rs, shape):
    fan = np.prod(shape[:-1]) + np.prod(shape[:-2]) * shape[-1]
    return rs.uniform(-1, 1, shape).astype(np.float32) * np.sqrt(6.0 / fan).astype(np.float32)


def _round_bf16(a):
    """numpy f32 -> the nearest bf16 value (ties to even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16).float().numpy()


def _ulp_bf16(v):
    """The bf16 ulp at each |v| (2^(e - 7) for |v| in [2^e, 2^(e+1)))."""
    _, e = np.frexp(np.abs(v).astype(np.float64))
    return np.ldexp(1.0, e - 8)


# --- (a) K2, K3, K4 bf16 plain versions vs the JAX functions in bf16 ----------

# The plain versions round once per stored tensor (f32 sums of exact bf16
# products); XLA's bf16 reference rounds the conv output, then the bias add,
# then the activation.  Measured here: K2 <= 3.9e-3 of max|ref| (one ulp of
# the largest value), K4 <= 3.6e-3.  Bound: 2 ulps of the max.  K3 also
# differs in its features (XLA rounds its bf16 Sobel sums; see below):
# measured 9.0e-3 and 6.3e-3, where JAX's own bf16 stem is 1.15e-2 and
# 1.23e-2 from its f32 stem and the port's 1.01e-2 and 1.22e-2.  Bound: 4 ulps.
KERNEL_BF16_TOL = 2 * ULP
STEM_BF16_TOL = 4 * ULP


@pytest.mark.parametrize("k,c", [(7, 3), (7, 9), (7, 16), (5, 16), (3, 32)])
def test_unet_stage2_bf16_plain_matches_jax_reference_in_bf16(k, c):
    rs = np.random.RandomState(100 + 10 * k + c)
    f = 16 if c < 16 else 2 * c
    x = rs.rand(2, 12, 20, c).astype(np.float32)
    w1, w2 = _glorot(rs, (k, k, c, f)), _glorot(rs, (k, k, f, f))
    b1, b2 = (rs.randn(f) * 0.1).astype(np.float32), (rs.randn(f) * 0.1).astype(np.float32)
    want_pool, want_act = jk2._xla_reference(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        jnp.asarray(b2))
    assert want_act.dtype == jnp.bfloat16
    pooled, act = unet_stage2_plain(_nchw(x).to(BF16), _hwio_to_oihw(w1).to(BF16),
                                    torch.from_numpy(b1), _hwio_to_oihw(w2).to(BF16),
                                    torch.from_numpy(b2))
    assert pooled.dtype == act.dtype == BF16
    want_act, want_pool = np.asarray(want_act, np.float32), np.asarray(want_pool, np.float32)
    scale = np.abs(want_act).max()
    assert np.abs(_nhwc(act) - want_act).max() <= KERNEL_BF16_TOL * scale
    assert np.abs(_nhwc(pooled) - want_pool).max() <= KERNEL_BF16_TOL * scale


def test_unet_stage2_bf16_pools_before_rounding():
    """The bf16 K2 (kernel and plain version) pools conv2's f32 values and
    rounds once.  Pooling the rounded skip instead, as ``_xla_reference``
    does, moves each pooled value by at most half a bf16 ulp of the largest
    skip value in its window (the mean of the skip's rounding errors) plus
    half an ulp of each rounded pool: within one ulp of the larger of the
    pooled value and that window maximum (measured: up to 1.0 of it; 22 % of
    the values differ, so the rule is observable).  Near cancellation (a
    leaky window of both signs) that is many ulps of the pooled value itself."""
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.rand(2, 16, 24, 24).astype(np.float32)).to(BF16)
    w1 = torch.from_numpy(_glorot(rs, (32, 16, 5, 5))).to(BF16)
    w2 = torch.from_numpy(_glorot(rs, (32, 32, 5, 5))).to(BF16)
    b1, b2 = torch.from_numpy(rs.randn(32).astype(np.float32) * 0.1), torch.zeros(32)
    pooled, act = unet_stage2_plain(x, w1, b1, w2, b2)
    from_rounded = F.avg_pool2d(act.float(), 2).to(BF16).float().numpy()
    window_max = F.max_pool2d(act.float().abs(), 2).numpy()
    got = pooled.float().numpy()
    diff = np.abs(got - from_rounded)
    assert (diff <= _ulp_bf16(np.maximum(np.abs(got), window_max))).all()
    assert (diff > 0).mean() > 0.05


@pytest.mark.parametrize("c,hw", [(3, (12, 20)), (64, (13, 9))])
def test_encoder_stage2_bf16_plain_matches_jax_reference_in_bf16(c, hw):
    rs = np.random.RandomState(200 + c)
    f = 64 if c == 3 else 128
    x = (rs.rand(1, *hw, c) * 50).astype(np.float32)
    w1, w2 = _glorot(rs, (3, 3, c, f)), _glorot(rs, (3, 3, f, f))
    b1, b2 = (rs.randn(f) * 0.1).astype(np.float32), (rs.randn(f) * 0.1).astype(np.float32)
    want_pool, want_act = jk4._xla_reference(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        jnp.asarray(b2))
    pooled, act = encoder_stage2_plain(_nchw(x).to(BF16), _hwio_to_oihw(w1).to(BF16),
                                       torch.from_numpy(b1), _hwio_to_oihw(w2).to(BF16),
                                       torch.from_numpy(b2))
    assert pooled.dtype == act.dtype == BF16
    want_act, want_pool = np.asarray(want_act, np.float32), np.asarray(want_pool, np.float32)
    scale = np.abs(want_act).max()
    assert np.abs(_nhwc(act) - want_act).max() <= KERNEL_BF16_TOL * scale
    assert np.abs(_nhwc(pooled) - want_pool).max() <= KERNEL_BF16_TOL * scale
    # max pool of the rounded skip == rounding of the max: the same values
    np.testing.assert_array_equal(
        pooled.float().numpy(), F.max_pool2d(act.float(), 2, 2, ceil_mode=True).numpy())


@pytest.mark.parametrize("hw", [(40, 56), (37, 50)])
def test_lin_feature_stem_bf16_plain_matches_jax_reference_in_bf16(hw):
    rs = np.random.RandomState(300 + hw[0])
    x = rs.rand(2, *hw, 3).astype(np.float32)
    k7 = _glorot(rs, (7, 7, 93, 64))
    bias = (rs.randn(64) * 0.1).astype(np.float32)
    want = jk3._xla_reference(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k7), jnp.asarray(bias))
    assert want.dtype == jnp.bfloat16
    got = k3.lin_feature_stem_plain(_nchw(x).to(BF16), _hwio_to_oihw(k7).to(BF16),
                                    torch.from_numpy(bias))
    assert got.dtype == BF16
    want = np.asarray(want, np.float32)
    assert np.abs(_nhwc(got) - want).max() <= STEM_BF16_TOL * np.abs(want).max()
    # no less accurate than JAX's bf16 stem, against JAX's f32 stem
    want_f32 = np.asarray(jk3._xla_reference(jnp.asarray(x), jnp.asarray(k7), jnp.asarray(bias)))
    port_err = np.abs(_nhwc(got) - want_f32).max()
    assert port_err <= 1.25 * np.abs(want - want_f32).max()


def test_bf16_feature_stack_against_jax():
    """The port builds each feature in f32 from the bf16 image and rounds
    once (K3's rule): each is its exact value rounded to bf16.  XLA rounds its
    bf16 Sobel and histogram arithmetic where it chooses.  Against it, the
    image channels are equal and the histogram channels within one bf16 ulp
    of the feature (measured: 1.0).  A Sobel channel is a difference of two
    [1, 2, 1] sums in [0, 4]: XLA rounds each sum twice and the difference
    once, so the two agree within 3 ulps of a value in [2, 4), 3 * 2^-6
    absolute (measured 2^-5; the port's own error <= 2^-7, XLA's up to 0.027)."""
    rs = np.random.RandomState(5)
    x = rs.rand(2, 20, 24, 3).astype(np.float32)
    want = np.asarray(jhist.linearization_features(jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = linearization_features(_nchw(x).to(BF16))
    assert got.dtype == BF16
    got = _nhwc(got)
    exact = linearization_features(_nchw(_round_bf16(x)).float())
    np.testing.assert_array_equal(got, _round_bf16(_nhwc(exact)))
    diff = np.abs(got - want)
    np.testing.assert_array_equal(got[..., :3], want[..., :3])
    assert (diff[..., 9:] <= _ulp_bf16(want[..., 9:]) + 1e-30).all()
    assert diff[..., 3:9].max() <= 3 * 2.0 ** -6


# --- (b) the nets in bf16 vs the Flax nets in bf16 ---------------------------

NETS = {
    "deq": (jm.DequantizationNet, tm.DequantizationNet, (2, 32, 32, 3)),
    "lin": (jm.LinearizationNet, tm.LinearizationNet, (2, 32, 32, 3)),
    "hal": (jm.HallucinationNet, tm.HallucinationNet, (2, 32, 32, 3)),
    "ref": (jm.RefinementNet, tm.RefinementNet, (2, 32, 32, 9)),
}
# max|port bf16 - JAX bf16| / max|JAX f32|, measured: deq 4.7e-3, lin 5.7e-6
# (the curve), hal 8.4e-3, ref 5.6e-3 -- each at the level of JAX's own bf16
# vs f32 difference (3.9e-3, 1.5e-6, 8.4e-3, 5.4e-3).  Bound: 4 ulps of the max
NET_BF16_TOL = 4 * ULP


@pytest.mark.parametrize("name", list(NETS))
def test_net_bf16_matches_flax_bf16_and_returns_f32(name):
    jcls, tcls, shape = NETS[name]
    variables = seeded_variables(jcls(), shape, seed=len(name))
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    want = np.asarray(jax.jit(jcls(dtype=jnp.bfloat16).apply)(variables, jnp.asarray(x)))
    scale = np.abs(np.asarray(jax.jit(jcls().apply)(variables, jnp.asarray(x)))).max()
    net = load_jax_variables(tcls(dtype=BF16), variables).eval()
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.inference_mode():
        got = net(_nchw(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    got = got.numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert np.abs(got - want).max() <= NET_BF16_TOL * scale


def test_bf16_eval_casts_and_packs_each_weight_once():
    """An eval forward casts each conv weight to bf16 once and hands the
    kernels the same tensor on the next forward (so their packing caches on
    it); a change of the weight makes a new cast."""
    net = tm.DequantizationNet(BF16).eval()
    with torch.no_grad():
        for p in net.parameters():
            p.uniform_(-0.1, 0.1)
    conv = net.unet.stem1
    with torch.no_grad():
        first = conv.compute_weight()
        assert first.dtype == BF16 and conv.compute_weight() is first
    torch.testing.assert_close(first, conv.weight.detach().to(BF16), rtol=0, atol=0)
    x = torch.rand(1, 3, 32, 32)
    with torch.inference_mode():
        net(x)
    with torch.no_grad():
        assert conv.compute_weight() is first and not first.is_inference()
        conv.weight.mul_(2)
        assert conv.compute_weight() is not first
    # under autograd the cast is part of the graph
    net.train()
    w = conv.compute_weight()
    assert w.requires_grad and w.grad_fn is not None


def test_lin_folded_stem_is_kept_until_a_source_changes():
    net = tm.LinearizationNet(BF16).eval()
    from singlehdr_tpu_torch.models.layers import keras_init_

    keras_init_(net, torch.Generator().manual_seed(0))
    crf = net.crf_feature_net
    with torch.no_grad():
        k, b = crf.folded_stem()
        assert k.dtype == BF16 and b.dtype == torch.float32
        assert crf.folded_stem()[0] is k
        crf.stem_bn.running_var.mul_(2)  # a BN statistic moves: refold
        k2, _ = crf.folded_stem()
    assert k2 is not k
    assert k3.packed_stem_weights(k2) is k3.packed_stem_weights(k2)


# --- (c) the pipeline ----------------------------------------------------------


def test_pipeline_bf16_psnr_is_within_3db_of_jax_bf16():
    """On ``hdr``, with max|JAX f32| as the peak.  Measured at 1 x 64^2: the
    port in bf16 54.99 dB, JAX in bf16 55.47 dB."""
    shape = (1, 64, 64, 3)
    variables = seeded_variables(jm.ReverseCameraPipeline(), shape, seed=3)
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    hdr = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jp = jm.ReverseCameraPipeline(dtype=dt)
        hdr[dt] = np.asarray(jax.jit(lambda v, a: jp.apply(v, a).hdr)(variables, jnp.asarray(x)))
    pipe = load_jax_variables(tm.ReverseCameraPipeline(BF16), variables).eval()
    kernels.reset_launches()
    with torch.inference_mode():
        out = pipe(_nchw(x))
    assert out.hdr.dtype == out.invcrf.dtype == out.b_pred.dtype == torch.float32
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}
    ref = hdr[jnp.float32]
    peak = np.abs(ref).max()

    def psnr(a):
        return 10 * np.log10(peak ** 2 / np.mean((a - ref) ** 2))

    port, jax_bf16 = psnr(out.hdr.permute(0, 2, 3, 1).numpy()), psnr(hdr[jnp.bfloat16])
    print(f"PSNR vs JAX f32: port bf16 {port:.2f} dB, JAX bf16 {jax_bf16:.2f} dB")
    assert port >= jax_bf16 - 3.0


def test_build_pipeline_takes_the_compute_dtype():
    pipe = tm.build_pipeline(seed=0, device="cpu", dtype=BF16)
    assert pipe.dtype == BF16 and not pipe.training
    assert {m.dtype for m in (pipe.deq, pipe.lin, pipe.hal, pipe.ref)} == {BF16}
    assert all(p.dtype == torch.float32 for p in pipe.parameters())
    with torch.inference_mode():
        out = pipe(torch.rand(1, 3, 32, 32))
    assert out.hdr.dtype == torch.float32 and torch.isfinite(out.hdr).all()


# --- (d) the bf16 backward: each layer, the bias reduction, one joint step -----

# Each layer kind of the nets' train-mode path alone, bf16 in and out: the
# port's VJP of a seeded bf16 cotangent against Flax's.  Where the two round
# at the same points they agree to the bit, or nearly (a sum straddling a
# rounding boundary), while JAX's own bf16 gradients sit 0.2-6 % of their
# norm from its f32 ones: so each gradient is held to within a quarter of that
# distance of JAX's bf16 gradient, and a port that computed a layer in f32 or
# rounded elsewhere fails.  Measured: at most 6.1e-4 of the f32 norm (the
# bottleneck block's conv1 kernel), 0.022 of JAX's own bf16 - f32 distance.
# The gradients of a conv's bias are the exception (see the next test): held
# to JAX's within 0.15 of the f32 norm (measured up to 0.063, where the port
# is on JAX's f32 gradient).
CONV_BIAS_VJP_TOL = 0.15
# name -> (Flax module, port module, input shapes (NHWC), Flax call kwargs)
BF16_VJP_UNITS = {
    "conv7x7s2_stem": (lambda dt: jl.conv(64, 7, strides=2, dtype=dt),
                       lambda dt: tl.Conv2d(N_FEATURES, 64, 7, 2, dtype=dt), [(2, 20, 24, 93)], {}),
    "conv3x3": (lambda dt: jl.conv(32, 3, dtype=dt), lambda dt: tl.Conv2d(16, 32, 3, dtype=dt),
                [(2, 16, 16, 16)], {}),
    "conv1x1s2_no_bias": (lambda dt: jl.conv(32, 1, strides=2, use_bias=False, dtype=dt),
                          lambda dt: tl.Conv2d(16, 32, 1, 2, bias=False, dtype=dt),
                          [(2, 16, 16, 16)], {}),
    "batchnorm": (lambda dt: jl.batch_norm(True, dtype=dt), lambda dt: tl.BatchNorm(16, dt),
                  [(2, 16, 16, 16)], {}),
    "upsample_conv": (lambda dt: jl.UpsampleConv(16, dtype=dt), lambda dt: tl.UpsampleConv(32, 16, dt),
                      [(2, 8, 8, 32)], {}),
    "skip_fusion": (lambda dt: jhal.SkipFusion(16, dtype=dt), lambda dt: thal.SkipFusion(16, 16, 16, dt),
                    [(2, 16, 16, 16), (2, 16, 16, 16)], {}),
    "bottleneck_block": (lambda dt: jlin.BottleneckResBlock((8, 8, 32), strides=2, projection=True,
                                                            dtype=dt),
                         lambda dt: tlin.BottleneckResBlock(16, (8, 8, 32), 2, True, dt),
                         [(2, 16, 16, 16)], {"train": True}),
    "encoder_stage3": (lambda dt: jhal.EncoderStage(32, 3, dtype=dt),
                       lambda dt: thal.EncoderStage(16, 32, 3, dt), [(2, 16, 16, 16)], {"train": True}),
    "decoder_stage": (lambda dt: jhal.DecoderStage(16, dtype=dt), lambda dt: thal.DecoderStage(32, 16, dt),
                      [(2, 8, 8, 32)], {"train": True}),
}


def _flax_vjp(module, variables, xs, kwargs, cot_seed):
    """Flax's gradients ({param: OIHW tensor}, [input grads NHWC]) of <R, out>
    for a seeded cotangent R in the output's dtype; R as f32 numpy."""
    def fwd(params, *inputs):
        kw = dict(kwargs)
        if "batch_stats" in variables:
            kw["mutable"] = ["batch_stats"]
        out = module.apply(dict(variables, params=params), *inputs, **kw)
        out = out[0] if "batch_stats" in variables else out
        return out[0] if isinstance(out, tuple) else out  # a stage's pooled output

    out, vjp = jax.vjp(fwd, variables["params"], *[jnp.asarray(x) for x in xs])
    cot = np.random.RandomState(cot_seed).randn(*out.shape).astype(np.float32)
    grads = vjp(jnp.asarray(cot, out.dtype))
    return (from_jax_variables({"params": grads[0]}),
            [np.asarray(g, np.float32) for g in grads[1:]], _round_bf16(cot))


@pytest.mark.parametrize("unit", list(BF16_VJP_UNITS))
def test_layer_bf16_backward_rounds_where_flax_does(unit):
    jmod, tmod, shapes, kwargs = BF16_VJP_UNITS[unit]
    rs = np.random.RandomState(len(unit))
    variables = seeded_variables(jmod(jnp.float32), shapes[0], 3, *shapes[1:])
    xs = [jnp.asarray(rs.rand(*s) * 2 - 0.5, jnp.bfloat16) for s in shapes]
    jax32 = _flax_vjp(jmod(jnp.float32), variables, [x.astype(jnp.float32) for x in xs], kwargs, 5)
    jax16 = _flax_vjp(jmod(jnp.bfloat16), variables, xs, kwargs, 5)
    net = load_jax_variables(tmod(BF16), variables).train()
    inputs = [_nchw(np.asarray(x, np.float32)).to(BF16).requires_grad_() for x in xs]
    out = net(*inputs)
    out = out[0] if isinstance(out, tuple) else out
    assert out.dtype == BF16
    out.backward(_nchw(jax16[2]).to(BF16))
    port = ({k: p.grad for k, p in net.named_parameters()},
            [_nhwc(t.grad) for t in inputs])

    def rel(a, b, ref):
        return _fro(torch.as_tensor(a) - torch.as_tensor(b)) / _fro(torch.as_tensor(ref))

    checks = [(f"d{i}", port[1][i], jax16[1][i], jax32[1][i]) for i in range(len(xs))]
    checks += [(k, port[0][k], jax16[0][k], jax32[0][k]) for k in jax32[0]]
    for name, got, want, f32 in checks:
        got_err, jax_err = rel(got, want, f32), rel(want, f32, f32)
        if name.endswith("bias") and not _is_bn_param(net, name):
            assert got_err <= CONV_BIAS_VJP_TOL, (unit, name, got_err)
        else:
            assert got_err <= 0.25 * jax_err + 1e-6, (unit, name, got_err, jax_err)


def _is_bn_param(net, name):
    owner = net.get_submodule(name.rpartition(".")[0]) if "." in name else net
    return isinstance(owner, tl.BatchNorm)


def test_conv_bias_gradient_is_summed_in_f32():
    """Why JAX's bf16 bias gradients on the CPU sit far from its f32 ones (deq's
    at 0.5-0.8 of their norm at 4 x 64^2, the port's at 0.002-0.01): the
    gradient of ``y + bias.astype(bf16)`` is a ``reduce_sum`` of the bf16
    cotangent, which XLA:CPU computes rounding each partial sum to bf16 (its
    reducer is an f32 add followed by a convert to bf16).  PyTorch sums the
    bf16 cotangent in f32 and rounds once.  Measured here: the port within
    half a bf16 ulp of the exact sum on every channel, JAX up to 40 ulps."""
    rs = np.random.RandomState(9)
    cot = _round_bf16(rs.randn(2, 32, 32, 16) + 0.05)
    y = jnp.zeros(cot.shape, jnp.bfloat16)
    _, vjp = jax.vjp(lambda b: y + b.astype(jnp.bfloat16), jnp.zeros(16, jnp.float32))
    got_jax = np.asarray(vjp(jnp.asarray(cot, jnp.bfloat16))[0], np.float64)
    bias = torch.zeros(16, requires_grad=True)
    (torch.zeros(2, 16, 32, 32, dtype=BF16) + bias.to(BF16)[:, None, None]).backward(_nchw(cot).to(BF16))
    assert bias.grad.dtype == torch.float32
    exact = cot.astype(np.float64).sum(axis=(0, 1, 2))
    ulp = _ulp_bf16(exact)
    assert (np.abs(bias.grad.double().numpy() - exact) <= 0.5 * ulp).all()
    assert np.abs(got_jax - exact).max() >= 8 * ulp.max()


# One bf16 joint step against ``make_joint_train_step(vgg, jnp.bfloat16)`` at
# 4 x 64^2 (hal's deepest stage 2 x 2), on seeded smooth images.  Whole nets
# in bf16 do not agree to the bit: XLA rounds a few operations its own way
# (its bf16 reductions on the CPU, the Sobel sums), and a one-ulp change of an
# activation moves a ReLU's mask.  lin's and hal's gradients amplify such
# changes: a BatchNorm's backward removes the part of the cotangent that is
# constant or proportional to its input, and what is left depends on the few
# activations near a ReLU's edge.  So JAX's own bf16 gradients sit 0.57 (lin)
# and 0.56 (hal) of their norm from its f32 ones here (0.56-0.88 for hal over
# six batch seeds; 0.60 and 1.17 on uniform-noise images, 0.66 and 1.65 at
# 2 x 32^2, where bf16 rounding swamps the gradient).  deq (no BatchNorm)
# sits 0.0048 from JAX f32, JAX's own bf16 0.22: its bias gradients (above).
# Per net (Frobenius over its tensors, relative to the f32 norm), measured
# deq / lin / hal:
#   port - JAX bf16 <= 0.3 (deq), 0.6 (lin)          (0.22 / 0.43 / 0.97)
#   port - JAX f32 <= 1.5 (JAX bf16 - JAX f32) + 0.02  (0.0048 / 0.54 / 0.67)
#   cos(port, JAX f32) >= max(0.5, cos(JAX bf16, JAX f32) - 0.15)
#                                                    (1.000 / 0.85 / 0.89;
#                                                     JAX 0.976 / 0.83 / 0.83)
# and a zeroed or sign-flipped gradient of any one net fails them.  hal has no
# bound against JAX's bf16 gradients: two bf16 realisations of a noise that
# large differ by 0.51-0.97 of the norm (six seeds), so hal is held to the f32
# gradients through the noise and cosine bounds (over six seeds the port's
# distance was at most 1.19 of JAX's, its cosine at least 0.675 where JAX's
# was 0.709).  deq per tensor: each kernel gradient within 0.03 of its norm of
# JAX's bf16 and of JAX's f32 gradient (measured 0.015 and 0.016), each bias
# within 0.03 of the f32 one (0.015; JAX's bf16 biases 0.015-0.88).  The loss
# within 1e-3 of JAX's bf16 loss, relative (measured 5.7e-6); the new BN
# statistics within 1e-2 of their max (5.8e-4; reduced in f32 on both
# sides).  The
# layers' rounding points are pinned by the tests above.
STEP_B, STEP_HW = 4, 64
STEP_NET_TOL = {"deq": 0.3, "lin": 0.6}
STEP_NOISE_FACTOR = 1.5
STEP_COS_SLACK, STEP_COS_MIN = 0.15, 0.5
STEP_DEQ_TOL = (0.03, 0.03)
STEP_LOSS_TOL = 1e-3
STEP_STATS_TOL = 1e-2


def _fro(a):
    return float((a.double() ** 2).sum()) ** 0.5


def _smooth_images(rs, b, hw):
    """Seeded smooth images in [0, 1]: four low-frequency waves a channel."""
    yy, xx = np.meshgrid(np.linspace(0, 1, hw), np.linspace(0, 1, hw), indexing="ij")
    out = np.zeros((b, hw, hw, 3))
    for i in range(b):
        for c in range(3):
            for _ in range(4):
                fy, fx = rs.randint(1, 4, 2) * rs.rand(2)
                out[i, ..., c] += rs.rand() * np.sin(2 * np.pi * (fx * xx + fy * yy) + 6 * rs.rand())
    out -= out.min(axis=(1, 2, 3), keepdims=True)
    return (out / out.max(axis=(1, 2, 3), keepdims=True)).astype(np.float32)


def _step_batch(seed):
    rs = np.random.RandomState(seed)
    ldr, clipped = _smooth_images(rs, STEP_B, STEP_HW), _smooth_images(rs, STEP_B, STEP_HW)
    return {
        "ldr": ldr,
        "jpeg": np.clip(ldr + rs.randn(*ldr.shape).astype(np.float32) * 0.02, 0, 1),
        "clipped_hdr_t": clipped,
        "hdr_t": clipped * rs.uniform(1.0, 2.0, (STEP_B, 1, 1, 1)).astype(np.float32),
        "mask": np.ones((STEP_B, 1, 1, 1), np.float32),
        "invcrf": np.asarray(jcurves.monotonic_rf(jnp.asarray(rs.rand(STEP_B, 1024).astype(np.float32)))),
    }


def _net_step_failures(net, grads, g_f32, g_bf16):
    """The per-net bounds above that ``grads`` (one net's) breaks."""
    keys = list(grads)

    def norm(d):
        return sum(_fro(d[k]) ** 2 for k in keys) ** 0.5

    def dist(a, b):
        return sum(_fro(a[k] - b[k]) ** 2 for k in keys) ** 0.5

    def cos(a):
        dot = sum(float((a[k].double() * g_f32[k].double()).sum()) for k in keys)
        return dot / (n * norm(a)) if norm(a) > 0 else 0.0

    n = norm(g_f32)
    out = []
    if net in STEP_NET_TOL and not dist(grads, g_bf16) <= STEP_NET_TOL[net] * n:
        out.append(f"{net}: port - JAX bf16 {dist(grads, g_bf16) / n:.3f}")
    if not dist(grads, g_f32) <= STEP_NOISE_FACTOR * dist(g_bf16, g_f32) + 0.02 * n:
        out.append(f"{net}: port - JAX f32 {dist(grads, g_f32) / n:.3f}, JAX bf16 "
                   f"{dist(g_bf16, g_f32) / n:.3f}")
    if not cos(grads) >= max(STEP_COS_MIN, cos(g_bf16) - STEP_COS_SLACK):
        out.append(f"{net}: cos {cos(grads):.3f}, JAX bf16 {cos(g_bf16):.3f}")
    return out


def test_joint_step_bf16_matches_jax_bf16_step():
    names = ("deq", "lin", "hal")
    variables = _variables(names, seed=20)
    batch = _step_batch(21)
    keys = ("ldr", "jpeg", "clipped_hdr_t", "hdr_t", "mask", "invcrf")
    jax_runs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jstate, jloss, _ = jsteps.make_joint_train_step(JVgg16Features(), dt)(
            _jax_state(variables, _recording_tx()), *[jnp.asarray(batch[k]) for k in keys])
        jax_runs[dt] = (from_jax_variables({"params": jstate.opt_state}), float(jloss),
                        from_jax_variables({"batch_stats": jstate.batch_stats}))
    g_f32, _, _ = jax_runs[jnp.float32]
    g_bf16, loss_bf16, stats_bf16 = jax_runs[jnp.bfloat16]

    nets = nn.ModuleDict({n: NETS[n][1](dtype=BF16) for n in names})
    load_jax_variables(nets, variables)
    state = TrainState(nets, make_optimizer(nets.parameters(), 1e-4))
    assert state.dtype == BF16
    with pytest.raises(ValueError, match="compute in"):
        steps.make_joint_train_step(Vgg16Features())(state, *_port_args(batch, keys))
    loss, aux = steps.make_joint_train_step(Vgg16Features(), BF16)(state, *_port_args(batch, keys))
    assert loss.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in aux.values())
    assert abs(float(loss) - loss_bf16) <= STEP_LOSS_TOL * abs(loss_bf16)

    params = dict(state.nets.named_parameters())
    assert set(g_f32) == set(params)
    grads = {k: p.grad for k, p in params.items()}
    assert all(g is not None and g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads.values())
    failures = []
    for net in names:
        own = {k: g for k, g in grads.items() if k.startswith(net + ".")}
        failures += _net_step_failures(net, own, g_f32, g_bf16)
        for fault, bad in (("zeroed", 0.0), ("sign-flipped", -1.0)):
            assert _net_step_failures(net, {k: g * bad for k, g in own.items()}, g_f32, g_bf16), \
                f"a {fault} {net} gradient passes the bounds"
    assert not failures, failures
    for key, got in grads.items():
        if key.startswith("deq."):
            n = _fro(g_f32[key])
            if key.endswith("weight"):
                assert _fro(got - g_bf16[key]) <= STEP_DEQ_TOL[0] * n, key
            assert _fro(got - g_f32[key]) <= STEP_DEQ_TOL[1] * n, key

    buffers = dict(state.nets.named_buffers())
    for key, value in stats_bf16.items():
        got = buffers[key]
        assert got.dtype == torch.float32
        assert float((got - value).abs().max()) <= STEP_STATS_TOL * float(value.abs().max()), key


def test_batchnorm_running_variance_is_reduced_in_f32():
    """A bf16 BatchNorm's running statistics are the f32 batch statistics of
    its (bf16) input, as Flax's, not a bf16 reduction."""
    from singlehdr_tpu_torch.models.layers import BN_MOMENTUM, BatchNorm

    bn = BatchNorm(4, BF16)
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
    x = (torch.randn(8, 4, 16, 16, generator=torch.Generator().manual_seed(0)) * 3 + 100).to(BF16)
    y = bn.train()(x)
    assert y.dtype == BF16
    var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, BN_MOMENTUM * mean, rtol=1e-6, atol=0)
    torch.testing.assert_close(bn.running_var, (1 - BN_MOMENTUM) + BN_MOMENTUM * var, rtol=1e-6,
                               atol=0)


# --- (e) the bf16 kernels' index maps, in numpy ----------------------------------

MAIN_PATH_CONVS = [(3, 16, 7), (9, 16, 7), (16, 16, 7), (16, 32, 5), (32, 32, 5), (32, 64, 3),
                   (64, 64, 3), (3, 64, 3), (64, 128, 3), (128, 128, 3)]


def test_bf16_plan_pads_k_to_a_multiple_of_16():
    want = {(3, 16, 7): (16, 3, 160), (9, 16, 7): (16, 9, 448), (16, 16, 7): (16, 16, 784),
            (16, 32, 5): (32, 16, 400), (32, 64, 3): (64, 16, 144), (3, 64, 3): (64, 3, 32)}
    for (c, f, k), plan in want.items():
        assert cg.conv_plan(c, f, k, BF16) == plan
    for c, f, k in MAIN_PATH_CONVS:
        bn, cc, kc_pad = cg.conv_plan(c, f, k, BF16)
        assert kc_pad % 16 == 0 and cc * k * k <= kc_pad < cc * k * k + 16
        assert cg.supported(c, f, k, BF16) is None
        # a bf16 plan needs at most the shared memory of the f32 one
        assert cg.smem_bytes(c, f, k, BF16) <= cg.smem_bytes(c, f, k)
    # the f32 plan is unchanged: k-steps of 8
    assert cg.conv_plan(3, 16, 7) == (16, 3, 152)
    # K3: 6 chunks of 16 channels, 49 k-steps of one tap each (K 784 a chunk)
    assert k3.CHUNKS_BF16 * k3.CHUNK_BF16 == k3.C_PAD == 96
    assert k3.smem_bytes(BF16) < k3.smem_bytes() <= cg.SMEM_LIMIT


def _bits(t):
    """bf16 tensor -> its 16-bit patterns as numpy uint16."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _from_bits(u16):
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _b_bf16(block, bn):
    """B [16 k, bn n] of one k-step as wgmma reads it through the descriptor
    (no swizzle, K-major; csrc/tf32_mma.cuh's LBO 128, SBO 256): core
    (n // 8, k // 8) at byte (n // 8) * 256 + (k // 8) * 128, element
    (n % 8, k % 8) at byte 16 (n % 8) + 2 (k % 8)."""
    n, k = np.arange(bn)[None, :], np.arange(16)[:, None]
    byte = (n // 8) * 256 + (k // 8) * 128 + 16 * (n % 8) + 2 * (k % 8)
    return block[byte // 2]


@pytest.mark.parametrize("c,f,k", [(3, 64, 3), (9, 16, 7), (16, 32, 5), (64, 128, 3)])
def test_bf16_pack_is_the_wgmma_b_layout(c, f, k):
    rs = np.random.RandomState(c + f + k)
    w = torch.from_numpy(rs.randn(f, c, k, k).astype(np.float32)).to(BF16)
    bn, cc, kc_pad = cg.conv_plan(c, f, k, BF16)
    rows = cg.weight_rows(w, cc, kc_pad)
    assert rows.dtype == BF16 and rows.shape == ((c // cc) * kc_pad, f)
    pk = cg.pack_weights(w)
    assert pk.dtype == BF16
    assert pk.shape == (f // bn, c // cc, kc_pad // 16, 1, bn // 8, 2, 8, 8)
    assert cg.packed_weights(w) is cg.packed_weights(w)
    flat = _bits(pk).reshape(f // bn, c // cc, -1)
    want = _bits(rows)
    for nblk in range(f // bn):
        for j in range(c // cc):
            for ks in range(kc_pad // 16):
                block = flat[nblk, j, ks * bn * 16:(ks + 1) * bn * 16]
                np.testing.assert_array_equal(
                    _b_bf16(block, bn),
                    want[j * kc_pad + 16 * ks:j * kc_pad + 16 * ks + 16, nblk * bn:(nblk + 1) * bn])


def test_bf16_mma_sync_b_words_hold_the_ptx_fragment():
    """The BN = 16 path reads b0 = word 64 nt + lane and b1 = word 64 nt + 32
    + lane of a k-step's block: b0 holds B[2t][g] (low half) and B[2t+1][g],
    b1 B[2t+8][g] and B[2t+9][g], in n8 tile nt (mma.sync m16n8k16 .bf16)."""
    rs = np.random.RandomState(3)
    w = torch.from_numpy(rs.randn(16, 16, 7, 7).astype(np.float32)).to(BF16)
    bn, cc, kc_pad = cg.conv_plan(16, 16, 7, BF16)
    rows = _bits(cg.weight_rows(w, cc, kc_pad))
    words = _bits(cg.pack_weights(w)).reshape(-1).view(np.uint32)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for ks in (0, 17, kc_pad // 16 - 1):
        blk = words[ks * bn * 8:(ks + 1) * bn * 8]
        b = rows[16 * ks:16 * ks + 16]
        for nt in range(bn // 8):
            b0, b1 = blk[64 * nt + lane], blk[64 * nt + 32 + lane]
            n = 8 * nt + g
            np.testing.assert_array_equal(b0 & 0xFFFF, b[2 * t, n])
            np.testing.assert_array_equal(b0 >> 16, b[2 * t + 1, n])
            np.testing.assert_array_equal(b1 & 0xFFFF, b[2 * t + 8, n])
            np.testing.assert_array_equal(b1 >> 16, b[2 * t + 9, n])


def _koff_bf16(c, k, cc, kc_pad):
    side, cs = cg.TILE + k - 1, cg.channel_stride(k, BF16)
    kk = np.arange(kc_pad)
    return np.where(kk < cc * k * k, kk // (k * k) * cs + kk % (k * k) // k * side + kk % k,
                    cc * cs)


@pytest.mark.parametrize("c,f,k", MAIN_PATH_CONVS)
def test_bf16_a_fragment_loads_are_bank_conflict_free(c, f, k):
    """Each 16-bit A load of a warp (row g (+8), k column 2t (+1, +8, +9))
    touches at most one 4-byte word a bank, given the bf16 channel stride."""
    bn, cc, kc_pad = cg.conv_plan(c, f, k, BF16)
    side = cg.TILE + k - 1
    koff = _koff_bf16(c, k, cc, kc_pad)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    assert cg.channel_stride(k, BF16) % 64 == 48
    for row in range(cg.TILE):
        for ks in range(kc_pad // 16):
            for col in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9):
                for half in (0, 8):
                    words = np.unique((row * side + g + half + koff[ks * 16 + col]) >> 1)
                    assert len(np.unique(words % 32)) == len(words), (row, ks)


def _a_regs_bf16(stage, moff, koff, ks):
    """The 4 A registers (uint32) of each lane, packed as the kernel packs
    them: low half the even k.  moff [..., 32]."""
    lane = np.arange(32)
    t = lane & 3
    kb = ks * 16 + 2 * t
    k0, k1, k8, k9 = koff[kb], koff[kb + 1], koff[kb + 8], koff[kb + 9]

    def pack(lo, hi):
        return stage[lo].astype(np.uint32) | (stage[hi].astype(np.uint32) << 16)

    return np.stack([pack(moff + k0, moff + k1), pack(moff + 8 + k0, moff + 8 + k1),
                     pack(moff + k8, moff + k9), pack(moff + 8 + k8, moff + 8 + k9)], -1)


def _a_matrix_bf16(regs):
    """A registers [..., 32, 4] -> the warp's A rows [..., 16, 16] by the PTX
    map: a0 (g, 2t | 2t+1), a1 (g+8, ...), a2 (g, 2t+8 | 2t+9), a3 (g+8, ...)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    m = np.zeros(regs.shape[:-2] + (16, 16), np.float64)
    for r, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8), (g + 8, 2 * t + 8))):
        m[..., row, col] = _from_bits((regs[..., r] & 0xFFFF).astype(np.uint16))
        m[..., row, col + 1] = _from_bits((regs[..., r] >> 16).astype(np.uint16))
    return m


def simulate_launch_bf16(x, w, bias, mode):
    """What one ``shdr_conv_gemm_bf16`` launch writes (bf16 tensors in and
    out): the staged tile of 16-bit patterns, the A registers packed from two
    16-bit loads each, B through the descriptor (BN >= 32) or the mma.sync
    words (BN = 16), products and sums in float64, the epilogue's rounding."""
    bsz, c, h, wd = x.shape
    f, _, k, _ = w.shape
    bn, cc, kc_pad = cg.conv_plan(c, f, k, BF16)
    tile, r = cg.TILE, k // 2
    side, cs = tile + k - 1, cg.channel_stride(k, BF16)
    mt_n = tile // cg.WARPS
    chunks, ksteps, kvalid = c // cc, kc_pad // 16, cc * k * k
    zero = tile * side if kvalid < kc_pad else 0
    koff = _koff_bf16(c, k, cc, kc_pad)
    xb = _bits(x)
    wpk = _bits(cg.pack_weights(w)).reshape(f // bn, chunks, -1)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    pool = mode in (cg.LEAKY_AVG_POOL, cg.RELU_MAX_POOL)
    leaky = mode in (cg.LEAKY_STORE, cg.LEAKY_AVG_POOL)
    ph, pw = (h // 2, wd // 2) if mode == cg.LEAKY_AVG_POOL else ((h + 1) // 2, (wd + 1) // 2)
    out = np.full((bsz, f, h, wd), np.nan, np.float32)
    pooled = np.full((bsz, f, ph, pw), np.nan, np.float32) if pool else None
    i = np.arange(cc * side * side)
    ci, ri = i // (side * side), i % (side * side)
    bias = bias.numpy()
    for b in range(bsz):
        for nblk in range(f // bn):
            for ty0 in range(0, h, tile):
                for tx0 in range(0, wd, tile):
                    acc = np.zeros((cg.WARPS, mt_n, 16, bn))
                    for j in range(chunks):
                        stage = np.zeros(cc * cs + zero, np.uint16)
                        gy, gx = ty0 - r + ri // side, tx0 - r + ri % side
                        ok = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < wd)
                        stage[ci[ok] * cs + ri[ok]] = xb[b, j * cc + ci[ok], gy[ok], gx[ok]]
                        blocks = wpk[nblk, j].reshape(ksteps, bn * 16)
                        for warp in range(cg.WARPS):
                            moff = (warp * mt_n + np.arange(mt_n))[:, None] * side + g
                            for ks in range(ksteps):
                                a = _a_matrix_bf16(_a_regs_bf16(stage, moff, koff, ks))
                                if bn == 16:  # mma.sync words
                                    words = blocks[ks].view(np.uint32)
                                    bm = np.zeros((16, bn))
                                    for nt in range(bn // 8):
                                        b0, b1 = words[64 * nt + lane], words[64 * nt + 32 + lane]
                                        n = 8 * nt + g
                                        for kr, half in ((2 * t, b0 & 0xFFFF), (2 * t + 1, b0 >> 16),
                                                         (2 * t + 8, b1 & 0xFFFF),
                                                         (2 * t + 9, b1 >> 16)):
                                            bm[kr, n] = _from_bits(half.astype(np.uint16))
                                else:
                                    bm = _from_bits(_b_bf16(blocks[ks], bn))
                                acc[warp] += a @ bm
                    for warp in range(cg.WARPS):
                        v = acc[warp].astype(np.float32) + bias[nblk * bn:(nblk + 1) * bn]
                        v = np.where(v > 0, v, v * np.float32(0.1)) if leaky else np.maximum(v, 0)
                        for mt in range(mt_n):
                            y = ty0 + warp * mt_n + mt
                            xs = tx0 + np.arange(16)
                            m = xs < wd
                            if y < h:
                                # (advanced indices apart: [columns, channels])
                                out[b, nblk * bn:(nblk + 1) * bn, y, xs[m]] = _round_bf16(v[mt][m])
                        if not pool:
                            continue
                        y = ty0 + warp * mt_n  # even: the window's top row
                        if y // 2 >= ph:
                            continue
                        if mode == cg.RELU_MAX_POOL:
                            top = v[0]
                            bot = v[1] if y + 1 < h else np.full_like(v[1], -np.inf)
                            cols = np.maximum(top, bot)
                            xs = tx0 + np.arange(16)
                            cols = np.where((xs < wd)[:, None], cols, -np.inf)
                            pv = np.maximum(cols[0::2], cols[1::2])
                        else:
                            s = v[0] + v[1]
                            pv = (s[0::2] + s[1::2]) * np.float32(0.25)
                        px = tx0 // 2 + np.arange(8)
                        m = px < pw
                        pooled[b, nblk * bn:(nblk + 1) * bn, y // 2, px[m]] = _round_bf16(pv[m])
    return out, pooled


BF16_STAGES = [
    ("encoder_stage2", (1, 3, 19, 21), 64, 3),
    ("encoder_stage2", (1, 64, 17, 18), 128, 3),
    ("unet_stage2", (1, 9, 18, 20), 16, 7),
    ("unet_stage2", (1, 16, 16, 17), 16, 7),
    ("unet_stage2", (2, 16, 17, 16), 32, 5),
]


@pytest.mark.parametrize("kernel,shape,f,k", BF16_STAGES,
                         ids=[f"{s[0]}_{s[1][1]}to{s[2]}_k{s[3]}" for s in BF16_STAGES])
def test_simulated_bf16_launches_match_the_bf16_plain_stage(kernel, shape, f, k):
    """Two simulated launches (conv1 stores, conv2 stores and pools) against
    the bf16 plain stage.  Both sum the same exact products, in float64 here
    and f32 there, so a stored value differs at most where the two sums round
    to neighbouring bf16 values: within one ulp of the largest value
    (measured: most elements equal)."""
    rs = np.random.RandomState(f * k + shape[1])
    c = shape[1]
    x = torch.from_numpy((rs.rand(*shape) * 2 - 0.5).astype(np.float32)).to(BF16)
    w1 = torch.from_numpy(rs.randn(f, c, k, k).astype(np.float32) * np.sqrt(2.0 / (c * k * k))
                          ).to(BF16)
    w2 = torch.from_numpy(rs.randn(f, f, k, k).astype(np.float32) * np.sqrt(2.0 / (f * k * k))
                          ).to(BF16)
    b1 = torch.from_numpy((rs.randn(f) * 0.1).astype(np.float32))
    b2 = torch.from_numpy((rs.randn(f) * 0.1).astype(np.float32))
    if kernel == "unet_stage2":
        plain, modes = unet_stage2_plain, (cg.LEAKY_STORE, cg.LEAKY_AVG_POOL)
    else:
        plain, modes = encoder_stage2_plain, (cg.RELU_STORE, cg.RELU_MAX_POOL)
    mid, none = simulate_launch_bf16(x, w1, b1, modes[0])
    assert none is None and np.isfinite(mid).all()
    act, pooled = simulate_launch_bf16(torch.from_numpy(mid).to(BF16), w2, b2, modes[1])
    want_pool, want_act = (t.float().numpy() for t in plain(x, w1, b1, w2, b2))
    for got, want in ((act, want_act), (pooled, want_pool)):
        assert got.shape == want.shape
        assert np.isfinite(got).all(), "every output element is written"
        assert np.abs(got - want).max() <= ULP * np.abs(want).max()
        assert np.mean(got == want) > 0.9


def simulate_stem_bf16(x, k7, bias):
    """What one ``shdr_lin_stem_bf16`` launch writes: the features in f32
    from the bf16 image, rounded once and paired into words (channel 2q in
    the low half of plane q), the A registers read from the pair planes with
    the f32 design's word offsets, B through the descriptor, float64 sums,
    the output rounded to bf16."""
    bsz, _, h, w = x.shape
    ho, wo = -(-h // 2), -(-w // 2)
    pad_t, pad_l = same_pads(h, 7, 2)[0], same_pads(w, 7, 2)[0]
    field, row, pw, cs, cc = k3.FIELD, k3.ROW, k3.PARITY_WIDTH, k3.CHANNEL_STRIDE, k3.CHUNK_BF16
    ring = _bits(k3.pack_stem_weights(k7)).reshape(k3.CHUNKS_BF16, 49, 64 * 16)
    offs = _gather_offsets()  # word offsets [tap, warp, mt, a0..a3, lane]
    xf = x.float().numpy()
    bias = bias.numpy()
    out = np.full((bsz, 64, ho, wo), np.nan, np.float32)
    r = np.arange(field)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for b in range(bsz):
        for oy0 in range(0, ho, k3.TILE):
            for ox0 in range(0, wo, k3.TILE):
                ry0, rx0 = 2 * oy0 - pad_t, 2 * ox0 - pad_l
                gy = _reflect_clamp(ry0 - 1 + np.arange(field + 2), h)
                gx = _reflect_clamp(rx0 - 1 + np.arange(field + 2), w)
                img = xf[b][:, gy][:, :, gx]
                a_idx, b_idx = np.meshgrid(r + 1, r + 1, indexing="ij")
                inside = ((ry0 + r >= 0) & (ry0 + r < h))[:, None] & \
                    ((rx0 + r >= 0) & (rx0 + r < w))[None, :]
                dest = r[:, None] * row + (r[None, :] & 1) * pw + (r[None, :] >> 1)
                acc = np.zeros((k3.WARPS, 2, 16, 64))
                for j in range(k3.CHUNKS_BF16):
                    feats = np.zeros((cc, field, field), np.float32)
                    for cl in range(cc):
                        if j * cc + cl < N_FEATURES:
                            v = _feature(img, j * cc + cl, a_idx, b_idx)
                            feats[cl] = np.where(inside, v, np.float32(0))
                    fb = _bits(torch.from_numpy(feats).to(BF16)).astype(np.uint32)
                    planes = np.zeros((cc // 2) * cs, np.uint32)
                    where = (np.arange(cc // 2)[:, None, None] * cs + dest).reshape(-1)
                    planes[where] = (fb[0::2] | (fb[1::2] << 16)).reshape(-1)
                    regs = np.moveaxis(planes[offs], 3, -1)  # [tap, warp, mt, 32, 4]
                    a = _a_matrix_bf16(regs)                 # [tap, warp, mt, 16, 16]
                    bm = np.stack([_from_bits(_b_bf16(ring[j, ks], 64)) for ks in range(49)])
                    acc += np.einsum("swmrk,skn->wmrn", a, bm)
                for warp in range(k3.WARPS):
                    for mt in range(2):
                        oy = oy0 + warp * 2 + mt
                        if oy >= ho:
                            continue
                        v = np.maximum(acc[warp, mt].astype(np.float32) + bias, 0)
                        ox = ox0 + np.arange(16)
                        m = ox < wo
                        out[b, :, oy, ox[m]] = _round_bf16(v[m])
    return out


@pytest.mark.parametrize("hw", [(37, 50), (32, 32)], ids=["37x50", "one_tile"])
def test_simulated_bf16_stem_matches_the_bf16_plain_stem(hw):
    rs = np.random.RandomState(hw[0] + hw[1])
    x = torch.from_numpy(rs.rand(1, 3, *hw).astype(np.float32)).to(BF16)
    k7 = torch.from_numpy((rs.randn(64, N_FEATURES, 7, 7) * np.sqrt(2.0 / (93 * 49))
                           ).astype(np.float32)).to(BF16)
    bias = torch.from_numpy((rs.randn(64) * 0.1).astype(np.float32))
    pk = k3.pack_stem_weights(k7)
    assert pk.dtype == BF16 and pk.shape == (1, k3.CHUNKS_BF16, 49, 1, 8, 2, 8, 8)
    got = simulate_stem_bf16(x, k7, bias)
    want = k3.lin_feature_stem_plain(x, k7, bias).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= ULP * np.abs(want).max()
    assert np.mean(got == want) > 0.9


# --- (f) the training CLIs in bf16 ------------------------------------------------


@pytest.fixture()
def hdr_dir(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rs = np.random.RandomState(0)
    d = tmp_path / "hdr"
    d.mkdir()
    for i in range(2):
        img = (rs.rand(64, 96, 3).astype(np.float32) * 4) ** 2
        assert cv2.imwrite(str(d / f"s{i}.hdr"), img)
    return str(d)


def _cli_args(hdr_dir, tmp_path, extra):
    return ["--batch_size", "2", "--patch_size", "32", "--workers", "1", "--log_every", "1",
            "--ckpt_every", "100", "--device", "cpu", "--dtype", "bfloat16", *extra]


def test_train_cli_runs_bf16_on_the_cpu(hdr_dir, tmp_path, monkeypatch):
    from singlehdr_tpu_torch.cli import train

    monkeypatch.chdir(tmp_path)
    args = train.build_parser().parse_args(_cli_args(hdr_dir, tmp_path, [
        "--hdrdir", hdr_dir, "--deq", "true", "--iterations", "2",
        "--deq_ckpt", str(tmp_path / "ck" / "deq")]))
    assert args.dtype == "bfloat16"
    assert train.build_parser().parse_args(["--hdrdir", hdr_dir]).dtype == "float32"
    train.run(args)
    assert os.listdir(tmp_path / "ck" / "deq")


def test_joint_train_cli_runs_bf16_on_the_cpu(hdr_dir, tmp_path, monkeypatch):
    from singlehdr_tpu_torch.cli import joint_train

    monkeypatch.chdir(tmp_path)
    ck = tmp_path / "ck"
    state = joint_train.run(joint_train.build_parser().parse_args(_cli_args(hdr_dir, tmp_path, [
        "--dir", hdr_dir, "--iterations", "1", "--deq_ckpt", str(ck / "deq"),
        "--lin_ckpt", str(ck / "lin"), "--hal_ckpt", str(ck / "hal"),
        "--jnt_ckpt", str(ck / "jnt")])))
    assert state.step == 1 and state.dtype == BF16
    assert all(p.dtype == torch.float32 and p.grad is not None and torch.isfinite(p.grad).all()
               for p in state.nets.parameters())


# --- (g) the argument checks ------------------------------------------------------


def test_conv_kernels_reject_mixed_dtypes():
    x = torch.zeros(1, 16, 8, 8, dtype=BF16)
    w = torch.zeros(16, 16, 3, 3, dtype=BF16)
    b = torch.zeros(16)
    assert check_stage("unet_stage2", x, w, b, w, b, (3,))[4] == 16
    with pytest.raises(ValueError, match="w1: dtype torch.float32"):
        check_stage("unet_stage2", x, w.float(), b, w, b, (3,))
    with pytest.raises(ValueError, match="b2: dtype torch.bfloat16"):
        check_stage("encoder_stage2", x, w, b, w, b.to(BF16), (3,))
    with pytest.raises(ValueError, match="w2: dtype torch.bfloat16, expected torch.float32"):
        check_stage("unet_stage2", x.float(), w.float(), b, w, b, (3,))
    with pytest.raises(ValueError, match="expected one of"):
        check_stage("unet_stage2", x.half(), w.half(), b, w.half(), b, (3,))
    xs = torch.zeros(1, 3, 8, 8, dtype=BF16)
    k7 = torch.zeros(64, N_FEATURES, 7, 7, dtype=BF16)
    assert k3.check_stem(xs, k7, torch.zeros(64)) == BF16
    with pytest.raises(ValueError, match="kernel7: dtype torch.float32"):
        k3.check_stem(xs, k7.float(), torch.zeros(64))
    with pytest.raises(ValueError, match="bias: dtype torch.bfloat16"):
        k3.check_stem(xs, k7, torch.zeros(64, dtype=BF16))


def test_k1_rejects_a_bf16_tensor():
    x, rf = torch.zeros(2, 10), torch.zeros(2, 1024)
    assert apply_rf_cuda.check_args("apply_rf", x, rf) == (2, 1024)
    with pytest.raises(ValueError, match="rf: dtype torch.bfloat16"):
        apply_rf_cuda.check_args("apply_rf", x, rf.to(BF16))
    with pytest.raises(ValueError, match="contiguous float32"):
        apply_rf_cuda.check_args("apply_rf_bwd", x.to(BF16), rf)
