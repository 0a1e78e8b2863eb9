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
import re

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

from test_torch_lin_stem_gemm import _feature, _reflect_clamp
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
    """bf16 K2/K4: k-steps of one tap x 16 channels (two planes), or of four
    taps of a kernel row x 4 channels (C = 3: one plane of pixel-pair rows,
    each kernel row padded to a multiple of 4 taps); K is 16 a k-step."""
    want = {(3, 16, 7): (16, 4, 16 * 14), (9, 16, 7): (16, 16, 16 * 49),
            (16, 16, 7): (16, 16, 16 * 49), (16, 32, 5): (32, 16, 16 * 25),
            (32, 64, 3): (64, 16, 16 * 9), (3, 64, 3): (64, 4, 16 * 3),
            (64, 128, 3): (64, 16, 16 * 9)}
    for (c, f, k), plan in want.items():
        assert cg.conv_plan(c, f, k, BF16) == plan
    for c, f, k in MAIN_PATH_CONVS:
        bn, cc, kc_pad = cg.conv_plan(c, f, k, BF16)
        assert kc_pad % 16 == 0 and kc_pad >= cc * k * k
        assert cg.supported(c, f, k, BF16) is None
    assert cg.supported(24, 64, 3, BF16) is not None  # neither <= 16 nor a multiple of 16
    # the f32 plan is unchanged: k-steps of 8
    assert cg.conv_plan(3, 16, 7) == (16, 3, 152)
    # K3: 6 chunks of 16 channels, 49 k-steps of one tap each (K 784 a chunk)
    assert k3.CHUNKS_BF16 * k3.CHUNK_BF16 == k3.C_PAD == 96
    assert k3.smem_bytes(BF16) < k3.smem_bytes() <= cg.SMEM_LIMIT


@pytest.mark.parametrize("c,f,k", MAIN_PATH_CONVS)
def test_bf16_plan_fits_the_card(c, f, k):
    """Every bf16 layer of the main path: the ring (and conv2's skip and pool
    tiles) fits a block's shared memory and the blocks an SM fit its 228 KB
    (1 KB reserved each); the A
    descriptors' lead, stride and every start address fit their 14-bit fields
    in 16-byte units; conv2's blocked reads take 16-channel chunks."""
    p = cg.plan_bf16(c, f, k)
    assert p["smem_bytes"] <= p["pool_smem_bytes"] <= cg.SMEM_LIMIT
    assert p["blocks_per_sm"] * (p["pool_smem_bytes"] + cg.BLOCK_RESERVED) <= cg.SM_SMEM
    assert p["pool_smem_bytes"] >= p["bn"] * (p["skip_stride"] + p["pool_stride"]) * 2
    assert p["stages"] == min(p["chunks"], cg.RING_BF16) and f % p["bn"] == 0
    for field in (p["lead_bytes"], p["stride_bytes"], p["smem_bytes"]):
        assert field % 16 == 0 and field >> 4 < 2 ** 14
    assert p["slot_bytes"] % 16 == 0 and p["w_bytes"] == p["kc_pad"] * p["bn"] * 2
    if c % 16 == 0:
        assert p["planes"] == 2 and p["chunks"] == c // 16
    else:
        assert p["chunks"] == 1 and p["cc"] >= c


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
    chunks = -(-c // cc)
    rows = cg.weight_rows_bf16(w, cc)
    assert rows.dtype == BF16 and rows.shape == (chunks * kc_pad, f)
    pk = cg.pack_weights(w)
    assert pk.dtype == BF16
    assert pk.shape == (f // bn, chunks, kc_pad // 16, 1, bn // 8, 2, 8, 8)
    assert cg.packed_weights(w) is cg.packed_weights(w)
    flat = _bits(pk).reshape(f // bn, chunks, -1)
    want = _bits(rows)
    for nblk in range(f // bn):
        for j in range(chunks):
            for ks in range(kc_pad // 16):
                block = flat[nblk, j, ks * bn * 16:(ks + 1) * bn * 16]
                np.testing.assert_array_equal(
                    _b_bf16(block, bn),
                    want[j * kc_pad + 16 * ks:j * kc_pad + 16 * ks + 16, nblk * bn:(nblk + 1) * bn])


def test_bf16_mma_sync_b_words_hold_the_ptx_fragment():
    """The BN = 16 path loads a k-step's B by ldmatrix.x4 with lane L's row
    at byte 16 L of the k-step's block: registers 0, 1 (2, 3) are b0, b1 of
    n8 tile 0 (1), b0 holding B[2t][g] (low half) and B[2t+1][g], b1
    B[2t+8][g] and B[2t+9][g] (mma.sync m16n8k16 .bf16)."""
    rs = np.random.RandomState(3)
    w = torch.from_numpy(rs.randn(16, 16, 7, 7).astype(np.float32)).to(BF16)
    bn, cc, kc_pad = cg.conv_plan(16, 16, 7, BF16)
    rows = _bits(cg.weight_rows_bf16(w, cc))
    flat = _bits(cg.pack_weights(w)).reshape(-1)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for ks in (0, 17, kc_pad // 16 - 1):
        regs = _ldmatrix_x4(flat[ks * bn * 16:(ks + 1) * bn * 16], lane * 16)
        b = rows[16 * ks:16 * ks + 16]
        for nt in range(bn // 8):
            b0, b1 = regs[:, 2 * nt], regs[:, 2 * nt + 1]
            n = 8 * nt + g
            np.testing.assert_array_equal(b0 & 0xFFFF, b[2 * t, n])
            np.testing.assert_array_equal(b0 >> 16, b[2 * t + 1, n])
            np.testing.assert_array_equal(b1 & 0xFFFF, b[2 * t + 8, n])
            np.testing.assert_array_equal(b1 >> 16, b[2 * t + 9, n])


def _im2col_taps(x, cc, k):
    """NCHW x -> the GEMM's A [B*H*W, chunks * kc_pad] in the bf16 K order
    (``weight_rows_bf16``'s rows): SAME zeros outside the image, zero columns
    for channels >= C and for a kernel row's padding taps."""
    bsz, c, h, w = x.shape
    r = k // 2
    chunks = -(-c // cc)
    xp = np.zeros((bsz, chunks * cc, h + 2 * r, w + 2 * r + 3))
    xp[:, :c, r:r + h, r:r + w] = x
    kwp = k + -k % 4 if cc == 4 else k
    cols = np.stack([np.stack([xp[:, :, kh:kh + h, kw:kw + w] for kw in range(kwp)], 1)
                     for kh in range(k)], 1)  # [B, kh, kw, chunks*cc, H, W]
    cols = cols.reshape(bsz, k, kwp, chunks, cc, h, w).transpose(0, 5, 6, 3, 1, 2, 4)
    return cols.reshape(bsz * h * w, -1)


@pytest.mark.parametrize("c,f,k", [(3, 16, 7), (9, 16, 7), (16, 32, 5), (3, 64, 3),
                                   (32, 64, 3)])
def test_bf16_weight_rows_reproduce_conv2d(c, f, k):
    """A [pixels, K] in (kh, kw, c) order times ``weight_rows_bf16`` is the
    SAME conv, in float64 (the zero rows meet the zero columns)."""
    rs = np.random.RandomState(7 * c + k)
    x = rs.randn(2, c, 9, 11)
    w = torch.from_numpy(rs.randn(f, c, k, k).astype(np.float32)).to(BF16)
    _, cc, _ = cg.conv_plan(c, f, k, BF16)
    got = _im2col_taps(x, cc, k) @ cg.weight_rows_bf16(w, cc).double().numpy()
    want = F.conv2d(torch.from_numpy(x), w.double(), padding=k // 2)
    np.testing.assert_allclose(got.reshape(2, 9, 11, f).transpose(0, 3, 1, 2), want.numpy(),
                               rtol=1e-10, atol=1e-10)


def _ldmatrix_x4(mem, addr):
    """ldmatrix.sync.aligned.m8n8.x4.b16: lane 8q + r gives the byte address of
    row r of matrix q (``addr`` [..., 32]); lane (g, t) receives, for each q,
    the word of bf16s 2t, 2t + 1 of row g of matrix q.  -> uint32 [..., 32, 4]."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    regs = []
    for q in range(4):
        row = np.take(addr, 8 * q + g, axis=-1) // 2 + 2 * t
        regs.append(mem[row].astype(np.uint32) | (mem[row + 1].astype(np.uint32) << 16))
    return np.stack(regs, -1)


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


def _b_matrix_sync(regs):
    """ldmatrix.x4 of a BN = 16 k-step block [32, 4] -> B [16 k, 16 n] by the
    PTX map of mma.sync m16n8k16: n8 tile nt takes b0 = reg 2 nt (k 2t, 2t+1;
    n g), b1 = reg 2 nt + 1 (k 2t+8, 2t+9; n g)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    m = np.zeros((16, 16))
    for nt in range(2):
        for half in range(2):
            word = regs[:, 2 * nt + half]
            m[2 * t + 8 * half, 8 * nt + g] = _from_bits((word & 0xFFFF).astype(np.uint16))
            m[2 * t + 8 * half + 1, 8 * nt + g] = _from_bits((word >> 16).astype(np.uint16))
    return m


def _desc(start, lead, stride):
    """csrc/bf16_mma.cuh smem_desc: 14-bit fields in 16-byte units."""
    return ((start & 0x3FFFF) >> 4) | ((lead >> 4) << 16) | ((stride >> 4) << 32)


def _desc_matrix(mem, desc, rows):
    """The rows x 16 bf16 operand a no-swizzle K-major descriptor names (PTX
    ISA, matrix descriptor): 8-row core matrices of 16-byte rows; core
    (m // 8, k // 8) at start + (m // 8) * stride + (k // 8) * lead, element
    (m % 8, k % 8) at 16 (m % 8) + 2 (k % 8) within it.  -> float64."""
    start, lead, stride = (desc & 0x3FFF) << 4, ((desc >> 16) & 0x3FFF) << 4, \
        ((desc >> 32) & 0x3FFF) << 4
    m, k = np.arange(rows)[:, None], np.arange(16)[None, :]
    byte = start + (m // 8) * stride + (k // 8) * lead + 16 * (m % 8) + 2 * (k % 8)
    return _from_bits(mem[byte // 2]).astype(np.float64)


def _sync_a_addresses(p, k, warp, c):
    """The mma.sync path's ldmatrix rows of A for kernel column step c:
    [warps, 32] byte offsets into the staged tile of tile row 4 warp (staged
    row y adds y * IW * 16).  Lane 8q + r: pixel column r + 8 (q & 1),
    k half h = q >> 1: plane h at tap kw = c (two planes), or the pixel-pair
    row at kw = 4c + 2h (one plane; kw = 4c where 4c + 2h is past the row)."""
    lane = np.arange(32)
    q = lane >> 3
    h = q >> 1
    col = (lane & 7) + 8 * (q & 1)
    if p["planes"] == 2:
        plane, kw = h, c + 0 * h
    else:
        plane, kw = 0 * h, np.where(4 * c + 2 * h < k, 4 * c + 2 * h, 4 * c)
    warp = np.asarray(warp)[..., None]
    return plane * p["plane_bytes"] + ((4 * warp) * p["iw"] + col + kw) * 16


def _stage_tile(xb, blocked, b, j, p, c, ty0, tx0, k):
    """The staged planes of chunk j, as conv1 (NCHW input: 8 channels a 16-byte
    row, or with one plane 4 channels of pixels p and p + 1; zeros past C) or
    conv2 (blocked input, one 16-byte copy a row) writes them: uint16
    [planes * IH * IW * 8], zeros outside the image."""
    ih, iw, planes = p["ih"], p["iw"], p["planes"]
    i = np.arange(planes * ih * iw)
    q, rr = i // (ih * iw), i % (ih * iw)
    gy, gx = ty0 - k // 2 + rr // iw, tx0 - k // 2 + rr % iw
    ok = (gy >= 0) & (gy < xb.shape[-3 if blocked else -2]) & (gx >= 0) & \
        (gx < xb.shape[-2 if blocked else -1])
    rows = np.zeros((i.size, 8), np.uint16)
    if blocked:
        rows[ok] = xb[b, j * planes + q[ok], gy[ok], gx[ok]]
    else:
        rows_in = (gy >= 0) & (gy < xb.shape[-2])
        for e in range(8):
            ch, dx = (j * 16 + q * 8 + e, 0) if planes == 2 else (0 * q + e % 4, e // 4)
            m = rows_in & (ch < c) & (gx + dx >= 0) & (gx + dx < xb.shape[-1])
            rows[m, e] = xb[b, ch[m], gy[m], gx[m] + dx]
    return rows.reshape(-1)


def simulate_launch_bf16(x, w, bias, mode):
    """What one ``shdr_conv_gemm_bf16`` launch writes, lane by lane: the staged
    channel-inner planes (SAME zeros), then per k-step either (BN >= 32) the A
    and B descriptors resolved into core matrices, one m64 tile of 8 x 8
    pixels each, or (BN = 16) the ldmatrix.x4 rows of A and B mapped into
    mma.sync fragments, each A fragment of staged row y used for the warp's
    tile rows y - kh; sums in float64.  The epilogue maps each thread's
    accumulators to pixels as the kernel does, rounds to bf16, stores conv1
    channel-blocked [B, F/8, H, W, 8] and conv2 NCHW: the skip and the pool
    (taken in registers, lane g ^ 1 by shuffle; the max pool's members
    outside the image set to 0, which no ReLU value is below) through their
    shared-memory tiles and 16-byte row copies.  Store modes take NCHW x; pool modes the blocked
    mid."""
    pool = mode in (cg.LEAKY_AVG_POOL, cg.RELU_MAX_POOL)
    xb = _bits(x)
    if pool:
        bsz, c8, h, wd, _ = x.shape
        c = 8 * c8
    else:
        bsz, c, h, wd = x.shape
    f, _, k, _ = w.shape
    p = cg.plan_bf16(c, f, k)
    bn, planes, ksteps = p["bn"], p["planes"], p["ksteps"]
    (th, tw), iw = p["tile"], p["iw"]
    csr = ksteps // k
    sync = cg.sync_path_bf16(bn)
    mt_n, nt_n = (4 if sync else 2), bn // 8
    wpk = _bits(cg.pack_weights(w)).reshape(f // bn, p["chunks"], -1)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    warp = np.arange(8)
    leaky = mode in (cg.LEAKY_STORE, cg.LEAKY_AVG_POOL)
    ph, pw = (h // 2, wd // 2) if mode == cg.LEAKY_AVG_POOL else ((h + 1) // 2, (wd + 1) // 2)
    out = np.full((bsz, f, h, wd) if pool else (bsz, f // 8, h, wd, 8), np.nan, np.float32)
    pooled = np.full((bsz, f, ph, pw), np.nan, np.float32) if pool else None
    # a thread's accumulator d[mt][4 nt + i] -> (tile row, column, channel)
    W_, L_, MT_, NT_, I_ = np.ix_(warp, lane, np.arange(mt_n), np.arange(nt_n), np.arange(4))
    G_, T_ = L_ >> 2, L_ & 3
    if sync:
        row, col = 4 * W_ + MT_ + 0 * I_, G_ + 8 * (I_ >> 1) + 0 * MT_
    else:
        row, col = 8 * (W_ // 4) + 2 * (W_ % 4) + (I_ >> 1) + 0 * MT_, 8 * MT_ + G_ + 0 * I_
    chan = 8 * NT_ + 2 * T_ + (I_ & 1)
    row, col, chan = np.broadcast_arrays(row, col, chan)
    for b in range(bsz):
        for nblk in range(f // bn):
            for ty0 in range(0, h, th):
                for tx0 in range(0, wd, tw):
                    d = np.zeros((8, mt_n, 16, bn)) if sync else np.zeros((2, mt_n, 64, bn))
                    for j in range(p["chunks"]):
                        tile = _stage_tile(xb, pool, b, j, p, c, ty0, tx0, k)
                        wmem = wpk[nblk, j]
                        for c_ in range(csr):
                            if sync:
                                bm = [_b_matrix_sync(_ldmatrix_x4(wmem, (kh * csr + c_) * bn * 32
                                                                  + lane * 16)) for kh in range(k)]
                                a_lane = _sync_a_addresses(p, k, warp, c_)
                                for y in range(mt_n + k - 1):
                                    a = _a_matrix_bf16(_ldmatrix_x4(tile, a_lane + y * iw * 16))
                                    for mt in range(mt_n):
                                        if 0 <= y - mt < k:
                                            d[:, mt] += a @ bm[y - mt]
                                continue
                            kw0 = c_ if planes == 2 else 4 * c_
                            kw1 = c_ if planes == 2 else (4 * c_ + 2 if 4 * c_ + 2 < k else 4 * c_)
                            lead = p["plane_bytes"] if planes == 2 else (kw1 - kw0) * 16
                            for kh in range(k):
                                bmat = _desc_matrix(wmem, _desc((kh * csr + c_) * bn * 32, 128, 256),
                                                    bn)
                                for v in range(2):
                                    for mt in range(mt_n):
                                        start = ((8 * v + kh) * iw + 8 * mt + kw0) * 16
                                        a = _desc_matrix(tile, _desc(start, lead, p["stride_bytes"]),
                                                         64)
                                        d[v, mt] += a @ bmat.T
                    # the D fragments of each thread: mma.sync rows g (+8) of
                    # the warp's m16 tile mt; wgmma rows 16 (warp % 4) + g (+8)
                    # of its warpgroup's m64 tile mt
                    if sync:
                        acc = d[W_, MT_, G_ + 8 * (I_ >> 1), chan]
                    else:
                        acc = d[W_ // 4, MT_, 16 * (W_ % 4) + G_ + 8 * (I_ >> 1), chan]
                    n = nblk * bn + chan
                    v = acc.astype(np.float32) + bias.numpy()[n]
                    v = np.where(v > 0, v, v * np.float32(0.1)) if leaky else np.maximum(v, 0)
                    y, xx = ty0 + row, tx0 + col
                    inside = (y < h) & (xx < wd)
                    if mode == cg.RELU_MAX_POOL:  # members outside the image: 0 (<= any ReLU)
                        v = np.where(inside, v, np.float32(0))
                    if not pool:
                        out[b, n[inside] // 8, y[inside], xx[inside], n[inside] % 8] = \
                            _round_bf16(v[inside])
                        continue
                    # window (y, y + 1) x (xx, xx + 1): mma.sync tile rows mt,
                    # mt + 1 of a thread; wgmma accumulators i, i + 2
                    if sync:
                        sel = (slice(None), slice(None), slice(0, None, 2))
                        below = (slice(None), slice(None), slice(1, None, 2))
                    else:
                        sel = (Ellipsis, slice(0, 2))
                        below = (Ellipsis, slice(2, 4))
                    top, bot, prw, pcl, pch = v[sel], v[below], row[sel], col[sel], chan[sel]
                    if mode == cg.RELU_MAX_POOL:
                        s = np.maximum(top, bot)
                        s = np.maximum(s, s[:, lane ^ 4])
                    else:
                        s = top + bot
                        s = (s + s[:, lane ^ 4]) * np.float32(0.25)
                    # the skip tile [bn][rows * 16 + pad] and the pool tile
                    # [bn][rows / 2 * 8 + pad] in shared memory (even lanes g write
                    # the pool), then 8 columns (16 bytes) a copy
                    even = np.broadcast_to((G_ & 1) == 0, s.shape)
                    es = np.full(bn * p["skip_stride"], np.nan, np.float32)
                    es[chan * p["skip_stride"] + row * tw + col] = _round_bf16(v)
                    ps = np.full(bn * p["pool_stride"], np.nan, np.float32)
                    ps[pch[even] * p["pool_stride"] + prw[even] // 2 * (tw // 2)
                       + pcl[even] // 2] = _round_bf16(s[even])
                    for tile, stride, rows, cols, dst, hh, ww, y0, x0 in (
                            (es, p["skip_stride"], th, tw, out, h, wd, ty0, tx0),
                            (ps, p["pool_stride"], th // 2, tw // 2, pooled, ph, pw, ty0 // 2,
                             tx0 // 2)):
                        k_ = np.arange(bn * rows * (cols // 8))
                        piece = k_ % (cols // 8)
                        srow, sn = k_ // (cols // 8) % rows, k_ // (cols // 8 * rows)
                        for e in range(8):
                            ys, xs = y0 + srow, x0 + 8 * piece + e
                            mm = (ys < hh) & (xs < ww)
                            dst[b, nblk * bn + sn[mm], ys[mm], xs[mm]] = tile[
                                sn[mm] * stride + srow[mm] * cols + 8 * piece[mm] + e]
    return out, pooled


BF16_STAGES = [
    ("encoder_stage2", (1, 3, 19, 21), 64, 3),
    ("encoder_stage2", (1, 64, 17, 18), 128, 3),
    ("unet_stage2", (1, 9, 18, 20), 16, 7),
    ("unet_stage2", (1, 16, 16, 17), 16, 7),
    ("unet_stage2", (2, 16, 17, 16), 32, 5),
    ("unet_stage2", (1, 3, 35, 18), 16, 7),
]


@pytest.mark.parametrize("kernel,shape,f,k", BF16_STAGES,
                         ids=[f"{s[0]}_{s[1][1]}to{s[2]}_k{s[3]}" for s in BF16_STAGES])
def test_simulated_bf16_launches_match_the_bf16_plain_stage(kernel, shape, f, k):
    """Two simulated launches (conv1 stores the blocked mid, conv2 reads it
    back, stores and pools) against the bf16 plain stage.  Both sum the same
    exact products, in float64 here and f32 there, so a stored value differs
    at most where the two sums round to neighbouring bf16 values: within one
    ulp of the largest value (measured: most elements equal)."""
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
    assert mid.shape == tuple(cg.mid_like(x, f).shape)
    act, pooled = simulate_launch_bf16(torch.from_numpy(mid).to(BF16), w2, b2, modes[1])
    want_pool, want_act = (t.float().numpy() for t in plain(x, w1, b1, w2, b2))
    for got, want in ((act, want_act), (pooled, want_pool)):
        assert got.shape == want.shape
        assert np.isfinite(got).all(), "every output element is written"
        assert np.abs(got - want).max() <= ULP * np.abs(want).max()
        assert np.mean(got == want) > 0.9


def test_bf16_mid_is_channel_blocked():
    """conv1's bf16 activation is [B, F/8, H, W, 8] (channel 8 q + e of pixel
    (y, x) at [b, q, y, x, e]); f32 keeps NCHW."""
    x = torch.zeros(2, 3, 5, 7, dtype=BF16)
    assert tuple(cg.mid_like(x, 64).shape) == (2, 8, 5, 7, 8)
    assert cg.mid_like(x, 64).dtype == BF16
    assert tuple(cg.mid_like(x.float(), 64).shape) == (2, 64, 5, 7)
    rs = np.random.RandomState(5)
    xc = torch.from_numpy(rs.rand(1, 3, 6, 5).astype(np.float32)).to(BF16)
    w = torch.from_numpy(rs.randn(16, 3, 7, 7).astype(np.float32) * 0.1).to(BF16)
    b = torch.from_numpy((rs.randn(16) * 0.1).astype(np.float32))
    mid, _ = simulate_launch_bf16(xc, w, b, cg.LEAKY_STORE)
    want = F.leaky_relu(F.conv2d(xc.float(), w.float(), b, padding=3), 0.1).to(BF16).float()
    got = torch.from_numpy(mid).permute(0, 1, 4, 2, 3).reshape(1, 16, 6, 5)
    assert (got - want).abs().max() <= ULP * want.abs().max()


@pytest.mark.parametrize("c", [3, 16], ids=["one_plane", "two_planes"])
def test_bf16_ldmatrix_fragments_are_the_mma_a_layout(c):
    """The stems' ldmatrix.x4 rows, mapped into mma.sync m16n8k16 A
    registers by the PTX layout, are the im2col rows of tile row 4 warp +
    y - kh: A[m, k] is pixel column m of that staged row at the k-step's tap
    and channel (k 0-7 plane 0; k 8-15 plane 1, or the pair's second tap)."""
    k = 7
    p = cg.plan_bf16(c, 16, k)
    ih, iw, planes = p["ih"], p["iw"], p["planes"]
    rs = np.random.RandomState(c)
    tile = _bits(torch.from_numpy(rs.randn(planes * ih * iw * 8).astype(np.float32)).to(BF16))
    vals = _from_bits(tile).reshape(planes, ih, iw, 8)
    for warp in (0, 7):
        for c_ in range(p["ksteps"] // k):
            a_lane = _sync_a_addresses(p, k, warp, c_)
            for y in (0, 4 + k - 2):
                a = _a_matrix_bf16(_ldmatrix_x4(tile, a_lane + y * iw * 16))
                srow = 4 * warp + y
                m = np.arange(16)
                if planes == 2:
                    want = np.concatenate([vals[0, srow, m + c_], vals[1, srow, m + c_]], 1)
                else:
                    kw1 = 4 * c_ + 2 if 4 * c_ + 2 < k else 4 * c_
                    want = np.concatenate([vals[0, srow, m + 4 * c_], vals[0, srow, m + kw1]], 1)
                np.testing.assert_array_equal(a, want)


@pytest.mark.parametrize("c,f,k", MAIN_PATH_CONVS)
def test_bf16_a_fragment_loads_are_bank_conflict_free(c, f, k):
    """Shared-memory accesses of every bf16 layer, in the phases the hardware
    serves 16-byte accesses in (8 lanes, 128 bytes): the staging stores (a
    warp's 32 consecutive rows), the stems' ldmatrix rows of A and B, each
    128-byte core matrix a wgmma descriptor names (A and B), and conv2's
    skip-tile copies touch each bank once; the skip tile's 2-byte stores
    touch each bank in one word."""
    p = cg.plan_bf16(c, f, k)

    def distinct(byte_rows):  # 8 16-byte rows: 32 distinct banks
        banks = ((np.asarray(byte_rows)[:, None] + 4 * np.arange(4)) // 4 % 32).ravel()
        return len(np.unique(banks)) == 32

    rows = np.arange(p["planes"] * p["ih"] * p["iw"] + 32) * 16
    for start in range(0, rows.size - 32, 32):
        assert all(distinct(rows[start + 8 * q:start + 8 * q + 8]) for q in range(4))
    bn, planes, ksteps = p["bn"], p["planes"], p["ksteps"]
    # conv2's skip tile: each 2-byte store of a warp (one accumulator of
    # every lane) on distinct words a bank, and the 16-byte copies out
    (th, tw), es = p["tile"], p["skip_stride"]
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    sync = cg.sync_path_bf16(bn)
    for warp in range(8):
        for mt in range(4 if sync else 2):
            for i in range(4):
                row = 4 * warp + mt if sync else 8 * (warp // 4) + 2 * (warp % 4) + (i >> 1)
                col = g + 8 * (i >> 1) if sync else 8 * mt + g
                for nt in range(bn // 8):
                    words = np.unique(((8 * nt + 2 * t + (i & 1)) * es + row * tw + col) // 2)
                    assert len(np.unique(words % 32)) == len(words), (warp, mt, i, nt)
                    if i < 2 or sync:  # a window's top row: even lanes g, into the pool tile
                        pw_ = ((8 * nt + 2 * t + (i & 1)) * p["pool_stride"] + row // 2 * (tw // 2)
                               + col // 2)[(g & 1) == 0]
                        words = np.unique(pw_ // 2)
                        assert len(np.unique(words % 32)) == len(words), (warp, mt, i, nt)
    k_ = np.arange(bn * th * (tw // 8))
    copies = (k_ // (tw // 8 * th) * es + k_ // (tw // 8) % th * tw + 8 * (k_ % (tw // 8))) * 2
    for start in range(0, copies.size, 8):
        assert distinct(copies[start:start + 8])
    k_ = np.arange(bn * th // 2)
    copies = (bn * es + k_ // (th // 2) * p["pool_stride"] + k_ % (th // 2) * (tw // 2)) * 2
    for start in range(0, copies.size, 8):
        assert distinct(copies[start:start + 8])
    csr = ksteps // k
    lane = np.arange(32)
    if cg.sync_path_bf16(bn):
        for warp in range(8):
            for c_ in range(csr):
                a_lane = _sync_a_addresses(p, k, warp, c_)
                for y in range(4 + k - 1):
                    addr = a_lane + y * p["iw"] * 16
                    assert all(distinct(addr[8 * q:8 * q + 8]) for q in range(4)), (warp, c_, y)
                for kh in range(k):
                    addr = (kh * csr + c_) * bn * 32 + lane * 16
                    assert all(distinct(addr[8 * q:8 * q + 8]) for q in range(4))
        return
    for c_ in range(csr):
        kw0 = c_ if planes == 2 else 4 * c_
        kw1 = c_ if planes == 2 else (4 * c_ + 2 if 4 * c_ + 2 < k else 4 * c_)
        lead = p["plane_bytes"] if planes == 2 else (kw1 - kw0) * 16
        for kh in range(k):
            for v in range(2):
                for mt in range(2):
                    start = ((8 * v + kh) * p["iw"] + 8 * mt + kw0) * 16
                    for core_m in range(8):
                        for core_k in range(2):
                            base = start + core_m * p["stride_bytes"] + core_k * lead
                            assert distinct(base + 16 * np.arange(8))
            for ng in range(bn // 8):
                for kc in range(2):
                    assert distinct((kh * csr + c_) * bn * 32 + 256 * ng + 128 * kc
                                    + 16 * np.arange(8))


# K3 in bf16 (csrc/lin_stem.cu, lin_stem_bf16_kernel): a producer warpgroup
# builds each 16-channel chunk's features into one of two channel-inner
# buffers, two consumer warpgroups run wgmma on them and on the B ring by
# descriptor, one loader thread copies B with cp.async.bulk; mbarriers hand
# buffers and ring slots over.


def _stem_constants():
    """The constexpr ints and bools of csrc/lin_stem.cu (and common.cuh),
    evaluated in order: the kernel's own plan."""
    from singlehdr_tpu_torch.ops.cuda import _build

    env = {}
    for name in ("common.cuh", "lin_stem.cu"):
        text = (_build.CSRC / name).read_text()
        for key, expr in re.findall(r"^constexpr (?:int|bool) (\w+) = ([^;]+);", text, re.M):
            expr = expr.replace("true", "True").replace("false", "False").replace("/", "//")
            env[key] = eval(expr, {}, dict(env))
    return env


def test_bf16_stem_plan_is_the_kernels():
    """``plan_bf16`` mirrors the kernel's constants: the ring, the roles, the
    buffers' lead and stride and every shared-memory offset."""
    c, p = _stem_constants(), k3.plan_bf16()
    assert (c["TO"], c["kRingBf16"], c["kConsumerWarps"], c["kProducerWarps"]) == \
        (k3.TILE, p["ring_slots"], p["consumer_warps"], p["producer_warps"])
    assert (c["kSliceBytesBf16"], c["kSlicesBf16"], c["kKstepBytesBf16"]) == \
        (p["slice_bytes"], p["slices"], p["kstep_bytes"])
    assert (c["kGroupBytes"], c["kOutRowBytes"], c["kFeatBytes"]) == \
        (p["lead_bytes"], p["stride_bytes"], p["feat_bytes"])
    assert (c["kFeatOffsetBf16"], c["kImgOffsetBf16"], c["kBarOffsetBf16"], c["kSmemBf16"]) == \
        (p["feat_offset"], p["img_offset"], p["bar_offset"], p["smem_bytes"])
    assert c["kThreadsBf16"] == p["threads"] and c["kMaxSmemBytes"] == cg.SMEM_LIMIT


def _stem_descriptor_starts():
    """Every feature-operand start a consumer's descriptors name, as byte
    offsets into a buffer: (ky, kx, consumer warpgroup)."""
    return np.array([(ky * k3.ROW + (kx & 1) * k3.PARITY_WIDTH + (kx >> 1) + 8 * cw) * 16
                     for ky in range(7) for kx in range(7) for cw in range(2)])


def test_bf16_stem_plan_fits_the_card():
    """One block an SM within 227 KB; the descriptors' lead and stride and
    every start address fit their 14-bit fields (16-byte units), every core
    matrix starts on 16 bytes, and an operand's last core matrix stays in
    its buffer (features: N = 128 pixels, 16 core matrices) or its slot
    (weights).  A 32-row tile's two buffers do not fit beside the ring."""
    p = k3.plan_bf16()
    assert p["fits"] and p["smem_bytes"] <= cg.SMEM_LIMIT and p["blocks_per_sm"] == 1
    assert p["threads"] == 32 * (8 + 8 + 1)
    for field in (p["lead_bytes"], p["stride_bytes"], p["smem_bytes"], p["slice_bytes"]):
        assert field % 16 == 0 and field >> 4 < 2 ** 14
    assert p["feat_offset"] % 16 == 0 and p["feat_bytes"] % 16 == 0 and p["bar_offset"] % 8 == 0
    assert p["img_offset"] >= p["feat_offset"] + 2 * p["feat_bytes"]
    starts = _stem_descriptor_starts()
    assert (starts % 16 == 0).all()
    last = starts.max() + 15 * p["stride_bytes"] + p["lead_bytes"] + 128
    assert last <= p["feat_bytes"]
    w_last = 6 * p["kstep_bytes"] + 7 * 256 + 128 + 128  # tap 6: n8 group 7, k half 1
    assert w_last <= p["slice_bytes"]
    assert not k3.plan_bf16(32)["fits"]
    assert k3.plan_bf16(32)["lead_bytes"] >> 4 < 2 ** 14


def test_bf16_stem_weight_rows_reproduce_conv2d():
    """The bf16 B rows in K order (chunk, tap, 16 channels; 93 padded to 96
    with zero rows) times the im2col of the built features is the stride-2
    SAME conv, in float64; the packing puts a k-step's rows in wgmma's core
    matrices, as the consumers' weight descriptors read them."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(2, 3, 19, 22).astype(np.float32))
    k7 = torch.from_numpy((rs.randn(64, N_FEATURES, 7, 7) * 0.05).astype(np.float32)).to(BF16)
    rows = k3.stem_weight_rows_bf16(k7)
    assert rows.dtype == BF16 and rows.shape == (k3.CHUNKS_BF16 * 49 * 16, 64)
    r = rows.double().reshape(k3.CHUNKS_BF16, 49, 16, 64)
    chan = torch.arange(k3.CHUNKS_BF16)[:, None, None] * 16 + torch.arange(16)
    assert not r[(chan >= N_FEATURES).expand(k3.CHUNKS_BF16, 49, 16)].any()
    feats = linearization_features(x).double()
    pt, pb = same_pads(19, 7, 2)
    pl, pr = same_pads(22, 7, 2)
    fp = F.pad(F.pad(feats, (pl, pr, pt, pb)), (0, 0, 0, 0, 0, k3.C_PAD - N_FEATURES))
    ho, wo = 10, 11
    taps = torch.stack([fp[:, :, ky:ky + 2 * ho:2, kx:kx + 2 * wo:2]
                        for ky in range(7) for kx in range(7)], 1)  # [b, tap, c, ho, wo]
    a = taps.reshape(2, 49, k3.CHUNKS_BF16, 16, ho, wo).permute(0, 4, 5, 2, 1, 3)
    got = (a.reshape(2 * ho * wo, -1) @ rows.double()).reshape(2, ho, wo, -1).permute(0, 3, 1, 2)
    want = F.conv2d(F.pad(feats, (pl, pr, pt, pb)), k7.double(), stride=2)
    assert torch.abs(got - want).max() <= 1e-12 * torch.abs(want).max()
    slot = _bits(k3.pack_stem_weights(k7)).reshape(k3.CHUNKS_BF16 * 7, -1)
    p = k3.plan_bf16()
    bits = _bits(rows).reshape(k3.CHUNKS_BF16, 49, 16, 64)
    for s, kx in ((0, 0), (17, 4), (41, 6)):
        a_w = _desc_matrix(slot[s], _desc(kx * p["kstep_bytes"], 128, 256), 64)  # [64 n, 16 k]
        np.testing.assert_array_equal(a_w, _from_bits(bits[s // 7, 7 * (s % 7) + kx]).T)


def test_bf16_stem_producer_stores_are_bank_conflict_free():
    """The producers' 16-byte stores of a warp (consecutive rows of one
    8-channel group), in the 8-lane phases the hardware serves them in,
    touch each bank once; so does every 128-byte core matrix a feature
    descriptor names."""
    p = k3.plan_bf16()
    rows = p["group_bytes"] // 16
    threads = 32 * p["producer_warps"]

    def distinct(byte_rows):
        banks = ((np.asarray(byte_rows)[:, None] + 4 * np.arange(4)) // 4 % 32).ravel()
        return len(np.unique(banks)) == len(banks)

    for k in range(-(-rows // threads)):
        for warp in range(p["producer_warps"]):
            e = k * threads + 32 * warp + np.arange(32)
            e = e[e < rows]
            for h in range(2):
                addr = p["feat_offset"] + h * p["group_bytes"] + 16 * e
                for q in range(0, addr.size, 8):
                    assert distinct(addr[q:q + 8]), (k, warp, h, q)
    for start in _stem_descriptor_starts():
        for core in range(16):
            assert distinct(start + core * p["stride_bytes"] + 16 * np.arange(8))


class _Mbarrier:
    """An mbarrier: a phase completes when its ``count`` arrivals are in and
    its expected transaction bytes have landed; a wait on parity P passes
    once the phase of that parity has completed (the phase count's parity
    differs from P)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, tx=0):
        self.tx += tx
        self.pending -= 1
        self._complete()

    def complete_tx(self, n):
        self.tx -= n
        self._complete()

    def _complete(self):
        assert self.pending >= 0, "more arrivals than the barrier's count"
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passed(self, parity):
        return (self.phase & 1) != parity


def _stem_chunk_rows(img, j, ry0, rx0, h, w):
    """Chunk j's buffer as the producers write it: uint16 [2 groups, rows,
    8]; row e is receptive row e // ROW at parity entry e % ROW, each feature
    computed in f32 and rounded to bf16 once, zeros outside the image (and
    at the odd plane's unused entry)."""
    e = np.arange(k3.FIELD * k3.ROW)
    ry, idx = e // k3.ROW, e % k3.ROW
    rx = np.where(idx < k3.PARITY_WIDTH, 2 * idx, 2 * (idx - k3.PARITY_WIDTH) + 1)
    inside = (rx < k3.FIELD) & (ry0 + ry >= 0) & (ry0 + ry < h) & (rx0 + rx >= 0) & (rx0 + rx < w)
    a, b = ry + 1, np.minimum(rx, k3.FIELD - 1) + 1
    vals = np.zeros((16, e.size), np.float32)
    for cl in range(16):
        if 16 * j + cl < N_FEATURES:
            vals[cl] = np.where(inside, _feature(img, 16 * j + cl, a, b), np.float32(0))
    bits = _bits(torch.from_numpy(vals).to(BF16))  # [16, rows]
    return bits.reshape(2, 8, e.size).transpose(0, 2, 1)


def simulate_stem_bf16(x, k7, bias, seed=0, blocks=2):
    """What one ``shdr_lin_stem_bf16`` launch of ``blocks`` blocks writes,
    each block walking the tiles blockIdx, + blocks, ... with its slice and
    chunk counts running on across them.  A block's three roles run in an
    interleaving drawn from ``seed`` over a model of the kernel's mbarriers:
    the loader's bulk copies of B slices into the ring (landing later, in any
    order), the producer's image staging and chunks into the two feature
    buffers (in pieces), the consumer warpgroups' wgmma groups, one a kernel
    row, each reading shared memory when it completes (in order, at the
    latest when ``wgmma_wait`` needs it), the releases of slots and buffers
    and each tile's epilogue.  Shared memory starts as bf16 NaNs, so a read
    of a row nobody wrote, or of a slot or buffer refilled too early, shows
    in the output.  Operands are resolved from the descriptors' bits into
    core matrices, products summed in float64; the epilogue maps each
    thread's accumulators to channels and pixels as the kernel does, rounds
    to bf16 and stores NCHW."""
    p = k3.plan_bf16()
    bsz, _, h, w = x.shape
    ho, wo = -(-h // 2), -(-w // 2)
    pad_t, pad_l = same_pads(h, 7, 2)[0], same_pads(w, 7, 2)[0]
    wpk = _bits(k3.pack_stem_weights(k7)).reshape(p["slices"], -1)
    slots, slice_bytes, field = p["ring_slots"], p["slice_bytes"], k3.FIELD
    xf, bias = x.float().numpy(), bias.numpy()
    out = np.full((bsz, 64, ho, wo), np.nan, np.float32)
    rng = np.random.RandomState(seed)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    tiles = [(b, oy0, ox0) for b in range(bsz) for oy0 in range(0, ho, k3.TILE)
             for ox0 in range(0, wo, k3.TILE)]
    for block in range(min(blocks, len(tiles))):
        mine = tiles[block::blocks]
        mem = np.full(p["smem_bytes"] // 2, 0xFFFF, np.uint16)
        full_b = [_Mbarrier(1) for _ in range(slots)]
        empty_b = [_Mbarrier(8) for _ in range(slots)]
        full_f = [_Mbarrier(32 * p["producer_warps"]) for _ in range(2)]
        empty_f = [_Mbarrier(8) for _ in range(2)]
        copies, groups, acc = [], [[], []], [None, None]

        def loader():
            q = 0
            for _ in mine:
                for s in range(p["slices"]):
                    slot = q % slots
                    if q >= slots:
                        yield empty_b[slot], (q // slots - 1) & 1
                    full_b[slot].arrive(tx=slice_bytes)
                    copies.append((slot, s))
                    q += 1
                    yield None

        def producer():
            j = 0
            for b, oy0, ox0 in mine:
                ry0, rx0 = 2 * oy0 - pad_t, 2 * ox0 - pad_l
                gy = _reflect_clamp(ry0 - 1 + np.arange(field + 2), h)
                gx = _reflect_clamp(rx0 - 1 + np.arange(field + 2), w)
                img = xf[b][:, gy][:, :, gx]
                for c in range(k3.CHUNKS_BF16):
                    if j >= 2:
                        yield empty_f[j & 1], ((j >> 1) - 1) & 1
                    rows = _stem_chunk_rows(img, c, ry0, rx0, h, w)
                    base = (p["feat_offset"] + (j & 1) * p["feat_bytes"]) // 2
                    for piece in np.array_split(np.arange(rows.shape[1]), 4):
                        for grp in range(2):
                            at = base + grp * p["group_bytes"] // 2 + 8 * piece
                            mem[at[:, None] + np.arange(8)] = rows[grp, piece]
                        yield None
                    for _ in range(32 * p["producer_warps"]):
                        full_f[j & 1].arrive()
                    j += 1

        def release(q):
            for _ in range(4):  # lane 0 of each warp of the warpgroup
                empty_b[q % slots].arrive()
                if q % 7 == 6:
                    empty_f[(q // 7) & 1].arrive()

        def consumer(cw):
            q = 0
            for b, oy0, ox0 in mine:
                acc[cw] = np.zeros((64, 128))  # M = 64 channels, N = 16 rows x 8 columns
                for s in range(p["slices"]):
                    j, ky = divmod(q, 7)
                    if ky == 0:
                        yield full_f[j & 1], (j >> 1) & 1
                    yield full_b[q % slots], (q // slots) & 1
                    wst = (q % slots) * slice_bytes
                    fst = p["feat_offset"] + (j & 1) * p["feat_bytes"]
                    ops = []
                    for kx in range(7):
                        col = (kx & 1) * k3.PARITY_WIDTH + (kx >> 1)
                        f = fst + (ky * k3.ROW + col + 8 * cw) * 16
                        ops.append((_desc(wst + kx * p["kstep_bytes"], 128, 256),
                                    _desc(f, p["lead_bytes"], p["stride_bytes"])))
                    groups[cw].append(ops)
                    q += 1
                    yield "wgmma_wait", 1
                    if s > 0:
                        release(q - 2)
                yield "wgmma_wait", 0
                release(q - 1)
                _stem_epilogue(out, acc[cw], cw, b, oy0, ox0, bias)

        def run_group(cw):  # wgmma m64n128k16: D += A (weights) B (features)^T
            for a_desc, b_desc in groups[cw].pop(0):
                acc[cw] += _desc_matrix(mem, a_desc, 64) @ _desc_matrix(mem, b_desc, 128).T

        roles = {"loader": loader(), "producer": producer(), 0: consumer(0), 1: consumer(1)}
        waits = dict.fromkeys(roles)
        while roles or copies or groups[0] or groups[1]:
            moves = []
            for name in roles:
                wait = waits[name]
                if wait is None or (wait[0] == "wgmma_wait" and len(groups[name]) <= wait[1]) \
                        or (wait[0] != "wgmma_wait" and wait[0].passed(wait[1])):
                    moves.append(("role", name))
            moves += [("copy", i) for i in range(len(copies))]
            moves += [("group", cw) for cw in range(2) if groups[cw]]
            assert moves, "deadlock: every role waits"
            kind, key = moves[rng.randint(len(moves))]
            if kind == "copy":
                slot, s = copies.pop(key)
                mem[slot * slice_bytes // 2:(slot + 1) * slice_bytes // 2] = wpk[s]
                full_b[slot].complete_tx(slice_bytes)
            elif kind == "group":
                run_group(key)
            else:
                try:
                    waits[key] = next(roles[key])
                except StopIteration:
                    del roles[key]
    return out


def _stem_epilogue(out, d, cw, b, oy0, ox0, bias):
    """A consumer warpgroup's stores: thread (warp 4 cw + wq, lane g t) holds
    d[4 r + i] = D[16 wq + g + 8 (i >> 1), 8 r + 2t + (i & 1)] of its
    warpgroup's accumulator D (the m64n128k16 fragment): channel
    16 wq + g + 8 (i >> 1), output row r, column 8 cw + 2t + (i & 1)."""
    _, _, ho, wo = out.shape
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for wq in range(4):
        for i in range(4):
            n = 16 * wq + g + 8 * (i >> 1)
            for r in range(k3.TILE):
                oy, ox = oy0 + r, ox0 + 8 * cw + 2 * t + (i & 1)
                if oy < ho:
                    v = d[n, 8 * r + 2 * t + (i & 1)].astype(np.float32) + bias[n]
                    m = ox < wo
                    out[b, n[m], oy, ox[m]] = _round_bf16(np.maximum(v, 0))[m]


def _stem_case(hw):
    rs = np.random.RandomState(hw[0] + hw[1])
    x = torch.from_numpy(rs.rand(1, 3, *hw).astype(np.float32)).to(BF16)
    k7 = torch.from_numpy((rs.randn(64, N_FEATURES, 7, 7) * np.sqrt(2.0 / (93 * 49))
                           ).astype(np.float32)).to(BF16)
    bias = torch.from_numpy((rs.randn(64) * 0.1).astype(np.float32))
    return x, k7, bias


def _check_simulated_stem(got, x, k7, bias):
    want = k3.lin_feature_stem_plain(x, k7, bias).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all(), "every output element is written"
    assert np.abs(got - want).max() <= ULP * np.abs(want).max()
    assert np.mean(got == want) > 0.9


@pytest.mark.parametrize("hw", [(37, 50), (32, 32), (37, 53)], ids=["37x50", "one_tile", "37x53"])
def test_simulated_bf16_stem_matches_the_bf16_plain_stem(hw):
    """One launch of the tree's orientation, lane by lane, against the bf16
    plain stem: both sum the same exact products (f32 there, float64 here),
    so a value differs only where the two round to neighbouring bf16 values.
    (37, 53): ragged tiles along both axes, odd SAME pads, REFLECT at every
    edge of the image inside the tiles' fields."""
    x, k7, bias = _stem_case(hw)
    pk = k3.pack_stem_weights(k7)
    assert pk.dtype == BF16 and pk.shape == (1, k3.CHUNKS_BF16, 49, 1, 8, 2, 8, 8)
    _check_simulated_stem(simulate_stem_bf16(x, k7, bias, seed=hw[1]), x, k7, bias)


@pytest.mark.parametrize("seed,blocks", [(1, 1), (2, 3)])
def test_simulated_bf16_stem_interleavings_agree(seed, blocks):
    """Other interleavings of the roles, and other numbers of blocks (one
    block walking all four tiles; three, one of which takes two), write the
    same stem."""
    x, k7, bias = _stem_case((37, 53))
    got = simulate_stem_bf16(x, k7, bias, seed=seed, blocks=blocks)
    _check_simulated_stem(got, x, k7, bias)
    np.testing.assert_array_equal(got, simulate_stem_bf16(x, k7, bias, seed=seed + 10))


def test_stem_variants_edit_the_kernel_source_once():
    """tools/stem_variants' variants are text edits of the tree's
    csrc/lin_stem.cu: each edit matches exactly once."""
    from singlehdr_tpu_torch.ops.cuda import _build
    from singlehdr_tpu_torch.tools import stem_variants as sv

    text = (_build.CSRC / "lin_stem.cu").read_text()
    for name in sv.VARIANTS:
        assert sv.edited_source(name, text) != text
    assert set(sv.VARIANTS) == set(sv.CHOICES) | set(sv.ABLATIONS)


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


def test_conv_variants_edit_the_kernel_source_once():
    """tools/conv_variants' design variants are text edits of the tree's
    csrc/conv2_pool.cu: each edit matches exactly once, so a variant stays
    the tree's kernel but for the one choice it names."""
    from singlehdr_tpu_torch.ops.cuda import _build
    from singlehdr_tpu_torch.tools import conv_variants as cv

    text = (_build.CSRC / "conv2_pool.cu").read_text()
    for name in cv.SOURCE_EDITS:
        assert cv.edited_source(name, text) != text
    assert set(cv.VARIANTS) == set(cv.SOURCE_EDITS) | set(cv.PLAN_VARIANTS)
    undo = cv.sixteen_channel_plan()
    try:
        assert cg.conv_plan(3, 16, 7, BF16) == (16, 16, 16 * 49)
    finally:
        undo()
    assert cg.conv_plan(3, 16, 7, BF16) == (16, 4, 16 * 14)
