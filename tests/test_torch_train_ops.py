"""CPU parity of the port's training ops against the JAX package.

K1's backward (``ApplyRf`` -> ``apply_rf_bwd_plain`` on CPU tensors) is held
to ``jax.grad`` of the xla form of ``apply_rf`` and to the Pallas
``_bwd_kernel`` itself, run in interpret mode from the module's own
``_pad_args``/``_pixel_spec``/``_curve_spec``; then the tie rules of
``monotonic_rf`` and ``clip``, tonemaps, losses, the exposure mask, the VGG16
surrogate, the deterministic capture chain, and BatchNorm in train mode.
Inputs are seeded numpy; tolerances are stated per test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from singlehdr_tpu import models as jm
from singlehdr_tpu.models import vgg16 as jvgg
from singlehdr_tpu.ops import curves as jcurves
from singlehdr_tpu.ops import degradation as jdeg
from singlehdr_tpu.ops import losses as jlosses
from singlehdr_tpu.ops import masks as jmasks
from singlehdr_tpu.ops import tonemap as jtone
from singlehdr_tpu.ops.pallas import apply_rf_pallas as jk1
from singlehdr_tpu_torch import models as tm
from singlehdr_tpu_torch.convert import from_jax_variables, load_jax_variables
from singlehdr_tpu_torch.models.vgg16 import Vgg16Features, load_vgg16_params
from singlehdr_tpu_torch.ops import cuda as kernels
from singlehdr_tpu_torch.ops import degradation, losses, tonemap
from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf, apply_rf_bwd_plain
from singlehdr_tpu_torch.ops.curves import monotonic_rf
from singlehdr_tpu_torch.ops.masks import clip, exposure_loss_mask

from test_torch_models import seeded_variables

ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _k1_inputs(b, n, seed, k=1024):
    """x with values below 0, above 1, exactly 0 and 1, and on bin edges."""
    rs = np.random.RandomState(seed)
    x = (rs.rand(b, n) * 1.4 - 0.2).astype(np.float32)
    x[:, : n // 10] = 1.0
    x[:, n // 10: n // 10 + 7] = 0.0
    x[:, n // 5: n // 5 + 9] = np.arange(9, dtype=np.float32) * 37 / (k - 1)
    rf = np.asarray(jcurves.monotonic_rf(jnp.asarray(rs.rand(b, k).astype(np.float32))))
    g = rs.randn(b, n).astype(np.float32)
    return x, rf, g


def _interpret_bwd(x, rf, g):
    """The Pallas _bwd_kernel under the interpreter, cut back to [b, n] / [b, k]."""
    b, k = rf.shape
    flat, rf_t, n, n_pad, b_pad = jk1._pad_args(jnp.asarray(x), jnp.asarray(rf), k)
    gflat = jnp.pad(jnp.asarray(g), ((0, b_pad), (0, n_pad)))
    gx, grf_t = pl.pallas_call(
        functools.partial(jk1._bwd_kernel, k=k),
        grid=(flat.shape[0] // jk1.GROUP, flat.shape[1] // jk1.BLOCK),
        in_specs=[jk1._pixel_spec(), jk1._curve_spec(k), jk1._pixel_spec()],
        out_specs=[jk1._pixel_spec(), jk1._curve_spec(k)],
        out_shape=[jax.ShapeDtypeStruct(flat.shape, jnp.float32),
                   jax.ShapeDtypeStruct(rf_t.shape, jnp.float32)],
        interpret=True,
    )(flat, rf_t, gflat)
    return (np.asarray(gx)[:b, :n],
            np.asarray(grf_t)[:b].transpose(0, 2, 1).reshape(b, k))


def _torch_grads(x, rf, g, need=(True, True)):
    xt = torch.from_numpy(x).requires_grad_(need[0])
    rft = torch.from_numpy(rf).requires_grad_(need[1])
    (apply_rf(xt, rft) * torch.from_numpy(g)).sum().backward()
    return xt.grad, rft.grad


def _assert_rel(got, want, rel):
    scale = float(np.abs(want).max())
    assert scale > 0
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)


# --- K1 backward ------------------------------------------------------------


@pytest.mark.parametrize("b,n", [(3, 700), (8, 1024), (1, 513)])
def test_apply_rf_grad_matches_jax_grad_and_interpreted_bwd_kernel(b, n):
    # b = 3 and 1 are not multiples of the kernel's 8-sample group, and n =
    # 700 and 513 not multiples of its 512-pixel block: both pad in _pad_args
    x, rf, g = _k1_inputs(b, n, seed=b * n)
    gx, grf = _torch_grads(x, rf, g)

    def objective(xx, cc):
        return jnp.sum(jcurves.apply_rf(xx, cc, impl="xla") * g)

    jgx, jgrf = jax.grad(objective, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(rf))
    kgx, kgrf = _interpret_bwd(x, rf, g)
    # 1e-6 of max|ref|: the kernel and the xla autodiff differ only in f32
    # sum order (measured 1e-7 on gx, 3e-7 on grf)
    for want_gx, want_grf in ((np.asarray(jgx), np.asarray(jgrf)), (kgx, kgrf)):
        _assert_rel(gx.numpy(), want_gx, 1e-6)
        _assert_rel(grf.numpy(), want_grf, 1e-6)


def test_apply_rf_grad_follows_needs_input_grad():
    x, rf, g = _k1_inputs(2, 300, seed=1)
    both_gx, both_grf = _torch_grads(x, rf, g)
    gx, grf = _torch_grads(x, rf, g, need=(False, True))
    assert gx is None and torch.equal(grf, both_grf)
    gx, grf = _torch_grads(x, rf, g, need=(True, False))
    assert grf is None and torch.equal(gx, both_gx)
    # the plain backward allocates nothing it is not asked for
    assert apply_rf_bwd_plain(torch.from_numpy(x), torch.from_numpy(rf), torch.from_numpy(g),
                              False, True)[0] is None


def test_apply_rf_gradcheck_float64():
    rs = np.random.RandomState(2)
    k = 8  # wide bins: the finite difference steps stay inside one bin
    x = torch.from_numpy(rs.rand(2, 3, 4, 5) * 1.2 - 0.1).requires_grad_()
    rf = torch.from_numpy(np.sort(rs.rand(2, k), axis=1)).requires_grad_()
    assert torch.autograd.gradcheck(apply_rf, (x, rf), eps=1e-6, atol=1e-8)


def test_cpu_backward_counts_no_launch():
    kernels.reset_launches()
    _torch_grads(*_k1_inputs(2, 100, seed=3))
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}


# --- tie rules --------------------------------------------------------------


def _tied_curves():
    """Row 0: tied minimum steps (-0.2 twice); row 1: minimum step exactly 0
    (a lift of exactly 0); row 2: a plain random curve."""
    rs = np.random.RandomState(4)
    steps = rs.uniform(0.01, 0.05, (3, 15)).astype(np.float32)
    steps[0, 3] = steps[0, 9] = -0.25
    steps[1, 5] = 0.0
    steps[2] = rs.uniform(-0.05, 0.05, 15)
    return np.concatenate([np.zeros((3, 1), np.float32), np.cumsum(steps, 1)], 1).astype(np.float32)


def test_monotonic_rf_gradient_follows_jax_tie_rules():
    rf = _tied_curves()
    # cotangents of 0.25 N(0, 1) keep the gradients below ~0.2, where the f32
    # cancellation in the renormalisation's gradient stays under 1e-6; a wrong
    # tie rule moves them by ~1e-2
    w = (0.25 * np.random.RandomState(5).randn(*rf.shape)).astype(np.float32)
    want = jax.grad(lambda c: jnp.sum(jcurves.monotonic_rf(c) * w))(jnp.asarray(rf))
    t = torch.from_numpy(rf).requires_grad_()
    out = monotonic_rf(t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jcurves.monotonic_rf(jnp.asarray(rf))),
                               atol=1e-6)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-6)


def test_clip_gradient_is_half_at_the_bounds():
    x = np.asarray([-0.5, 0.0, 0.3, 1.0, 1.5], np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    clip(t, 0.0, 1.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(t.grad.numpy(), [0.0, 0.5, 1.0, 0.5, 0.0])


# --- tonemaps, losses, masks ------------------------------------------------


def test_tonemaps_match_jax():
    x = np.random.RandomState(6).rand(2, 5, 6, 3).astype(np.float32) * 3
    for ours, theirs in ((tonemap.mu_tonemap, jtone.mu_tonemap),
                         (tonemap.hdr_log_compression, jtone.hdr_log_compression)):
        # atol: hdr_log_compression subtracts 1, so values near 0 carry 1 ulp of 1
        np.testing.assert_allclose(_nhwc(ours(_nchw(x))), np.asarray(theirs(jnp.asarray(x))),
                                   rtol=1e-6, atol=2.4e-7)
    c = np.asarray(jtone.hdr_log_compression(jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tonemap.hdr_log_decompression(_nchw(c))),
                               np.asarray(jtone.hdr_log_decompression(jnp.asarray(c))), rtol=1e-6)


def test_losses_match_jax():
    rs = np.random.RandomState(7)
    a, b = (rs.rand(2, 8, 10, 3).astype(np.float32) for _ in range(2))
    mask = np.asarray([1.0, 0.0], np.float32).reshape(2, 1, 1, 1)
    ta, tb, tmask = _nchw(a), _nchw(b), torch.from_numpy(mask)
    for ours, theirs in ((losses.masked_l2, jlosses.masked_l2), (losses.masked_l1, jlosses.masked_l1)):
        np.testing.assert_allclose(ours(ta, tb, tmask).numpy(), np.asarray(theirs(a, b, mask)),
                                   rtol=1e-6)
    np.testing.assert_allclose(float(losses.tv_loss(ta)), float(jlosses.tv_loss(jnp.asarray(a))),
                               rtol=1e-6)
    feats = [rs.rand(2, 4, 4, c).astype(np.float32) for c in (3, 5)]
    feats2 = [rs.rand(*f.shape).astype(np.float32) for f in feats]
    np.testing.assert_allclose(
        losses.perceptual_l1([_nchw(f) for f in feats], [_nchw(f) for f in feats2]).numpy(),
        np.asarray(jlosses.perceptual_l1(feats, feats2)), rtol=1e-6)
    assert float(losses.scalar_from_per_sample(ta)) == pytest.approx(float(a.sum()), rel=1e-6)


def test_hallucination_loss_and_vgg_match_jax():
    params = load_vgg16_params()
    jparams = jvgg.load_vgg16_params()
    # the seeded He surrogate: the same draws in the same order
    assert set(params) == set(jparams)
    for name in params:
        for ours, theirs in zip(params[name], jparams[name]):
            np.testing.assert_array_equal(ours, theirs)
    vgg, jvgg_net = Vgg16Features(), jvgg.Vgg16Features()
    assert not any(p.requires_grad for p in vgg.parameters())
    vgg.train()
    assert not vgg.training
    rs = np.random.RandomState(8)
    y, t = rs.rand(2, 16, 16, 3).astype(np.float32), (rs.rand(2, 16, 16, 3) * 2).astype(np.float32)
    for got, want in zip(vgg(_nchw(y)), jvgg_net(jnp.asarray(y))):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want),
                                   atol=ATOL * float(np.abs(want).max()))
    mask = np.ones((2, 1, 1, 1), np.float32)
    got = losses.hallucination_loss(_nchw(y), _nchw(t), vgg, torch.from_numpy(mask))
    want = jlosses.hallucination_loss(jnp.asarray(y), jnp.asarray(t), jvgg_net, jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_exposure_loss_mask_matches_jax():
    rs = np.random.RandomState(9)
    levels = rs.randint(0, 256, (4, 256, 256, 3)).astype(np.float32)
    levels[1] = 252  # over-exposed
    levels[2, :200] = 2  # under-exposed on more than half the pixels
    levels[3, :100] = 255  # over-exposed on less than half
    want = np.asarray(jmasks.exposure_loss_mask(jnp.asarray(levels)))
    got = exposure_loss_mask(_nchw(levels)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.ravel(), [1, 0, 0, 1])
    np.testing.assert_array_equal(
        degradation.loss_mask_from_levels(_nchw(levels.astype(np.uint8))).numpy(), want)


def test_jpeg_quality_ladder_matches_jax():
    for b in (1, 2, 16):
        assert degradation.jpeg_quality_ladder(b) == jdeg.jpeg_quality_ladder(b)


def test_capture_chain_matches_jax_given_its_noise():
    rs = np.random.RandomState(10)
    b, h, w = 3, 8, 12
    hdr = (rs.rand(b, h, w, 3) * 2).astype(np.float32)
    crf = np.asarray(jcurves.monotonic_rf(jnp.asarray(rs.rand(b, 1024).astype(np.float32))))
    t = rs.uniform(0.5, 4, b).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jdeg.simulate_capture(key, jnp.asarray(hdr), jnp.asarray(crf), jnp.asarray(t))
    # the fields simulate_capture draws, from the same key split
    k_s, k_c, k_ns, k_nc = jax.random.split(key, 4)
    noise = degradation.CaptureNoise(
        _nchw(np.asarray(jdeg.SHOT_SIGMA * jax.random.uniform(k_s, (b, 1, 1, 3)))),
        _nchw(np.asarray(jdeg.READ_SIGMA * jax.random.uniform(k_c, (b, 1, 1, 3)))),
        _nchw(np.asarray(jax.random.normal(k_ns, hdr.shape))),
        _nchw(np.asarray(jax.random.normal(k_nc, hdr.shape))),
    )
    got = degradation.capture_chain(_nchw(hdr), torch.from_numpy(crf), torch.from_numpy(t), noise)
    for name in degradation.CaptureSim._fields:
        np.testing.assert_array_equal(_nhwc(getattr(got, name)), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.quantized_u8.dtype == torch.uint8


def test_simulate_capture_draws_from_its_generator():
    hdr = torch.from_numpy(np.random.RandomState(11).rand(2, 3, 8, 8).astype(np.float32))
    crf = torch.linspace(0, 1, 1024).repeat(2, 1)
    t = torch.ones(2)
    a = degradation.simulate_capture(torch.Generator().manual_seed(0), hdr, crf, t)
    b = degradation.simulate_capture(torch.Generator().manual_seed(0), hdr, crf, t)
    c = degradation.simulate_capture(torch.Generator().manual_seed(1), hdr, crf, t)
    assert torch.equal(a.hdr_t, b.hdr_t) and not torch.equal(a.hdr_t, c.hdr_t)
    noise = degradation.draw_capture_noise(torch.Generator().manual_seed(0), hdr)
    assert 0 <= float(noise.sigma_s.max()) <= degradation.SHOT_SIGMA
    assert 0 <= float(noise.sigma_c.max()) <= degradation.READ_SIGMA


# --- BatchNorm in train mode --------------------------------------------------

NETS = {
    "deq": (jm.DequantizationNet, tm.DequantizationNet, (2, 32, 32, 3)),
    "lin": (jm.LinearizationNet, tm.LinearizationNet, (2, 32, 32, 3)),
    "hal": (jm.HallucinationNet, tm.HallucinationNet, (2, 32, 32, 3)),
    "ref": (jm.RefinementNet, tm.RefinementNet, (2, 32, 32, 9)),
}


@pytest.mark.parametrize("name", list(NETS))
def test_train_mode_forward_and_batch_stats_match_flax(name):
    jcls, tcls, shape = NETS[name]
    variables = seeded_variables(jcls(), shape, seed=11 + len(name))
    x = np.random.RandomState(12).rand(*shape).astype(np.float32)
    want, mutated = jax.jit(
        lambda v, a: jcls().apply(v, a, train=True, mutable=["batch_stats"])
    )(variables, jnp.asarray(x))
    net = load_jax_variables(tcls(), variables).train()
    with torch.no_grad():
        got = net(_nchw(x)).numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    # hal normalises deep, narrow-variance decoder maps by their batch
    # statistics, which amplifies f32 sum order: each package's f32 train
    # forward is 5-6e-5 from the port's float64 one (max |out| 4.4), so hal is
    # held to 5e-5 of max |out|; the other nets to the golden 2e-5
    atol = 5e-5 * float(np.abs(want).max()) if name == "hal" else ATOL
    np.testing.assert_allclose(got, np.asarray(want), atol=atol)
    new_stats = from_jax_variables({"batch_stats": mutated.get("batch_stats", {})})
    buffers = dict(net.named_buffers())
    assert bool(new_stats) == (name in ("lin", "hal"))
    for key, value in new_stats.items():
        # the biased batch variance: the unbiased one is off by n/(n-1)
        np.testing.assert_allclose(buffers[key].numpy(), value.numpy(), atol=1e-6, err_msg=key)
