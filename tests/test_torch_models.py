"""CPU parity of the PyTorch port's nets and pipeline against the JAX package.

One set of weights goes into both packages: the JAX variable tree (its
structure from ``jax.eval_shape`` of the Flax init, its values seeded numpy,
BatchNorm statistics included) is bridged into the port by
``convert.from_jax_variables``.  The nets run in eval mode, so the port's
kernel wrappers (K1-K4) take their plain versions on these CPU tensors.
Shapes are the goldens' (tests/test_golden.py): 2x32x32 per net, 1x64x64 for
the pipeline.  Tolerance: 2e-5 absolute (tests/test_golden.py:37).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlehdr_tpu import models as jm
from singlehdr_tpu.ops.color import VGG_MEAN_BGR
from singlehdr_tpu_torch import models as tm
from singlehdr_tpu_torch.convert import (
    flat_variables,
    from_jax_variables,
    load_jax_variables,
    to_jax_variables,
)
from singlehdr_tpu_torch.ops import cuda as kernels

ATOL = 2e-5

CASES = {
    "deq": (jm.DequantizationNet, tm.DequantizationNet, (2, 32, 32, 3)),
    "lin": (jm.LinearizationNet, tm.LinearizationNet, (2, 32, 32, 3)),
    "hal": (jm.HallucinationNet, tm.HallucinationNet, (2, 32, 32, 3)),
    "ref": (jm.RefinementNet, tm.RefinementNet, (2, 32, 32, 9)),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def seeded_variables(module, sample_shape, seed=0, *more_shapes):
    """The JAX variable tree of ``module`` (called on inputs of
    ``sample_shape`` and ``more_shapes``) filled with seeded numpy values:
    glorot-range kernels, small biases, non-trivial BN statistics."""
    shapes = jax.eval_shape(
        module.init, jax.random.PRNGKey(0),
        *[jnp.zeros(s, jnp.float32) for s in (sample_shape, *more_shapes)]
    )
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan = np.prod(shape[:-1]) + np.prod(shape[:-2]) * shape[-1]
            lim = np.sqrt(6.0 / fan)
            return rs.uniform(-lim, lim, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "preproc_mean":
            return (np.asarray(VGG_MEAN_BGR) + rs.uniform(-1, 1, shape)).astype(np.float32)
        return rs.uniform(-0.1, 0.1, shape).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _input(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


@pytest.mark.parametrize("name", list(CASES))
def test_net_matches_jax(name):
    jcls, tcls, shape = CASES[name]
    variables = seeded_variables(jcls(), shape, seed=len(name))
    x = _input(shape)
    want = np.asarray(jax.jit(jcls().apply)(variables, jnp.asarray(x)))
    net = load_jax_variables(tcls(), variables).eval()
    with torch.inference_mode():
        got = net(_nchw(x)).numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_bridge_round_trips_every_key(name):
    jcls, tcls, shape = CASES[name]
    flat = flat_variables(seeded_variables(jcls(), shape))
    sd = from_jax_variables(flat)
    # every JAX key lands on exactly one tensor of the port's module ...
    assert set(sd) == set(tcls().state_dict())
    assert len(sd) == len(flat)
    # ... and comes back unchanged
    back = to_jax_variables(sd)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_pipeline_matches_jax():
    shape = (1, 64, 64, 3)
    variables = seeded_variables(jm.ReverseCameraPipeline(), shape, seed=3)
    x = _input(shape, seed=1)
    jpipe = jm.ReverseCameraPipeline()
    want_hdr, want_invcrf = jax.jit(
        lambda v, a: (lambda o: (o.hdr, o.invcrf))(jpipe.apply(v, a))
    )(variables, jnp.asarray(x))
    pipe = load_jax_variables(tm.ReverseCameraPipeline(), variables).eval()
    kernels.reset_launches()
    with torch.inference_mode():
        out = pipe(_nchw(x))
    np.testing.assert_allclose(
        out.invcrf.numpy(), np.asarray(want_invcrf), atol=ATOL
    )
    np.testing.assert_allclose(
        out.hdr.permute(0, 2, 3, 1).numpy(), np.asarray(want_hdr), atol=ATOL
    )
    # CPU tensors never launch a kernel
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}


def test_pipeline_without_refinement_matches_jax():
    """``use_refinement=False`` (JAX's ``ReverseCameraPipeline`` attribute):
    ``hdr`` is A_pred and ``ref`` does not run, on the module and as the
    forward's argument, and through ``HdrPredictor`` and ``TiledPredictor``
    (one tile the whole image)."""
    from singlehdr_tpu_torch.inference import HdrPredictor
    from singlehdr_tpu_torch.tiled import TiledPredictor

    shape = (1, 64, 64, 3)
    variables = seeded_variables(jm.ReverseCameraPipeline(), shape, seed=4)
    x = _input(shape, seed=2)
    jpipe = jm.ReverseCameraPipeline(use_refinement=False)
    want = np.asarray(jax.jit(lambda v, a: jpipe.apply(v, a).hdr)(variables, jnp.asarray(x)))
    pipe = load_jax_variables(tm.ReverseCameraPipeline(use_refinement=False), variables).eval()
    ran = []
    pipe.ref.register_forward_hook(lambda *a: ran.append(1))
    with torch.inference_mode():
        out = pipe(_nchw(x))
        again = load_jax_variables(tm.ReverseCameraPipeline(), variables).eval()(_nchw(x), use_refinement=False)
    assert not ran and out.hdr is out.a_pred
    np.testing.assert_allclose(out.hdr.permute(0, 2, 3, 1).numpy(), want, atol=ATOL)
    assert torch.equal(again.hdr, out.hdr)
    whole = load_jax_variables(tm.ReverseCameraPipeline(), variables).eval()
    with torch.inference_mode():
        a_pred = whole(_nchw(x)).a_pred[0].permute(1, 2, 0).numpy()
    np.testing.assert_array_equal(HdrPredictor(whole, use_refinement=False)._forward(x)[0], a_pred)
    # one 64^2 tile, its curve from the 64^2 view: the image itself
    tiled = TiledPredictor(whole, tile=64, halo=16, invcrf_view=64, use_refinement=False)(x[0])
    np.testing.assert_allclose(tiled, a_pred, atol=1e-6)


def test_constructors_turn_tf32_off():
    """``build_pipeline`` and ``init_multi_state``/``init_net_state`` set the
    package's precision policy (full f32 convolutions and matmuls), whatever
    the caller's flags were."""
    from singlehdr_tpu_torch.train.state import init_multi_state, init_net_state

    for build in (lambda: tm.build_pipeline(seed=0, device="cpu"),
                  lambda: init_multi_state(("deq",), 1e-4, device="cpu"),
                  lambda: init_net_state("deq", 1e-4, device="cpu")):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        build()
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False


def test_build_pipeline_defaults_to_the_card(monkeypatch):
    import inspect

    assert inspect.signature(tm.build_pipeline).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((AssertionError, RuntimeError)):
        tm.build_pipeline(seed=0)


def test_seeded_init_is_deterministic_and_keras_like():
    a = tm.build_pipeline(seed=0, device="cpu")
    b = tm.build_pipeline(seed=0, device="cpu")
    c = tm.build_pipeline(seed=1, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["deq.unet.stem1.weight"], sc["deq.unet.stem1.weight"])
    assert torch.all(sa["lin.crf_feature_net.stem_bn.running_var"] == 1)
    assert torch.all(sa["hal.enc1.conv1.bias"] == 0)
    assert not a.training
    n_params = {n: sum(p.numel() for p in getattr(a, n).parameters()) for n in
                ("deq", "lin", "hal", "ref")}
    # the published widths: ~2.0M / ~1.2M / ~24.6M / ~1.3M parameters
    assert n_params == {"deq": 1999779, "lin": 1172747, "hal": 24569118, "ref": 1266947}
