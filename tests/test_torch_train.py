"""CPU parity of the port's train steps against the JAX package's.

Each step factory takes one step from weights bridged from seeded JAX
variables, on the same seeded batch.  JAX's exact gradients come out of its
own jitted step by giving its ``NetState`` a recording transformation as
``tx`` (zero updates; the gradients become the new optimizer state), and
optax's Adam applied to them gives JAX's next parameters.  Bounds:

  * the loss at rtol 1e-5;
  * every gradient at max|d| <= 1e-3 max|g_jax| of the tensor + 1e-4 max|g_jax|
    of its net (f32 sum order of two conv libraries, amplified by
    batch-statistic normalisation; see the test);
  * the new BatchNorm statistics at 1e-5 absolute;
  * the parameters after one Adam step within 2 lr: the first step moves each
    by ~lr sign(g), and a gradient within sum-order noise of 0 may flip sign.

The joint and finetune steps also run with ``remat=True`` and ``'convs'``,
each against the JAX step with the same ``remat``, under the same bounds;
and a remat step leaves every gradient, the loss and the BatchNorm running
statistics bit-equal to the plain port step's (the recompute must not
update the statistics a second time), in f32 and bf16.

Shapes: 2x32x32 for every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from singlehdr_tpu import models as jm
from singlehdr_tpu.ops import curves as jcurves
from singlehdr_tpu.train import steps as jsteps
from singlehdr_tpu.train.state import NetState
from singlehdr_tpu.train.state import make_optimizer as jax_make_optimizer
from singlehdr_tpu_torch import models as tm
from singlehdr_tpu_torch.convert import (
    adam_state_from_jax,
    adam_state_to_jax,
    flat_variables,
    from_jax_variables,
    load_jax_variables,
)
from singlehdr_tpu_torch.models.layers import Dense
from singlehdr_tpu_torch.models.vgg16 import Vgg16Features
from singlehdr_tpu_torch.train import steps
from singlehdr_tpu_torch.train.state import ADAM_EPS, TrainState, make_optimizer

from test_torch_models import seeded_variables

LR = 1e-4
HW = 32
NETS = {
    "deq": (jm.DequantizationNet, tm.DequantizationNet, 3),
    "lin": (jm.LinearizationNet, tm.LinearizationNet, 3),
    "hal": (jm.HallucinationNet, tm.HallucinationNet, 3),
    "ref": (jm.RefinementNet, tm.RefinementNet, 9),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def vggs():
    return Vgg16Features(), jm.Vgg16Features()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _batch(seed, b=2, hw=HW):
    rs = np.random.RandomState(seed)
    ldr = rs.rand(b, hw, hw, 3).astype(np.float32)
    clipped = rs.rand(b, hw, hw, 3).astype(np.float32)
    return {
        "ldr": ldr,
        "jpeg": np.clip(ldr + rs.randn(b, hw, hw, 3).astype(np.float32) * 0.02, 0, 1),
        "clipped_hdr_t": clipped,
        "hdr_t": clipped * rs.uniform(1.0, 2.0, (b, 1, 1, 1)).astype(np.float32),
        "mask": np.asarray([1.0, 1.0][:b], np.float32).reshape(b, 1, 1, 1),
        "invcrf": np.asarray(jcurves.monotonic_rf(jnp.asarray(rs.rand(b, 1024).astype(np.float32)))),
        "hdr": (rs.rand(b, hw, hw, 3) * 2).astype(np.float32),
    }


def _port_args(batch, keys):
    return [_nchw(batch[k]) if batch[k].ndim == 4 and k != "mask" else torch.from_numpy(batch[k])
            for k in keys]


def _recording_tx():
    """Zero updates; the gradients become the optimizer state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


def _jax_state(variables, tx):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return NetState(step=jnp.zeros((), jnp.int32), params=params,
                    batch_stats=jax.tree.map(jnp.asarray, variables.get("batch_stats", {})),
                    opt_state=tx.init(params), tx=tx)


def _variables(names, seed):
    per = {n: seeded_variables(NETS[n][0](), (2, HW, HW, NETS[n][2]), seed=seed + i)
           for i, n in enumerate(names)}
    if len(names) == 1:
        return per[names[0]]
    return {"params": {n: v["params"] for n, v in per.items()},
            "batch_stats": {n: v.get("batch_stats", {}) for n, v in per.items()}}


def _port_state(names, variables, dtype=torch.float32):
    nets = nn.ModuleDict({n: NETS[n][1](dtype) for n in names})
    load_jax_variables(nets[names[0]] if len(names) == 1 else nets, variables)
    return TrainState(nets, make_optimizer(nets.parameters(), LR))


# step name -> (nets, JAX factory(vgg), port factory(vgg), batch keys)
STEPS = {
    "deq": (("deq",), lambda v: jsteps.make_deq_train_step(), lambda v: steps.make_deq_train_step(),
            ("ldr", "jpeg", "mask")),
    "lin": (("lin",), lambda v: jsteps.make_lin_train_step(), lambda v: steps.make_lin_train_step(),
            ("ldr", "clipped_hdr_t", "mask", "invcrf")),
    "hal": (("hal",), jsteps.make_hal_train_step, steps.make_hal_train_step,
            ("hdr_t", "clipped_hdr_t", "mask")),
    "joint": (("deq", "lin", "hal"), jsteps.make_joint_train_step, steps.make_joint_train_step,
              ("ldr", "jpeg", "clipped_hdr_t", "hdr_t", "mask", "invcrf")),
    "finetune": (("deq", "lin", "hal", "ref"), lambda v, **kw: jsteps.make_finetune_train_step(**kw),
                 lambda v, **kw: steps.make_finetune_train_step(**kw), ("ldr", "hdr")),
}
# case -> (step name, remat): the factories that take remat, as in JAX
REMAT_CASES = {f"{name}-{label}": (name, remat) for name in ("joint", "finetune")
               for label, remat in (("remat", True), ("convs", "convs"))}
CASES = {**{name: (name, False) for name in STEPS}, **REMAT_CASES}


def _finetune_batch(seed):
    batch = _batch(seed)
    # keep C_pred off 1.0: a saturated pixel maps to the curve's last
    # sample, which the two packages' cumsums put 1 ulp either side of
    # 1.0, and at exactly 1.0 the highlight mask's clip has a kink
    # (gradient 1/t below, 0.5/t at, 0 above)
    batch["ldr"] = batch["ldr"] * 0.5
    return batch


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(case, vggs):
    name, remat = CASES[case]
    names, jfactory, pfactory, keys = STEPS[name]
    kw = {"remat": remat} if remat else {}
    variables = _variables(names, seed=20)
    batch = _finetune_batch(21) if name == "finetune" else _batch(21)
    jstate, jloss, jaux = jfactory(vggs[1], **kw)(_jax_state(variables, _recording_tx()),
                                                  *[jnp.asarray(batch[k]) for k in keys])
    grads = jstate.opt_state
    adam = jax_make_optimizer(LR)
    updates, _ = adam.update(grads, adam.init(jstate.params), jstate.params)
    jax_next = optax.apply_updates(jstate.params, updates)

    state = _port_state(names, variables)
    loss, aux = pfactory(vggs[0], **kw)(state, *_port_args(batch, keys))
    assert state.step == 1 and set(aux) == set(jaux)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    prefix = f"{names[0]}." if len(names) == 1 else ""
    params = dict(state.nets.named_parameters())
    want_grads = from_jax_variables({"params": grads})
    want_next = from_jax_variables({"params": jax_next})
    assert {prefix + k for k in want_grads} == set(params)
    # bound: 1e-3 of the tensor's own max|g| plus 1e-4 of its net's largest
    # gradient.  JAX's own f32 gradients sit up to 2.3e-4 of a tensor's max
    # from the float64 gradient of the same step (lin at 32^2, measured), and
    # a bias in front of a batch-statistic normalisation has a true gradient
    # of 0, so its f32 gradient is pure sum-order noise on the net's scale
    net_scale = {}
    for key, g in want_grads.items():
        net = (prefix + key).split(".")[0]
        net_scale[net] = max(net_scale.get(net, 0.0), float(g.abs().max()))
    for key, g in want_grads.items():
        p = params[prefix + key]
        got = torch.zeros_like(p) if p.grad is None else p.grad
        bound = 1e-3 * float(g.abs().max()) + 1e-4 * net_scale[(prefix + key).split(".")[0]]
        err = float((got - g).abs().max())
        assert err <= bound, f"{key}: grad err {err:.3e} > {bound:.3e}"
        # the pre-step parameter is the bridged one; the step moved it ~lr
        np.testing.assert_allclose(p.detach().numpy(), want_next[key].numpy(), rtol=0,
                                   atol=2 * LR * (1 + 1e-3), err_msg=key)

    new_stats = from_jax_variables({"batch_stats": jstate.batch_stats})
    buffers = dict(state.nets.named_buffers())
    assert bool(new_stats) == any(n in ("lin", "hal") for n in names)
    for key, value in new_stats.items():
        np.testing.assert_allclose(buffers[prefix + key].numpy(), value.numpy(), atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_remat_step_equals_the_plain_step(case, dtype, vggs):
    """Loss, every gradient and every buffer (the BatchNorm running
    statistics) bit-equal to the plain step's on the CPU: a second momentum
    update in the recompute would move the statistics by about 1 %."""
    name, remat = REMAT_CASES[case]
    names, _, pfactory, keys = STEPS[name]
    variables = _variables(names, seed=50)
    args = _port_args(_finetune_batch(51) if name == "finetune" else _batch(51), keys)
    results = []
    for kw in ({}, {"remat": remat}):
        state = _port_state(names, variables, dtype)
        loss, _ = pfactory(vggs[0], dtype=dtype, **kw)(state, *args)
        results.append((loss, {n: p.grad for n, p in state.nets.named_parameters()},
                        dict(state.nets.named_buffers())))
    (loss, grads, buffers), (rloss, rgrads, rbuffers) = results
    assert torch.equal(rloss, loss)
    for key, g in grads.items():
        assert torch.equal(rgrads[key], g), key
    assert buffers and set(rbuffers) == set(buffers)
    for key, b in buffers.items():
        assert torch.equal(rbuffers[key], b), key


def test_remat_takes_false_true_or_convs():
    with pytest.raises(ValueError, match="remat"):
        steps.make_finetune_train_step(remat="all")


def test_adam_matches_optax_given_the_same_gradients():
    """Keras eps, optax's update rule: three steps on identical gradients,
    with the state carried across to torch after the first."""
    rs = np.random.RandomState(30)
    params = {"params": {"head": {"kernel": rs.randn(4, 3).astype(np.float32),
                                  "bias": rs.randn(3).astype(np.float32)}}}
    grads = [{"head": {"kernel": rs.randn(4, 3).astype(np.float32),
                       "bias": rs.randn(3).astype(np.float32)}} for _ in range(3)]
    tx = jax_make_optimizer(LR)
    jp = jax.tree.map(jnp.asarray, params["params"])
    opt = tx.init(jp)
    history = []
    for g in grads:
        updates, opt = tx.update(g, opt, jp)
        jp = optax.apply_updates(jp, updates)
        history.append((jp, opt))

    module = nn.Module()
    module.head = Dense(4, 3)
    # torch after step 1 on its own, then from optax's state after step 1
    load_jax_variables(module, params)
    adam = make_optimizer(module.parameters(), LR)
    assert adam.defaults["eps"] == ADAM_EPS == 1e-7
    _set_grads(module, grads[0])
    adam.step()
    _assert_params(module, history[0][0], atol=1e-9)
    load_jax_variables(module, {"params": history[0][0]})
    scale_state = history[0][1][0]
    adam_state_from_jax(module, adam, int(scale_state.count), scale_state.mu, scale_state.nu)
    count, mu, nu = adam_state_to_jax(module, adam)
    assert count == 1
    for got, want in ((mu, scale_state.mu), (nu, scale_state.nu)):
        flat = flat_variables({"params": want})
        assert set(got) == set(flat)
        for k in flat:
            np.testing.assert_array_equal(got[k], flat[k])
    for g, (want_params, _) in zip(grads[1:], history[1:]):
        _set_grads(module, g)
        adam.step()
        _assert_params(module, want_params, atol=1e-9)


def _set_grads(module, grads):
    for name, g in from_jax_variables({"params": grads}).items():
        module.get_parameter(name).grad = g


def _assert_params(module, jax_params, atol):
    for name, want in from_jax_variables({"params": jax_params}).items():
        np.testing.assert_allclose(module.get_parameter(name).detach().numpy(), want.numpy(),
                                   rtol=1e-6, atol=atol, err_msg=name)


def test_adam_state_bridge_carries_a_jax_run_into_the_port():
    """One JAX deq step with its real Adam, the state carried across, then
    one more step on each side."""
    variables = _variables(("deq",), seed=40)
    step1, step2 = _batch(41), _batch(42)
    keys = ("ldr", "jpeg", "mask")
    jstep = jsteps.make_deq_train_step()
    jstate, _, _ = jstep(_jax_state(variables, jax_make_optimizer(LR)),
                         *[jnp.asarray(step1[k]) for k in keys])
    carried = {"params": jax.device_get(jstate.params),
               "batch_stats": jax.device_get(jstate.batch_stats)}
    adam_state = jstate.opt_state[0]

    state = _port_state(("deq",), carried)
    adam_state_from_jax(state.nets["deq"], state.optimizer, int(adam_state.count),
                        adam_state.mu, adam_state.nu)
    state.step = int(jstate.step)
    jstate, jloss, _ = jstep(jstate, *[jnp.asarray(step2[k]) for k in keys])
    loss, _ = steps.make_deq_train_step()(state, *_port_args(step2, keys))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    count, mu, nu = adam_state_to_jax(state.nets["deq"], state.optimizer)
    assert count == int(jstate.opt_state[0].count) == state.step == 2
    for got, want in ((mu, jstate.opt_state[0].mu), (nu, jstate.opt_state[0].nu)):
        flat = flat_variables({"params": jax.device_get(want)})
        assert set(got) == set(flat)
        for k, v in flat.items():
            # the carried moment is exact; the new gradient's share differs by sum order
            assert np.abs(got[k] - v).max() <= 1e-4 * np.abs(v).max(), k
    # the second step moves each parameter by at most ~1.0014 lr (Adam's
    # t = 2 bound), in either direction where the gradient is noise
    for key, want in from_jax_variables({"params": jstate.params}).items():
        got = state.nets["deq"].get_parameter(key).detach()
        assert float((got - want).abs().max()) <= 2.01 * LR, key
