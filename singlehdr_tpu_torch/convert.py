"""Weight bridge between the JAX package's variables and the port's state_dict.

The JAX side is the ``{"params", "batch_stats"}`` tree, as numpy arrays, or
its flat-npz form (``singlehdr_tpu.train.weight_import.save_variables_npz``)
with keys like ``params/deq/unet/stem1/kernel``.  The port's modules carry the
Flax module names, so a key maps by its leaf:

  params/<path>/kernel  (4-D HWIO)  <->  <path>.weight  (OIHW)
  params/<path>/kernel  (2-D in,out) <->  <path>.weight  ([out, in])
  params/<path>/scale               <->  <path>.weight  (BatchNorm, 1-D)
  params/<path>/bias                <->  <path>.bias
  batch_stats/<path>/mean | var     <->  <path>.running_mean | running_var
  batch_stats/hal/preproc_mean      <->  hal.preproc_mean

Every key maps to exactly one tensor, in both directions.  A train state's
``ModuleDict`` of nets carries the multi-net paths (``params/deq/...``).
Optax's Adam state (count, mu, nu) maps onto torch Adam's (step, exp_avg,
exp_avg_sq) per parameter by the same rule (``adam_state_from_jax`` /
``adam_state_to_jax``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_INV = {v: k for k, v in _STATS.items()}


def _flatten(tree: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def flat_variables(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Nested ``{"params", "batch_stats"}`` tree (or an already-flat npz
    mapping) -> ``{"params/deq/...": array}``."""
    if any("/" in k for k in variables):
        return {k: np.asarray(v) for k, v in variables.items()}
    flat: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        flat.update(_flatten(variables.get(collection, {}), collection))
    return flat


def nest_variables(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Flat keys (``params/deq/unet/stem1/kernel``) -> the nested ``{"params":
    {"deq": {...}}, "batch_stats": {...}}`` tree that ``train.weight_import``
    works on, both collections present."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX variables -> the port's ``state_dict`` (f32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat_variables(variables).items():
        collection, _, rest = key.partition("/")
        path, _, leaf = rest.rpartition("/")
        mod = path.replace("/", ".") + "." if path else ""
        if collection == "batch_stats":
            name = mod + _STATS.get(leaf, leaf)
        elif leaf == "kernel" and arr.ndim == 4:
            arr, name = arr.transpose(3, 2, 0, 1), mod + "weight"
        elif leaf == "kernel" and arr.ndim == 2:
            arr, name = arr.T, mod + "weight"
        elif leaf in ("scale", "bias"):
            name = mod + ("weight" if leaf == "scale" else "bias")
        else:
            raise KeyError(f"no state_dict counterpart for {key!r}")
        if name in out:
            raise KeyError(f"two JAX keys map to {name!r}")
        out[name] = torch.tensor(arr, dtype=torch.float32)
    return out


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` -> flat JAX keys (``params/...``, ``batch_stats/...``)."""
    out: Dict[str, np.ndarray] = {}
    for name, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        mod, _, leaf = name.rpartition(".")
        path = mod.replace(".", "/") + "/" if mod else ""
        if leaf in _STATS_INV or leaf == "preproc_mean":
            key = f"batch_stats/{path}{_STATS_INV.get(leaf, leaf)}"
        elif leaf == "weight" and arr.ndim == 4:
            arr, key = arr.transpose(2, 3, 1, 0), f"params/{path}kernel"
        elif leaf == "weight" and arr.ndim == 2:
            arr, key = arr.T, f"params/{path}kernel"
        elif leaf == "weight" and arr.ndim == 1:
            key = f"params/{path}scale"
        elif leaf == "bias":
            key = f"params/{path}bias"
        else:
            raise KeyError(f"no JAX counterpart for {name!r}")
        out[key] = np.ascontiguousarray(arr)
    return out


def load_jax_variables(module: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Load JAX variables into ``module`` strictly (every key, both ways).
    A multi-net tree (``params/deq/...``) loads into the train state's
    ``ModuleDict``; a one-net tree into that net."""
    module.load_state_dict(from_jax_variables(variables), strict=True)
    return module


def _param_tensors(module: torch.nn.Module, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A params-shaped JAX tree (nested, or flat with ``params/`` keys) ->
    {parameter name: tensor}, covering exactly ``module``'s parameters."""
    flat = from_jax_variables(tree if any("/" in k for k in tree) else {"params": tree})
    names = {n for n, _ in module.named_parameters()}
    if set(flat) != names:
        raise KeyError(f"Adam moments do not match the parameters: {sorted(set(flat) ^ names)[:4]}")
    return flat


def adam_state_from_jax(module: torch.nn.Module, optimizer: torch.optim.Adam, count: int,
                        mu: Mapping[str, Any], nu: Mapping[str, Any]) -> None:
    """Optax Adam state (``ScaleByAdamState`` count, mu, nu) -> torch Adam
    state (``step``, ``exp_avg``, ``exp_avg_sq``) of ``module``'s parameters,
    one to one.  ``optimizer`` must hold those parameters."""
    exp_avg, exp_avg_sq = _param_tensors(module, mu), _param_tensors(module, nu)
    for name, p in module.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": exp_avg[name].to(p.device),
            "exp_avg_sq": exp_avg_sq[name].to(p.device),
        }


def adam_state_to_jax(module: torch.nn.Module, optimizer: torch.optim.Adam):
    """torch Adam state of ``module``'s parameters -> (count, mu, nu), mu and
    nu flat with ``params/...`` keys (zeros where Adam has not stepped)."""
    names = dict(module.named_parameters())
    state = [optimizer.state.get(p, {}) for p in names.values()]
    counts = {int(s["step"]) for s in state if "step" in s}
    if len(counts) > 1:
        raise ValueError(f"parameters at different Adam steps: {sorted(counts)}")
    moments = []
    for key in ("exp_avg", "exp_avg_sq"):
        moments.append(to_jax_variables({
            n: s[key] if key in s else torch.zeros_like(p)
            for (n, p), s in zip(names.items(), state)
        }))
    return (counts.pop() if counts else 0), moments[0], moments[1]
