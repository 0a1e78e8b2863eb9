"""Import reference (TF2-Keras) checkpoint weights into this framework's trees
(the port's copy of ``singlehdr_tpu.train.weight_import``: the same code on
the same Flax-layout numpy trees, which ``convert.py`` bridges to the port's
``state_dict``).

The reference saves each net with ``tf.train.Checkpoint(epoch, lin=model,
optimizer=...)`` — the model slot is literally named ``lin`` for every net
(tf_utils.py:157-160) — so variable keys look like

    lin/conv1/kernel/.ATTRIBUTES/VARIABLE_VALUE
    lin/crf_feature_net/res1/norm1/moving_mean/.ATTRIBUTES/VARIABLE_VALUE

This module maps those Keras attribute paths onto this framework's Flax param
trees per net.  Loading backends (``load_reference_checkpoint``):

  * a TensorBundle prefix (``<prefix>.index`` + data shard), read by
    ``train.tensorbundle`` without TensorFlow, or
  * a dict of {key: np.ndarray} saved as .npz (for example by the JAX
    package's ``tools/dump_tf_checkpoint.py`` on a machine with TF).

Layout notes: Keras Conv2D kernels are HWIO and Dense kernels are [in, out] —
identical to Flax, so arrays transfer without transposition.  Keras
BatchNormalization gamma/beta map to Flax scale/bias (params) and
moving_mean/moving_variance to batch_stats mean/var.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"

# Conv/Dense parameter names are shared by TF-Keras and Flax.
_CONV = {"kernel": ("params", "kernel"), "bias": ("params", "bias")}
_BN = {
    "gamma": ("params", "scale"),
    "beta": ("params", "bias"),
    "moving_mean": ("batch_stats", "mean"),
    "moving_variance": ("batch_stats", "var"),
}

# ---------------------------------------------------------------------------
# per-net attribute-path -> flax-module-path maps
# ---------------------------------------------------------------------------

# Dequantization / Refinement U-Net (dequantization_net.py:31-47,
# refinement_net.py:31-47): attribute names conv1/conv2/d2..d4/enc/u4..u1/out.
_UNET_MAP = {
    "conv1": "unet/stem1",
    "conv2": "unet/stem2",
    "d2": "unet/down2",
    "d3": "unet/down3",
    "d4": "unet/down4",
    "enc": "unet/bottleneck",
    "u4": "unet/up4",
    "u3": "unet/up3",
    "u2": "unet/up2",
    "u1": "unet/up1",
    "out": "unet/head",
}

# Bottleneck residual blocks (linearization_net.py:6-83): projection blocks
# (type1) name their shortcut conv1/norm1 and main path conv2..4/norm2..4;
# identity blocks (type2) use conv1..3/norm1..3.
_RES_T1 = {
    "conv1": "proj_conv",
    "norm1": "proj_bn",
    "conv2": "conv1",
    "norm2": "bn1",
    "conv3": "conv2",
    "norm3": "bn2",
    "conv4": "conv3",
    "norm4": "bn3",
}
_RES_T2 = {
    "conv1": "conv1",
    "norm1": "bn1",
    "conv2": "conv2",
    "norm2": "bn2",
    "conv3": "conv3",
    "norm3": "bn3",
}

_LIN_MAP: Dict[str, str] = {
    "crf_feature_net/conv1": "crf_feature_net/stem",
    "crf_feature_net/norm1": "crf_feature_net/stem_bn",
    "ae_invcrf_decode_net/fc": "pca_head",
}
for _blk, _tmap in (
    ("res1", _RES_T1),
    ("res2", _RES_T2),
    ("res3", _RES_T2),
    ("res4", _RES_T1),
    ("res5", _RES_T2),
):
    for _src, _dst in _tmap.items():
        _LIN_MAP[f"crf_feature_net/{_blk}/{_src}"] = (
            f"crf_feature_net/{_blk}/{_dst}"
        )

# Hallucination-Net (hallucination_net.py:109-145): encoder d1..d5, latent
# conv1/norm1, decoder u5..u1 (conv1/norm1) with skip fusions s5..s1, head
# conv2/norm2, final skip s0.
_HAL_MAP: Dict[str, str] = {"conv1": "latent_conv", "norm1": "latent_bn",
                            "conv2": "head_conv", "norm2": "head_bn",
                            "s0/conv1": "skip0/conv"}
for _i in range(1, 6):
    for _c in ("conv1", "conv2", "conv3"):
        _HAL_MAP[f"d{_i}/{_c}"] = f"enc{_i}/{_c}"
    _HAL_MAP[f"u{_i}/conv1"] = f"dec{_i}/conv"
    _HAL_MAP[f"u{_i}/norm1"] = f"dec{_i}/bn"
    _HAL_MAP[f"u{_i}/conv2"] = f"dec{_i}/conv2_unused"  # dead layer in the ref
    _HAL_MAP[f"s{_i}/conv1"] = f"skip{_i}/conv"

NET_MAPS: Dict[str, Mapping[str, str]] = {
    "deq": _UNET_MAP,
    "ref": _UNET_MAP,
    "lin": _LIN_MAP,
    "hal": _HAL_MAP,
}


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def reference_keys_to_tree(
    net: str, raw: Mapping[str, np.ndarray]
) -> Dict[str, Any]:
    """Map a reference checkpoint's {key: array} dict onto flax variable trees.

    Returns {"params": ..., "batch_stats": ...} for the given net
    ('deq'/'lin'/'hal'/'ref').  Unknown keys (optimizer slots, epoch counters,
    the hal decoder's dead conv2 layer) are skipped.
    """
    net_map = NET_MAPS[net]
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, value in raw.items():
        if not key.endswith(_SUFFIX):
            continue
        path = key[: -len(_SUFFIX)]
        parts = path.split("/")
        if parts[0] != "lin":  # the universal model-slot name (tf_utils.py:159)
            continue
        parts = parts[1:]
        if len(parts) < 2:
            continue
        var_name = parts[-1]
        attr_path = "/".join(parts[:-1])
        # try longest-prefix match in the net map
        if attr_path in net_map:
            module_path = net_map[attr_path]
        else:
            # two-level attributes like d2/conv1 for the U-Nets
            head, _, tail = attr_path.partition("/")
            if head in net_map and tail:
                module_path = f"{net_map[head]}/{tail}"
            else:
                continue
        if "unused" in module_path:
            continue
        var_map = _BN if var_name in _BN else _CONV
        if var_name not in var_map:
            continue
        collection, flax_name = var_map[var_name]
        _set_path(
            out[collection],
            tuple(module_path.split("/")) + (flax_name,),
            np.asarray(value),
        )
    return out


# ---------------------------------------------------------------------------
# consolidated deployment weights: one flat .npz for the whole pipeline
# ---------------------------------------------------------------------------


def _flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}" if not prefix else f"{prefix}/{k}"
        if isinstance(v, Mapping):
            out.update(_flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_variables_npz(variables: Mapping[str, Any], path: str) -> int:
    """Write {params, batch_stats} as one flat compressed npz.

    Keys are collection-prefixed slash paths (``params/deq/unet/stem1/kernel``),
    portable across machines without orbax/sharding metadata — the deployment
    artifact for inference and serving.
    """
    flat = {}
    for collection in ("params", "batch_stats"):
        flat.update(
            _flatten_tree(variables.get(collection, {}), collection)
        )
    np.savez_compressed(path, **flat)
    return len(flat)


def load_variables_npz(path: str) -> Dict[str, Any]:
    """Inverse of save_variables_npz -> {"params": ..., "batch_stats": ...}."""
    z = np.load(path)
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key in z.files:
        collection, _, rest = key.partition("/")
        _set_path(out[collection], tuple(rest.split("/")), z[key])
    return out


def load_reference_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read {key: array} from a TF checkpoint prefix or an .npz dump.

    Raw ``tf.train.Checkpoint`` prefixes (``<prefix>.index`` +
    ``<prefix>.data-*``) are read directly by the dependency-free
    TensorBundle parser (train.tensorbundle) — no TensorFlow needed.
    """
    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=False)
        return {k: z[k] for k in z.files}
    from singlehdr_tpu_torch.train import tensorbundle

    if tensorbundle.is_bundle(path):
        prefix = path[: -len(".index")] if path.endswith(".index") else path
        return tensorbundle.read_bundle(prefix)
    raise FileNotFoundError(
        f"no checkpoint at {path!r}: expected an .npz dump or a "
        "TensorBundle prefix (<prefix>.index + <prefix>.data-*)"
    )


def export_reference_checkpoint(
    net: str, variables: Mapping[str, Any], prefix: str
) -> int:
    """Write one net's Flax variables as a reference-format TF2 checkpoint.

    Emits a TensorBundle at ``prefix`` with the reference's key layout
    (universal model slot ``lin``, tf_utils.py:157-160), the
    ``_CHECKPOINTABLE_OBJECT_GRAPH`` proto TF2's object-based restore walks
    (train.object_graph), an int32 ``epoch`` matching the reference's
    ``tf.Variable(0)``, and a ``checkpoint`` manager-state file so
    ``tf.train.latest_checkpoint`` finds it.  Verified end-to-end against
    real TF in tests/test_tf_parity.py: ``tf.train.Checkpoint(epoch, lin=
    <reference model>, optimizer).restore(prefix)`` binds every model
    variable (optimizer slots are absent and tolerated).  Returns the number
    of tensors written.
    """
    from singlehdr_tpu_torch.train import tensorbundle
    from singlehdr_tpu_torch.train.object_graph import build_object_graph

    inverse: Dict[str, str] = {}
    for attr, module_path in NET_MAPS[net].items():
        inverse[module_path] = attr

    flat_params = _flatten_tree(variables.get("params", {}))
    flat_stats = _flatten_tree(variables.get("batch_stats", {}))
    _INV_CONV = {"kernel": "kernel", "bias": "bias"}
    _INV_BN_P = {"scale": "gamma", "bias": "beta"}
    _INV_BN_S = {"mean": "moving_mean", "var": "moving_variance"}

    tensors: Dict[str, Any] = {
        "epoch/.ATTRIBUTES/VARIABLE_VALUE": np.asarray(0, np.int32),
        "save_counter/.ATTRIBUTES/VARIABLE_VALUE": np.asarray(1, np.int64),
    }

    def attr_for(module_path: str) -> str | None:
        attr = inverse.get(module_path)
        if attr is None:
            # two-level attributes like d2/conv1 mapped via their head
            head, _, tail = module_path.rpartition("/")
            if inverse.get(head) and tail:
                attr = f"{inverse[head]}/{tail}"
        return attr

    # BN params share the name 'bias' with convs; a module is a BN iff it
    # also carries batch_stats at the same path.
    bn_paths = {k.rpartition("/")[0] for k in flat_stats}
    for key, value in flat_params.items():
        module_path, _, var_name = key.rpartition("/")
        tf_var = (
            _INV_BN_P.get(var_name)
            if module_path in bn_paths
            else _INV_CONV.get(var_name)
        )
        attr = attr_for(module_path)
        if tf_var is None or attr is None:
            continue
        tensors[f"lin/{attr}/{tf_var}{_SUFFIX}"] = np.asarray(value, np.float32)
    for key, value in flat_stats.items():
        module_path, _, var_name = key.rpartition("/")
        tf_var = _INV_BN_S.get(var_name)
        attr = attr_for(module_path)
        if tf_var is None or attr is None:
            continue
        tensors[f"lin/{attr}/{tf_var}{_SUFFIX}"] = np.asarray(value, np.float32)

    tensors["_CHECKPOINTABLE_OBJECT_GRAPH"] = build_object_graph(tensors)
    tensorbundle.write_bundle(prefix, tensors)
    # CheckpointManager state file (CheckpointState text proto) so
    # tf.train.latest_checkpoint / CheckpointManager discover the export.
    import os

    base = os.path.basename(prefix)
    state = (
        f'model_checkpoint_path: "{base}"\n'
        f'all_model_checkpoint_paths: "{base}"\n'
    )
    with open(os.path.join(os.path.dirname(prefix) or ".", "checkpoint"), "w") as f:
        f.write(state)
    return len(tensors)


# ---------------------------------------------------------------------------
# channel-order adapter for BGR-trained reference weights
# ---------------------------------------------------------------------------

# The reference trains its synth path on cv2-BGR images (the two channel
# flips in dataset.py:182-184 cancel), while this framework is RGB end-to-end.
# Weights trained on BGR are exactly the RGB weights with channel-coupled
# parameters permuted, because every architecture here is channel-equivariant
# except for hallucination's fixed VGG-mean constants — which a bias
# correction absorbs exactly (the mean subtraction happens after the
# channel reversal inside the net, hallucination_net.py:151-153, so swapping
# input channel order shifts each channel by a known constant).

_VGG_MEAN = np.array([103.939, 116.779, 123.68], np.float32)  # B, G, R


def _lin_stack_permutation() -> np.ndarray:
    """Channel involution of the 93-ch linearization feature stack under a
    data channel reversal: image(3) reversed; sobel(6, channel-major (dy,dx)
    pairs) pairs reversed; each histogram bin's 3-group reversed (bin-major,
    linearization_net.py:312-322, ops/histogram.py)."""
    perm = list(range(93))
    perm[0:3] = [2, 1, 0]
    for j in range(6):
        blk, d = divmod(j, 2)
        perm[3 + j] = 3 + (2 - blk) * 2 + d
    base = 9
    for bins in (4, 8, 16):
        for g in range(bins):
            for c in range(3):
                perm[base + g * 3 + c] = base + g * 3 + (2 - c)
        base += bins * 3
    return np.asarray(perm)


def _perm_in(kernel: np.ndarray, perm) -> np.ndarray:
    return np.ascontiguousarray(kernel[:, :, perm, :])


def _flip_out(node: Dict[str, Any]) -> None:
    node["kernel"] = np.ascontiguousarray(node["kernel"][..., ::-1])
    if "bias" in node:
        node["bias"] = np.ascontiguousarray(node["bias"][::-1])


def adapt_channel_order(net: str, tree: Dict[str, Any]) -> Dict[str, Any]:
    """Convert a BGR-trained net's variables for RGB inputs, in place.

    ``tree`` is the {"params", "batch_stats"} dict in this framework's module
    naming (i.e. after ``reference_keys_to_tree``).  The adapted net computes
    exactly the permuted function: net'(x) == flip(net(flip(x))) for deq/ref/
    hal and net'(x) == net(flip(x)) for lin (whose curve output has no
    channel order).  Missing nodes are skipped so partial trees survive.
    """
    params = tree.get("params", {})

    def node(*path):
        n = params
        for p in path:
            if not isinstance(n, Mapping) or p not in n:
                return None
            n = n[p]
        return n

    if net in ("deq", "ref"):
        stem = node("unet", "stem1")
        if stem is not None and "kernel" in stem:
            cin = stem["kernel"].shape[2]
            # per-3-group reversal: 3 for deq, 9 (concat[A,B,C]) for ref
            perm = np.concatenate(
                [np.arange(g, g + 3)[::-1] for g in range(0, cin, 3)]
            )
            stem["kernel"] = _perm_in(np.asarray(stem["kernel"]), perm)
        head = node("unet", "head")
        if head is not None and "kernel" in head:
            _flip_out(head)
    elif net == "lin":
        stem = node("crf_feature_net", "stem")
        if stem is not None and "kernel" in stem:
            stem["kernel"] = _perm_in(
                np.asarray(stem["kernel"]), _lin_stack_permutation()
            )
    elif net == "hal":
        # Under BGR training data the net's effective preprocessed input is
        # P(255*x - reversed_mean) relative to ours (hallucination_net.py:
        # 149-153 reverses channels *before* subtracting the means, so data
        # order and mean order swap together).  Permuting the stored
        # preprocessing means + the first conv's input channels reproduces it
        # exactly — including at SAME-padding borders, where a bias-side
        # correction would be wrong.
        first = node("enc1", "conv1")
        if first is not None and "kernel" in first:
            first["kernel"] = _perm_in(
                np.asarray(first["kernel"], np.float32), np.array([2, 1, 0])
            )
        skip0 = node("skip0", "conv")
        if skip0 is not None and "kernel" in skip0:
            k = np.asarray(skip0["kernel"], np.float32)  # [1,1,6,3]
            skip0["kernel"] = _perm_in(k, np.array([0, 1, 2, 5, 4, 3]))
            # the net's output IS skip0's conv (relu'd): flip its channels so
            # downstream consumers keep seeing reverse-of-data order
            _flip_out(skip0)
        tree.setdefault("batch_stats", {})["preproc_mean"] = np.asarray(
            _VGG_MEAN[::-1]
        )
    else:
        raise ValueError(net)
    return tree


def import_net_weights(
    net: str,
    path: str,
    target_variables: Mapping[str, Any],
    channel_order: str = "rgb",
):
    """Import reference weights for one net, validated against a target tree.

    Args:
      net: 'deq' | 'lin' | 'hal' | 'ref'.
      path: .npz dump (or TF checkpoint prefix when TF is available).
      target_variables: the flax variables of a freshly-initialized net —
        defines the expected structure/shapes.

    Returns: {"params": ..., "batch_stats": ...} with imported arrays where
    the checkpoint provided them and target values elsewhere; raises on any
    shape mismatch.
    """
    if channel_order not in ("rgb", "bgr"):
        raise ValueError(f"channel_order must be 'rgb' or 'bgr', got {channel_order!r}")
    raw = load_reference_checkpoint(path)
    imported = reference_keys_to_tree(net, raw)
    if channel_order == "bgr":
        imported = adapt_channel_order(net, imported)
    carried = 0
    if net == "hal" and "preproc_mean" not in imported["batch_stats"]:
        # framework-only constant, absent from reference checkpoints: carry
        # the target's default instead of reporting it as an unmapped param
        tgt = target_variables.get("batch_stats", {}).get("preproc_mean")
        if tgt is not None:
            imported["batch_stats"]["preproc_mean"] = np.asarray(tgt)
            carried = 1

    stats = {"imported": 0, "kept": 0}

    def merge(target: Any, src: Any, crumb: str = ""):
        if not isinstance(target, Mapping):
            if src is None:
                stats["kept"] += 1
                return target
            if tuple(np.shape(src)) != tuple(np.shape(target)):
                raise ValueError(
                    f"shape mismatch at {crumb}: checkpoint "
                    f"{np.shape(src)} vs model {np.shape(target)}"
                )
            stats["imported"] += 1
            return np.asarray(src, np.float32)
        return {
            k: merge(v, src.get(k) if isinstance(src, Mapping) else None, f"{crumb}/{k}")
            for k, v in target.items()
        }

    out = {
        "params": merge(target_variables["params"], imported["params"]),
        "batch_stats": merge(
            target_variables.get("batch_stats", {}), imported["batch_stats"]
        ),
    }
    # the carried framework-default is not checkpoint data, but it is not an
    # unmapped-variable failure either ("kept" guards those): report it in
    # its own bucket
    stats["imported"] -= carried
    stats["carried"] = carried
    out["_import_stats"] = dict(stats)
    return out
