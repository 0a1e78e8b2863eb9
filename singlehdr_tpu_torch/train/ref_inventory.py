"""Hand-derived inventory of the reference checkpoints' variable keys (the
port's copy of ``singlehdr_tpu.train.ref_inventory``).

The reference saves each net as ``tf.train.Checkpoint(epoch=..., lin=model,
optimizer=tf.keras.optimizers.Adam(...))`` (tf_utils.py:149-169), which
serializes the Keras object graph by *attribute name*.  This module lists, per
net, every variable-bearing attribute path with its variable names and shapes,
derived line-by-line from the reference model definitions — independently of
``weight_import.NET_MAPS``, so the two cross-check each other in tests.

Derivations (all shapes HWIO / [in, out], TF-Keras conventions):

* deq (dequantization_net.py:31-46): stems conv1/conv2 7x7@16, downs
  d2(5x5@32) d3(3x3@64) d4(3x3@128) enc(3x3@256) each with conv1/conv2
  (dequantization_net.py:4-15), ups u4..u1 with conv1 (post-resize) and conv2
  (post-skip-concat, so 2x input channels) (dequantization_net.py:17-29),
  head ``out`` 3x3@3.
* ref (refinement_net.py:31-48): same topology, 9-channel input
  (concat[A,B,C], refinement_net.py:52), enc at 128 instead of 256.
* lin (linearization_net.py:85-118,305-309): crf_feature_net stem conv1
  7x7/2@64 (input 93 = 3 img + 6 sobel + (4+8+16)*3 histogram channels,
  linearization_net.py:312-322) + norm1, bottleneck blocks res1/res4
  (type1: projection conv1/norm1 + main conv2-4/norm2-4,
  linearization_net.py:6-48, biasless convs) and res2/res3/res5 (type2:
  conv1-3/norm1-3, linearization_net.py:50-83), then
  ae_invcrf_decode_net.fc Dense(11) from the 512-dim pooled feature
  (linearization_net.py:185,192).
* hal (hallucination_net.py:109-145): encoder d1/d2 (down1: conv1/conv2,
  hallucination_net.py:43-57) at 64/128, d3-d5 (down2: conv1-3,
  hallucination_net.py:59-75) at 256/512/512, latent conv1@512 + norm1,
  decoder u5..u1 (up: conv1 + norm1; the ``conv2`` attribute is defined but
  never called (hallucination_net.py:83,87-91) so Keras never builds it and
  it contributes **no** checkpoint variables), skips s5..s1
  (skipLayer.conv1 1x1 on concat[x, skip], hallucination_net.py:93-107),
  head conv2 1x1@3 + norm2, final skip s0 on concat[x, vgg-preprocessed
  input] (hallucination_net.py:186-188).

Every net's checkpoint also carries ``epoch``, ``save_counter``, the Adam
hyperparameter scalars, per-trainable-variable Adam m/v slots, and the
``_CHECKPOINTABLE_OBJECT_GRAPH`` string tensor — all of which an importer must
skip.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

Shape = Tuple[int, ...]
VarMap = Dict[str, Dict[str, Shape]]  # attr_path -> {var_name: shape}

ATTR_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"
SLOT_INFIX = "/.OPTIMIZER_SLOT/optimizer/"
OBJECT_GRAPH_KEY = "_CHECKPOINTABLE_OBJECT_GRAPH"


def _conv(k: int, cin: int, cout: int, bias: bool = True) -> Dict[str, Shape]:
    out: Dict[str, Shape] = {"kernel": (k, k, cin, cout)}
    if bias:
        out["bias"] = (cout,)
    return out


def _bn(c: int) -> Dict[str, Shape]:
    return {
        "gamma": (c,),
        "beta": (c,),
        "moving_mean": (c,),
        "moving_variance": (c,),
    }


def _dense(cin: int, cout: int) -> Dict[str, Shape]:
    return {"kernel": (cin, cout), "bias": (cout,)}


def _residual_unet(cin: int, enc: int) -> VarMap:
    """deq/ref shared topology (dequantization_net.py:31-46)."""
    v: VarMap = {
        "conv1": _conv(7, cin, 16),
        "conv2": _conv(7, 16, 16),
        "d2/conv1": _conv(5, 16, 32),
        "d2/conv2": _conv(5, 32, 32),
        "d3/conv1": _conv(3, 32, 64),
        "d3/conv2": _conv(3, 64, 64),
        "d4/conv1": _conv(3, 64, 128),
        "d4/conv2": _conv(3, 128, 128),
        "enc/conv1": _conv(3, 128, enc),
        "enc/conv2": _conv(3, enc, enc),
        "u4/conv1": _conv(3, enc, 128),
        "u4/conv2": _conv(3, 256, 128),
        "u3/conv1": _conv(3, 128, 64),
        "u3/conv2": _conv(3, 128, 64),
        "u2/conv1": _conv(3, 64, 32),
        "u2/conv2": _conv(3, 64, 32),
        "u1/conv1": _conv(3, 32, 16),
        "u1/conv2": _conv(3, 32, 16),
        "out": _conv(3, 16, 3),
    }
    return v


def _lin_net() -> VarMap:
    v: VarMap = {
        "crf_feature_net/conv1": _conv(7, 93, 64),
        "crf_feature_net/norm1": _bn(64),
        "ae_invcrf_decode_net/fc": _dense(512, 11),
    }

    def type1(name: str, cin: int, b1: int, b2: List[int]) -> None:
        v[f"{name}/conv1"] = _conv(1, cin, b1, bias=False)
        v[f"{name}/norm1"] = _bn(b1)
        v[f"{name}/conv2"] = _conv(1, cin, b2[0], bias=False)
        v[f"{name}/norm2"] = _bn(b2[0])
        v[f"{name}/conv3"] = _conv(3, b2[0], b2[1], bias=False)
        v[f"{name}/norm3"] = _bn(b2[1])
        v[f"{name}/conv4"] = _conv(1, b2[1], b2[2], bias=False)
        v[f"{name}/norm4"] = _bn(b2[2])

    def type2(name: str, cin: int, f: List[int]) -> None:
        v[f"{name}/conv1"] = _conv(1, cin, f[0], bias=False)
        v[f"{name}/norm1"] = _bn(f[0])
        v[f"{name}/conv2"] = _conv(3, f[0], f[1], bias=False)
        v[f"{name}/norm2"] = _bn(f[1])
        v[f"{name}/conv3"] = _conv(1, f[1], f[2], bias=False)
        v[f"{name}/norm3"] = _bn(f[2])

    type1("crf_feature_net/res1", 64, 256, [64, 64, 256])
    type2("crf_feature_net/res2", 256, [64, 64, 256])
    type2("crf_feature_net/res3", 256, [64, 64, 256])
    type1("crf_feature_net/res4", 256, 512, [128, 128, 512])
    type2("crf_feature_net/res5", 512, [128, 128, 512])
    return v


def _hal_net() -> VarMap:
    v: VarMap = {
        "d1/conv1": _conv(3, 3, 64),
        "d1/conv2": _conv(3, 64, 64),
        "d2/conv1": _conv(3, 64, 128),
        "d2/conv2": _conv(3, 128, 128),
        "d3/conv1": _conv(3, 128, 256),
        "d3/conv2": _conv(3, 256, 256),
        "d3/conv3": _conv(3, 256, 256),
        "d4/conv1": _conv(3, 256, 512),
        "d4/conv2": _conv(3, 512, 512),
        "d4/conv3": _conv(3, 512, 512),
        "d5/conv1": _conv(3, 512, 512),
        "d5/conv2": _conv(3, 512, 512),
        "d5/conv3": _conv(3, 512, 512),
        "conv1": _conv(3, 512, 512),
        "norm1": _bn(512),
        # decoder: up.conv2 is unbuilt/dead (hallucination_net.py:83) -> absent
        "u5/conv1": _conv(3, 512, 512),
        "u5/norm1": _bn(512),
        "s5/conv1": _conv(1, 1024, 512),
        "u4/conv1": _conv(3, 512, 512),
        "u4/norm1": _bn(512),
        "s4/conv1": _conv(1, 1024, 512),
        "u3/conv1": _conv(3, 512, 256),
        "u3/norm1": _bn(256),
        "s3/conv1": _conv(1, 512, 256),
        "u2/conv1": _conv(3, 256, 128),
        "u2/norm1": _bn(128),
        "s2/conv1": _conv(1, 256, 128),
        "u1/conv1": _conv(3, 128, 64),
        "u1/norm1": _bn(64),
        "s1/conv1": _conv(1, 128, 64),
        "conv2": _conv(1, 64, 3),
        "norm2": _bn(3),
        "s0/conv1": _conv(1, 6, 3),
    }
    return v


NET_VARIABLES: Mapping[str, VarMap] = {
    "deq": _residual_unet(3, 256),
    "ref": _residual_unet(9, 128),
    "lin": _lin_net(),
    "hal": _hal_net(),
}

# Variables that exist in the graph but are not Adam-slotted (non-trainable).
_NON_TRAINABLE = ("moving_mean", "moving_variance")


def checkpoint_keys(net: str, with_optimizer: bool = True) -> Dict[str, Shape]:
    """Full key->shape inventory for one reference checkpoint.

    Mirrors what ``tf.train.list_variables`` reports on a checkpoint written
    by the reference's ``checkpoint_initialization`` (tf_utils.py:149-169):
    model variables under the universal ``lin`` slot, Adam m/v slots per
    trainable variable, optimizer hyperparameters, the epoch/save counters.
    (The ``_CHECKPOINTABLE_OBJECT_GRAPH`` string tensor also exists; it is
    omitted here because it has no static shape.)
    """
    out: Dict[str, Shape] = {
        "epoch" + ATTR_SUFFIX: (),
        "save_counter" + ATTR_SUFFIX: (),
    }
    if with_optimizer:
        for hyper in ("beta_1", "beta_2", "decay", "learning_rate"):
            out[f"optimizer/{hyper}{ATTR_SUFFIX}"] = ()
        out["optimizer/iter" + ATTR_SUFFIX] = ()
    for attr, variables in NET_VARIABLES[net].items():
        for var, shape in variables.items():
            base = f"lin/{attr}/{var}"
            out[base + ATTR_SUFFIX] = shape
            if with_optimizer and var not in _NON_TRAINABLE:
                for slot in ("m", "v"):
                    out[f"{base}{SLOT_INFIX}{slot}{ATTR_SUFFIX}"] = shape
    return out


def make_fixture_tensors(net: str, seed: int = 0) -> Dict[str, "np.ndarray"]:
    """Deterministic small-valued tensors for every key of one checkpoint.

    Values are seeded per-key so tests can recognize individual tensors after
    import; moving_variance is kept positive as BatchNorm requires.
    """
    import numpy as np

    rng = np.random.RandomState(seed)
    out = {}
    for key, shape in checkpoint_keys(net).items():
        arr = rng.normal(0.0, 0.05, size=shape).astype(np.float32)
        if key.endswith("moving_variance" + ATTR_SUFFIX):
            arr = np.abs(arr) + 0.5
        out[key] = arr
    out["epoch" + ATTR_SUFFIX] = np.asarray(3.0, np.float32)
    out["save_counter" + ATTR_SUFFIX] = np.asarray(3, np.int64)
    out["optimizer/iter" + ATTR_SUFFIX] = np.asarray(3000, np.int64)
    return out
