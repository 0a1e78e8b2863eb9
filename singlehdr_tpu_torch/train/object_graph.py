"""TrackableObjectGraph serialization for TF2 object-based restore (the port's
copy of ``singlehdr_tpu.train.object_graph``).

``tf.train.Checkpoint.restore`` does not match tensors by key string: it
deserializes the ``_CHECKPOINTABLE_OBJECT_GRAPH`` entry (a TrackableObjectGraph
proto) and walks it in lockstep with the live Python object graph, binding
variables by *local attribute name* at each edge.  A bundle without this entry
restores nothing object-wise (ADVICE r2, medium) — so exported reference-format
checkpoints must carry one.

The proto layout (tensorflow/core/protobuf/trackable_object_graph.proto) was
confirmed empirically against bundles written by TF 2.21 / legacy Keras in
the JAX package's tests (tests/test_tf_parity.py::test_exported_checkpoint_restores_in_tf):

    TrackableObjectGraph:    nodes = 1 (repeated TrackableObject)
    TrackableObject:         children = 1 (ObjectReference),
                             attributes = 2 (SerializedTensor),
                             has_checkpoint_values = 5 (BoolValue wrapper)
    ObjectReference:         node_id = 1 (varint), local_name = 2 (string)
    SerializedTensor:        name = 1, full_name = 2, checkpoint_key = 3

The graph here is derived from the checkpoint keys themselves: every key
``a/b/c/.ATTRIBUTES/VARIABLE_VALUE`` contributes the path a -> b -> c with a
VARIABLE_VALUE attribute at the leaf.  Node ids are assigned BFS from the
root with children in sorted order — TF's matcher looks children up by name,
so ordering is cosmetic.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from singlehdr_tpu_torch.train.tensorbundle import _proto_field, _write_varint

ATTR_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


class _Node:
    __slots__ = ("children", "key")

    def __init__(self):
        self.children: Dict[str, _Node] = {}
        self.key: str | None = None  # checkpoint key when this node is a variable


def _len_field(field: int, payload: bytes) -> bytes:
    """Length-delimited field (tensorbundle's _proto_field leaves the length
    varint to the caller)."""
    return _proto_field(field, 2, _write_varint(len(payload)) + payload)


def _string_field(field: int, value: str) -> bytes:
    return _len_field(field, value.encode("utf-8"))


def _varint_field(field: int, value: int) -> bytes:
    return _proto_field(field, 0, _write_varint(value))


def build_object_graph(keys: Iterable[str]) -> bytes:
    """Serialized TrackableObjectGraph covering ``keys``.

    ``keys`` are full checkpoint keys ending in ``/.ATTRIBUTES/VARIABLE_VALUE``
    (others are ignored).  Returns the proto bytes to store under the
    ``_CHECKPOINTABLE_OBJECT_GRAPH`` key.
    """
    root = _Node()
    for key in sorted(keys):
        if not key.endswith(ATTR_SUFFIX):
            continue
        node = root
        for part in key[: -len(ATTR_SUFFIX)].split("/"):
            node = node.children.setdefault(part, _Node())
        node.key = key

    # BFS numbering
    order: List[_Node] = [root]
    ids: Dict[int, int] = {id(root): 0}
    frontier = [root]
    while frontier:
        nxt: List[_Node] = []
        for node in frontier:
            for name in sorted(node.children):
                child = node.children[name]
                ids[id(child)] = len(order)
                order.append(child)
                nxt.append(child)
        frontier = nxt

    has_values = _len_field(5, _varint_field(1, 1))  # BoolValue(true)
    out = bytearray()
    for node in order:
        body = bytearray()
        for name in sorted(node.children):
            ref = _varint_field(1, ids[id(node.children[name])]) + _string_field(
                2, name
            )
            body += _len_field(1, bytes(ref))
        if node.key is not None:
            full_name = node.key[: -len(ATTR_SUFFIX)].rsplit("/", 1)[-1]
            attr = (
                _string_field(1, "VARIABLE_VALUE")
                + _string_field(2, full_name)
                + _string_field(3, node.key)
            )
            body += _len_field(2, bytes(attr))
        body += has_values
        out += _len_field(1, bytes(body))
    return bytes(out)
