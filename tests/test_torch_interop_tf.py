"""The port's TensorBundle reader and writer against TensorFlow itself.

A reference-format checkpoint written by the port (``export_reference_
checkpoint`` over the port's seeded deq) must read back in TF to the same
arrays and restore object by object, through its object graph, into a
``tf.train.Checkpoint`` whose objects carry the reference's attribute names;
a checkpoint that TF writes for such objects must read in the port to TF's
arrays and import with no array left at init.  The object trees are plain
``tf.Module``s built from the key inventory, so no reference checkout is
needed.  Skipped where TensorFlow is not installed.
"""

import os

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from singlehdr_tpu_torch.convert import nest_variables, to_jax_variables  # noqa: E402
from singlehdr_tpu_torch.models import build_pipeline  # noqa: E402
from singlehdr_tpu_torch.train import ref_inventory, tensorbundle, weight_import  # noqa: E402

SUFFIX = ref_inventory.ATTR_SUFFIX


def _deq_variables():
    flat = to_jax_variables(build_pipeline(seed=3, device="cpu").state_dict())
    variables = nest_variables(flat)
    return {"params": variables["params"]["deq"], "batch_stats": {}}


def _object_tree(keys, values=None):
    """{top-level name: tf.Module or tf.Variable} holding one variable a key,
    nested by the key's attribute path; zeros unless ``values`` gives them."""
    root = tf.Module()
    for key in keys:
        *path, leaf = key[: -len(SUFFIX)].split("/")
        node = root
        for name in path:
            if not hasattr(node, name):
                setattr(node, name, tf.Module())
            node = getattr(node, name)
        value = values[key] if values is not None else np.zeros_like(keys[key])
        setattr(node, leaf, tf.Variable(value))
    return {name: getattr(root, name) for name in {k.split("/")[0] for k in keys}}


def test_tf_reads_and_restores_a_port_export(tmp_path):
    prefix = str(tmp_path / "deq" / "ckpt-1")
    weight_import.export_reference_checkpoint("deq", _deq_variables(), prefix)
    assert tf.train.latest_checkpoint(str(tmp_path / "deq")) == prefix
    ours = tensorbundle.read_bundle(prefix)
    reader = tf.train.load_checkpoint(prefix)
    theirs = {k for k, dt in reader.get_variable_to_dtype_map().items() if dt != tf.string}
    assert theirs == set(ours)
    for key, value in ours.items():
        got = reader.get_tensor(key)
        assert got.dtype == value.dtype, key
        np.testing.assert_array_equal(got, value, err_msg=key)

    # the Checkpoint's own save counter binds to ``save_counter``
    objects = _object_tree({k: v for k, v in ours.items() if not k.startswith("save_counter/")})
    tf.train.Checkpoint(**objects).restore(prefix).assert_existing_objects_matched()
    for key, value in ours.items():
        if key.startswith("save_counter/"):
            continue
        node = objects
        for name in key[: -len(SUFFIX)].split("/"):
            node = node[name] if isinstance(node, dict) else getattr(node, name)
        np.testing.assert_array_equal(node.numpy(), value, err_msg=key)


def test_port_reads_and_imports_a_checkpoint_tf_wrote(tmp_path):
    rs = np.random.RandomState(4)
    keys = {k: s for k, s in ref_inventory.checkpoint_keys("deq", with_optimizer=False).items()
            if not k.startswith("save_counter/")}  # the Checkpoint writes its own
    values = {k: rs.normal(0.0, 0.05, s).astype(np.float32) for k, s in keys.items()}
    values["epoch" + SUFFIX] = np.asarray(7, np.int32)
    prefix = tf.train.Checkpoint(**_object_tree(values, values)).write(str(tmp_path / "ckpt-1"))
    assert tensorbundle.is_bundle(prefix)
    ours = tensorbundle.read_bundle(prefix)
    reader = tf.train.load_checkpoint(prefix)
    assert set(ours) == {k for k, dt in reader.get_variable_to_dtype_map().items() if dt != tf.string}
    assert set(values) <= set(ours)
    for key, value in values.items():
        assert ours[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)
    out = weight_import.import_net_weights("deq", prefix, _deq_variables())
    assert out.pop("_import_stats") == {"imported": 38, "kept": 0, "carried": 0}
    np.testing.assert_array_equal(out["params"]["unet"]["stem1"]["kernel"],
                                  values["lin/conv1/kernel" + SUFFIX])
    assert os.path.exists(prefix + ".index")
