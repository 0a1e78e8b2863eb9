"""The port's copies of the JAX package's numpy-only modules (``calib``,
``data``, ``utils``) against the originals, on the same inputs: equal arrays,
byte-equal files, the same file lists and the same batches."""

import argparse
import filecmp
import os
import time

import numpy as np
import pytest

from singlehdr_tpu import calib as jcalib
from singlehdr_tpu import utils as jutils
from singlehdr_tpu.data import hdr_io as jhdr_io
from singlehdr_tpu.data import jpeg as jjpeg
from singlehdr_tpu.data import loader as jloader
from singlehdr_tpu.data import synth as jsynth
from singlehdr_tpu.data.datasets import ArrayDataset as JArrayDataset
from singlehdr_tpu.data.datasets import CachedDataset as JCachedDataset
from singlehdr_tpu_torch import calib, utils
from singlehdr_tpu_torch.data import hdr_io, jpeg, loader, synth
from singlehdr_tpu_torch.data.datasets import ArrayDataset, CachedDataset


@pytest.mark.parametrize("which", ["load_emor", "load_inverse_emor"])
def test_emor_arrays_equal(which):
    got, want = getattr(calib, which)(), getattr(jcalib, which)()
    for field in ("x", "mean", "basis"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_crf_bank_and_exposure_ladder_equal():
    got, want = calib.get_crf_bank(), jcalib.get_crf_bank()
    for field in ("train_crf", "train_invcrf", "test_crf", "test_invcrf"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    for n in (7, 600):
        np.testing.assert_array_equal(calib.get_exposure_ladder(n), jcalib.get_exposure_ladder(n))


def _radiance(rs, h, w):
    return ((rs.rand(h, w, 3) * 4) ** 2).astype(np.float32)


def test_write_hdr_byte_equal_and_read_hdr_equal(tmp_path):
    rgb = _radiance(np.random.RandomState(1), 24, 40)
    a, b = str(tmp_path / "port.hdr"), str(tmp_path / "jax.hdr")
    hdr_io.write_hdr(a, rgb)
    jhdr_io.write_hdr(b, rgb)
    assert filecmp.cmp(a, b, shallow=False)
    for path in (a, b):
        np.testing.assert_array_equal(hdr_io.read_hdr(path), jhdr_io.read_hdr(path))
    np.testing.assert_array_equal(hdr_io.rgbe_encode(rgb), jhdr_io.rgbe_encode(rgb))


def _hdr_tree(root, n):
    rs = np.random.RandomState(2)
    for i in range(n):
        sub = os.path.join(root, f"scene{i % 3}")
        os.makedirs(sub, exist_ok=True)
        jhdr_io.write_hdr(os.path.join(sub, f"img{i:02d}.hdr"), _radiance(rs, 64, 96))


def test_get_train_dataset_same_files_and_samples(tmp_path, monkeypatch):
    _hdr_tree(str(tmp_path), 23)  # 23 files: one goes to the 1-in-20 test split
    monkeypatch.delenv("SINGLEHDR_DORF_PATH", raising=False)
    got = synth.get_train_dataset(str(tmp_path), patch_size=32)
    want = jsynth.get_train_dataset(str(tmp_path), patch_size=32)
    assert got._members[0]._paths == want._members[0]._paths
    assert len(got._members[0]._paths) == 21
    assert len(got) == len(want)
    for idx in (0, 5, len(want) - 1):
        for a, b in zip(got[idx], want[idx]):
            np.testing.assert_array_equal(a, b)
    for split in ("train", "test"):
        assert synth.discover_hdr_files(str(tmp_path), split) == jsynth.discover_hdr_files(
            str(tmp_path), split)


def test_random_sample_loader_same_batches():
    data = np.arange(1000 * 3, dtype=np.float32).reshape(1000, 3)
    with loader.RandomSampleLoader(ArrayDataset(data), 8, n_workers=1, seed=5) as a, \
            jloader.RandomSampleLoader(JArrayDataset(data), 8, n_workers=1, seed=5) as b:
        for _ in range(3):
            got, want = a.read_batch(), b.read_batch()
            assert len(got) == len(want) == 3
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)



@pytest.mark.parametrize("read", [0, 2])
def test_random_sample_loader_close_joins_its_threads(read):
    """``close`` ends the shuffler and every worker, also when they sit
    blocked on full queues (nothing read, or the reader gone after a few
    batches), so a training run leaves no threads behind."""
    data = np.arange(1000 * 3, dtype=np.float32).reshape(1000, 3)
    with loader.RandomSampleLoader(ArrayDataset(data), 4, n_workers=3, seed=1) as a:
        for _ in range(read):
            a.read_batch()
        threads = list(a._threads)
        time.sleep(0.2)  # the queues fill and the threads block on them
    assert not any(t.is_alive() for t in threads)

def test_jpeg_roundtrip_equal():
    rs = np.random.RandomState(3)
    batch = (rs.rand(3, 32, 48, 3) * 255).astype(np.uint8)
    q = [30, 70, 95]
    np.testing.assert_array_equal(jpeg.jpeg_roundtrip_batch(batch, q),
                                  jjpeg.jpeg_roundtrip_batch(batch, q))


def test_jpeg_roundtrip_raises_without_a_codec(monkeypatch):
    """With neither the native codec nor cv2 the round trip raises, naming
    both, where it returned the batch unchanged (the JAX copy still does)."""
    from singlehdr_tpu_torch.data import native_jpeg

    monkeypatch.setattr(native_jpeg, "available", lambda: False)
    monkeypatch.setattr(jpeg, "_HAS_CV2", False)
    batch = np.zeros((2, 8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="native libjpeg codec.*cv2"):
        jpeg.jpeg_roundtrip_batch(batch, [50, 90])


def test_utils_equal(tmp_path):
    for v in ("true", "F", "1", "no", True):
        assert utils.str2bool(v) == jutils.str2bool(v)
    with pytest.raises(argparse.ArgumentTypeError):
        utils.str2bool("maybe")
    dirs = utils.create_run_dirs(str(tmp_path), "deq")
    assert sorted(dirs) == ["outputImg", "tensorboard"]
    assert all(os.path.isdir(p) and p.startswith(str(tmp_path)) for p in dirs.values())


def test_crf_bank_n_train_equal():
    bank, jbank = calib.get_crf_bank(), jcalib.get_crf_bank()
    assert bank.n_train == jbank.n_train == bank.train_crf.shape[0] > 0


class _CountingDataset:
    def __init__(self, n):
        self.reads = []
        self._n = n

    def __getitem__(self, idx):
        self.reads.append(idx)
        return (np.full((2,), idx, np.float32), idx * 10)

    def __len__(self):
        return self._n


@pytest.mark.parametrize("eager", [False, True])
def test_cached_dataset_reads_each_item_once_as_the_jax_one(eager):
    """The copy of ``CachedDataset`` (the reference's MemDataset): the same
    items, the same length, and each inner item read once, lazily or up
    front, as the JAX class does."""
    port_inner, jax_inner = _CountingDataset(5), _CountingDataset(5)
    port, jax_ds = CachedDataset(port_inner, eager=eager), JCachedDataset(jax_inner, eager=eager)
    assert port_inner.reads == jax_inner.reads == ([0, 1, 2, 3, 4] if eager else [])
    for idx in (3, 1, 3, 0, 1):
        got, want = port[idx], jax_ds[idx]
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert len(port) == len(jax_ds) == 5
    assert port_inner.reads == jax_inner.reads
    assert sorted(port_inner.reads) == sorted(set(port_inner.reads))
