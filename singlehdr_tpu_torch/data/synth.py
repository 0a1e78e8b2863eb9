"""HDR-Synth training dataset: HDR patches x CRFs x exposures (the port's copy
of ``singlehdr_tpu.data.synth``).

Mirrors the reference composition (dataset.py:157-310): each HDR file is
resized so its short side is 512 and contributes two 512x512 crops
(top/bottom or left/right); patches are mean-normalized to 0.5; training
augmentation is random scale 0.5-2.0, a random 256x256 crop, rot90, and
H/V flips.  The full training set is the Cartesian product of patches,
(crf, invcrf) pairs from the calibration bank, and the exposure ladder
(dataset.py:271-276).

File lists: the reference distributes pickled path lists
(``i_dataset_train.pkl`` / ``i_dataset_test.pkl``, not in its repo).  We accept
those when present and otherwise glob ``**/*.hdr`` under the prefix with a
deterministic 95/5 split.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import List, Sequence

import numpy as np

from singlehdr_tpu_torch.calib import get_crf_bank, get_exposure_ladder
from singlehdr_tpu_torch.data.datasets import (
    ArrayDataset,
    ProductDataset,
    ZipDataset,
)
from singlehdr_tpu_torch.data.hdr_io import read_hdr

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

PATCH_FULL = 512
PATCH_TRAIN = 256
TRAIN_EXPOSURES = 600
TEST_EXPOSURES = 7


def _resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if _HAS_CV2:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    # nearest-ish numpy fallback for tests without cv2
    ys = (np.linspace(0, img.shape[0] - 1, h)).astype(np.int64)  # pragma: no cover
    xs = (np.linspace(0, img.shape[1] - 1, w)).astype(np.int64)  # pragma: no cover
    return img[ys][:, xs]  # pragma: no cover


def discover_hdr_files(prefix: str, split: str = "train") -> List[str]:
    """Resolve the HDR file list: reference pkl lists if present, else glob."""
    pkl = os.path.join(prefix, f"i_dataset_{split}.pkl")
    if os.path.exists(pkl):
        with open(pkl, "rb") as f:
            postfixes = pickle.load(f)
        return [os.path.join(prefix, p) for p in postfixes]
    files = sorted(glob.glob(os.path.join(prefix, "**", "*.hdr"), recursive=True))
    if not files:
        raise FileNotFoundError(f"no .hdr files under {prefix}")
    # deterministic split: every 20th file to test
    test = files[::20]
    train = [f for f in files if f not in set(test)]
    return train if split == "train" else test


def normalize_hdr_mean(hdr: np.ndarray, target: float = 0.5) -> np.ndarray:
    """Scale so the mean is `target` (reference _pre_hdr_p2, dataset.py:265-268)."""
    return target * hdr / (hdr.mean() + 1e-6)


class PatchHDRDataset:
    """Two 512^2 half-crops per HDR file; optional train augmentation to
    ``patch_size`` (256 in the reference, dataset.py:238)."""

    def __init__(
        self,
        paths: Sequence[str],
        training: bool,
        cache: bool = True,
        seed: int = 0,
        patch_size: int = PATCH_TRAIN,
    ):
        self._paths = list(paths)
        self._training = training
        self._cache = cache
        self._patch = patch_size
        self._rng = np.random.RandomState(seed)
        self._file_cache: dict[int, np.ndarray] = {}
        self._crop_cache: dict[int, np.ndarray] = {}

    def _load_resized(self, path: str) -> np.ndarray:
        hdr = read_hdr(path)
        h, w, _ = hdr.shape
        ratio = max(PATCH_FULL / h, PATCH_FULL / w)
        return _resize_area(hdr, round(h * ratio), round(w * ratio))

    def _file(self, fidx: int) -> np.ndarray:
        if not self._cache:
            return self._load_resized(self._paths[fidx])
        if fidx not in self._file_cache:
            self._file_cache[fidx] = self._load_resized(self._paths[fidx])
        return self._file_cache[fidx]

    def __len__(self) -> int:
        return 2 * len(self._paths)

    def _half_crop(self, idx: int) -> np.ndarray:
        """Mean-normalized 512^2 half-crop for sample `idx` (cached)."""
        if self._cache and idx in self._crop_cache:
            return self._crop_cache[idx]
        hdr = self._file(idx // 2)
        h, w, _ = hdr.shape
        first = idx % 2 == 0
        if h > w:
            hdr = hdr[:PATCH_FULL] if first else hdr[-PATCH_FULL:]
        else:
            hdr = hdr[:, :PATCH_FULL] if first else hdr[:, -PATCH_FULL:]
        hdr = np.ascontiguousarray(normalize_hdr_mean(hdr), np.float32)
        if self._cache:
            self._crop_cache[idx] = hdr
            if idx ^ 1 in self._crop_cache:  # both halves cached: the full
                self._file_cache.pop(idx // 2, None)  # resized image is dead
        return hdr

    def __getitem__(self, idx: int) -> np.ndarray:
        hdr = self._half_crop(idx)
        if self._training:
            hdr = self._augment(hdr)
        return np.ascontiguousarray(hdr, np.float32)

    def _augment(self, hdr: np.ndarray) -> np.ndarray:
        """Random scale 0.5-2.0 + 256^2 crop + rot90 + flips (dataset.py:223-248).

        The scale+crop is realized as crop-before-resize: instead of resizing
        the full 512^2 patch to (512*scale)^2 and keeping a 256^2 window (the
        reference's order, which at scale 2 writes 16x the pixels it keeps),
        the equivalent source window of the virtual crop is cut first and a
        single INTER_AREA resize produces the 256^2 output directly — the same
        augmentation distribution at 4-16x less resize work.
        """
        rng = self._rng
        scale = rng.uniform(0.5, 2.0)
        size = int(np.round(PATCH_FULL * scale))
        # random self._patch^2 window of the virtually-resized size^2 image
        y = rng.randint(0, max(1, size - self._patch))
        x = rng.randint(0, max(1, size - self._patch))
        h, w = hdr.shape[:2]
        # map the window back to source coordinates and cut it (outer bounds)
        sy0, sy1 = int(y * h / size), min(h, -(-((y + self._patch) * h) // size))
        sx0, sx1 = int(x * w / size), min(w, -(-((x + self._patch) * w) // size))
        hdr = _resize_area(hdr[sy0:sy1, sx0:sx1], self._patch, self._patch)
        hdr = np.rot90(hdr, rng.randint(4))
        if rng.rand() < 0.5:
            hdr = np.flip(hdr, 0)
        if rng.rand() < 0.5:
            hdr = np.flip(hdr, 1)
        return hdr


def get_train_dataset(hdr_prefix: str, patch_size: int = PATCH_TRAIN) -> ProductDataset:
    """patches x (crf, invcrf) x exposure — items are (hdr, crf, invcrf, t)."""
    bank = get_crf_bank()
    return ProductDataset(
        [
            PatchHDRDataset(
                discover_hdr_files(hdr_prefix, "train"),
                training=True,
                patch_size=patch_size,
            ),
            ZipDataset([ArrayDataset(bank.train_crf), ArrayDataset(bank.train_invcrf)]),
            ArrayDataset(get_exposure_ladder(TRAIN_EXPOSURES)),
        ]
    )


def get_validation_dataset(hdr_prefix: str, n: int = 10) -> ProductDataset:
    """Held-out patches x held-out CRFs x a 5-step ladder (dataset.py:279-300)."""
    bank = get_crf_bank()
    paths = discover_hdr_files(hdr_prefix, "test")[:n]
    return ProductDataset(
        [
            PatchHDRDataset(paths, training=False),
            ZipDataset(
                [ArrayDataset(bank.test_crf[:n]), ArrayDataset(bank.test_invcrf[:n])]
            ),
            ArrayDataset(get_exposure_ladder(5)),
        ]
    )


def get_test_dataset(hdr_prefix: str) -> ProductDataset:
    """Test patches x test CRFs x the 7-step test ladder (dataset.py:305-310)."""
    bank = get_crf_bank()
    return ProductDataset(
        [
            PatchHDRDataset(discover_hdr_files(hdr_prefix, "test"), training=False),
            ZipDataset([ArrayDataset(bank.test_crf), ArrayDataset(bank.test_invcrf)]),
            ArrayDataset(get_exposure_ladder(TEST_EXPOSURES)),
        ]
    )
