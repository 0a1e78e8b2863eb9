"""Arbitrary-size single-image HDR inference (counterpart of
``singlehdr_tpu.inference``).

The reference's geometry: bicubic-resize each image up to the next multiple of
``bucket_multiple`` (64), symmetric-pad by 32 px, run the 4-net pipeline,
un-pad, and resize back.  A group of same-bucket images runs as one batch,
repeat-padded up to the smallest batch size already run for that bucket
("warm"), so the set of shapes the card sees stays small.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False

PAD = 32
MULTIPLE = 64


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_to_multiple(img: np.ndarray, multiple: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Symmetric-pad H, W up to multiples of ``multiple``; returns (padded, (h, w))."""
    h, w = img.shape[:2]
    nh, nw = _ceil_to(h, multiple), _ceil_to(w, multiple)
    top, left = (nh - h) // 2, (nw - w) // 2
    padded = np.pad(
        img, ((top, nh - h - top), (left, nw - w - left), (0, 0)), mode="symmetric"
    )
    return padded, (h, w)


def crop_back(img: np.ndarray, orig_hw: Tuple[int, int]) -> np.ndarray:
    h, w = orig_hw
    nh, nw = img.shape[:2]
    top, left = (nh - h) // 2, (nw - w) // 2
    return img[top : top + h, left : left + w]


class HdrPredictor:
    """Shape-bucketed full-pipeline inference on one device.

    ``pipeline`` is a ``ReverseCameraPipeline`` already on its device; it is
    switched to eval mode and run under ``torch.inference_mode()``.  With
    ``use_refinement`` False the output is A_pred (``ref`` does not run).
    """

    def __init__(self, pipeline: torch.nn.Module, bucket_multiple: int = MULTIPLE,
                 use_refinement: bool = True):
        self.pipeline = pipeline.eval()
        self.use_refinement = use_refinement
        self.bucket_multiple = bucket_multiple
        self.device = next(pipeline.parameters()).device
        # per padded-(h, w) bucket: batch sizes already run ("warm")
        self._warm: dict = {}

    def bucket_key(self, shape) -> Tuple[int, int]:
        """The padded (h, w) bucket an input shape runs under."""
        return (
            _ceil_to(shape[0], self.bucket_multiple),
            _ceil_to(shape[1], self.bucket_multiple),
        )

    def _prepare(self, rgb01: np.ndarray) -> np.ndarray:
        """Resize to the bucket and apply the symmetric halo pad."""
        oh, ow = rgb01.shape[:2]
        rh, rw = self.bucket_key(rgb01.shape)
        x = rgb01
        if (rh, rw) != (oh, ow):
            if not _HAS_CV2:
                raise RuntimeError("cv2 required for non-multiple-of-64 inputs")
            x = cv2.resize(x, (rw, rh), interpolation=cv2.INTER_CUBIC)
        return np.pad(x, ((PAD, PAD), (PAD, PAD), (0, 0)), mode="symmetric")

    def _finish(self, out: np.ndarray, orig_hw) -> np.ndarray:
        out = out[PAD:-PAD, PAD:-PAD]
        oh, ow = orig_hw
        if out.shape[:2] != (oh, ow):
            out = cv2.resize(out, (ow, oh), interpolation=cv2.INTER_CUBIC)
        return out

    def _forward(self, batch_nhwc: np.ndarray) -> np.ndarray:
        """[n, H, W, 3] float32 host batch -> [n, H, W, 3] HDR on the host."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(batch_nhwc, np.float32))
            x = x.to(self.device).permute(0, 3, 1, 2).contiguous()
            hdr = self.pipeline(x, use_refinement=self.use_refinement).hdr
            return hdr.permute(0, 2, 3, 1).cpu().numpy()

    def __call__(self, rgb01: np.ndarray) -> np.ndarray:
        """[h, w, 3] float32 RGB in [0, 1] -> [h, w, 3] float32 HDR (RGB)."""
        return self.predict_batch([rgb01])[0]

    def warmup(self, sizes, batch_sizes=(1,)) -> None:
        """Run each (bucket, batch size) once so later groups find it warm.

        ``sizes`` are *input* (h, w) pairs, mapped through ``bucket_key``
        exactly as a request would be.
        """
        for hw in sizes:
            rh, rw = self.bucket_key(hw)
            warm = self._warm.setdefault((rh, rw), set())
            for n in sorted(set(batch_sizes)):
                if n in warm:
                    continue
                self._forward(
                    np.zeros((n, rh + 2 * PAD, rw + 2 * PAD, 3), np.float32)
                )
                warm.add(n)

    def warm_sizes(self) -> dict:
        """{padded (h, w) bucket: the batch sizes already run there, sorted}."""
        return {k: sorted(v) for k, v in self._warm.items()}

    def predict_batch(self, images) -> list:
        """Run same-bucket images as one device batch.

        A group reuses the smallest warm batch size that fits, repeat-padding
        up to it; a group larger than every warm size runs at its exact size
        (and becomes warm).
        """
        keys = {self.bucket_key(im.shape) for im in images}
        if len(keys) != 1:
            raise ValueError(f"predict_batch requires one bucket, got {keys}")
        stacked = np.stack([self._prepare(im) for im in images])
        n = stacked.shape[0]
        warm = self._warm.setdefault(keys.pop(), set())
        n_run = min((m for m in warm if m >= n), default=n)
        if n_run != n:
            stacked = np.concatenate([stacked, np.repeat(stacked[-1:], n_run - n, axis=0)])
        out = self._forward(stacked)
        warm.add(n_run)
        return [self._finish(out[i], im.shape[:2]) for i, im in enumerate(images)]
