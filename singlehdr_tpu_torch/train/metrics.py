"""Running means and the training event log (counterpart of the logging half
of ``singlehdr_tpu.train.metrics``): TensorBoard scalars and images through
tensorboardX when it imports, and always a line-buffered JSONL event log."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch


class Mean:
    """Running mean tracker (tf.keras.metrics.Mean)."""

    def __init__(self, name: str = "mean"):
        self.name = name
        self._total = 0.0
        self._count = 0

    def update(self, value) -> None:
        arr = np.asarray(value, np.float64)
        self._total += float(arr.sum())
        self._count += int(arr.size)

    def result(self) -> float:
        return self._total / self._count if self._count else 0.0

    def reset(self) -> None:
        self._total, self._count = 0.0, 0


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class MetricsWriter:
    """Scalars and images: TensorBoard when tensorboardX imports, + JSONL."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(logdir)
        # line-buffered so a live run can be followed (tail -f)
        self._jsonl = open(os.path.join(logdir, "events.jsonl"), "a", buffering=1)

    def scalar(self, tag: str, value, step: int) -> None:
        v = float(_numpy(value).mean())
        if self._tb:
            self._tb.add_scalar(tag, v, step)
        self._jsonl.write(json.dumps({"t": time.time(), "step": step, tag: v}) + "\n")

    def image(self, tag: str, img, step: int, max_images: int = 3) -> None:
        """``img``: [b, c, h, w] in [0, 1] (clipped)."""
        if self._tb is None:
            return
        arr = np.clip(_numpy(img[:max_images]), 0.0, 1.0)
        for i in range(arr.shape[0]):
            self._tb.add_image(f"{tag}/{i}", arr[i], step, dataformats="CHW")

    def flush(self) -> None:
        if self._tb:
            self._tb.flush()
        self._jsonl.flush()

    def close(self) -> None:
        if self._tb:
            self._tb.close()
        self._jsonl.close()
