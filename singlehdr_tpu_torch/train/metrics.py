"""Running means, quality metrics and the training event log (counterpart of
``singlehdr_tpu.train.metrics``): PSNR and SSIM on NCHW tensors, TensorBoard
scalars, images and histograms through tensorboardX when it imports, and
always a line-buffered JSONL event log."""

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


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, one number per batch (the mean
    squared error over every element)."""
    mse = torch.mean(torch.square(pred - target))
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def _blur1d(x: torch.Tensor, g: torch.Tensor, dim: int) -> torch.Tensor:
    """Convolve along ``dim`` with the taps ``g``, symmetric-padded as
    ``np.pad(mode="symmetric")`` pads (the edge sample repeated, reflected
    again where the pad is longer than the axis); the taps are summed in
    the JAX function's order."""
    n, half = x.shape[dim], g.numel() // 2
    index = torch.from_numpy(np.pad(np.arange(n), half, mode="symmetric")).to(x.device)
    padded = x.index_select(dim, index)
    out = 0.0
    for i in range(g.numel()):
        out = out + g[i] * padded.narrow(dim, i, n)
    return out


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0, filter_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over a [b, c, h, w] batch: a separable Gaussian window over
    h and w, the standard constants."""
    half = filter_size // 2
    coords = torch.arange(filter_size, dtype=torch.float32, device=pred.device) - half
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    g = g / torch.sum(g)

    def smooth(x):
        return _blur1d(_blur1d(x, g, 2), g, 3)

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_p, mu_t = smooth(pred), smooth(target)
    var_p = smooth(pred * pred) - mu_p**2
    var_t = smooth(target * target) - mu_t**2
    cov = smooth(pred * target) - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p**2 + mu_t**2 + c1) * (var_p + var_t + c2)
    return torch.mean(num / den)


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class MetricsWriter:
    """Scalars, images and histograms: TensorBoard when tensorboardX imports, + JSONL."""

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

    def histogram(self, tag: str, values, step: int) -> None:
        if self._tb:
            self._tb.add_histogram(tag, _numpy(values).ravel(), step)

    def flush(self) -> None:
        if self._tb:
            self._tb.flush()
        self._jsonl.flush()

    def close(self) -> None:
        if self._tb:
            self._tb.close()
        self._jsonl.close()
