"""The serving geometry of the reference's inference script: resize up to the
next multiple of 64 (bicubic), pad 32 px symmetrically, run, un-pad and
resize back.  numpy and cv2 on the host."""

from __future__ import annotations

import numpy as np

PAD = 32
MULTIPLE = 64


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def prepare(rgb01: np.ndarray, multiple: int = MULTIPLE) -> np.ndarray:
    """[h, w, 3] float32 in [0, 1] -> the padded network input [H, W, 3]."""
    h, w = rgb01.shape[:2]
    rh, rw = _ceil_to(h, multiple), _ceil_to(w, multiple)
    x = rgb01
    if (rh, rw) != (h, w):
        import cv2

        x = cv2.resize(x, (rw, rh), interpolation=cv2.INTER_CUBIC)
    return np.pad(x, ((PAD, PAD), (PAD, PAD), (0, 0)), mode="symmetric")


def finish(out: np.ndarray, hw) -> np.ndarray:
    out = out[PAD:-PAD, PAD:-PAD]
    if out.shape[:2] != tuple(hw):
        import cv2

        out = cv2.resize(out, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    return out


def forward_images(run, images, device, block: int = 4) -> list:
    """``run`` (NCHW float32 tensor -> NCHW) over ``images`` of one shape,
    ``block`` at a time; the finished [h, w, 3] outputs on the host."""
    import torch

    outs = []
    for i in range(0, len(images), block):
        part = images[i:i + block]
        x = torch.from_numpy(np.stack([prepare(im) for im in part])).to(device)
        with torch.no_grad():
            y = run(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1).cpu().numpy()
        outs += [finish(y[j], im.shape[:2]) for j, im in enumerate(part)]
    return outs


def rel_err(prog: np.ndarray, ref: np.ndarray) -> float:
    """max |prog - ref| / max |ref|."""
    return float(np.abs(prog.astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30))
