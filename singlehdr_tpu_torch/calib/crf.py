"""Camera-response-function (CRF) banks and exposure ladders for HDR-Synth
training (the port's copy of ``singlehdr_tpu.calib.crf``).

The reference builds its train/test CRF lists from ``dorfCurves.txt`` — 201
measured curves from the DoRF database — shuffled with a fixed seed, last 10 held
out for test, each numerically inverted (the reference's ``dataset.py:19-56``).
That file is a git-LFS blob missing from the reference mount, so this module can
either:

  * parse a real ``dorfCurves.txt`` if the caller provides a path (same 6-line
    record layout: the brightness curve is line ``idx+5`` of each record), or
  * synthesize a DoRF-like bank of 201 monotone CRFs from the forward EMoR PCA
    model (the EMoR basis was itself fit to DoRF, so samples from it are
    realistic response curves).  Deterministic under a fixed seed.

Either way the bank exposes the same artifacts the reference training stack
consumes: ``train_crf / train_invcrf`` ([191, 1024]), ``test_crf / test_invcrf``
([10, 1024]), and exposure ladders ``t = 2**linspace(-3, 3, n)`` with n=600
train / 7 test (``dataset.py:54-56``).

Synthetic-bank fidelity (the JAX package's tools/analyze_crf_bank.py, deterministic): every
sampled curve is monotone with exact {0, 1} endpoints; mean RMS residual
against the 25-base measured-EMoR subspace is 2.9e-4 (max 1.3e-3) and 1.2e-3
against the 11 bases the Linearization-Net predicts in — the same order as
published DoRF->EMoR reconstruction residuals, i.e. the synthetic curves are
statistically inside the measured-curve family rather than an arbitrary gamma
zoo.  Shape diversity: identity-RMS spread 0.004-0.31 (mean 0.15) with a
2:1 concave/convex curvature mix.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from singlehdr_tpu_torch.calib.emor import load_emor

N_DORF_CURVES = 201
N_TEST_CURVES = 10
SAMPLES = 1024
_SHUFFLE_SEED = 730  # dataset.py:30 — RandomState(730)


def inverse_response(rf: np.ndarray) -> np.ndarray:
    """Numerically invert a monotone response curve sampled on linspace(0,1,s).

    Matches the reference ``_inverse_rf`` (``dataset.py:41-46``): endpoints are
    pinned to 0/1, then the inverse is evaluated by 1-D interpolation of the
    swapped (y, x) pairs on a uniform grid.
    """
    rf = np.asarray(rf, np.float64).copy()
    (s,) = rf.shape
    rf[0] = 0.0
    rf[-1] = 1.0
    grid = np.linspace(0.0, 1.0, num=s)
    # np.interp requires increasing sample points; enforce monotonicity for
    # safety (measured DoRF curves are increasing; synthesized ones are
    # projected to be).  With duplicate knots (flat curve regions) np.interp
    # picks an arbitrary duplicate, so re-pin the mathematically exact
    # endpoints g(0)=0, g(1)=1 afterwards.
    rf = np.maximum.accumulate(rf)
    inv = np.interp(grid, rf, grid)
    inv[0] = 0.0
    inv[-1] = 1.0
    return inv.astype(np.float32)


def _make_monotone(curves: np.ndarray) -> np.ndarray:
    """Project curves to be increasing from 0 to 1 (same recipe as the
    Linearization-Net's monotonicity projection, ops.curves.monotonic_rf)."""
    g = np.diff(curves, axis=-1)
    g = g + np.maximum(0.0, -np.min(g, axis=-1, keepdims=True))
    g = g / np.sum(g, axis=-1, keepdims=True)
    out = np.concatenate(
        [np.zeros_like(curves[..., :1]), np.cumsum(g, axis=-1)], axis=-1
    )
    return out.astype(np.float32)


def _parse_dorf_text(path: str) -> np.ndarray:
    """Parse dorfCurves.txt: records of 6 lines; brightness curve at offset 5."""
    with open(path, "r") as f:
        lines = [line.strip() for line in f.readlines()]
    curves = [lines[idx + 5] for idx in range(0, len(lines), 6)]
    return np.asarray([c.split() for c in curves], dtype=np.float32)


def _synthesize_dorf_like(n: int, seed: int = 20260816) -> np.ndarray:
    """Sample n realistic CRFs from the forward EMoR PCA model.

    Coefficients use a 1/i-decaying scale over the first 11 bases (the same
    subspace the Linearization-Net predicts in), plus a random gamma warp for
    extra diversity, then a monotone-[0,1] projection.
    """
    emor = load_emor()
    rng = np.random.RandomState(seed)
    k = 11
    scales = 0.6 / np.arange(1, k + 1, dtype=np.float32)
    w = rng.randn(n, k).astype(np.float32) * scales
    curves = emor.mean[None, :] + w @ emor.basis[:, :k].T  # [n, 1024]
    # mild random gamma warp of the abscissa for additional shape diversity
    gamma = np.exp(rng.uniform(-0.35, 0.35, size=(n, 1)).astype(np.float32))
    grid = np.linspace(0.0, 1.0, SAMPLES, dtype=np.float32)
    warped = np.stack(
        [np.interp(grid**g, grid, c) for g, c in zip(gamma[:, 0], curves)], axis=0
    )
    return _make_monotone(warped)


@dataclasses.dataclass(frozen=True)
class CrfBank:
    """Train/test split of response curves and their numerical inverses."""

    train_crf: np.ndarray      # [n_train, 1024]
    train_invcrf: np.ndarray   # [n_train, 1024]
    test_crf: np.ndarray       # [n_test, 1024]
    test_invcrf: np.ndarray    # [n_test, 1024]

    @property
    def n_train(self) -> int:
        return self.train_crf.shape[0]


_BANK_CACHE: dict = {}


def get_crf_bank(dorf_path: Optional[str] = None) -> CrfBank:
    """Build the train/test CRF bank.

    Reproduces the reference split recipe (``dataset.py:19-50``): shuffle the
    full curve list with RandomState(730), hold out the last 10 for test, invert
    each curve numerically.  ``dorf_path`` defaults to $SINGLEHDR_DORF_PATH, and
    falls back to the synthesized EMoR-sampled bank when no file is available.
    """
    dorf_path = dorf_path or os.environ.get("SINGLEHDR_DORF_PATH")
    key = dorf_path or "<synth>"
    if key in _BANK_CACHE:
        return _BANK_CACHE[key]

    if dorf_path and os.path.exists(dorf_path):
        curves = _parse_dorf_text(dorf_path)
    else:
        curves = _synthesize_dorf_like(N_DORF_CURVES)

    curves = curves.copy()
    np.random.RandomState(_SHUFFLE_SEED).shuffle(curves)
    test, train = curves[-N_TEST_CURVES:], curves[:-N_TEST_CURVES]
    bank = CrfBank(
        train_crf=train,
        train_invcrf=np.stack([inverse_response(c) for c in train]),
        test_crf=test,
        test_invcrf=np.stack([inverse_response(c) for c in test]),
    )
    _BANK_CACHE[key] = bank
    return bank


def get_exposure_ladder(n: int) -> np.ndarray:
    """Exposure multipliers 2**linspace(-3, 3, n) (``dataset.py:54``).

    n=600 for training, n=7 for test in the reference."""
    return (2.0 ** np.linspace(-3.0, 3.0, n)).astype(np.float32)
