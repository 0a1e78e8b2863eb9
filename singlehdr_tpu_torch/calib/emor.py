"""EMoR / inverse-EMoR response-curve model (the port's copy of
``singlehdr_tpu.calib.emor``, loading only).

The EMoR model (Grossberg & Nayar, "Modeling the Space of Camera Response
Functions") represents a camera response function (CRF) f and its inverse g as a
mean curve plus a low-dimensional PCA expansion over 1024 samples:

    f(x) ~ f0 + H  @ w        (forward CRF,  ``emor.txt``)
    g(y) ~ g0 + Hinv @ w      (inverse CRF, ``invemor.txt``)

The curves ship parsed, as the compressed ``data/emor.npz`` beside this module
(the same file as the JAX package's), and are exposed as plain numpy arrays.
25 basis curves are stored; the reference uses the first 11.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np

_NPZ_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "emor.npz")


@dataclasses.dataclass(frozen=True)
class EmorModel:
    """A (possibly inverse) EMoR response model.

    Attributes:
      x:     [1024] the sample grid (irradiance ``E`` for forward, brightness
             ``B`` for inverse) — uniform on [0, 1].
      mean:  [1024] the mean curve (``f0`` or ``g0``).
      basis: [1024, n_bases] PCA basis curves (``h(i)`` or ``hinv(i)``),
             column i is the i-th basis.
    """

    x: np.ndarray
    mean: np.ndarray
    basis: np.ndarray


_CACHE: Dict[bool, EmorModel] = {}


def _load(inverse: bool) -> EmorModel:
    if inverse not in _CACHE:
        z = np.load(_NPZ_PATH)
        if inverse:
            _CACHE[True] = EmorModel(x=z["b"], mean=z["g0"], basis=z["hinv"])
        else:
            _CACHE[False] = EmorModel(x=z["e"], mean=z["f0"], basis=z["h"])
    return _CACHE[inverse]


def load_emor() -> EmorModel:
    """The forward EMoR model (f0 + H w)."""
    return _load(inverse=False)


def load_inverse_emor() -> EmorModel:
    """The inverse EMoR model (g0 + Hinv w) used by the Linearization-Net decoder."""
    return _load(inverse=True)
