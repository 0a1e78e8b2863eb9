"""Response-curve ops: per-sample LUT application, inverse-CRF decoding and the
monotonicity projection (counterpart of ``singlehdr_tpu.ops.curves``).

``apply_rf`` is the K1 wrapper: a CPU tensor takes ``apply_rf_plain``, a CUDA
tensor the hand kernel in ``ops.cuda.apply_rf_cuda``.
"""

from __future__ import annotations

import torch

from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf, apply_rf_plain

__all__ = ["apply_rf", "apply_rf_plain", "decode_invcrf", "monotonic_rf"]


def decode_invcrf(w: torch.Tensor, g0: torch.Tensor, hinv: torch.Tensor) -> torch.Tensor:
    """Inverse CRFs from PCA weights: ``g0 + w @ hinv[:, :p].T``.

    w: [b, p]; g0: [s]; hinv: [s, >=p].  Returns [b, s] (not yet monotone).
    """
    p = w.shape[-1]
    return g0[None, :] + w @ hinv[:, :p].T


def monotonic_rf(rf: torch.Tensor) -> torch.Tensor:
    """Project curves onto increasing curves with rf[0]=0 and rf[-1]=1.

    Finite differences, lifted by ``relu(-min step)``, renormalised to sum to
    1, cumulatively summed, with a 0 prepended.  The gradient follows JAX's
    tie rules: ``amin`` splits it evenly between tied minima, and
    ``torch.maximum`` gives 0.5 to each side at a lift of exactly 0, as
    ``jnp.min`` and ``jnp.maximum`` do.
    """
    g = rf[:, 1:] - rf[:, :-1]
    lift = torch.maximum(-g.amin(dim=-1, keepdim=True), torch.zeros((), dtype=g.dtype, device=g.device))
    g = g + lift
    g = g / g.sum(dim=-1, keepdim=True)
    return torch.nn.functional.pad(torch.cumsum(g, dim=-1), (1, 0))
