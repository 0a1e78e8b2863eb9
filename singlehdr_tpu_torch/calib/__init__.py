"""Camera response-function calibration data (EMoR, inverse EMoR, the CRF
bank): the port's copy of ``singlehdr_tpu.calib``, numpy only."""

from singlehdr_tpu_torch.calib.crf import (
    CrfBank,
    get_crf_bank,
    get_exposure_ladder,
    inverse_response,
)
from singlehdr_tpu_torch.calib.emor import EmorModel, load_emor, load_inverse_emor

__all__ = [
    "CrfBank",
    "EmorModel",
    "get_crf_bank",
    "get_exposure_ladder",
    "inverse_response",
    "load_emor",
    "load_inverse_emor",
]
