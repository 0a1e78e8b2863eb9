"""Gate on the port's trained-quality anchor artifacts, one case per run type.

``singlehdr_tpu_torch.tools.quality_anchor`` (a fresh run of the recipe) and
``singlehdr_tpu_torch.tools.extend_anchor`` (its extension by more finetune
scenes) write ``QUALITY_TORCH_fresh.json`` and
``QUALITY_TORCH_extension.json`` at the repo root.  Each committed artifact
is held to floors taken from the JAX package's runs of the same recipe, not
from the port's own: about 1 dB and 0.011 SSIM below each, as the JAX gate
sits under its artifact.  A semantic regression (a loss mis-wired, a wrong
restore, a channel swap) fails; ordinary run-to-run noise passes.  Skipped
when the artifact is absent.
"""

import json
import math
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (mu-PSNR dB, mu-SSIM, linear PSNR dB) floors.  fresh: the JAX r5 fresh run,
# 24.21 / 0.949 / 13.15 (BENCH_NOTES.md:691-695); extension: the JAX r5
# extension run, 26.555 / 0.959 / 15.666 (QUALITY_r05.json)
FLOORS = {
    "fresh": (23.2, 0.938, 12.1),
    "extension": (25.5, 0.948, 14.6),
}


@pytest.mark.parametrize("run", sorted(FLOORS))
def test_torch_quality_anchor_gate(run):
    path = os.path.join(ROOT, f"QUALITY_TORCH_{run}.json")
    if not os.path.exists(path):
        pytest.skip(f"no {os.path.basename(path)} artifact present")
    with open(path) as f:
        q = json.load(f)
    assert q["run"] == run, f"{path} holds a {q['run']!r} run"
    for key in ("psnr_mu", "ssim_mu", "psnr_linear"):
        assert q.get(key) is not None and math.isfinite(q[key]), f"{key}: {q.get(key)}"
    psnr_mu, ssim_mu, psnr_linear = FLOORS[run]
    assert q["psnr_mu"] >= psnr_mu, f"mu-PSNR regressed: {q['psnr_mu']}"
    assert q["ssim_mu"] >= ssim_mu, f"mu-SSIM regressed: {q['ssim_mu']}"
    assert q["psnr_linear"] >= psnr_linear, f"linear PSNR regressed: {q['psnr_linear']}"
