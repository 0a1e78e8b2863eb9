"""Small host-side utilities (the port's copy of ``str2bool`` and
``create_run_dirs`` from ``singlehdr_tpu.utils.common``)."""

from __future__ import annotations

import argparse
import os
from datetime import datetime

_TIMESTAMP = datetime.now().strftime("%Y-%m-%d-%H%M%S")


def str2bool(v) -> bool:
    """Argparse-friendly boolean ('true'/'false'/'1'/'0'/...)."""
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in ("yes", "true", "t", "y", "1"):
        return True
    if s in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def create_run_dirs(root: str, name: str) -> dict:
    """Create tensorboard/ and outputImg/ run dirs for a module name, stamped
    with the process's start time."""
    out = {}
    for kind in ("tensorboard", "outputImg"):
        path = os.path.join(root, kind, name, _TIMESTAMP)
        os.makedirs(path, exist_ok=True)
        out[kind] = path
    return out
