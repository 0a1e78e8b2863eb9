"""Build and load the port's CUDA kernels.

All sources under ``singlehdr_tpu_torch/csrc`` compile with one ``nvcc`` call
into one shared library with a plain C interface, loaded with ``ctypes``.
(``torch.utils.cpp_extension.load`` would include PyTorch's headers, which
takes minutes to compile; this takes seconds.)  The library is keyed by a
hash of the sources and flags and lands in ``build/kernels/`` at the root of
the checkout.  It is built at first use, never at import: the CPU tests import
every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "shdr_apply_rf_f32": (_P, _P, _P, _I, ctypes.c_longlong, _I, _P),
    "shdr_apply_rf_bwd_f32": (_P, _P, _P, _P, _P, _I, ctypes.c_longlong, _I, _P),
    "shdr_unet_stage2_f32": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "shdr_encoder_stage2_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "shdr_lin_stem_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc call, if this process built


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libshdr_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_seconds
    path = _library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            so.shdr_error_string.argtypes = (ctypes.c_int,)
            so.shdr_error_string.restype = ctypes.c_char_p
            _lib = so
        return _lib


def call(name: str, *args) -> None:
    """Launch C entry ``name``; raise if the launch reported a CUDA error."""
    so = lib()
    err = getattr(so, name)(*args)
    if err != 0:
        msg = so.shdr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
